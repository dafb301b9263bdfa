"""sync_wait_ms: the host's time a call blocked in its waits on the
card, in ms: the self times of the program's spans named `sync.<site>`
(dsptpu_torch.utils.device's uploads and read-backs, and the other
waits spanned where they happen), summed, over the calls of the
device-alone profile (dsptpu_torch.utils.profiling.self_times). 0.0
where the program spans its waits and none happened; None where the
trace holds no device record or too few calls' spans, or the program
does not span its waits (it has no utils.device.to_host). Layer: ops
and routing (host)."""


def read(trace):
    from benchmark import spans
    st = spans.self_times(trace)
    if st is None or not _counts_waits():
        return None
    return 1e3 * sum(v for k, v in st.items() if k.startswith("sync."))


def _counts_waits():
    from dsptpu_torch.utils import device
    return hasattr(device, "to_host")
