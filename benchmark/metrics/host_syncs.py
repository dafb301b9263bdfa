"""host_syncs: the host's waits on the card a call: the sum of the
program's counters named `sync.<site>` (each upload of host data and
each read-back, dsptpu_torch.utils.device, and the other waits counted
where they happen) over both profiled windows of the traced run,
divided by their 2 x trace.calls calls. 0.0 where the program counts
its waits and none happened; None where the trace holds no device
record or the program does not count its waits (it has no
utils.device.to_host). Layer: ops and routing (host)."""


def read(trace):
    from benchmark import spans
    c = spans.counters(trace)
    if c is None or not _counts_waits():
        return None
    return sum(v for k, v in c.items() if k.startswith("sync.")) / (
        2 * trace.calls)


def _counts_waits():
    from dsptpu_torch.utils import device
    return hasattr(device, "to_host")
