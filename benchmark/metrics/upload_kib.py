"""upload_kib: the host data uploaded to the card a call, in KiB: the
program's counter `upload.bytes` (each upload through
dsptpu_torch.utils.device.as_tensor, and each host scalar written into
a device tensor where that is counted) over both profiled windows of
the traced run, divided by their 2 x trace.calls calls. 0.0 where the
program counts its uploads and none happened; None where the trace
holds no device record or the program does not count its uploads (it
has no utils.device.to_host). Layer: ops and routing (host)."""


def read(trace):
    from benchmark import spans
    c = spans.counters(trace)
    if c is None or not _counts_waits():
        return None
    return c.get("upload.bytes", 0) / (2 * trace.calls * 1024.0)


def _counts_waits():
    from dsptpu_torch.utils import device
    return hasattr(device, "to_host")
