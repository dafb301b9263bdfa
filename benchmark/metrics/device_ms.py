"""device_ms: the union of the device's busy intervals (kernels, memcpy,
memset) in the traced window, per call, in ms. Layer: kernels and
device ops."""


def read(trace):
    busy = trace.busy_s()
    if busy <= 0 or not trace.calls:
        return None
    return 1e3 * busy / trace.calls
