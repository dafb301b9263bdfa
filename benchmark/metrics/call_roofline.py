"""call_roofline: the least time one call could take on the card (the
configuration's bytes and operations against the card's peaks,
benchmark/roofline.py) as a share, in %, of the device time the call
took (device_ms). Layer: kernels."""


def read(trace):
    busy = trace.busy_s()
    if trace.bound_s is None or busy <= 0 or not trace.calls:
        return None
    return 100.0 * trace.bound_s / (busy / trace.calls)
