"""idle_share: 1 - (union of the device's busy intervals) / (wall time
of the profiled closed-loop calls). Layer: device."""


def read(trace):
    busy, window = trace.busy_s(), trace.window_s()
    if busy <= 0 or window <= 0:
        return None
    return 1.0 - busy / window
