"""launches: device kernel launches per call, counted from the
profiler's device records in the traced window (memcpy and memset
records are not kernels; the harness lists them apart). Layer: kernel
wrappers."""


def read(trace):
    kernels = trace.in_window(kinds=("kernel",))
    if not kernels or not trace.calls:
        return None
    return len(kernels) / trace.calls
