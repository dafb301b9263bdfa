"""osconv_ms: K4's device time a call, in ms: the summed duration of the
traced window's kernel records named `osconv_kernel<...>`, over the
calls. None where the window holds no such record (the call took
another route). Layer: kernels and device ops."""

from benchmark import devtrace


def osconv_s(trace):
    """K4's device seconds a call, or None."""
    recs = [r for r in trace.in_window(kinds=("kernel",))
            if devtrace.short_name(r.name).startswith("osconv_kernel")]
    if not recs or not trace.calls:
        return None
    return sum(r.end - r.start for r in recs) / trace.calls


def read(trace):
    s = osconv_s(trace)
    return None if s is None else 1e3 * s
