"""mt_stack_ms: K3's multitaper stack's device time a call, in ms: the
summed duration of the traced window's kernel records named
`stft_kernel<...>` (not the chain's `stft_fused_kernel`), over the
calls. None where the window holds no such record (the spectrogram took
another route). Layer: kernels and device ops."""

from benchmark import devtrace


def is_stack(rec):
    return devtrace.short_name(rec.name).startswith("stft_kernel")


def stack_s(trace):
    """The stack's device seconds a call, or None."""
    recs = [r for r in trace.in_window(kinds=("kernel",)) if is_stack(r)]
    if not recs or not trace.calls:
        return None
    return sum(r.end - r.start for r in recs) / trace.calls


def read(trace):
    s = stack_s(trace)
    return None if s is None else 1e3 * s
