"""The program's own spans and counters (dsptpu_torch.utils.profiling),
read by the per-layer readers of a traced run.

The harness resets them (kernels.reset_launches) just before its
device-alone profile, so the ring's first `trace.calls` root spans are
that profile's calls, and the counters cover both profiled windows. A
trace with no device record (a run on the CPU), a ring with fewer root
spans than calls, or a program that has no spans or counters reads
None, never an error.
"""


def _profiling(trace, attr):
    """The program's profiling function `attr`, or None where the trace
    holds no device record or the program has no such function."""
    if not trace.in_window() or not trace.calls:
        return None
    from dsptpu_torch.utils import profiling
    return getattr(profiling, attr, None)


def self_times(trace):
    """{span name: mean self seconds a call} over the traced calls, or
    None."""
    f = _profiling(trace, "self_times")
    return None if f is None else f(trace.calls)


def counters(trace):
    """{counter name: count} since the reset, or None."""
    f = _profiling(trace, "counters")
    return None if f is None else f()
