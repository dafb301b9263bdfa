"""host_ms: the mean host-clock time, in ms, for the entry's forward(x)
to return, before the synchronize, over the calls of the measured window
(no profiler attached). Layer: ops and routing on the host."""


def read(trace):
    if not trace.host_s:
        return None
    return 1e3 * sum(trace.host_s) / len(trace.host_s)
