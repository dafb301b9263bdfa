"""route_ms: the host's self time a call, in ms, in the program's spans
that are not a kernel wrapper's (`entry`, the ops' and stages' spans),
over the calls of the device-alone profile
(dsptpu_torch.utils.profiling.self_times). With wrapper_ms it splits
the mean `entry` span. Layer: ops and routing (host)."""


def read(trace):
    from benchmark import spans
    st = spans.self_times(trace)
    if not st:
        return None
    return 1e3 * sum(v for k, v in st.items() if not k.startswith("kernel."))
