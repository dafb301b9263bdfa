"""wrapper_ms: the host's self time a call, in ms, in the kernel
wrappers' spans (`kernel.<name>`: gate, tables, launch), over the calls
of the device-alone profile (dsptpu_torch.utils.profiling.self_times).
Layer: kernel wrappers."""


def read(trace):
    from benchmark import spans
    st = spans.self_times(trace)
    if not st:
        return None
    return 1e3 * sum(v for k, v in st.items() if k.startswith("kernel."))
