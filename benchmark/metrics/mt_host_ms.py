"""mt_host_ms: the host's self time a call, in ms, in the spans of path
D's call, `entry`, `mt_spectrogram`, `kernel.stft`, `mt_cross_spectra`
and `mt_coherence`, over the calls of the device-alone profile
(dsptpu_torch.utils.profiling.self_times): the whole host path of a
call. A program without one of these spans leaves it out; one with none
but `entry` reads None. Layer: ops and routing (host)."""

SPANS = ("entry", "mt_spectrogram", "kernel.stft", "mt_cross_spectra",
         "mt_coherence")


def read(trace):
    from benchmark import spans
    st = spans.self_times(trace)
    if not st or not any(k in st for k in SPANS[1:]):
        return None
    return 1e3 * sum(st.get(k, 0.0) for k in SPANS)
