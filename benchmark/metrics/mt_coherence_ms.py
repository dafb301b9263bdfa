"""mt_coherence_ms: path D's coherence stage's device time a call, in
ms: the summed duration of the traced window's kernel records other than
K3's stack (mt_stack_ms's `stft_kernel`), over the calls: the taper
products, the coherence's transforms, the cross-spectral einsum and the
coherence's passes. None where the window holds no stack record (the
other kernels would then hold the spectrogram's work too). Layer:
kernels and device ops."""

from pathlib import Path

from benchmark import harness


def read(trace):
    stack = harness._load(Path(__file__).with_name("mt_stack_ms.py"),
                          "metric")
    if stack.stack_s(trace) is None:
        return None
    s = sum(r.end - r.start for r in trace.in_window(kinds=("kernel",))
            if not stack.is_stack(r))
    return 1e3 * s / trace.calls
