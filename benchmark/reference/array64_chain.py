"""Plain reference of the `array64_chain` configuration: the FIR, the
Butterworth cascade with its sections at gain 1, then the Welch PSD and
the STFT power of the filtered stream, over all channels.

The FIR and the cascade are linear and start from rest, so the reference
applies them as one filter: the windowed-sinc taps convolved with the
cascade's impulse response (worked out from the poles, in float64), by
FFT over the whole block. The frames are then windowed and transformed
one by one.
"""

import torch

from benchmark.reference import common


def reference(cfg, x, precision="float64"):
    """{"psd": (nfft//2+1, C), "stft": (nfft//2+1, frames, C)} of the
    block x (n, C) under the configuration `cfg` (its JSON file)."""
    dev = x.device
    taps = common.fir_lowpass(cfg["fir_taps"], cfg["fir_cutoff"],
                              cfg["fir_window"], dev)
    poles, g = common.butterworth_lowpass(cfg["iir_order"], cfg["iir_cutoff"])
    gain = g if cfg["iir_gain"] == "design" else 1.0
    h_iir = common.iir_impulse(poles, cfg["iir_order"], gain,
                               cfg["impulse_len"], dev)
    m = 1 << (taps.shape[0] + h_iir.shape[0] - 2).bit_length()
    h = torch.fft.irfft(torch.fft.rfft(taps, n=m) * torch.fft.rfft(h_iir, n=m),
                        n=m)[: taps.shape[0] + h_iir.shape[0] - 1]
    y = common.fft_filter(x, h, precision)
    win = common.sym_window(cfg["window"], cfg["nfft"], dev)
    frames = common.frame_psd(y, cfg["nfft"], cfg["hop"], win, precision)
    return {"psd": frames.mean(1), "stft": frames}
