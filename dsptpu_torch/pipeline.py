"""The flagship chain on torch tensors: the port's counterpart of
dsptpu's __graft_entry__.entry.

    filt(b, x)  (127-tap FIR, K1) -> sosfilt(sos, y)  (SOS cascade, K2)
    -> welch_pgram + stft(psdonly=True)  (K3) -> power

`entry()` defaults to the full-width configuration, the 64-channel
stream of dsptpu's BASELINE.json (bench.py's welch/spectrogram config
and weak-scaling pipeline): x (1,000,000 x 64) float32, the 127-tap
Lowpass(0.25) Hamming FIR, Butterworth(8) at 0.2 as 4 sections, and
nfft 1024 with hop 512 and a Hanning window (1952 frames). At this size
every kernel gate of the reference holds. The reference entry's own
configuration is entry(n=16384, channels=4, order=6, cutoff=0.3,
nfft=256); it is too short for the FIR kernel (n < 32768).

As in the reference entry, the cascade is passed as its (nsec, 5)
float32 section array, so sosfilt applies gain 1 (the design's overall
gain g is not applied). The sections and the window stay host numpy
arrays: they are design-time constants that the routing reads on the
host, and a device copy would have to be read back, which waits for the
stream.
"""

import numpy as np
import torch

from .filters import Butterworth, FIRWindow, Lowpass, as_sos, digitalfilter
from .filters.filt import sosfilt
from .ops import windows
from .ops.dspbase import filt
from .ops.periodograms import power, stft, welch_pgram
from .utils.device import check_full_f32, resolve_device

__all__ = ["entry", "chain_params"]


def chain_params(order=8, cutoff=0.2, nfft=1024):
    """Host float32 parameters of the chain: (taps (127,), sos (nsec, 5),
    window (nfft,))."""
    taps = np.asarray(digitalfilter(Lowpass(0.25), FIRWindow.create(
        np.asarray(windows.hamming(127)))), dtype=np.float32)
    sos = as_sos(digitalfilter(Lowpass(cutoff), Butterworth(order)))
    win = np.asarray(windows.hanning(nfft)).astype(np.float32)
    return taps, sos.sos_array().astype(np.float32), win


def entry(device="cuda", n=1_000_000, channels=64, order=8, cutoff=0.2,
          nfft=1024):
    """(forward, (x,)): forward(x) maps x (n, channels) to
    (psd (nfft//2+1, channels), stft power (nfft//2+1, frames, channels));
    x is standard normal float32 from numpy seed 0, on `device`
    (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        check_full_f32()
    taps, sos, win = chain_params(order, cutoff, nfft)
    taps = torch.as_tensor(taps, device=dev)

    def forward(x):
        """x: (n, channels) -> (psd, stft_power), in x's dtype."""
        y = filt(taps, x)
        y = sosfilt(sos, y)
        p = welch_pgram(y, nfft, nfft // 2, window=win)
        s = stft(y, nfft, nfft // 2, window=win, psdonly=True)
        return power(p), s

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((n, channels)).astype(np.float32),
                        device=dev)
    return forward, (x,)
