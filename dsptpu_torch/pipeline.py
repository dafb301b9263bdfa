"""The flagship chain on torch tensors: the port's counterpart of
dsptpu's __graft_entry__.entry; and the drivers of the other paths
(fftfilt_entry, filtfilt_lpc_entry, resample_entry, multitaper_entry).

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

from fractions import Fraction

import numpy as np
import torch

from .filters import (Butterworth, FIRWindow, Lowpass, as_sos, digitalfilter,
                      resample_filter)
from .filters.filt import fftfilt, filtfilt, sosfilt
from .ops import windows
from .ops.dspbase import filt
from .ops.lpc import lpc
from .filters.stream_filt import FIRFilter
from .ops.multitaper import (MTCoherenceConfig, MTConfig,
                             MTSpectrogramConfig, mt_coherence,
                             mt_spectrogram)
from .ops.periodograms import power, stft, welch_pgram
from .utils.device import check_full_f32, resolve_device

__all__ = ["entry", "chain_params", "fftfilt_entry", "fftfilt_taps",
           "filtfilt_lpc_entry", "resample_entry", "RESAMPLE_RATES",
           "multitaper_entry", "MT_NFFT", "MT_OVERLAP", "MT_NW", "MT_NTAPERS"]


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


def _stream(dev, n, channels):
    """x (n, channels): standard normal float32 from numpy seed 0."""
    rng = np.random.default_rng(0)
    return torch.as_tensor(rng.standard_normal((n, channels)).astype(
        np.float32), device=dev)


def fftfilt_taps(taps=4096):
    """Host float32 taps of path A: the Lowpass(0.1) Hamming FIR."""
    return np.asarray(digitalfilter(Lowpass(0.1), FIRWindow.create(
        np.asarray(windows.hamming(taps)))), dtype=np.float32)


def fftfilt_entry(device="cuda", n=10_000_000, channels=16, taps=4096):
    """(forward, (x,)): forward(x) = fftfilt(h, x), (n, channels), with
    h = fftfilt_taps(taps) on `device`."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        check_full_f32()
    h = torch.as_tensor(fftfilt_taps(taps), device=dev)

    def forward(x):
        """x: (n, channels) -> fftfilt(h, x), in x's dtype."""
        return fftfilt(h, x)

    return forward, (_stream(dev, n, channels),)


def filtfilt_lpc_entry(device="cuda", n=1_000_000, channels=64, order=8,
                       cutoff=0.2, lpc_order=16, flen=400):
    """(forward, (x,)): forward(x) maps x (n, channels) to
    (filtfilt(f, x) (n, channels), (a (lpc_order, nfr), err (nfr,))),
    f the Butterworth(order) lowpass at `cutoff` as sections with its
    gain, and the LPC of the nfr = n // flen frames of flen samples of
    channel 0 of x, as columns of an (flen, nfr) matrix."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        check_full_f32()
    f = as_sos(digitalfilter(Lowpass(cutoff), Butterworth(order)))
    nfr = n // flen

    def forward(x):
        """x: (n, channels) -> (y, (a, err)), in x's dtype."""
        y = filtfilt(f, x)
        # one copy of the frames, as bench.py makes them (.T.copy()):
        # the lag sums then read 4 MB contiguously, not a strided column
        frames = x[: nfr * flen, 0].reshape(nfr, flen).T.contiguous()
        # a range for profiles: the LPC stage's host and device time
        with torch.profiler.record_function("lpc"):
            return y, lpc(frames, lpc_order, method="levinson")

    return forward, (_stream(dev, n, channels),)


# path C's rates: 44.1 kHz -> 48 kHz, 3/2 and a clock-drift correction
RESAMPLE_RATES = (Fraction(147, 160), Fraction(3, 2), 0.9997)


def resample_entry(device="cuda", n=10_000_000, arb_n=2_500_000):
    """(forward, (x,)): forward(x) maps the 1-D stream x (n,) to
    (y_147_160, y_3_2, y_arb), x resampled by the streaming polyphase
    FIRFilter at each rate of RESAMPLE_RATES with the float32 taps of
    resample_filter(rate); the arbitrary rate 0.9997 (32-phase dual PFB)
    takes x[:arb_n]. As bench.py's config 4 does, forward holds one
    FIRFilter per rate and calls reset() then filt() on each call, so
    host plans are cached across calls. x is standard normal float32
    from numpy seed 0, on `device` (CUDA unless the caller asks for the
    CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        check_full_f32()
    fs = [FIRFilter(np.asarray(resample_filter(r), dtype=np.float32), r)
          for r in RESAMPLE_RATES]

    def forward(x):
        """x: (n,) -> one output per rate, in x's dtype."""
        out = []
        for f, xs in zip(fs, (x, x, x[:arb_n])):
            f.reset()
            out.append(f.filt(xs))
        return tuple(out)

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal(n).astype(np.float32),
                        device=dev)
    return forward, (x,)


# path D's multitaper geometry: BASELINE config 3's frames (nfft 1024,
# hop 512) with 7 DPSS tapers of half-bandwidth 4
MT_NFFT, MT_OVERLAP, MT_NW, MT_NTAPERS = 1024, 512, 4, 7


def multitaper_entry(device="cuda", n=1_000_000, channels=64, coh_n=16384):
    """(forward, (x,)): forward(x) maps x (n, channels) to
    (mt_spectrogram power (MT_NFFT//2+1, frames, channels), mt_coherence
    (channels, channels, coh_n//2+1)). The spectrogram takes frames of
    MT_NFFT samples overlapping by MT_OVERLAP (1952 frames at the default
    n) with MT_NTAPERS DPSS tapers of half-bandwidth MT_NW, uniformly
    weighted, fs 1 (K3's K-window stack); the coherence takes the first
    coh_n samples as a channel-major (channels, coh_n) matrix with the
    same tapers, nfft coh_n. x is standard normal float32 from numpy
    seed 0, on `device` (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        check_full_f32()
    spec_cfg = MTSpectrogramConfig.create(
        n, n_overlap_samples=MT_OVERLAP, mt_config=MTConfig.create(
            MT_NFFT, nfft=MT_NFFT, nw=MT_NW, ntapers=MT_NTAPERS))
    coh_cfg = MTCoherenceConfig.create(channels, mt_config=MTConfig.create(
        coh_n, nfft=coh_n, nw=MT_NW, ntapers=MT_NTAPERS))

    def forward(x):
        """x: (n, channels) -> (spectrogram power, coherence), in x's
        dtype."""
        p = mt_spectrogram(x, config=spec_cfg).power
        return p, mt_coherence(x[:coh_n].T, config=coh_cfg).coherence

    return forward, (_stream(dev, n, channels),)
