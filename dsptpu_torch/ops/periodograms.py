"""Spectral estimation on torch tensors: periodogram (1-D with trailing
channel dims, and 2-D) / Welch / STFT / spectrogram, fftshift_tfr (port
of dsptpu/ops/periodograms.py).

Segmentation is one batch of overlapping frames, the window multiply
broadcasts, and one batched FFT (torch.fft) handles every segment.
Where dsptpu's kernel gate holds (real float32 signal, nfft and hop
multiples of 128, 2 <= nfft/128 <= 16, n <= nfft), Welch and the
PSD-mode STFT instead run through K3 (kernels/stft.py): framing,
window, DFT and |X|^2 (and the Welch sum) in one kernel.
The 2-D periodogram's radial sums bin with `index_add_` (atomics on
CUDA: the sums are not bit-repeatable there, within float rounding).
"""

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import as_tensor
from ..utils.fftutil import nextfastfft, fftintype
from ..utils.profiling import spanned
from . import windows as _windows

__all__ = [
    "arraysplit", "periodogram", "welch_pgram", "spectrogram", "stft",
    "WelchConfig", "Periodogram", "Periodogram2", "Spectrogram", "power",
    "freq", "tfr_time", "fftshift_tfr",
]


# ---------------------------------------------------------------------------
# result containers
# ---------------------------------------------------------------------------

@dataclass
class Periodogram:
    """PSD result: `power` (nbins, *chans), `freq` (nbins,) numpy axis."""
    power: Any
    freq: Any


@dataclass
class Periodogram2:
    """2-D PSD result: `power` (n1, n2), `freq1`, `freq2`."""
    power: Any
    freq1: Any
    freq2: Any


@dataclass
class Spectrogram:
    """Time-frequency PSD: `power` (nbins, nsegments, *chans), `freq`,
    `time`."""
    power: Any
    freq: Any
    time: Any


@spanned("power")
def power(p):
    return p.power


def freq(p):
    if isinstance(p, Periodogram2):
        return (p.freq1, p.freq2)
    return p.freq


def tfr_time(p):
    return p.time


def fftshift_tfr(p):
    """fftshift a two-sided TFR's frequency axis (reference
    periodograms.jl:331-339,777-780); a one-sided one is returned as it
    is."""
    def is_twosided(f):
        return np.any(np.asarray(f) < 0)

    if isinstance(p, Periodogram):
        if not is_twosided(p.freq):
            return p
        return Periodogram(torch.fft.fftshift(p.power, dim=0),
                           np.fft.fftshift(p.freq))
    if isinstance(p, Spectrogram):
        if not is_twosided(p.freq):
            return p
        return Spectrogram(torch.fft.fftshift(p.power, dim=0),
                           np.fft.fftshift(p.freq), p.time)
    if isinstance(p, Periodogram2):
        pw = p.power
        f1, f2 = p.freq1, p.freq2
        if is_twosided(f1):
            pw = torch.fft.fftshift(pw, dim=0)
            f1 = np.fft.fftshift(f1)
        if is_twosided(f2):
            pw = torch.fft.fftshift(pw, dim=1)
            f2 = np.fft.fftshift(f2)
        return Periodogram2(pw, f1, f2)
    raise TypeError(f"cannot fftshift {type(p)}")


# ---------------------------------------------------------------------------
# segmentation + window plumbing
# ---------------------------------------------------------------------------

def _num_segments(length, n, noverlap):
    if not 0 <= noverlap < n:
        raise ValueError("noverlap must be between zero and n")
    return (length - n) // (n - noverlap) + 1 if length >= n else 0


def _bcast(v, like):
    """Host (m,) values as a (1, m, 1, ...) tensor against like, a
    (k, m, *chans) batch, in like's real precision."""
    t = torch.as_tensor(v, device=like.device).to(like.real.dtype)
    return t.reshape((1, -1) + (1,) * (like.ndim - 2))


def arraysplit(s, n, noverlap, nfft=None, window=None, device=None):
    """Split signal into overlapping (optionally windowed, zero-padded to
    nfft) segments, as a (k, nfft, *chans) batch."""
    s = as_tensor(s, device)
    n = int(n)
    nfft = n if nfft is None else int(nfft)
    if nfft < n:
        raise ValueError("nfft must be >= n")
    k = _num_segments(s.shape[0], n, noverlap)
    hop = n - noverlap
    if k == 0:
        return s.new_zeros((0, nfft) + tuple(s.shape[1:]))
    frames = s.unfold(0, n, hop)[:k]                 # (k, *chans, n)
    frames = frames.movedim(-1, 1)                   # (k, n, *chans)
    if window is not None:
        frames = frames * _bcast(_resolve_window(window, n)[0], frames)
    if nfft > n:
        frames = F.pad(frames.movedim(1, -1), (0, nfft - n)).movedim(-1, 1)
    return frames


def _resolve_window(window, n):
    """window may be None, a callable (n -> array), an array or a
    tensor. Returns (float64 numpy window or None, squared L2 norm)."""
    if window is None:
        return None, float(n)
    if callable(window):
        win = np.asarray(window(n), dtype=np.float64)
    else:
        if isinstance(window, torch.Tensor):
            window = window.detach().cpu().numpy()
        win = np.asarray(window, dtype=np.float64)
        if win.shape[0] != n:
            raise ValueError("length of window must match input")
    return win, float(np.sum(win ** 2))


def _psd_from_rfft(F_, nfft, r, onesided, twosided_from_rfft):
    """|F|^2 / r with one/two-sided bin bookkeeping. F_ has shape
    (k, nbins, *chans)."""
    mag = F_.abs() ** 2
    nbins = F_.shape[1]
    if onesided:
        w = np.full(nbins, 2.0)
        w[0] = 1.0
        if nfft % 2 == 0:
            w[-1] = 1.0
        return mag * _bcast(w / r, mag)
    if not twosided_from_rfft:
        return mag / r
    # mirror rfft bins into a full two-sided spectrum
    stop = nbins - 1 if nfft % 2 == 0 else nbins
    tail = mag[:, 1:stop].flip(1)
    return torch.cat([mag, tail], 1) / r


def _fft_segments(frames, nfft, is_real):
    if is_real:
        return torch.fft.rfft(frames, n=nfft, dim=1)
    return torch.fft.fft(frames, n=nfft, dim=1)


def _as_fft_input(s, device):
    s = as_tensor(s, device)
    t = fftintype(s.dtype)
    return s if s.dtype == t else s.to(t)


# ---------------------------------------------------------------------------
# fused segment-DFT kernel path (K3)
# ---------------------------------------------------------------------------

def _stft_kernel_ok(s, n, nfft, hop):
    """dsptpu's _pallas_stft_ok gate."""
    if s.is_complex() or s.dtype != torch.float32:
        return False
    from ..kernels.stft import stft_supported
    return stft_supported(nfft, hop, s.dtype) and n <= nfft


def _psd_weights(nfft, r, onesided):
    """One/two-sided PSD bin weights applied to full-spectrum |X|^2
    bins."""
    nbins = nfft // 2 + 1 if onesided else nfft
    w = np.full(nbins, 1.0 / r)
    if onesided:
        w[1:] *= 2.0
        if nfft % 2 == 0:
            w[-1] /= 2.0
    return w


def _kernel_seg_pow(s, n, noverlap, nfft, win, wts, accumulate):
    """Weighted per-frame (nbins, k, *chans) or frame-summed
    (nbins, *chans) |DFT|^2 through K3, bins in order, nbins = len(wts).
    The weights (dsptpu applies them after its kernel) are folded into
    the kernel's store."""
    from ..kernels.stft import stft_pow
    hop = n - noverlap
    k = _num_segments(s.shape[0], n, noverlap)
    flat = s.reshape(s.shape[0], -1)                  # (len, C)
    wext = np.zeros(nfft)
    wext[:n] = win if win is not None else 1.0
    out = stft_pow(flat, wext, nfft, hop, k, accumulate, wts)
    lead = (len(wts),) if accumulate else (len(wts), k)
    return out.reshape(lead + tuple(s.shape[1:]))


# ---------------------------------------------------------------------------
# periodogram (1-D and 2-D)
# ---------------------------------------------------------------------------

def periodogram(s, onesided=None, nfft=None, fs=1.0, window=None,
                radialsum=False, radialavg=False, device=None):
    """Periodogram of a 1-D signal, which may carry two or more trailing
    channel dims, or of a matrix: the 2-D periodogram, in full
    (Periodogram2) or as its radial sum or average (Periodogram over
    wavenumber), as dsptpu's."""
    s = _as_fft_input(s, device)
    if s.ndim == 2:
        if radialsum and radialavg:
            raise ValueError("radialsum and radialavg are mutually exclusive")
        ptype = 1 if radialsum else (2 if radialavg else 0)
        nfft2 = nfft if isinstance(nfft, tuple) else \
            tuple(nextfastfft(d) for d in s.shape)
        return _periodogram2(s, nfft2, fs, ptype)
    if radialsum or radialavg:
        raise ValueError("radial periodograms require a 2-D input")
    is_real = not s.is_complex()
    if onesided is None:
        onesided = is_real
    if onesided and not is_real:
        raise ValueError("cannot compute one-sided FFT of a complex signal")
    n = s.shape[0]
    nfft = nextfastfft(n) if nfft is None else int(nfft)
    if nfft < n:
        raise ValueError("nfft must be >= length(s)")

    win, norm2 = _resolve_window(window, n)
    if win is not None:
        s = s * _bcast(win, s[None])[0]
    F_ = _fft_segments(s[None], nfft, is_real)
    pw = _psd_from_rfft(F_, nfft, fs * norm2, onesided,
                        twosided_from_rfft=is_real)[0]
    f = (np.fft.rfftfreq(nfft, 1 / fs) if onesided
         else np.fft.fftfreq(nfft, 1 / fs))
    return Periodogram(pw, f)


def _periodogram2(s, nfft, fs, ptype):
    """Full 2-D PSD (ptype 0) or radial sum/average (1/2) (reference
    periodograms.jl:473-509, fft2pow2radial! :183-232)."""
    n1s, n2s = s.shape
    if n1s <= 1 or n2s <= 1:
        raise ValueError("dimensions of s must be > 1")
    n1, n2 = nfft
    if n1s > n1 or n2s > n2:
        raise ValueError("nfft must be >= size(s)")
    r = fs * s.numel()

    if ptype == 0:
        pw = torch.fft.fftn(s, s=(n1, n2)).abs() ** 2 / r
        return Periodogram2(pw, np.fft.fftfreq(n1, 1 / fs),
                            np.fft.fftfreq(n2, 1 / fs))

    mag = torch.fft.fft(torch.fft.rfft(s, n=n1, dim=0), n=n2, dim=1).abs() ** 2
    nmin = min(n1, n2)
    kmax = nmin // 2 + 1
    n1max = n1 // 2 + 1
    # wavenumber of each (i, j) bin, scaled for non-square inputs
    c1, c2 = (n2 / n1, 1.0) if n1 != nmin else (1.0, n1 / n2)
    i = np.arange(n1max)[:, None]
    j = np.arange(n2)[None, :]
    kj1 = np.where(j <= n2 // 2, j, j - n2).astype(np.float64)
    wavenum = np.round(np.sqrt((c1 * i) ** 2 + (c2 * kj1) ** 2)).astype(
        np.int64)
    # doubling weights for the implicit negative-freq half of the rfft axis
    wt = np.full((n1max, n2), 2.0)
    wt[0, :] = 1.0
    wt[-1, :] = 1.0 if n1 % 2 == 0 else 2.0
    seg = np.where(wavenum < kmax, wavenum, kmax)  # overflow bucket
    flat = (mag * torch.as_tensor(wt, device=mag.device).to(mag.dtype)
            ).reshape(-1)
    sums = mag.new_zeros(kmax + 1).index_add_(
        0, torch.as_tensor(seg.reshape(-1), device=mag.device), flat)
    sums = sums[:kmax] / r
    if ptype == 2:
        counts = np.zeros(kmax + 1)
        np.add.at(counts, seg.reshape(-1), wt.reshape(-1))
        sums = sums / torch.as_tensor(np.maximum(counts[:kmax], 1.0),
                                      device=mag.device).to(sums.dtype)
    return Periodogram(sums, np.arange(kmax) * (fs / nmin))


# ---------------------------------------------------------------------------
# Welch
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class WelchConfig:
    """Static Welch plan (hashable)."""
    nsamples: int
    noverlap: int
    onesided: bool
    nfft: int
    fs: float
    window: Optional[tuple]  # window samples as a hashable tuple, or None

    @staticmethod
    def create(nsamples=None, n=None, noverlap=None, onesided=True,
               nfft=None, fs=1.0, window=None, data=None):
        if data is not None:
            nsamples = data.shape[0]
        n = nsamples >> 3 if n is None else int(n)
        noverlap = n >> 1 if noverlap is None else int(noverlap)
        nfft = nextfastfft(n) if nfft is None else int(nfft)
        if nfft < n:
            raise ValueError("nfft must be >= n")
        if isinstance(window, str) and window == "hanning":
            window = _windows.hanning
        win, _ = _resolve_window(window, n)
        return WelchConfig(n, noverlap, onesided, nfft, float(fs),
                           None if win is None else tuple(win.tolist()))


@spanned("welch_pgram")
def welch_pgram(s, n=None, noverlap=None, onesided=None, nfft=None, fs=1.0,
                window=None, config=None, device=None):
    """Welch PSD estimate over overlapping windowed segments; trailing
    channel dims are batched."""
    s = _as_fft_input(s, device)
    is_real = not s.is_complex()
    if config is None:
        if onesided is None:
            onesided = is_real
        config = WelchConfig.create(
            nsamples=s.shape[0], n=n, noverlap=noverlap, onesided=onesided,
            nfft=nfft, fs=fs, window=window)
    if config.onesided and not is_real:
        raise ValueError("cannot compute one-sided FFT of a complex signal")

    win = None if config.window is None else np.asarray(config.window)
    norm2 = float(config.nsamples) if win is None else float(np.sum(win ** 2))
    k = _num_segments(s.shape[0], config.nsamples, config.noverlap)
    if _stft_kernel_ok(s, config.nsamples, config.nfft,
                       config.nsamples - config.noverlap):
        wts = _psd_weights(config.nfft, k * config.fs * norm2,
                           config.onesided)
        pw = _kernel_seg_pow(s, config.nsamples, config.noverlap,
                             config.nfft, win, wts, accumulate=True)
    else:
        frames = arraysplit(s, config.nsamples, config.noverlap,
                            config.nfft, win)
        F_ = _fft_segments(frames, config.nfft, is_real)
        pw = _psd_from_rfft(F_, config.nfft, k * config.fs * norm2,
                            config.onesided, twosided_from_rfft=is_real)
        pw = pw.sum(0)
    f = (np.fft.rfftfreq(config.nfft, 1 / config.fs) if config.onesided
         else np.fft.fftfreq(config.nfft, 1 / config.fs))
    return Periodogram(pw, f)


# ---------------------------------------------------------------------------
# STFT / spectrogram
# ---------------------------------------------------------------------------

@spanned("stft")
def stft(s, n=None, noverlap=None, psdonly=False, onesided=None, nfft=None,
         fs=1.0, window=None, device=None):
    """Short-time Fourier transform: (nbins, k, *chans) DFT coefficients
    (or PSD when psdonly). One batched FFT over all segments."""
    s = _as_fft_input(s, device)
    is_real = not s.is_complex()
    if onesided is None:
        onesided = is_real
    if onesided and not is_real:
        raise ValueError("cannot compute one-sided FFT of a complex signal")
    n = s.shape[0] >> 3 if n is None else int(n)
    noverlap = n >> 1 if noverlap is None else int(noverlap)
    nfft = nextfastfft(n) if nfft is None else int(nfft)

    win, norm2 = _resolve_window(window, n)
    if psdonly and _stft_kernel_ok(s, n, nfft, n - noverlap):
        return _kernel_seg_pow(s, n, noverlap, nfft, win,
                               _psd_weights(nfft, fs * norm2, onesided),
                               accumulate=False)
    frames = arraysplit(s, n, noverlap, nfft, win)   # (k, nfft, *chans)
    F_ = _fft_segments(frames, nfft, is_real)        # (k, nbins, *chans)
    if psdonly:
        out = _psd_from_rfft(F_, nfft, fs * norm2, onesided,
                             twosided_from_rfft=is_real)
    elif not onesided and is_real:
        # mirror rfft coefficients to two-sided
        stop = F_.shape[1] - 1 if nfft % 2 == 0 else F_.shape[1]
        out = torch.cat([F_, F_[:, 1:stop].flip(1).conj()], 1)
    else:
        out = F_
    return out.transpose(0, 1)                       # (nbins, k, *chans)


def spectrogram(s, n=None, noverlap=None, onesided=None, nfft=None, fs=1.0,
                window=None, device=None):
    """Spectrogram = PSD-mode STFT with time axis."""
    s = as_tensor(s, device)
    n = s.shape[0] >> 3 if n is None else int(n)
    noverlap = n >> 1 if noverlap is None else int(noverlap)
    nfft_i = nextfastfft(n) if nfft is None else int(nfft)
    out = stft(s, n, noverlap, psdonly=True, onesided=onesided, nfft=nfft_i,
               fs=fs, window=window)
    is_real = not s.is_complex()
    onesided_eff = is_real if onesided is None else onesided
    f = (np.fft.rfftfreq(nfft_i, 1 / fs) if onesided_eff
         else np.fft.fftfreq(nfft_i, 1 / fs))
    hop = n - noverlap
    k = out.shape[1]
    t = (n / 2 + hop * np.arange(k)) / fs
    return Spectrogram(out, f, t)
