"""Multitaper spectral estimation on torch tensors: mt_pgram,
mt_spectrogram, mt_cross_power_spectra, mt_coherence (port of
dsptpu/ops/multitaper.py; reference src/multitaper.jl).

The taper dimension joins segments and channels as batch dims of one
torch.fft call, and the taper-weighted sums are tensor reductions. The
float64 tapers are host constants: each config uploads them once per
(device, dtype) and keeps them. The port keeps the signal's float type
(float32 in, float32 out).

Where dsptpu's kernel gate holds (real float32 signal, nfft and hop
multiples of 128, 2 <= nfft/128 <= 16, n <= nfft), mt_spectrogram runs
through K3's K-window stack (kernels/stft.py): the signal is read once,
each frame is windowed by every taper w_m / sqrt(r_m) and the K |DFT|^2
are summed in the kernel, with the one-sided doubling folded into its
bin scale; the kernel writes (nbins, nseg, C) in bin order.

The cross-spectral einsum is a complex product outside any kernel (as
in dsptpu); it runs in full float32 (TF32 off) on the card. Where K9's
gate holds (a float32 signal, so complex64 spectra, with at most 16
tapers and 908 channel-taper rows), mt_coherence takes the tapered
spectra straight to K9 (kernels/mtcoh.py), which writes the coherence
without the cross-spectral matrix; its plain version, on a CPU tensor,
is the einsum and coherence_from_cs, bit for bit the other route.

Tracing (utils/profiling): the spans `mt_spectrogram`,
`mt_cross_spectra` (tapered FFT, edge correction, einsum) and
`mt_coherence` (K9's route: the tapered FFT and `kernel.mtcoh`; else the
cross spectra and the coherence from them); the counter
`route.mt_spec.k3` or `route.mt_spec.torch` once an `mt_spectrogram`
call, `route.mt_coh.k9` or `route.mt_coh.cs` once an `mt_coherence`
call, and `table.mt_const.hit` or `.miss` once a `MTConfig.const`
lookup.
"""

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from .periodograms import (Periodogram, Spectrogram, WelchConfig,
                           _num_segments, _stft_kernel_ok, arraysplit)
from .windows import dpss, dpsseig
from ..kernels.mtcoh import mtcoh, mtcoh_supported
from ..utils.device import as_tensor, full_f32, resolve_device
from ..utils.fftutil import nextfastfft
from ..utils.profiling import count, spanned

__all__ = ["allocate_output",
           "MTConfig", "MTSpectrogramConfig", "MTCrossSpectraConfig",
           "MTCoherenceConfig", "dpss_config", "mt_pgram", "mt_spectrogram",
           "mt_cross_power_spectra", "mt_coherence", "CrossPowerSpectra",
           "Coherence", "coherence", "coherence_from_cs"]


def coherence(c):
    """Accessor for the pairwise-coherence array of a Coherence result
    (reference multitaper.jl:742-744)."""
    return c.coherence


@dataclass(frozen=True, eq=False)
class MTConfig:
    """Multitaper configuration (reference multitaper.jl:5-135).
    `window` is the (n, ntapers) float64 taper matrix; `r` the per-taper
    inverse normalization fs*||w_k||^2/weight_k, float64 (ntapers,).
    Configs compare by identity; `_dev` holds the tapers uploaded per
    (device, dtype)."""
    n_samples: int
    fs: float
    nfft: int
    ntapers: int
    onesided: bool
    window: np.ndarray
    r: np.ndarray
    _dev: dict = field(default_factory=dict, repr=False)

    @staticmethod
    def create(n_samples, fs=1.0, nfft=None, window=None, nw=4,
               ntapers=None, taper_weights=None, onesided=True):
        if n_samples <= 0:
            raise ValueError("n_samples must be positive")
        if ntapers is None:
            ntapers = int(2 * nw) - 1
        if ntapers <= 0:
            raise ValueError("ntapers must be positive")
        if nfft is None:
            nfft = nextfastfft(n_samples)
        if nfft < n_samples:
            raise ValueError("must have nfft >= n_samples")
        if fs <= 0:
            raise ValueError("fs must be positive")
        if taper_weights is None:
            taper_weights = np.full(ntapers, 1.0 / ntapers)
        else:
            taper_weights = np.asarray(taper_weights, dtype=np.float64)
        if window is None:
            window = np.asarray(dpss(n_samples, nw, ntapers))
            r = fs / taper_weights
        else:
            window = np.asarray(window, dtype=np.float64)
            ntapers = window.shape[1]
            if len(taper_weights) != ntapers:
                taper_weights = np.full(ntapers, 1.0 / ntapers)
            r = fs * np.sum(window ** 2, axis=0) / taper_weights
        if window.shape[0] != n_samples:
            raise ValueError("window must be (n_samples, ntapers)")
        return MTConfig(int(n_samples), float(fs), int(nfft), int(ntapers),
                        bool(onesided), np.array(window, dtype=np.float64),
                        np.array(r, dtype=np.float64).reshape(-1))

    @property
    def window_array(self):
        return self.window

    @property
    def freq(self):
        if self.onesided:
            return np.fft.rfftfreq(self.nfft, 1.0 / self.fs)
        return np.fft.fftfreq(self.nfft, 1.0 / self.fs)

    def const(self, name, device, dtype):
        """A host constant of the config as a tensor, uploaded once per
        (device, dtype) (a pageable upload waits for the stream):
        "tapers" (ntapers, n), "rinv" 1/r, "w2" 2/r, for the one-sided
        bins "scale" (the doubling) and "corr" (the cross spectra's
        edge-bin 1/sqrt(2)), and K3's "stack" and "stack_scale"
        (_stack_args). Each lookup counts `table.mt_const.hit` or
        `.miss`."""
        key = (name, str(device), dtype)
        t = self._dev.get(key)
        if t is not None:
            count("table.mt_const.hit")
        else:
            count("table.mt_const.miss")
            nfreq = self.nfft // 2 + 1
            host = {"tapers": lambda: self.window.T,
                    "rinv": lambda: 1.0 / self.r,
                    "w2": lambda: 2.0 / self.r,
                    "scale": lambda: _onesided_scale(self.nfft, nfreq),
                    "corr": lambda: _edge_corr(self.nfft, nfreq),
                    "stack": lambda: _stack_args(self)[0],
                    "stack_scale": lambda: _stack_args(self)[1]}[name]()
            t = self._dev[key] = as_tensor(
                np.ascontiguousarray(host), device, "mt_const." + name).to(
                    dtype)
        return t


def dpss_config(n_samples, nw=4, ntapers=None, fs=1.0,
                keep_only_large_evals=False, weight_by_evals=False,
                **kwargs):
    """DPSS MTConfig with eigenvalue filtering/weighting options
    (reference multitaper.jl:52-77)."""
    if ntapers is None:
        ntapers = 2 * int(nw) - 1
    window = np.asarray(dpss(n_samples, nw, ntapers))
    evals = None
    if keep_only_large_evals:
        evals = np.asarray(dpsseig(window, nw))
        mask = evals > 0.9
        window = window[:, mask]
        evals = evals[mask]
        ntapers = window.shape[1]
    if weight_by_evals:
        if evals is None:
            evals = np.asarray(dpsseig(window, nw))
        taper_weights = evals / np.sum(evals)
    else:
        taper_weights = np.full(ntapers, 1.0 / ntapers)
    return MTConfig.create(n_samples, fs=fs, window=window,
                           taper_weights=taper_weights, **kwargs)


def _onesided_scale(nfft, nfreq):
    """Doubling of the one-sided bins that stand for two: all but DC and
    (even nfft) Nyquist."""
    scale = np.ones(nfreq)
    scale[1:] = 2.0
    if nfft % 2 == 0:
        scale[-1] = 1.0
    return scale


def _edge_corr(nfft, nfreq):
    """The cross spectra's one-sided edge-bin correction: DC (and
    Nyquist for even nfft) carry no conjugate partner, so the doubling
    by 2/r over-counts them by 2; those bins are divided by sqrt(2)
    (multitaper.jl:579-582)."""
    corr = np.ones(nfreq)
    corr[0] = 1 / np.sqrt(2)
    if nfft % 2 == 0:
        corr[-1] = 1 / np.sqrt(2)
    return corr


def _tapered_fft(s, config):
    """rfft/fft of the tapered signal, batched over tapers (and any
    leading batch dims of s). s: (..., n); returns (..., ntapers,
    nfreq)."""
    win = config.const("tapers", s.device, s.real.dtype)  # (ntapers, n)
    tapered = s[..., None, :] * win                    # (..., ntapers, n)
    if config.onesided:
        return torch.fft.rfft(tapered, n=config.nfft, dim=-1)
    return torch.fft.fft(tapered, n=config.nfft, dim=-1)


def _mt_power(s, config):
    """Taper-weighted PSD: (..., nfreq). One batched FFT and a reduction
    (the reference's per-taper loop, multitaper.jl:237-240)."""
    pw = _tapered_fft(s, config).abs() ** 2
    out = (pw * config.const("rinv", pw.device, pw.dtype)[:, None]).sum(-2)
    if config.onesided:
        out = out * config.const("scale", out.device, out.dtype)
    return out


def mt_pgram(s, fs=1.0, nfft=None, nw=4, ntapers=None, window=None,
             onesided=None, config=None, device=None):
    """Multitaper periodogram (reference multitaper.jl:177-242) of s
    (n,) or (n, *chans). Returns a Periodogram."""
    s = as_tensor(s, device)
    if onesided is None:
        onesided = not s.is_complex()
    if config is None:
        config = MTConfig.create(s.shape[0], fs=fs, nfft=nfft, window=window,
                                 nw=nw, ntapers=ntapers, onesided=onesided)
    p = _mt_power(s.movedim(0, -1), config).movedim(-1, 0)
    return Periodogram(p, config.freq)


@dataclass(frozen=True, eq=False)
class MTSpectrogramConfig:
    """Multitaper-spectrogram plan: an MTConfig plus the segmentation
    geometry (reference multitaper.jl:248-286)."""
    n_samples: int
    n_overlap_samples: int
    mt_config: MTConfig

    def __post_init__(self):
        if self.mt_config.n_samples <= self.n_overlap_samples:
            raise ValueError("need samples_per_window > n_overlap_samples")

    @staticmethod
    def create(n_samples, samples_per_window=None, n_overlap_samples=None,
               mt_config=None, fs=1.0, **kwargs):
        """MTSpectrogramConfig(n_samples, mt_config, n_overlap) or
        MTSpectrogramConfig(n_samples, samples_per_window, n_overlap,
        fs=..., <MTConfig kwargs>)."""
        if mt_config is None:
            if samples_per_window is None:
                raise ValueError("need samples_per_window or mt_config")
            mt_config = MTConfig.create(samples_per_window, fs=fs, **kwargs)
        if n_overlap_samples is None:
            n_overlap_samples = mt_config.n_samples >> 1
        return MTSpectrogramConfig(int(n_samples), int(n_overlap_samples),
                                   mt_config)

    @property
    def time(self):
        n = self.mt_config.n_samples
        hop = n - self.n_overlap_samples
        nseg = _num_segments(self.n_samples, n, self.n_overlap_samples)
        return (np.arange(nseg) * hop + n / 2) / self.mt_config.fs


@spanned("mt_spectrogram")
def mt_spectrogram(s, n=None, n_overlap=None, fs=1.0, nfft=None, nw=4,
                   ntapers=None, window=None, onesided=None, config=None,
                   device=None):
    """Multitaper spectrogram (reference multitaper.jl:305-391).
    `config` may be an MTSpectrogramConfig or an MTConfig. Trailing
    channel dims batch: returns a Spectrogram with power
    (nfreq, nsegments, *chans)."""
    s = as_tensor(s, device)
    nsamples = s.shape[0]
    if isinstance(config, MTSpectrogramConfig):
        if nsamples != config.n_samples:
            raise ValueError("signal length does not match config.n_samples")
        n_overlap = config.n_overlap_samples
        config = config.mt_config
        n = config.n_samples
    elif config is not None:
        n = config.n_samples
        if n_overlap is None:
            n_overlap = n >> 1
    else:
        if n is None:
            n = nsamples >> 3
        if n_overlap is None:
            n_overlap = n >> 1
        if onesided is None:
            onesided = not s.is_complex()
        config = MTConfig.create(n, fs=fs, nfft=nfft, window=window, nw=nw,
                                 ntapers=ntapers, onesided=onesided)
    hop = n - n_overlap
    if hop <= 0:
        raise ValueError("need n > n_overlap")
    nseg = _num_segments(nsamples, n, n_overlap)
    t = (np.arange(nseg) * hop + n / 2) / config.fs
    if _stft_kernel_ok(s, n, config.nfft, hop):
        count("route.mt_spec.k3")
        return Spectrogram(_kernel_mt_spec(s, n, n_overlap, config),
                           config.freq, t)
    count("route.mt_spec.torch")
    frames = arraysplit(s, n, n_overlap)              # (nseg, n, *chans)
    p = _mt_power(frames.movedim(1, -1), config)      # (nseg, *chans, nfreq)
    return Spectrogram(p.movedim(-1, 0), config.freq, t)


def _stack_args(config):
    """K3's window stack and bin scale for a config, float64 host
    arrays: W_m = win_m / sqrt(r_m) zero-padded to nfft (|F_m|^2 / r_m ==
    |F of W_m seg|^2), and the one-sided doubling (ones if two-sided)."""
    W = np.zeros((config.ntapers, config.nfft))
    W[:, :config.n_samples] = (config.window / np.sqrt(config.r)).T
    nbins = config.nfft // 2 + 1 if config.onesided else config.nfft
    scale = (_onesided_scale(config.nfft, nbins) if config.onesided
             else np.ones(nbins))
    return W, scale


def _kernel_mt_spec(s, n, n_overlap, config):
    """The multitaper spectrogram as one K3 call with the K-window stack
    (_stack_args). Returns (nfreq, nseg, *chans)."""
    from ..kernels.stft import stft_pow
    nseg = _num_segments(s.shape[0], n, n_overlap)
    W = config.const("stack", s.device, s.dtype)
    scale = config.const("stack_scale", s.device, s.dtype)
    pw = stft_pow(s.reshape(s.shape[0], -1), W, config.nfft, n - n_overlap,
                  nseg, False, scale)
    return pw.reshape((len(scale), nseg) + tuple(s.shape[1:]))


@dataclass(frozen=True)
class CrossPowerSpectra:
    power: object  # (n_channels, n_channels, nfreq)
    freq: object


@dataclass(frozen=True)
class Coherence:
    coherence: object
    freq: object


def _freq_mask(freq, freq_range):
    if freq_range is None:
        return slice(None), freq
    lo, hi = freq_range[0], freq_range[-1]
    mask = (freq > lo) & (freq < hi)
    return np.flatnonzero(mask), freq[mask]


@dataclass(frozen=True, eq=False)
class MTCrossSpectraConfig:
    """Plan for mt_cross_power_spectra (reference multitaper.jl:424-516):
    channel count, demeaning, an optional (lo, hi) frequency range and
    the MTConfig."""
    n_channels: int
    demean: bool
    freq_range: Optional[Tuple]
    mt_config: MTConfig

    @staticmethod
    def create(n_channels, n_samples=None, mt_config=None, fs=1.0,
               demean=False, freq_range=None, **kwargs):
        if mt_config is None:
            if n_samples is None:
                raise ValueError("need n_samples or mt_config")
            mt_config = MTConfig.create(n_samples, fs=fs, **kwargs)
        if not mt_config.onesided:
            raise ValueError("mt_cross_power_spectra requires a onesided "
                             "(real-input) MTConfig")
        if freq_range is not None:
            freq_range = (float(freq_range[0]), float(freq_range[-1]))
        return MTCrossSpectraConfig(int(n_channels), bool(demean),
                                    freq_range, mt_config)

    @property
    def freq(self):
        _, freqs = _freq_mask(self.mt_config.freq, self.freq_range)
        return freqs

    @property
    def normalization_weights(self):
        return 2.0 / np.asarray(self.mt_config.r)


@dataclass(frozen=True, eq=False)
class MTCoherenceConfig:
    """Plan for mt_coherence (reference multitaper.jl:656-690): a
    cross-spectra plan."""
    cs_config: MTCrossSpectraConfig

    @staticmethod
    def create(n_channels, n_samples=None, mt_config=None, fs=1.0,
               demean=False, freq_range=None, **kwargs):
        cs = MTCrossSpectraConfig.create(
            n_channels, n_samples, mt_config, fs=fs, demean=demean,
            freq_range=freq_range, **kwargs)
        return MTCoherenceConfig(cs)

    @property
    def freq(self):
        return self.cs_config.freq


@spanned("mt_cross_spectra")
def mt_cross_power_spectra(signal, fs=1.0, demean=False, freq_range=None,
                           nfft=None, nw=4, ntapers=None, window=None,
                           config=None, device=None):
    """Multitapered cross power spectra between channels (reference
    multitaper.jl:544-651, after MNE-python). `signal` is
    (n_channels, n_samples), real. Returns CrossPowerSpectra with an
    (n_channels, n_channels, nfreq) complex tensor."""
    signal = as_tensor(signal, device)
    if signal.is_complex():
        raise ValueError("only real signals supported (onesided)")
    n_channels, n_samples = signal.shape
    if isinstance(config, MTCrossSpectraConfig):
        if n_channels != config.n_channels:
            raise ValueError("channel count does not match config")
        demean = config.demean
        freq_range = config.freq_range
        config = config.mt_config
    elif config is None:
        config = MTConfig.create(n_samples, fs=fs, nfft=nfft, window=window,
                                 nw=nw, ntapers=ntapers, onesided=True)
    if demean:
        signal = signal - signal.mean(dim=1, keepdim=True)
    F = _tapered_fft(signal, config)          # (n_channels, ntapers, nfreq)
    rdt = F.real.dtype
    F = F * config.const("corr", F.device, rdt)
    w = config.const("w2", F.device, rdt)
    idx, freqs = _freq_mask(config.freq, freq_range)
    if not isinstance(idx, slice):
        F = F[:, :, as_tensor(idx, F.device, "mt_cross_spectra.idx")]
    # S^{lm}(f) = sum_k w_k J_k^l(f) conj(J_k^m(f))
    with full_f32():
        out = torch.einsum("lkf,mkf->lmf", F * w[:, None], F.conj())
    return CrossPowerSpectra(out, freqs)


def coherence_from_cs(cs_matrix, device=None):
    """Pairwise coherence from a cross-spectral matrix (reference
    multitaper.jl:704-724)."""
    cs = as_tensor(cs_matrix, device)
    d = torch.diagonal(cs, dim1=0, dim2=1).real.T       # (n_channels, nfreq)
    denom = torch.sqrt(d[:, None, :] * d[None, :, :])
    coh = cs.abs() / denom
    n = cs.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=cs.device)[:, :, None]
    return torch.where(eye, torch.ones((), dtype=coh.dtype,
                                       device=coh.device), coh)


@spanned("mt_coherence")
def mt_coherence(signal, fs=1.0, demean=False, freq_range=None, nfft=None,
                 nw=4, ntapers=None, window=None, config=None, device=None):
    """Pairwise channel coherences (reference multitaper.jl:765-817).
    signal: (n_channels, n_samples); `config` may be an
    MTCoherenceConfig, MTCrossSpectraConfig, or MTConfig. Returns a
    Coherence object. Where K9's gate holds, the tapered spectra go
    straight to K9 (`route.mt_coh.k9`); otherwise the cross spectra of
    mt_cross_power_spectra, then coherence_from_cs (`route.mt_coh.cs`)."""
    if isinstance(config, MTCoherenceConfig):
        config = config.cs_config
    signal = as_tensor(signal, device)
    if signal.is_complex():
        raise ValueError("only real signals supported (onesided)")
    n_channels, n_samples = signal.shape
    if isinstance(config, MTConfig):
        config = MTCrossSpectraConfig(n_channels, demean, freq_range, config)
    elif config is None:
        config = MTCrossSpectraConfig.create(
            n_channels, n_samples, fs=fs, demean=demean,
            freq_range=freq_range, nfft=nfft, nw=nw, ntapers=ntapers,
            window=window)
    elif n_channels != config.n_channels:
        raise ValueError("channel count does not match config")
    mtc = config.mt_config
    idx, freqs = _freq_mask(mtc.freq, config.freq_range)
    spectra = torch.complex64 if signal.dtype == torch.float32 else None
    if not mtcoh_supported(n_channels, mtc.ntapers, len(freqs), spectra):
        count("route.mt_coh.cs")
        cs = mt_cross_power_spectra(signal, config=config)
        return Coherence(coherence_from_cs(cs.power), cs.freq)
    count("route.mt_coh.k9")
    if signal.is_cuda:
        # a transposed view (multitaper_entry's) would make the taper
        # product and the FFT strided passes (0.17 ms against 0.01 at
        # 64 x 16,384 on an H100); the CPU keeps its layout, and so its
        # bits
        signal = signal.contiguous()
    if config.demean:
        signal = signal - signal.mean(dim=1, keepdim=True)
    F = _tapered_fft(signal, mtc)             # (n_channels, ntapers, nfreq)
    corr = mtc.const("corr", F.device, torch.float32)
    w = mtc.const("w2", F.device, torch.float32)
    if not isinstance(idx, slice):
        sel = torch.as_tensor(idx, device=F.device)
        F, corr = F[:, :, sel], corr[sel]
    return Coherence(mtcoh(F, w, corr), freqs)


def allocate_output(config, device=None):
    """Zeros of the output's shape for a config (reference DSP.jl:12,
    multitaper.jl:137,332,518,693), on `device` ("cuda" by default):
    float32, complex64 for cross spectra."""
    dev = resolve_device(device)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)
    if isinstance(config, MTConfig):
        return zeros(len(config.freq))
    if isinstance(config, MTSpectrogramConfig):
        return zeros(len(config.mt_config.freq), len(config.time))
    if isinstance(config, MTCrossSpectraConfig):
        return zeros(config.n_channels, config.n_channels, len(config.freq),
                     dtype=torch.complex64)
    if isinstance(config, MTCoherenceConfig):
        n = config.cs_config.n_channels
        return zeros(n, n, len(config.freq))
    if isinstance(config, WelchConfig):
        nb = (config.nfft // 2 + 1) if config.onesided else config.nfft
        return zeros(nb)
    raise TypeError(f"no allocate_output for {type(config)}")
