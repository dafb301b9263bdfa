"""Copy of dsptpu/filters/design.py (numpy only).

Filter design (host, float64 numpy): IIR analog prototypes +
frequency transforms + bilinear transform, windowed-FIR design,
kaiserord, iirnotch, resample_filter.

Capability parity with reference src/Filters/design.jl (Butterworth
:11-33, Chebyshev :39-113, Elliptic :122-228 after Orfanidis' elliptic
lecture notes, response types :252-315, prototype transforms :326-425,
bilinear :445-495, prewarp :498-503, digitalfilter :507-513, iirnotch
:529-539, kaiserord :547-559, FIRWindow :561-595, firprototype
:598-640, scalefactor :642-667, resample_filter :683-720).

Everything here is deterministic float64 host math producing
coefficient arrays that device kernels consume as constants — there is
no reason (and no benefit) to trace filter design onto the TPU.
"""

from dataclasses import dataclass
from fractions import Fraction

import numpy as np

from .coefficients import ZeroPoleGain, Biquad, as_zpk
from ..ops.windows import kaiser as kaiser_window

__all__ = [
    "FilterType",
    "Butterworth", "Chebyshev1", "Chebyshev2", "Elliptic",
    "Lowpass", "Highpass", "Bandpass", "Bandstop", "ComplexBandpass",
    "analogfilter", "digitalfilter", "bilinear", "transform_prototype",
    "kaiserord", "FIRWindow", "iirnotch", "resample_filter",
]


# ---------------------------------------------------------------------------
# analog prototypes (all return ZeroPoleGain in the s domain)
# ---------------------------------------------------------------------------

def Butterworth(n):
    """n-pole Butterworth prototype: poles equally spaced on the unit
    half-circle (reference design.jl:11-33)."""
    if n <= 0:
        raise ValueError("n must be positive")
    i = np.arange(1, n // 2 + 1)
    w = (2.0 * i - 1) / (2 * n)
    upper = -np.sin(np.pi * w) + 1j * np.cos(np.pi * w)
    poles = np.empty(n, np.complex128)
    poles[0: 2 * (n // 2): 2] = upper
    poles[1: 2 * (n // 2) + 1: 2] = np.conj(upper)
    if n % 2 == 1:
        poles[-1] = -1.0
    return ZeroPoleGain([], poles, 1.0, domain="s")


def _cheb_poles(n, eps):
    """Poles on the Chebyshev ellipse (reference design.jl:39-57)."""
    mu = np.arcsinh(1.0 / eps) / n
    b, c = -np.sinh(mu), np.cosh(mu)
    p = np.empty(n, np.complex128)
    i = np.arange(1, n // 2 + 1)
    w = (2.0 * i - 1) / (2 * n)
    upper = b * np.sin(np.pi * w) + 1j * c * np.cos(np.pi * w)
    p[0: 2 * (n // 2): 2] = upper
    p[1: 2 * (n // 2) + 1: 2] = np.conj(upper)
    if n % 2 == 1:
        w = (2.0 * (n // 2) + 1) / (2 * n)
        p[-1] = b * np.sin(np.pi * w)
    return p


def Chebyshev1(n, ripple):
    """Type-I Chebyshev prototype with `ripple` dB passband ripple
    (reference design.jl:59-83)."""
    if n <= 0:
        raise ValueError("n must be positive")
    if ripple < 0:
        raise ValueError("ripple must be non-negative")
    eps = np.sqrt(10.0 ** (ripple / 10) - 1)
    p = _cheb_poles(n, eps)
    k = 1.0
    for i in range(n // 2):
        k *= abs(p[2 * i + 1]) ** 2
    if n % 2 == 0:
        k /= np.sqrt(1 + eps ** 2)
    else:
        k *= -p[-1].real
    return ZeroPoleGain([], p, float(k), domain="s")


def Chebyshev2(n, ripple):
    """Type-II (inverse) Chebyshev prototype with `ripple` dB stopband
    attenuation (reference design.jl:85-113)."""
    if n <= 0:
        raise ValueError("n must be positive")
    if ripple < 0:
        raise ValueError("ripple must be non-negative")
    eps = 1.0 / np.sqrt(10.0 ** (ripple / 10) - 1)
    p = 1.0 / _cheb_poles(n, eps)
    nz = n - (n % 2)
    z = np.empty(nz, np.complex128)
    k = 1.0
    for i in range(n // 2):
        w = (2.0 * (i + 1) - 1) / (2 * n)
        ze = -1j / np.cos(np.pi * w)
        z[2 * i] = ze
        z[2 * i + 1] = np.conj(ze)
        k *= abs(p[2 * i + 1]) ** 2 / abs(ze) ** 2
    if n % 2 == 1:
        k *= -p[-1].real
    return ZeroPoleGain(z, p, float(k), domain="s")


# --- elliptic machinery (Landen/Jacobi; Orfanidis formulation) -------------

def _landen(k, kp=None, niter=7):
    """Descending Landen sequence k_1..k_niter. When the complementary
    modulus kp = k' is known (it is, throughout the elliptic design),
    the pair recursion  k_{i+1} = (1-k'_i)/(1+k'_i),
    k'_{i+1} = 2 sqrt(k'_i)/(1+k'_i)  is used: for k ~ 1 the naive
    sqrt(1-k^2) loses half the significand to cancellation (~1e6 ULP
    in the n=4 elliptic zeros), while the pair form is stable."""
    seq = np.empty(niter)
    if kp is None:
        kp = np.sqrt((1 - k) * (1 + k))
    for i in range(niter):
        k = (1 - kp) / (1 + kp)
        kp = 2 * np.sqrt(kp) / (1 + kp)
        seq[i] = k
    return seq


def _ellip_from_init(init, landen_seq):
    winv = 1.0 / init
    for x in landen_seq[::-1]:
        winv = (winv + x / winv) / (1 + x)
    return 1.0 / winv


def _cde(u, landen_seq):
    return _ellip_from_init(np.cos(np.pi * u / 2), landen_seq)


def _sne(u, landen_seq):
    return _ellip_from_init(np.sin(np.pi * u / 2), landen_seq)


def _asne(w, k):
    """Inverse sn (descending Landen recursion)."""
    oldw = None
    for _ in range(60):
        if oldw is not None and w == oldw:
            break
        oldw = w
        kold = k
        k = (k / (1 + np.sqrt(1 - k * k))) ** 2
        w = 2 * w / ((1 + k) * (1 + np.sqrt(1 - kold ** 2 * w ** 2)))
    return 2 * np.arcsin(w) / np.pi


def Elliptic(n, rp, rs):
    """n-pole elliptic (Cauer) prototype with rp dB passband ripple and
    rs dB stopband attenuation (reference design.jl:160-228)."""
    if n <= 0:
        raise ValueError("n must be positive")
    if rp <= 0:
        raise ValueError("rp must be positive")
    if rp >= rs:
        raise ValueError("rp must be less than rs")

    eps_p = np.sqrt(10.0 ** (rp / 10) - 1)
    eps_s = np.sqrt(10.0 ** (rs / 10) - 1)
    k1 = eps_p / eps_s
    if k1 >= 1:
        raise ValueError("filter order is too high for parameters")

    k1p_sq = 1 - k1 * k1
    k1p = np.sqrt(k1p_sq)
    k1p_landen = _landen(k1p, kp=k1)

    kp = 1.0
    for i in range(1, n // 2 + 1):
        kp *= _sne((2.0 * i - 1) / n, k1p_landen)
    kp = k1p_sq ** (n / 2.0) * kp ** 4

    k = np.sqrt((1 - kp) * (1 + kp))
    k_landen = _landen(k, kp=kp)

    v0 = (-1j / n * _asne(1j / eps_p, k1)).real  # asne of imaginary arg is imaginary

    nz = 2 * (n // 2)
    z = np.empty(nz, np.complex128)
    p = np.empty(n, np.complex128)
    gain = 1.0
    for i in range(1, n // 2 + 1):
        w = (2.0 * i - 1) / n
        ze = -1j / (k * _cde(w, k_landen))
        z[2 * i - 2] = ze
        z[2 * i - 1] = np.conj(ze)
        pole = 1j * _cde(w - 1j * v0, k_landen)
        p[2 * i - 2] = np.conj(pole)
        p[2 * i - 1] = pole
        gain *= abs(pole) ** 2 / abs(ze) ** 2

    if n % 2 == 1:
        pole = 1j * _sne(1j * v0, k_landen)
        p[-1] = pole
        gain *= abs(pole)
    else:
        gain *= 10.0 ** (-rp / 20)

    return ZeroPoleGain(z, p, float(gain.real) if np.iscomplex(gain) else float(gain),
                        domain="s")


# ---------------------------------------------------------------------------
# response types
# ---------------------------------------------------------------------------

def _normalize_freq(w, fs):
    """half-cycles/sample in (0, 1) (reference design.jl:235-240)."""
    if w <= 0:
        raise ValueError("frequencies must be positive")
    f = 2 * w / fs
    if f >= 1:
        raise ValueError(f"frequencies must be less than the Nyquist frequency {fs / 2}")
    return f


def _normalize_complex_freq(w, fs):
    f = 2 * w / fs
    if f >= 2:
        raise ValueError(f"frequencies must be less than the sampling frequency {fs}")
    return f


class FilterType:
    """Abstract response-type base (reference design.jl:5)."""


@dataclass(frozen=True)
class Lowpass(FilterType):
    w: float


@dataclass(frozen=True)
class Highpass(FilterType):
    w: float


@dataclass(frozen=True)
class Bandpass(FilterType):
    w1: float
    w2: float

    def __post_init__(self):
        if not self.w1 < self.w2:
            raise ValueError("w1 must be less than w2")


@dataclass(frozen=True)
class Bandstop(FilterType):
    w1: float
    w2: float

    def __post_init__(self):
        if not self.w1 < self.w2:
            raise ValueError("w1 must be less than w2")


@dataclass(frozen=True)
class ComplexBandpass(FilterType):
    w1: float
    w2: float

    def __post_init__(self):
        if not self.w1 < self.w2:
            raise ValueError("w1 must be less than w2")


# ---------------------------------------------------------------------------
# prototype transforms (s domain, on ZPK)
# ---------------------------------------------------------------------------

def transform_prototype(ftype, proto):
    """LP prototype -> LP/HP/BP/BS at the requested band edges
    (reference design.jl:326-425; sftrans formulas)."""
    proto = as_zpk(proto)
    assert proto.domain == "s"
    z, p, k = proto.z, proto.p, proto.k

    if isinstance(ftype, Lowpass):
        return ZeroPoleGain(ftype.w * z, ftype.w * p,
                            k * ftype.w ** (len(p) - len(z)), domain="s")

    if isinstance(ftype, Highpass):
        num = np.prod(-z) if len(z) else 1.0
        den = np.prod(-p) if len(p) else 1.0
        nmax = max(len(z), len(p))
        newz = np.zeros(nmax, np.complex128)
        newp = np.zeros(nmax, np.complex128)
        newz[: len(z)] = ftype.w / z
        newp[: len(p)] = ftype.w / p
        return ZeroPoleGain(newz, newp, k * float(np.real(num) / np.real(den)),
                            domain="s")

    if isinstance(ftype, Bandpass):
        bw = ftype.w2 - ftype.w1
        prod_w = ftype.w1 * ftype.w2

        def bp_map(c):
            b = c * (bw / 2)
            pm = np.sqrt(b * b - prod_w + 0j)
            return np.concatenate([(b + pm)[:, None], (b - pm)[:, None]],
                                  axis=1).reshape(-1)

        newz = bp_map(z) if len(z) else np.zeros(0, np.complex128)
        newp = bp_map(p) if len(p) else np.zeros(0, np.complex128)
        ncommon = min(len(z), len(p))
        extra = len(p) - ncommon  # zeros at origin for excess poles
        newz = np.concatenate([newz, np.zeros(extra, np.complex128)]) \
            if extra > 0 else newz
        extra_p = len(z) - ncommon
        newp = np.concatenate([newp, np.zeros(extra_p, np.complex128)]) \
            if extra_p > 0 else newp
        return ZeroPoleGain(newz[: 2 * len(z) + len(p) - ncommon],
                            newp[: 2 * len(p) + len(z) - ncommon],
                            k * bw ** (len(p) - len(z)), domain="s")

    if isinstance(ftype, Bandstop):
        bw = ftype.w2 - ftype.w1
        prod_w = ftype.w1 * ftype.w2
        npairs = max(len(z), len(p))

        def bs_map(c):
            b = (bw / 2) / c
            pm = np.sqrt(b * b - prod_w + 0j)
            return np.stack([b - pm, b + pm], axis=1).reshape(-1)

        num = np.prod(-z) if len(z) else 1.0
        den = np.prod(-p) if len(p) else 1.0
        npm = np.sqrt(-complex(prod_w))
        newz = np.empty(2 * npairs, np.complex128)
        newp = np.empty(2 * npairs, np.complex128)
        newz[: 2 * len(z)] = bs_map(z) if len(z) else []
        newp[: 2 * len(p)] = bs_map(p) if len(p) else []
        for arr, nfilled in ((newz, len(z)), (newp, len(p))):
            for i in range(nfilled, npairs):
                arr[2 * i] = -npm
                arr[2 * i + 1] = npm
        return ZeroPoleGain(newz, newp, k * float(np.real(num) / np.real(den)),
                            domain="s")

    raise TypeError(f"unsupported response type {type(ftype)}")


def analogfilter(ftype, proto):
    """Analog filter from prototype (reference design.jl:433)."""
    return transform_prototype(ftype, proto)


def bilinear(f, fs):
    """s -> z bilinear transform on ZPK (reference design.jl:445-495).
    Excess zeros map to z = -1."""
    f = as_zpk(f)
    assert f.domain == "s"
    nz, npoles = len(f.z), len(f.p)
    z = np.full(max(npoles, nz), -1.0 + 0j, np.complex128)
    z[:nz] = (2 + f.z / fs) / (2 - f.z / fs)
    p = (2 + f.p / fs) / (2 - f.p / fs)
    num = np.prod(2 * fs - f.z) if nz else 1.0
    den = np.prod(2 * fs - f.p) if npoles else 1.0
    return ZeroPoleGain(z, p, f.k * float(np.real(num) / np.real(den)),
                        domain="z")


def _prewarp(ftype, fs):
    warp = lambda f: 4 * np.tan(np.pi * f / 2)
    if isinstance(ftype, Lowpass):
        return Lowpass(warp(_normalize_freq(ftype.w, fs)))
    if isinstance(ftype, Highpass):
        return Highpass(warp(_normalize_freq(ftype.w, fs)))
    if isinstance(ftype, Bandpass):
        return Bandpass(warp(_normalize_freq(ftype.w1, fs)),
                        warp(_normalize_freq(ftype.w2, fs)))
    if isinstance(ftype, Bandstop):
        return Bandstop(warp(_normalize_freq(ftype.w1, fs)),
                        warp(_normalize_freq(ftype.w2, fs)))
    raise TypeError(f"unsupported response type {type(ftype)}")


# ---------------------------------------------------------------------------
# FIR design
# ---------------------------------------------------------------------------

def kaiserord(transitionwidth, attenuation=60):
    """Kaiser-window FIR length and shape parameter for a given
    transition width (half-cycles/sample) and stopband attenuation in
    dB (reference design.jl:547-559). Returns (n, alpha)."""
    n = int(np.ceil((attenuation - 7.95) / (np.pi * 2.285 * transitionwidth))) + 1
    if attenuation > 50:
        beta = 0.1102 * (attenuation - 8.7)
    elif attenuation >= 21:
        beta = 0.5842 * (attenuation - 21) ** 0.4 + 0.07886 * (attenuation - 21)
    else:
        beta = 0.0
    return n, beta / np.pi


@dataclass(frozen=True)
class FIRWindow:
    """Windowed-FIR design method (reference design.jl:561-595).
    Construct from a window vector, or from transitionwidth/attenuation
    for an automatic kaiser design."""
    window: tuple
    scale: bool = True

    @staticmethod
    def create(window=None, transitionwidth=None, attenuation=60, scale=True):
        if window is None:
            if transitionwidth is None:
                raise ValueError("must specify transitionwidth")
            n, alpha = kaiserord(transitionwidth, attenuation)
            window = kaiser_window(n, alpha)
        return FIRWindow(tuple(np.asarray(window, dtype=np.float64).tolist()),
                         scale)


def _sinc_proto(n, w):
    k = np.arange(1, n + 1)
    return w * np.sinc(w * (k - (n + 1) / 2))


def firprototype(n, ftype, fs):
    """Windowed-sinc FIR prototype for each response type (reference
    design.jl:598-640)."""
    if isinstance(ftype, Lowpass):
        return _sinc_proto(n, _normalize_freq(ftype.w, fs))
    if isinstance(ftype, Bandpass):
        w1 = _normalize_freq(ftype.w1, fs)
        w2 = _normalize_freq(ftype.w2, fs)
        return _sinc_proto(n, w2) - _sinc_proto(n, w1)
    if isinstance(ftype, Highpass):
        if n % 2 == 0:
            raise ValueError(
                "FIRWindow highpass filters must have an odd number of coefficients")
        out = -_sinc_proto(n, _normalize_freq(ftype.w, fs))
        out[n // 2] += 1
        return out
    if isinstance(ftype, Bandstop):
        if n % 2 == 0:
            raise ValueError(
                "FIRWindow bandstop filters must have an odd number of coefficients")
        w1 = _normalize_freq(ftype.w1, fs)
        w2 = _normalize_freq(ftype.w2, fs)
        out = _sinc_proto(n, w1) - _sinc_proto(n, w2)
        out[n // 2] += 1
        return out
    if isinstance(ftype, ComplexBandpass):
        w1 = _normalize_complex_freq(ftype.w1, fs)
        w2 = _normalize_complex_freq(ftype.w2, fs)
        w_center = (w2 + w1) / 2
        w_cutoff = (w2 - w1) / 2
        lp = _sinc_proto(n, w_cutoff)
        return lp * np.exp(1j * np.pi * w_center * np.arange(n))
    raise TypeError(f"unsupported response type {type(ftype)}")


def _scalefactor(coefs, ftype, fs):
    """Passband normalization constant (reference design.jl:642-667)."""
    n = len(coefs)
    if isinstance(ftype, (Lowpass, Bandstop)):
        return np.sum(coefs)
    if isinstance(ftype, Highpass):
        signs = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
        return np.sum(coefs * signs)
    if isinstance(ftype, Bandpass):
        f = _normalize_freq((ftype.w1 + ftype.w2) / 2, fs)
        k = np.arange(1, n + 1)
        return np.sum(coefs * np.cos(np.pi * f * (k - (n + 1) / 2)))
    if isinstance(ftype, ComplexBandpass):
        f = _normalize_complex_freq((ftype.w1 + ftype.w2) / 2, fs)
        k = np.arange(1, n + 1)
        return abs(np.sum(coefs * np.exp(-1j * np.pi * f * (k - (n + 1) / 2))))
    raise TypeError(f"unsupported response type {type(ftype)}")


def digitalfilter(ftype, proto, fs=2):
    """Digital filter design (reference design.jl:507-513,669-674):
      * IIR: prewarp -> s-domain prototype transform -> bilinear.
      * FIRWindow: windowed-sinc prototype, optionally scaled to unity
        passband gain."""
    if isinstance(proto, FIRWindow):
        window = np.asarray(proto.window)
        coefs = firprototype(len(window), ftype, fs)
        out = coefs * window
        if proto.scale:
            out = out / _scalefactor(out, ftype, fs)
        return out
    return bilinear(transform_prototype(_prewarp(ftype, fs), proto), 2)


def iirnotch(w, bandwidth, fs=2):
    """Second-order IIR notch (reference design.jl:529-539; Orfanidis
    8.2.22/23)."""
    w = _normalize_freq(w, fs)
    bandwidth = _normalize_freq(bandwidth, fs)
    b = 1 / (1 + np.tan(np.pi * bandwidth / 2))
    cosw0 = np.cos(np.pi * w)
    b1 = -2 * b * cosw0
    return Biquad(b, b1, b, b1, 2 * b - 1, domain="z")


# ---------------------------------------------------------------------------
# resample filter design
# ---------------------------------------------------------------------------

def resample_filter(rate, Nphi_or_relbw=None, rel_bw=1.0, attenuation=60):
    """Anti-aliasing FIR for resampling (reference design.jl:683-720).

    * rational/integer `rate` (Fraction or int):
      resample_filter(rate, rel_bw=1.0, attenuation=60)
    * float `rate` (arbitrary resampling):
      resample_filter(rate, Nphi=32, rel_bw=1.0, attenuation=60)
    """
    if isinstance(rate, (int, Fraction)):
        rate = Fraction(rate)
        Nphi = rate.numerator
        decimation = rate.denominator
        if Nphi_or_relbw is not None:
            rel_bw = Nphi_or_relbw
        f_nyq = min(1.0 / Nphi, 1.0 / decimation)
    else:
        Nphi = 32 if Nphi_or_relbw is None else int(Nphi_or_relbw)
        f_nyq = 1.0 / Nphi if rate >= 1.0 else rate / Nphi

    cutoff = f_nyq * rel_bw
    trans_width = cutoff * 0.2
    h_len, alpha = kaiserord(trans_width, attenuation)
    h_len = Nphi * int(np.ceil(h_len / Nphi))
    if h_len % 2 == 0:
        h_len += 1
    h = digitalfilter(Lowpass(cutoff), FIRWindow.create(kaiser_window(h_len, alpha)))
    return h * Nphi
