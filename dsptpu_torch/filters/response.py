"""Filter frequency/phase/group-delay/impulse/step responses (port of
dsptpu/filters/response.py: host float64 numpy, with the port's filt for
impresp/stepresp, which return tensors on `device`, "cuda" by default).

Capability parity with reference src/Filters/response.jl (freqresp
:16-52, phaseresp :62-76, grpdelay :96-120, impresp/stepresp :127-140,
default frequency grids :158-175). These are design-time diagnostics:
evaluated in host float64 numpy (polynomial evaluation per coefficient
form, so SOS/ZPK keep their factored accuracy), with filt() reused for
the time responses.
"""

import numpy as np
import torch

from .coefficients import (FilterCoefficients, PolynomialRatio, Biquad,
                           SecondOrderSections, ZeroPoleGain,
                           as_polynomial_ratio, as_zpk, coefb, coefa)
from .filt import filt
from ..utils.unwrap import unwrap

__all__ = ["freqresp", "phaseresp", "grpdelay", "impresp", "stepresp"]


def _eval_H(f, x):
    """Evaluate H at complex points x, form-polymorphically (reference
    response.jl:38-52)."""
    x = np.asarray(x, dtype=np.complex128)
    if isinstance(f, ZeroPoleGain):
        num = np.ones_like(x)
        for z in f.z:
            num = num * (x - z)
        den = np.ones_like(x)
        for p in f.p:
            den = den * (x - p)
        return f.k * num / den
    if isinstance(f, Biquad):
        return (((f.b0 * x + f.b1) * x + f.b2)
                / ((x + f.a1) * x + f.a2))
    if isinstance(f, SecondOrderSections):
        out = np.full_like(x, f.g)
        for q in f.biquads:
            out = out * _eval_H(q, x)
        return out
    pr = as_polynomial_ratio(f)
    if pr.domain == "z":
        # z-domain ratio is a polynomial in z^{-1} (b[0] multiplies z^0)
        u = 1.0 / x
        return (np.polyval(pr.b[::-1], u) / np.polyval(pr.a[::-1], u))
    return np.polyval(pr.b, x) / np.polyval(pr.a, x)


def _freqrange(f):
    if f.domain == "z":
        return np.linspace(0, np.pi, 257)
    zpk = as_zpk(f)
    w_int = np.sort(np.abs(np.concatenate([zpk.p, zpk.z])).astype(float))
    include_zero = w_int.size > 0 and w_int[0] == 0
    nonzero = w_int[w_int > 0]
    if nonzero.size == 0:
        k = abs(zpk.k)
        if not include_zero or not np.isfinite(1 / k if k else np.inf):
            w = 10.0 ** np.arange(-1.0, 7.0)
            w[0] = 0.0
            return w
        return np.linspace(0.0, 10 * max(k, 1 / k), 200)
    w_min, w_max = nonzero[0], nonzero[-1]
    w = 10.0 ** np.linspace(np.log10(w_min) - 1, np.log10(w_max) + 1, 200)
    if include_zero:
        w = np.concatenate([[0.0], w])
    return w


def freqresp(f, w=None):
    """Frequency response at frequencies w (rad/sample for digital,
    rad/s for analog). Without w, returns (H, w) on a default grid
    (reference response.jl:16-35)."""
    if w is None:
        w = _freqrange(f)
        return freqresp(f, w), w
    w = np.asarray(w, dtype=float)
    x = np.exp(1j * w) if f.domain == "z" else 1j * w
    return _eval_H(f, x)


def phaseresp(f, w=None):
    """Unwrapped phase response (reference response.jl:62-76)."""
    if w is None:
        w = _freqrange(f)
        return phaseresp(f, w), w
    h = freqresp(f, w)
    return unwrap(torch.as_tensor(np.angle(h))).numpy()


def _is_sym(x):
    n = len(x) // 2
    return all(x[i] == x[-1 - i] for i in range(n))


def _is_anti_sym(x):
    n = len(x) // 2
    return all(x[i] == -x[-1 - i] for i in range(n + 1))


def grpdelay(f, w=None):
    """Group delay (reference response.jl:96-120). Digital filters use
    the xcorr(b, a) frequency-ramp identity; analog filters the
    analytic derivative."""
    if w is None:
        w = _freqrange(f)
        return grpdelay(f, w), w
    w = np.asarray(w, dtype=float)
    pr = as_polynomial_ratio(f)
    if f.domain == "z":
        b, a = coefb(pr), coefa(pr)
        if len(a) == 1 and (_is_sym(b) or _is_anti_sym(b)):
            return np.full(w.shape, (len(b) - 1) / 2)
        # c = xcorr(b, a), lowest-lag-first; ramp-weighted ratio
        c = np.convolve(b, np.conj(a[::-1]))
        cr = np.arange(len(c)) * c
        ejw = np.exp(-1j * w)
        # c is ordered lowest power of e^{-jw} first
        num = np.polyval(cr[::-1], ejw)
        den = np.polyval(c[::-1], ejw)
        return np.real(num / den) - (len(a) - 1)
    # analog: tau = -d(arg H)/dw = Re[(a'b - b'a) / (a b)](s=jw)
    b, a = pr.b[::-1], pr.a[::-1]  # lowest power first
    P = np.polynomial.polynomial
    bd = P.polyder(b)
    ad = P.polyder(a)
    s = 1j * w
    num = P.polyval(s, P.polysub(P.polymul(ad, b), P.polymul(bd, a)))
    den = P.polyval(s, P.polymul(a, b))
    return np.real(num / den)


def impresp(f, n=100, device=None):
    """Impulse response of a digital filter (reference
    response.jl:127-133)."""
    delta = np.zeros(n)
    delta[0] = 1.0
    if isinstance(f, FilterCoefficients):
        return filt(f, delta, device=device)
    return filt(np.atleast_1d(f), delta, device=device)


def stepresp(f, n=100, device=None):
    """Step response of a digital filter (reference
    response.jl:135-140)."""
    ones = np.ones(n)
    if isinstance(f, FilterCoefficients):
        return filt(f, ones, device=device)
    return filt(np.atleast_1d(f), ones, device=device)
