"""Copy of dsptpu/ops/windows.py (numpy only).

Window functions (design-time, host float64 numpy).

Capability parity with reference src/windows.jl (16 window generators,
`makewindow`, `dpss`/`dpsseig`, and 2-D tensor-product windows;
reference src/windows.jl:97-121 for the `makewindow` sampling
convention). Windows are *design artifacts*: they are computed once on
the host in float64 and fed to jitted device code as constants, so this
module is pure numpy by design — the TPU never evaluates a Bessel
function at runtime.

All windows sample a continuous w(x) on x in [-0.5, 0.5]; `zerophase`
produces the DFT-even (periodic, fftshifted) variant; `padding` appends
zeros (in the middle, for zerophase).
"""

import numpy as np

from ..utils.special import besseli0
from ..utils.fftutil import nextfastfft

__all__ = [
    "makewindow", "rect", "hanning", "hann", "hamming", "tukey", "cosine",
    "lanczos", "triang", "bartlett", "gaussian", "bartlett_hann", "blackman",
    "blackmanharris", "nuttall", "kaiser", "flattop", "dpss", "dpsseig",
]


def makewindow(winfunc, n, padding=0, zerophase=False):
    """Sample `winfunc` (vectorized over a float64 array of x in [-0.5, 0.5])
    into a window of length n+padding. Reference src/windows.jl:97-121."""
    n = int(n)
    padding = int(padding)
    if n < 0:
        raise ValueError("`n` must be nonnegative")
    if padding < 0:
        raise ValueError("`padding` must be nonnegative")
    win = np.zeros(n + padding, dtype=np.float64)
    if n == 1:
        win[0] = winfunc(np.float64(0.0))
    elif n > 1:
        if zerophase:
            h = n // 2
            win[: h + 1] = winfunc(np.linspace(0.0, h / n, h + 1))
            if h > 0:
                win[len(win) - h:] = winfunc(np.linspace(-h / n, -1.0 / n, h))
        else:
            win[:n] = winfunc(np.linspace(-0.5, 0.5, n))
    return win


def _window(func):
    """Wrap a w(x) sampler into the standard (n|dims, padding, zerophase) API,
    including the 2-D tensor-product form (reference src/windows.jl:788-813)."""

    def wrapped(n, padding=0, zerophase=False):
        if isinstance(n, tuple):
            return _matrix_window(wrapped, n, None, padding, zerophase)
        return makewindow(func, n, padding, zerophase)

    return wrapped


def _window_arg(maker):
    """Same as _window for windows taking one shape parameter (tukey(alpha), ...)."""

    def wrapped(n, arg, padding=0, zerophase=False):
        if isinstance(n, tuple):
            return _matrix_window(wrapped, n, arg, padding, zerophase)
        return maker(n, arg, padding, zerophase)

    return wrapped


def _dup(v):
    return v if isinstance(v, tuple) else (v, v)


def _matrix_window(func, dims, arg, padding, zerophase):
    pads, zps = _dup(padding), _dup(zerophase)
    if arg is None:
        w1 = func(dims[0], padding=pads[0], zerophase=zps[0])
        w2 = func(dims[1], padding=pads[1], zerophase=zps[1])
    else:
        args = _dup(arg)
        w1 = func(dims[0], args[0], padding=pads[0], zerophase=zps[0])
        w2 = func(dims[1], args[1], padding=pads[1], zerophase=zps[1])
    return np.outer(w1, w2)


rect = _window(lambda x: np.ones_like(np.asarray(x, dtype=np.float64)))
hanning = _window(lambda x: 0.5 * (1.0 + np.cos(2 * np.pi * x)))
hann = hanning
hamming = _window(lambda x: 0.54 + 0.46 * np.cos(2 * np.pi * x))
cosine = _window(lambda x: np.cos(np.pi * x))
lanczos = _window(lambda x: np.sinc(2.0 * np.asarray(x, dtype=np.float64)))
bartlett = _window(lambda x: 1.0 - np.abs(2.0 * x))
bartlett_hann = _window(
    lambda x: 0.62 - 0.48 * np.abs(x) + 0.38 * np.cos(2 * np.pi * x))
blackman = _window(
    lambda x: 0.42 + 0.5 * np.cos(2 * np.pi * x) + 0.08 * np.cos(4 * np.pi * x))
flattop = _window(lambda x: (
    0.21557895
    + 0.41663158 * np.cos(2 * np.pi * x)
    + 0.277263158 * np.cos(4 * np.pi * x)
    + 0.083578947 * np.cos(6 * np.pi * x)
    + 0.006947368 * np.cos(8 * np.pi * x)))


def _triang(n, padding=0, zerophase=False):
    if isinstance(n, tuple):
        return _matrix_window(_triang, n, None, padding, zerophase)
    m = n + 1 if zerophase else n
    scale = 2.0 * (m - 1) / m if m % 2 == 0 else 2.0 * (m - 1) / (m + 1)
    return makewindow(lambda x: 1.0 - scale * np.abs(x), n, padding, zerophase)


triang = _triang


def _tukey(n, alpha, padding=0, zerophase=False):
    if not 0 <= alpha <= 1:
        raise ValueError("alpha must be in the range [0, 1]")
    if abs(alpha) <= np.finfo(np.float64).eps:
        return rect(n, padding=padding, zerophase=zerophase)

    def f(x):
        x = np.asarray(x, dtype=np.float64)
        lo = 0.5 * (1.0 + np.cos(2 * np.pi / alpha * (x + (1 - alpha) / 2)))
        hi = 0.5 * (1.0 + np.cos(2 * np.pi / alpha * (x - (1 - alpha) / 2)))
        return np.where(x <= -(1 - alpha) / 2, lo,
                        np.where(x <= (1 - alpha) / 2, 1.0, hi))

    return makewindow(f, n, padding, zerophase)


tukey = _window_arg(_tukey)


def _gaussian(n, sigma, padding=0, zerophase=False):
    if sigma <= 0.0:
        raise ValueError("sigma must be positive")
    return makewindow(lambda x: np.exp(-0.5 * np.square(x / sigma)),
                      n, padding, zerophase)


gaussian = _window_arg(_gaussian)


def _blackmanharris(n, term=4, padding=0, zerophase=False):
    if term == 4:
        a = (0.35875, 0.48829, 0.14128, 0.01168)
    elif term == 3:
        a = (0.42323, 0.49755, 0.07922)
    else:
        raise ValueError("`term` must be either 3 or 4")
    return makewindow(lambda x: _cos_sum(x, a), n, padding, zerophase)


def _nuttall(n, term=4, padding=0, zerophase=False):
    if term == 4:
        a = (0.3635819, 0.4891775, 0.1365995, 0.0106411)
    elif term == 3:
        a = (0.4243801, 0.4973406, 0.0782793)
    else:
        raise ValueError("`term` must be either 3 or 4")
    return makewindow(lambda x: _cos_sum(x, a), n, padding, zerophase)


def _cos_sum(x, coefs):
    x = np.asarray(x, dtype=np.float64)
    acc = np.full_like(x, coefs[0])
    for k, c in enumerate(coefs[1:], start=1):
        acc = acc + c * np.cos(2 * np.pi * k * x)
    return acc


def blackmanharris(n, term=4, padding=0, zerophase=False):
    if isinstance(n, tuple):
        return _matrix_window(blackmanharris, n, term, padding, zerophase)
    return _blackmanharris(n, term, padding, zerophase)


def nuttall(n, term=4, padding=0, zerophase=False):
    if isinstance(n, tuple):
        return _matrix_window(nuttall, n, term, padding, zerophase)
    return _nuttall(n, term, padding, zerophase)


def _kaiser(n, alpha, padding=0, zerophase=False):
    pf = 1.0 / besseli0(np.pi * alpha)
    return makewindow(
        lambda x: pf * besseli0(np.pi * alpha * np.sqrt(
            np.maximum(1.0 - np.square(2.0 * x), 0.0))),
        n, padding, zerophase)


kaiser = _window_arg(_kaiser)


def dpss(n, nw, ntapers=None, padding=0, zerophase=False):
    """First `ntapers` discrete prolate spheroidal sequences as an
    (n, ntapers) float64 matrix (reference src/windows.jl:668-726;
    Gruenbacher & Hummels tridiagonal formulation).

    Sign convention: antisymmetric tapers start with a positive element.
    """
    n = int(n)
    if ntapers is None:
        ntapers = int(np.ceil(2 * nw)) - 1
    if n % 2 == 1 and zerophase:
        raise ValueError("dpss does not support odd-length zerophase windows")
    if zerophase:
        n += 1
    if not (0 < ntapers <= n):
        raise ValueError("ntapers must be in the interval (0, n]")
    if not (0 <= nw < n / 2):
        raise ValueError("nw must be in the interval [0, n/2)")

    i = np.arange(n, dtype=np.float64)
    v = np.cos(2 * np.pi * nw / n)
    dv = v * np.square((n - 1) / 2.0 - i)
    j = np.arange(1, n, dtype=np.float64)
    ev = 0.5 * (j * n - j * j)

    vecs = _tridiag_top_eigvecs(dv, ev, ntapers)  # (n, ntapers), descending eig

    # Slepian's convention: antisymmetric (odd-index) tapers start positive.
    for c in range(1, vecs.shape[1], 2):
        col = vecs[:, c]
        nz = np.flatnonzero(col)
        if nz.size:
            vecs[:, c] = col * np.sign(col[nz[0]])

    if zerophase:
        vecs = vecs[:-1, :]
    if padding > 0:
        vecs = np.vstack([vecs, np.zeros((padding, ntapers))])
    if zerophase:
        vecs = np.fft.ifftshift(vecs, axes=0)
    return vecs


def _tridiag_top_eigvecs(dv, ev, k):
    """Top-k eigenvectors (by eigenvalue, descending) of the symmetric
    tridiagonal matrix with diagonal dv and off-diagonal ev."""
    try:  # fast tridiagonal path when scipy is present
        from scipy.linalg import eigh_tridiagonal

        n = len(dv)
        _, vecs = eigh_tridiagonal(dv, ev, select="i",
                                   select_range=(n - k, n - 1))
        return vecs[:, ::-1].copy()
    except ImportError:
        mat = np.diag(dv) + np.diag(ev, 1) + np.diag(ev, -1)
        _, vecs = np.linalg.eigh(mat)
        return vecs[:, : -k - 1: -1].copy()


def dpsseig(A, nw):
    """Energy-concentration eigenvalues for dpss tapers `A` (n, ntapers)
    (reference src/windows.jl:739-776, Percival & Walden ex. 8.1)."""
    A = np.asarray(A, dtype=np.float64)
    n = A.shape[0]
    if not (0 <= nw < n / 2):
        raise ValueError("nw must be in the interval [0, n/2)")
    w = nw / n
    i = np.arange(n, dtype=np.float64)
    seq = np.where(i == 0, 1.0, 2.0 * np.sinc(2 * w * i))
    nfft = nextfastfft(2 * n - 1)
    spec = np.abs(np.fft.rfft(A, n=nfft, axis=0)) ** 2
    acorr = np.fft.irfft(spec, n=nfft, axis=0)[:n, :]
    return 2.0 * w * (seq @ acorr)
