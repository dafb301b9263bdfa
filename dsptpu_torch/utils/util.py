"""Signal utilities on torch tensors (port of dsptpu/utils/util.py).

hilbert, rms, rmsfft, meanfreq and the delay/alignment helpers take
tensors (a numpy array or list goes to `device`, "cuda" by default);
the dB helpers take numpy values or tensors and return the same kind.
`unsafe_dot` keeps the reference's windowed dot products for API
parity; the streaming filters never call it (they lower whole blocks
of such dots to one banded product).
"""

import numpy as np
import torch

from .device import as_tensor
from .fftutil import fftintype

__all__ = [
    "hilbert", "db2pow", "db2amp", "pow2db", "amp2db", "dB", "dBa",
    "rms", "rmsfft",
    "meanfreq", "shiftin", "finddelay", "shiftsignal", "alignsignals",
    "unsafe_dot",
]


def unsafe_dot(a, *args, device=None):
    """Windowed dot products of the reference streaming engine
    (util.jl:222-283). Forms (indices 0-based; `last` is the index of
    the LAST element of the window, inclusive):
      unsafe_dot(a, b, last)          -> dot(a, b[last-len(a)+1 : last+1])
      unsafe_dot(A, col, b, last)     -> same with a = A[:, col]
      unsafe_dot(a, b, c, k)          -> dot(a, concat(b[k-1:], c[:k]))
                                         (history b of len(a)-1 + new c)
    """
    a = as_tensor(a, device)
    if a.ndim == 2:
        col = args[0]
        a = a[:, col]
        args = args[1:]
    n = a.shape[0]
    if len(args) == 2:
        b, last = as_tensor(args[0], a.device), int(args[1])
        return torch.dot(a, b[last - n + 1: last + 1])
    b, c, k = (as_tensor(args[0], a.device), as_tensor(args[1], a.device),
               int(args[2]))
    if b.shape[0] != n - 1:
        raise ValueError("len(b) must equal len(a) - 1")
    if not 1 <= k < n:
        raise ValueError("k must be in [1, len(a))")
    return torch.dot(a, torch.cat([b[k - 1:], c[:k]]))


class _DBconvert:
    """`3 * dB == db2pow(3)` (reference util.jl:141-146)."""
    def __rmul__(self, a):
        return db2pow(a)


class _DBaconvert:
    """`3 * dBa == db2amp(3)` (reference util.jl:141-146)."""
    def __rmul__(self, a):
        return db2amp(a)


dB = _DBconvert()
dBa = _DBaconvert()


def hilbert(x, device=None):
    """Analytic representation x_a = x + j*hilbert(x) along axis 0
    (reference src/util.jl:31-87): rfft, double the strictly-positive
    frequency bins, zero the negative half, inverse fft."""
    x = as_tensor(x, device)
    if x.is_complex():
        raise ValueError("hilbert requires a real signal")
    t = fftintype(x.dtype)
    if x.dtype != t:
        x = x.to(t)
    n = x.shape[0]
    Xh = torch.fft.rfft(x, dim=0)
    # bins 1 .. ceil(n/2)-1 are doubled; for even n the Nyquist bin
    # (index n//2) keeps weight 1, DC keeps weight 1.
    nhalf = Xh.shape[0]
    w = torch.ones((nhalf,) + (1,) * (x.ndim - 1), dtype=x.dtype,
                   device=x.device)
    w[1:(n + 1) // 2] = 2.0   # up to the first index NOT doubled
    Xfull = Xh.new_zeros((n,) + tuple(x.shape[1:]))
    Xfull[:nhalf] = Xh * w
    return torch.fft.ifft(Xfull, dim=0)


def db2pow(a):
    """dB -> power ratio (reference src/util.jl:154)."""
    if isinstance(a, torch.Tensor):
        return 10.0 ** (a / 10.0)
    return 10.0 ** (np.asarray(a) / 10.0)


def db2amp(a):
    """dB -> amplitude ratio (reference src/util.jl:162)."""
    if isinstance(a, torch.Tensor):
        return 10.0 ** (a / 20.0)
    return 10.0 ** (np.asarray(a) / 20.0)


def pow2db(a):
    """power ratio -> dB (reference src/util.jl:170)."""
    return 10.0 * (torch.log10(a) if isinstance(a, torch.Tensor)
                   else np.log10(a))


def amp2db(a):
    """amplitude ratio -> dB (reference src/util.jl:178)."""
    return 20.0 * (torch.log10(a) if isinstance(a, torch.Tensor)
                   else np.log10(a))


def rms(s, dims=None, device=None):
    """Root mean square, optionally along `dims` (reference
    src/util.jl:186-192)."""
    sq = as_tensor(s, device).abs() ** 2
    if dims is None:
        return torch.sqrt(sq.mean())
    return torch.sqrt(sq.mean(dim=dims, keepdim=True))


def rmsfft(f, device=None):
    """rms of the signal whose fft is `f` (reference src/util.jl:200)."""
    f = as_tensor(f, device)
    return torch.sqrt((f.abs() ** 2).sum()) / f.numel()


def meanfreq(x, fs=2 * np.pi, device=None):
    """Mean power frequency (reference src/util.jl:211-220)."""
    x = as_tensor(x, device)
    pxx = torch.fft.rfft(x).abs() ** 2
    n = x.shape[0]
    freqs = fs / n * torch.arange(n // 2 + 1, device=x.device,
                                  dtype=pxx.dtype)
    return (pxx * freqs).sum() / pxx.sum()


def shiftin(a, b, device=None):
    """Functional analogue of the reference's `shiftin!`
    (src/util.jl:299-314): shift b into the end of a, returning an array
    of a's length holding the most recent samples."""
    a = as_tensor(a, device)
    b = as_tensor(b, a.device)
    return torch.cat([a, b.to(a.dtype)], 0)[-a.shape[0]:]


def finddelay(x, y, device=None):
    """Delay of x w.r.t. y via the xcorr peak (reference
    src/util.jl:336-347), a Python int. Ties resolve to the lag closest
    to zero."""
    from ..ops.dspbase import xcorr

    x = as_tensor(x, device)
    y = as_tensor(y, x.device)
    s = xcorr(y, x, padmode="none").abs()
    center = x.shape[0]  # 1-based center index
    idx = torch.arange(1, s.shape[0] + 1, device=s.device)
    dist = torch.where(s == s.max(), (center - idx).abs(),
                       torch.iinfo(torch.int64).max)
    return int(center - idx[torch.argmin(dist)])


def shiftsignal(x, s, device=None):
    """Shift x by s samples, zero-filling (reference
    src/util.jl:357-395)."""
    x = as_tensor(x, device)
    s = int(s)
    n = x.shape[0]
    if abs(s) > n:
        raise ValueError("|s| must not be greater than the length of x")
    if s == 0:
        return x
    if s > 0:
        return torch.cat([x.new_zeros((s,) + tuple(x.shape[1:])), x[: n - s]])
    return torch.cat([x[-s:], x.new_zeros((-s,) + tuple(x.shape[1:]))])


def alignsignals(x, y, device=None):
    """Align x to y; returns (aligned_x, delay) (reference
    src/util.jl:404-427)."""
    d = finddelay(x, y, device)
    return shiftsignal(x, -d, device), d
