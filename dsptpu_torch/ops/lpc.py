"""Linear predictive coding on torch tensors: Burg and Levinson-Durbin
estimation (dsptpu/ops/lpc.py).

The recursions are sequential over the model order p; every per-order
update is a vector op over the whole signal or the channel batch, with
channels on trailing dims. Real float32 autocorrelations with at least
128 channels and 2 <= p <= 64 go through K5, the hand-written
Levinson-Durbin kernel (kernels/levinson.py); the wrapper runs its
plain version for a CPU tensor. `lpc` of a multichannel signal forms
its p+1 lags in one batched pass (`_biased_lags`), where dsptpu writes
p+1 shifted products that XLA fuses under jit.

Device rule: a tensor argument stays on its device; a numpy array or a
list goes to `device=` (default "cuda", which must be present).
"""

import torch

from ..kernels.levinson import lev_supported, levinson as lev_kernel
from ..utils.device import as_tensor
from .dspbase import xcorr

__all__ = ["lpc", "arburg", "levinson", "LPCBurg", "LPCLevinson"]


class LPCBurg:
    """Method marker; lpc(..., LPCBurg())."""


class LPCLevinson:
    """Method marker; lpc(..., LPCLevinson())."""


def _inexact(dtype):
    return dtype if (dtype.is_complex or dtype.is_floating_point) \
        else torch.float64


def arburg(x, p, device=None):
    """Burg-method LPC (Vos fast recursion). x: (n,) or (n, *chans).
    Returns (a, prediction_err, reflection_coeffs) with a[0] = 1, a
    shaped (p+1, *chans)."""
    x = as_tensor(x, device)
    vec = x.ndim == 1
    xf = x[:, None] if vec else x.reshape(x.shape[0], -1)
    n, C = xf.shape
    if p >= n:
        raise ValueError("model order must be less than the signal length")
    dtype = _inexact(xf.dtype)
    xf = xf.to(dtype)

    unnormed = (xf.conj() * xf).sum(0).abs()                # (C,)
    pred_err = unnormed / n
    ef = xf
    eb = xf
    a_arr = torch.zeros((p + 1, C), dtype=dtype, device=x.device)
    a_arr[0] = 1
    refl = []
    den = 2 * unnormed
    ratio = torch.ones_like(unnormed)

    for m in range(1, p + 1):
        cf = ef[-1]
        cb = eb[0]
        ef = ef[:-1]
        eb = eb[1:]
        den = ratio * den - (cf.abs() ** 2 + cb.abs() ** 2)
        k = -2 * (eb.conj() * ef).sum(0) / den
        refl.append(k)
        # a[i] += k * conj(a[m-i]) for i = 1..m
        a_arr[1: m + 1] = a_arr[1: m + 1] + k * a_arr[:m].flip(0).conj()
        ef_new = ef + k * eb
        eb = eb + k.conj() * ef
        ef = ef_new
        ratio = 1 - k.abs() ** 2
        pred_err = pred_err * ratio

    a_arr = a_arr.conj().resolve_conj()                     # (p+1, C)
    refl_arr = torch.stack(refl)
    if vec:
        return a_arr[:, 0], pred_err[0], refl_arr[:, 0]
    shape = tuple(x.shape[1:])
    return (a_arr.reshape((p + 1,) + shape), pred_err.reshape(shape),
            refl_arr.reshape((p,) + shape))


def levinson(R, p, device=None):
    """Levinson-Durbin recursion on an autocorrelation sequence. R:
    (>= p+1,) or (m, *chans). Returns (a, prediction_err,
    reflection_coeffs), a shaped (p, *chans)."""
    R = as_tensor(R, device)
    vec = R.ndim == 1
    Rf = R[:, None] if vec else R.reshape(R.shape[0], -1)
    C = Rf.shape[1]
    if Rf.shape[0] < p + 1:
        raise ValueError("need at least p+1 autocorrelation lags")
    dtype = _inexact(Rf.dtype)
    Rf = Rf.to(dtype)
    shape = tuple(R.shape[1:])

    def out(a_arr, pred_err, refl_arr):
        if vec:
            return a_arr[:, 0], pred_err[0], refl_arr[:, 0]
        return (a_arr.reshape((p,) + shape), pred_err.reshape(shape),
                refl_arr.reshape((p,) + shape))

    # dsptpu's _pallas_lev_ok gate without the platform check: the
    # wrapper picks kernel or plain version by the tensor's device
    if not dtype.is_complex and lev_supported(p, C, dtype):
        return out(*lev_kernel(Rf, p))

    k = -Rf[1] / Rf[0]
    pred_err = Rf[0].real * (1 - k.abs() ** 2)
    a_arr = torch.zeros((p, C), dtype=dtype, device=R.device)
    a_arr[0] = k
    refl = [k]
    for m in range(2, p + 1):
        # unconjugated dot: acc = R[m] + sum_{i=1..m-1} R[i] a[m-1-i]
        acc = Rf[m] + (Rf[1:m] * a_arr[: m - 1].flip(0)).sum(0)
        k = -acc / pred_err
        head = a_arr[: m - 1]
        a_arr[: m - 1] = head + k * head.flip(0).conj()
        a_arr[m - 1] = k
        refl.append(k)
        pred_err = pred_err * (1 - k.abs() ** 2)
    return out(a_arr, pred_err, torch.stack(refl))


def _biased_lags(x, p):
    """The p+1 biased autocorrelation lags of x (n, *chans) along axis 0,
    R[l] = sum_t conj(x[t]) x[t+l] / n, (p+1, *chans), in one batched
    pass: the windows of p+1 samples of x zero-padded by p samples (an
    unfolded view) times conj(x), averaged over t. Four launches on the
    card (the pad's fill and copy, the product, the mean); the product
    holds (p+1) n prod(chans) elements."""
    x = x.to(_inexact(x.dtype))
    xp = torch.nn.functional.pad(x, (0, 0) * (x.ndim - 1) + (0, p))
    win = xp.unfold(0, p + 1, 1).movedim(-1, 0)        # (p+1, n, *chans)
    return (x.conj() * win).mean(1)


def lpc(x, p, method="burg", device=None):
    """LPC coefficients and prediction error, without the implicit
    leading 1. method in {"burg", "levinson"} (or the marker classes)."""
    x = as_tensor(x, device)
    if isinstance(method, LPCBurg) or method is LPCBurg:
        method = "burg"
    elif isinstance(method, LPCLevinson) or method is LPCLevinson:
        method = "levinson"
    if method == "burg":
        a, err, _ = arburg(x, p)
        return a[1:], err
    if method == "levinson":
        n = x.shape[0]
        if x.ndim == 1:
            R = xcorr(x, scaling="biased")[n - 1:]
        else:
            R = _biased_lags(x, p)
        a, err, _ = levinson(R, p)
        return a, err
    raise ValueError("method must be 'burg' or 'levinson'")
