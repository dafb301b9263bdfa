"""K5: Levinson-Durbin recursion over a batch of channels, a
hand-written CUDA kernel (csrc/levinson.cu).

Replaces dsptpu/kernels/levinson.py:levinson_pallas (:75; Pallas
`_kernel` :51). From autocorrelation lags R (p+1, C) float32 it computes
per channel the order-p predictor a (p, C), the prediction error err
(C,) and the reflection coefficients refl (p, C), as ops/lpc.levinson
does.

Bound on an H100: the bytes of R, a, err and refl (about 8 (p + 1) C
bytes), a few microseconds at any realistic size; the recursion's
p^2 multiply-adds per channel are fewer still. The kernel gives each
channel one thread that keeps R, a and its reversed copy in local
arrays; reads of R and writes of a and refl are coalesced across the
channels of a warp.

`levinson` launches the kernel for a CUDA tensor and runs
`levinson_reference`, the plain PyTorch version (the per-order vector
recursion of ops/lpc.levinson on float32 tensors), for a CPU tensor.
`launches["levinson"]` counts kernel launches.
"""

import ctypes

import torch

from . import _build

__all__ = ["levinson", "levinson_reference", "lev_supported", "launches"]

launches = {"levinson": 0}

# dsptpu_levinson(R, a, err, refl, p, C, stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


def lev_supported(p, C, dtype):
    """The gate of dsptpu's kernels/levinson.py:lev_supported: real
    float32, 2 <= p <= 64, C >= 128."""
    return 2 <= p <= 64 and C >= 128 and dtype == torch.float32


def levinson_reference(R, p):
    """Plain PyTorch version: the order recursion as vector ops over the
    channels. R (p+1, C). Returns (a (p, C), err (C,), refl (p, C))."""
    k = -R[1] / R[0]
    err = R[0] * (1 - k * k)
    a = torch.zeros((p, R.shape[1]), dtype=R.dtype, device=R.device)
    refl = torch.zeros_like(a)
    a[0] = k
    refl[0] = k
    for m in range(2, p + 1):
        acc = R[m] + (R[1:m] * a[: m - 1].flip(0)).sum(0)
        k = -acc / err
        head = a[: m - 1]
        a[: m - 1] = head + k * head.flip(0)
        a[m - 1] = k
        refl[m - 1] = k
        err = err * (1 - k * k)
    return a, err, refl


def levinson(R, p):
    """Levinson-Durbin recursion of order p on R (>= p+1, C) float32.
    Returns (a (p, C), err (C,), refl (p, C))."""
    if R.device.type == "cpu":
        return levinson_reference(R[: p + 1], p)
    if R.dtype != torch.float32 or R.ndim != 2:
        raise TypeError("levinson kernel takes (p+1, C) float32 lags")
    if R.shape[0] < p + 1 or not lev_supported(p, R.shape[1], R.dtype):
        raise ValueError("levinson kernel takes 2 <= p <= 64, C >= 128 "
                         "and p+1 lags")
    Rc = R[: p + 1].contiguous()
    C = Rc.shape[1]
    a = torch.empty((p, C), dtype=torch.float32, device=Rc.device)
    err = torch.empty(C, dtype=torch.float32, device=Rc.device)
    refl = torch.empty_like(a)
    f = _build.entry("levinson", "dsptpu_levinson", _ARGTYPES)
    code = f(Rc.data_ptr(), a.data_ptr(), err.data_ptr(), refl.data_ptr(),
             p, C, _build.stream_of(Rc))
    _build.check("levinson", code, "levinson kernel launch")
    launches["levinson"] += 1
    return a, err, refl
