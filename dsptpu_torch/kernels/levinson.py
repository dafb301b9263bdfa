"""K5: Levinson-Durbin recursion over a batch of channels, a
hand-written CUDA kernel (csrc/levinson.cu).

Replaces dsptpu/kernels/levinson.py:levinson_pallas (:75; Pallas
`_kernel` :51). From autocorrelation lags R (p+1, C) float32 it computes
per channel the order-p predictor a (p, C), the prediction error err
(C,) and the reflection coefficients refl (p, C), as ops/lpc.levinson
does.

Bounds on an H100: the bytes of R, a, err and refl (4 (3p + 2) C), a
tenth of a microsecond at path B's shape (p 16, C 2500), and the
latency of the recursion's chain of p orders, each a dot and an IEEE
division. The kernel gives each channel one thread whose r and a live
in registers, one instance per order class (8, 16, 32, 64); reads of R
and writes of the outputs are coalesced across the channels of a warp.

`levinson` launches the kernel for a CUDA tensor and runs
`levinson_reference`, the plain PyTorch version (the per-order vector
recursion of ops/lpc.levinson on float32 tensors), for a CPU tensor.
`launches["levinson"]` counts kernel launches.
"""

import ctypes

import torch

from . import _build
from ..utils.profiling import spanned

__all__ = ["levinson", "levinson_reference", "lev_supported", "launches"]

launches = {"levinson": 0}

# dsptpu_levinson(R, ldr, out, p, C, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_entry = None


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


@spanned("kernel.levinson")
def levinson(R, p):
    """Levinson-Durbin recursion of order p on R (>= p+1, C) float32.
    Returns (a (p, C), err (C,), refl (p, C)), contiguous row views of
    one (2p+1, C) tensor. R's rows are read in place where its columns
    are adjacent (stride 1), whatever its row stride."""
    global _entry
    if R.is_cpu:
        return levinson_reference(R[: p + 1], p)
    if R.dtype != torch.float32 or R.ndim != 2:
        raise TypeError("levinson kernel takes (p+1, C) float32 lags")
    C = R.shape[1]
    if R.shape[0] < p + 1 or not lev_supported(p, C, R.dtype):
        raise ValueError("levinson kernel takes 2 <= p <= 64, C >= 128 "
                         "and p+1 lags")
    if R.stride(1) != 1 or R.stride(0) < C:
        R = R[: p + 1].contiguous()
    out = torch.empty((2 * p + 1, C), dtype=torch.float32, device=R.device)
    if _entry is None:
        _entry = _build.entry("levinson", "dsptpu_levinson", _ARGTYPES)
    code = _entry(R.data_ptr(), R.stride(0), out.data_ptr(), p, C,
                  torch.cuda.current_stream(R.get_device()).cuda_stream)
    _build.check("levinson", code, "levinson kernel launch")
    launches["levinson"] += 1
    return out[:p], out[2 * p], out[p: 2 * p]
