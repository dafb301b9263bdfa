"""K1: fused causal FIR, a hand-written CUDA kernel (csrc/fir.cu).

Replaces dsptpu/kernels/fir.py:fir_pallas (:140; Pallas `_kernel` :77).
Computes filt(b, x) with zero initial state, y[t] = sum_k b[k] x[t-k],
per channel of a time-major (n,) or (n, C) float32 signal.

Bound on an H100: at 127 taps the 2*nb f32 flops per output on the CUDA
cores (67 TFLOP/s) outweigh the 8 bytes per sample of HBM traffic
(3.35 TB/s). The kernel keeps the FMAs fed from registers: see the
design note at the top of csrc/fir.cu.

`fir` launches the kernel for a CUDA tensor and runs `fir_reference`,
the plain PyTorch version, for a CPU tensor. `launches["fir"]` counts
kernel launches.
"""

import ctypes

import torch

from . import _build

__all__ = ["fir", "fir_reference", "fir_supported", "launches"]

launches = {"fir": 0}

# dsptpu_fir(x, taps, y, n, C, nb, stream)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]


def fir_supported(nb, dtype):
    """The gate of dsptpu's kernels/fir.py:fir_supported: real f32 taps,
    2 <= nb <= 1536."""
    return dtype == torch.float32 and 2 <= nb <= 1536


def fir_reference(x, b):
    """Plain PyTorch version: the same tap-by-tap f32 multiply-add."""
    vec = x.ndim == 1
    x2 = x.reshape(x.shape[0], -1)
    n, nb = x2.shape[0], b.shape[0]
    y = torch.zeros_like(x2)
    for k, bk in enumerate(b.tolist()):
        if k >= n:
            break
        y[k:].add_(x2[: n - k], alpha=bk)
    return y.reshape(n) if vec else y.reshape(x.shape)


def fir(x, b):
    """Causal FIR of x (n,) or (n, C) float32 with taps b (nb,) float32,
    zero initial state; output has x's shape."""
    if x.device.type == "cpu":
        return fir_reference(x, b)
    if x.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("fir kernel takes float32 signal and taps")
    if b.ndim != 1 or not fir_supported(b.shape[0], b.dtype):
        raise ValueError("fir kernel takes 2 <= len(b) <= 1536 taps")
    if x.ndim not in (1, 2) or b.device != x.device:
        raise ValueError("fir kernel takes (n,) or (n, C) on b's device")
    xc = x.contiguous()
    bc = b.contiguous()
    n = xc.shape[0]
    C = 1 if xc.ndim == 1 else xc.shape[1]
    y = torch.empty_like(xc)
    f = _build.entry("fir", "dsptpu_fir", _ARGTYPES)
    err = f(xc.data_ptr(), bc.data_ptr(), y.data_ptr(), n, C, bc.shape[0],
            _build.stream_of(xc))
    _build.check("fir", err, "fir kernel launch")
    launches["fir"] += 1
    return y
