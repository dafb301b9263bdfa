"""K1: fused causal FIR, a hand-written CUDA kernel (csrc/fir.cu).

Replaces dsptpu/kernels/fir.py:fir_pallas (:140; Pallas `_kernel` :77).
Computes filt(b, x) with zero initial state, y[t] = sum_k b[k] x[t-k],
per channel of a time-major (n,) or (n, C) float32 signal.

Bound on an H100: at 127 taps the 2*nb f32 flops per output on the CUDA
cores (67 TFLOP/s) outweigh the 8 bytes per sample of HBM traffic
(3.35 TB/s). The kernel is persistent: one wave of blocks, each walking a
run of time tiles of one channel group, its input history kept on chip
in a shared-memory ring, the next tile staged by cp.async while the
current one computes; each thread slides a register window of 16 outputs
by one sample per tap over two adjacent channels that share the taps.
See the design note at the top of csrc/fir.cu. `_plan` fixes the block
geometry (channels a block, ring size, runs) for the kernel.

`fir` launches the kernel for a CUDA tensor and runs `fir_reference`,
the plain PyTorch version, for a CPU tensor. `launches["fir"]` counts
kernel launches.
"""

import ctypes

import torch

from . import _build
from ..utils.profiling import spanned

__all__ = ["fir", "fir_reference", "fir_supported", "launches"]

launches = {"fir": 0}

THREADS = 256           # threads a block
R = 16                  # outputs a thread, rows a ring segment
MAX_SMEM = 232448       # dynamic shared memory a block can have on sm_90

# dsptpu_fir(x, taps, y, n, C, nb, nbp, cw, nseg, ntiles, runs, smem, stream)
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 5
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])
_OCC_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_wave = {}              # (device index, cw, smem) -> resident blocks


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


def _plan(n, C, nb):
    """The kernel's geometry for an (n, C) signal and nb taps: cw
    channels a block (1 at C = 1, else 2 per thread times ncl threads a
    row, a power of two up to 32, halved until the ring fits), v channels
    a thread, tt output times a tile, nbp taps padded to a multiple of
    2R, the ring of nseg segments of R rows (sseg floats each: R rows of
    cw floats, plus cw floats of padding below cw = 32), smem bytes (the
    taps, the ring and, at C = 1, the warps' output buffers), channel
    groups and time tiles."""
    nbp = -(-nb // (2 * R)) * (2 * R)
    cw = 1 if C == 1 else min(32, 1 << (C - 1).bit_length())
    while True:
        v = 1 if cw == 1 else 2
        ncl = cw // v
        tt = THREADS // ncl * R
        sseg = R * cw + (cw if cw < 32 else 0)
        nseg = (nbp + 2 * tt) // R
        # at C = 1 each warp stages its 512 outputs (17 floats a lane)
        smem = 4 * (nbp + nseg * sseg + (THREADS * (R + 1) if v == 1 else 0))
        if smem <= MAX_SMEM or cw <= 2:
            break
        cw //= 2
    return dict(cw=cw, v=v, ncl=ncl, tt=tt, nbp=nbp, sseg=sseg, nseg=nseg,
                smem=smem, groups=-(-C // cw), ntiles=-(-n // tt))


def _runs(plan, wave):
    """Blocks per channel group: one wave of `wave` resident blocks over
    the groups, at most one block per tile. Run r of a group takes tiles
    [ntiles r / runs, ntiles (r + 1) / runs)."""
    return max(1, min(plan["ntiles"], wave // plan["groups"]))


def _resident(device, plan):
    """Blocks of the plan's kernel that the card holds at once."""
    key = (device.index, plan["cw"], plan["smem"])
    if key not in _wave:
        f = _build.entry("fir", "dsptpu_fir_blocks_per_sm", _OCC_ARGTYPES)
        per_sm = ctypes.c_int(0)
        _build.check("fir", f(plan["cw"], plan["smem"],
                              ctypes.addressof(per_sm)), "fir occupancy")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _wave[key] = max(1, per_sm.value) * sms
    return _wave[key]


@spanned("kernel.fir")
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
    p = _plan(n, C, bc.shape[0])
    runs = _runs(p, _resident(xc.device, p))
    f = _build.entry("fir", "dsptpu_fir", _ARGTYPES)
    err = f(xc.data_ptr(), bc.data_ptr(), y.data_ptr(), n, C, bc.shape[0],
            p["nbp"], p["cw"], p["nseg"], p["ntiles"], runs, p["smem"],
            _build.stream_of(xc))
    _build.check("fir", err, "fir kernel launch")
    launches["fir"] += 1
    return y
