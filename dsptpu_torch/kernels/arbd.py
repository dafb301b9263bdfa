"""K7: near-unity arbitrary-rate dual-PFB resampling of a 1-D stream, a
hand-written CUDA kernel (csrc/arbd.cu).

Replaces dsptpu/kernels/arbd.py:arbd_resample_pallas (:359; `_arbd_jit`
:274, `pallas_call` :332). It computes the reference's own definition
(stream_filt.jl:579-625; dsptpu's `_pfb_dot_arb`): with xcat = hist ‖ x,
a (W, nphi) bank pfb and its derivative bank dpfb = taps2pfb(append(
diff(h), 0), nphi),

    y_j = lo_j + alpha_j * hi_j,
    lo_j = sum_{t < W} pfb[t, phi_j] * xcat[end0_j - (W - 1) + t],

and hi_j the same sum over dpfb. end0, phi and alpha come from the host
plan (FIRArbitrary.plan, float64): end0 = history_len + x_idx - 1 is the
0-based window end in xcat. The TPU kernel's rewrite of the sum as
(1 - alpha) lo_phi + alpha lo_{phi+1} plus two boundary terms is an
identity for the matrix unit and is not carried over.

Bound on an H100: the bytes, 4 per input and 4 per output sample
(20.0 MB at 0.9997 over 2,500,000 samples); the 4 W + 2 flops per
output take about as long on the CUDA cores. The plan the kernel reads
(12 bytes per output) is not part of the function's bound. A block
takes a run of outputs; at a near-unity rate their windows span about
as many input samples plus W, which the block stages in shared memory
beside both banks (2 W nphi floats); one thread per output runs the two
dots and the interpolation. See csrc/arbd.cu.

dsptpu's gate is kept: `arbd_supported` (:69), and `arbd_accepts`, the
rejections of dsptpu's `arbd_plan` (:102-183) as a host predicate that
builds none of its TPU tables.

`arbd` launches the kernel for a CUDA tensor and runs `arbd_reference`,
the plain PyTorch version (a gather and a dot per tap), for a CPU
tensor. `launches["arbd"]` counts kernel launches.
"""

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["arbd", "arbd_reference", "arbd_supported", "arbd_accepts",
           "launches", "SEG"]

launches = {"arbd": 0}

_TO = 1024                    # outputs per block

# dsptpu_arbd(hist, hl, x, n, end0, phi, alpha, pfb, dpfb, W, nphi,
#             out_len, to, cap, smem_bytes, y, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_longlong] + [ctypes.c_void_p] * 5 + [
             ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p]

# dsptpu's plan constants (kernels/arbd.py:62-66)
SEG = 32768            # outputs per TPU grid step
NSEG = 40              # max drift segments per block
_XP_CAP = 320          # position rows per step cap


def arbd_supported(nphi, taps, dtype):
    """dsptpu's gate: float32, nphi % 4 == 0, 4 <= nphi <= 32 and
    2 <= taps <= 128."""
    return (dtype == torch.float32
            and nphi % 4 == 0 and 4 <= nphi <= 32
            and 2 <= taps <= 128)


def arbd_accepts(x_idx, out_len, xlen):
    """True where dsptpu's arbd_plan returns a plan: at least SEG
    outputs, no window past the end of xcat (xlen = history + chunk
    length), strictly increasing positions, non-negative block origins,
    at most _XP_CAP rows of positions and NSEG drift segments per
    SEG-output block, and no index past the padded signal. x_idx: the
    plan's 1-based window ends."""
    if out_len < SEG:
        return False
    x_idx = np.asarray(x_idx)[:out_len]
    if np.any(x_idx > xlen):
        return False
    u = x_idx.astype(np.int64) - 1
    if np.any(u[1:] <= u[:-1]):
        return False                      # duplicates or non-monotone
    niter = -(-out_len // SEG)
    npad = niter * SEG - out_len
    if npad:
        u = np.concatenate([u, u[-1] + 1 + np.arange(npad)])
    ub = u.reshape(niter, SEG)
    c = ub - np.arange(SEG, dtype=np.int64)
    row0 = (c.min(axis=1) // 1024) * 8
    if row0.min() < 0:
        return False
    dv = c - 128 * row0[:, None]
    if dv.min() < 0:
        return False
    nw_need = int((ub.max(axis=1) - 128 * row0).max()) + 3
    XP = -(-nw_need // 1024) * 8
    if XP > _XP_CAP:
        return False
    if np.any(np.count_nonzero(np.diff(dv, axis=1), axis=1) + 1 > NSEG):
        return False
    XB = -(-(XP + 2) // 8) * 8 + 8
    npos = (int((row0 // XB).max()) + 2) * XB * 128
    return bool(u[-1] + 2 < npos)


def arbd_reference(hist, x, end0, phi, alpha, pfb, dpfb, out_len):
    """Plain PyTorch version: filters.stream_filt._pfb_dot_arb, a gather
    and a dot per tap for each bank."""
    from ..filters.stream_filt import _pfb_dot_arb
    xcat = x if hist is None else torch.cat([hist, x])
    return _pfb_dot_arb(xcat, pfb.T, dpfb.T, end0[:out_len],
                        phi[:out_len], alpha[:out_len], pfb.shape[0])


def _smem_cap(W):
    """Staged samples per block: a run of _TO outputs spans about _TO
    input samples plus W at a near-unity rate; twice that covers rates
    down to 1/2. A block whose span is larger reads xcat from global
    memory instead."""
    return 2 * _TO + W


def arbd(hist, x, end0, phi, alpha, pfb, dpfb, out_len):
    """Dual-PFB arbitrary-rate outputs of the 1-D float32 stream
    hist ‖ x (hist None: no history): end0, phi (int32) and alpha
    (float32) per output from the host plan, pfb and dpfb (W, nphi)
    float32; (out_len,) float32."""
    if x.device.type == "cpu":
        return arbd_reference(hist, x, end0, phi, alpha, pfb, dpfb, out_len)
    fl = [x, alpha, pfb, dpfb] + ([] if hist is None else [hist])
    if any(t.dtype != torch.float32 for t in fl) or any(
            t.dtype != torch.int32 for t in (end0, phi)):
        raise TypeError("arbd kernel takes float32 signal, history, alpha "
                        "and banks, int32 end0 and phi")
    if (x.ndim != 1 or (hist is not None and hist.ndim != 1)
            or pfb.ndim != 2 or dpfb.shape != pfb.shape
            or any(t.ndim != 1 or t.shape[0] < out_len
                   for t in (end0, phi, alpha))):
        raise ValueError("arbd kernel takes a 1-D signal and history, "
                         "(W, nphi) banks and out_len plan entries")
    ts = fl + [end0, phi]
    if any(t.device != x.device for t in ts) or not all(
            t.is_contiguous() for t in ts):
        raise ValueError("arbd kernel takes contiguous tensors on one "
                         "device")
    W, nphi = pfb.shape
    if not arbd_supported(nphi, W, torch.float32):
        raise ValueError(f"arbd kernel: nphi={nphi} taps={W} fails the "
                         "gate (nphi % 4 == 0, 4 <= nphi <= 32, "
                         "2 <= taps <= 128)")
    if out_len < 1:
        raise ValueError(f"arbd kernel: out_len={out_len} < 1")
    cap = _smem_cap(W)
    smem = 4 * (2 * W * nphi + cap)
    y = torch.empty(out_len, dtype=torch.float32, device=x.device)
    f = _build.entry("arbd", "dsptpu_arbd", _ARGTYPES)
    err = f(0 if hist is None else hist.data_ptr(),
            0 if hist is None else hist.shape[0], x.data_ptr(), x.shape[0],
            end0.data_ptr(), phi.data_ptr(), alpha.data_ptr(),
            pfb.data_ptr(), dpfb.data_ptr(), W, nphi, int(out_len), _TO, cap,
            smem, y.data_ptr(), _build.stream_of(x))
    _build.check("arbd", err, "arbd kernel launch")
    launches["arbd"] += 1
    return y
