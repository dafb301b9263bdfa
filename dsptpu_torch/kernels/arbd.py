"""K7: near-unity arbitrary-rate dual-PFB resampling of a 1-D stream, a
hand-written CUDA kernel (csrc/arbd.cu) that derives its plan on the
card from the stream's float64 anchor.

Replaces dsptpu/kernels/arbd.py:arbd_resample_pallas (:359; `_arbd_jit`
:274, `pallas_call` :332). It computes the reference's own definition
(stream_filt.jl:579-625; dsptpu's `_pfb_dot_arb`): with xcat = hist ‖ x,
a (W, nphi) bank pfb and its derivative bank dpfb = taps2pfb(append(
diff(h), 0), nphi),

    y_j = lo_j + alpha_j * hi_j,
    lo_j = sum_{t < W} pfb[t, phi_j] * xcat[end0_j - (W - 1) + t],

and hi_j the same sum over dpfb. The TPU kernel's rewrite of the sum as
(1 - alpha) lo_phi + alpha lo_{phi+1} plus two boundary terms is an
identity for the matrix unit and is not carried over.

The plan (end0, phi, alpha per output) is FIRArbitrary.plan's closed
form, evaluated from an `Anchor`, a few scalars of the stream's state:
output j of a call is the stream's output J = j0 + j, with

    acc = acc_base + J * delta                 (float64)
    q = floor(acc / nphi), rem = acc - q * nphi, + nphi where negative
    end0 = end_off + q, phi = floor(rem), alpha = float32(rem - phi)

rem is exact and equals numpy's mod, so the plan is FIRArbitrary.plan's
bit for bit (end0 = history_len + x_idx - 1). The kernel evaluates it on
the card (`plan_at` in csrc/arbd.cu, the product and the sum rounded
apart); `arbd_plan_from_anchor` is its numpy twin, the same operations
in the same order, from which the CPU route builds the arrays for the
plain version. So the kernel route needs no per-output array on the
host: `arbd_out_len` finds the output count by bisection on the same
scalar expression (x_idx does not decrease with J), and
`arbd_accepts_anchor` decides dsptpu's plan checks from the outputs at
each SEG block's ends.

Bound on an H100: the bytes, 4 per input and 4 per output sample
(20.0 MB at 0.9997 over 2,500,000 samples); the 4 W + 2 flops per
output take about as long on the CUDA cores. A thread owns RUN = 9
consecutive outputs, read from one register window that slides under
them; the outputs from a phase change on in a run go to its block's
split pass, one a thread (see csrc/arbd.cu).

dsptpu's gate is kept: `arbd_supported` (:69), and the rejections of
dsptpu's `arbd_plan` (:102-183), as `arbd_accepts` on the plan's x_idx
and `arbd_accepts_anchor` on the anchor.

`arbd` launches the kernel for a CUDA tensor and, for a CPU tensor,
builds the plan with `arbd_plan_from_anchor` and runs `arbd_reference`,
the plain PyTorch version (a gather and a dot per tap). `launches["arbd"]`
counts kernel launches. `arbd_plan` writes the plan alone (a check of
the card's closed form, called by no route and not counted).
"""

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from ..utils.profiling import spanned

__all__ = ["Anchor", "RUN", "arbd", "arbd_plan", "arbd_plan_from_anchor",
           "arbd_reference", "arbd_out_len", "arbd_supported",
           "arbd_accepts", "arbd_accepts_anchor", "launches", "gate_counts",
           "SEG"]

launches = {"arbd": 0}

RUN = 9                # consecutive outputs a thread (csrc/arbd.cu, kRun)

# arbd_accepts_anchor's decisions: from the anchor's scalars, or from
# x_idx built on the host where the closed form cannot decide
gate_counts = {"anchor": 0, "host_arrays": 0}

# dsptpu_arbd(hist, hl, x, n, acc_base, delta, nphi, j0, end_off, pfb,
#             dpfb, W, out_len, counts, y, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_double, ctypes.c_double,
             ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p]
# dsptpu_arbd_plan(acc_base, delta, nphi, j0, end_off, out_len, end0,
#                  phi, alpha, stream)
_PLAN_ARGTYPES = [ctypes.c_double, ctypes.c_double, ctypes.c_int,
                  ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_void_p]

# dsptpu's plan constants (kernels/arbd.py:62-66)
SEG = 32768            # outputs per TPU grid step
NSEG = 40              # max drift segments per block
_XP_CAP = 320          # position rows per step cap


class Anchor(NamedTuple):
    """A stream's closed form at its current state (FIRArbitrary.anchor):
    output j of the next call has acc = acc_base + (j0 + j) * delta, and
    its window ends at end_off + floor(acc / nphi) in hist ‖ x, where
    hist holds hist_len samples."""
    acc_base: float
    delta: float
    nphi: int
    j0: int
    end_off: int
    hist_len: int


def arbd_supported(nphi, taps, dtype):
    """dsptpu's gate: float32, nphi % 4 == 0, 4 <= nphi <= 32 and
    2 <= taps <= 128."""
    return (dtype == torch.float32
            and nphi % 4 == 0 and 4 <= nphi <= 32
            and 2 <= taps <= 128)


def _closed_form(anchor, j):
    """q = floor(acc / nphi) and rem = acc - q nphi (+ nphi where
    negative), float64, at the stream-global output indices j (int64)."""
    acc = anchor.acc_base + j * anchor.delta
    q = np.floor(acc / anchor.nphi)
    rem = acc - q * anchor.nphi
    return q, np.where(rem < 0, rem + anchor.nphi, rem)


def arbd_plan_from_anchor(anchor, out_len):
    """The plan of the next out_len outputs: end0 (int64, the 0-based
    window end in hist ‖ x), phi (int64) and alpha (float32), the
    operations of csrc/arbd.cu's plan_at in numpy."""
    q, rem = _closed_form(anchor, anchor.j0 + np.arange(out_len,
                                                        dtype=np.int64))
    phi = np.floor(rem)
    return (anchor.end_off + q.astype(np.int64), phi.astype(np.int64),
            (rem - phi).astype(np.float32))


def _u_at(anchor, i):
    """u = x_idx - 1 (0-based window end in the chunk) of the call's
    outputs i (int64 array)."""
    q, _ = _closed_form(anchor, anchor.j0 + np.asarray(i, dtype=np.int64))
    return anchor.end_off - anchor.hist_len + q.astype(np.int64)


def arbd_out_len(anchor, xlen):
    """How many outputs xlen more samples give: the outputs whose window
    end x_idx (1-based in the chunk) is at most xlen, FIRArbitrary.plan's
    count. x_idx does not decrease with J, so the count is found by
    bisection on the scalar closed form, with no per-output array."""
    def fits(i):
        acc = anchor.acc_base + (anchor.j0 + i) * anchor.delta
        return (anchor.end_off - anchor.hist_len + 1
                + math.floor(acc / anchor.nphi)) <= xlen
    if not fits(0):
        return 0
    lo, hi = 0, max(2, int(xlen * anchor.nphi / anchor.delta) + 2)
    while fits(hi):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:           # fits(lo), not fits(hi)
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return hi


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


def arbd_accepts_anchor(anchor, out_len, xlen):
    """arbd_accepts on the plan of the anchor's next out_len outputs,
    decided from the closed form at each SEG block's first and last
    outputs where it can be:

    * u = x_idx - 1 does not decrease, so a window past xcat shows at
      the last output, and u_last - u_first < out_len - 1 means a
      duplicate (an increment of 0): rejected;
    * where every increment of u is provably 1 or 2 (the rounding of
      acc / nphi, at most 8 ulp of the largest |acc| over nphi, cannot
      carry delta / nphi across 1 or 2), c = u - i does not decrease in a
      block, so each block's c.min(), ub.max() and row0 come from its
      first and last outputs, and its drift segments number c_last -
      c_first + 1.

    Where neither decides, that is rate 1 or above without a duplicate in
    the count, rates at or below 1/2, or a J so large that the rounding
    could reach an increment of 0 or 3, x_idx is built on the host from
    arbd_plan_from_anchor and arbd_accepts decides. gate_counts counts
    both ways."""
    if out_len < SEG:
        return False
    ends = _u_at(anchor, [0, out_len - 1])
    if ends[1] + 1 > xlen or ends[1] - ends[0] < out_len - 1:
        gate_counts["anchor"] += 1
        return False
    nphi, delta = anchor.nphi, anchor.delta
    amax = abs(anchor.acc_base) + (abs(anchor.j0) + out_len) * delta
    slack = 2 * 8 * 2.0 ** -53 * amax           # 2 E nphi
    if not (delta - nphi > slack and 2 * nphi - delta > slack):
        gate_counts["host_arrays"] += 1
        end0, _, _ = arbd_plan_from_anchor(anchor, out_len)
        return arbd_accepts(end0 - anchor.hist_len + 1, out_len, xlen)
    gate_counts["anchor"] += 1
    niter = -(-out_len // SEG)
    npad = niter * SEG - out_len
    first = np.arange(niter, dtype=np.int64) * SEG
    u = _u_at(anchor, np.concatenate([first, np.minimum(
        first + SEG, out_len) - 1]))
    c_first, ub_last = u[:niter], u[niter:]
    ub_last[-1] += npad                         # u[-1] + 1 + (npad - 1)
    row0 = (c_first // 1024) * 8
    if row0.min() < 0 or (c_first - 128 * row0).min() < 0:
        return False
    nw_need = int((ub_last - 128 * row0).max()) + 3
    XP = -(-nw_need // 1024) * 8
    if XP > _XP_CAP:
        return False
    if np.any(ub_last - (SEG - 1) - c_first + 1 > NSEG):
        return False
    XB = -(-(XP + 2) // 8) * 8 + 8
    npos = (int((row0 // XB).max()) + 2) * XB * 128
    return bool(ends[1] + 2 < npos)


def arbd_reference(hist, x, end0, phi, alpha, pfb, dpfb, out_len):
    """Plain PyTorch version: filters.stream_filt._pfb_dot_arb, a gather
    and a dot per tap for each bank, on a plan given as arrays."""
    from ..filters.stream_filt import _pfb_dot_arb
    xcat = x if hist is None else torch.cat([hist, x])
    return _pfb_dot_arb(xcat, pfb.T, dpfb.T, end0[:out_len],
                        phi[:out_len], alpha[:out_len], pfb.shape[0])


def _check_anchor(anchor, hist, out_len):
    hl = 0 if hist is None else hist.shape[0]
    if anchor.hist_len != hl:
        raise ValueError(f"arbd: the anchor is for {anchor.hist_len} "
                         f"samples of history, not {hl}")
    if out_len < 1:
        raise ValueError(f"arbd kernel: out_len={out_len} < 1")


@spanned("kernel.arbd")
def arbd(hist, x, anchor, pfb, dpfb, out_len, counts=None):
    """Dual-PFB arbitrary-rate outputs of the 1-D float32 stream
    hist ‖ x (hist None: no history) for the stream's `anchor`, pfb and
    dpfb (W, nphi) float32; (out_len,) float32. counts: None, or an
    int32 (2,) tensor on the card, to which the kernel adds the runs of
    RUN outputs it computes one output at a time (outside the two-phase
    geometry: none under dsptpu's gate) and the outputs its blocks'
    split passes compute (those from a run's phase change on)."""
    _check_anchor(anchor, hist, out_len)
    if x.device.type == "cpu":
        end0, phi, alpha = (torch.from_numpy(a) for a in
                            arbd_plan_from_anchor(anchor, out_len))
        return arbd_reference(hist, x, end0, phi, alpha, pfb, dpfb, out_len)
    fl = [x, pfb, dpfb] + ([] if hist is None else [hist])
    if any(t.dtype != torch.float32 for t in fl):
        raise TypeError("arbd kernel takes float32 signal, history and "
                        "banks")
    if (x.ndim != 1 or (hist is not None and hist.ndim != 1)
            or pfb.ndim != 2 or dpfb.shape != pfb.shape
            or pfb.shape[1] != anchor.nphi):
        raise ValueError("arbd kernel takes a 1-D signal and history and "
                         "(W, nphi) banks of the anchor's nphi")
    ts = fl + ([] if counts is None else [counts])
    if any(t.device != x.device for t in ts) or not all(
            t.is_contiguous() for t in ts):
        raise ValueError("arbd kernel takes contiguous tensors on one "
                         "device")
    if counts is not None and (counts.dtype != torch.int32
                               or counts.numel() < 2):
        raise TypeError("arbd kernel: counts holds two int32 counters")
    W, nphi = pfb.shape
    if not arbd_supported(nphi, W, torch.float32):
        raise ValueError(f"arbd kernel: nphi={nphi} taps={W} fails the "
                         "gate (nphi % 4 == 0, 4 <= nphi <= 32, "
                         "2 <= taps <= 128)")
    y = torch.empty(out_len, dtype=torch.float32, device=x.device)
    f = _build.entry("arbd", "dsptpu_arbd", _ARGTYPES)
    err = f(0 if hist is None else hist.data_ptr(), anchor.hist_len,
            x.data_ptr(), x.shape[0], float(anchor.acc_base),
            float(anchor.delta), nphi, int(anchor.j0), int(anchor.end_off),
            pfb.data_ptr(), dpfb.data_ptr(), W, int(out_len),
            0 if counts is None else counts.data_ptr(), y.data_ptr(),
            _build.stream_of(x))
    _build.check("arbd", err, "arbd kernel launch")
    launches["arbd"] += 1
    return y


def arbd_plan(anchor, out_len, device):
    """The plan of the anchor's next out_len outputs on `device`: end0
    (int64), phi (int32), alpha (float32). On the card, one launch of
    csrc/arbd.cu's plan kernel, the closed form the K7 kernel evaluates
    (not counted in `launches`: no route calls it); on the CPU,
    arbd_plan_from_anchor."""
    device = torch.device(device)
    if device.type == "cpu":
        end0, phi, alpha = arbd_plan_from_anchor(anchor, out_len)
        return (torch.from_numpy(end0), torch.from_numpy(phi.astype(
            np.int32)), torch.from_numpy(alpha))
    if out_len < 1:
        raise ValueError(f"arbd_plan: out_len={out_len} < 1")
    end0 = torch.empty(out_len, dtype=torch.int64, device=device)
    phi = torch.empty(out_len, dtype=torch.int32, device=device)
    alpha = torch.empty(out_len, dtype=torch.float32, device=device)
    f = _build.entry("arbd", "dsptpu_arbd_plan", _PLAN_ARGTYPES)
    err = f(float(anchor.acc_base), float(anchor.delta), int(anchor.nphi),
            int(anchor.j0), int(anchor.end_off), int(out_len),
            end0.data_ptr(), phi.data_ptr(), alpha.data_ptr(),
            _build.stream_of(end0))
    _build.check("arbd", err, "arbd plan launch")
    return end0, phi, alpha
