"""IIR core of dsptpu/filters/filt.py on torch tensors: the block
state-space form of an LTI filter, SOS cascades and the `filt`
dispatcher.

The recurrence z_t = A z_{t-1} + c x_t, y_t = d x_t + w'z_{t-1} runs as
a blocked parallel pass: samples are grouped into rows of V = 128; per
row the output is the lower-triangular Toeplitz product of the exact
impulse response (F), the row's effect on the state is a (p, V) product
(K) and the carried state enters through a (V, p) product (G). All
tables are host float64 design-time constants. A whole SOS cascade is
ONE pass through the stacked 2*nsec state (_stack_cascade).

On a float32 signal with n >= 512 and p <= 32 the pass is K2, the
hand-written kernel of kernels/biir.py; otherwise it runs as torch
matrix products plus the boundary recurrence of `_affine_rec`.

DF2TFilter, filtfilt, fftfilt and tdfilt are not ported yet (ROADMAP
Queue 1 items 7-8).
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import dspbase
from ..ops.dspbase import _flatten_channels, _float_type
from ..utils.device import as_tensor
from .coefficients import (PolynomialRatio, Biquad, SecondOrderSections,
                           ZeroPoleGain, as_sos, coefb, coefa)

__all__ = ["filt", "sosfilt", "sos_arrays"]


# ---------------------------------------------------------------------------
# parallel affine linear recurrence
# ---------------------------------------------------------------------------

def _affine_scan(M, u, z0):
    """Solve z_t = M @ z_{t-1} + u_t, t = 1..n, as a log-depth scan
    (doubling: after step s, Z[t] holds the sum over the last 2^s
    inputs).

    M: (p, p) transition; u: (n, p, C); z0: (p, C).
    Returns z: (n, p, C) (z[t-1] == z_t).
    """
    n = u.shape[0]
    Z = u.clone()
    Z[0] += M @ z0
    Mp = M
    s = 1
    while s < n:
        Z = torch.cat([Z[:s], Z[s:] + Mp @ Z[:-s]], 0)
        Mp = Mp @ Mp
        s *= 2
    return Z


_REC_BLOCK = 128
_rec_tables_cache = {}


def _rec_tables(A_np, S):
    """Host float64 tables for the blocked vector recurrence with
    transition A (p x p): T2 the (S*p, S*p) lower-triangular
    Toeplitz-of-powers matrix with T2[s*p+a, i*p+b] = (A^{s-i})[a, b]
    for i <= s, AS = A^S, P1 = stacked powers A^1..A^S as (S, p, p)."""
    key = (A_np.tobytes(), A_np.shape[0], S)
    hit = _rec_tables_cache.get(key)
    if hit is not None:
        return hit
    p = A_np.shape[0]
    powers = np.empty((S + 1, p, p))
    powers[0] = np.eye(p)
    for k in range(S):
        powers[k + 1] = A_np @ powers[k]
    diff = np.arange(S)[:, None] - np.arange(S)[None, :]
    T = np.where((diff >= 0)[:, :, None, None],
                 powers[np.clip(diff, 0, S)], 0.0)   # (S, S, p, p)
    T2 = T.transpose(0, 2, 1, 3).reshape(S * p, S * p)
    hit = (T2, powers[S], powers[1: S + 1])
    if len(_rec_tables_cache) > 256:
        _rec_tables_cache.clear()
    _rec_tables_cache[key] = hit
    return hit


def _const(a, like):
    """Host numpy table as a tensor of like's dtype on like's device."""
    return torch.as_tensor(a, device=like.device).to(like.dtype)


def _affine_rec(A_np, U, z0):
    """Solve z_b = A z_{b-1} + U_b, b = 0..B-1, z_{-1} = z0.

    A_np: host (p, p) float64 transition; U: (C, B, p) injected vectors;
    z0: (p, C). Returns Z (C, B, p), the state AFTER each step: one
    (C*Bo, S*p) @ (S*p, S*p) product for within-block prefixes, a scan
    over block boundary states, and a (S, p, p) reconstruct einsum."""
    C, B, p = U.shape
    S = min(_REC_BLOCK, max(8, B))
    T2, AS, P1 = _rec_tables(A_np, S)
    U = U.clone()
    U[:, 0] += (_const(A_np, U) @ z0).T

    Bo = -(-B // S)
    npad = Bo * S - B
    if npad:
        U = F.pad(U, (0, 0, 0, npad))
    W = U.reshape(C * Bo, S * p) @ _const(T2.T, U)      # (C*Bo, S*p)
    Wl = W.reshape(C, Bo, S, p)

    # cross-block boundary states: zs_{k+1} = A^S zs_k + W[k, -1]
    zin = torch.zeros((1, p, C), dtype=U.dtype, device=U.device)
    if Bo > 1:
        v = Wl[:, :-1, -1].movedim(0, -1)               # (Bo-1, p, C)
        zs = _affine_scan(_const(AS, U), v,
                          torch.zeros((p, C), dtype=U.dtype,
                                      device=U.device))
        zin = torch.cat([zin, zs], 0)                   # (Bo, p, C)

    # reconstruct z_{k,s} = A^{s+1} zin_k + W[k, s]
    Z = torch.einsum("sab,kbc->cksa", _const(P1, U), zin) + Wl
    return Z.reshape(C, Bo * S, p)[:, :B]


# ---------------------------------------------------------------------------
# block state-space LTI application
# ---------------------------------------------------------------------------

_BLOCKSS_V = 128
_blockss_tables_cache = {}


class _BlockSS:
    """Host-precomputed block state-space tables of one LTI system
    y_t = d x_t + w'z_{t-1}; z_t = A z_{t-1} + c x_t, blocked over V
    samples. All float64 numpy; see _blockss_apply."""

    __slots__ = ("V", "p", "A", "c", "F", "G", "K", "AV", "powers")

    def __init__(self, A, c, w, d, V):
        p = A.shape[0]
        powers = np.empty((V + 1, p, p))
        powers[0] = np.eye(p)
        for k in range(V):
            powers[k + 1] = A @ powers[k]
        h = np.empty(V)
        h[0] = d
        if V > 1:
            # h[v] = w' A^{v-1} c, v >= 1
            h[1:] = (powers[: V - 1] @ c) @ w
        i = np.arange(V)
        dij = i[:, None] - i[None, :]
        F = np.where(dij >= 0, h[np.clip(dij, 0, V - 1)], 0.0)  # (V, V)
        G = powers[:V].transpose(0, 2, 1) @ w                   # (V, p)
        K = (powers[V - 1::-1] @ c).T                           # (p, V)
        self.V, self.p = V, p
        self.A, self.c = A, c
        self.F, self.G, self.K, self.AV = F, G, K, powers[V]
        self.powers = powers


def _blockss(A, c, w, d):
    key = (A.tobytes(), c.tobytes(), w.tobytes(), float(d), A.shape[0])
    hit = _blockss_tables_cache.get(key)
    if hit is None:
        hit = _BlockSS(A, c, w, d, _BLOCKSS_V)
        if len(_blockss_tables_cache) > 256:
            _blockss_tables_cache.clear()
        _blockss_tables_cache[key] = hit
    return hit


def _kernel_iir_ok(ss, n, dtype):
    """dsptpu's _pallas_iir_ok gate: K2 takes V = 128, p <= 32, float32
    and n >= 4 V."""
    from ..kernels.biir import biir_supported
    return biir_supported(ss, dtype) and n >= 4 * ss.V


def _blockss_apply(ss, x, z0, need_state=True):
    """Apply the block state-space system over x (n, C) with initial
    state z0 (p, C); returns (y (n, C), z_final (p, C) or None).

    Through K2 (kernels/biir.py) where its gate holds; else three
    matrix products per row batch (F, K, G) plus the boundary-state
    recurrence over n/V row states (_affine_rec)."""
    dtype = x.dtype
    n, C = x.shape
    if not (need_state and n < ss.V) and _kernel_iir_ok(ss, n, dtype):
        from ..kernels.biir import blockss_filt
        res = blockss_filt(ss, x, z0, need_state=need_state)
        return res if need_state else (res, None)
    V, p = ss.V, ss.p
    B = -(-n // V)
    npad = B * V - n
    xT = x.T                                             # (C, n)
    if npad:
        xT = F.pad(xT, (0, npad))
    X = xT.reshape(C * B, V)
    Ylocal = X @ _const(ss.F.T, x)
    U = (X @ _const(ss.K.T, x)).reshape(C, B, p)
    Z = _affine_rec(ss.AV, U, z0)                        # (C, B, p)
    Zstart = torch.cat([z0.T[:, None, :], Z[:, :-1]], 1)
    Y = Ylocal.reshape(C, B, V) + torch.einsum(
        "cbp,vp->cbv", Zstart, _const(ss.G, x))
    y = Y.reshape(C, B * V)[:, :n].T
    if not need_state:
        return y, None
    if npad == 0:
        zf = Z[:, -1].T                                  # (p, C)
    else:
        # state at the true last sample: index v = V-npad-1 in the last
        # (zero-padded) block
        v = V - npad - 1
        Kp = np.zeros((ss.p, V))
        Kp[:, : v + 1] = (ss.powers[v::-1] @ ss.c).T
        xlast = xT.reshape(C, B, V)[:, -1]               # (C, V)
        zf = (_const(ss.powers[v + 1], x) @ Zstart[:, -1].T
              + (xlast @ _const(Kp.T, x)).T)
    return y, zf


def _single_ss(bp, ap):
    """(A, c, w, d) DF2T realization of one normalized section:
    y = b0 x + z1_prev; z = M z_prev + c x."""
    bp = np.asarray(bp, dtype=np.float64)
    ap = np.asarray(ap, dtype=np.float64)
    p = len(ap) - 1
    M = np.zeros((p, p))
    M[:, 0] = -ap[1:]
    if p > 1:
        M += np.eye(p, k=1)
    c = bp[1:] - ap[1:] * bp[0]
    w = np.zeros(p)
    w[0] = 1.0
    return M, c, w, float(bp[0])


def _stack_cascade(sos, g=1.0):
    """Stacked state-space of a biquad cascade followed by gain g.

    Section k (DF2T): s^k_t = M_k s^k_{t-1} + c_k u^k_t with input
    u^k = previous section's output, u^{k+1} = b0_k u^k + e1's^k_{t-1}.
    Eliminating the chain gives one (2K, 2K) block-lower-triangular
    transition whose state vector is the per-section states stacked in
    order. Host float64 only."""
    sos = np.asarray(sos, dtype=np.float64).reshape(-1, 5)
    K = sos.shape[0]
    p = 2 * K
    A = np.zeros((p, p))
    cvec = np.zeros(p)
    wk = np.zeros(p)
    dk = 1.0
    for k in range(K):
        b0, b1, b2, a1, a2 = sos[k]
        Mk = np.array([[-a1, 1.0], [-a2, 0.0]])
        ck = np.array([b1 - a1 * b0, b2 - a2 * b0])
        sl = slice(2 * k, 2 * k + 2)
        A[sl, sl] = Mk
        A[sl, :] += np.outer(ck, wk)
        cvec[sl] = ck * dk
        # u^{k+1} = b0 u^k + e1's^k
        wk = b0 * wk
        wk[2 * k] += 1.0
        dk = b0 * dk
    return A, cvec, g * wk, g * dk


def _affine_apply(bp, ap, x, z0):
    """Transposed DF-II of a normalized (a[0]==1) filter over x (n, C)
    with initial state z0 (p, C); returns (y, z_final). bp/ap are host
    numpy design-time constants; see _blockss_apply."""
    return _blockss_apply(_blockss(*_single_ss(bp, ap)), x, z0)


# ---------------------------------------------------------------------------
# SOS filtering
# ---------------------------------------------------------------------------

def sos_arrays(f):
    """Accept SecondOrderSections | Biquad | (nsec, 5) array or tensor;
    return ((nsec, 5) float64 ndarray, gain)."""
    if isinstance(f, SecondOrderSections):
        return f.sos_array(), f.g
    if isinstance(f, Biquad):
        return np.array([[f.b0, f.b1, f.b2, f.a1, f.a2]]), 1.0
    if isinstance(f, torch.Tensor):
        f = f.detach().cpu().numpy()
    arr = np.asarray(f, dtype=np.float64).reshape(-1, 5)
    return arr, 1.0


def _sosfilt(sos, g, x, si, need_state=True):
    """Biquad cascade as ONE stacked block state-space pass. x (n,
    *chans), si (2, nsec, *chans). Returns (y, si_final or None)."""
    flat, restore = _flatten_channels(x)
    flat = flat.to(_float_type(flat.dtype))
    nsec = sos.shape[0]
    ss = _blockss(*_stack_cascade(np.asarray(sos, dtype=np.float64),
                                  float(g)))
    # stacked state rows ordered (z1_0, z2_0, z1_1, ...) <-> si (2, nsec, C)
    z0 = si.reshape(2, nsec, -1).to(flat.dtype)
    z0 = z0.transpose(0, 1).reshape(2 * nsec, -1)
    y, zf = _blockss_apply(ss, flat, z0, need_state=need_state)
    if not need_state:
        return restore(y), None
    si_final = zf.reshape(nsec, 2, -1).transpose(0, 1).reshape(
        (2, nsec) + tuple(x.shape[1:]))
    return restore(y), si_final


def sosfilt(f, x, si=None, device=None):
    """Filter x along axis 0 through a biquad cascade. `f` is a
    SecondOrderSections, Biquad, or (nsec, 5) [b0 b1 b2 a1 a2] array. If
    `si` (shape (2, nsec, *chans)) is given, returns (y, si_final) for
    streaming continuation."""
    x = as_tensor(x, device)
    sos, g = sos_arrays(f)
    nsec = sos.shape[0]
    if si is None:
        zi = torch.zeros((2, nsec) + tuple(x.shape[1:]), dtype=x.dtype,
                         device=x.device)
        y, _ = _sosfilt(sos, g, x, zi, need_state=False)
        return y
    return _sosfilt(sos, g, x, as_tensor(si, x.device))


# ---------------------------------------------------------------------------
# filt entry point (arrays and coefficient objects)
# ---------------------------------------------------------------------------

def filt(f, a=None, x=None, si=None, device=None):
    """Apply a filter along the first dimension of x.

    Forms:
      filt(b, a, x)            — IIR/FIR from coefficient vectors
      filt(b, x)               — FIR taps
      filt(coef_object, x)     — PolynomialRatio/Biquad/SOS/ZPK
    """
    if isinstance(f, (Biquad, SecondOrderSections)):
        return sosfilt(f, a if x is None else x, si, device)
    if isinstance(f, ZeroPoleGain):
        return sosfilt(as_sos(f), a if x is None else x, si, device)
    if isinstance(f, PolynomialRatio):
        return dspbase.filt(coefb(f), coefa(f), a if x is None else x,
                            si=si, device=device)
    return dspbase.filt(f, a, x, si=si, device=device)
