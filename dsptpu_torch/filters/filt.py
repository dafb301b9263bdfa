"""dsptpu/filters/filt.py on torch tensors: the block state-space form
of an LTI filter, SOS cascades, the `filt` dispatcher, the streaming
DF2TFilter, zero-phase filtfilt, tdfilt and fftfilt.

The recurrence z_t = A z_{t-1} + c x_t, y_t = d x_t + w'z_{t-1} runs as
a blocked parallel pass: samples are grouped into rows of V = 128; per
row the output is the lower-triangular Toeplitz product of the exact
impulse response (F), the row's effect on the state is a (p, V) product
(K) and the carried state enters through a (V, p) product (G). All
tables are host float64 design-time constants. A whole SOS cascade is
ONE pass through the stacked 2*nsec state (_stack_cascade).

A system is found once, by its design (a cascade's sections and gain,
or a normalised (b, a): _design_ss); every table derived from it lives
on it (_BlockSS.table), keyed only by what is not the system (device,
geometry, step state), and goes when the `blockss` cache drops it.

On a float32 signal with n >= 512 and p <= 32 the pass is K2, the
hand-written kernel of kernels/biir.py; otherwise it runs as torch
matrix products plus the boundary recurrence of `_affine_rec`.

filtfilt on float32 input long enough for K2 (n >= 4*128 + pad) takes
the kernel route of dsptpu's _filtfilt_pallas_v2: the front extension
folds into the forward pass's entering state, the back extension is
appended to the forward pass, and the reverse pass (K2 reverse with
n_eff) starts at the aligned boundary m = 128*floor(n/128), its
entering state and the outputs over [m, n) in closed form from small
host tables (_ff_edge_tables). The route runs on CPU tensors too, with
K2's plain version. fftfilt is overlap-save (K4 where its gate holds).
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import dspbase
from ..ops.dspbase import _as_1d, _flatten_channels, _float_type
from ..utils.device import as_tensor, full_f32, to_host
from ..utils.profiling import count, span, spanned, table_cache
from .coefficients import (PolynomialRatio, Biquad, SecondOrderSections,
                           ZeroPoleGain, as_sos, coefb, coefa)

__all__ = ["filt", "sosfilt", "sos_arrays", "DF2TFilter", "filtfilt",
           "fftfilt", "tdfilt", "filt_stepstate", "filt_stepstate_sos"]


# ---------------------------------------------------------------------------
# parallel affine linear recurrence
# ---------------------------------------------------------------------------

@full_f32()
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


def _rec_tables(A_np, S):
    """Host float64 tables for the blocked vector recurrence with
    transition A (p x p): T2 the (S*p, S*p) lower-triangular
    Toeplitz-of-powers matrix with T2[s*p+a, i*p+b] = (A^{s-i})[a, b]
    for i <= s, AS = A^S, P1 = stacked powers A^1..A^S as (S, p, p)."""
    p = A_np.shape[0]
    powers = np.empty((S + 1, p, p))
    powers[0] = np.eye(p)
    for k in range(S):
        powers[k + 1] = A_np @ powers[k]
    diff = np.arange(S)[:, None] - np.arange(S)[None, :]
    T = np.where((diff >= 0)[:, :, None, None],
                 powers[np.clip(diff, 0, S)], 0.0)   # (S, S, p, p)
    T2 = T.transpose(0, 2, 1, 3).reshape(S * p, S * p)
    return T2, powers[S], powers[1: S + 1]


def _const(a, like, site="blockss.table"):
    """Host numpy table as a tensor of like's dtype on like's device (an
    upload counted as `sync.<site>`, utils.device.as_tensor)."""
    return as_tensor(a, like.device, site).to(like.dtype)


@full_f32()
def _affine_rec(ss, U, z0):
    """Solve z_b = A z_{b-1} + U_b, b = 0..B-1, z_{-1} = z0, A = ss.AV.

    U: (C, B, p) injected vectors; z0: (p, C). Returns Z (C, B, p), the
    state AFTER each step: one (C*Bo, S*p) @ (S*p, S*p) product for
    within-block prefixes, a scan over block boundary states, and a
    (S, p, p) reconstruct einsum."""
    A_np = ss.AV
    C, B, p = U.shape
    S = min(_REC_BLOCK, max(8, B))
    T2, AS, P1 = ss.table("rec", (S,), _rec_tables, A_np, S)
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


class _BlockSS:
    """Host-precomputed block state-space tables of one LTI system
    y_t = d x_t + w'z_{t-1}; z_t = A z_{t-1} + c x_t, blocked over V
    samples. All float64 numpy; see _blockss_apply. `sections`: for a
    stacked SOS cascade (_cascade_ss), its (nsec, 5) [b0 b1 b2 a1 a2]
    rows and gain g, which K2's output stage runs per row instead of F;
    None for any other system. `tables`: every table derived from the
    system, built on first use (table)."""

    __slots__ = ("V", "p", "A", "c", "F", "G", "K", "AV", "powers",
                 "sections", "tables", "__weakref__")

    def __init__(self, A, c, w, d, V, sections=None):
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
        self.sections = sections
        self.tables = {}

    def table(self, name, key, build, *args):
        """The table `name` at `key` derived from this system:
        build(*args) on its first lookup, then kept here. Each lookup
        counts `table.<name>.hit` or `table.<name>.miss`."""
        k = (name,) + key
        hit = k in self.tables
        count(f"table.{name}.{'hit' if hit else 'miss'}")
        if not hit:
            self.tables[k] = build(*args)
        return self.tables[k]


def _blockss(A, c, w, d, sections=None):
    """A new system (no cache: _design_ss finds a design's system once)."""
    return _BlockSS(A, c, w, d, _BLOCKSS_V, sections)


@table_cache("blockss", lambda rows, g=None: (rows.tobytes(), g), 256)
def _design_ss(rows, g=None):
    """The system of one design: a biquad cascade's (nsec, 5) float64
    rows with gain g, or (g None) one normalised section's (2, p + 1)
    rows [bp; ap]. _stack_cascade and _single_ss run only here."""
    if g is None:
        return _blockss(*_single_ss(*rows))
    return _blockss(*_stack_cascade(rows, g), sections=(rows, g))


def _kernel_iir_ok(ss, n, dtype):
    """dsptpu's _pallas_iir_ok gate: K2 takes V = 128, p <= 32, float32
    and n >= 4 V."""
    from ..kernels.biir import biir_supported
    return biir_supported(ss, dtype) and n >= 4 * ss.V


@full_f32()
def _blockss_apply(ss, x, z0, need_state=True, reverse=False):
    """Apply the block state-space system over x (n, C) with initial
    state z0 (p, C); returns (y (n, C), z_final (p, C) or None).

    Through K2 (kernels/biir.py) where its gate holds; else three
    matrix products per row batch (F, K, G) plus the boundary-state
    recurrence over n/V row states (_affine_rec).

    reverse=True: the anti-causal pass rev(apply(rev(x))) with z0 the
    state entering from the right; z_final is then the state entering
    sample 0. K2 takes it without a flip of the data; the torch route
    flips."""
    dtype = x.dtype
    n, C = x.shape
    if (not (need_state and (reverse or n < ss.V))
            and _kernel_iir_ok(ss, n, dtype)):
        from ..kernels.biir import blockss_filt
        res = blockss_filt(ss, x, z0, need_state=need_state,
                           reverse=reverse)
        return res if need_state else (res, None)
    if reverse:
        y, zf = _blockss_apply(ss, x.flip(0), z0, need_state)
        return y.flip(0), zf
    V, p = ss.V, ss.p
    B = -(-n // V)
    npad = B * V - n
    xT = x.T                                             # (C, n)
    if npad:
        xT = F.pad(xT, (0, npad))
    X = xT.reshape(C * B, V)
    Ylocal = X @ _const(ss.F.T, x)
    U = (X @ _const(ss.K.T, x)).reshape(C, B, p)
    Z = _affine_rec(ss, U, z0)                           # (C, B, p)
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


def _cascade_ss(sos, g=1.0):
    """The system of a biquad cascade with gain g (_stack_cascade),
    carrying a copy of its sections for K2's SOS output stage."""
    return _design_ss(np.array(sos, dtype=np.float64).reshape(-1, 5),
                      float(g))


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
    arr = np.asarray(to_host(f, "sosfilt.sos"), dtype=np.float64).reshape(
        -1, 5)
    return arr, 1.0


def _sosfilt(sos, g, x, si, need_state=True):
    """Biquad cascade as ONE stacked block state-space pass. x (n,
    *chans), si (2, nsec, *chans). Returns (y, si_final or None)."""
    flat, restore = _flatten_channels(x)
    flat = flat.to(_float_type(flat.dtype))
    nsec = sos.shape[0]
    ss = _cascade_ss(sos, g)
    # stacked state rows ordered (z1_0, z2_0, z1_1, ...) <-> si (2, nsec, C)
    z0 = si.reshape(2, nsec, -1).to(flat.dtype)
    z0 = z0.transpose(0, 1).reshape(2 * nsec, -1)
    y, zf = _blockss_apply(ss, flat, z0, need_state=need_state)
    if not need_state:
        return restore(y), None
    si_final = zf.reshape(nsec, 2, -1).transpose(0, 1).reshape(
        (2, nsec) + tuple(x.shape[1:]))
    return restore(y), si_final


@spanned("sosfilt")
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
      filt(df2t_filter, x)     — stateful streaming filter
    """
    if isinstance(f, DF2TFilter):
        return f(a if x is None else x)
    if isinstance(f, (Biquad, SecondOrderSections)):
        return sosfilt(f, a if x is None else x, si, device)
    if isinstance(f, ZeroPoleGain):
        return sosfilt(as_sos(f), a if x is None else x, si, device)
    if isinstance(f, PolynomialRatio):
        return dspbase.filt(coefb(f), coefa(f), a if x is None else x,
                            si=si, device=device)
    return dspbase.filt(f, a, x, si=si, device=device)


class DF2TFilter:
    """Stateful direct-form-II-transposed filter: chunked calls continue
    the filter state, so they equal one call on the concatenated input.

    `coldims` sizes the trailing channel dims of the inputs this filter
    will see. The state lives on the device and in the type of the last
    input (float64 on the CPU before the first call)."""

    def __init__(self, coef, coldims=(), si=None):
        if isinstance(coef, ZeroPoleGain):
            coef = as_sos(coef)
        self.coef = coef
        if isinstance(coef, PolynomialRatio):
            b, a = coefb(coef), coefa(coef)
            sz = max(len(b), len(a)) - 1
            shape = (sz,) + tuple(coldims)
        elif isinstance(coef, SecondOrderSections):
            shape = (2, len(coef.biquads)) + tuple(coldims)
        elif isinstance(coef, Biquad):
            shape = (2, 1) + tuple(coldims)
        else:
            raise TypeError(f"unsupported coefficient type {type(coef)}")
        if si is not None:
            si = si if isinstance(si, torch.Tensor) else torch.as_tensor(
                np.asarray(si))
            if isinstance(coef, Biquad) and tuple(si.shape[:1]) == (2,) and (
                    si.ndim == 1 or si.shape[1] != 1):
                si = si.reshape((2, 1) + tuple(si.shape[1:]))
            if tuple(si.shape) != shape:
                raise ValueError(f"state shape {tuple(si.shape)} does not "
                                 f"match filter {shape}")
            self.state = si
        else:
            self.state = torch.zeros(shape, dtype=torch.float64)

    def __call__(self, x):
        x = as_tensor(x)
        si = self.state.to(x.device)
        if isinstance(self.coef, PolynomialRatio):
            y, self.state = dspbase.filt(coefb(self.coef), coefa(self.coef),
                                         x, si=si)
            return y
        y, self.state = sosfilt(self.coef, x, si=si)
        return y

    filt = __call__


# ---------------------------------------------------------------------------
# filtfilt
# ---------------------------------------------------------------------------

def filt_stepstate(b, a):
    """Initial DF2T state making the step response steady-state.
    Host-side float64 solve; returns (si, b_padded, a_padded) with a[0]
    normalized to 1."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    scale = a[0]
    b = b / scale
    a = a / scale
    sz = max(len(b), len(a))
    if sz == 1:
        return np.zeros(0), b, a
    bp = np.zeros(sz)
    bp[: len(b)] = b
    ap = np.zeros(sz)
    ap[: len(a)] = a
    A = np.hstack([-ap[1:, None], np.vstack([np.eye(sz - 2),
                                             np.zeros((1, sz - 2))])])
    B = bp[1:] - ap[1:] * bp[0]
    si = np.linalg.solve(np.eye(sz - 1) - A, B) * scale
    return si, bp, ap


def filt_stepstate_sos(sos):
    """Per-biquad steady-state initial conditions, closed form.
    sos: (nsec, 5). Returns (2, nsec)."""
    sos = np.asarray(sos, dtype=np.float64).reshape(-1, 5)
    nsec = sos.shape[0]
    si = np.zeros((2, nsec))
    y = 1.0
    for i in range(nsec):
        b0, b1, b2, a1, a2 = sos[i]
        den = 1 + a1 + a2
        si[0, i] = (-(a1 + a2) * b0 + (b1 + b2)) / den * y
        si[1, i] = (a1 * b2 - a2 * (b0 + b1) + b2) / den * y
        y *= (b0 + b1 + b2) / den
    return si


def _extrapolate(x, pad):
    """Odd-symmetric edge extension, batched over channels.
    x (n, C) -> (n + 2*pad, C)."""
    if pad == 0:
        return x
    front = 2 * x[0] - x[1: pad + 1].flip(0)
    back = 2 * x[-1] - x[-pad - 1: -1].flip(0)
    return torch.cat([front, x, back], 0)


@spanned("filtfilt")
def filtfilt(f, a=None, x=None, device=None):
    """Zero-phase filtering: forward and reverse pass with steady-state
    initial conditions and odd-symmetric edge extrapolation. Forms:
    filtfilt(b, x), filtfilt(b, a, x), filtfilt(coef_object, x)."""
    if isinstance(f, PolynomialRatio):
        return filtfilt(coefb(f), coefa(f), a if x is None else x, device)
    if isinstance(f, (Biquad, ZeroPoleGain, SecondOrderSections)):
        return _filtfilt_sos(as_sos(f), as_tensor(a if x is None else x,
                                                  device))
    if x is None:
        x = as_tensor(a, f.device if isinstance(f, torch.Tensor)
                      else device)
        return _filtfilt_fir(_as_1d(f, "b", x.device), x)
    x = as_tensor(x, device)
    b = np.atleast_1d(to_host(f, "filtfilt.coefs"))
    a = np.atleast_1d(to_host(a, "filtfilt.coefs"))
    if len(a) == 1:
        return _filtfilt_fir(as_tensor(b / a[0], x.device, "filtfilt.fir"),
                             x)
    # real rational TFs go through the SOS cascade: the companion-form
    # state space of a high-order polynomial is badly conditioned in
    # float32. The pad stays at the TF form's 3*(max(len)-1).
    if (len(b) + len(a) <= 66
            and not (np.iscomplexobj(b) or np.iscomplexobj(a))):
        # the except guards only the host root-finding; a failure in the
        # SOS pass itself propagates
        try:
            sos_f = as_sos(PolynomialRatio(b, a))
        except Exception:
            sos_f = None              # root-finding failed: TF path
        if sos_f is not None:
            pad = 3 * (max(len(a), len(b)) - 1)
            return _filtfilt_sos(sos_f, x, pad=pad)
    return _iir_filtfilt(b, a, x)


def _filtfilt_fir(b, x):
    """FIR path: one pass with the autocorrelation of b."""
    nb = b.shape[0]
    newb = dspbase.conv(b, b.conj().resolve_conj().flip(0))
    flat, restore = _flatten_channels(x)
    ext = _extrapolate(flat, nb - 1)
    y = dspbase.filt(newb, None, ext)
    return restore(y[2 * nb - 2:])


def _filtfilt_ss(ss, zi_np, flat, pad):
    """filtfilt of flat (n, C) by the system ss from its step state zi_np:
    the kernel route where K2's gate holds on the input's own type, else
    two block state-space passes over the extended signal, forward from
    zi * ext[0], reverse from zi * y1[-1]."""
    n = flat.shape[0]
    if pad and n >= 4 * ss.V + pad and _kernel_iir_ok(ss, n, flat.dtype):
        return _filtfilt_kernel(ss, zi_np, flat, pad, n)
    flat = flat.to(_float_type(flat.dtype))
    z = _const(zi_np, flat, "filtfilt.zi")
    ext = _extrapolate(flat, pad)
    y1, _ = _blockss_apply(ss, ext, z[:, None] * ext[0][None, :],
                           need_state=False)
    y2, _ = _blockss_apply(ss, y1, z[:, None] * y1[-1][None, :],
                           need_state=False, reverse=True)
    return y2[pad: pad + n] if pad else y2


def _iir_filtfilt(b, a, x):
    """(b, a) that do not go through the SOS cascade: one DF2T state
    space of the whole polynomial."""
    pad = min(3 * (max(len(a), len(b)) - 1), x.shape[0] - 1)
    zi, bp, ap = filt_stepstate(b, a)
    flat, restore = _flatten_channels(x)
    ss = _design_ss(np.array([bp, ap]))
    return restore(_filtfilt_ss(ss, zi, flat, pad))


def _filtfilt_sos(f, x, pad=None):
    """SOS cascade (stacked state space, gain included) forward and
    backward; the kernel route where K2's gate holds."""
    with span("filtfilt.design"):
        sos, g = sos_arrays(f)
        nsec = sos.shape[0]
        if pad is None:
            pad = 6 * nsec
        pad = min(pad, x.shape[0] - 1)
        flat, restore = _flatten_channels(x)
        # stacked-state rows ordered (z1_0, z2_0, z1_1, ...) as in _sosfilt
        ss = _cascade_ss(sos, g)
        zi_np = ss.table("zstep", (), lambda: np.swapaxes(
            filt_stepstate_sos(sos), 0, 1).reshape(2 * nsec))
    return restore(_filtfilt_ss(ss, zi_np, flat, pad))


def _ff_edge_tables(ss, zst_np, pad, q, tl, device):
    """The kernel route's analytic edges, built in float64 on the host
    and uploaded as float32 to `device`: the front extension folded into
    the forward pass's entering state (Apad, Kf); the reverse pass's
    entering state at the aligned boundary from [tail of y1,
    back-extension outputs] (Aq, Krq); the closed-form anti-causal
    outputs over the unaligned tail (Fr, Gr); the step state zst_np."""
    A, c, w, d = ss.A, ss.c, ss.G[0], float(ss.F[0, 0])
    pw = list(ss.powers)                    # A^0 .. A^max(pad, q)
    while len(pw) <= max(pad, q):
        pw.append(A @ pw[-1])
    Apad = pw[pad]
    Kf = np.stack([pw[pad - 1 - j] @ c for j in range(pad)], axis=1)
    Aq = pw[q]
    Krq = np.stack([pw[j] @ c for j in range(q)], axis=1)
    # reverse outputs over the unaligned tail [m, n): y2[t] =
    # d*y1[t] + w' z_before(t), z_before(t) = A^{q-1-i} z0
    #   + sum_{j>i} A^{j-i-1} c seg[j]  (i = t - m)
    Gr = (np.stack([w @ pw[q - 1 - i] for i in range(tl)], axis=0)
          if tl else np.zeros((0, ss.p)))
    wAc = np.array([w @ (pw[j] @ c) for j in range(q)])
    Fr = np.zeros((tl, q))
    for i in range(tl):
        Fr[i, i] = d
        if i + 1 < q:
            Fr[i, i + 1:] = wAc[: q - i - 1]
    return tuple(torch.as_tensor(np.asarray(t, np.float32), device=device)
                 for t in (Apad, Kf, Aq, Krq, Fr, Gr, zst_np))


@full_f32()
def _filtfilt_kernel(ss, zst_np, x, pad, n):
    """filtfilt through K2 (dsptpu's _filtfilt_pallas_v2 arithmetic),
    x (n, C) float32, n >= 4*128 + pad:
      forward: the front extension folds into the entering state
        z_e = A^pad (zi x_front[0]) + Kf x_front; one forward pass over
        n + pad samples, K2 reading the back extension's pad rows from
        their own tensor (nothing is appended to x);
      reverse: the state entering the aligned boundary m = 128*floor(n/128)
        from the last q = n - m + pad forward outputs, Aq z0r + Krq seg;
        one reverse pass over the first m samples (K2's n_eff mode) into
        the output's first m rows; the outputs over [m, n) in closed
        form, Fr seg + Gr z0r, into the rest. The only signal-sized
        tensors are the forward pass's output and the result."""
    from ..kernels.biir import blockss_filt
    V = ss.V
    m = (n // V) * V
    q = n - m + pad
    tl = n - m
    with span("filtfilt.tables"):
        # the step state scales with a[0] on the (b, a) route; at most
        # 128 geometries (tl) a pad
        Apad, Kf, Aq, Krq, Fr, Gr, zst = ss.table(
            "ff_dev", (zst_np.tobytes(), pad, q, tl, str(x.device)),
            _ff_edge_tables, ss, zst_np, pad, q, tl, x.device)
    with span("filtfilt.edges"):
        front = 2 * x[0] - x[1: pad + 1].flip(0)        # (pad, C)
        z_e = Apad @ (zst[:, None] * front[0][None, :]) + Kf @ front
        back = 2 * x[-1] - x[n - 1 - pad: n - 1].flip(0)  # (pad, C)
    y1 = blockss_filt(ss, x, z_e, back=back)            # (n + pad, C)
    with span("filtfilt.edges"):
        seg = y1[m: n + pad]                            # (q, C)
        z0r = zst[:, None] * y1[n + pad - 1][None, :]
        z_rr = Aq @ z0r + Krq @ seg
        y = torch.empty((n, x.shape[1]), dtype=x.dtype, device=x.device)
    blockss_filt(ss, y1, z_rr, reverse=True, n_eff=m, out=y)
    with span("filtfilt.edges"):
        torch.add(Fr @ seg, Gr @ z0r, out=y[m:])
        return y


# ---------------------------------------------------------------------------
# tdfilt / fftfilt
# ---------------------------------------------------------------------------

def tdfilt(h, x, device=None):
    """FIR filtering by the time-domain routes of filt."""
    x = as_tensor(x, device)
    return dspbase.filt(_as_1d(h, "h", x.device), None, x)


@spanned("fftfilt")
def fftfilt(b, x, nfft=None, device=None):
    """FIR filtering by overlap-save FFT blocks along axis 0 (K4 where
    its gate holds); the output has x's length."""
    x = as_tensor(x, device)
    b = _as_1d(b, "b", x.device)
    y = dspbase._conv_os_1d(x, b, nfft=nfft, out_len=x.shape[0])
    return y[: x.shape[0]]
