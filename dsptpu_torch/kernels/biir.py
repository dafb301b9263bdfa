"""K2: block state-space IIR pass, a hand-written CUDA kernel
(csrc/biir.cu).

Replaces dsptpu/kernels/biir.py:blockss_filt_pallas (:242; Pallas
`_kernel` :60, tables `_dev_tables` :194) in all its modes: one pass of
y_t = d x_t + w'z_{t-1}; z_t = A z_{t-1} + c x_t (an SOS cascade stacked
into one state of dimension p <= 32) over 128-sample rows, with the
carried state entering through the tables F, K, G and AV = A^128 of
filters.filt._BlockSS. Forward, with need_state (the state after the
last sample), reverse (the anti-causal pass rev(apply(rev(x))) with z0
entering after the last sample) and reverse with n_eff (only the first
n_eff samples, z0 entering at sample n_eff - 1): filtfilt's two
passes.

Bound on an H100: 8 bytes per sample of HBM traffic (x in, y out),
0.153 ms a pass at 1,000,000 x 64. The cascade itself needs 5
multiply-adds per section per sample, far less. The TPU kernel carries
the state across a sequential grid; the CUDA kernel turns that carry
into a reduce-then-scan over chunks of _CHUNK rows in three launches
(csrc/biir.cu): `chunk_reduce` (U = K X per row from x staged on chip,
and each chunk's end state from zero), `carry` (the state entering each
chunk, a grouped scan with every order of operations fixed) and, for a
stacked SOS cascade (a system built by filters.filt._cascade_ss, which
carries its sections), `chunk_scan_sos_output` (each row's entering
state on chip, then the cascade itself per (row, channel)). The chain
moves x twice, U twice and y once: about 800 MB a pass at 1,000,000 x
64, 0.24 ms at the HBM rate. A general (b, a) system keeps a scan from
the entering states and the 128-tap product F (four launches).

`blockss_filt` launches the kernel for a CUDA tensor and runs
`blockss_reference`, the plain PyTorch version of the same arithmetic,
for a CPU tensor. `launches["biir"]` counts kernel launches (one per
pass), `launches["biir_reverse"]` those of reverse passes.
"""

import ctypes

import numpy as np
import torch

from . import _build
from ..utils.device import full_f32
from ..utils.profiling import spanned, table_cache

__all__ = ["blockss_filt", "blockss_reference", "biir_supported",
           "launches"]

launches = {"biir": 0, "biir_reverse": 0}

# dsptpu_biir(x, h, kt, gt, av, avl, z0, y, U, E, zin, zrow, n, tbase,
#             C, P, L, brow, sec, nsec, stream)
_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_longlong] * 2 + [
    ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]

_V = 128
_CHUNK = 64        # rows per chunk (the carry walks n/(128*64) chunk ends)


def biir_supported(ss, dtype):
    """The gate of dsptpu's kernels/biir.py:biir_supported."""
    return ss.V == _V and ss.p <= 32 and dtype == torch.float32


def _padded_p(p):
    return 8 if p <= 8 else (16 if p <= 16 else 32)


@table_cache("biir", lambda ss, device: (
    ss.F.tobytes(), ss.K.tobytes(), ss.G.tobytes(), ss.AV.tobytes(),
    str(device), None if ss.sections is None
    else (ss.sections[0].tobytes(), ss.sections[1])), 128)
def _tables(ss, device):
    """float64 host tables cast to float32, as dsptpu's _dev_tables
    builds them (forward direction), on `device`: h (V,) = F[:, 0] (F is
    Toeplitz in h), Kt = K' (V, P), Gt = G (V, P), AV (P, P) and
    AV^_CHUNK (P, P), zero-padded from p to P in {8, 16, 32}; then, for
    a system that carries its sections, their rows [b0 b1 b2 a1 a2] and
    the gain as one (5 nsec + 1,) vector (else None)."""
    sec = ss.sections
    P = _padded_p(ss.p)

    def pad(m, shape):
        out = np.zeros(shape)
        out[: m.shape[0], : m.shape[1]] = m
        return out

    host = (ss.F[:, 0], pad(ss.K.T, (_V, P)), pad(ss.G, (_V, P)),
            pad(ss.AV, (P, P)),
            pad(np.linalg.matrix_power(ss.AV, _CHUNK), (P, P)))
    if sec is not None:
        host += (np.append(sec[0].reshape(-1), sec[1]),)
    hit = tuple(torch.as_tensor(t.astype(np.float32), device=device)
                for t in host)
    return hit if sec is not None else hit + (None,)


@full_f32()
def _advance_tail(ss, zrow, x, n):
    """State after the true last sample from the state after the last
    complete row: z = A^m z_row + sum_j A^{m-1-j} c x_tail[j] (the host
    closed form of dsptpu's biir.py:321-334). x (n, C), zrow (p, C)."""
    m = n % _V
    if not m:
        return zrow
    Kp = (ss.powers[m - 1::-1] @ ss.c).T                # (p, m)
    dt = zrow.dtype
    pm = torch.as_tensor(ss.powers[m], device=x.device).to(dt)
    Kpt = torch.as_tensor(Kp.T, device=x.device).to(dt)
    return pm @ zrow + (x[n - m:].to(dt).T @ Kpt).T


def _reverse_span(x, reverse, n_eff):
    """Number of samples a pass covers (n, or n_eff in reverse)."""
    n = x.shape[0]
    if n_eff is None:
        return n
    if not reverse or n_eff % _V or not 0 < n_eff <= n:
        raise ValueError("n_eff: reverse passes only, a positive multiple "
                         "of 128 that is at most n")
    return n_eff


def blockss_reference(ss, x, z0, need_state=False, reverse=False,
                      n_eff=None):
    """Plain PyTorch version of the kernel's arithmetic, float32 tables:
    U = X K', the same chunked scan of z_b = AV z_{b-1} + U_b, then
    Y = X F' + Zstart G'. x (n, C), z0 (p, C). Returns y, or (y, z_final)
    with need_state. reverse: the same pass over the time-reversed first
    n_eff (default n) samples, its output reversed back: (n_eff, C)."""
    if reverse:
        if need_state:
            raise ValueError("need_state: forward passes only")
        N = _reverse_span(x, reverse, n_eff)
        return blockss_reference(ss, x[:N].flip(0), z0).flip(0)
    n, C = x.shape
    p = ss.p
    _, kt, gt, av, avl, _ = _tables(ss, x.device)
    L = _CHUNK
    F = torch.as_tensor(ss.F.astype(np.float32), device=x.device)
    B = -(-n // _V)
    nch = -(-B // L)
    xp = torch.zeros((nch * L * _V, C), dtype=x.dtype, device=x.device)
    xp[:n] = x
    X = xp.T.reshape(C, nch * L, _V)
    U = (X @ kt[:, :p]).reshape(C, nch, L, p)
    a1 = av[:p, :p].T
    s = torch.zeros((C, nch, p), dtype=x.dtype, device=x.device)
    for l in range(L):
        s = s @ a1 + U[:, :, l]
    zin = torch.empty_like(s)
    S = z0.T.to(x.dtype)
    for j in range(nch):
        zin[:, j] = S
        S = S @ avl[:p, :p].T + s[:, j]
    Zs = torch.empty_like(U)
    after = torch.empty_like(U)
    z = zin
    for l in range(L):
        Zs[:, :, l] = z
        z = z @ a1 + U[:, :, l]
        after[:, :, l] = z
    Zs = Zs.reshape(C, nch * L, p)
    Y = X @ F.T + Zs @ gt[:, :p].T                      # (C, rows, V)
    y = Y.reshape(C, -1)[:, :n].T.contiguous()
    if not need_state:
        return y
    zrow = after.reshape(C, nch * L, p)[:, n // _V - 1].T
    return y, _advance_tail(ss, zrow, x, n)


@spanned("kernel.biir")
def blockss_filt(ss, x, z0, need_state=False, reverse=False, n_eff=None):
    """Apply the block state-space system `ss` (V = 128) over x (n, C)
    float32 with initial state z0 (p, C). Returns y (n, C), or
    (y, z_final (p, C)) with need_state (forward, n >= 128).

    reverse=True runs the anti-causal pass rev(apply(rev(x))) with z0
    the state entering after the last sample; with n_eff (a multiple of
    128, at most n) only the first n_eff samples are read, z0 enters at
    sample n_eff - 1, and y is (n_eff, C)."""
    if need_state and (reverse or n_eff is not None or x.shape[0] < _V):
        raise ValueError("need_state: forward passes with n >= 128 only")
    N = _reverse_span(x, reverse, n_eff)
    if x.device.type == "cpu":
        return blockss_reference(ss, x, z0, need_state, reverse, n_eff)
    if x.dtype != torch.float32 or x.ndim != 2:
        raise TypeError("biir kernel takes an (n, C) float32 signal")
    if not biir_supported(ss, x.dtype):
        raise ValueError("biir kernel takes V = 128 and p <= 32")
    xc = x.contiguous()
    n, C = N, xc.shape[1]
    p = ss.p
    P = _padded_p(p)
    L = _CHUNK
    dev = xc.device
    h, kt, gt, av, avl, sec = _tables(ss, dev)
    z0p = torch.zeros((P, C), dtype=torch.float32, device=dev)
    z0p[:p] = z0.to(device=dev, dtype=torch.float32)
    B = -(-n // _V)
    nch = -(-B // L)
    y = torch.empty((n, C), dtype=torch.float32, device=dev)
    U = torch.empty((B, P, C), dtype=torch.float32, device=dev)
    E = torch.empty((nch, P, C), dtype=torch.float32, device=dev)
    zin = torch.empty((nch, P, C), dtype=torch.float32, device=dev)
    zrow = (torch.empty((P, C), dtype=torch.float32, device=dev)
            if need_state else None)
    brow = n // _V - 1 if need_state else -1
    f = _build.entry("biir", "dsptpu_biir", _ARGTYPES)
    err = f(xc.data_ptr(), h.data_ptr(), kt.data_ptr(), gt.data_ptr(),
            av.data_ptr(), avl.data_ptr(), z0p.data_ptr(), y.data_ptr(),
            U.data_ptr(), E.data_ptr(), zin.data_ptr(),
            zrow.data_ptr() if need_state else None, n,
            n - 1 if reverse else -1, C, P, L, brow,
            None if sec is None else sec.data_ptr(),
            0 if sec is None else ss.sections[0].shape[0],
            _build.stream_of(xc))
    _build.check("biir", err, "biir kernel launch")
    launches["biir"] += 1
    launches["biir_reverse"] += bool(reverse)
    if not need_state:
        return y
    return y, _advance_tail(ss, zrow[:p], xc, n)
