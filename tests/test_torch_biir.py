"""Port parity for the IIR core: dsptpu_torch's sosfilt / filt(b, a, x)
against dsptpu's, and the plain version of K2
(kernels/biir.blockss_reference, what the wrapper runs on a CPU tensor)
against dsptpu's Pallas block state-space kernel in interpret mode,
forward and need_state.

Inputs come from a numpy seed and go to both packages as explicit
float32 or float64 arrays. Tolerances: max|d| <= 1e-10 max|ref| in
float64, <= 1e-4 max|ref| in float32 (bench.py's IIR bound: the
recurrence accumulates f32 error)."""

import gc
import importlib
import math
import weakref

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import dsptpu
import dsptpu_torch
from dsptpu.filters import as_sos as jax_as_sos
from dsptpu.filters.filt import (_blockss as jax_blockss,
                                 _stack_cascade as jax_stack)
from dsptpu.kernels.biir import blockss_filt_pallas
from dsptpu_torch.convert import (sos_from_numpy, state_from_numpy,
                                  zpk_from_numpy)
from dsptpu_torch.filters.filt import _blockss, _cascade_ss, _stack_cascade
from dsptpu_torch.kernels import biir as tbiir
from dsptpu_torch.utils import profiling

# the module, not the function that filters/__init__ binds to `filt`
filt_mod = importlib.import_module("dsptpu_torch.filters.filt")

TOL = {np.float64: 1e-10, np.float32: 1e-4}


def check(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.max(np.abs(got.astype(np.float64) - want))
    assert err <= tol * np.max(np.abs(want)), err


def butter_sos(order, cut):
    return jax_as_sos(dsptpu.digitalfilter(dsptpu.Lowpass(cut),
                                           dsptpu.Butterworth(order)))


@pytest.mark.parametrize("n,shape,dtype", [
    (5000, (3,), np.float32),    # K2 gate (plain K2 on the CPU)
    (5000, (3,), np.float64),    # block state-space in torch
    (300, (2,), np.float32),     # n < 512: block state-space in torch
    (2000, (), np.float32),      # 1-D
])
def test_sosfilt_matches_dsptpu(n, shape, dtype):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n,) + shape).astype(dtype)
    sos = butter_sos(8, 0.2)
    want = dsptpu.sosfilt(sos, jnp.asarray(x))
    got = dsptpu_torch.sosfilt(sos_from_numpy(sos.sos_array(), sos.g),
                               torch.as_tensor(x))
    check(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sosfilt_streaming_state_matches_dsptpu(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3001, 2)).astype(dtype)
    sos = butter_sos(6, 0.3)
    si = rng.standard_normal((2, 3, 2)).astype(dtype)
    y_ref, sf_ref = dsptpu.sosfilt(sos, jnp.asarray(x), si=jnp.asarray(si))
    y, sf = dsptpu_torch.sosfilt(sos_from_numpy(sos.sos_array(), sos.g),
                                 torch.as_tensor(x),
                                 si=state_from_numpy(si, "cpu"))
    check(y, y_ref, TOL[dtype])
    check(sf, sf_ref, TOL[dtype])


def test_sosfilt_float32_section_array_like_entry():
    """dsptpu's entry passes the sections as a float32 array (gain 1);
    the reference casts them back to float64 for its tables."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4000, 2)).astype(np.float32)
    arr = butter_sos(6, 0.3).sos_array().astype(np.float32)
    want = dsptpu.sosfilt(jnp.asarray(arr), jnp.asarray(x))
    got = dsptpu_torch.sosfilt(torch.as_tensor(arr), torch.as_tensor(x))
    check(got, want, 1e-4)


@pytest.mark.parametrize("n,dtype,with_si", [
    (3000, np.float32, False),   # filt(b, a) -> K2 need_state (plain)
    (3000, np.float32, True),
    (2500, np.float64, True),
])
def test_filt_ba_matches_dsptpu(n, dtype, with_si):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((n, 3)).astype(dtype)
    b = np.array([0.2, 0.1, 0.05, 0.02], dtype)
    a = np.array([1.0, -0.5, 0.25, -0.1], dtype)
    si = rng.standard_normal((3, 3)).astype(dtype) if with_si else None
    args = (jnp.asarray(b), jnp.asarray(a), jnp.asarray(x))
    targs = (torch.as_tensor(b), torch.as_tensor(a), torch.as_tensor(x))
    if with_si:
        y_ref, zf_ref = dsptpu.filt(*args, si=jnp.asarray(si))
        y, zf = dsptpu_torch.filt(*targs, si=torch.as_tensor(si))
        check(zf, zf_ref, TOL[dtype])
    else:
        y_ref = dsptpu.filt(*args)
        y = dsptpu_torch.filt(*targs)
    check(y, y_ref, TOL[dtype])


def test_filt_unstable_denominator_sequential():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((200, 2))
    b, a = np.array([1.0, 0.5]), np.array([1.0, -1.01])
    want = dsptpu.filt(jnp.asarray(b), jnp.asarray(a), jnp.asarray(x))
    got = dsptpu_torch.filt(torch.as_tensor(b), torch.as_tensor(a),
                            torch.as_tensor(x))
    check(got, want, 1e-10)


def test_filt_coefficient_objects():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1500, 2))
    zpk = dsptpu.digitalfilter(dsptpu.Lowpass(0.3), dsptpu.Butterworth(4))
    want = dsptpu.filt(zpk, jnp.asarray(x))
    got = dsptpu_torch.filt(zpk_from_numpy(zpk.z, zpk.p, zpk.k),
                            torch.as_tensor(x))
    check(got, want, 1e-10)
    own = dsptpu_torch.digitalfilter(dsptpu_torch.Lowpass(0.3),
                                     dsptpu_torch.Butterworth(4))
    check(dsptpu_torch.filt(own, torch.as_tensor(x)), want, 1e-10)


def _pair(order, cut):
    sos = butter_sos(order, cut)
    arr, g = sos.sos_array(), sos.g
    return jax_blockss(*jax_stack(arr, g)), _blockss(*_stack_cascade(arr, g))


@pytest.mark.parametrize("n,C", [(2053, 2), (1024, 3)])
def test_k2_plain_matches_pallas_interpret(n, C):
    jss, tss = _pair(8, 0.4)
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, C)).astype(np.float32)
    z0 = rng.standard_normal((tss.p, C)).astype(np.float32)
    want = blockss_filt_pallas(jss, jnp.asarray(x), jnp.asarray(z0), TB=4,
                               interpret=True)
    got = tbiir.blockss_filt(tss, torch.as_tensor(x), torch.as_tensor(z0))
    check(got, want, 1e-4)


@pytest.mark.parametrize("n,C", [(2053, 2), (1024, 1)])
def test_k2_plain_need_state_matches_pallas_interpret(n, C):
    jss, tss = _pair(6, 0.25)
    rng = np.random.default_rng(n + 1)
    x = rng.standard_normal((n, C)).astype(np.float32)
    z0 = rng.standard_normal((tss.p, C)).astype(np.float32)
    y_ref, zf_ref = blockss_filt_pallas(jss, jnp.asarray(x),
                                        jnp.asarray(z0), TB=4,
                                        interpret=True, need_state=True)
    y, zf = tbiir.blockss_filt(tss, torch.as_tensor(x), torch.as_tensor(z0),
                               need_state=True)
    check(y, y_ref, 1e-4)
    check(zf, zf_ref, 1e-4)
    assert tbiir.launches["biir"] == 0


def test_k2_reverse_not_ported():
    """K2's reverse mode: its plain version matches dsptpu's Pallas
    kernel at a ragged n, with and without n_eff."""
    jss, tss = _pair(4, 0.2)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((1100, 2)).astype(np.float32)
    z0 = rng.standard_normal((tss.p, 2)).astype(np.float32)
    for n_eff in (None, 1024):
        want = blockss_filt_pallas(jss, jnp.asarray(x), jnp.asarray(z0),
                                   TB=4, interpret=True, reverse=True,
                                   n_eff=n_eff)
        got = tbiir.blockss_filt(tss, torch.as_tensor(x),
                                 torch.as_tensor(z0), reverse=True,
                                 n_eff=n_eff)
        check(got, want, 1e-4)
    assert tbiir.launches["biir"] == 0


def _emulate_sos_rows(ss, x, z0, reverse=False, n_eff=None):
    """K2's SOS output stage (csrc/biir.cu:sos_output_kernel) in numpy
    float64, next to the block form it replaces, over the same row
    states: z_{b-1} by the block recursion z_b = AV z_{b-1} + K X_b, then
    per row (all rows and channels at once) the cascade from z_{b-1}
    (section k's DF2T state at rows 2k, 2k+1), y_k = b0 u + s1,
    s1 <- s2 + b1 u - a1 y_k, s2 <- b2 u - a2 y_k, u <- y_k, output g u.
    reverse runs in virtual time (the first n_eff samples, reversed).
    Returns (cascade, block form F X_b + G z_{b-1}), (n, C) each."""
    sos, g = ss.sections
    if reverse:
        x = x[: x.shape[0] if n_eff is None else n_eff][::-1]
    n, C = x.shape
    V, B = ss.V, -(-n // ss.V)
    X = np.zeros((B, V, C))
    X.reshape(B * V, C)[:n] = x
    Z = np.empty((B, ss.p, C))
    z = z0
    for b in range(B):
        Z[b] = z
        z = ss.AV @ z + ss.K @ X[b]
    block = np.einsum("vu,buc->bvc", ss.F, X) + np.einsum("va,bac->bvc",
                                                          ss.G, Z)
    s = Z.reshape(B, len(sos), 2, C).copy()
    casc = np.empty_like(X)
    for v in range(V):
        u = X[:, v]
        for k, (b0, b1, b2, a1, a2) in enumerate(sos):
            yk = b0 * u + s[:, k, 0]
            s[:, k, 0] = s[:, k, 1] + b1 * u - a1 * yk
            s[:, k, 1] = b2 * u - a2 * yk
            u = yk
        casc[:, v] = g * u
    return (casc.reshape(B * V, C)[:n], block.reshape(B * V, C)[:n])


@pytest.mark.parametrize("order", [2, 8, 32])
@pytest.mark.parametrize("mode", ["forward", "reverse", "n_eff"])
def test_k2_sos_stage_arithmetic_is_block_form(order, mode):
    """The per-row cascade from the block states equals the block form
    F X + G z for 1, 4 and 16 sections with a gain other than 1, in each
    of K2's directions."""
    sos = butter_sos(order, 0.3)
    tss = _cascade_ss(sos.sos_array(), 1.7 * sos.g)
    assert len(tss.sections[0]) == order // 2
    rng = np.random.default_rng(order)
    n, C = 1100, 3
    x = rng.standard_normal((n, C))
    z0 = rng.standard_normal((tss.p, C))
    casc, block = _emulate_sos_rows(tss, x, z0, reverse=mode != "forward",
                                    n_eff=1024 if mode == "n_eff" else None)
    check(casc, block, 1e-10)


def test_cascade_ss_carries_its_sections():
    """sosfilt's and filtfilt's systems carry their sections and gain for
    K2's SOS stage, keyed apart from the same tables without them; other
    systems carry none."""
    from dsptpu_torch.filters.filt import _single_ss
    sos = butter_sos(8, 0.2)
    arr, g = sos.sos_array(), sos.g
    tss = _cascade_ss(arr, g)
    assert np.array_equal(tss.sections[0], arr) and tss.sections[1] == g
    assert _cascade_ss(arr, g) is tss
    plain = _blockss(*_stack_cascade(arr, g))
    assert plain.sections is None and plain is not tss
    assert np.array_equal(plain.F, tss.F)
    assert _cascade_ss(arr, 2 * g) is not tss
    assert _blockss(*_single_ss([0.2, 0.1], [1.0, -0.5])).sections is None
    host = tbiir._tables(tss, "cpu")[5].numpy()
    assert np.allclose(host, np.append(arr.reshape(-1), g), rtol=1e-7)
    assert tbiir._tables(plain, "cpu")[5] is None


@pytest.mark.parametrize("n,C,reverse", [(2053, 2, False), (1100, 3, True)])
def test_k2_plain_of_cascade_ss_matches_pallas_interpret(n, C, reverse):
    """A system that carries its sections gives the same plain pass as
    dsptpu's Pallas kernel, forward and reverse."""
    sos = butter_sos(8, 0.3)
    arr, g = sos.sos_array(), sos.g
    jss, tss = jax_blockss(*jax_stack(arr, g)), _cascade_ss(arr, g)
    rng = np.random.default_rng(n + C)
    x = rng.standard_normal((n, C)).astype(np.float32)
    z0 = rng.standard_normal((tss.p, C)).astype(np.float32)
    want = blockss_filt_pallas(jss, jnp.asarray(x), jnp.asarray(z0), TB=4,
                               interpret=True, reverse=reverse)
    got = tbiir.blockss_filt(tss, torch.as_tensor(x), torch.as_tensor(z0),
                             reverse=reverse)
    check(got, want, 1e-4)


def _k2_geometry(C, L, nchunks):
    """csrc/biir.cu's run(): channel group cw, row group RG, segments S of
    16 samples, tile TS, and the carry's NG groups of GL chunk ends."""
    cw = 1
    while cw < C and cw < 32:
        cw *= 2
    RG = min(L, 256 // cw)
    S = 256 // (RG * cw)
    NG = min(256, math.ceil(math.sqrt(2.0 * nchunks)))
    GL = -(-nchunks // NG)
    return cw, RG, S, 16 * S, -(-nchunks // GL), GL


def _emulate_k2_launches(ss, x, z0, need_state=False, reverse=False,
                         n_eff=None, L=tbiir._CHUNK, back=None):
    """K2's three launches (csrc/biir.cu) in numpy float64, walked as the
    kernels walk: (1) chunk_reduce per (chunk, channel group): x tiles of
    RG rows x TS samples (zeros past n), each thread's 16-sample segment
    summed into U_b = K X_b, segments added in order, then the chunk's
    end state from zero E_j; (2) carry: the chunk ends in NG groups of GL,
    each group from zero, the groups' entering states in series with
    (AV^L)^GL, each group again from its entering state -> zin[j];
    (3) per chunk from zin[j], each row's entering state z_{b-1} (and the
    state after row `brow`), then the cascade per row (a system with
    sections) or F X_b + G z_{b-1}. Reverse runs in virtual time t' and
    reads and writes sample tbase - t'. With back (forward), the pass
    covers x's nb rows and then back's, each staged sample t from x below
    nb and from back[t - nb] from it on (stage_tile's and output_kernel's
    rule). Returns y (n, C) in memory order, or (y, z_final) with
    need_state."""
    V, p = ss.V, ss.p
    nb = x.shape[0] if n_eff is None else n_eff
    n = nb + (0 if back is None else back.shape[0])
    C = x.shape[1]
    tbase = n - 1 if reverse else -1

    def row_of(t):
        return t if tbase < 0 else tbase - t

    def samples(t):
        r = row_of(t)
        if back is None:
            return x[r]
        got = np.full((len(r), C), np.nan)
        inx = r < nb
        got[inx] = x[r[inx]]
        got[~inx] = back[r[~inx] - nb]
        return got
    B = -(-n // V)
    nch = -(-B // L)
    cw, RG, S, TS, NG, GL = _k2_geometry(C, L, nch)
    AV = ss.AV
    AVL = np.linalg.matrix_power(AV, L)
    U = np.full((B, p, C), np.nan)
    E = np.full((nch, p, C), np.nan)
    for j in range(nch):
        for cb in range(0, C, cw):
            ch = np.arange(cb, min(cb + cw, C))
            z = np.zeros((p, len(ch)))
            for g in range(L // RG):
                b0 = j * L + g * RG
                acc = np.zeros((S, RG, p, len(ch)))
                for k in range(V // TS):
                    t = ((b0 + np.arange(RG))[:, None] * V + k * TS
                         + np.arange(TS)[None, :])
                    tile = np.zeros((RG, TS, len(ch)))
                    ok = t < n
                    tile[ok] = samples(t[ok])[:, ch]
                    for seg in range(S):
                        u = k * TS + seg * 16 + np.arange(16)
                        acc[seg] += np.einsum(
                            "au,ruc->rac", ss.K[:, u],
                            tile[:, seg * 16: seg * 16 + 16])
                Ug = acc[0]
                for seg in range(1, S):
                    Ug = Ug + acc[seg]
                for r in range(RG):
                    if b0 + r >= B:
                        break
                    U[b0 + r][:, ch] = Ug[r]
                    z = AV @ z + Ug[r]
            E[j][:, ch] = z
    T = []
    for g in range(NG - 1):
        s = np.zeros((p, C))
        for j in range(g * GL, (g + 1) * GL):
            s = AVL @ s + E[j]
        T.append(s)
    M = np.linalg.matrix_power(AVL, GL)
    Sg = [z0]
    for g in range(NG - 1):
        Sg.append(M @ Sg[-1] + T[g])
    zin = np.full((nch, p, C), np.nan)
    for g in range(NG):
        s = Sg[g]
        for j in range(g * GL, min(nch, (g + 1) * GL)):
            zin[j] = s
            s = AVL @ s + E[j]
    brow = n // V - 1 if need_state else -1
    Z = np.full((B, p, C), np.nan)
    zrow = None
    for j in range(nch):
        z = zin[j]
        for b in range(j * L, min(B, j * L + L)):
            Z[b] = z
            z = AV @ z + U[b]
            if b == brow:
                zrow = z
    X = np.zeros((B * V, C))
    X[:n] = samples(np.arange(n))
    X = X.reshape(B, V, C)
    if ss.sections is None:
        Y = (np.einsum("vu,buc->bvc", ss.F, X)
             + np.einsum("va,bac->bvc", ss.G, Z))
    else:
        sos, gain = ss.sections
        s = Z.reshape(B, len(sos), 2, C).copy()
        Y = np.empty_like(X)
        for v in range(V):
            w = X[:, v]
            for k, (c0, c1, c2, a1, a2) in enumerate(sos):
                yk = c0 * w + s[:, k, 0]
                s[:, k, 0] = s[:, k, 1] + c1 * w - a1 * yk
                s[:, k, 1] = c2 * w - a2 * yk
                w = yk
            Y[:, v] = gain * w
    y = np.empty((n, C))
    y[row_of(np.arange(n))] = Y.reshape(B * V, C)[:n]
    if not need_state:
        return y
    zf = tbiir._advance_tail(ss, torch.as_tensor(zrow), torch.as_tensor(x),
                             n)
    return y, zf.numpy()


# (order, n, C) for each mode: n at 64·128·k - 1, k, + 1 (K2's chunk is
# 64 rows) and below 64·128; C 1, 3, 33, 64; p 2, 8, 20, 32 (tables
# padded to 8, 16, 32). need_state: brow = n // 128 - 1 ends a chunk at
# n = 8192 and 8193, lies inside one at 8191 and 3001.
K2_WALK = {
    "forward": [(8, 8191, 64), (2, 8193, 3), (20, 3001, 33), (32, 8192, 1)],
    "need_state": [(8, 8192, 3), (8, 8191, 33), (32, 8193, 64),
                   (2, 3001, 1)],
    "reverse": [(8, 8193, 1), (20, 8191, 64), (2, 3001, 3), (32, 8192, 33)],
    "n_eff": [(8, 12289, 3), (20, 8193, 33), (32, 3001, 64), (2, 8191, 1)],
}
# forward with `back` (mode "back<pad>", n = nb, the rows in x): the
# boundary nb on a chunk edge (8192), on a tile edge (tiles of 64 samples
# at C 1, 16 at C 3 and 64) with nb % 128 = 64 (8256, 8128, 12352) or 0
# (4096), mid-tile (4136, 3000); back in the last chunk, or across the
# chunk edge (8128 + 195)
K2_WALK_BACK = [("back24", 8, 8192, 64), ("back195", 2, 8256, 1),
                ("back24", 20, 4136, 3), ("back195", 32, 8128, 64),
                ("back24", 8, 12352, 3), ("back195", 8, 4096, 3),
                ("back195", 20, 3000, 1)]


@pytest.mark.parametrize("route", ["sections", "F"])
@pytest.mark.parametrize("mode,order,n,C", [
    (mode, *case) for mode, cases in K2_WALK.items() for case in cases]
    + K2_WALK_BACK)
def test_k2_three_launch_walk_emulated(mode, order, n, C, route):
    """The emulated walk of K2's three launches against the plain version
    (what the wrapper runs on a CPU tensor) and dsptpu's Pallas kernel in
    interpret mode, both within 1e-4, in each mode, on both output routes
    (the cascade per row for a system with sections, F X + G z for one
    without). A forward pass with `back` reads its last pad rows from
    back, the others from x; dsptpu's kernel runs on their
    concatenation."""
    sos = butter_sos(order, 0.3)
    arr, g = sos.sos_array(), sos.g
    tss = (_cascade_ss(arr, 1.3 * g) if route == "sections"
           else _blockss(*_stack_cascade(arr, 1.3 * g)))
    jss = jax_blockss(*jax_stack(arr, 1.3 * g))
    assert tss.p == order
    rng = np.random.default_rng(n + C + order)
    x = rng.standard_normal((n, C)).astype(np.float32)
    z0 = rng.standard_normal((tss.p, C)).astype(np.float32)
    kw = dict(need_state=mode == "need_state",
              reverse=mode in ("reverse", "n_eff"),
              n_eff=(n // 128) * 128 if mode == "n_eff" else None)
    bk, xj = {}, x
    if mode.startswith("back"):
        bk["back"] = rng.standard_normal((int(mode[4:]), C)).astype(
            np.float32)
        xj = np.concatenate([x, bk["back"]])
    got = _emulate_k2_launches(
        tss, x.astype(np.float64), z0.astype(np.float64), **kw,
        **{k: v.astype(np.float64) for k, v in bk.items()})
    plain = tbiir.blockss_filt(tss, torch.as_tensor(x), torch.as_tensor(z0),
                               **kw, **{k: torch.as_tensor(v)
                                        for k, v in bk.items()})
    want = blockss_filt_pallas(jss, jnp.asarray(xj), jnp.asarray(z0), TB=4,
                               interpret=True, **kw)
    if not kw["need_state"]:
        got, plain, want = (got,), (plain,), (want,)
    for gt, pl, w in zip(got, plain, want):
        check(gt, pl.numpy(), 1e-4)
        check(gt, w, 1e-4)


@pytest.mark.parametrize("route", ["sections", "F"])
@pytest.mark.parametrize("nb,pad,C", [(2048, 24, 3), (2112, 195, 1),
                                      (2000, 24, 64), (8128, 195, 3)])
def test_k2_plain_back_and_out_are_the_concatenation(route, nb, pad, C):
    """The plain version with `back` is the same call on
    torch.cat([x, back]) bit for bit, through the wrapper too; with `out`
    it writes the pass's rows into out's first rows, returns that view and
    leaves the rows past it as they were, forward with back and reverse
    with n_eff alike. Each use counts once (route.biir.back / .into)."""
    sos = butter_sos(8, 0.3)
    arr, g = sos.sos_array(), 1.3 * sos.g
    ss = (_cascade_ss(arr, g) if route == "sections"
          else _blockss(*_stack_cascade(arr, g)))
    rng = np.random.default_rng(nb + pad + C)
    x, back, z0 = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
                   for s in ((nb, C), (pad, C), (ss.p, C)))
    cat = torch.cat([x, back])
    want = tbiir.blockss_reference(ss, cat, z0)
    assert torch.equal(tbiir.blockss_reference(ss, x, z0, back=back), want)
    profiling.reset()
    assert torch.equal(tbiir.blockss_filt(ss, x, z0, back=back), want)
    out = torch.full((nb + pad + 5, C), 7.0)
    got = tbiir.blockss_filt(ss, x, z0, back=back, out=out)
    assert got.data_ptr() == out.data_ptr() and got.shape == want.shape
    assert torch.equal(out[: nb + pad], want)
    assert bool((out[nb + pad:] == 7.0).all())
    m = (nb // 128) * 128
    want_r = tbiir.blockss_reference(ss, cat, z0, reverse=True, n_eff=m)
    out = torch.full((nb + pad, C), 7.0)
    got = tbiir.blockss_reference(ss, cat, z0, reverse=True, n_eff=m,
                                  out=out)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(out[:m], want_r)
    assert bool((out[m:] == 7.0).all())
    assert profiling.counters().get("route.biir.back") == 2
    assert profiling.counters().get("route.biir.into") == 1
    assert tbiir.launches["biir"] == 0


def test_k2_back_and_out_refusals():
    """back only on forward passes without need_state, in x's dtype with
    its C; out contiguous, of x's dtype and C, and long enough."""
    ss = _cascade_ss(butter_sos(4, 0.2).sos_array(), 1.0)
    x, z0 = torch.zeros(1024, 2), torch.zeros(ss.p, 2)
    back = torch.zeros(24, 2)
    for fn in (tbiir.blockss_filt, tbiir.blockss_reference):
        for kw in (dict(reverse=True), dict(need_state=True)):
            with pytest.raises(ValueError):
                fn(ss, x, z0, back=back, **kw)
        for bad in (torch.zeros(24, 3), torch.zeros(24, 2,
                                                    dtype=torch.float64)):
            with pytest.raises(ValueError, match="back"):
                fn(ss, x, z0, back=bad)
        for bad in (torch.zeros(1047, 2), torch.zeros(1048, 3),
                    torch.zeros(2, 1048).T):
            with pytest.raises(ValueError, match="out"):
                fn(ss, x, z0, back=back, out=bad)


def _table_counts():
    """{table name: (hits, misses)} of the counters since the last reset."""
    c = profiling.counters()
    names = {k.split(".")[1] for k in c if k.startswith("table.")}
    return {t: (c.get(f"table.{t}.hit", 0), c.get(f"table.{t}.miss", 0))
            for t in names}


def test_sosfilt_finds_its_system_once_by_its_design(monkeypatch):
    """The blockss cache is keyed by the design: two sosfilt calls with
    equal sections and gain run _stack_cascade once and share a system;
    another gain is another system. Each output held to dsptpu."""
    runs = []
    stack = filt_mod._stack_cascade
    monkeypatch.setattr(filt_mod, "_stack_cascade",
                        lambda *a: runs.append(a[1]) or stack(*a))
    filt_mod._design_ss.entries.clear()
    sos = butter_sos(8, 0.2)
    arr, g = sos.sos_array(), sos.g
    x = np.random.default_rng(21).standard_normal((2000, 2)).astype(
        np.float32)
    want = np.asarray(dsptpu.sosfilt(sos, jnp.asarray(x)))
    for k in (1.0, 1.0, 2.0):
        got = dsptpu_torch.sosfilt(sos_from_numpy(arr, k * g),
                                   torch.as_tensor(x))
        check(got, k * want, 1e-4)
    assert runs == [g, 2.0 * g]
    assert _cascade_ss(arr, g) is _cascade_ss(arr.copy(), g)
    assert _cascade_ss(arr, 2.0 * g) is not _cascade_ss(arr, g)


@pytest.mark.parametrize("which", ["chain", "path_b"])
def test_second_entry_call_finds_the_same_tables(which):
    """A second chain or path B call on the CPU finds its one system and
    every table on it again: the very same tensors, hits only, outputs
    bit for bit the first call's, which is held to dsptpu."""
    import jax
    filt_mod._design_ss.entries.clear()
    if which == "chain":
        nfft = 256
        fwd, (xt,) = dsptpu_torch.entry(device="cpu", n=32768, channels=2,
                                        nfft=nfft)
        taps, sos, win = dsptpu_torch.pipeline.chain_params(nfft=nfft)
        x = jnp.asarray(xt.numpy())
        y = dsptpu.sosfilt(jnp.asarray(sos),
                           dsptpu.filt(jnp.asarray(taps), x))
        want = (dsptpu.power(dsptpu.welch_pgram(y, nfft, nfft // 2,
                                                window=jnp.asarray(win))),
                dsptpu.stft(y, nfft, nfft // 2, window=jnp.asarray(win),
                            psdonly=True))
    else:
        fwd, (xt,) = dsptpu_torch.filtfilt_lpc_entry(device="cpu",
                                                     n=51200, channels=1)
        f = jax_as_sos(dsptpu.digitalfilter(dsptpu.Lowpass(0.2),
                                            dsptpu.Butterworth(8)))
        want = (jax.jit(lambda v: dsptpu.filtfilt(f, v))(
            jnp.asarray(xt.numpy())),)
    first = fwd(xt)
    for got, w in zip(first, want):
        check(got, w, 1e-4)
    (ss,) = filt_mod._design_ss.entries.values()
    tables = dict(ss.tables)
    profiling.reset()
    second = fwd(xt)
    assert list(filt_mod._design_ss.entries.values()) == [ss]
    assert ss.tables.keys() == tables.keys()
    assert all(ss.tables[k] is v for k, v in tables.items())
    counts = _table_counts()
    assert counts["blockss"] == (1, 0) and counts["biir"][0] > 0
    assert all(miss == 0 for _, miss in counts.values()), counts
    leaves = (lambda o: [o[0], o[1]] if which == "chain"
              else [o[0], *o[1]])
    for a, b in zip(leaves(first), leaves(second)):
        assert torch.equal(a, b)


def test_dropped_system_takes_its_tables_with_it():
    """When the blockss cache drops a system, nothing else holds it: a
    weakref to it and to one of its K2 tables dies on collection."""
    filt_mod._design_ss.entries.clear()
    sos = butter_sos(4, 0.3)
    x = np.random.default_rng(22).standard_normal((1500, 2)).astype(
        np.float32)
    got = dsptpu_torch.sosfilt(sos_from_numpy(sos.sos_array(), sos.g),
                               torch.as_tensor(x))
    check(got, dsptpu.sosfilt(sos, jnp.asarray(x)), 1e-4)
    (ss,) = filt_mod._design_ss.entries.values()
    assert ("biir", "cpu") in ss.tables
    refs = weakref.ref(ss), weakref.ref(ss.tables[("biir", "cpu")][0])
    del ss
    filt_mod._design_ss.entries.clear()
    gc.collect()
    assert [r() for r in refs] == [None, None]
