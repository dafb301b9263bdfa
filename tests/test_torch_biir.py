"""Port parity for the IIR core: dsptpu_torch's sosfilt / filt(b, a, x)
against dsptpu's, and the plain version of K2
(kernels/biir.blockss_reference, what the wrapper runs on a CPU tensor)
against dsptpu's Pallas block state-space kernel in interpret mode,
forward and need_state.

Inputs come from a numpy seed and go to both packages as explicit
float32 or float64 arrays. Tolerances: max|d| <= 1e-10 max|ref| in
float64, <= 1e-4 max|ref| in float32 (bench.py's IIR bound: the
recurrence accumulates f32 error)."""

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
    (3000, np.float32, False),   # _affine_apply -> K2 need_state (plain)
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
