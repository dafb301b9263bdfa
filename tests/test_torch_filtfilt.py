"""Port parity for zero-phase filtering and the streaming filter:
dsptpu_torch's filtfilt (SOS, (b, a) and FIR forms; 1-D and
multichannel; float64 and float32, the latter long enough for the
kernel route of K2 forward + reverse/n_eff) against dsptpu's, the plain
version of K2's reverse and n_eff modes against dsptpu's Pallas block
state-space kernel in interpret mode, and DF2TFilter's chunked calls
against one call and against dsptpu's DF2TFilter.

Inputs come from a numpy seed. dsptpu runs under x64 here, so its
filtfilt of float32 input computes in float64 (it takes the Pallas
route only on a TPU); the port keeps float32 and, on a CPU tensor, runs
K2's plain version on the kernel route. Tolerances: max|d| <= 1e-10
max|ref| in float64, <= 1e-4 max|ref| in float32 (bench.py's filtfilt
bound)."""

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import dsptpu
import dsptpu_torch
from dsptpu.filters.filt import (_blockss as jax_blockss,
                                 _stack_cascade as jax_stack)
from dsptpu.kernels.biir import blockss_filt_pallas
from dsptpu_torch import kernels
from dsptpu_torch.convert import sos_from_numpy
from dsptpu_torch.filters.filt import (_blockss, _blockss_apply,
                                       _stack_cascade, filt_stepstate,
                                       filt_stepstate_sos)
from dsptpu_torch.kernels import biir as tbiir
from dsptpu_torch.utils import profiling
from torch_helpers import filtfilt_two_cats

# the module, not the function that filters/__init__ binds to `filt`
filt_mod = importlib.import_module("dsptpu_torch.filters.filt")

TOL = {np.float64: 1e-10, np.float32: 1e-4}


def check(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.max(np.abs(got.astype(np.float64) - want))
    assert err <= tol * np.max(np.abs(want)), err


def butter(order, cut):
    return dsptpu.digitalfilter(dsptpu.Lowpass(cut),
                                dsptpu.Butterworth(order))


def port_sos(zpk):
    sos = dsptpu.filters.as_sos(zpk)
    return sos_from_numpy(sos.sos_array(), sos.g)


@pytest.mark.parametrize("n,shape,dtype,route", [
    (3001, (2,), np.float64, "torch"),
    (2000, (3,), np.float32, "kernel"),     # n >= 4*128 + 24, n % 128 != 0
    (1536, (), np.float32, "kernel"),       # 1-D, n % 128 == 0
    (1000, (2, 2), np.float32, "kernel"),   # two channel dims
    (300, (2,), np.float32, "torch"),       # too short for the kernel
])
def test_filtfilt_sos_matches_dsptpu(n, shape, dtype, route):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n,) + shape).astype(dtype)
    zpk = butter(8, 0.2)
    want = dsptpu.filtfilt(dsptpu.filters.as_sos(zpk), jnp.asarray(x))
    kernels.reset_launches()
    calls = []
    orig = tbiir.blockss_filt

    def spy(*a, **k):
        calls.append(k.get("reverse", False))
        return orig(*a, **k)
    tbiir.blockss_filt = spy
    try:
        got = dsptpu_torch.filtfilt(port_sos(zpk), torch.as_tensor(x))
    finally:
        tbiir.blockss_filt = orig
    assert got.dtype == torch.as_tensor(x).dtype
    assert (calls == [False, True]) == (route == "kernel")
    assert kernels.launch_counts()["biir"] == 0
    check(got, want, TOL[dtype])


@pytest.mark.parametrize("n,dtype", [(2500, np.float64), (2500, np.float32),
                                     (200, np.float64)])
def test_filtfilt_ba_matches_dsptpu(n, dtype):
    """(b, a) of Butterworth(4): routed through the SOS cascade with the
    TF form's pad, 3*(max(len)-1)."""
    rng = np.random.default_rng(n + 1)
    x = rng.standard_normal((n, 2)).astype(dtype)
    pr = dsptpu.filters.as_polynomial_ratio(butter(4, 0.3))
    b, a = np.asarray(pr.b), np.asarray(pr.a)
    want = dsptpu.filtfilt(b, a, jnp.asarray(x))
    got = dsptpu_torch.filtfilt(b, a, torch.as_tensor(x))
    check(got, want, TOL[dtype])
    own = dsptpu_torch.PolynomialRatio(b, a)
    check(dsptpu_torch.filtfilt(own, torch.as_tensor(x)), want, TOL[dtype])


def test_filtfilt_long_tf_takes_the_state_space_route():
    """len(b) + len(a) > 66: one DF2T state space of the whole
    polynomial (_iir_filtfilt)."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((800, 2))
    b = rng.standard_normal(64) * 0.05
    a = np.array([1.0, -0.5, 0.2])
    want = dsptpu.filtfilt(b, a, jnp.asarray(x))
    check(dsptpu_torch.filtfilt(torch.as_tensor(b), torch.as_tensor(a),
                                torch.as_tensor(x)), want, 1e-10)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", [(), (3,)])
def test_filtfilt_fir_matches_dsptpu(dtype, shape):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1200,) + shape).astype(dtype)
    b = rng.standard_normal(31).astype(dtype)
    want = dsptpu.filtfilt(jnp.asarray(b), jnp.asarray(x))
    got = dsptpu_torch.filtfilt(torch.as_tensor(b), torch.as_tensor(x))
    check(got, want, TOL[dtype])
    want = dsptpu.filtfilt(b, np.array([2.0]), jnp.asarray(x))
    got = dsptpu_torch.filtfilt(b, np.array([2.0]), torch.as_tensor(x))
    check(got, want, TOL[dtype])


def test_filt_stepstate_matches_dsptpu():
    from dsptpu.filters.filt import (filt_stepstate as jax_stepstate,
                                     filt_stepstate_sos as jax_stepstate_sos)
    pr = dsptpu.filters.as_polynomial_ratio(butter(4, 0.3))
    for w, g in zip(jax_stepstate(pr.b, pr.a), filt_stepstate(pr.b, pr.a)):
        np.testing.assert_array_equal(w, g)
    sos = dsptpu.filters.as_sos(butter(8, 0.2)).sos_array()
    np.testing.assert_array_equal(jax_stepstate_sos(sos),
                                  filt_stepstate_sos(sos))


def _pair(order, cut):
    sos = dsptpu.filters.as_sos(butter(order, cut))
    arr, g = sos.sos_array(), sos.g
    return jax_blockss(*jax_stack(arr, g)), _blockss(*_stack_cascade(arr, g))


@pytest.mark.parametrize("n,C,n_eff", [(2053, 2, None), (1024, 1, None),
                                       (2053, 3, 1536), (1024, 2, 1024)])
def test_k2_reverse_plain_matches_pallas_interpret(n, C, n_eff):
    jss, tss = _pair(8, 0.2)
    rng = np.random.default_rng(n + C)
    x = rng.standard_normal((n, C)).astype(np.float32)
    z0 = rng.standard_normal((tss.p, C)).astype(np.float32)
    want = blockss_filt_pallas(jss, jnp.asarray(x), jnp.asarray(z0), TB=4,
                               interpret=True, reverse=True, n_eff=n_eff)
    got = tbiir.blockss_filt(tss, torch.as_tensor(x), torch.as_tensor(z0),
                             reverse=True, n_eff=n_eff)
    check(got, want, 1e-4)
    assert tbiir.launches["biir"] == 0


def test_k2_reverse_refusals():
    _, tss = _pair(4, 0.2)
    x, z0 = torch.zeros(1024, 1), torch.zeros(tss.p, 1)
    with pytest.raises(ValueError, match="need_state"):
        tbiir.blockss_filt(tss, x, z0, need_state=True, reverse=True)
    for bad in (1000, 2048, 0):
        with pytest.raises(ValueError, match="n_eff"):
            tbiir.blockss_filt(tss, x, z0, reverse=True, n_eff=bad)
    with pytest.raises(ValueError, match="n_eff"):
        tbiir.blockss_filt(tss, x, z0, n_eff=512)


def test_blockss_apply_reverse_routes_agree():
    """The torch route (flip, forward, flip) and K2's reverse mode
    (plain version on the CPU) give the same anti-causal pass."""
    _, tss = _pair(6, 0.25)
    rng = np.random.default_rng(12)
    x = torch.as_tensor(rng.standard_normal((1300, 2)).astype(np.float32))
    z0 = torch.as_tensor(rng.standard_normal((tss.p, 2)).astype(np.float32))
    k, _ = _blockss_apply(tss, x, z0, need_state=False, reverse=True)
    t, _ = _blockss_apply(tss, x.double(), z0.double(), need_state=False,
                          reverse=True)
    check(k, t.numpy(), 1e-5)


@pytest.mark.parametrize("kind", ["sos", "biquad", "ba"])
def test_df2tfilter_chunked_equals_one_shot(kind):
    rng = np.random.default_rng(13)
    x = rng.standard_normal((3000, 2))
    zpk = butter(4, 0.3)
    if kind == "sos":
        jc, tc = dsptpu.filters.as_sos(zpk), port_sos(zpk)
    elif kind == "biquad":
        jc = dsptpu.Biquad(0.2, 0.3, 0.1, -0.4, 0.2)
        tc = dsptpu_torch.Biquad(0.2, 0.3, 0.1, -0.4, 0.2)
    else:
        pr = dsptpu.filters.as_polynomial_ratio(zpk)
        jc = pr
        tc = dsptpu_torch.PolynomialRatio(np.asarray(pr.b), np.asarray(pr.a))
    one = dsptpu_torch.DF2TFilter(tc, (2,))(torch.as_tensor(x))
    f = dsptpu_torch.DF2TFilter(tc, (2,))
    parts = [dsptpu_torch.filt(f, torch.as_tensor(x[i:j]))
             for i, j in [(0, 700), (700, 701), (701, 2100), (2100, 3000)]]
    check(torch.cat(parts), one.numpy(), 1e-12)
    jf = dsptpu.DF2TFilter(jc, (2,))
    want = np.concatenate([np.asarray(jf(jnp.asarray(x[:1500]))),
                           np.asarray(jf(jnp.asarray(x[1500:])))])
    check(one, want, 1e-10)
    check(f.state, np.asarray(jf.state), 1e-10)


def test_df2tfilter_initial_state_and_refusals():
    tc = port_sos(butter(2, 0.3))
    si = np.ones((2, 1, 3))
    f = dsptpu_torch.DF2TFilter(tc, (3,), si=si)
    assert f.state.shape == (2, 1, 3)
    with pytest.raises(ValueError, match="state shape"):
        dsptpu_torch.DF2TFilter(tc, (2,), si=si)
    with pytest.raises(TypeError):
        dsptpu_torch.DF2TFilter(np.ones(3))
    jf = dsptpu.DF2TFilter(dsptpu.filters.as_sos(butter(2, 0.3)), (3,),
                           si=jnp.asarray(si))
    x = np.random.default_rng(14).standard_normal((500, 3))
    check(f(torch.as_tensor(x)), jf(jnp.asarray(x)), 1e-10)


def _misses():
    """{table name: misses} of the table counters since the last reset
    (0 for a table looked up only with hits)."""
    c = profiling.counters()
    return {k.split(".")[1]: c.get(k.rsplit(".", 1)[0] + ".miss", 0)
            for k in c if k.startswith("table.")}


def test_filtfilt_ba_step_states_by_a0_keep_their_own_edge_tables():
    """(b, a) and (2b, 2a) normalise to one system, but the step state
    scales with a[0], so the kernel route's edge tables (ff_dev) keep an
    entry each on that system. Both held to dsptpu's (b, a) route (the
    one filtfilt takes when root-finding fails)."""
    from dsptpu.filters.filt import _iir_filtfilt as jax_iir_filtfilt
    filt_mod._design_ss.entries.clear()
    pr = dsptpu.filters.as_polynomial_ratio(butter(4, 0.3))
    b, a = np.asarray(pr.b), np.asarray(pr.a)
    x = np.random.default_rng(31).standard_normal((2000, 2)).astype(
        np.float32)
    for k in (1.0, 2.0):
        got = filt_mod._iir_filtfilt(k * b, k * a, torch.as_tensor(x))
        check(got, jax_iir_filtfilt(k * b, k * a, jnp.asarray(x)), 1e-4)
    (ss,) = filt_mod._design_ss.entries.values()
    ff = [k for k in ss.tables if k[0] == "ff_dev"]
    assert len(ff) == 2 and ff[0][1] != ff[1][1]


@pytest.mark.parametrize("route", ["sosfilt_si", "df2t_chunks",
                                   "filtfilt_sos", "filtfilt_ba"])
def test_table_miss_and_hit_calls_agree_bit_for_bit(route, monkeypatch):
    """A call that builds its system's tables (K2's need_state tail for
    streaming sosfilt and DF2TFilter chunks of 700, 1400 and 900 rows;
    filtfilt's step state and edge tables on the cascade and the (b, a)
    routes) and a call that finds them give the same output bit for bit,
    held to dsptpu."""
    zpk = butter(6, 0.25)
    jsos = dsptpu.filters.as_sos(zpk)
    rng = np.random.default_rng(32)
    x = rng.standard_normal((3000, 2)).astype(np.float32)
    si = rng.standard_normal((2, 3, 2)).astype(np.float32)
    if route == "sosfilt_si":
        built = "tail"
        want = dsptpu.sosfilt(jsos, jnp.asarray(x), si=jnp.asarray(si))[0]

        def run():
            return dsptpu_torch.sosfilt(port_sos(zpk), torch.as_tensor(x),
                                        si=torch.as_tensor(si))[0]
    elif route == "df2t_chunks":
        built = "tail"
        want = dsptpu.DF2TFilter(jsos, (2,))(jnp.asarray(x))

        def run():
            f = dsptpu_torch.DF2TFilter(port_sos(zpk), (2,))
            return torch.cat([f(torch.as_tensor(x[i:j])) for i, j in
                              [(0, 700), (700, 2100), (2100, 3000)]])
    elif route == "filtfilt_sos":
        built = "zstep"
        want = dsptpu.filtfilt(jsos, jnp.asarray(x))

        def run():
            return dsptpu_torch.filtfilt(port_sos(zpk), torch.as_tensor(x))
    else:
        from dsptpu.filters.filt import _iir_filtfilt as jax_iir_filtfilt
        pr = dsptpu.filters.as_polynomial_ratio(zpk)
        b, a = np.asarray(pr.b), np.asarray(pr.a)
        built = "ff_dev"
        want = jax_iir_filtfilt(b, a, jnp.asarray(x))

        def no_roots(_):
            raise np.linalg.LinAlgError("root-finding refused")
        monkeypatch.setattr(filt_mod, "as_sos", no_roots)

        def run():
            return dsptpu_torch.filtfilt(b, a, torch.as_tensor(x))
    filt_mod._design_ss.entries.clear()
    profiling.reset()
    miss = run()
    assert _misses()[built] > 0
    profiling.reset()
    hit = run()
    assert set(_misses().values()) == {0}
    assert torch.equal(miss, hit)
    check(hit, want, 1e-4)


def _ff_system(kind):
    """(system, step state) as filtfilt builds them for Butterworth(8) at
    0.2: the cascade of sections (the SOS output stage) or the (b, a)
    form's single state space (the F stage)."""
    f = dsptpu.filters.as_sos(butter(8, 0.2))
    if kind == "sos":
        arr = f.sos_array()
        ss = filt_mod._cascade_ss(arr, f.g)
        return ss, np.swapaxes(filt_stepstate_sos(arr), 0, 1).reshape(-1)
    pr = dsptpu.filters.as_polynomial_ratio(butter(4, 0.3))
    zi, bp, ap = filt_stepstate(np.asarray(pr.b), np.asarray(pr.a))
    return filt_mod._design_ss(np.array([bp, ap])), zi


@pytest.mark.parametrize("kind", ["sos", "ba"])
@pytest.mark.parametrize("n,C,pad", [(2048, 3, 24), (2112, 1, 24),
                                     (2000, 64, 195), (4096, 2, 195),
                                     (1000, 1, 12)])
def test_filtfilt_kernel_route_is_the_two_cat_form(kind, n, C, pad):
    """The kernel route without the concatenations (K2 reading the back
    extension from its own tensor, the reverse pass and the tail written
    into the output) gives the two-cat form's output bit for bit, at
    n % 128 = 0 (no tail) and otherwise, on the cascade and the (b, a)
    systems; one back read and one write into the output a call."""
    ss, zst = _ff_system(kind)
    x = torch.as_tensor(np.random.default_rng(n + C).standard_normal(
        (n, C)).astype(np.float32))
    profiling.reset()
    got = filt_mod._filtfilt_kernel(ss, zst, x, pad, n)
    c = profiling.counters()
    assert (c.get("route.biir.back"), c.get("route.biir.into")) == (1, 1)
    assert got.shape == (n, C) and got.is_contiguous()
    assert torch.equal(got, filtfilt_two_cats(ss, zst, x, pad))


def test_filtfilt_lpc_entry_reads_back_and_writes_into_once(monkeypatch):
    """Path B on the CPU: each filtfilt_lpc_entry call reads the back
    extension through K2's second tensor once and writes into the output
    once, and its filtfilt is the two-cat form's bit for bit."""
    seen = []
    route = filt_mod._filtfilt_kernel
    monkeypatch.setattr(filt_mod, "_filtfilt_kernel",
                        lambda *a: seen.append(a) or route(*a))
    fwd, (x,) = dsptpu_torch.filtfilt_lpc_entry(device="cpu", n=51200,
                                                channels=1)
    for _ in range(2):
        profiling.reset()
        y, _ = fwd(x)
        c = profiling.counters()
        assert (c.get("route.biir.back"), c.get("route.biir.into")) == (1, 1)
    assert len(seen) == 2
    ss, zst, xf, pad, n = seen[-1]
    assert torch.equal(y, filtfilt_two_cats(ss, zst, xf, pad))
