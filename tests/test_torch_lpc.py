"""Port parity for LPC: dsptpu_torch's arburg, levinson and lpc (Burg
and Levinson-Durbin; 1-D, multichannel, complex) against dsptpu's, and
the plain version of K5 (kernels/levinson.levinson_reference, what the
wrapper runs on a CPU tensor) against dsptpu's Pallas Levinson kernel
in interpret mode, at the cases of dsptpu's own kernel test.

Inputs come from a numpy seed. The reference side of a multichannel
case runs under jax.jit (its order loops compile once instead of op by
op); a 1-D case runs eagerly, because dsptpu's arburg and levinson of a
1-D input give other float64 results under jit (levinson's predictor
6.7e-5 off scipy's Toeplitz solve at p = 8; eagerly 3e-17). Tolerances: max|d| <= 1e-10 max|ref| in
float64, <= 1e-4 max|ref| in float32 (bench.py's LPC bound: an order-16
recursion on float32 lags)."""

import pathlib
import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import dsptpu
import dsptpu_torch
from dsptpu.kernels.levinson import levinson_pallas
from dsptpu_torch import kernels
from dsptpu_torch.kernels import levinson as tlev

TOL = {np.float64: 1e-10, np.float32: 1e-4, np.complex128: 1e-10}


def check(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.max(np.abs(got.astype(np.complex128) - want))
    assert err <= tol * np.max(np.abs(want)), err


def signal(rng, shape, dtype):
    """An AR(2) process, so that the predictors are well defined."""
    e = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        e = e + 1j * rng.standard_normal(shape)
    x = np.zeros_like(e)
    for t in range(shape[0]):
        x[t] = e[t] + (0.6 * x[t - 1] - 0.3 * x[t - 2] if t >= 2 else 0)
    return x.astype(dtype)


def reference(fn, x):
    """fn(x) on the JAX side: under jit for a multichannel x."""
    x = jnp.asarray(x)
    return fn(x) if x.ndim == 1 else jax.jit(fn)(x)


def lags(x, p):
    n = x.shape[0]
    return np.stack([np.sum(np.conj(x[: n - l]) * x[l:], axis=0) / n
                     for l in range(p + 1)], axis=0)


@pytest.mark.parametrize("shape,dtype", [((500,), np.float64),
                                         ((400, 3), np.float64),
                                         ((400, 2), np.float32),
                                         ((300,), np.complex128)])
def test_arburg_matches_dsptpu(shape, dtype):
    rng = np.random.default_rng(1)
    x = signal(rng, shape, dtype)
    want = reference(lambda v: dsptpu.arburg(v, 4), x)
    got = dsptpu_torch.arburg(torch.as_tensor(x), 4)
    for g, w in zip(got, want):
        check(g, w, TOL[dtype])


@pytest.mark.parametrize("shape,dtype", [((9,), np.float64),
                                         ((9, 4), np.float64),
                                         ((9, 4), np.float32),
                                         ((9, 200), np.float32),
                                         ((9,), np.complex128)])
def test_levinson_matches_dsptpu(shape, dtype):
    """(9, 200) float32 meets K5's gate: the plain version on the CPU."""
    rng = np.random.default_rng(2)
    R = lags(signal(rng, (400,) + shape[1:], dtype), 8).astype(dtype)
    want = reference(lambda r: dsptpu.levinson(r, 8), R)
    kernels.reset_launches()
    got = dsptpu_torch.levinson(torch.as_tensor(R), 8)
    assert kernels.launch_counts()["levinson"] == 0
    for g, w in zip(got, want):
        check(g, w, TOL[dtype])


@pytest.mark.parametrize("method", ["burg", "levinson"])
@pytest.mark.parametrize("shape,dtype", [((600,), np.float64),
                                         ((400, 3), np.float64),
                                         ((400, 130), np.float32)])
def test_lpc_matches_dsptpu(method, shape, dtype):
    """(400, 130) float32 with Levinson: the lags meet K5's gate."""
    rng = np.random.default_rng(3)
    x = signal(rng, shape, dtype)
    want = reference(lambda v: dsptpu.lpc(v, 6, method=method), x)
    got = dsptpu_torch.lpc(torch.as_tensor(x), 6, method=method)
    for g, w in zip(got, want):
        check(g, w, TOL[dtype])


def test_lpc_method_markers():
    x = torch.as_tensor(signal(np.random.default_rng(4), (300, 2),
                               np.float64))
    for marker, name in [(dsptpu_torch.LPCBurg(), "burg"),
                         (dsptpu_torch.LPCBurg, "burg"),
                         (dsptpu_torch.LPCLevinson(), "levinson"),
                         (dsptpu_torch.LPCLevinson, "levinson")]:
        for g, w in zip(dsptpu_torch.lpc(x, 4, marker),
                        dsptpu_torch.lpc(x, 4, name)):
            assert torch.equal(g, w)
    with pytest.raises(ValueError, match="method"):
        dsptpu_torch.lpc(x, 4, method="other")


@pytest.mark.parametrize("p,C", [(16, 300), (8, 2500), (32, 128), (2, 200)])
def test_k5_plain_matches_pallas_interpret(p, C):
    rng = np.random.default_rng(p + C)
    x = rng.standard_normal((400, C)).astype(np.float32)
    R = lags(x, p).astype(np.float32)
    want = levinson_pallas(jnp.asarray(R), p, True, 256)
    got = tlev.levinson(torch.as_tensor(R), p)
    for g, w in zip(got, want):
        check(g, w, 1e-4)
    assert tlev.launches["levinson"] == 0


@pytest.mark.parametrize("p,C,ok", [(2, 128, True), (64, 2500, True),
                                    (1, 200, False), (65, 200, False),
                                    (16, 127, False)])
def test_k5_gate_is_dsptpus(p, C, ok):
    from dsptpu.kernels.levinson import lev_supported
    assert lev_supported(p, C, np.float32) == ok
    assert tlev.lev_supported(p, C, torch.float32) == ok
    assert not tlev.lev_supported(p, C, torch.float64)


K5_ORDERS = (2, 8, 9, 16, 17, 32, 33, 64)   # the order classes' edges
# the kernel's accumulators for the order's dot
K5_ACC = int(re.search(r"constexpr int kAcc = (\d+);", (
    pathlib.Path(tlev.__file__).parent.parent / "csrc" /
    "levinson.cu").read_text()).group(1))


@pytest.mark.parametrize("C", [128, 130])
@pytest.mark.parametrize("p", K5_ORDERS)
def test_k5_plain_matches_pallas_interpret_order_classes(p, C):
    """K5's plain version against dsptpu's Pallas kernel at each edge of
    the CUDA kernel's order classes (8, 16, 32, 64)."""
    rng = np.random.default_rng(10 * p + C)
    R = lags(rng.standard_normal((400, C)), p).astype(np.float32)
    want = levinson_pallas(jnp.asarray(R), p, True, 256)
    got = tlev.levinson(torch.as_tensor(R), p)
    for g, w in zip(got, want):
        check(g, w, 1e-4)


def emulate_k5(R, p, nacc=4):
    """The CUDA kernel's operation order (csrc/levinson.cu) in numpy
    float32, one column per channel: term i of the order-m dot in
    accumulator i % nacc (accumulator 0 starts at R[m]), the accumulators
    summed as a tree, k = -acc / err, the pair update a[i] += k a[m-2-i],
    a[m-2-i] += k a[i] from the old pair, the middle element once, each
    multiply-add rounded once (float64 product and sum, then float32).
    Returns (a, err, refl)."""
    f32 = np.float32

    def fma(x, y, z):
        return (x.astype(np.float64) * y + z).astype(f32)
    r = R[: p + 1].astype(f32)
    C = r.shape[1]
    a = np.zeros((p, C), f32)
    refl = np.zeros((p, C), f32)
    k = -r[1] / r[0]
    err = r[0] * fma(-k, k, np.ones(C, f32))
    a[0] = refl[0] = k
    for m in range(2, p + 1):
        s = [r[m].copy()] + [np.zeros(C, f32) for _ in range(nacc - 1)]
        for i in range(1, m):
            s[i % nacc] = fma(r[i], a[m - 1 - i], s[i % nacc])
        w = nacc // 2
        while w:
            for j in range(w):
                s[j] = s[j] + s[j + w]
            w //= 2
        k = -s[0] / err
        old = a[: m - 1].copy()
        for i in range((m - 1) // 2):
            a[i] = fma(k, old[m - 2 - i], old[i])
            a[m - 2 - i] = fma(k, old[i], old[m - 2 - i])
        if (m - 1) % 2:
            h = (m - 2) // 2
            a[h] = fma(k, old[h], old[h])
        a[m - 1] = refl[m - 1] = k
        err = err * fma(-k, k, np.ones(C, f32))
    return a, err, refl


@pytest.mark.parametrize("nacc", [1, K5_ACC])
@pytest.mark.parametrize("p", K5_ORDERS)
def test_k5_kernel_order_emulated(p, nacc):
    """The kernel's accumulator split and pair update, emulated, against
    the plain version within 1e-5; nacc 1 is one accumulator, K5_ACC the
    kernel's (kAcc in csrc/levinson.cu)."""
    rng = np.random.default_rng(p)
    x = signal(rng, (400, 130), np.float64)
    R = lags(x, p).astype(np.float32)
    got = emulate_k5(R, p, nacc)
    want = tlev.levinson_reference(torch.as_tensor(R), p)
    for g, w in zip(got, want):
        check(g, w, 1e-5)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("C,p", [(130, 16), (2500, 16), (130, 64)])
def test_lpc_batched_lags_match_dsptpu(C, p, dtype):
    """lpc's lags in one batched pass (ops/lpc._biased_lags) against the
    p+1 shifted sums, and lpc(..., "levinson") against dsptpu's: 1e-9
    relative in float64 (x64), 1e-4 in float32 (K5's plain version)."""
    from dsptpu_torch.ops.lpc import _biased_lags
    rng = np.random.default_rng(C + p)
    x = signal(rng, (400, C), np.float64).astype(dtype)
    tol = 1e-9 if dtype == np.float64 else 1e-4
    check(_biased_lags(torch.as_tensor(x), p),
          lags(x.astype(np.float64), p), 1e-12 if dtype == np.float64
          else 1e-6)
    want = reference(lambda v: dsptpu.lpc(v, p, method="levinson"), x)
    got = dsptpu_torch.lpc(torch.as_tensor(x), p, method="levinson")
    for g, w in zip(got, want):
        check(g, w, tol)
