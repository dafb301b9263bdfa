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
