"""Port parity for the FIR path: dsptpu_torch's filt(b, x) against
dsptpu.filt, and the plain version of K1 (kernels/fir.fir_reference,
what the wrapper runs on a CPU tensor) against dsptpu's Pallas FIR
kernel in interpret mode.

Inputs come from a numpy seed and go to both packages as explicit
float32 or float64 arrays. Tolerances: max|d| <= 1e-10 max|ref| in
float64, <= 3e-5 max|ref| in float32 (bench.py's FIR bound)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import dsptpu
import dsptpu_torch
from dsptpu.kernels.fir import fir_pallas
from dsptpu_torch.convert import taps_from_numpy
from dsptpu_torch.kernels import fir as tfir

TOL = {np.float64: 1e-10, np.float32: 3e-5}


def check(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.max(np.abs(got.astype(np.float64) - want))
    assert err <= tol * np.max(np.abs(want)), err


@pytest.mark.parametrize("n,shape,nb,dtype", [
    (5000, (3,), 127, np.float64),      # block-Toeplitz product
    (40000, (3,), 127, np.float32),     # K1 gate (plain K1 on the CPU)
    (40001, (), 127, np.float32),       # K1 gate, 1-D signal
    (33000, (2, 2), 300, np.float32),   # K1 gate, 2 channel dims
    (300, (2,), 127, np.float64),       # n < 4 nb: convolution
    (3000, (2,), 31, np.float32),       # block-Toeplitz in float32
])
def test_filt_fir_matches_dsptpu(n, shape, nb, dtype):
    rng = np.random.default_rng(n + nb)
    x = rng.standard_normal((n,) + shape).astype(dtype)
    b = rng.standard_normal(nb).astype(dtype)
    want = dsptpu.filt(jnp.asarray(b), jnp.asarray(x))
    got = dsptpu_torch.filt(taps_from_numpy(b, "cpu"), torch.as_tensor(x))
    assert got.dtype == torch.from_numpy(x).dtype
    check(got, want, TOL[dtype])


def test_filt_fir_complex_short_signal():
    """Complex input below 4 nb: four real convolutions."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((200, 2)) + 1j * rng.standard_normal((200, 2))
    b = rng.standard_normal(64)
    want = np.asarray(dsptpu.filt(jnp.asarray(b), jnp.asarray(x)))
    got = dsptpu_torch.filt(torch.as_tensor(b), torch.as_tensor(x)).numpy()
    assert np.max(np.abs(got - want)) <= 1e-10 * np.max(np.abs(want))


def test_filt_fir_a0_normalization():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2000, 2))
    b = rng.standard_normal(17)
    want = dsptpu.filt(jnp.asarray(b), 2.0, jnp.asarray(x))
    got = dsptpu_torch.filt(torch.as_tensor(b), 2.0, torch.as_tensor(x))
    check(got, want, 1e-10)


@pytest.mark.parametrize("nb", [2, 127, 300])
@pytest.mark.parametrize("C", [1, 3])
def test_fir_plain_matches_pallas_interpret(nb, C):
    rng = np.random.default_rng(10 * nb + C)
    n = 4 * 1024 + 77                   # ragged: not a multiple of 128
    x = rng.standard_normal((n, C)).astype(np.float32)
    b = rng.standard_normal(nb).astype(np.float32)
    want = fir_pallas(jnp.asarray(x), jnp.asarray(b), interpret=True)
    got = tfir.fir(torch.as_tensor(x), torch.as_tensor(b))
    check(got, want, 3e-5)
    assert tfir.launches == 0


def test_fir_cpu_tensor_runs_plain_version():
    x = torch.randn(1000, 2)
    b = torch.randn(9)
    assert torch.equal(tfir.fir(x, b), tfir.fir_reference(x, b))
    assert tfir.launches == 0


def test_long_taps_route_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dsptpu_torch.filt(torch.randn(600), torch.randn(5000))
