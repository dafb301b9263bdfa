"""Port parity for K8a-c: the plain versions of dsptpu_torch's
transpose2d, transpose_tall and spectro_permute (what the wrappers run
on a CPU tensor) against dsptpu's Pallas transpose kernels in interpret
mode, at dsptpu's own test shapes. A transpose is exact: every
comparison is bit for bit."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dsptpu.kernels.transpose import (spectro_permute_pallas,
                                      transpose2d_pallas,
                                      transpose_tall_pallas)

from dsptpu_torch import kernels
from dsptpu_torch.kernels import transpose as tt


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(1024, 512), (1000, 300), (513, 2048)])
def test_transpose2d_matches_pallas_interpret(shape):
    x = rand(shape, shape[0])
    want = np.asarray(transpose2d_pallas(jnp.asarray(x), interpret=True))
    kernels.reset_launches()
    got = tt.transpose2d(torch.as_tensor(x))
    assert np.array_equal(got.numpy(), want)
    assert kernels.launch_counts()["transpose2d"] == 0


@pytest.mark.parametrize("M,C,TR,pad_to", [(10_000, 8, 2048, 12_000),
                                           (10_000, 8, 2048, None),
                                           (4096, 3, 1024, 100)])
def test_transpose_tall_matches_pallas_interpret(M, C, TR, pad_to):
    x = rand((M, C), M + C)
    want = np.asarray(transpose_tall_pallas(jnp.asarray(x), TR=TR,
                                            pad_to=pad_to, interpret=True))
    got = tt.transpose_tall(torch.as_tensor(x), TR=TR, pad_to=pad_to)
    assert got.shape[1] == tt.tall_out_len(M, TR, pad_to)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("C,nb,N1,TB,l2", [(3, 2, 8, 16, 65),
                                           (1, 1, 4, 8, 33)])
def test_spectro_permute_matches_pallas_interpret(C, nb, N1, TB, l2):
    tile = rand((C, nb, N1, TB, 128), C * TB)
    want = np.asarray(spectro_permute_pallas(jnp.asarray(tile), l2,
                                             interpret=True))
    got = tt.spectro_permute(torch.as_tensor(tile), l2)
    assert np.array_equal(got.numpy(), want)


def test_spectro_permute_refuses_bad_shapes():
    with pytest.raises(ValueError):
        tt.spectro_permute(torch.zeros(2, 1, 4, 8, 64), 3)
    with pytest.raises(ValueError):
        tt.spectro_permute(torch.zeros(2, 1, 4, 8, 128), 129)
