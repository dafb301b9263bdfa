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


@pytest.mark.parametrize("shape", [(1024, 512), (1000, 300), (513, 2048),
                                   (33, 4097)])
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
                                           (1, 1, 4, 8, 33),
                                           (5, 1, 2, 7, 1),
                                           (5, 1, 2, 7, 128)])
def test_spectro_permute_matches_pallas_interpret(C, nb, N1, TB, l2):
    tile = rand((C, nb, N1, TB, 128), C * TB)
    want = np.asarray(spectro_permute_pallas(jnp.asarray(tile), l2,
                                             interpret=True))
    got = tt.spectro_permute(torch.as_tensor(tile), l2)
    assert np.array_equal(got.numpy(), want)


def offset_view(x, off):
    """x's values in a contiguous view at a storage offset of `off` floats
    (rows not 16-byte aligned at 1: the card kernels' one-float path)."""
    buf = torch.zeros(x.size + off)
    buf[off:] = torch.as_tensor(x).reshape(-1)
    return buf[off:].view(*x.shape)


@pytest.mark.parametrize("off", [1, 4])
def test_offset_views_match_pallas_interpret(off):
    x = rand((1025, 300), off)
    got = tt.transpose2d(offset_view(x, off))
    assert np.array_equal(got.numpy(), np.asarray(
        transpose2d_pallas(jnp.asarray(x), interpret=True)))
    x = rand((10_001, 8), off + 1)
    got = tt.transpose_tall(offset_view(x, off), TR=2048)
    assert np.array_equal(got.numpy(), np.asarray(transpose_tall_pallas(
        jnp.asarray(x), TR=2048, interpret=True)))
    tile = rand((5, 1, 3, 9, 128), off + 2)
    got = tt.spectro_permute(offset_view(tile, off), 128)
    assert np.array_equal(got.numpy(), np.asarray(spectro_permute_pallas(
        jnp.asarray(tile), 128, interpret=True)))


def test_spectro_permute_refuses_bad_shapes():
    with pytest.raises(ValueError):
        tt.spectro_permute(torch.zeros(2, 1, 4, 8, 64), 3)
    with pytest.raises(ValueError):
        tt.spectro_permute(torch.zeros(2, 1, 4, 8, 128), 129)
