"""The port's hand-written kernels on the card: each kernel against its
plain PyTorch version on CUDA tensors, one launch per wrapper call, the
whole slice through every kernel, and the wrappers' refusals (nothing
falls back quietly to another path).

Marked `cuda`: every test skips without a CUDA device. These tests import
no JAX, so on a GPU machine without it they run with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: max|d| <= 3e-5 max|ref| for FIR and STFT, <= 1e-4 for the IIR
pass and the whole float32 chain against its float64 run."""

import numpy as np
import pytest
import torch

import dsptpu_torch
from dsptpu_torch import kernels
from dsptpu_torch.filters.filt import _blockss, _stack_cascade
from dsptpu_torch.kernels import biir, fir, stft

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def check(got, want, tol):
    torch.cuda.synchronize()
    assert got.shape == want.shape
    got, want = got.double(), want.double()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= tol * want.abs().max()


def launched_once(mod, call):
    before = mod.launches
    out = call()
    assert mod.launches == before + 1
    return out


def randn(dev, *shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                           device=dev)


@pytest.mark.parametrize("n,C,nb", [(40037, 1, 2), (40037, 3, 127),
                                    (33001, 64, 300), (5000, 40, 1536)])
def test_fir_kernel_matches_plain(dev, n, C, nb):
    x, b = randn(dev, n, C, seed=n), randn(dev, nb, seed=nb)
    y = launched_once(fir, lambda: fir.fir(x, b))
    check(y, fir.fir_reference(x, b), 3e-5)


@pytest.mark.parametrize("need_state", [False, True])
@pytest.mark.parametrize("n,C", [(5003, 3), (70001, 2)])
def test_biir_kernel_matches_plain(dev, n, C, need_state):
    sos = dsptpu_torch.as_sos(dsptpu_torch.digitalfilter(
        dsptpu_torch.Lowpass(0.2), dsptpu_torch.Butterworth(8)))
    ss = _blockss(*_stack_cascade(sos.sos_array(), sos.g))
    x, z0 = randn(dev, n, C, seed=n), randn(dev, ss.p, C, seed=C)
    got = launched_once(biir, lambda: biir.blockss_filt(ss, x, z0,
                                                        need_state))
    want = biir.blockss_reference(ss, x, z0, need_state)
    pairs = zip(got, want) if need_state else [(got, want)]
    for g, w in pairs:
        check(g, w, 1e-4)


@pytest.mark.parametrize("accumulate", [True, False])
@pytest.mark.parametrize("n,C,nfft,hop", [(7001, 3, 384, 128),
                                          (30011, 9, 1024, 512)])
def test_stft_kernel_matches_plain(dev, n, C, nfft, hop, accumulate):
    x = randn(dev, n, C, seed=nfft)
    win = torch.hann_window(nfft, device=dev)
    k = (n - nfft) // hop + 1
    scale = torch.linspace(0.5, 2.0, nfft // 2 + 1, device=dev)
    got = launched_once(stft, lambda: stft.stft_pow(x, win, nfft, hop, k,
                                                    accumulate, scale))
    check(got, stft.stft_pow_reference(x, win, nfft, hop, k, accumulate,
                                       scale), 3e-5)


def test_entry_runs_every_kernel(dev):
    fwd, (x,) = dsptpu_torch.entry(device="cuda", n=40000, channels=3)
    kernels.reset_launches()
    psd, s = fwd(x)
    assert kernels.launch_counts() == {"fir": 1, "biir": 1, "stft": 2}
    psd64, s64 = fwd(x.double())
    check(psd, psd64, 1e-4)
    check(s, s64, 1e-4)


def test_wrappers_refuse_instead_of_falling_back(dev):
    x = randn(dev, 5000, 2)
    with pytest.raises(TypeError):
        fir.fir(x.double(), torch.ones(9, dtype=torch.float64, device=dev))
    sos = dsptpu_torch.as_sos(dsptpu_torch.digitalfilter(
        dsptpu_torch.Lowpass(0.2), dsptpu_torch.Butterworth(4)))
    ss = _blockss(*_stack_cascade(sos.sos_array(), sos.g))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        biir.blockss_filt(ss, x, torch.zeros(ss.p, 2, device=dev),
                          reverse=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dsptpu_torch.filt(torch.ones(600, device=dev), x)
