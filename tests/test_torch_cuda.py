"""The port's hand-written kernels on the card: each kernel against its
plain PyTorch version on CUDA tensors, one launch per wrapper call, the
whole slice through every kernel, and the wrappers' refusals (nothing
falls back quietly to another path).

Marked `cuda`: every test skips without a CUDA device. These tests import
no JAX, so on a GPU machine without it they run with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: max|d| <= 3e-5 max|ref| for FIR, STFT and overlap-save,
<= 1e-4 for the IIR pass (both directions), Levinson, filtfilt and the
whole float32 chain against its float64 run."""

import numpy as np
import pytest
import torch

import dsptpu_torch
from dsptpu_torch import kernels
from dsptpu_torch.filters.filt import _blockss, _stack_cascade
from dsptpu_torch.kernels import biir, fir, levinson, osconv, stft

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
    assert kernels.launch_counts() == {"fir": 1, "biir": 1, "stft": 2,
                                       "osconv": 0, "levinson": 0,
                                       "biir_reverse": 0}
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
    z0 = randn(dev, ss.p, 2, seed=1)
    # reverse, and filt with more than 512 taps, run their kernels
    got = launched_once(biir, lambda: biir.blockss_filt(ss, x, z0,
                                                        reverse=True))
    check(got, biir.blockss_reference(ss, x, z0, reverse=True), 1e-4)
    b = randn(dev, 600, seed=2)
    got = launched_once(osconv, lambda: dsptpu_torch.filt(b, x))
    check(got, dsptpu_torch.filt(b.cpu().double(), x.cpu().double()).to(dev),
          3e-5)
    with pytest.raises(ValueError, match="need_state"):
        biir.blockss_filt(ss, x, z0, need_state=True, reverse=True)
    with pytest.raises(ValueError, match="n_eff"):
        biir.blockss_filt(ss, x, z0, reverse=True, n_eff=1000)
    v = randn(dev, 300, seed=3)
    with pytest.raises(TypeError):
        osconv.osconv(x.double(), v.double(), 1024)
    with pytest.raises(ValueError, match="gate"):
        osconv.osconv(x, v, 384)          # advance 0: the gate fails
    R = randn(dev, 17, 200, seed=4)
    with pytest.raises(TypeError):
        levinson.levinson(R.double(), 16)
    with pytest.raises(ValueError):
        levinson.levinson(R[:, :100], 16)  # C < 128
    with pytest.raises(ValueError):
        levinson.levinson(R, 1)            # p < 2


@pytest.mark.parametrize("out", ["full", "n"])
@pytest.mark.parametrize("n,C,nv,nfft", [(5001, 1, 127, 1024),
                                         (20011, 3, 1025, 4096),
                                         (40003, 17, 3969, 8192),
                                         (70001, 16, 4096, 16384),
                                         (9001, 2, 300, 1920)])
def test_osconv_kernel_matches_plain(dev, n, C, nv, nfft, out):
    x, v = randn(dev, n, C, seed=n), randn(dev, nv, seed=nv)
    out_len = None if out == "full" else n
    got = launched_once(osconv, lambda: osconv.osconv(x, v, nfft, out_len))
    want = osconv.osconv_reference(x, v, nfft,
                                   n + nv - 1 if out_len is None else n)
    check(got, want, 3e-5)


@pytest.mark.parametrize("n_eff", [None, "aligned"])
@pytest.mark.parametrize("order,n,C", [(3, 5003, 1), (8, 4097, 3),
                                       (20, 3001, 64)])
def test_biir_reverse_kernel_matches_plain(dev, order, n, C, n_eff):
    """p = 3 (one (b, a) section), 8 and 20 states (sections padded to
    P = 8, 16 and 32); n_eff the largest multiple of 128 below n."""
    if order == 3:
        from dsptpu_torch.filters.filt import _single_ss
        ss = _blockss(*_single_ss([0.2, 0.1, 0.05, 0.02],
                                  [1.0, -0.5, 0.25, -0.1]))
    else:
        sos = dsptpu_torch.as_sos(dsptpu_torch.digitalfilter(
            dsptpu_torch.Lowpass(0.3), dsptpu_torch.Butterworth(order)))
        ss = _blockss(*_stack_cascade(sos.sos_array(), sos.g))
    m = None if n_eff is None else (n // 128) * 128
    x, z0 = randn(dev, n, C, seed=n), randn(dev, ss.p, C, seed=C)
    got = launched_once(biir, lambda: biir.blockss_filt(
        ss, x, z0, reverse=True, n_eff=m))
    check(got, biir.blockss_reference(ss, x, z0, reverse=True, n_eff=m),
          1e-4)


@pytest.mark.parametrize("p,C", [(2, 128), (16, 300), (32, 2500),
                                 (64, 130)])
def test_levinson_kernel_matches_plain(dev, p, C):
    x = randn(dev, 400, C, seed=p)
    R = torch.stack([(x[: 400 - l] * x[l:]).sum(0) / 400
                     for l in range(p + 1)])
    got = launched_once(levinson, lambda: levinson.levinson(R, p))
    for g, w in zip(got, levinson.levinson_reference(R, p)):
        check(g, w, 1e-4)


def test_paths_run_their_kernels(dev):
    """fftfilt (path A's route), filtfilt and lpc (path B's) on CUDA
    float32 launch K4, K2 forward + reverse, and K5, and agree with the
    same calls in float64."""
    fwd, (x,) = dsptpu_torch.fftfilt_entry(device="cuda", n=70001,
                                           channels=4)
    kernels.reset_launches()
    y = fwd(x)
    assert kernels.launch_counts()["osconv"] == 1
    assert kernels.launch_counts()["fir"] == 0
    check(y, fwd(x.double()), 3e-5)
    fwd, (x,) = dsptpu_torch.filtfilt_lpc_entry(device="cuda", n=60000,
                                                channels=3)
    kernels.reset_launches()
    y, (a, e) = fwd(x)
    assert kernels.launch_counts()["biir"] == 2
    assert kernels.launch_counts()["biir_reverse"] == 1
    assert kernels.launch_counts()["levinson"] == 1
    y64, (a64, e64) = fwd(x.double())
    for g, w in [(y, y64), (a, a64), (e, e64)]:
        check(g, w, 1e-4)
