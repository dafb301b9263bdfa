"""The port's hand-written kernels on the card: each kernel against its
plain PyTorch version on CUDA tensors, one launch per wrapper call, the
whole slice through every kernel, and the wrappers' refusals (nothing
falls back quietly to another path).

Marked `cuda`: every test skips without a CUDA device. These tests import
no JAX, so on a GPU machine without it they run with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: max|d| <= 3e-5 max|ref| for FIR, STFT (one window or a
stack; per bin for the stack), overlap-save, resampling (K6, K7 and the
resampling filters against float64) and the multitaper spectrogram,
<= 1e-4 for the IIR pass (both directions), Levinson, filtfilt, the
coherence and the whole float32 chain against its float64 run. The
transposes (K8a-c) are exact."""

import numpy as np
import pytest
import torch

import dsptpu_torch
from dsptpu_torch import kernels
from dsptpu_torch.filters.filt import _blockss, _stack_cascade
from dsptpu_torch.kernels import (arbd, biir, fir, levinson, osconv, pfb2,
                                  stft, transpose)

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


def launched_once(name, call):
    before = kernels.launch_counts()[name]
    out = call()
    assert kernels.launch_counts()[name] == before + 1
    return out


def randn(dev, *shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                           device=dev)


@pytest.mark.parametrize("n,C,nb", [(40037, 1, 2), (40037, 3, 127),
                                    (33001, 64, 300), (5000, 40, 1536)])
def test_fir_kernel_matches_plain(dev, n, C, nb):
    x, b = randn(dev, n, C, seed=n), randn(dev, nb, seed=nb)
    y = launched_once("fir", lambda: fir.fir(x, b))
    check(y, fir.fir_reference(x, b), 3e-5)


@pytest.mark.parametrize("need_state", [False, True])
@pytest.mark.parametrize("n,C", [(5003, 3), (70001, 2)])
def test_biir_kernel_matches_plain(dev, n, C, need_state):
    sos = dsptpu_torch.as_sos(dsptpu_torch.digitalfilter(
        dsptpu_torch.Lowpass(0.2), dsptpu_torch.Butterworth(8)))
    ss = _blockss(*_stack_cascade(sos.sos_array(), sos.g))
    x, z0 = randn(dev, n, C, seed=n), randn(dev, ss.p, C, seed=C)
    got = launched_once("biir", lambda: biir.blockss_filt(ss, x, z0,
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
    got = launched_once("stft", lambda: stft.stft_pow(x, win, nfft, hop, k,
                                                    accumulate, scale))
    check(got, stft.stft_pow_reference(x, win, nfft, hop, k, accumulate,
                                       scale), 3e-5)


def test_entry_runs_every_kernel(dev):
    fwd, (x,) = dsptpu_torch.entry(device="cuda", n=40000, channels=3)
    kernels.reset_launches()
    psd, s = fwd(x)
    assert kernels.launch_counts() == {"fir": 1, "biir": 1, "stft": 2,
                                       "osconv": 0, "levinson": 0,
                                       "pfb2": 0, "arbd": 0,
                                       "transpose2d": 0,
                                       "transpose_tall": 0,
                                       "spectro_permute": 0,
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
    got = launched_once("biir", lambda: biir.blockss_filt(ss, x, z0,
                                                        reverse=True))
    check(got, biir.blockss_reference(ss, x, z0, reverse=True), 1e-4)
    b = randn(dev, 600, seed=2)
    got = launched_once("osconv", lambda: dsptpu_torch.filt(b, x))
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
    got = launched_once("osconv", lambda: osconv.osconv(x, v, nfft, out_len))
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
    got = launched_once("biir", lambda: biir.blockss_filt(
        ss, x, z0, reverse=True, n_eff=m))
    check(got, biir.blockss_reference(ss, x, z0, reverse=True, n_eff=m),
          1e-4)


@pytest.mark.parametrize("p,C", [(2, 128), (16, 300), (32, 2500),
                                 (64, 130)])
def test_levinson_kernel_matches_plain(dev, p, C):
    x = randn(dev, 400, C, seed=p)
    R = torch.stack([(x[: 400 - l] * x[l:]).sum(0) / 400
                     for l in range(p + 1)])
    got = launched_once("levinson", lambda: levinson.levinson(R, p))
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


def k6_args(dev, rate, n, history, seed=0):
    """One pfb2 call's arguments from a FIRFilter's kernel: fresh, or
    mid-stream with a random history, entry phase and deficit."""
    from fractions import Fraction
    rate = Fraction(rate)
    h = np.asarray(dsptpu_torch.resample_filter(rate), dtype=np.float32)
    f = dsptpu_torch.FIRFilter(h, rate)
    k = f.kernel
    L, M, hl = rate.numerator, rate.denominator, f.history_len
    hist = None
    if history:
        if hasattr(k, "phi_idx"):
            k.phi_idx = L // 2 + 1
        k.input_deficit = 3
        hist = randn(dev, hl, seed=seed + 1)
    pfb = torch.as_tensor(dsptpu_torch.taps2pfb(h, L), device=dev)
    return (hist, randn(dev, n, seed=seed), pfb, L, M,
            getattr(k, "phi_idx", 1),
            k.input_deficit + (hl if history else 0), k.output_length(n), hl)


@pytest.mark.parametrize("history", [False, True])
@pytest.mark.parametrize("n", [1061, 61951])
@pytest.mark.parametrize("rate", ["147/160", "3/2", "1/4", "5", "441/640"])
def test_pfb2_kernel_matches_plain(dev, rate, n, history):
    """441/640's 441 x 58 bank (102 KB) is read from global memory; the
    others are staged in shared memory."""
    args = k6_args(dev, rate, n, history)
    y, h = launched_once("pfb2", lambda: pfb2.pfb2(*args[:-1],
                                                 hist_len=args[-1]))
    yr, hr = pfb2.pfb2_reference(*args[:-1], hist_len=args[-1])
    check(y, yr, 3e-5)
    assert torch.equal(h, hr)


def test_pfb2_kernel_bank_in_global_memory(dev, monkeypatch):
    """147/160 with its bank forced out of shared memory."""
    args = k6_args(dev, "147/160", 61951, True)
    monkeypatch.setattr(pfb2, "_SMEM_BANK_MAX", 0)
    y = launched_once("pfb2", lambda: pfb2.pfb2(*args[:-1]))
    check(y, pfb2.pfb2_reference(*args[:-1]), 3e-5)


def k7_args(dev, rate, n, mid_stream, seed=0):
    """One arbd call's arguments from FIRArbitrary's host plan, fresh or
    after a first chunk of 30011 samples (random history)."""
    h = np.asarray(dsptpu_torch.resample_filter(rate), dtype=np.float32)
    f = dsptpu_torch.FIRFilter(h, rate)
    k = f.kernel
    if mid_stream:
        _, _, o1 = k.plan(30011)
        k.commit(30011, o1)
    head, alpha, out_len = k.plan(n)
    hl = f.history_len
    hist = randn(dev, hl, seed=seed + 1) if mid_stream else torch.zeros(
        hl, device=dev)

    def t(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a, dt), device=dev)
    return (hist, randn(dev, n, seed=seed),
            t(hl + head[0] - 1, np.int32), t(head[1], np.int32),
            t(alpha, np.float32), t(k.pfb_t.T, np.float32),
            t(k.dpfb_t.T, np.float32), out_len)


@pytest.mark.parametrize("mid_stream", [False, True])
@pytest.mark.parametrize("rate", [0.9997, 0.99999, 0.999])
def test_arbd_kernel_matches_plain(dev, rate, mid_stream):
    args = k7_args(dev, rate, 40037, mid_stream)
    y = launched_once("arbd", lambda: arbd.arbd(*args))
    check(y, arbd.arbd_reference(*args), 3e-5)


def test_resampling_kernels_refuse(dev):
    hist, x, pfb, L, M, phi0, deficit, out_len, hl = k6_args(
        dev, "3/2", 5000, True)
    with pytest.raises(TypeError):
        pfb2.pfb2(hist, x.double(), pfb, L, M, phi0, deficit, out_len)
    with pytest.raises(ValueError):
        pfb2.pfb2(hist, x[:, None].expand(-1, 2), pfb, L, M, phi0,
                  deficit, out_len)
    with pytest.raises(ValueError, match="gate"):    # M + taps - 1 > 896
        pfb2.pfb2(hist, x, pfb, L, 900, phi0, deficit, 10)
    a = k7_args(dev, 0.9997, 40037, False)
    with pytest.raises(TypeError):
        arbd.arbd(a[0].double(), a[1].double(), *a[2:])
    with pytest.raises(ValueError):
        arbd.arbd(a[0], a[1][:, None].expand(-1, 2), *a[2:])
    with pytest.raises(ValueError, match="gate"):    # nphi 64
        wide = a[5].repeat(1, 2).contiguous()
        arbd.arbd(*a[:5], wide, wide, a[7])


def test_streams_route_through_their_kernels(dev):
    """A 1-D float32 FIRFilter at 147/160 launches K6 once a chunk; a
    (n, 4) stream launches nothing (block matmul); rate 1.25 (duplicate
    positions) launches no K7, rate 0.9997 one; resample launches each
    kernel once; resample_entry's forward launches pfb2 twice and arbd
    once. Each agrees with the same call in float64."""
    from fractions import Fraction
    r = Fraction(147, 160)
    h = np.asarray(dsptpu_torch.resample_filter(r), dtype=np.float32)
    x = randn(dev, 70001)
    f = dsptpu_torch.FIRFilter(h, r)
    kernels.reset_launches()
    y = torch.cat([f.filt(c) for c in (x[:30011], x[30011:])])
    assert kernels.launch_counts()["pfb2"] == 2
    check(y, dsptpu_torch.FIRFilter(h, r).filt(x.double()), 3e-5)
    x4 = randn(dev, 20000, 4)
    kernels.reset_launches()
    y4 = dsptpu_torch.FIRFilter(h, r).filt(x4)
    assert set(kernels.launch_counts().values()) == {0}
    check(y4, dsptpu_torch.FIRFilter(h, r).filt(x4.double()), 3e-5)
    for rate, n_arbd in [(1.25, 0), (0.9997, 1)]:
        ha = np.asarray(dsptpu_torch.resample_filter(rate), np.float32)
        kernels.reset_launches()
        ya = dsptpu_torch.FIRFilter(ha, rate).filt(x)
        assert kernels.launch_counts()["arbd"] == n_arbd
        check(ya, dsptpu_torch.FIRFilter(ha, rate).filt(x.double()), 3e-5)
    for rate, name in [(r, "pfb2"), (0.9997, "arbd")]:
        kernels.reset_launches()
        yr = dsptpu_torch.resample(x, rate)
        assert kernels.launch_counts()[name] == 1
        check(yr, dsptpu_torch.resample(x.double(), rate), 3e-5)
    fwd, (xe,) = dsptpu_torch.resample_entry(device="cuda", n=100003,
                                             arb_n=50000)
    kernels.reset_launches()
    ys = fwd(xe)
    counts = kernels.launch_counts()
    assert (counts["pfb2"], counts["arbd"], counts["fir"],
            counts["osconv"]) == (2, 1, 0, 0)
    for y, y64 in zip(ys, fwd(xe.double())):
        check(y, y64, 3e-5)


@pytest.mark.parametrize("accumulate", [True, False])
@pytest.mark.parametrize("N1", [2, 3, 5, 7, 8, 15, 16])
@pytest.mark.parametrize("K", [1, 2, 7])
def test_stft_stack_kernel_matches_plain(dev, K, N1, accumulate):
    """K3 with a (K, nfft) window stack at ragged shapes, each bin held
    to 3e-5 of its largest value. N1 = 3 and 16 take all nfft bins; odd
    N1 run the direct odd-radix first stage."""
    nfft = 128 * N1
    hop = 128 * max(1, N1 // 2)
    C = 9
    n = 7 * hop + nfft + 37
    nframes = (n - nfft) // hop + 1
    x = randn(dev, n, C, seed=N1 + K)
    rng = np.random.default_rng(K)
    win = torch.as_tensor(rng.uniform(0.1, 1.0, (K, nfft)).astype(np.float32),
                          device=dev)
    nbins = nfft if N1 in (3, 16) else nfft // 2 + 1
    scale = torch.linspace(0.5, 2.0, nbins, device=dev)
    got = launched_once("stft", lambda: stft.stft_pow(x, win, nfft, hop,
                                                    nframes, accumulate,
                                                    scale))
    want = stft.stft_pow_reference(x, win, nfft, hop, nframes, accumulate,
                                   scale)
    check_by_bin(got, want, 3e-5)


def check_by_bin(got, want, tol):
    """Each bin (axis 0) within tol of its largest reference value."""
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    nbins = want.shape[0]
    d = (got.double() - want.double()).abs().reshape(nbins, -1).amax(1)
    ref = want.double().abs().reshape(nbins, -1).amax(1)
    assert (d <= tol * ref).all()


@pytest.mark.parametrize("accumulate", [True, False])
@pytest.mark.parametrize("K,nfft,hop,C,nbins", [
    (15, 2048, 1024, 9, 1025), (64, 2048, 1024, 3, 2048),
    (1, 1024, 512, 1, 513), (7, 1024, 512, 64, 513),
    (1, 1024, 1024, 5, 513), (3, 640, 1280, 4, 640),
    (1, 1024, 512, 64, 1), (2, 384, 128, 3, 7)])
def test_stft_kernel_edge_cases(dev, K, nfft, hop, C, nbins, accumulate):
    """Windows past the kernel's shared-memory budget (K = 15 and 64 at
    nfft 2048, read through L1), C = 1 and 64, hop = nfft and 2 nfft,
    nbins = 1 and 7 (chip_smoke.py's STFT_EDGES)."""
    n = 6 * hop + nfft + 37
    nframes = (n - nfft) // hop + 1
    x = randn(dev, n, C, seed=K + C)
    rng = np.random.default_rng(nfft + K)
    win = torch.as_tensor(rng.uniform(0.1, 1.0, (K, nfft)).astype(np.float32),
                          device=dev)
    scale = torch.linspace(0.5, 2.0, nbins, device=dev)
    got = launched_once("stft", lambda: stft.stft_pow(x, win, nfft, hop,
                                                    nframes, accumulate,
                                                    scale))
    check_by_bin(got, stft.stft_pow_reference(x, win, nfft, hop, nframes,
                                              accumulate, scale), 3e-5)


def test_welch_kernel_repeats_bit_for_bit(dev):
    """Two Welch sums of the same CUDA input are equal bit for bit: a
    fixed frame partition and a fixed-order second pass, no atomics."""
    x = randn(dev, 200_000, 64, seed=9)
    win = torch.hann_window(1024, device=dev)
    scale = torch.ones(513, device=dev)
    k = (200_000 - 1024) // 512 + 1
    a = stft.stft_pow(x, win, 1024, 512, k, True, scale)
    b = stft.stft_pow(x, win, 1024, 512, k, True, scale)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(1000, 300), (513, 2048), (3, 70001)])
def test_transpose2d_kernel_matches_plain(dev, shape):
    x = randn(dev, *shape, seed=shape[0])
    got = launched_once("transpose2d",
                        lambda: transpose.transpose2d(x))
    torch.cuda.synchronize()
    assert torch.equal(got, transpose.transpose2d_reference(x))


@pytest.mark.parametrize("M,C,TR,pad_to", [(10_000, 8, 2048, 12_000),
                                           (70_001, 64, 8192, None),
                                           (33, 3, 128, 300)])
def test_transpose_tall_kernel_matches_plain(dev, M, C, TR, pad_to):
    x = randn(dev, M, C, seed=M)
    got = launched_once("transpose_tall",
                        lambda: transpose.transpose_tall(x, TR, pad_to))
    torch.cuda.synchronize()
    assert torch.equal(got, transpose.transpose_tall_reference(x, TR, pad_to))


@pytest.mark.parametrize("C,nb,N1,TB,l2", [(3, 2, 8, 16, 65),
                                           (1, 1, 4, 8, 33),
                                           (64, 2, 8, 32, 65),
                                           (40, 1, 16, 8, 128)])
def test_spectro_permute_kernel_matches_plain(dev, C, nb, N1, TB, l2):
    tile = randn(dev, C, nb, N1, TB, 128, seed=C)
    got = launched_once("spectro_permute",
                        lambda: transpose.spectro_permute(tile, l2))
    torch.cuda.synchronize()
    assert torch.equal(got, transpose.spectro_permute_reference(tile, l2))


def test_multitaper_runs_the_stack_kernel(dev):
    """mt_spectrogram on a CUDA float32 signal launches K3 once with the
    taper stack; multitaper_entry's forward launches it once and agrees
    with the same call in float64."""
    x = randn(dev, 20000, 3, seed=5)
    kernels.reset_launches()
    s = dsptpu_torch.mt_spectrogram(x, 512, 256, nfft=512, ntapers=5)
    assert kernels.launch_counts()["stft"] == 1
    check(s.power, dsptpu_torch.mt_spectrogram(
        x.double(), 512, 256, nfft=512, ntapers=5).power, 3e-5)
    fwd, (xe,) = dsptpu_torch.multitaper_entry(device="cuda", n=40000,
                                               channels=4, coh_n=4096)
    kernels.reset_launches()
    spec, coh = fwd(xe)
    assert kernels.launch_counts()["stft"] == 1
    spec64, coh64 = fwd(xe.double())
    check(spec, spec64, 3e-5)
    check(coh, coh64, 1e-4)


def test_stack_and_transposes_refuse(dev):
    x = randn(dev, 5000, 2)
    with pytest.raises(ValueError):
        stft.stft_pow(x, torch.ones(2, 256, device=dev), 512, 256, 3, False,
                      torch.ones(257, device=dev))
    with pytest.raises(TypeError):
        transpose.transpose2d(x.double())
    with pytest.raises(ValueError):
        transpose.transpose_tall(x[:, 0])
    with pytest.raises(TypeError):
        transpose.spectro_permute(torch.zeros(2, 1, 4, 8, 128,
                                              dtype=torch.float64,
                                              device=dev), 3)
