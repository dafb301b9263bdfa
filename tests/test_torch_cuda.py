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
from dsptpu_torch.filters.filt import _blockss, _cascade_ss, _stack_cascade
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


def fir_cases():
    """K1's cases: every C template (C = 1, 2, a ragged last group at 31,
    33 and 100) at nb from 2 to 1536 (multiples of R = 16 and not), n
    just above 4 nb, n a tile +- 1, and long streams whose blocks walk
    runs of many tiles; also in chip_smoke.py."""
    cases = [(40037, 1, 2), (40037, 3, 127), (33001, 64, 300),
             (5000, 40, 1536), (300_007, 33, 129), (2_000_003, 1, 17),
             (200_003, 100, 1536), (500_001, 2, 512)]
    for C in (1, 2, 31, 32, 33, 64, 100):
        cases += [(4 * nb + 1 + C, C, nb)
                  for nb in (2, 16, 17, 127, 128, 129, 512, 1536)]
        tt = fir._plan(1, C, 127)["tt"]
        cases += [(2 * tt - 1, C, 127), (2 * tt + 1, C, 127)]
    return cases


@pytest.mark.parametrize("n,C,nb", fir_cases())
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


def k6_random_args(dev, taps, L, M, n, history, seed=0):
    """One pfb2 call with a random (taps, L) bank at rate L/M: fresh, or
    mid-stream with a random history of taps + 5 samples, entry phase
    L // 2 + 1 and input deficit 3."""
    rng = np.random.default_rng(seed)
    hl = taps + 5
    pfb = torch.as_tensor(rng.standard_normal((taps, L)).astype(np.float32),
                          device=dev)
    hist = randn(dev, hl, seed=seed + 1) if history else None
    return (hist, randn(dev, n, seed=seed + 2), pfb, L, M,
            L // 2 + 1 if history else 1, 3 + hl if history else 1,
            n * L // M)


@pytest.mark.parametrize("history", [False, True])
@pytest.mark.parametrize("n", [1061, 61951])
@pytest.mark.parametrize("rate", ["147/160", "3/2", "1/4", "5", "441/640",
                                  "1/3", "7/5"])
def test_pfb2_kernel_matches_plain(dev, rate, n, history):
    """441/640's 441 columns run in passes (more than one block's lanes);
    1/4's 147 and 1/3's 111 taps in chunks of at most 64."""
    args = k6_args(dev, rate, n, history)
    y, h = launched_once("pfb2", lambda: pfb2.pfb2(*args[:-1],
                                                 hist_len=args[-1]))
    yr, hr = pfb2.pfb2_reference(*args[:-1], hist_len=args[-1])
    check(y, yr, 3e-5)
    assert torch.equal(h, hr)


@pytest.mark.parametrize("history", [False, True])
@pytest.mark.parametrize("L,M", [(7, 5), (147, 160)])
@pytest.mark.parametrize("taps", [5, 16, 21, 29, 40, 41, 56, 64])
def test_pfb2_kernel_every_template(dev, taps, L, M, history):
    """One case for each compiled tap count (8, 16, ..., 64)."""
    args = k6_random_args(dev, taps, L, M, 40037, history)
    assert pfb2._launch_geometry(taps, L, M, args[5])[0] == -(-taps // 8) * 8
    y = launched_once("pfb2", lambda: pfb2.pfb2(*args))
    check(y, pfb2.pfb2_reference(*args), 3e-5)


@pytest.mark.parametrize("history", [False, True])
@pytest.mark.parametrize("taps,L,M", [(65, 7, 5), (200, 3, 2), (800, 7, 5),
                                      (40, 1201, 800), (9, 300, 7)])
def test_pfb2_kernel_long_bank_and_wide_rows(dev, taps, L, M, history):
    """Banks of more than 64 taps (in chunks), and L larger than the
    lanes of one block (columns in passes)."""
    args = k6_random_args(dev, taps, L, M, 40037, history)
    nt, nch, lanes, warps, k, _ = pfb2._launch_geometry(taps, L, M, args[5])
    assert (nch > 1) == (taps > 64)
    assert (taps <= 64) == (k * L > lanes * warps)
    y = launched_once("pfb2", lambda: pfb2.pfb2(*args))
    check(y, pfb2.pfb2_reference(*args), 3e-5)


@pytest.mark.parametrize("history", [False, True])
@pytest.mark.parametrize("taps,L,M", [(41, 147, 160), (37, 3, 2), (21, 7, 5),
                                      (5, 7, 5), (147, 1, 4), (200, 3, 2),
                                      (9, 300, 7)])
def test_pfb2_kernel_nonfinite_input(dev, taps, L, M, history):
    """An Inf and a NaN in the stream reach only the outputs whose windows
    hold them, as in the plain version: the zero taps that pad a pass
    (and each sample is just past some output's window) leave the
    outputs they meet finite."""
    args = list(k6_random_args(dev, taps, L, M, 40037, history))
    x = args[1].clone()
    x[1000], x[5001] = float("inf"), float("nan")
    args[1] = x
    y = launched_once("pfb2", lambda: pfb2.pfb2(*args))
    want = pfb2.pfb2_reference(*args)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(y), fin) and not fin.all()
    check(y[fin], want[fin], 3e-5)


def k7_args(dev, rate, n, mid_stream, seed=0):
    """One arbd call's arguments, the stream's anchor in place of a plan,
    and the host plan's arrays for the plain version: fresh, after a
    first chunk of 30011 samples, or at J0 >= 10^8 (a stream advanced by
    10^8 + 12345 samples), the last two with a random history. Returns
    (hist, x, anchor, pfb, dpfb, out_len) and (end0, phi, alpha)."""
    h = np.asarray(dsptpu_torch.resample_filter(rate), dtype=np.float32)
    f = dsptpu_torch.FIRFilter(h, rate)
    k = f.kernel
    hl = f.history_len
    if mid_stream == "J0":
        xl = 10 ** 8 + 12345
        k.commit(xl, arbd.arbd_out_len(k.anchor(hl), xl))
    elif mid_stream:
        _, _, o1 = k.plan(30011)
        k.commit(30011, o1)
    head, alpha, out_len = k.plan(n)
    hist = randn(dev, hl, seed=seed + 1) if mid_stream else torch.zeros(
        hl, device=dev)

    def t(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a, dt), device=dev)
    return ((hist, randn(dev, n, seed=seed), k.anchor(hl),
             t(k.pfb_t.T, np.float32), t(k.dpfb_t.T, np.float32), out_len),
            (t(hl + head[0] - 1, np.int64), t(head[1], np.int64),
             t(alpha, np.float32)))


def k7_plain(args, plan):
    hist, x, _, pfb, dpfb, out_len = args
    return arbd.arbd_reference(hist, x, *plan, pfb, dpfb, out_len)


@pytest.mark.parametrize("mid_stream", [False, True, "J0"])
@pytest.mark.parametrize("rate", [0.9997, 0.99999, 0.999])
def test_arbd_kernel_matches_plain(dev, rate, mid_stream):
    """K7 from the anchor against the plain version on the host plan;
    no run computed one output at a time (the gate accepts); a second
    call equal bit for bit."""
    args, plan = k7_args(dev, rate, 40037, mid_stream)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    y = launched_once("arbd", lambda: arbd.arbd(*args, counts=counts))
    check(y, k7_plain(args, plan), 3e-5)
    assert counts[0].item() == 0
    assert torch.equal(y, arbd.arbd(*args))


@pytest.mark.parametrize("mid_stream", [False, "J0"])
def test_arbd_kernel_full_shape(dev, mid_stream):
    """K7 at path C's shapes (2,500,000 samples at 0.9997), fresh and at
    J0 >= 10^8: the plain version's result, no run computed one output
    at a time, repeats bit for bit."""
    args, plan = k7_args(dev, 0.9997, 2_500_000, mid_stream)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    y = launched_once("arbd", lambda: arbd.arbd(*args, counts=counts))
    check(y, k7_plain(args, plan), 3e-5)
    assert counts[0].item() == 0
    assert torch.equal(y, arbd.arbd(*args))


@pytest.mark.parametrize("rate", [0.9, 0.5, 1.0003])
def test_arbd_kernel_off_the_gate(dev, rate):
    """Anchors the gate rejects still give the plain version's result:
    at 0.9 (a phase every 3 outputs) and 1.0003 (duplicates) runs are
    computed one output at a time, at 0.5 a tile's windows exceed its
    buffer and are read from global memory."""
    args, plan = k7_args(dev, rate, 40037, True)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    y = launched_once("arbd", lambda: arbd.arbd(*args, counts=counts))
    check(y, k7_plain(args, plan), 3e-5)
    assert counts[0].item() > 0


@pytest.mark.parametrize("mid_stream", [False, True, "J0"])
@pytest.mark.parametrize("rate", [0.9997, 0.999])
def test_arbd_plan_on_card_is_the_host_plan(dev, rate, mid_stream):
    """The plan-only launch (the kernel's own closed form) equals
    FIRArbitrary.plan bit for bit, and counts no K7 launch."""
    args, (end0, phi, alpha) = k7_args(dev, rate, 40037, mid_stream)
    before = kernels.launch_counts()["arbd"]
    e, p, a = arbd.arbd_plan(args[2], args[5], dev)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["arbd"] == before
    assert torch.equal(e, end0) and torch.equal(p.long(), phi)
    assert torch.equal(a.view(torch.int32), alpha.view(torch.int32))


def test_arbd_route_builds_no_host_plan(dev, monkeypatch):
    """A CUDA float32 stream at 0.9997 runs K7 with FIRArbitrary.plan
    made to raise: the route builds no host plan, one shot or in chunks,
    and its result equals the kernel route's with the plan intact."""
    from dsptpu_torch.filters import stream_filt
    h = np.asarray(dsptpu_torch.resample_filter(0.9997), np.float32)
    x = randn(dev, 110000, seed=3)
    want = dsptpu_torch.FIRFilter(h, 0.9997).filt(x)

    def no_plan(self, xlen):
        raise AssertionError("host plan built on the kernel route")
    monkeypatch.setattr(stream_filt.FIRArbitrary, "plan", no_plan)
    kernels.reset_launches()
    assert torch.equal(dsptpu_torch.FIRFilter(h, 0.9997).filt(x), want)
    f = dsptpu_torch.FIRFilter(h, 0.9997)
    got = torch.cat([f.filt(c) for c in (x[:36001], x[36001:72007],
                                         x[72007:])])
    assert kernels.launch_counts()["arbd"] == 4
    assert torch.equal(got, want)


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
    a, _ = k7_args(dev, 0.9997, 40037, False)
    with pytest.raises(TypeError):
        arbd.arbd(a[0].double(), a[1].double(), *a[2:])
    with pytest.raises(ValueError):
        arbd.arbd(a[0], a[1][:, None].expand(-1, 2), *a[2:])
    with pytest.raises(ValueError, match="gate"):    # nphi 64
        wide = a[3].repeat(1, 2).contiguous()
        arbd.arbd(*a[:2], a[2]._replace(nphi=64), wide, wide, a[5])
    with pytest.raises(ValueError, match="history"):
        arbd.arbd(a[0][1:], *a[1:])
    with pytest.raises(TypeError):
        arbd.arbd(*a, counts=torch.zeros(2, device=dev))


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


# one nfft per M template of csrc/osconv.cu (M = 256 ... 16384) and two
# with an odd factor (384 = 3 x 128, the M = 128 template; 1920 = 15 x 128)
@pytest.mark.parametrize("C", [1, 15, 16])
@pytest.mark.parametrize("nfft,nv", [(256, 100), (512, 300), (1024, 897),
                                     (2048, 1025), (4096, 3585),
                                     (8192, 4096), (16384, 4096),
                                     (384, 200), (1920, 500)])
def test_osconv_templates_match_plain(dev, nfft, nv, C):
    n = 5 * nfft + 77
    x, v = randn(dev, n, C, seed=nfft + C), randn(dev, nv, seed=nv)
    got = launched_once("osconv", lambda: osconv.osconv(x, v, nfft))
    check(got, osconv.osconv_reference(x, v, nfft, n + nv - 1), 3e-5)


@pytest.mark.parametrize("mode", ["forward", "need_state", "reverse",
                                  "n_eff"])
@pytest.mark.parametrize("order", [2, 8, 32])
def test_biir_sos_stage_matches_plain(dev, order, mode):
    """K2 with the SOS output stage (a system that carries its sections:
    1, 4 and 16 of them, gain 1.3 g) against the block form's plain
    version, in each direction."""
    sos = dsptpu_torch.as_sos(dsptpu_torch.digitalfilter(
        dsptpu_torch.Lowpass(0.3), dsptpu_torch.Butterworth(order)))
    ss = _cascade_ss(sos.sos_array(), 1.3 * sos.g)
    n, C = 70001, 5
    x, z0 = randn(dev, n, C, seed=order), randn(dev, ss.p, C, seed=n)
    kw = dict(need_state=mode == "need_state",
              reverse=mode in ("reverse", "n_eff"),
              n_eff=(n // 128) * 128 if mode == "n_eff" else None)
    got = launched_once("biir", lambda: biir.blockss_filt(ss, x, z0, **kw))
    want = biir.blockss_reference(ss, x, z0, **kw)
    pairs = zip(got, want) if kw["need_state"] else [(got, want)]
    for g, w in pairs:
        check(g, w, 1e-4)


@pytest.mark.parametrize("reverse", [False, True])
def test_biir_general_stage_matches_plain(dev, reverse):
    """A general (b, a) system (one 5-state section) keeps the F output
    stage, and so does a stacked cascade built without its sections."""
    from dsptpu_torch.filters.filt import _single_ss
    sos = dsptpu_torch.as_sos(dsptpu_torch.digitalfilter(
        dsptpu_torch.Lowpass(0.25), dsptpu_torch.Butterworth(6)))
    for ss in (_blockss(*_single_ss([0.2, 0.1, 0.05, 0.02, 0.01, 0.005],
                                    [1.0, -0.5, 0.25, -0.1, 0.05, -0.02])),
               _blockss(*_stack_cascade(sos.sos_array(), sos.g))):
        assert ss.sections is None
        x, z0 = randn(dev, 20011, 7, seed=3), randn(dev, ss.p, 7, seed=4)
        got = launched_once("biir", lambda: biir.blockss_filt(
            ss, x, z0, reverse=reverse))
        check(got, biir.blockss_reference(ss, x, z0, reverse=reverse), 1e-4)


@pytest.mark.parametrize("call", ["resample_441_640", "filt_127"])
def test_matmul_routes_keep_full_f32_under_tf32(dev, call):
    """With the caller's float32 matmul precision at "high" (TF32), the
    port's matrix-product routes still compute in full float32: the
    block matmul of resample at 441/640 and of filt with 127 taps at
    n = 20000, each within 3e-5 of float64; the caller's setting is
    back after the call."""
    from fractions import Fraction
    x = randn(dev, 20000, seed=5)
    if call == "resample_441_640":
        def run(s):
            return dsptpu_torch.resample(s, Fraction(441, 640))
    else:
        b = randn(dev, 127, seed=6) / 16

        def run(s):
            return dsptpu_torch.filt(b.to(s.dtype), s)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        assert torch.backends.cuda.matmul.allow_tf32
        got = run(x)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision(prev)
    check(got, run(x.double()), 3e-5)


def _k2_system(order, route):
    sos = dsptpu_torch.as_sos(dsptpu_torch.digitalfilter(
        dsptpu_torch.Lowpass(0.3), dsptpu_torch.Butterworth(order)))
    arr, g = sos.sos_array(), 1.3 * sos.g
    return (_cascade_ss(arr, g) if route == "sections"
            else _blockss(*_stack_cascade(arr, g)))


def _k2_kw(mode, n):
    return dict(need_state=mode == "need_state",
                reverse=mode in ("reverse", "n_eff"),
                n_eff=(n // 128) * 128 if mode == "n_eff" else None)


@pytest.mark.parametrize("route", ["sections", "F"])
@pytest.mark.parametrize("mode", ["forward", "need_state", "reverse",
                                  "n_eff"])
@pytest.mark.parametrize("order,n,C", [(8, 8191, 33), (20, 8192, 3),
                                       (32, 8193, 1), (2, 3001, 64),
                                       (8, 12289, 64)])
def test_biir_chunk_boundaries_match_plain(dev, order, n, C, mode, route):
    """K2 at n = 64·128·k - 1, k, + 1 (the chunk of 64 rows) and below
    one chunk, C 1, 3, 33, 64, p 2, 8, 20, 32, both output routes, in
    each mode (need_state's row ends a chunk at 8192 and 8193, lies
    inside one at 8191, 3001 and 12289)."""
    ss = _k2_system(order, route)
    x, z0 = randn(dev, n, C, seed=n + C), randn(dev, ss.p, C, seed=order)
    kw = _k2_kw(mode, n)
    got = launched_once("biir", lambda: biir.blockss_filt(ss, x, z0, **kw))
    want = biir.blockss_reference(ss, x, z0, **kw)
    pairs = zip(got, want) if kw["need_state"] else [(got, want)]
    for g, w in pairs:
        check(g, w, 1e-4)


@pytest.mark.parametrize("mode", ["forward", "need_state", "n_eff"])
def test_biir_kernel_main_path_shape(dev, mode):
    """K2 at the main path's full shape (1,000,000 x 64, the 8th-order
    Butterworth cascade with its sections) against the plain version."""
    from dsptpu_torch.pipeline import chain_params
    ss = _cascade_ss(chain_params()[1].astype(np.float64), 1.0)
    n, C = 1_000_000, 64
    x, z0 = randn(dev, n, C, seed=5), randn(dev, ss.p, C, seed=6)
    kw = _k2_kw(mode, n)
    got = launched_once("biir", lambda: biir.blockss_filt(ss, x, z0, **kw))
    want = biir.blockss_reference(ss, x, z0, **kw)
    pairs = zip(got, want) if kw["need_state"] else [(got, want)]
    for g, w in pairs:
        check(g, w, 1e-4)


@pytest.mark.parametrize("route", ["sections", "F"])
@pytest.mark.parametrize("mode", ["forward", "need_state", "n_eff"])
def test_biir_kernel_repeats_bit_for_bit(dev, mode, route):
    """Two K2 calls on the same input give identical tensors: every fold
    (chunk ends, the carry's groups, the rows) runs in a fixed order."""
    ss = _k2_system(8, route)
    n, C = 300_001, 64
    x, z0 = randn(dev, n, C, seed=7), randn(dev, ss.p, C, seed=8)
    kw = _k2_kw(mode, n)
    a = biir.blockss_filt(ss, x, z0, **kw)
    b = biir.blockss_filt(ss, x, z0, **kw)
    torch.cuda.synchronize()
    for u, v in (zip(a, b) if kw["need_state"] else [(a, b)]):
        assert torch.equal(u, v)
