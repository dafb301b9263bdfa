"""Port parity for multitaper: dsptpu_torch's mt_pgram / mt_spectrogram /
mt_cross_power_spectra / mt_coherence / allocate_output and the DPSS
tapers against dsptpu's, and the plain version of K3's K-window stack
(kernels/stft.stft_pow_reference, what the wrapper runs on a CPU tensor)
against dsptpu's Pallas STFT kernel with a (K, nfft) window in interpret
mode, decoded from its tile layout with bins_from_tile /
onesided_bins_from_tile.

Inputs come from a numpy seed and go to both packages as explicit
float32 or float64 arrays. Tolerances: max|d| <= 1e-10 max|ref| in
float64, <= 3e-5 max|ref| in float32 (bench.py's Welch / spectrogram
bound). Under the tests' x64, dsptpu's _mt_power promotes float32 input
to float64 where its float64 tapers meet the signal; the port keeps
float32, and the float32 tolerance absorbs the difference. dsptpu's
mt_pgram takes only a 1-D signal; the port's takes trailing channel dims
like its other 1-D entry points, and each channel is held to dsptpu's
1-D call. Host copies (dpss, dpsseig, dpss_config) match exactly.

Path D as the benchmark's `array64_multitaper` deployment runs it
(`pipeline.multitaper_entry`, at a small size): its spans
(`entry` -> `mt_spectrogram` -> `kernel.stft`, `entry` ->
`mt_coherence` -> `kernel.mtcoh`), its route counters
(`route.mt_spec.k3` where K3's gate holds, K3's plain version standing
in on the CPU; `route.mt_spec.torch` for float64; `route.mt_coh.k9` or
`route.mt_coh.cs` as K9's gate holds or not), the taper cache's
`table.mt_const.hit`/`.miss` counters, outputs that tracing leaves bit
for bit as they are, and both outputs against the benchmark's plain
float64 reference (benchmark/reference/array64_multitaper.py) within
3e-5 of max|ref|, which the reference computed in TF32 misses.

K9 (kernels/mtcoh.py, the coherence from the tapered spectra): its walk
(csrc/mtcoh.cu's tiles, fold, normalisation and split of the pairs over
the warps) emulated in float64 numpy against mt_cross_power_spectra and
coherence_from_cs, every output element written once; its plain version
bit for bit the cross-spectra route on the CPU; its gate."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import dsptpu
from dsptpu.kernels.stft import (bins_from_tile, onesided_bins_from_tile,
                                 stft_pow_pallas)
from dsptpu.ops import multitaper as jmt
from dsptpu.ops import windows as jwin

import dsptpu_torch
from benchmark.reference import array64_multitaper as mt_reference
from dsptpu_torch import kernels, pipeline
from dsptpu_torch.utils import profiling
from dsptpu_torch.convert import mtconfig_from_numpy
from dsptpu_torch.kernels import mtcoh as tmtcoh
from dsptpu_torch.kernels import stft as tstft
from dsptpu_torch.ops.multitaper import _tapered_fft

TOL = {np.float64: 1e-10, np.float32: 3e-5}


def check(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.max(np.abs(got - want))
    assert err <= tol * np.max(np.abs(want)), err


def port_config(cfg):
    """dsptpu MTConfig -> the port's, through its plain fields."""
    return mtconfig_from_numpy(cfg.n_samples, cfg.fs, cfg.nfft, cfg.ntapers,
                               cfg.onesided, cfg.window_array, cfg.r)


def signal(shape, dtype, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("K", [1, 3, 7])
@pytest.mark.parametrize("chans", [(), (3,), (2, 2)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_mt_pgram_matches_dsptpu(dtype, chans, K):
    x = signal((1000,) + chans, dtype, K)
    got = dsptpu_torch.mt_pgram(torch.as_tensor(x), fs=2.0, nfft=1024,
                                ntapers=K)
    assert got.power.shape == (513,) + chans
    cols = x.reshape(1000, -1)
    gcols = got.power.reshape(513, -1)
    for c in range(cols.shape[1]):
        want = dsptpu.mt_pgram(jnp.asarray(cols[:, c]), fs=2.0, nfft=1024,
                               ntapers=K)
        check(gcols[:, c], want.power, TOL[dtype])
        assert np.array_equal(got.freq, want.freq)


# (length, chans, n, n_overlap, nfft, dtype, K): float32 cases with nfft
# and hop multiples of 128 and n <= nfft take K3's stack (plain on the
# CPU); dsptpu on the CPU takes its torch.fft-like XLA route
SPEC_CASES = [
    (20000, (3,), 512, 256, 512, np.float32, 7),
    (20000, (), 1024, 512, 1024, np.float32, 3),
    (20000, (2, 2), 512, 384, 512, np.float32, 1),
    (12000, (3,), 1000, 500, None, np.float32, 7),   # nfft 1000: torch.fft
    (12000, (2,), 512, 256, 512, np.float64, 3),     # float64: torch.fft
]


@pytest.mark.parametrize("length,chans,n,nov,nfft,dtype,K", SPEC_CASES)
def test_mt_spectrogram_matches_dsptpu(length, chans, n, nov, nfft, dtype,
                                       K):
    x = signal((length,) + chans, dtype, n + K)
    want = dsptpu.mt_spectrogram(jnp.asarray(x), n, nov, fs=100.0,
                                 nfft=nfft, ntapers=K)
    kernels.reset_launches()
    got = dsptpu_torch.mt_spectrogram(torch.as_tensor(x), n, nov, fs=100.0,
                                      nfft=nfft, ntapers=K)
    assert got.power.dtype == torch.from_numpy(x).dtype
    check(got.power, want.power, TOL[dtype])
    assert np.array_equal(got.freq, want.freq)
    assert np.array_equal(got.time, want.time)
    assert set(kernels.launch_counts().values()) == {0}


def test_mt_spectrogram_config_forms():
    """An MTSpectrogramConfig, and an MTConfig with n_overlap, give what
    the keyword form gives; a wrong length is refused as in dsptpu."""
    x = torch.as_tensor(signal((9000, 2), np.float32, 5))
    mt = dsptpu_torch.MTConfig.create(512, fs=10.0, nfft=512, ntapers=4)
    scfg = dsptpu_torch.MTSpectrogramConfig.create(9000, mt_config=mt,
                                                   n_overlap_samples=128)
    a = dsptpu_torch.mt_spectrogram(x, config=scfg)
    b = dsptpu_torch.mt_spectrogram(x, config=mt, n_overlap=128)
    c = dsptpu_torch.mt_spectrogram(x, 512, 128, fs=10.0, nfft=512,
                                    ntapers=4)
    assert torch.equal(a.power, b.power) and torch.equal(a.power, c.power)
    jcfg = jmt.MTSpectrogramConfig.create(9000, 512, 128, fs=10.0, nfft=512,
                                          ntapers=4)
    assert np.array_equal(scfg.time, jcfg.time)
    assert np.array_equal(a.time, jcfg.time)
    with pytest.raises(ValueError, match="n_samples"):
        dsptpu_torch.mt_spectrogram(x[:8000], config=scfg)


@pytest.mark.parametrize("keep,weight", [(True, False), (False, True),
                                         (True, True)])
def test_dpss_config_through_convert(keep, weight):
    """dsptpu's dpss_config with eigenvalue filtering / weighting runs
    unchanged through the port once converted; the port's own
    dpss_config gives the same host arrays bit for bit."""
    jcfg = jmt.dpss_config(512, nw=4, fs=1000.0, nfft=512,
                           keep_only_large_evals=keep,
                           weight_by_evals=weight)
    cfg = port_config(jcfg)
    own = dsptpu_torch.dpss_config(512, nw=4, fs=1000.0, nfft=512,
                                   keep_only_large_evals=keep,
                                   weight_by_evals=weight)
    assert np.array_equal(own.window, jcfg.window_array)
    assert np.array_equal(own.r, np.asarray(jcfg.r))
    assert own.ntapers == jcfg.ntapers == cfg.ntapers
    x = signal((16000, 3), np.float32, 7)
    want = jmt.mt_spectrogram(jnp.asarray(x), config=jcfg, n_overlap=256)
    got = dsptpu_torch.mt_spectrogram(torch.as_tensor(x), config=cfg,
                                      n_overlap=256)
    check(got.power, want.power, 3e-5)
    x1 = signal(512, np.float64, 8)
    want = jmt.mt_pgram(jnp.asarray(x1), config=jcfg)
    got = dsptpu_torch.mt_pgram(torch.as_tensor(x1), config=cfg)
    check(got.power, want.power, 1e-10)


@pytest.mark.parametrize("freq_range", [None, (0.05, 0.3)])
@pytest.mark.parametrize("demean", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cross_spectra_and_coherence_match_dsptpu(dtype, demean,
                                                  freq_range):
    x = signal((5, 2000), dtype, 9) + 0.5
    kw = dict(fs=1.0, demean=demean, freq_range=freq_range, nw=3)
    want = dsptpu.mt_cross_power_spectra(jnp.asarray(x), **kw)
    got = dsptpu_torch.mt_cross_power_spectra(torch.as_tensor(x), **kw)
    assert got.power.dtype == (torch.complex64 if dtype == np.float32
                               else torch.complex128)
    check(got.power, want.power, TOL[dtype])
    assert np.array_equal(got.freq, want.freq)
    want = dsptpu.mt_coherence(jnp.asarray(x), **kw)
    got = dsptpu_torch.mt_coherence(torch.as_tensor(x), **kw)
    check(got.coherence, want.coherence, TOL[dtype])
    assert np.array_equal(got.freq, want.freq)
    cfg = dsptpu_torch.MTCoherenceConfig.create(5, 2000, fs=1.0,
                                                demean=demean,
                                                freq_range=freq_range, nw=3)
    again = dsptpu_torch.mt_coherence(torch.as_tensor(x), config=cfg)
    assert torch.equal(again.coherence, got.coherence)
    assert np.array_equal(cfg.freq, want.freq)


def test_allocate_output_shapes_match_dsptpu():
    mt = (jmt.MTConfig.create(300, nfft=512),
          dsptpu_torch.MTConfig.create(300, nfft=512))
    pairs = [
        mt,
        (jmt.MTSpectrogramConfig.create(4000, 300, 100, nfft=512),
         dsptpu_torch.MTSpectrogramConfig.create(4000, 300, 100, nfft=512)),
        (jmt.MTCrossSpectraConfig.create(4, 300, freq_range=(0.1, 0.2)),
         dsptpu_torch.MTCrossSpectraConfig.create(4, 300,
                                                  freq_range=(0.1, 0.2))),
        (jmt.MTCoherenceConfig.create(3, 300),
         dsptpu_torch.MTCoherenceConfig.create(3, 300)),
        (dsptpu.WelchConfig.create(4000, 256, onesided=False),
         dsptpu_torch.WelchConfig.create(4000, 256, onesided=False)),
    ]
    for jcfg, cfg in pairs:
        want = jmt.allocate_output(jcfg)
        got = dsptpu_torch.allocate_output(cfg, device="cpu")
        assert tuple(got.shape) == want.shape
        assert got.device.type == "cpu" and not got.any()
        assert got.is_complex() == jnp.iscomplexobj(want)
    with pytest.raises(TypeError):
        dsptpu_torch.allocate_output(object(), device="cpu")


@pytest.mark.parametrize("nfft,K", [(384, 3), (1024, 2)])
def test_k3_stack_plain_matches_pallas_interpret(nfft, K):
    """(K, nfft) windows in both modes; nframes = 13 leaves a ragged
    last block of TB = 8."""
    rng = np.random.default_rng(nfft + K)
    hop = 128 * max(1, nfft // 256)
    nframes = 13
    n = (nframes - 1) * hop + nfft + 37
    x = rng.standard_normal((n, 3)).astype(np.float32)
    wins = rng.uniform(0.1, 1.0, (K, nfft))
    nb1 = nfft // 2 + 1
    acc = stft_pow_pallas(jnp.asarray(x), wins, nfft, hop, nframes,
                          accumulate=True, onesided=True, TB=8,
                          interpret=True)
    want = np.asarray(onesided_bins_from_tile(acc, nfft, nb1))   # (C, nb1)
    got = tstft.stft_pow(torch.as_tensor(x), wins, nfft, hop, nframes, True,
                         np.ones(nb1))                             # (nb1, C)
    check(got.T, want, 3e-5)
    tile = stft_pow_pallas(jnp.asarray(x), wins, nfft, hop, nframes,
                           accumulate=False, TB=8, interpret=True)
    want = np.asarray(bins_from_tile(tile, nfft, nfft))        # (C, k, nfft)
    got = tstft.stft_pow(torch.as_tensor(x), wins, nfft, hop, nframes,
                         False, np.ones(nfft))                 # (nfft, k, C)
    check(got.permute(2, 1, 0), want, 3e-5)
    assert tstft.launches["stft"] == 0


def test_mt_spectrogram_matches_pallas_mt_spec():
    """The port's stack route (plain K3 on the CPU) against dsptpu's
    fused multitaper spectrogram called directly, in interpret mode on
    the CPU."""
    x = signal((30000, 3), np.float32, 10)
    jcfg = jmt.dpss_config(1024, nw=4, fs=1000.0, nfft=1024,
                           weight_by_evals=True)
    want = jmt._pallas_mt_spec(jnp.asarray(x), 1024, 512, jcfg)
    got = dsptpu_torch.mt_spectrogram(torch.as_tensor(x),
                                      config=port_config(jcfg),
                                      n_overlap=512)
    check(got.power, want, 3e-5)


@pytest.mark.parametrize("n,nw,K", [(64, 2, 3), (511, 2.5, 4), (512, 3, 5),
                                    (1024, 4, 7), (1000, 4, None)])
def test_dpss_and_dpsseig_match_dsptpu(n, nw, K):
    want = np.asarray(jwin.dpss(n, nw, K))
    got = dsptpu_torch.windows.dpss(n, nw, K)
    assert np.array_equal(got, want)
    assert np.array_equal(dsptpu_torch.windows.dpsseig(got, nw),
                          np.asarray(jwin.dpsseig(want, nw)))


@pytest.mark.parametrize("kw", [dict(padding=10), dict(zerophase=True)])
def test_dpss_options_match_dsptpu(kw):
    want = np.asarray(jwin.dpss(256, 3, 4, **kw))
    assert np.array_equal(dsptpu_torch.windows.dpss(256, 3, 4, **kw), want)


# path D at a small size: 31 frames of 4 channels, coherence over 2048
D_N, D_C, D_COH = 16384, 4, 2048
D_CFG = {"nfft": 1024, "overlap": 512, "nw": 4, "ntapers": 7,
         "coh_n": D_COH, "fs": 1, "demean": False}


@pytest.fixture
def clean_ring():
    """Tracing off, the ring and counters empty, before and after."""
    profiling.tracing(False)
    kernels.reset_launches()
    yield
    profiling.tracing(False)
    kernels.reset_launches()


def test_multitaper_entry_spans_and_counters(clean_ring):
    fwd, (x,) = pipeline.multitaper_entry(device="cpu", n=D_N,
                                          channels=D_C, coh_n=D_COH)
    profiling.tracing(True)
    traced = fwd(x)
    recs = profiling.spans()
    assert [r[3] for r in recs] == [
        "entry", "mt_spectrogram", "sync.mt_const.stack",
        "sync.mt_const.stack_scale", "kernel.stft", "mt_coherence",
        "sync.mt_const.tapers", "sync.mt_const.corr", "sync.mt_const.w2",
        "kernel.mtcoh"]
    # parents: the spectrogram and the coherence under the entry, the
    # stack and its constants' first uploads under the spectrogram, K9's
    # wrapper and its constants' under the coherence
    idx = [r[0] for r in recs]
    assert [r[2] for r in recs] == [-1, idx[0]] + [idx[1]] * 3 + [
        idx[0]] + [idx[5]] * 4
    assert len({r[1] for r in recs}) == 1
    # float32 at nfft 1024, hop 512 passes K3's gate: the stack route
    # (its plain version on the CPU); complex64 spectra of 4 channels and
    # 7 tapers pass K9's: no cross-spectral matrix (K9's plain version on
    # the CPU); 5 constants looked up, each new
    c = profiling.counters()
    assert c["route.mt_spec.k3"] == 1 and "route.mt_spec.torch" not in c
    assert c["route.mt_coh.k9"] == 1 and "route.mt_coh.cs" not in c
    assert (c.get("table.mt_const.miss"), c.get("table.mt_const.hit")) == (
        5, None)
    # each miss uploads its constant once (utils.device)
    assert {k for k in c if k.startswith("sync.")} == {
        f"sync.mt_const.{k}" for k in ("stack", "stack_scale", "tapers",
                                       "corr", "w2")}
    assert all(c[k] == 1 for k in c if k.startswith("sync."))
    # a second call finds every constant
    kernels.reset_launches()
    fwd(x)
    c = profiling.counters()
    assert {k: v for k, v in c.items() if k.startswith("route.mt_")
            or k.startswith("table.mt_const.")} == {
        "route.mt_spec.k3": 1, "route.mt_coh.k9": 1,
        "table.mt_const.hit": 5}
    assert not [k for k in c if k.endswith(".miss")]
    assert not [k for k in c if k.startswith(("sync.", "upload."))]
    # tracing off: the same outputs, bit for bit, and no span recorded
    profiling.tracing(False)
    kernels.reset_launches()
    plain = fwd(x)
    assert profiling.spans() == []
    for a, b in zip(traced, plain):
        assert torch.equal(a, b)


def test_mt_spectrogram_counts_the_torch_route(clean_ring):
    """float64 fails K3's gate: batched torch.fft frames."""
    x = torch.as_tensor(signal((8192, 2), np.float64, 11))
    dsptpu_torch.mt_spectrogram(x, n=1024, n_overlap=512, nw=4)
    c = profiling.counters()
    assert c["route.mt_spec.torch"] == 1 and "route.mt_spec.k3" not in c


def test_multitaper_entry_matches_the_benchmark_reference():
    fwd, _ = pipeline.multitaper_entry(device="cpu", n=D_N, channels=D_C,
                                       coh_n=D_COH)
    gen = torch.Generator().manual_seed(2 ** 31 + 25)
    x = torch.randn((D_N, D_C), generator=gen)
    power, coh = fwd(x)
    ref = mt_reference.reference(D_CFG, x, "float64")
    tf32 = mt_reference.reference(D_CFG, x, "tf32")
    for got, name in ((power, "power"), (coh, "coherence")):
        want = ref[name].numpy()
        check(got, want, 3e-5)
        # the control: the reference computed in TF32 misses the bound
        err = np.max(np.abs(tf32[name].numpy() - want))
        assert err > 3e-5 * np.max(np.abs(want)), (name, err)


def emulate_k9(F, w, corr, R, warps=16, tb=32):
    """csrc/mtcoh.cu's walk in float64 numpy: for each tile of tb bins,
    g = sqrt(w_k) corr_f F_lk on its live bins (0 past nbins), h = g /
    sqrt(d_l), the diagonal's 1s; then each warp's share of the (group,
    m) iterations over groups of R channels, each pair l < m written to
    (l, m) and (m, l). Returns the output and the count of writes of
    each element."""
    C, K, nb = F.shape
    out = np.full((C, C, nb), np.nan)
    writes = np.zeros((C, C, nb), dtype=int)
    total = sum(C - lo - 1 for lo in range(0, C, R))
    for f0 in range(0, nb, tb):
        f = np.arange(f0, f0 + tb)
        live = f < nb
        fl, fw = np.minimum(f, nb - 1), f[live]
        g = np.where(live, F[:, :, fl], 0) * (
            np.sqrt(w)[:, None] * np.where(live, corr[fl], 0))
        with np.errstate(divide="ignore", invalid="ignore"):
            h = g / np.sqrt((np.abs(g) ** 2).sum(1))[:, None, :]
        for l in range(C):
            out[l, l, fw] = 1.0
            writes[l, l, fw] += 1
        for warp in range(warps):
            it, end = total * warp // warps, total * (warp + 1) // warps
            if it >= end:
                continue
            lo, m = 0, it
            while m >= C - lo - 1:
                m -= C - lo - 1
                lo += R
            m += lo + 1
            for _ in range(it, end):
                while m >= C:
                    lo += R
                    m = lo + 1
                for l in range(lo, min(lo + R, m)):
                    c = np.abs((h[l] * h[m].conj()).sum(0))[live]
                    for a, b in ((l, m), (m, l)):
                        out[a, b, fw] = c
                        writes[a, b, fw] += 1
                m += 1
    return out, writes


def k9_inputs(x, cfg):
    """K9's inputs for mt_coherence(x, config=cfg) as its route makes
    them: the tapered spectra on the selected bins, w2 and corr there."""
    cs = cfg.cs_config
    mtc = cs.mt_config
    dt = x.real.dtype
    if cs.demean:
        x = x - x.mean(dim=1, keepdim=True)
    F = _tapered_fft(x, mtc)
    w, corr = mtc.const("w2", "cpu", dt), mtc.const("corr", "cpu", dt)
    if cs.freq_range is not None:
        sel = (torch.as_tensor(mtc.freq) > cs.freq_range[0]) & (
            torch.as_tensor(mtc.freq) < cs.freq_range[1])
        F, corr = F[:, :, sel], corr[sel]
    return F, w, corr


# (channels, samples, config kwargs): C 1, 4 and 64; bin counts that leave
# a ragged last tile of 32 (101, 76, 33, 129, 65 and 500 bins); K 10 (the
# KMAX 16, R 2 instance); eigenvalue weights; a frequency range
K9_WALKS = [(1, 200, dict(nw=4)), (4, 150, dict(nw=4)),
            (64, 64, dict(nw=4)), (5, 256, dict(nw=6, ntapers=10)),
            (7, 130, dict(weight_by_evals=True)),
            (6, 2000, dict(nw=3, freq_range=(0.05, 0.3)))]


def k9_config(C, n, kw):
    kw = dict(kw)
    if kw.pop("weight_by_evals", False):
        return dsptpu_torch.MTCoherenceConfig.create(
            C, mt_config=dsptpu_torch.dpss_config(n, nw=4,
                                                  weight_by_evals=True))
    return dsptpu_torch.MTCoherenceConfig.create(C, n, **kw)


@pytest.mark.parametrize("C,n,kw", K9_WALKS)
def test_k9_walk_matches_the_cross_spectra(C, n, kw):
    cfg = k9_config(C, n, kw)
    x = torch.as_tensor(signal((C, n), np.float64, C * n))
    F, w, corr = k9_inputs(x, cfg)
    K, nb = F.shape[1:]
    if kw.get("weight_by_evals"):
        assert np.ptp(w.numpy()) > 0
    assert nb % 32 and tmtcoh.mtcoh_supported(C, K, nb, torch.complex64)
    got, writes = emulate_k9(F.numpy(), w.numpy(), corr.numpy(),
                             R=4 if K <= 8 else 2)
    assert (writes == 1).all()
    want = dsptpu_torch.coherence_from_cs(
        dsptpu_torch.mt_cross_power_spectra(x, config=cfg.cs_config).power)
    check(got, want.numpy(), 1e-12)


@pytest.mark.parametrize("demean", [False, True])
@pytest.mark.parametrize("C,n,kw", K9_WALKS[:2] + K9_WALKS[4:])
def test_k9_plain_is_the_cross_spectra_route(clean_ring, C, n, kw, demean):
    """On a float32 CPU signal mt_coherence takes K9's route, whose plain
    version gives, bit for bit, the cross spectra and coherence_from_cs
    (mt_coherence before K9)."""
    cfg = k9_config(C, n, kw)
    cfg = dsptpu_torch.MTCoherenceConfig(dataclasses.replace(
        cfg.cs_config, demean=demean))
    x = torch.as_tensor(signal((C, n), np.float32, C + n) + 0.25)
    got = dsptpu_torch.mt_coherence(x, config=cfg)
    c = profiling.counters()
    assert c["route.mt_coh.k9"] == 1 and "route.mt_coh.cs" not in c
    want = dsptpu_torch.coherence_from_cs(
        dsptpu_torch.mt_cross_power_spectra(x, config=cfg.cs_config).power)
    assert got.coherence.dtype == torch.float32
    assert torch.equal(got.coherence, want)
    assert np.array_equal(got.freq, cfg.freq)
    assert torch.equal(tmtcoh.mtcoh(*k9_inputs(x, cfg)), want)
    assert tmtcoh.launches["mtcoh"] == 0


def test_k9_gate_refuses_what_the_kernel_does_not_take(clean_ring):
    ok = tmtcoh.mtcoh_supported
    assert ok(64, 7, 8193, torch.complex64) and ok(4, 7, 2049,
                                                   torch.complex64)
    assert ok(1, 1, 1, torch.complex64) and ok(56, 16, 3, torch.complex64)
    assert ok(129, 7, 5, torch.complex64)            # 903 rows
    for args in [(64, 7, 8193, torch.complex128), (64, 7, 8193, None),
                 (4, 17, 100, torch.complex64), (4, 0, 100, torch.complex64),
                 (0, 7, 100, torch.complex64), (4, 7, 0, torch.complex64),
                 (130, 7, 5, torch.complex64)]:       # 910 rows
        assert not ok(*args), args
    # mt_coherence outside the gate takes the cross spectra: float64, 17
    # tapers, 130 channels of 7, and a frequency range that holds no bin
    cases = [(signal((3, 300), np.float64, 1), dict(nw=4)),
             (signal((3, 300), np.float32, 2), dict(nw=9, ntapers=17)),
             (signal((130, 64), np.float32, 3), dict(nw=4)),
             (signal((3, 300), np.float32, 4), dict(freq_range=(0.2, 0.2)))]
    for x, kw in cases:
        kernels.reset_launches()
        got = dsptpu_torch.mt_coherence(torch.as_tensor(x), **kw)
        c = profiling.counters()
        assert c["route.mt_coh.cs"] == 1 and "route.mt_coh.k9" not in c
        cs = dsptpu_torch.mt_cross_power_spectra(torch.as_tensor(x), **kw)
        assert torch.equal(got.coherence, dsptpu_torch.coherence_from_cs(
            cs.power))
