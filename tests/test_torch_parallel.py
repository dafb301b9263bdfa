"""Port parity for the sharded layer (dsptpu_torch.parallel): each sharded
op on 4 gloo ranks on the CPU (one simulate_hosts(4) pool for the
module) against dsptpu's same op on a JAX mesh of the same shape (4 of
conftest's 8 virtual CPU devices), so both pad, mask and count segments
and outputs alike; meshes (1, 4) and (2, 2), the signal passed whole
(every rank takes its block) or as a DTensor sharded along time (each
rank holds its torch.chunk block). Counterparts of tests/test_parallel.py
case by case, with its odd lengths, its 4 resample ratios and its tiny
and multichannel filtfilt, plus a float32 case per op with 1024 samples
a shard, where the IIR ops take K2's plain version (need_state) and the
600-tap FIR takes K4's.

Inputs come from a numpy seed. Tolerances: max|d| <= 1e-9 max|ref| in
float64; in float32, bench.py's witness bounds (3e-5 for FIR, Welch,
spectrogram and resampling, 1e-4 for the IIR ops, which bench.py gives
filtfilt). dsptpu under x64 may compute float32 input in float64 (its
float64 windows and taps promote it); the port keeps float32."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from fractions import Fraction
from scipy import signal as sp
import torch

import dsptpu
import dsptpu.parallel as jpar
import dsptpu_torch
import dsptpu_torch.parallel as tpar
from dsptpu.filters.filt import _sos_arrays
from dsptpu_torch import kernels
from dsptpu_torch.parallel import Sharded
from dsptpu_torch.utils import profiling

TOL = {np.float64: 1e-9, np.float32: 3e-5}
IIR_TOL = {np.float64: 1e-9, np.float32: 1e-4}

# (mesh shape, channel axis of the ops)
MESHES = {"1x4": ((1, 4), None), "2x2": ((2, 2), "channel")}


@pytest.fixture(scope="module")
def pool():
    with tpar.simulate_hosts(4) as p:
        yield p


def jmesh(shape):
    return jpar.make_mesh(shape, devices=jax.devices()[:4])


def rng(seed):
    return np.random.default_rng(seed)


def check(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.max(np.abs(want))
    err = np.max(np.abs(got - want)) if got.size else 0.0
    assert err <= tol * scale, (err, scale)


def same(a, b):
    """Two ranks' results equal (tuples element by element)."""
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            same(u, v)
    else:
        np.testing.assert_array_equal(a, b)


def run(pool, op, *args, mesh, form="global", cax=None, **kw):
    """op on the 4 ranks with the signal (the Sharded argument) whole for
    form "global" or as a DTensor for "dtensor"; every rank's full
    result equal, rank 0's returned."""
    args = tuple((a.array if form == "global" else Sharded(a.array, cax))
                 if isinstance(a, Sharded) else a for a in args)
    res = pool.run(op, *args, mesh=mesh, channel_axis=cax, **kw)
    for r in res[1:]:
        same(res[0], r)
    return res[0]


def ports(sos_sp):
    """scipy sos (b0 b1 b2 a0 a1 a2) rows as dsptpu's (b0 b1 b2 a1 a2)."""
    return np.column_stack([sos_sp[:, :3], sos_sp[:, 4:]])


FORMS = ["global", "dtensor"]


# dsptpu's sharded results, one per case and mesh, shared by both input
# forms: dsptpu's shard_map ops compile anew on every call, so each op is
# held against them on each mesh shape once, and its other cases against
# dsptpu's unsharded op or scipy (tests/test_parallel.py holds dsptpu's
# sharded ops equal to those)
_JAX = {}


def jax_ref(key, fn, x, jit=True):
    """fn(x), under jax.jit unless jit is False: one compile of the whole
    sharded op (called eagerly, dsptpu's sharded filtfilt compiles op by
    op for about 30 s on this CPU; under jit about 3 s), x an argument,
    not a constant. dsptpu's shard_stft_pow takes its window's norm on
    the host (float() of a jnp value), so it runs eagerly."""
    if key not in _JAX:
        _JAX[key] = jax.tree_util.tree_map(
            np.asarray, (jax.jit(fn) if jit else fn)(x))
    return _JAX[key]


# ---------------------------------------------------------------------------
# shard_fir / shard_fftfilt
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("nb,n,dtype,mesh,vs", [
    (31, 4096, np.float64, "1x4", "dsptpu"),   # test_matches_lfilter
    (31, 4097, np.float64, "1x4", "scipy"),    # test_shard_fir_odd
    (31, 4097, np.float64, "2x2", "dsptpu"),
    (63, 2048, np.float64, "2x2", "scipy"),    # test_channel_sharded_2d
    (127, 4096, np.float32, "1x4", "scipy"),
    (127, 4096, np.float32, "2x2", "scipy")])
def test_shard_fir(pool, form, nb, n, dtype, mesh, vs):
    shape, cax = MESHES[mesh]
    g = rng(n + nb)
    b = g.standard_normal(nb)
    x = g.standard_normal((n, 8) if cax else n).astype(dtype)
    got = run(pool, tpar.shard_fir, b, Sharded(x), mesh=shape, form=form,
              cax=cax)
    if vs == "dsptpu":
        want = jax_ref(("fir", nb, n, mesh), lambda x: jpar.shard_fir(
            b, x, jmesh(shape), channel_axis=cax), x)
    else:
        want = sp.lfilter(b, [1.0], x.astype(np.float64), axis=0)
    check(got, want, TOL[dtype])


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("nb,dtype,mesh,vs", [
    (300, np.float64, "1x4", "scipy"),    # test_long_taps_os_path (conv)
    (600, np.float64, "1x4", "scipy"),    # above 512 taps: overlap-save
    (600, np.float32, "1x4", "dsptpu"),   # overlap-save, K4's plain version
    (600, np.float32, "2x2", "scipy")])
def test_shard_fftfilt(pool, form, nb, dtype, mesh, vs):
    shape, cax = MESHES[mesh]
    g = rng(nb)
    b = g.standard_normal(nb)
    x = g.standard_normal((8192, 4) if cax else 8192).astype(dtype)
    got = run(pool, tpar.shard_fftfilt, b, Sharded(x), mesh=shape,
              form=form, cax=cax)
    if vs == "dsptpu":
        want = jax_ref(("fftfilt", nb, mesh), lambda x: jpar.shard_fftfilt(
            b, x, jmesh(shape), channel_axis=cax), x)
    else:
        want = sp.lfilter(b, [1.0], x, axis=0)
    check(got, want, TOL[dtype])


@pytest.mark.parametrize("form", FORMS)
def test_shard_fir_one_tap(pool, form):
    """A 1-tap FIR over a (1, 4) mesh equals lfilter in the port. dsptpu's
    is off, a divergence on purpose: with nb = 1 its halo, xs[-(nb - 1):]
    (dsptpu/parallel/ops.py:94), is xs[-0:], a whole block, where it
    should be none."""
    b = np.array([0.7])
    x = rng(1001).standard_normal(1001)
    want = sp.lfilter(b, [1.0], x)
    got = run(pool, tpar.shard_fir, b, Sharded(x), mesh=(1, 4), form=form)
    check(got, want, TOL[np.float64])
    ref = jax_ref(("fir", 1, 1001, "1x4"), lambda x: jpar.shard_fir(
        b, x, jmesh((1, 4))), x)
    err = np.max(np.abs(ref - want)) / np.max(np.abs(want))
    assert err > 1.0, err       # 1.49 of max|ref| on this input


def test_shard_fir_refuses_long_history(pool):
    with pytest.raises(RuntimeError, match="filter history"):
        pool.run(tpar.shard_fir, np.ones(40), np.ones(100), mesh=(1, 4))


# ---------------------------------------------------------------------------
# shard_welch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("n_sig,nfft,window,dtype,mesh,vs", [
    (8192, 256, "hanning", np.float64, "1x4", "dsptpu"),  # test_matches_welch
    (4097, 256, "hanning", np.float64, "1x4", "welch"),   # test_shard_welch_odd
    (5000, 256, "hanning", np.float64, "1x4", "welch"),
    (1000, 256, "hanning", np.float64, "1x4", "welch"),
    (4096, 128, "hamming", np.float64, "2x2", "dsptpu"),  # test_multichannel
    (4097, 128, "hanning", np.float64, "2x2", "welch"),
    (4096, 128, "hanning", np.float32, "1x4", "welch"),
    (4096, 128, "hamming", np.float32, "2x2", "welch")])
def test_shard_welch(pool, form, n_sig, nfft, window, dtype, mesh, vs):
    shape, cax = MESHES[mesh]
    x = rng(n_sig).standard_normal((n_sig, 4) if cax else n_sig).astype(
        dtype)
    win = np.asarray(getattr(dsptpu.windows, window)(nfft))
    psd, freqs = run(pool, tpar.shard_welch, Sharded(x), nfft, nfft // 2,
                     win, mesh=shape, form=form, cax=cax, fs=2.0)
    np.testing.assert_allclose(freqs, np.fft.rfftfreq(nfft, 0.5),
                               rtol=1e-15)
    if vs == "dsptpu":
        want = jax_ref(("welch", n_sig, mesh), lambda x: jpar.shard_welch(
            x, nfft, nfft // 2, win, jmesh(shape), channel_axis=cax,
            fs=2.0)[0], x)
    else:
        want = dsptpu.power(dsptpu.welch_pgram(
            x.astype(np.float64), nfft, nfft // 2, window=win, fs=2.0))
    check(psd, want, TOL[dtype])


# ---------------------------------------------------------------------------
# shard_sosfilt
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("design,g,n,dtype,mesh,vs", [
    ((8, 0.2), 1.0, 4096, np.float64, "1x4", "dsptpu"),  # test_matches_sosfilt
    ((4, 0.35), 1.0, 2048, np.float64, "2x2", "dsptpu"),  # test_multichannel
    ((4, 0.3), 1.0, 3001, np.float64, "1x4", "scipy"),   # test_shard_sosfilt_odd
    ((6, [0.2, 0.5]), 2.5, 8192, np.float64, "1x4", "scipy"),  # long cascade
    ((8, 0.2), 1.0, 4096, np.float32, "1x4", "scipy"),   # K2 need_state
    ((8, 0.2), 1.0, 2050, np.float32, "2x2", "scipy")])  # K2 need_state
def test_shard_sosfilt(pool, form, design, g, n, dtype, mesh, vs):
    # the long cascade (TestShardSOSPrefix) chains its state over every
    # rank, with a gain; the float32 cases run 512-1024 samples a shard
    shape, cax = MESHES[mesh]
    order, cut = design
    sos_sp = sp.butter(order, cut, btype="band" if isinstance(cut, list)
                       else "low", output="sos")
    x = rng(n + order).standard_normal((n, 4) if cax else n).astype(dtype)
    got = run(pool, tpar.shard_sosfilt, ports(sos_sp), g, Sharded(x),
              mesh=shape, form=form, cax=cax)
    if vs == "dsptpu":
        want = jax_ref(("sosfilt", n, mesh), lambda x: jpar.shard_sosfilt(
            ports(sos_sp), g, x, jmesh(shape), channel_axis=cax), x)
    else:
        want = sp.sosfilt(sos_sp, x.astype(np.float64), axis=0) * g
    check(got, want, IIR_TOL[dtype])


# ---------------------------------------------------------------------------
# shard_filtfilt
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("band,order,n,dtype,mesh,vs", [
    ((0.2,), 8, 4096, np.float64, "1x4", "dsptpu"),  # test_matches_filtfilt
    ((0.15, 0.4), 3, 2050, np.float64, "2x2", "dsptpu"),  # odd multichannel
    ((0.15, 0.4), 3, 2048, np.float64, "2x2", "filtfilt"),  # multichannel
    ((0.2,), 8, 3001, np.float64, "1x4", "filtfilt"),  # test_shard_filtfilt_odd
    ((0.2,), 8, 4097, np.float64, "1x4", "filtfilt"),
    ((0.3,), 4, 200, np.float64, "1x4", "filtfilt"),   # tiny: padding shards
    ((0.2,), 8, 4096, np.float32, "1x4", "filtfilt"),  # K2 need_state
    ((0.2,), 8, 4001, np.float32, "1x4", "filtfilt"),  # padded, K2 need_state
    ((0.2,), 8, 2050, np.float32, "2x2", "filtfilt")])
def test_shard_filtfilt(pool, form, band, order, n, dtype, mesh, vs):
    shape, cax = MESHES[mesh]
    ftype = (dsptpu.Lowpass(*band) if len(band) == 1
             else dsptpu.Bandpass(*band))
    f = dsptpu.digitalfilter(ftype, dsptpu.Butterworth(order))
    sos, g = _sos_arrays(dsptpu.filters.as_sos(f))
    x = rng(n + order).standard_normal((n, 4) if cax else n).astype(dtype)
    got = run(pool, tpar.shard_filtfilt, sos, g, Sharded(x), mesh=shape,
              form=form, cax=cax)
    if vs == "dsptpu":
        want = jax_ref(("filtfilt", n, mesh), lambda x: jpar.shard_filtfilt(
            sos, g, x, jmesh(shape), channel_axis=cax), x)
    else:
        want = dsptpu.filtfilt(f, x=jnp.asarray(x.astype(np.float64)))
    check(got, want, IIR_TOL[dtype])


# ---------------------------------------------------------------------------
# shard_spectrogram / shard_stft_pow / shard_mt_spectrogram
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("n_sig,nfft,window,dtype,mesh,vs", [
    (4096, 128, "hanning", np.float64, "1x4", "dsptpu"),  # test_matches_spectrogram
    (2048, 64, "hamming", np.float64, "2x2", "dsptpu"),   # test_multichannel
    (4100, 128, "hanning", np.float64, "1x4", "spectrogram"),  # odd
    (4096, 128, "hanning", np.float32, "1x4", "spectrogram"),
    (2050, 64, "hamming", np.float32, "2x2", "spectrogram")])
def test_shard_spectrogram(pool, form, n_sig, nfft, window, dtype, mesh, vs):
    shape, cax = MESHES[mesh]
    x = rng(n_sig + nfft).standard_normal(
        (n_sig, 4) if cax else n_sig).astype(dtype)
    win = np.asarray(getattr(dsptpu.windows, window)(nfft))
    pw, freqs, t = run(pool, tpar.shard_spectrogram, Sharded(x), nfft,
                       nfft // 2, win, mesh=shape, form=form, cax=cax)
    ref = np.asarray(dsptpu.spectrogram(x.astype(np.float64), nfft,
                                        nfft // 2, window=win).power)
    k = ref.shape[1]
    if vs == "dsptpu":
        jpw, jfreqs, jt = jax_ref(
            ("spectrogram", n_sig, mesh), lambda x: jpar.shard_spectrogram(
                x, nfft, nfft // 2, win, jmesh(shape), channel_axis=cax), x,
            jit=False)
        check(pw, jpw, TOL[dtype])
        np.testing.assert_array_equal(freqs, jfreqs)
        np.testing.assert_array_equal(t, jt)
    check(pw[:k], np.moveaxis(ref, 0, 1), TOL[dtype])
    assert np.all(pw[k:] == 0)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("onesided,window", [(False, "hanning"),
                                             (True, None)])
def test_shard_stft_pow_forms(pool, form, onesided, window):
    # two-sided power, and no window; dsptpu's sharded op is the
    # reference of the first
    x = rng(11).standard_normal((3000, 4))
    win = None if window is None else np.asarray(dsptpu.windows.hanning(96))
    pw, freqs, t = run(pool, tpar.shard_stft_pow, Sharded(x), 96, 48, win,
                       mesh=(2, 2), cax="channel", form=form,
                       onesided=onesided, fs=3.0)
    if window is None:
        ref = np.asarray(dsptpu.spectrogram(x, 96, 48, fs=3.0).power)
        k = ref.shape[1]
        check(pw[:k], np.moveaxis(ref, 0, 1), 1e-9)
        assert np.all(pw[k:] == 0)
        return
    jpw, jfreqs, jt = jax_ref(("stft_pow", onesided), lambda x:
                              jpar.shard_stft_pow(
                                  x, 96, 48, win, jmesh((2, 2)),
                                  channel_axis="channel", onesided=onesided,
                                  fs=3.0), x, jit=False)
    check(pw, jpw, 1e-9)
    np.testing.assert_array_equal(freqs, jfreqs)
    np.testing.assert_array_equal(t, jt)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("n_sig,dtype,mesh,vs", [
    (4096, np.float64, "1x4", "dsptpu"),   # test_matches_mt_spectrogram
    (4099, np.float64, "2x2", "dsptpu"),   # test_shard_mt_spectrogram_odd
    (4099, np.float64, "1x4", "mt_spectrogram"),
    (4096, np.float32, "1x4", "mt_spectrogram")])
def test_shard_mt_spectrogram(pool, form, n_sig, dtype, mesh, vs):
    shape, cax = MESHES[mesh]
    x = rng(n_sig).standard_normal((n_sig, 2) if cax else n_sig).astype(
        dtype)
    cfg = dsptpu_torch.MTConfig.create(128, nw=2, nfft=128)
    pw = run(pool, tpar.shard_mt_spectrogram, Sharded(x), cfg, 64,
             mesh=shape, form=form, cax=cax)
    jcfg = dsptpu.MTConfig.create(128, nw=2, nfft=128)
    if vs == "dsptpu":
        want = jax_ref(("mt_spectrogram", n_sig, mesh), lambda x:
                       jpar.shard_mt_spectrogram(x, jcfg, 64, jmesh(shape),
                                                 channel_axis=cax), x)
        check(pw, want, TOL[dtype])
        return
    ref = np.asarray(dsptpu.mt_spectrogram(
        jnp.asarray(x.astype(np.float64)), config=jcfg, n_overlap=64).power)
    k = ref.shape[1]
    check(pw[:k], ref.T, TOL[dtype])
    assert np.all(pw[k:] == 0)


def test_shard_mt_spectrogram_config(pool):
    # an MTSpectrogramConfig carries the overlap
    x = rng(3).standard_normal(3000)
    cfg = dsptpu_torch.MTSpectrogramConfig.create(
        3000, n_overlap_samples=96, mt_config=dsptpu_torch.MTConfig.create(
            128, nw=3, nfft=128))
    pw = run(pool, tpar.shard_mt_spectrogram, Sharded(x), cfg, mesh=(1, 4),
             form="dtensor")
    jcfg = dsptpu.MTConfig.create(128, nw=3, nfft=128)
    ref = np.asarray(dsptpu.mt_spectrogram(jnp.asarray(x), config=jcfg,
                                           n_overlap=96).power)
    check(pw[: ref.shape[1]], ref.T, 1e-9)


# ---------------------------------------------------------------------------
# shard_resample / compact_shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("ratio,n,dtype,mesh,vs", [
    ("147/160", 8000, np.float64, "1x4", "dsptpu"),  # test_matches_firfilter
    ("3/2", 8000, np.float64, "1x4", "firfilter"),
    ("1/4", 8000, np.float64, "1x4", "firfilter"),
    ("5", 8000, np.float64, "1x4", "firfilter"),
    ("3/2", 4000, np.float64, "2x2", "dsptpu"),      # test_multichannel
    ("3/2", 8001, np.float64, "1x4", "firfilter"),   # test_shard_resample_odd
    ("147/160", 8000, np.float32, "1x4", "firfilter"),
    ("3/2", 4001, np.float32, "2x2", "firfilter")])
def test_shard_resample(pool, form, ratio, n, dtype, mesh, vs):
    shape, cax = MESHES[mesh]
    ratio = Fraction(ratio)
    h = np.asarray(dsptpu.resample_filter(ratio))
    x = rng(n).standard_normal((n, 4) if cax else n).astype(dtype)
    y, cnt = run(pool, tpar.shard_resample, h, ratio, Sharded(x),
                 mesh=shape, form=form, cax=cax)
    got = tpar.compact_shards(dsptpu_torch.utils.as_tensor(y, "cpu"),
                              cnt).numpy()
    if vs == "dsptpu":
        jy, jcnt = jax_ref(("resample", ratio, n, mesh), lambda x:
                           jpar.shard_resample(h, ratio, x, jmesh(shape),
                                               channel_axis=cax), x)
        np.testing.assert_array_equal(cnt, jcnt)
        check(y, jy, TOL[dtype])
        check(got, np.asarray(jpar.compact_shards(jy, jcnt)), TOL[dtype])
        return
    ref = np.asarray(dsptpu.FIRFilter(h, ratio).filt(
        jnp.asarray(x.astype(np.float64))))
    check(got, ref, TOL[dtype])


# ---------------------------------------------------------------------------
# taper-sharded cross spectra and coherence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES)
def test_shard_mt_cross_power_spectra(pool, mesh):
    # TestShardMTCrossSpectra.test_matches_cross_power_spectra: 7 tapers
    # over 4 (or 2) ranks, padded with zero weight
    shape = MESHES[mesh][0]
    x = rng(4).standard_normal((4, 1024))
    got = pool.run(tpar.shard_mt_cross_power_spectra, x, mesh=shape,
                   nw=4)[0]
    want = jpar.shard_mt_cross_power_spectra(x, jmesh(shape), nw=4)
    check(got.power, want.power, 1e-9)
    np.testing.assert_allclose(got.freq, np.asarray(want.freq))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_shard_mt_cross_power_spectra_config(pool, dtype):
    # test_divisible_tapers_freq_range_demean; in float32 the tapers are
    # cast to the signal's dtype as dsptpu's sharded op casts them
    x = (rng(3).standard_normal((3, 512)) + 0.7).astype(dtype)
    kw = dict(fs=2.0, demean=True, freq_range=(0.1, 0.8), ntapers=8, nw=5)
    got = pool.run(tpar.shard_mt_cross_power_spectra, x, mesh=(1, 4),
                   config=dsptpu_torch.MTCrossSpectraConfig.create(
                       3, 512, **kw))[0]
    want = jpar.shard_mt_cross_power_spectra(
        x, jmesh((1, 4)), config=dsptpu.MTCrossSpectraConfig.create(
            3, 512, **kw))
    assert got.power.shape == np.asarray(want.power).shape
    check(got.power, want.power, TOL[dtype])
    np.testing.assert_allclose(got.freq, np.asarray(want.freq))


def test_shard_mt_coherence(pool):
    # TestShardMTCrossSpectra.test_coherence
    n = 2048
    g = rng(2048)
    common = np.sin(2 * np.pi * 0.07 * np.arange(n))
    x = np.stack([common + 0.3 * g.standard_normal(n),
                  common + 0.3 * g.standard_normal(n),
                  g.standard_normal(n)])
    got = pool.run(tpar.shard_mt_coherence, x, mesh=(2, 2), nw=4)[0]
    want = jpar.shard_mt_coherence(x, jmesh((2, 2)), nw=4)
    check(got.coherence, want.coherence, 1e-9)


# ---------------------------------------------------------------------------
# meshes, process groups, the simulated hosts, the entries
# ---------------------------------------------------------------------------

def test_make_mesh_covers_the_world(pool):
    assert pool.run(tpar.make_mesh, (2, 2), device_type="cpu") == [
        {"channel": 2, "time": 2}] * 4
    assert pool.run(tpar.make_mesh, device_type="cpu")[0] == {
        "channel": 1, "time": 4}
    with pytest.raises(RuntimeError, match="does not cover 4 devices"):
        pool.run(tpar.make_mesh, (3, 2), device_type="cpu")
    with pytest.raises(ValueError, match="does not cover 8 devices"):
        jpar.make_mesh((3, 2))


def test_global_mesh_divergence(pool):
    # dsptpu's global_mesh passes time=/channel= to a make_mesh that takes
    # neither (ROADMAP Queue 3, reference behaviours); the port builds
    # the mesh its docstring describes
    with pytest.raises(TypeError):
        jpar.global_mesh()
    assert pool.run(tpar.global_mesh, device_type="cpu") == [{"time": 4}] * 4
    assert pool.run(tpar.global_mesh, channel=2, device_type="cpu")[0] == {
        "channel": 2, "time": 2}
    assert pool.run(tpar.global_mesh, time=4, device_type="cpu")[0] == {
        "channel": 1, "time": 4}


def test_init_distributed(pool, monkeypatch):
    # the ranks joined through init_distributed (a file:// store); a
    # second call returns False, as does a call with nothing to join
    assert pool.run(tpar.init_distributed, device_type="cpu") == [False] * 4
    for name in ("MASTER_ADDR", "WORLD_SIZE", "RANK",
                 "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES"):
        monkeypatch.delenv(name, raising=False)
    assert tpar.init_distributed(device_type="cpu") is False
    assert jpar.init_distributed() is False


def test_hosts_are_gloo_ranks_without_jax(pool):
    # the spawned ranks import torch, numpy and dsptpu_torch only; one
    # torch thread each
    assert pool.run(eval, "'jax' in __import__('sys').modules") == [False] * 4
    assert pool.run(eval, "__import__('torch').get_num_threads()") == [1] * 4
    assert pool.run(eval, "__import__('torch.distributed').distributed."
                          "get_backend()") == ["gloo"] * 4
    assert sorted(pool.run(eval, "__import__('torch.distributed')."
                                 "distributed.get_rank()")) == [0, 1, 2, 3]


def test_host_errors_reach_the_caller(pool):
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        pool.run(eval, "1 / 0")
    assert pool.run(eval, "2 + 2") == [4] * 4      # the pool still works


def test_single_rank_mesh_without_a_group():
    # dsptpu builds a mesh with no distributed setup; the port starts a
    # single-rank gloo group for device_type="cpu"
    import torch.distributed as dist
    assert not dist.is_initialized()
    try:
        mesh = tpar.make_mesh(device_type="cpu")
        assert dist.get_world_size() == 1
        assert mesh.mesh_dim_names == ("channel", "time")
        assert tuple(mesh.mesh.shape) == (1, 1)
        x = rng(1).standard_normal(700)
        b = rng(2).standard_normal(31)
        y = tpar.shard_fir(b, x, mesh).full_tensor().numpy()
        check(y, jpar.shard_fir(b, x, jpar.make_mesh(
            (1, 1), devices=jax.devices()[:1])), 1e-9)
        # sharded_entry at world size 1 equals entry()'s Welch PSD
        fwd, (xs,) = dsptpu_torch.sharded_entry(mesh, n=20000, channels=3)
        psd = fwd(xs)
        ref, _ = dsptpu_torch.entry(device="cpu", n=20000, channels=3)[0](
            xs.to_local())
        check(psd.to_local().numpy(), ref.numpy(), 3e-5)
    finally:
        dist.destroy_process_group()


def test_weak_scaling_efficiency():
    rates = {1: 10.0, 2: 19.0, 4: 36.0}
    assert tpar.weak_scaling_efficiency(rates) == \
        jpar.weak_scaling_efficiency(rates)


def test_public_names_match_dsptpu():
    names = [n for n in dir(jpar) if not n.startswith("_")
             and n not in ("distributed", "mesh", "ops")]
    assert len(names) == 18
    for n in names:
        assert callable(getattr(tpar, n)), n


def test_dryrun_multichip():
    # __graft_entry__.dryrun_multichip's witnesses on 4 simulated hosts
    # (a (2, 2) mesh): fir + sosfilt + welch, spectrogram, resample
    # through compact_shards (on the ranks) and filtfilt; and
    # sharded_entry's chain at world size 4 against entry()'s
    errs = dsptpu_torch.dryrun_multichip(4)
    assert set(errs) == {"fir+sosfilt+welch", "spectrogram", "resample",
                         "filtfilt", "sharded_entry"}


# ---------------------------------------------------------------------------
# tracing: the sharded layer's spans and counters
# ---------------------------------------------------------------------------

# the collective counters, one for each call issued
COLLECTIVES = ("shard.p2p", "shard.all_reduce", "shard.all_gather")


@pytest.fixture
def mesh1():
    """A world-size-1 gloo mesh in this process; its group is destroyed
    after the test."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    mesh = tpar.make_mesh(device_type="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def _local(v):
    """A result as numpy: a DTensor as its local block, dataclasses by
    field, tuples element by element."""
    from torch.distributed.tensor import DTensor
    if isinstance(v, DTensor):
        v = v.to_local()
    if isinstance(v, torch.Tensor):
        return v.numpy()
    if dataclasses.is_dataclass(v):
        return tuple(_local(getattr(v, f.name))
                     for f in dataclasses.fields(v))
    if isinstance(v, tuple):
        return tuple(_local(u) for u in v)
    return np.asarray(v)


def traced(fn):
    """(fn() with tracing off, fn() with tracing on, the span ring's
    records of the traced call, its counters)."""
    off = fn()
    kernels.reset_launches()
    profiling.tracing(True)
    try:
        on = fn()
    finally:
        profiling.tracing(False)
    recs = profiling.spans()
    counters = profiling.counters()
    kernels.reset_launches()
    return off, on, recs, counters


def tree(recs):
    """[(span name, its parent's name or None)] in the order opened."""
    names = {r[0]: r[3] for r in recs}
    return [(r[3], names.get(r[2])) for r in recs]


def test_sharded_entry_spans_and_counters_at_world_size_1(mesh1):
    n, C = 20000, 3
    fwd, (xs,) = dsptpu_torch.sharded_entry(mesh1, n=n, channels=C)
    off, on, recs, counters = traced(lambda: fwd(xs))
    same(_local(off), _local(on))
    assert tree(recs) == [
        ("entry", None), ("shard_fir", "entry"),
        ("shard.reblock", "shard_fir"), ("shard_sosfilt", "entry"),
        ("kernel.biir", "shard_sosfilt"), ("shard_welch", "entry"),
        ("shard.reblock", "shard_welch"),
        ("sync.shard_welch.window", "shard_welch")] + [
        ("sync.shard_welch.scale", "shard_welch")] * 2
    # shard_welch's waits: the float64 window (1024 points) uploaded and
    # the one-sided weights' two float32 host scalars written
    assert {k: v for k, v in counters.items()
            if k.startswith(("sync.", "upload."))} == {
        "sync.shard_welch.window": 1, "sync.shard_welch.scale": 2,
        "upload.bytes": 8 * 1024 + 2 * 4}
    # the FIR's block with its 126-row left halo, Welch's with the
    # n - hop = 512-row right halo past the hop-multiple block
    welch_rows = -(-n // 512) * 512 + 512
    assert counters["shard.reblock.bytes"] == 4 * C * ((n + 126) + welch_rows)
    assert counters["route.shard_fir.direct"] == 1
    assert "route.shard_fir.os" not in counters
    assert not set(COLLECTIVES) & set(counters)


def _sos():
    return ports(sp.butter(4, 0.2, output="sos"))


def _mt_cfg():
    return dsptpu_torch.MTConfig.create(128, nw=2, nfft=128)


# shard_filtfilt's host tables, uploaded each call (utils.device), and
# the span of each
_FF_TABLE = ("sync.shard_filtfilt.table", "shard_filtfilt")
_FF_T = ("sync.shard_scan.T", "shard_filtfilt")
_FF_K2 = ("kernel.biir", "shard_filtfilt")
# the one-sided Welch weights' host scalars and a window's upload
_WELCH_WAITS = [("sync.shard_welch.window", "shard_welch")] + [
    ("sync.shard_welch.scale", "shard_welch")] * 2
_STFT_WAITS = [("sync.shard_stft_pow.window", "shard_stft_pow"),
               ("sync.shard_stft_pow.scale", "shard_stft_pow")]

# (case, the call on a (4096, 2) float32 block and the mesh, the spans it
# records as (name, parent), the FIR route it counts); a span `sync.<site>`
# is an upload or read-back (utils.device): the taps given as a host
# array, and each op's host tables and windows
SHARD_OPS = [
    ("fir", lambda x, m: tpar.shard_fir(rng(5).standard_normal(31), x, m),
     [("shard_fir", None), ("sync.as_tensor", "shard_fir"),
      ("shard.reblock", "shard_fir")], "direct"),
    ("fftfilt", lambda x, m: tpar.shard_fftfilt(
        rng(6).standard_normal(600), x, m),
     [("shard_fftfilt", None), ("shard_fir", "shard_fftfilt"),
      ("sync.as_tensor", "shard_fir"), ("shard.reblock", "shard_fir")],
     "os"),
    ("welch", lambda x, m: tpar.shard_welch(x, 256, 128, np.hanning(256),
                                            m),
     [("shard_welch", None), ("shard.reblock", "shard_welch")]
     + _WELCH_WAITS, None),
    ("stft_pow", lambda x, m: tpar.shard_stft_pow(
        x, 256, 128, np.hanning(256), m, onesided=False),
     [("shard_stft_pow", None), ("shard.reblock", "shard_stft_pow")]
     + _STFT_WAITS, None),
    ("spectrogram", lambda x, m: tpar.shard_spectrogram(
        x, 256, 192, np.hamming(256), m),
     [("shard_spectrogram", None), ("shard_stft_pow", "shard_spectrogram"),
      ("shard.reblock", "shard_stft_pow")] + _STFT_WAITS, None),
    ("mt_spectrogram", lambda x, m: tpar.shard_mt_spectrogram(
        x, _mt_cfg(), 64, m),
     [("shard_mt_spectrogram", None),
      ("shard.reblock", "shard_mt_spectrogram")]
     + [(f"sync.mt_const.{k}", "shard_mt_spectrogram")
        for k in ("tapers", "rinv", "scale")], None),
    ("sosfilt", lambda x, m: tpar.shard_sosfilt(_sos(), 1.0, x, m),
     [("shard_sosfilt", None), ("kernel.biir", "shard_sosfilt")], None),
    ("filtfilt", lambda x, m: tpar.shard_filtfilt(_sos(), 1.0, x, m),
     [("shard_filtfilt", None), _FF_TABLE, _FF_K2, _FF_TABLE, _FF_TABLE,
      _FF_T, _FF_TABLE, _FF_K2] + [_FF_TABLE] * 5
     + [_FF_K2, _FF_T, _FF_TABLE, _FF_K2], None),
    ("resample", lambda x, m: tpar.compact_shards(*tpar.shard_resample(
        np.asarray(dsptpu_torch.resample_filter(Fraction(3, 2))),
        Fraction(3, 2), x, m)),
     [("shard_resample", None), ("shard.reblock", "shard_resample"),
      ("compact_shards", None)], None),
    ("mt_cross_power_spectra", lambda x, m:
     tpar.shard_mt_cross_power_spectra(x.T[:, :1024], m, nw=4),
     [("shard_mt_cross_power_spectra", None)], None),
    ("mt_coherence", lambda x, m: tpar.shard_mt_coherence(
        x.T[:, :1024], m, nw=4),
     [("shard_mt_coherence", None),
      ("shard_mt_cross_power_spectra", "shard_mt_coherence")], None),
]


@pytest.mark.parametrize("case,call,spans,route", SHARD_OPS,
                         ids=[c[0] for c in SHARD_OPS])
def test_shard_op_spans_and_bits_with_tracing(mesh1, case, call, spans,
                                              route):
    """Each public op at world size 1 records its own span (and
    _reblock's where the layouts differ), issues no collective, and
    gives the same bits with tracing on as off."""
    x = torch.as_tensor(rng(27).standard_normal((4096, 2)).astype(
        np.float32))
    off, on, recs, counters = traced(lambda: call(x, mesh1))
    same(_local(off), _local(on))
    assert tree(recs) == spans
    assert not set(COLLECTIVES) & set(counters)
    fir = {k for k in counters if k.startswith("route.shard_fir.")}
    assert fir == ({f"route.shard_fir.{route}"} if route else set())
    if not any(s[0] == "shard.reblock" for s in spans):
        assert "shard.reblock.bytes" not in counters


# (rows, taps, dtype, the route _fir_local takes, the reference): K1 by
# dspbase.filt's gate (real float32, 2-512 taps, a block of at least
# 32,768 and 4 nb rows), F.conv1d outside it, overlap-save above 512 taps
SHARD_FIR_ROUTES = [
    (40000, "chain", np.float32, "k1", "dsptpu"),
    (40000, "chain", np.float64, "direct", "scipy"),
    (40000, "one", np.float32, "direct", "scipy"),
    (8192, "chain", np.float32, "direct", "scipy"),
    (40000, "long", np.float32, "os", "scipy")]


@pytest.mark.parametrize("n,taps,dtype,route,vs", SHARD_FIR_ROUTES,
                         ids=[f"{r[1]}-{r[0]}-{r[2].__name__}"
                              for r in SHARD_FIR_ROUTES])
def test_shard_fir_route_at_world_size_1(mesh1, n, taps, dtype, route, vs):
    """shard_fir on a (n, 2) block counts the route it takes, once, and
    runs K1 (here its plain version) on the halo-extended block inside
    shard_fir's span where the gate holds, K4's above 512 taps."""
    b = {"chain": dsptpu_torch.pipeline.chain_params()[0],
         "one": np.array([0.7], np.float32),
         "long": rng(29).standard_normal(600).astype(np.float32)}[taps]
    x = rng(30).standard_normal((n, 2)).astype(dtype)
    off, on, recs, counters = traced(lambda: tpar.shard_fir(
        torch.as_tensor(b), torch.as_tensor(x), mesh1))
    same(_local(off), _local(on))
    fir = {k: v for k, v in counters.items()
           if k.startswith("route.shard_fir.")}
    assert fir == {f"route.shard_fir.{route}": 1}
    spans = [("shard_fir", None)]
    if b.shape[0] > 1:
        spans.append(("shard.reblock", "shard_fir"))
    if route != "direct":
        spans.append(({"k1": "kernel.fir", "os": "kernel.osconv"}[route],
                      "shard_fir"))
    assert tree(recs) == spans
    if vs == "dsptpu":
        want = jax_ref(("fir_route", n, taps), lambda x: jpar.shard_fir(
            b, x, jpar.make_mesh((1, 1), devices=jax.devices()[:1])), x)
    else:
        want = sp.lfilter(b.astype(np.float64), [1.0],
                          x.astype(np.float64), axis=0)
    check(_local(on), want, TOL[dtype])


def test_collective_counters_at_world_size_4(pool):
    """The chain of sharded_entry on 4 ranks, op by op on DTensor blocks:
    each rank issues one exchange for the FIR's left halo and one for
    Welch's right halo, one all_gather of the cascade's boundary states
    and one all_reduce of Welch's sums, and builds the two halo blocks."""
    from dsptpu_torch.kernels import reset_launches
    from dsptpu_torch.utils.profiling import counters
    n, C = 8192, 2
    x = rng(28).standard_normal((n, C)).astype(np.float32)
    taps, sos, win = dsptpu_torch.pipeline.chain_params()
    pool.run(reset_launches)
    y = run(pool, tpar.shard_fir, taps, Sharded(x), mesh=(1, 4),
            form="dtensor")
    z = run(pool, tpar.shard_sosfilt, sos, 1.0, Sharded(y), mesh=(1, 4),
            form="dtensor")
    run(pool, tpar.shard_welch, Sharded(z), 1024, 512, win, mesh=(1, 4),
        form="dtensor")
    got = [{k: v for k, v in c.items() if k.startswith(("shard.",
                                                         "route.shard_fir"))}
           for c in pool.run(counters)]
    nlocal = n // 4
    assert got == [{"shard.p2p": 2, "shard.all_gather": 1,
                    "shard.all_reduce": 1, "route.shard_fir.direct": 1,
                    "shard.reblock.bytes": 4 * C * ((nlocal + 126)
                                                    + (nlocal + 512))}] * 4
