"""Port parity for the rest of the single-chip library: the 2-D
periodogram and fftshift_tfr, the signal utilities (util, unwrap,
diric), frequency estimation, filter responses, order estimation and
remez, against dsptpu on the same inputs.

Inputs come from a numpy seed. Tolerances: max|d| <= 1e-10 max|ref| in
float64, <= 3e-5 max|ref| in float32 (bench.py's bound) for the tensor
code; the host numpy copies (estimation, freqresp / grpdelay,
filt_order, remez, the N-D unwrap) match exactly."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import dsptpu
import dsptpu_torch

TOL = {np.float64: 1e-10, np.float32: 3e-5}


def check(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    assert err <= tol * np.max(np.abs(want)), err


def same_freq(got, want):
    """The frequency axes (both of a Periodogram2) are equal."""
    g, w = dsptpu_torch.freq(got), dsptpu.freq(want)
    g, w = (g, w) if isinstance(w, tuple) else ((g,), (w,))
    assert len(g) == len(w)
    assert all(np.array_equal(a, b) for a, b in zip(g, w))


def rand(shape, dtype=np.float64, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


# ---------------------------------------------------------------------------
# 2-D periodogram, fftshift_tfr
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["full", "radialsum", "radialavg"])
@pytest.mark.parametrize("shape,nfft", [((32, 48), None), ((40, 40), None),
                                        ((30, 20), (64, 27))])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_periodogram2_matches_dsptpu(dtype, shape, nfft, kind):
    x = rand(shape, dtype, sum(shape))
    kw = dict(fs=3.0, radialsum=kind == "radialsum",
              radialavg=kind == "radialavg")
    if nfft is not None:
        kw["nfft"] = nfft
    want = dsptpu.periodogram(jnp.asarray(x), **kw)
    got = dsptpu_torch.periodogram(torch.as_tensor(x), **kw)
    check(got.power, want.power, TOL[dtype])
    assert type(got).__name__ == type(want).__name__
    same_freq(got, want)


def test_periodogram2_refusals():
    x = torch.zeros(16, 16)
    with pytest.raises(ValueError, match="mutually exclusive"):
        dsptpu_torch.periodogram(x, radialsum=True, radialavg=True)
    with pytest.raises(ValueError, match="2-D"):
        dsptpu_torch.periodogram(torch.zeros(16), radialsum=True)
    with pytest.raises(ValueError, match="> 1"):
        dsptpu_torch.periodogram(torch.zeros(1, 16))


def test_fftshift_tfr_matches_dsptpu():
    x = rand((600, 2), np.float64, 3)
    pairs = [
        (dsptpu.periodogram(jnp.asarray(x[:, 0]), onesided=False),
         dsptpu_torch.periodogram(torch.as_tensor(x[:, 0]), onesided=False)),
        (dsptpu.periodogram(jnp.asarray(x[:, 0])),
         dsptpu_torch.periodogram(torch.as_tensor(x[:, 0]))),
        (dsptpu.spectrogram(jnp.asarray(x), 64, 32, onesided=False),
         dsptpu_torch.spectrogram(torch.as_tensor(x), 64, 32,
                                  onesided=False)),
        (dsptpu.periodogram(jnp.asarray(x[:30, :]), nfft=(31, 5)),
         dsptpu_torch.periodogram(torch.as_tensor(x[:30, :]), nfft=(31, 5))),
    ]
    for want, got in pairs:
        want, got = dsptpu.fftshift_tfr(want), dsptpu_torch.fftshift_tfr(got)
        check(got.power, want.power, 1e-10)
        same_freq(got, want)
    with pytest.raises(TypeError):
        dsptpu_torch.fftshift_tfr(object())


# ---------------------------------------------------------------------------
# utils/util.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(101,), (128, 3)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_hilbert_matches_dsptpu(shape, dtype):
    x = rand(shape, dtype, shape[0])
    check(dsptpu_torch.hilbert(torch.as_tensor(x)),
          dsptpu.hilbert(jnp.asarray(x)), TOL[dtype])


def test_db_helpers_match_dsptpu():
    a = np.array([-20.0, 0.0, 3.0, 17.5])
    for name in ("db2pow", "db2amp"):
        want = getattr(dsptpu, name)(a)
        assert np.array_equal(getattr(dsptpu_torch, name)(a), want)
        check(getattr(dsptpu_torch, name)(torch.as_tensor(a)), want, 1e-15)
    p = np.array([0.01, 1.0, 2.0, 56.2])
    for name in ("pow2db", "amp2db"):
        want = getattr(dsptpu, name)(p)
        assert np.array_equal(getattr(dsptpu_torch, name)(p), want)
        check(getattr(dsptpu_torch, name)(torch.as_tensor(p)), want, 1e-15)
    assert 3 * dsptpu_torch.dB == 3 * dsptpu.dB
    assert 3 * dsptpu_torch.dBa == 3 * dsptpu.dBa


def test_rms_rmsfft_meanfreq_match_dsptpu():
    x = rand((300, 4), seed=4)
    t = torch.as_tensor(x)
    check(dsptpu_torch.rms(t), dsptpu.rms(jnp.asarray(x)), 1e-10)
    check(dsptpu_torch.rms(t, dims=0), dsptpu.rms(jnp.asarray(x), dims=0),
          1e-10)
    f = np.fft.fft(x[:, 0])
    check(dsptpu_torch.rmsfft(torch.as_tensor(f)),
          dsptpu.rmsfft(jnp.asarray(f)), 1e-10)
    check(dsptpu_torch.meanfreq(t[:, 1], fs=50.0),
          dsptpu.meanfreq(jnp.asarray(x[:, 1]), fs=50.0), 1e-10)


def test_shiftin_and_unsafe_dot_match_dsptpu():
    a, b = rand(10, seed=5), rand(4, seed=6)
    check(dsptpu_torch.shiftin(torch.as_tensor(a), torch.as_tensor(b)),
          dsptpu.shiftin(jnp.asarray(a), jnp.asarray(b)), 1e-15)
    h, s = rand(6, seed=7), rand(40, seed=8)
    A = rand((6, 3), seed=9)
    T = torch.as_tensor
    for got, want in [
            (dsptpu_torch.unsafe_dot(T(h), T(s), 20),
             dsptpu.unsafe_dot(jnp.asarray(h), jnp.asarray(s), 20)),
            (dsptpu_torch.unsafe_dot(T(A), 2, T(s), 11),
             dsptpu.unsafe_dot(jnp.asarray(A), 2, jnp.asarray(s), 11)),
            (dsptpu_torch.unsafe_dot(T(h), T(s[:5]), T(s[5:]), 3),
             dsptpu.unsafe_dot(jnp.asarray(h), jnp.asarray(s[:5]),
                               jnp.asarray(s[5:]), 3))]:
        check(got, want, 1e-12)
    with pytest.raises(ValueError):
        dsptpu_torch.unsafe_dot(T(h), T(s[:4]), T(s), 3)


@pytest.mark.parametrize("d", [-7, 0, 12])
def test_delay_and_alignment_match_dsptpu(d):
    y = rand(200, seed=10)
    x = np.roll(y, d)
    got = dsptpu_torch.finddelay(torch.as_tensor(x), torch.as_tensor(y))
    assert got == dsptpu.finddelay(jnp.asarray(x), jnp.asarray(y)) == d
    ax, dd = dsptpu_torch.alignsignals(torch.as_tensor(x), torch.as_tensor(y))
    wx, wd = dsptpu.alignsignals(jnp.asarray(x), jnp.asarray(y))
    assert dd == wd
    assert np.array_equal(ax.numpy(), np.asarray(wx))
    for s in (-5, 0, 9):
        assert np.array_equal(
            dsptpu_torch.shiftsignal(torch.as_tensor(x), s).numpy(),
            np.asarray(dsptpu.shiftsignal(jnp.asarray(x), s)))
    with pytest.raises(ValueError):
        dsptpu_torch.shiftsignal(torch.as_tensor(x), 201)


# ---------------------------------------------------------------------------
# utils/unwrap.py, utils/diric.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [0, 1])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_unwrap_along_matches_dsptpu(dims, dtype):
    true = np.cumsum(rand((90, 3), seed=11), axis=dims) * 2.0
    wrapped = np.angle(np.exp(1j * true)).astype(dtype)
    want = dsptpu.unwrap(jnp.asarray(wrapped), dims=dims)
    got = dsptpu_torch.unwrap(torch.as_tensor(wrapped), dims=dims)
    check(got, want, TOL[dtype])
    got = dsptpu_torch.unwrap(wrapped, dims=dims, range=3.0, device="cpu")
    check(got, dsptpu.unwrap(wrapped, dims=dims, range=3.0), TOL[dtype])


@pytest.mark.parametrize("circular", [None, (True, False)])
def test_unwrap_nd_matches_dsptpu(circular):
    yy, xx = np.meshgrid(np.linspace(0, 6 * np.pi, 24),
                         np.linspace(0, 5 * np.pi, 19), indexing="ij")
    wrapped = np.angle(np.exp(1j * (yy + 0.7 * xx + 0.3 * rand(yy.shape))))
    want = dsptpu.unwrap(wrapped, dims=range(2), circular_dims=circular,
                         rng=np.random.default_rng(3))
    got = dsptpu_torch.unwrap(wrapped, dims=range(2), circular_dims=circular,
                              rng=np.random.default_rng(3))
    assert np.array_equal(got, want)
    got = dsptpu_torch.unwrap(torch.as_tensor(wrapped), dims=(0, 1),
                              circular_dims=circular,
                              rng=np.random.default_rng(3))
    assert isinstance(got, torch.Tensor)
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        dsptpu_torch.unwrap(torch.as_tensor(wrapped))


@pytest.mark.parametrize("n", [1, 4, 7, 10])
def test_diric_matches_dsptpu(n):
    om = np.concatenate([np.linspace(-13.0, 13.0, 401),
                         2 * np.pi * np.arange(-3, 4)])
    check(dsptpu_torch.diric(torch.as_tensor(om), n),
          dsptpu.diric(jnp.asarray(om), n), 1e-10)
    with pytest.raises(ValueError):
        dsptpu_torch.diric(torch.as_tensor(om), 0)


# ---------------------------------------------------------------------------
# ops/estimation.py
# ---------------------------------------------------------------------------

def test_estimation_matches_dsptpu():
    rng = np.random.default_rng(12)
    t = np.arange(2000) / 8000
    x = (2 * np.exp(2j * np.pi * 2500 * t) + 5 * np.exp(2j * np.pi * 400 * t)
         + rng.standard_normal(2000) * (1 + 1j))
    assert np.array_equal(dsptpu_torch.esprit(torch.as_tensor(x), 5, 2, 8000),
                          dsptpu.esprit(x, 5, 2, 8000))
    r = np.cos(2 * np.pi * 17.3 * t[:300] * 80 + 0.4) \
        + 0.1 * rng.standard_normal(300)
    for s in (x[:500], r):
        assert dsptpu_torch.jacobsen(torch.as_tensor(s), 100.0) == \
            dsptpu.jacobsen(s, 100.0)
        assert dsptpu_torch.quinn(torch.as_tensor(s), Fs=100.0) == \
            dsptpu.quinn(s, Fs=100.0)


# ---------------------------------------------------------------------------
# filters/response.py
# ---------------------------------------------------------------------------

def filter_pair(form):
    """The same design in both packages, in coefficient form `form`."""
    def make(pkg):
        f = pkg.digitalfilter(pkg.Bandpass(0.2, 0.4), pkg.Elliptic(4, 0.5,
                                                                  40))
        if form == "sos":
            return pkg.filters.as_sos(f)
        if form == "tf":
            return pkg.filters.as_polynomial_ratio(f)
        if form == "biquad":
            return pkg.filters.as_biquad(pkg.digitalfilter(
                pkg.Lowpass(0.3), pkg.Butterworth(2)))
        if form == "analog":
            return pkg.analogfilter(pkg.Lowpass(2.0), pkg.Chebyshev1(3, 1.0))
        return f
    return make(dsptpu), make(dsptpu_torch)


@pytest.mark.parametrize("form", ["zpk", "sos", "tf", "biquad", "analog"])
def test_responses_match_dsptpu(form):
    jf, tf = filter_pair(form)
    w = np.linspace(0.01, 3.0, 97)
    for name in ("freqresp", "phaseresp", "grpdelay"):
        want, wgrid = getattr(dsptpu, name)(jf)
        got, grid = getattr(dsptpu_torch, name)(tf)
        assert np.array_equal(grid, wgrid)
        check(got, want, 1e-10)
        check(getattr(dsptpu_torch, name)(tf, w),
              getattr(dsptpu, name)(jf, w), 1e-10)


@pytest.mark.parametrize("form", ["zpk", "sos", "tf", "taps"])
def test_impresp_stepresp_match_dsptpu(form):
    if form == "taps":
        jf = tf = rand(31, seed=13)
    else:
        jf, tf = filter_pair(form)
    for name in ("impresp", "stepresp"):
        want = getattr(dsptpu, name)(jf, 120)
        got = getattr(dsptpu_torch, name)(tf, 120, device="cpu")
        assert got.device.type == "cpu"
        check(got, want, 1e-10)


# ---------------------------------------------------------------------------
# filters/filt_order.py, filters/remez_fir.py
# ---------------------------------------------------------------------------

ORDER_CASES = [
    ((40 / 500, 150 / 500, 3, 60), {}),
    ((40 / 500, 150 / 500, 3, 60), dict(domain="s")),
    ((0.6, 0.3, 3, 60), {}),
    (((0.2, 0.4), (0.1, 0.5), 3, 40), {}),
    (((0.1, 0.6), (0.2, 0.5), 3, 40), {}),
    ((100.0, 150.0, 0.5, 60), dict(domain="s")),
]


@pytest.mark.parametrize("name", ["buttord", "ellipord", "cheb1ord",
                                  "cheb2ord"])
@pytest.mark.parametrize("args,kw", ORDER_CASES)
def test_order_estimates_match_dsptpu(name, args, kw):
    got = getattr(dsptpu_torch, name)(*args, **kw)
    want = getattr(dsptpu, name)(*args, **kw)
    assert got[0] == want[0]
    assert np.array_equal(np.asarray(got[1]), np.asarray(want[1]))


def test_remezord_matches_dsptpu():
    for args in [(0.1, 0.15, 0.01, 0.001), (0.2, 0.25, 0.05, 0.01)]:
        assert dsptpu_torch.remezord(*args) == dsptpu.remezord(*args)
    with pytest.raises(ValueError):
        dsptpu_torch.remezord(0.6, 0.7, 0.01, 0.01)


@pytest.mark.parametrize("args,kw", [
    ((51, [0, 0.2, 0.3, 0.5], [1.0, 0.0]), {}),
    ((152, [0, 0.475, 0.5, 1.0], [1.0, 0.0]), dict(weight=[1, 2], Hz=2.0)),
    ((21, [0.1, 0.95], [1]), dict(filter_type="hilbert", Hz=2.0)),
    ((40, [0.05, 0.95], [1]), dict(filter_type="differentiator", Hz=2.0)),
    ((35, [0, 0.1, 0.2, 0.5], [1.0, 0.0]), dict(weight=[3, 1])),
])
def test_remez_matches_dsptpu(args, kw):
    assert np.array_equal(dsptpu_torch.remez(*args, **kw),
                          dsptpu.remez(*args, **kw))
