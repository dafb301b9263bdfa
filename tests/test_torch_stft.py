"""Port parity for the spectral path: dsptpu_torch's welch_pgram / stft /
spectrogram / periodogram against dsptpu's, and the plain version of K3
(kernels/stft.stft_pow_reference, what the wrapper runs on a CPU tensor)
against dsptpu's Pallas STFT kernel in interpret mode, decoded from its
tile layout with bins_from_tile / onesided_bins_from_tile.

Inputs come from a numpy seed and go to both packages as explicit
float32 or float64 arrays. Tolerances: max|d| <= 1e-10 max|ref| in
float64, <= 3e-5 max|ref| in float32 (bench.py's Welch / spectrogram
bound)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import dsptpu
import dsptpu_torch
from dsptpu.kernels.stft import (bins_from_tile, onesided_bins_from_tile,
                                 stft_pow_pallas)
from dsptpu_torch.convert import window_from_numpy
from dsptpu_torch.kernels import stft as tstft

TOL = {np.float64: 1e-10, np.float32: 3e-5}


def check(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    assert err <= tol * np.max(np.abs(want)), err


# (n, chans, nseg, noverlap, nfft, dtype): the float32 cases with nfft and
# hop multiples of 128 take the K3 gate (plain K3 on the CPU)
CASES = [
    (6000, (3,), 256, 128, 256, np.float32),
    (7001, (2,), 384, 256, 384, np.float32),
    (9000, (2, 2), 1024, 512, 1024, np.float32),
    (5000, (3,), 256, 128, 256, np.float64),
    (3000, (2,), 100, 50, 128, np.float32),      # off the gate: torch.fft
    (3000, (), 200, 72, 256, np.float32),        # n < nfft: still the gate
]


@pytest.mark.parametrize("n,chans,nseg,nov,nfft,dtype", CASES)
def test_welch_matches_dsptpu(n, chans, nseg, nov, nfft, dtype):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n,) + chans).astype(dtype)
    win = np.hanning(nseg).astype(dtype)
    want = dsptpu.welch_pgram(jnp.asarray(x), nseg, nov, nfft=nfft,
                              window=jnp.asarray(win))
    got = dsptpu_torch.welch_pgram(torch.as_tensor(x), nseg, nov, nfft=nfft,
                                   window=window_from_numpy(win, "cpu"))
    check(got.power, want.power, TOL[dtype])
    assert np.array_equal(got.freq, want.freq)


@pytest.mark.parametrize("n,chans,nseg,nov,nfft,dtype", CASES)
def test_spectrogram_matches_dsptpu(n, chans, nseg, nov, nfft, dtype):
    rng = np.random.default_rng(n + 1)
    x = rng.standard_normal((n,) + chans).astype(dtype)
    win = np.hanning(nseg).astype(dtype)
    want = dsptpu.spectrogram(jnp.asarray(x), nseg, nov, nfft=nfft,
                              window=jnp.asarray(win))
    got = dsptpu_torch.spectrogram(torch.as_tensor(x), nseg, nov, nfft=nfft,
                                   window=torch.as_tensor(win))
    check(got.power, want.power, TOL[dtype])
    assert np.array_equal(got.time, want.time)


@pytest.mark.parametrize("onesided", [True, False])
@pytest.mark.parametrize("psdonly", [True, False])
def test_stft_matches_dsptpu(onesided, psdonly):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4000, 2)).astype(np.float32)
    win = np.hanning(256).astype(np.float32)
    kw = dict(psdonly=psdonly, onesided=onesided, nfft=256)
    want = dsptpu.stft(jnp.asarray(x), 256, 128, window=jnp.asarray(win),
                       **kw)
    got = dsptpu_torch.stft(torch.as_tensor(x), 256, 128,
                            window=torch.as_tensor(win), **kw)
    check(got, want, 3e-5)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("onesided", [True, False])
@pytest.mark.parametrize("chans", [(), (2, 2)])
def test_periodogram_matches_dsptpu(dtype, onesided, chans):
    """1-D signals, alone or with two channel dims (a matrix is a 2-D
    periodogram in dsptpu: test_2d_periodogram_not_ported)."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((1000,) + chans).astype(dtype)
    win = np.hamming(1000)
    want = dsptpu.periodogram(jnp.asarray(x), onesided=onesided, nfft=1024,
                              fs=2.0, window=win)
    got = dsptpu_torch.periodogram(torch.as_tensor(x), onesided=onesided,
                                   nfft=1024, fs=2.0, window=win)
    check(got.power, want.power, TOL[dtype])
    assert np.array_equal(got.freq, want.freq)


@pytest.mark.parametrize("nfft", [256, 384, 1024])
def test_k3_plain_matches_pallas_interpret(nfft):
    """Both modes; nframes = 13 leaves a ragged last block of TB = 8."""
    rng = np.random.default_rng(nfft)
    hop = 128 * max(1, nfft // 256)       # the kernels take hop % 128 == 0
    nframes = 13
    n = (nframes - 1) * hop + nfft + 37
    x = rng.standard_normal((n, 3)).astype(np.float32)
    win = np.hanning(nfft)
    nb1 = nfft // 2 + 1
    acc = stft_pow_pallas(jnp.asarray(x), win, nfft, hop, nframes,
                          accumulate=True, onesided=True, TB=8,
                          interpret=True)
    want = np.asarray(onesided_bins_from_tile(acc, nfft, nb1))   # (C, nb1)
    got = tstft.stft_pow(torch.as_tensor(x), win, nfft, hop, nframes, True,
                         np.ones(nb1))                             # (nb1, C)
    check(got.T, want, 3e-5)
    tile = stft_pow_pallas(jnp.asarray(x), win, nfft, hop, nframes,
                           accumulate=False, TB=8, interpret=True)
    want = np.asarray(bins_from_tile(tile, nfft, nfft))        # (C, k, nfft)
    got = tstft.stft_pow(torch.as_tensor(x), win, nfft, hop, nframes,
                         False, np.ones(nfft))                 # (nfft, k, C)
    check(got.permute(2, 1, 0), want, 3e-5)
    assert tstft.launches["stft"] == 0


def test_2d_periodogram_not_ported():
    """A matrix is dsptpu's 2-D periodogram (it once raised here); now
    ported: full, radial sum and radial average agree with dsptpu."""
    x = np.random.default_rng(13).standard_normal((64, 48))
    for kw in ({}, dict(radialsum=True), dict(radialavg=True)):
        want = dsptpu.periodogram(jnp.asarray(x), fs=2.0, **kw)
        got = dsptpu_torch.periodogram(torch.as_tensor(x), fs=2.0, **kw)
        check(got.power, want.power, 1e-10)
