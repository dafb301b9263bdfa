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


# --- numpy emulation of csrc/stft.cu's data movement (float64) --------

ROW = 144       # float2 slots per 128-point row (kRow)


def _bitrev(i, n):
    r = 0
    b = 1
    while b < n:
        r = (r << 1) | (i & 1)
        i >>= 1
        b <<= 1
    return r


def _fft_pow2(a, r128):
    """fft_pow2<N> on a[..., N]: bit reversal, then radix-2 DIT
    butterflies of span len with roots r128[j * (128 / len)] (1 and -i
    exact)."""
    N = a.shape[-1]
    a = a[..., [_bitrev(i, N) for i in range(N)]].copy()
    length = 2
    while length <= N:
        h = length // 2
        m = np.arange(h) * (128 // length)
        w = np.where(m == 32, -1j, np.where(m == 0, 1, r128[m]))
        for i in range(0, N, length):
            u = a[..., i:i + h].copy()
            v = a[..., i + h:i + length] * w
            a[..., i:i + h] = u + v
            a[..., i + h:i + length] = u - v
        length *= 2
    return a


def _dft(a, r128, r1):
    """dft<N1>: radix-2 for a power of two, else the direct DFT with j
    paired with N1 - j and the roots r1[(j k) mod N1]."""
    N = a.shape[-1]
    if N & (N - 1) == 0:
        return _fft_pow2(a, r128)
    H = (N - 1) // 2
    s = {j: a[..., j] + a[..., N - j] for j in range(1, H + 1)}
    d = {j: a[..., j] - a[..., N - j] for j in range(1, H + 1)}
    y = a.copy()
    y[..., 0] = a[..., 0] + sum(s.values())
    if N % 2 == 0:
        y[..., 0] += a[..., N // 2]
        y[..., N // 2] = sum((-1) ** j * a[..., j] for j in range(N))
    for k in range(1, H + 1):
        p = a[..., 0] + (a[..., N // 2] * (-1) ** k if N % 2 == 0 else 0)
        p = p + sum(s[j] * r1[(j * k) % N].real for j in s)
        q = sum(1j * d[j] * r1[(j * k) % N].imag for j in d)
        y[..., k], y[..., N - k] = p + q, p - q
    return y


def _superjob(r, N1):
    """Pass C's super-job r: jobs A = (a1, aa) and B = (b1, ba)."""
    s1, q = r >> 3, r & 7
    if s1 == 0:
        return 0, q, 0, (8 if q == 0 else 16 - q)
    if 2 * s1 <= N1:
        return s1, q, N1 - s1, 15 - q
    return N1 - s1, q + 8, s1, 7 - q


def _emulate_k3_frame(xs, wins, N1, G, base, tabs):
    """One frame of one block: xs (nfft, 2G) real channels, wins (K, nfft),
    the ring offset `base` (a multiple of 128), tables (r1, tw, r128)
    complex. Returns P (2G, nfft) = sum_m |DFT(w_m x_c)|^2 as the
    kernel's threads write it, and checks that every bin is written
    once."""
    r1, tw, r128 = tabs
    nfft = N1 * 128
    T = 8 * N1 * G
    raw = np.empty((nfft, G), complex)        # the ring, as float2 pairs
    slots = (base + np.arange(nfft)) % nfft
    raw[slots] = xs[:, 0::2] + 1j * xs[:, 1::2]
    acc = np.zeros((T, 32))
    tid = np.arange(T)
    g, r = tid % G, tid // G
    for w in wins:
        Z = np.full(N1 * ROW * G, np.nan, complex)
        # pass A: job e = (ga, j2)
        e = np.arange(G * 128)
        ga, j2 = e % G, e // G
        z = np.stack([w[j2 + 128 * j1] * raw[(base + j2 + 128 * j1) % nfft,
                                               ga] for j1 in range(N1)], -1)
        z = _dft(z, r128, r1)
        pos = ((j2 & 7) + 9 * (j2 >> 3)) * G + ga
        for k1 in range(N1):
            Z[pos + k1 * ROW * G] = z[:, k1] * (tw[k1, j2] if k1 else 1)
        # pass B: thread (g, k1 = r >> 3, jb = r & 7), in place; twiddle
        # W_128^(i jb) from the table after the roots
        bjb = r & 7
        zb = ((r >> 3) * ROW + bjb) * G + g
        idx = zb[:, None] + 9 * np.arange(16)[None, :] * G
        a = _fft_pow2(Z[idx], r128)
        a[:, 1:] *= r128[128 + 8 * np.arange(1, 16)[None, :] + bjb[:, None]]
        Z[idx] = a
        assert not np.isnan(Z[idx]).any()
        # pass C: super-job r of pair g
        sj = np.array([_superjob(int(q), N1) for q in r])
        a1, aa, b1, ba = sj.T
        ia = ((a1 * ROW + 9 * aa) * G + g)[:, None] + np.arange(8) * G
        ib = ((b1 * ROW + 9 * ba) * G + g)[:, None] + np.arange(8) * G
        A, B = _fft_pow2(Z[ia], r128), _fft_pow2(Z[ib], r128)
        kb = np.arange(8)
        mA = np.where((r == 0)[:, None], A[:, (8 - kb) & 7], B[:, 7 - kb])
        mB = np.where((r == 0)[:, None], B[:, 7 - kb], A[:, 7 - kb])
        for h, (zz, zm) in enumerate([(A, mA), (B, mB)]):
            acc[:, 8 * h:8 * h + 8] += 0.25 * np.abs(zz + np.conj(zm)) ** 2
            acc[:, 16 + 8 * h:24 + 8 * h] += 0.25 * np.abs(
                zz - np.conj(zm)) ** 2
    # the bin ownership of the store
    P = np.full((2 * G, nfft), np.nan)
    kA = a1[:, None] + N1 * (aa[:, None] + 16 * kb)
    kB = b1[:, None] + N1 * (ba[:, None] + 16 * kb)
    for h, k in enumerate([kA, kB]):
        for ch in range(2):
            assert np.isnan(P[2 * g[:, None] + ch, k]).all()
            P[2 * g[:, None] + ch, k] = acc[:, 16 * ch + 8 * h:
                                         16 * ch + 8 * h + 8]
    assert not np.isnan(P).any()
    return P


def _tables64(N1):
    nfft = 128 * N1
    r1 = np.zeros(16, complex)
    r1[:N1] = np.exp(-2j * np.pi * np.arange(N1) / N1)
    tw = np.exp(-2j * np.pi * np.outer(np.arange(N1), np.arange(128)) / nfft)
    m = np.concatenate([np.arange(128),
                        np.outer(np.arange(16), np.arange(8)).ravel()])
    return r1, tw, np.exp(-2j * np.pi * m / 128)


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("N1", range(2, 17))
def test_k3_index_arithmetic_reproduces_fft(N1, K):
    """The kernel's thread-to-point map, radix split, exchange layout,
    twiddle indices, two-channel separation and bin ownership, emulated
    in float64 for every N1, G pairs (odd and even G) and a ring offset:
    sum over the K windows of |np.fft.fft|^2 within 1e-10."""
    nfft = 128 * N1
    G = min(3 if N1 % 2 else 2, 32 // N1)
    rng = np.random.default_rng(100 * N1 + K)
    xs = rng.standard_normal((nfft, 2 * G))
    wins = rng.uniform(0.1, 1.0, (K, nfft))
    base = 128 * (N1 // 2)
    got = _emulate_k3_frame(xs, wins, N1, G, base, _tables64(N1))
    want = sum(np.abs(np.fft.fft(w[:, None] * xs, axis=0)) ** 2
               for w in wins).T
    assert np.max(np.abs(got - want)) <= 1e-10 * np.max(want)


@pytest.mark.parametrize("N1", range(2, 17))
def test_k3_bin_ownership_and_mirrors(N1):
    """Each super-job's 16 bins, over all 8 N1 super-jobs, are every bin
    of [0, nfft) once (nbins = nfft included), and each element's
    partner holds bin nfft - k (row 0 and nfft/2 with themselves)."""
    nfft = 128 * N1
    seen = []
    kb = np.arange(8)
    for r in range(8 * N1):
        a1, aa, b1, ba = _superjob(r, N1)
        kA = a1 + N1 * (aa + 16 * kb)
        kB = b1 + N1 * (ba + 16 * kb)
        mA = kA[(8 - kb) & 7] if r == 0 else kB[7 - kb]
        mB = kB[7 - kb] if r == 0 else kA[7 - kb]
        assert np.array_equal((nfft - kA) % nfft, mA)
        assert np.array_equal((nfft - kB) % nfft, mB)
        seen += list(kA) + list(kB)
    assert sorted(seen) == list(range(nfft))


@pytest.mark.parametrize("nfft", [256, 384, 1024, 1920, 2048])
def test_k3_host_tables_match_numpy(nfft):
    """_tables: float64 roots and twiddles cast to float32 (r1 zero past
    N1) and the plain version's bin map, against numpy."""
    N1 = nfft // 128
    r1, tw, r128, idx = tstft._tables(nfft, "cpu")
    w1, w2, w3 = _tables64(N1)
    for got, want in [(r1, w1), (tw, w2), (r128, w3)]:
        got = got.numpy().astype(np.float64)
        assert got.dtype == np.float64 and got.shape == want.shape + (2,)
        z = got[..., 0] + 1j * got[..., 1]
        assert np.max(np.abs(z - want)) <= 6e-8
    assert not r1[N1:].any()
    k = np.arange(nfft)
    rows, cols = idx // 128, idx % 128
    mirror = rows != k % N1
    assert np.array_equal(rows, np.where(mirror, N1 - k % N1, k % N1))
    assert np.array_equal(cols, np.where(mirror, 127 - k // N1, k // N1))
    assert (rows <= N1 // 2).all()
