"""Port parity for the spectral path: dsptpu_torch's welch_pgram / stft /
spectrogram / periodogram against dsptpu's, and the plain version of K3
(kernels/stft.stft_pow_reference, what the wrapper runs on a CPU tensor)
against dsptpu's Pallas STFT kernel in interpret mode, decoded from its
tile layout with bins_from_tile / onesided_bins_from_tile. The fused
Welch + STFT op (periodograms._welch_stft_power) against the two ops,
exactly; a numpy emulation of csrc/stft.cu's thread and block layout,
its three modes held to each other.

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
from dsptpu_torch.ops.periodograms import _welch_stft_power
from dsptpu_torch.utils import profiling

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


# --- the fused Welch + STFT op ----------------------------------------


def _two_ops(x, n, nov, nfft, **kw):
    p = dsptpu_torch.welch_pgram(x, n, nov, nfft=nfft, **kw)
    return p, dsptpu_torch.stft(x, n, nov, psdonly=True, nfft=nfft, **kw)


@pytest.mark.parametrize("chans", [(), (1,), (3,), (64,), (2, 2)])
@pytest.mark.parametrize("nfft", [256, 1024, 2048])
def test_welch_stft_power_plain_matches_the_two_ops(nfft, chans):
    """The fused op on a CPU tensor (the fused wrapper's plain version)
    equals welch_pgram and stft(psdonly=True) bit for bit: 13 frames, a
    tail past the last one, a window and fs."""
    hop = nfft // 2
    n = 12 * hop + nfft + 37
    x = torch.as_tensor(np.random.default_rng(nfft).standard_normal(
        (n,) + chans).astype(np.float32))
    win = np.hanning(nfft).astype(np.float32)
    got_p, got_s = _welch_stft_power(x, nfft, nfft - hop, nfft, fs=2.5,
                                     window=win)
    want_p, want_s = _two_ops(x, nfft, nfft - hop, nfft, fs=2.5, window=win)
    assert torch.equal(got_p.power, want_p.power)
    assert np.array_equal(got_p.freq, want_p.freq)
    assert torch.equal(got_s, want_s)
    assert got_s.shape == (nfft // 2 + 1, 13) + chans
    assert tstft.launches["stft_fused"] == 0


@pytest.mark.parametrize("case", ["nfft1000", "complex", "float64",
                                  "no_window"])
def test_welch_stft_power_off_the_gate_is_the_two_ops(case):
    """Gate misses run the two ops: nfft not a multiple of 128, a complex
    or float64 signal; and on the gate, no window (a rectangular one)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((9000, 3)).astype(np.float32)
    n, nfft = (1000, 1000) if case == "nfft1000" else (512, 512)
    if case == "complex":
        x = x + 1j * rng.standard_normal(x.shape).astype(np.float32)
    if case == "float64":
        x = x.astype(np.float64)
    x = torch.as_tensor(x)
    win = None if case == "no_window" else np.hanning(n)
    got_p, got_s = _welch_stft_power(x, n, n // 2, nfft, window=win)
    want_p, want_s = _two_ops(x, n, n // 2, nfft, window=win)
    assert torch.equal(got_p.power, want_p.power)
    assert np.array_equal(got_p.freq, want_p.freq)
    assert torch.equal(got_s, want_s)


def test_welch_stft_power_matches_dsptpu():
    """Against dsptpu's welch_pgram and stft on the same frames."""
    x = np.random.default_rng(21).standard_normal((9000, 3)).astype(
        np.float32)
    win = np.hanning(1024).astype(np.float32)
    p, s = _welch_stft_power(torch.as_tensor(x), 1024, 512, 1024,
                             window=win)
    want_p = dsptpu.welch_pgram(jnp.asarray(x), 1024, 512, nfft=1024,
                                window=jnp.asarray(win))
    want_s = dsptpu.stft(jnp.asarray(x), 1024, 512, psdonly=True,
                         nfft=1024, window=jnp.asarray(win))
    check(p.power, want_p.power, 3e-5)
    check(s, want_s, 3e-5)


@pytest.mark.parametrize("gate", [True, False])
def test_welch_stft_power_spans(gate):
    """One span `welch_stft` a call: on the gate one fused wrapper call
    under it, off it the two ops' spans."""
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (5000, 2)).astype(np.float32))
    nfft = 256 if gate else 200
    profiling.reset()
    profiling.tracing(True)
    try:
        _welch_stft_power(x, nfft, nfft // 2, nfft, window=np.hanning(nfft))
    finally:
        profiling.tracing(False)
    names = [r[3] for r in profiling.spans()]
    assert names == (["welch_stft", "kernel.stft"] if gate
                     else ["welch_stft", "welch_pgram", "stft"])


def test_fused_wrapper_plain_matches_both_modes():
    """stft_pow_fused on a CPU tensor: stft_pow's per-frame and summed
    outputs, exactly, with scales of their own."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((7000, 5)).astype(np.float32))
    win = rng.uniform(0.1, 1.0, 384)
    sf, ss = rng.uniform(0.5, 2.0, 193), rng.uniform(0.5, 2.0, 193)
    k = (7000 - 384) // 128 + 1
    frames, summed = tstft.stft_pow_fused(x, win, 384, 128, k, sf, ss)
    assert torch.equal(frames, tstft.stft_pow(x, win, 384, 128, k, False,
                                              sf))
    assert torch.equal(summed, tstft.stft_pow(x, win, 384, 128, k, True,
                                              ss))


# --- the kernel's three modes, emulated over blocks of frames ---------


def _plan(N1, C, nframes, slots):
    """plan_launch's split on a card with `slots` resident blocks (SMs x
    occupancy): (G, groups, fpb, nfb)."""
    pairs = (C + 1) // 2
    G = min(32 // N1, pairs)
    groups = -(-pairs // G)
    nfb = max(1, min(nframes, slots // groups))
    fpb = -(-nframes // nfb)
    return G, groups, fpb, -(-nframes // fpb)


def _emulate_k3(x, win, N1, hop, nframes, nbins, scale, mode, slots,
                scale_sum=None):
    """stft_kernel (mode "frames" or "sum") or stft_fused_kernel
    ("fused") and the reduce pass over plan_launch's blocks, one window:
    each frame's power in float32 as pass C leaves it, the per-frame
    store, the running sums in float32 in frame order, part[blk] and
    the second pass in block order. Returns (frames (nbins, nframes, C)
    or None, summed (nbins, C) or None); every element written once."""
    n, C = x.shape
    nfft = 128 * N1
    G, groups, fpb, nfb = _plan(N1, C, nframes, slots)
    tabs = _tables64(N1)
    f32 = np.float32
    frames = np.full((nbins, nframes, C), np.nan, f32)
    part = np.full((nfb, nbins, C), np.nan, f32)
    for by in range(groups):
        cs = np.arange(2 * G) + 2 * G * by
        live = cs < C
        for bx in range(nfb):
            acc = np.zeros((2 * G, nbins), f32)
            for f in range(bx * fpb, min(nframes, (bx + 1) * fpb)):
                t = f * hop + np.arange(nfft)
                xs = np.zeros((nfft, 2 * G))
                xs[np.ix_(t < n, live)] = x[np.ix_(t[t < n], cs[live])]
                p = _emulate_k3_frame(xs, win[None], N1, G, (f * hop) % nfft,
                                      tabs)[:, :nbins].astype(f32)
                if mode == "frames":
                    acc = np.zeros_like(acc)
                    acc += p
                    out = acc
                else:
                    out = p
                    acc += p
                if mode != "sum":
                    assert np.isnan(frames[:, f, cs[live]]).all()
                    frames[:, f, cs[live]] = (out * scale).T[:, live]
            if mode != "frames":
                assert np.isnan(part[bx][:, cs[live]]).all()
                part[bx][:, cs[live]] = acc.T[:, live]
    summed = None
    if mode != "frames":
        assert not np.isnan(part).any()
        s = np.zeros((nbins, C), f32)
        for b in range(nfb):
            s += part[b]
        summed = s * (scale if mode == "sum" else scale_sum)[:, None]
    if mode == "sum":
        return None, summed
    assert not np.isnan(frames).any()
    return frames, summed


# (N1, C, nframes, hop, slots): ragged last blocks (7 frames in runs of
# 2, 5 in runs of 3), one block, one frame a block, hop = nfft, odd C
# (a zero imaginary channel) and two channel groups
FUSED_CASES = [(2, 3, 7, 128, 6), (8, 9, 5, 512, 4), (3, 2, 6, 384, 4),
               (4, 1, 3, 512, 1), (5, 4, 4, 640, 8), (2, 64, 3, 128, 200)]


@pytest.mark.parametrize("N1,C,nframes,hop,slots", FUSED_CASES)
def test_k3_fused_mode_emulation_matches_both_modes(N1, C, nframes, hop,
                                                    slots):
    """The fused mode's per-frame store equals the per-frame mode's and
    its block partials and second pass the summed mode's, bit for bit
    in float32, under plan_launch's split; both against numpy's FFT."""
    nfft = 128 * N1
    nbins = nfft // 2 + 1 if N1 % 2 == 0 else nfft
    rng = np.random.default_rng(N1 * 100 + C)
    n = (nframes - 1) * hop + nfft - 61       # the last frame runs past n
    x = rng.standard_normal((n, C))
    win = rng.uniform(0.1, 1.0, nfft)
    sf = rng.uniform(0.5, 2.0, nbins).astype(np.float32)
    ss = rng.uniform(0.5, 2.0, nbins).astype(np.float32)
    args = (x, win, N1, hop, nframes, nbins)
    fr, su = _emulate_k3(*args, sf, "fused", slots, scale_sum=ss)
    fr_alone, _ = _emulate_k3(*args, sf, "frames", slots)
    _, su_alone = _emulate_k3(*args, ss, "sum", slots)
    assert np.array_equal(fr, fr_alone)
    assert np.array_equal(su, su_alone)
    xp = np.zeros(((nframes - 1) * hop + nfft, C))
    xp[:n] = x
    segs = np.stack([xp[f * hop:f * hop + nfft] for f in range(nframes)])
    pw = np.abs(np.fft.fft(segs * win[None, :, None], axis=1))[:, :nbins]
    pw = (pw ** 2).transpose(1, 0, 2)                    # (nbins, k, C)
    tol = 1e-6 * pw.max()
    assert np.abs(fr - sf[:, None, None] * pw).max() <= tol
    assert np.abs(su - ss[:, None] * pw.sum(1)).max() <= tol * nframes
