"""Port parity for convolution: dsptpu_torch's conv (direct, one padded
FFT, overlap-save; 1-D and 2-D; complex; integer), conv_with_offset,
xcorr, deconv, fftfilt, tdfilt and filt with more than 512 taps against
dsptpu's, and the plain version of K4 (kernels/osconv.osconv_reference,
what the wrapper runs on a CPU tensor) against dsptpu's Pallas
overlap-save kernel in interpret mode.

Inputs come from a numpy seed and go to both packages as explicit
arrays. Tolerances: max|d| <= 1e-10 max|ref| in float64 (dsptpu runs
under x64 here), <= 3e-5 max|ref| in float32 (bench.py's overlap-save
bound), exact for integers; K4's plain version against the Pallas
kernel < 2e-6 (both are float32 FFTs of the same blocks)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import dsptpu
import dsptpu_torch
from dsptpu.kernels.osconv import osconv_pallas
from dsptpu.ops.dspbase import optimal_os_nfft as jax_nfft
from dsptpu_torch import kernels
from dsptpu_torch.kernels import osconv as tos

TOL = {np.float64: 1e-10, np.float32: 3e-5, np.complex128: 1e-10,
       np.complex64: 3e-5}


def check(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.max(np.abs(got.astype(np.complex128) - want))
    assert err <= tol * np.max(np.abs(want)), err


def data(rng, shape, dtype):
    if np.issubdtype(dtype, np.complexfloating):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def both(*arrs):
    return [jnp.asarray(a) for a in arrs], [torch.as_tensor(a) for a in arrs]


@pytest.mark.parametrize("nu,nv", [(10, 3), (700, 100), (3000, 200),
                                   (20000, 1500), (5000, 4096)])
def test_optimal_os_nfft_is_dsptpus(nu, nv):
    assert dsptpu_torch.optimal_os_nfft(nu, nv) == jax_nfft(nu, nv)


@pytest.mark.parametrize("algorithm", ["auto", "direct", "fft",
                                       "fft_overlapsave"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex128])
def test_conv_1d_matches_dsptpu(algorithm, dtype):
    rng = np.random.default_rng(1)
    u, v = data(rng, 3000, dtype), data(rng, 200, dtype)
    (ju, jv), (tu, tv) = both(u, v)
    want = dsptpu.conv(ju, jv, algorithm=algorithm)
    got = dsptpu_torch.conv(tu, tv, algorithm=algorithm)
    assert got.dtype == tu.dtype
    check(got, want, TOL[dtype])


@pytest.mark.parametrize("algorithm", ["direct", "fft_simple",
                                       "fft_overlapsave"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex64])
def test_conv_2d_matches_dsptpu(algorithm, dtype):
    """(600, 40) * (31, 5): overlap-save blocks the first dimension."""
    rng = np.random.default_rng(2)
    u, v = data(rng, (600, 40), dtype), data(rng, (31, 5), dtype)
    (ju, jv), (tu, tv) = both(u, v)
    want = dsptpu.conv(ju, jv, algorithm=algorithm)
    check(dsptpu_torch.conv(tu, tv, algorithm=algorithm), want, TOL[dtype])


def test_conv_integer_is_exact():
    rng = np.random.default_rng(3)
    u = rng.integers(-2 ** 40, 2 ** 40, 300, dtype=np.int64)
    v = rng.integers(-1000, 1000, 17, dtype=np.int64)
    got = dsptpu_torch.conv(torch.as_tensor(u), torch.as_tensor(v))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), np.convolve(u, v))
    want = np.asarray(dsptpu.conv(jnp.asarray(u), jnp.asarray(v)))
    assert np.array_equal(got.numpy(), want)
    u2 = rng.integers(-50, 50, (20, 7), dtype=np.int32)
    v2 = rng.integers(-50, 50, (3, 4), dtype=np.int32)
    want2 = np.asarray(dsptpu.conv(jnp.asarray(u2), jnp.asarray(v2)))
    got2 = dsptpu_torch.conv(torch.as_tensor(u2), torch.as_tensor(v2))
    assert np.array_equal(got2.numpy(), want2)


def test_conv_separable_and_offsets():
    rng = np.random.default_rng(4)
    u, v, A = rng.standard_normal(9), rng.standard_normal(7), \
        rng.standard_normal((30, 20))
    want = dsptpu.conv(jnp.asarray(u), jnp.asarray(v), jnp.asarray(A))
    check(dsptpu_torch.conv(*map(torch.as_tensor, (u, v, A))), want, 1e-10)
    out, off = dsptpu_torch.conv_with_offset(
        torch.as_tensor(A), torch.as_tensor(A[:5, :4]), (2, -1), 3)
    want, woff = dsptpu.conv_with_offset(jnp.asarray(A),
                                         jnp.asarray(A[:5, :4]), (2, -1), 3)
    assert off == woff == (5, 2)
    check(out, want, 1e-10)


@pytest.mark.parametrize("padmode", ["none", "longest"])
@pytest.mark.parametrize("scaling", ["none", "biased"])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_xcorr_matches_dsptpu(padmode, scaling, dtype):
    rng = np.random.default_rng(5)
    u = data(rng, 500, dtype)
    v = data(rng, 500 if scaling == "biased" else 300, dtype)
    (ju, jv), (tu, tv) = both(u, v)
    want = dsptpu.xcorr(ju, jv, padmode=padmode, scaling=scaling)
    got = dsptpu_torch.xcorr(tu, tv, padmode=padmode, scaling=scaling)
    check(got, want, 1e-10)
    check(dsptpu_torch.xcorr(tu), dsptpu.xcorr(ju), 1e-10)


def test_deconv_matches_dsptpu():
    rng = np.random.default_rng(6)
    a = np.array([1.0, -0.5, 0.2])
    c = rng.standard_normal(40)
    b = np.convolve(a, c)
    want = dsptpu.deconv(jnp.asarray(b), jnp.asarray(a))
    got = dsptpu_torch.deconv(torch.as_tensor(b), torch.as_tensor(a))
    check(got, want, 1e-10)
    check(got, c, 1e-10)
    assert dsptpu_torch.deconv(torch.ones(2), torch.ones(3)).shape == (1,)


@pytest.mark.parametrize("n,shape,nb,dtype,nfft", [
    (20000, (3,), 1025, np.float32, None),   # K4 gate: plain K4 on CPU
    (20000, (), 1025, np.float32, None),     # 1-D
    (9000, (2, 2), 700, np.float64, None),   # torch.fft route
    (9000, (2,), 700, np.float32, 1536),     # given nfft, N1 = 12
    (5000, (3,), 100, np.complex64, None),   # complex: torch.fft route
])
def test_fftfilt_matches_dsptpu(n, shape, nb, dtype, nfft):
    rng = np.random.default_rng(n + nb)
    x = data(rng, (n,) + shape, dtype)
    b = data(rng, nb, np.float32 if dtype == np.complex64 else dtype)
    want = dsptpu.fftfilt(jnp.asarray(b), jnp.asarray(x), nfft=nfft)
    kernels.reset_launches()
    got = dsptpu_torch.fftfilt(torch.as_tensor(b), torch.as_tensor(x),
                               nfft=nfft)
    assert got.shape == x.shape and kernels.launch_counts()["osconv"] == 0
    check(got, want, TOL[dtype])


@pytest.mark.parametrize("n,nb,dtype", [(8000, 600, np.float64),
                                        (20000, 2048, np.float32)])
def test_filt_long_taps_matches_dsptpu(n, nb, dtype):
    rng = np.random.default_rng(nb)
    x = rng.standard_normal((n, 2)).astype(dtype)
    b = rng.standard_normal(nb).astype(dtype)
    want = dsptpu.filt(jnp.asarray(b), jnp.asarray(x))
    got = dsptpu_torch.filt(torch.as_tensor(b), torch.as_tensor(x))
    check(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_tdfilt_matches_dsptpu(dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3000, 2)).astype(dtype)
    h = rng.standard_normal(41).astype(dtype)
    want = dsptpu.tdfilt(jnp.asarray(h), jnp.asarray(x))
    check(dsptpu_torch.tdfilt(torch.as_tensor(h), torch.as_tensor(x)), want,
          TOL[dtype])


@pytest.mark.parametrize("n,nv,nfft,C", [(5000, 127, 1024, 1),
                                         (20000, 1025, 4096, 3),
                                         (300, 100, 256, 1)])
def test_k4_plain_matches_pallas_interpret(n, nv, nfft, C):
    assert tos.osconv_supported(nfft, nv, torch.float32)
    rng = np.random.default_rng(n + C)
    u = rng.standard_normal((n, C)).astype(np.float32)
    v = rng.standard_normal(nv).astype(np.float32)
    want = osconv_pallas(jnp.asarray(u[:, 0] if C == 1 else u),
                         jnp.asarray(v), nfft, interpret=True)
    got = tos.osconv(torch.as_tensor(u[:, 0] if C == 1 else u),
                     torch.as_tensor(v), nfft)
    check(got, want, 2e-6)
    assert tos.launches["osconv"] == 0


@pytest.mark.parametrize("nfft,nv,ok", [(16384, 4096, True),
                                        (1024, 127, True),
                                        (384, 200, True),
                                        (256, 200, False),
                                        (32768, 4096, False),
                                        (1000, 127, False)])
def test_k4_gate_is_dsptpus(nfft, nv, ok):
    from dsptpu.kernels.osconv import osconv_supported
    assert osconv_supported(nfft, nv, np.float32) == ok
    assert tos.osconv_supported(nfft, nv, torch.float32) == ok
    assert not tos.osconv_supported(nfft, nv, torch.float64)


@pytest.mark.parametrize("nfft", [256, 384, 640, 1920])
def test_k4_bin_order_covers_every_bin(nfft):
    """The kernel's spectrum order (position k1*M + r holds bin
    k1 + m*bitrev(r)) is a permutation of the nfft bins."""
    perm = tos._perm(nfft)
    assert sorted(perm.tolist()) == list(range(nfft))


def _emulate_k4_frame(z, v, nfft):
    """The arithmetic of csrc/osconv.cu on one complex frame, in numpy
    float64 (each pass vectorized): odd radix-m stage folded into the
    load, decimation in frequency two radix-2 stages at a time, product
    with the spectrum in the kernel's bin order, decimation in time two
    stages at a time, the inverse radix-m stage folded into the store."""
    N = nfft
    M = N & -N
    m, logM, hM = N // M, M.bit_length() - 1, M // 2
    wn = np.exp(-2j * np.pi * np.arange(N) / N)
    tw2 = np.exp(-2j * np.pi * np.arange(hM) / M)
    # per-stage tables: tw[h-1+j] = w_{2h}^j for h < M/2; the first
    # (h = M/2) stage reads tw2 itself
    e = np.arange(hM - 1)
    h_of = 1 << (np.log2(e + 1).astype(int))
    tw = tw2[(e + 1 - h_of) * (hM // h_of)]

    def twid(h, j):
        return tw2[j] if h == hM else tw[h - 1 + j]

    Hp = (np.fft.fft(v, N) / N)[tos._perm(N)]
    e = np.arange(N)
    k1, r = e >> logM, e & (M - 1)
    buf = sum(z[n1 * M + r] * wn[((n1 * M + r) * k1) % N] for n1 in range(m))
    u = np.arange(N // 4)
    uu = u & (M // 4 - 1)

    def quad(inner, span):
        j = uu & (inner - 1)
        return (u >> (logM - 2)) * M + (uu >> (inner.bit_length() - 1)) \
            * span + j, j

    h = hM
    while h >= 2:
        q = h // 2
        i, j = quad(q, 2 * h)
        a0, a1, a2, a3 = (buf[i].copy(), buf[i + q].copy(),
                          buf[i + h].copy(), buf[i + h + q].copy())
        b0, b1 = a0 + a2, a1 + a3
        b2, b3 = (a0 - a2) * twid(h, j), (a1 - a3) * twid(h, j + q)
        buf[i], buf[i + q] = b0 + b1, (b0 - b1) * twid(q, j)
        buf[i + h], buf[i + h + q] = b2 + b3, (b2 - b3) * twid(q, j)
        h //= 4
    b = np.arange(N // 2)
    if h == 1:
        i = (b >> (logM - 1)) * M + (b & (hM - 1)) * 2
        a, c = buf[i].copy(), buf[i + 1].copy()
        buf[i], buf[i + 1] = a + c, a - c
    buf = buf * Hp
    h = 1
    while 2 * h <= hM:
        i, j = quad(h, 4 * h)
        w1 = np.conj(twid(h, j))
        t = buf[i + h] * w1
        b0, b1 = buf[i] + t, buf[i] - t
        t = buf[i + 3 * h] * w1
        b2, b3 = buf[i + 2 * h] + t, buf[i + 2 * h] - t
        t = b2 * np.conj(twid(2 * h, j))
        buf[i], buf[i + 2 * h] = b0 + t, b0 - t
        t = b3 * np.conj(twid(2 * h, j + h))
        buf[i + h], buf[i + 3 * h] = b1 + t, b1 - t
        h *= 4
    if h == hM:
        j = b & (hM - 1)
        i = (b >> (logM - 1)) * M + j
        a, t = buf[i].copy(), buf[i + hM] * np.conj(twid(hM, j))
        buf[i], buf[i + hM] = a + t, a - t
    out = np.arange(N)
    return sum(buf[k * M + (out & (M - 1))] * np.conj(wn[(out * k) % N])
               for k in range(m))


@pytest.mark.parametrize("nfft", [256, 384, 512, 1920])
def test_k4_kernel_arithmetic_is_circular_convolution(nfft):
    """The kernel's transform pipeline on one frame of two real channels
    (z = x_a + i x_b) gives the circular convolution of each with v."""
    rng = np.random.default_rng(nfft)
    xa, xb, v = (rng.standard_normal(nfft), rng.standard_normal(nfft),
                 rng.standard_normal(nfft // 3))
    y = _emulate_k4_frame(xa + 1j * xb, v, nfft)
    circ = lambda s: np.real(np.fft.ifft(np.fft.fft(s) * np.fft.fft(v, nfft)))
    check(y.real, circ(xa), 1e-12)
    check(y.imag, circ(xb), 1e-12)
