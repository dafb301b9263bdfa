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


# one nfft per M template of csrc/osconv.cu (M = 128 ... 16384; M = 128
# only with an odd factor) and odd-m sizes (m = 3, 5, 15, 127)
K4_SIZES = [384, 256, 512, 1024, 2048, 4096, 8192, 16384, 640, 1920,
            16256]


@pytest.mark.parametrize("nfft", K4_SIZES)
def test_k4_bin_order_covers_every_bin(nfft):
    """The kernel's spectrum table order (slot c*M + i*T + t: register i
    of thread t after the forward transform of sub-block c) is a
    permutation of the nfft bins."""
    perm = tos._perm(nfft)
    assert sorted(perm.tolist()) == list(range(nfft))


def _reg_dft(a, roots, inverse=False):
    """The kernel's in-register DFT along the last axis (N points, a
    power of two): bit reversal, then radix-2 decimation-in-time stages
    with the roots W_N^j = roots[j R / N] (roots[e] = W_R^e, constants
    in the kernel's code); the inverse as conj(dft(conj(a)))."""
    if inverse:
        return np.conj(_reg_dft(np.conj(a), roots))
    N = a.shape[-1]
    bits = N.bit_length() - 1
    rev = [int(format(i, f"0{bits}b")[::-1], 2) if bits else 0
           for i in range(N)]
    a = a[..., rev].copy()
    step = len(roots) * 2 // N       # roots holds W_Rmax^j, j < Rmax/2
    ln = 2
    while ln <= N:
        for i in range(0, N, ln):
            for j in range(ln // 2):
                w = roots[j * step * (N // ln)]
                u, v = a[..., i + j].copy(), a[..., i + j + ln // 2] * w
                a[..., i + j], a[..., i + j + ln // 2] = u + v, u - v
        ln *= 2
    return a


def _emulate_k4_frame(z, v, nfft):
    """The arithmetic of csrc/osconv.cu on one complex frame, in numpy
    float64, the T threads of one transform as the rows of a (T, R)
    register array: nfft = m M with m odd; per sub-block c < m the
    radix-m stage folded into the load, P passes of a mixed-radix
    decimation in frequency (R-point DFTs in registers, twiddles from the
    two anchors W^lo and W^(A lo) by chained products, an exchange
    through the padded shared layout between passes), the product with
    the spectrum in the table order of _perm, the mirrored inverse from
    the same registers, and the inverse radix-m stage folded into the
    store."""
    N = nfft
    M = N & -N
    m = N // M
    R, _, radices = tos._geometry(M)
    T, P, A = M // R, len(radices), R // 4
    wn = np.exp(-2j * np.pi * np.arange(N) / N)
    tw2 = np.exp(-2j * np.pi * np.arange(M // 2) / M)
    roots = tw2[:: M // R]                   # W_R^j, j < R/2
    strides = [M]
    for r in radices:
        strides.append(strides[-1] // r)
    t = np.arange(T)[:, None]
    n = np.arange(R)[None, :]

    def pos(j):
        """Frame position of register n of thread t in pass j (1-based):
        the pass's digit varies along n; the last pass holds R
        consecutive positions (R / r groups of r)."""
        if j == P:
            return t * R + n
        hi, lo = t // strides[j], t % strides[j]
        return hi * strides[j - 1] + n * strides[j] + lo

    def twiddle(a, j, inverse):
        lo = (t % strides[j])[:, 0]
        e = lo * (M // strides[j - 1])
        w1, wa = tw2[e], tw2[A * e]
        pw = np.stack([w1 ** b for b in range(A)], 1)     # products in the
        pa = np.stack([wa ** q for q in range(R // A)], 1)  # kernel
        w = pa[:, n[0] // A] * pw[:, n[0] % A]
        return a * (np.conj(w) if inverse else w)

    def exchange(a, j_from, j_to):
        buf = np.zeros(M + M // R, complex)
        pf, pt = pos(j_from), pos(j_to)
        buf[pf + pf // R] = a
        return buf[pt + pt // R]

    def last_pass(a, inverse):
        r = radices[-1]
        g = a.reshape(T, R // r, r)
        return _reg_dft(g, roots, inverse).reshape(T, R)

    Hs = (np.fft.fft(v, N) / N)[tos._perm(N)]
    res = np.zeros(N, complex)
    for c in range(m):
        r0 = n * strides[1] + t                    # load layout = pass 1
        a = sum(z[n1 * M + r0] * wn[((n1 * M + r0) * c) % N]
                for n1 in range(m))
        for j in range(1, P):
            if j > 1:
                a = exchange(a, j - 1, j)
            a = twiddle(_reg_dft(a, roots), j, False)
        if P > 1:
            a = exchange(a, P - 1, P)
        a = last_pass(a, False)
        a = a * Hs[c * M + n * T + t]
        a = last_pass(a, True)
        for j in range(P - 1, 0, -1):
            a = exchange(a, j + 1, j)
            a = _reg_dft(twiddle(a, j, True), roots, True)
        res[c * M + r0] = a
    out = np.arange(N)
    return sum(res[k * M + (out & (M - 1))] * np.conj(wn[(out * k) % N])
               for k in range(m))


@pytest.mark.parametrize("nfft", K4_SIZES)
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


def _first_pass_slot(M, t, i):
    """csrc/osconv.cu's slot_base<M, 1>(t) + slot_off<M, 1>(i) at G = 1:
    the exchange slot from which thread t loads register i."""
    R, _, _ = tos._geometry(M)
    T = M // R
    S1 = T                                    # stride(1) = M / R
    if S1 >= R:
        base = t + t // R                     # hi = 0, lo = t
        off = i * (S1 + S1 // R)
    else:
        base = t
        off = i * S1 + i * S1 // R
    return base + off


def _emulate_k4_cluster(n, C, nv, nfft, nout):
    """The index maps of csrc/osconv.cu's cluster instance, in numpy, over
    every job (frame f, channel group q) of a call: the staging (rank k
    reads frame rows [k M/4, (k + 1) M/4), lane pairs on a row, lane t
    16 bytes, pairs 2 (t & 1) and 2 (t & 1) + 1 of the group, into the
    owners' buffers at slot p + p / R), each owner thread's register loads
    (slot_base<M, 1> + slot_off<M, 1>) and the gather (rank k stores
    output rows [k L/4, (k + 1) L/4), lane j of a warp row (j >> 5) 16 +
    (j & 15), half (j >> 4) & 1). Every word is tagged by its source:
    1 + row * C + channel of x, 0 outside [0, n). Returns, per job, what
    each owner's registers hold and the tags of the stored outputs."""
    M = nfft
    R, _, _ = tos._geometry(M)
    T = THREADS = M // R
    QR = M // 4
    LOADS = 2 * QR // THREADS
    L = tos._advance(nfft, nv)
    S = M - L
    K = -(-nout // L)
    groups = C // 8
    Lq = L // 4
    y = np.zeros((nout, C), np.int64)
    stores = np.zeros((nout, C), np.int64)
    regs = []
    t = np.arange(THREADS)
    u = np.arange(LOADS)[:, None]
    for J in range(groups * K):
        f, q = J // groups, J % groups
        buf = np.zeros((4, M + M // R, 2), np.int64)
        hits = np.zeros((4, M + M // R), np.int64)
        for rank in range(4):
            hh = t & 1
            pl = (u * THREADS + t) >> 1                 # (LOADS, THREADS)
            p = rank * QR + pl
            g = f * L - S + p
            inside = (g >= 0) & (g < n)
            for k in range(2):                          # o0, o1
                owner = np.broadcast_to(2 * hh + k, p.shape)
                for part in range(2):
                    c = 8 * q + 4 * hh + 2 * k + part
                    buf[owner, p + p // R, part] = np.where(
                        inside, 1 + g * C + c, 0)
                np.add.at(hits, (owner, p + p // R), 1)
        got = np.stack([buf[:, _first_pass_slot(M, t, i)]
                        for i in range(R)], 1)          # (4, R, T, 2)
        regs.append((f, q, got, hits))
        # the owners' outputs in register order: row i T + t at i T + t
        out = got.transpose(0, 2, 1, 3)                 # (4, T, R, 2)
        frame = np.zeros((4, M, 2), np.int64)
        frame[:, (np.arange(R)[None, :] * T + t[:, None])] = out
        for rank in range(4):
            j = np.arange(2 * Lq)
            row = (j >> 5) * 16 + (j & 15)
            hh = (j >> 4) & 1
            r0 = rank * Lq
            o = f * L + r0 + row
            ok = row < nout - f * L - r0
            for k in range(2):
                for part in range(2):
                    c = 8 * q + 4 * hh[ok] + 2 * k + part
                    y[o[ok], c] = frame[2 * hh[ok] + k, S + r0 + row[ok],
                                        part]
                    np.add.at(stores, (o[ok], c), 1)
    return L, S, regs, y, stores


@pytest.mark.parametrize("out", ["full", "n"])
@pytest.mark.parametrize("C", [8, 16, 24, 32])
@pytest.mark.parametrize("nfft", [8192, 16384])
def test_k4_cluster_index_maps(nfft, C, out):
    """Every (row, channel) of every frame lands exactly once in the
    first-pass register of its owner that reads it (thread t, register i:
    frame row i T + t, pair 4q + owner), rows outside [0, n) read zero,
    and every valid output is stored exactly once, from the frame row and
    channel it belongs to."""
    n, nv = 2 * nfft + 1237, 4096 if nfft == 16384 else 1025
    nout = n + nv - 1 if out == "full" else n
    L, S, regs, y, stores = _emulate_k4_cluster(n, C, nv, nfft, nout)
    M = nfft
    R, _, _ = tos._geometry(M)
    T = M // R
    rows = np.arange(R)[:, None] * T + np.arange(T)[None, :]
    for f, q, got, hits in regs:
        slots = rows + rows // R
        assert (hits[:, slots] == 1).all() and hits.sum() == 4 * M
        g = f * L - S + rows
        inside = (g >= 0) & (g < n)
        for k in range(4):
            for part in range(2):
                c = 8 * q + 2 * k + part
                want = np.where(inside, 1 + g * C + c, 0)
                assert np.array_equal(got[k, :, :, part], want)
    assert (stores == 1).all()
    o = np.arange(nout)[:, None]       # output o is frame row S + o - f L
    assert np.array_equal(y, np.where(o < n, 1 + o * C + np.arange(C), 0))


@pytest.mark.parametrize("nfft,C,xoff,yoff,nout,want", [
    (16384, 16, 0, 0, 10_000_000, True),    # path A
    (16384, 8, 0, 0, 70_000, True),
    (8192, 24, 0, 0, 70_000, True),
    (8192, 32, 0, 0, 70_000, True),
    (16384, 1, 0, 0, 70_000, False),        # C % 8 != 0
    (16384, 2, 0, 0, 70_000, False),
    (16384, 3, 0, 0, 70_000, False),
    (16384, 17, 0, 0, 70_000, False),
    (8192, 12, 0, 0, 70_000, False),
    (4096, 16, 0, 0, 70_000, False),        # M <= 4096: G >= 2
    (2048, 32, 0, 0, 70_000, False),
    (12288, 16, 0, 0, 70_000, False),       # odd m (3 x 4096)
    (16256, 16, 0, 0, 70_000, False),       # odd m (127 x 128)
    (16384, 16, 4, 0, 70_000, False),       # view at a 4-byte offset
    (16384, 16, 8, 0, 70_000, False),
    (16384, 16, 0, 4, 70_000, False),       # unaligned output
    (16384, 16, 0, 0, 2 ** 31, False),      # frame rows past an int32
])
def test_k4_cluster_route_choice(nfft, C, xoff, yoff, nout, want):
    L = tos._advance(nfft, 4096 if nfft >= 8192 else 127)
    assert tos.cluster_route(nfft, C, nout, L, 1 << 20 | xoff,
                             1 << 24 | yoff) == want
