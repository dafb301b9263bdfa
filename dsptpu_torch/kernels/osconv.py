"""K4: overlap-save FFT convolution, a hand-written CUDA kernel
(csrc/osconv.cu).

Replaces dsptpu/kernels/osconv.py:osconv_pallas (:267; Pallas `_kernel`
:87, `_osconv_jit` :187). Computes the first `out_len` samples of the
linear convolution of every channel of a real float32 signal u (n, C)
with one real float32 filter v (nv,), by overlap-save blocks of nfft
points: advance L = floor((nfft - nv + 1) / 128) * 128, save region
S = nfft - L >= nv - 1. Frame f covers u[f*L - S, f*L - S + nfft), zero
outside [0, n), and yields the outputs [f*L, f*L + L).

Bound on an H100: the bytes, 4 per input and 4 per output sample
(8 n C in all, 0.38 ms for 10,000,000 x 16). The arithmetic a real FFT
pair and the spectrum product need per frame (about 5 nfft log2 nfft
+ 6 nfft flops per L outputs) is about 60% of that time on the CUDA
cores. The kernel keeps each frame in registers between the forward
transform, the product and the inverse transform (a mixed-radix FFT of
R points per thread, 2-4 exchanges through shared memory per frame), so
each sample crosses device memory about nfft / L times on the way in
and once on the way out: see the design note at the top of
csrc/osconv.cu.

`osconv` launches the kernel for a CUDA tensor and runs
`osconv_reference`, the plain PyTorch version (the same blocks through
torch.fft on unfolded frames), for a CPU tensor. `os_fft` is that
overlap-save for any advance and type; dspbase._conv_os_1d takes it
where K4's gate fails. `launches["osconv"]` counts kernel launches.
"""

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from ..utils.profiling import spanned, table_cache

__all__ = ["osconv", "osconv_reference", "osconv_supported", "os_fft",
           "launches"]

launches = {"osconv": 0}

# dsptpu_osconv(x, Hp, wn, tw2, y, n, C, nfft, M, L, nout, stream)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_void_p]

_spec_cache = {}


def osconv_supported(nfft, nv, dtype):
    """The gate of dsptpu's kernels/osconv.py:osconv_supported: real
    float32, nfft = N1*128 with 2 <= N1 <= 128, and a 128-aligned advance
    L >= 128 with N1 <= 8 L/128."""
    if dtype != torch.float32:
        return False
    if nfft % 128 or not (2 <= nfft // 128 <= 128):
        return False
    L = ((nfft - nv + 1) // 128) * 128
    return L >= 128 and (nfft // 128) <= 8 * (L // 128)


def _advance(nfft, nv):
    return ((nfft - nv + 1) // 128) * 128


def os_fft(u, v, nfft, L, nout):
    """Overlap-save over unfolded frames: u (n, C), v (nv,) of one
    floating type (real or complex), advance L; the first nout samples
    of the linear convolution, (nout, C). One batched torch.fft call
    covers every block of every channel."""
    n, C = u.shape
    S = nfft - L
    K = -(-nout // L)
    total = (K - 1) * L + nfft
    up = F.pad(u.T, (S, max(total - S - n, 0)))        # (C, >= total)
    frames = up.unfold(-1, nfft, L)[:, :K]              # (C, K, nfft)
    if u.dtype.is_complex:
        H = torch.fft.fft(v, n=nfft)
        y = torch.fft.ifft(torch.fft.fft(frames, dim=-1) * H, dim=-1)
    else:
        H = torch.fft.rfft(v, n=nfft)
        y = torch.fft.irfft(torch.fft.rfft(frames, dim=-1) * H, n=nfft,
                            dim=-1)
    y = y[..., S:].reshape(C, K * L)[:, :nout]
    return y.T.contiguous()


def osconv_reference(u, v, nfft, out_len):
    """Plain PyTorch version: the kernel's blocks (advance L aligned to
    128) through torch.fft. u (n, C) float32, v (nv,) float32."""
    return os_fft(u, v, nfft, _advance(nfft, v.shape[0]), out_len)


@table_cache("osconv", lambda nfft, device: (nfft, str(device)))
def _tables(nfft, device):
    """(wn, tw2) float32 twiddles built in float64 on the host:
    wn[e] = exp(-2 pi i e / nfft), e < nfft (the odd radix stage), and
    tw2[j] = exp(-2 pi i j / M), j < M/2, with M the largest power of
    two dividing nfft (the passes' twiddle anchors and the in-register
    DFTs' roots). As (., 2) re/im pairs."""
    M = nfft & -nfft
    wn = np.exp(-2j * np.pi * np.arange(nfft) / nfft)
    tw2 = np.exp(-2j * np.pi * np.arange(M // 2) / M)
    return tuple(torch.as_tensor(
        np.stack([t.real, t.imag], -1).astype(np.float32), device=device)
        for t in (wn, tw2))


def _geometry(M):
    """The kernel's plan of an M-point transform (csrc/osconv.cu,
    `Plan<M>`): R points per thread (T = M / R threads per transform), G
    transforms per block, and the radices of the passes, R for each but
    the last, whose radix r = M / R^(passes - 1) divides R."""
    R = 16 if M <= 256 else 32
    T = M // R
    G = max(1, 256 // T)
    radices, rem = [], M
    while rem > R:
        radices.append(R)
        rem //= R
    radices.append(rem)
    return R, G, radices


def _perm(nfft):
    """Bin of the spectrum at each slot of the kernel's table: slot
    c*M + i*T + t holds what thread t has in register i after its
    forward transform of sub-block c, i.e. position p = t*R + i of the
    decimation-in-frequency output, bin c + m*b(p) with b(p) the
    mixed-radix digit reversal of p (m = nfft / M odd)."""
    M = nfft & -nfft
    m = nfft // M
    R, _, radices = _geometry(M)
    T = M // R
    q = np.arange(M)
    p = (q % T) * R + q // T
    b = np.zeros(M, dtype=np.int64)
    stride, weight = M, 1
    for r in radices:
        stride //= r
        b += ((p // stride) % r) * weight
        weight *= r
    return (np.arange(m)[:, None] + m * b[None, :]).reshape(-1)


def _spectrum(v, nfft):
    """The filter's spectrum H / nfft, in the kernel's bin order, as
    float32 (nfft, 2) re/im pairs: computed once per (filter, nfft) in
    float64 by torch.fft and cached. The cache holds the filter tensor
    itself, so its storage is not reused while the entry lives, and
    checks its version counter, so an in-place change misses."""
    key = (v.data_ptr(), v.shape[0], str(v.device), nfft)
    hit = _spec_cache.get(key)
    if hit is not None and hit[0] is v and hit[1] == v._version:
        return hit[2]
    H = torch.fft.fft(v.double(), n=nfft) / nfft
    idx = torch.as_tensor(_perm(nfft), device=v.device)
    Hp = torch.view_as_real(H[idx]).float().contiguous()
    if len(_spec_cache) > 16:
        _spec_cache.clear()
    _spec_cache[key] = (v, v._version, Hp)
    return Hp


@spanned("kernel.osconv")
def osconv(u, v, nfft, out_len=None):
    """Overlap-save convolution of u (n,) or (n, C) float32 with the
    filter v (nv,) float32 in blocks of nfft points; the first out_len
    (default n + nv - 1) samples, (out_len,) or (out_len, C). Caller
    checks osconv_supported(nfft, len(v), float32)."""
    vec = u.ndim == 1
    u2 = u[:, None] if vec else u
    n, nv = u2.shape[0], v.shape[0]
    nout = n + nv - 1 if out_len is None else min(int(out_len), n + nv - 1)
    if u.device.type == "cpu":
        y = osconv_reference(u2, v, nfft, nout)
        return y[:, 0] if vec else y
    if u.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError("osconv kernel takes float32 signal and filter")
    if u2.ndim != 2 or v.ndim != 1 or v.device != u.device:
        raise ValueError("osconv kernel takes (n,) or (n, C) and a 1-D "
                         "filter on the same device")
    if not osconv_supported(nfft, nv, torch.float32):
        raise ValueError(f"osconv kernel: nfft={nfft} with {nv} taps fails "
                         "the gate (nfft = N1*128, 2 <= N1 <= 128, "
                         "advance >= 128, N1 <= 8 advance/128)")
    xc = u2.contiguous()
    C = xc.shape[1]
    Hp = _spectrum(v, nfft)
    wn, tw2 = _tables(nfft, xc.device)
    y = torch.empty((nout, C), dtype=torch.float32, device=xc.device)
    f = _build.entry("osconv", "dsptpu_osconv", _ARGTYPES)
    err = f(xc.data_ptr(), Hp.data_ptr(), wn.data_ptr(), tw2.data_ptr(),
            y.data_ptr(), n, C, nfft, nfft & -nfft, _advance(nfft, nv),
            nout, _build.stream_of(xc))
    _build.check("osconv", err, "osconv kernel launch")
    launches["osconv"] += 1
    return y[:, 0] if vec else y
