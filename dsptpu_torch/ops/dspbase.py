"""FIR/IIR `filt` on torch tensors: the filt half of dsptpu/ops/dspbase.py.

Same routing and gates as the reference, along axis 0 with trailing
channel dims:
  * short/medium real taps on a long float32 signal (n >= 32768,
    n >= 4 nb, nb <= 512) go through K1, the hand-written FIR kernel
    (kernels/fir.py);
  * other short/medium taps run as a block-Toeplitz matrix product
    (filters/stream_filt._block_matmul);
  * short signals (n < 4 nb) run as a convolution, with TF32 off;
  * taps longer than 512 take the overlap-save route (_conv_os_1d):
    K4, the hand-written overlap-save kernel (kernels/osconv.py), where
    its gate holds, else batched torch.fft frames;
  * (b, a) filters with a stable denominator run through the block
    state-space pass of filters/filt.py (K2); others through the
    sequential transposed direct-form II recurrence.

conv / conv_with_offset / xcorr / deconv follow dsptpu's routing too:
direct convolution (F.conv1d/2d/3d with TF32 off; exact integer
shift-and-add), one padded FFT, or overlap-save (1-D through
_conv_os_1d, N-D through _conv_os_nd), chosen by the reference's cost
model (optimal_os_nfft, copied with its TPU cost terms so that the port
picks the same FFT size and block boundaries).

Device rule: a tensor argument stays on its device; a numpy array or a
list goes to `device=` (default "cuda", which must be present).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import as_tensor, no_tf32
from ..utils.fftutil import fftintype
from ..utils.profiling import spanned

__all__ = ["filt", "conv", "conv_with_offset", "deconv", "xcorr",
           "optimal_os_nfft"]

# Crossover between direct and FFT convolution, in units of
# len(u)*len(v) (dsptpu's _CONV_DIRECT_CUTOFF)
_CONV_DIRECT_CUTOFF = 1 << 18

# FIR tap count above which filt() switches to overlap-save FFTs
# (dsptpu's _FIR_OS_CUTOFF)
_FIR_OS_CUTOFF = 512


def _as_1d(c, name, device=None):
    c = as_tensor(c, device)
    if c.ndim == 0:
        c = c[None]
    if c.ndim != 1:
        raise ValueError(f"{name} must be a scalar or 1-D array")
    return c


def _flatten_channels(x):
    """(n, *chans) -> (n, C), plus a restore function."""
    shape = x.shape
    flat = x.reshape(shape[0], -1) if x.ndim > 1 else x[:, None]

    def restore(y):
        return y.reshape((y.shape[0],) + tuple(shape[1:]))
    return flat, restore


def _float_type(*dtypes):
    dtype = dtypes[0]
    for d in dtypes[1:]:
        dtype = torch.promote_types(dtype, d)
    if not (dtype.is_floating_point or dtype.is_complex):
        dtype = torch.promote_types(dtype, torch.float32)
    return dtype


# ---------------------------------------------------------------------------
# FIR as a convolution and as a block-Toeplitz product
# ---------------------------------------------------------------------------

def _fir_causal(b, x):
    """Causal FIR along axis 0 of x (n, C): y[n] = sum_k b[k] x[n-k]."""
    n, C = x.shape
    nb = b.shape[0]
    if x.is_complex() or b.is_complex():
        # real convolutions only: expand the complex product
        xr = x.real
        xi = x.imag if x.is_complex() else torch.zeros_like(x)
        br = b.real
        bi = b.imag if b.is_complex() else torch.zeros_like(b)
        rr = _fir_causal(br, xr) - _fir_causal(bi, xi)
        ii = _fir_causal(br, xi) + _fir_causal(bi, xr)
        return torch.complex(rr, ii)
    dtype = _float_type(b.dtype, x.dtype)
    lhs = F.pad(x.T[:, None, :].to(dtype), (nb - 1, 0))  # (C, 1, n+nb-1)
    rhs = b.flip(0)[None, None, :].to(dtype)              # (1, 1, nb)
    with no_tf32():
        out = F.conv1d(lhs, rhs)
    return out[:, 0, :].T


def _fir_block_toeplitz(b, x):
    """Causal FIR as a block-Toeplitz matmul: outputs in blocks of T,
    block b multiplying the (T + nb - 1, T) banded tap matrix against
    its input window. x: (n, C) real."""
    from ..filters.stream_filt import _block_matmul
    nb = b.shape[0]
    n, C = x.shape
    T = min(1024, max(512, -(-2 * nb // 128) * 128))
    W = T + nb - 1
    # banded Toeplitz G[w, t] = b[nb-1-w+t] (0 <= w-t < nb): c has
    # period W+1, so row t of the (T, W) reshape is c shifted right by t
    c = torch.cat([b.flip(0).to(x.dtype),
                   torch.zeros(T, dtype=x.dtype, device=x.device)])
    G = c.repeat(T)[: T * W].reshape(T, W).T
    xcat = torch.cat([torch.zeros((nb - 1, C), dtype=x.dtype,
                                  device=x.device), x], 0)
    B = -(-n // T)
    return _block_matmul(xcat, G, 0, B, T, W, n)


# ---------------------------------------------------------------------------
# filt
# ---------------------------------------------------------------------------

@spanned("filt")
def filt(b, a, x=None, si=None, device=None):
    """Filter x along axis 0 with the IIR/FIR filter described by
    coefficient vectors b (numerator) and a (denominator).

    `filt(b, x)` is FIR shorthand for `filt(b, 1, x)`. Transposed
    direct-form II semantics including a[0] normalization. `si`
    optionally supplies the initial state (shape
    (max(len(a),len(b))-1, *channels)); when given, the final state is
    returned as a second output."""
    if x is None:
        b, a, x = b, None, a
    x = as_tensor(x, device)
    b = _as_1d(b, "b", x.device)
    if x.shape[0] == 0:
        raise ValueError("input must be nonempty")

    a_arr = None if a is None else as_tensor(a, x.device)
    if a_arr is None or a_arr.ndim == 0 or a_arr.numel() == 1:
        # pure FIR: normalize by a0 if given
        if a_arr is not None:
            b = b / a_arr.reshape(-1)[0]
        if si is None:
            flat, restore = _flatten_channels(x)
            nb, n = b.shape[0], flat.shape[0]
            rtype = torch.promote_types(b.dtype, flat.dtype)
            inexact = rtype.is_floating_point or rtype.is_complex
            cplx = flat.is_complex() or b.is_complex()
            if inexact and nb > _FIR_OS_CUTOFF and n > nb:
                # long taps: overlap-save FFTs (K4 where its gate holds)
                return restore(_conv_os_1d(flat, b, out_len=n)[:n])
            if inexact and not cplx and 1 < nb and n >= 4 * nb:
                if n >= 32768 and rtype == torch.float32:
                    from ..kernels.fir import fir, fir_supported
                    if fir_supported(nb, torch.float32):
                        return restore(fir(flat.to(torch.float32),
                                           b.to(torch.float32)))
                return restore(_fir_block_toeplitz(b, flat))
            return restore(_fir_causal(b, flat))
        a = torch.ones((1,), dtype=b.dtype, device=b.device)

    a = _as_1d(a, "a", x.device)
    return _filt_iir(b, a, x, si)


def _filt_iir(b, a, x, si=None):
    sz = max(a.shape[0], b.shape[0]) - 1
    dtype = _float_type(b.dtype, a.dtype, x.dtype)
    # Fast path: real *stable* coefficients run through the blocked
    # parallel recurrence (host tables, filters/filt.py) instead of the
    # sequential per-sample recurrence. Unstable denominators keep the
    # sequential form: their transition powers overflow.
    fast = None
    if sz > 0 and not (b.is_complex() or a.is_complex()):
        bh = b.detach().cpu().numpy().astype(np.float64)
        ah = a.detach().cpu().numpy().astype(np.float64)
        roots = np.roots(ah / ah[0]) if len(ah) > 1 else np.zeros(0)
        if len(roots) == 0 or np.max(np.abs(roots)) < 1.0 - 1e-9:
            fast = (bh, ah)
    if fast is not None:
        from ..filters.filt import _affine_apply
        bh, ah = fast
        scale = ah[0]
        bp = np.zeros(sz + 1)
        bp[: len(bh)] = bh / scale
        ap = np.zeros(sz + 1)
        ap[: len(ah)] = ah / scale
        flat, restore = _flatten_channels(x.to(dtype))
        z0 = (torch.zeros((sz, flat.shape[1]), dtype=dtype, device=x.device)
              if si is None else
              as_tensor(si, x.device).to(dtype).reshape(sz, flat.shape[1]))
        y, zf = _affine_apply(bp, ap, flat, z0)
        y = restore(y)
        if si is not None:
            return y, zf.reshape((sz,) + tuple(x.shape[1:]))
        return y
    a = a.to(dtype)
    b = b.to(dtype)
    b = b / a[0]
    a = a / a[0]
    bp = torch.zeros(sz + 1, dtype=dtype, device=x.device)
    bp[: b.shape[0]] = b
    ap = torch.zeros(sz + 1, dtype=dtype, device=x.device)
    ap[: a.shape[0]] = a

    flat, restore = _flatten_channels(x.to(dtype))
    C = flat.shape[1]
    if si is None:
        z = torch.zeros((sz, C), dtype=dtype, device=x.device)
    else:
        z = as_tensor(si, x.device).to(dtype).reshape(sz, C)

    b_tail = bp[1:][:, None]   # (sz, 1)
    a_tail = ap[1:][:, None]
    b0 = bp[0]
    ys = []
    for xt in flat:
        # transposed DF-II update, vectorized over channels
        yt = b0 * xt + z[0]
        z_shift = torch.cat([z[1:], torch.zeros((1, C), dtype=dtype,
                                                device=x.device)], 0)
        z = z_shift + b_tail * xt[None, :] - a_tail * yt[None, :]
        ys.append(yt)
    y = restore(torch.stack(ys))
    if si is not None:
        return y, z.reshape((sz,) + tuple(x.shape[1:]))
    return y


# ---------------------------------------------------------------------------
# deconv
# ---------------------------------------------------------------------------

def deconv(b, a, device=None):
    """Polynomial division: c with b = conv(a, c) + r."""
    b = _as_1d(b, "b", _device_of(device, b, a))
    a = _as_1d(a, "a", b.device)
    dtype = torch.promote_types(b.dtype, a.dtype)
    if b.shape[0] < a.shape[0]:
        return torch.zeros(1, dtype=dtype, device=b.device)
    delta = torch.zeros(b.shape[0] - a.shape[0] + 1, dtype=dtype,
                        device=b.device)
    delta[0] = 1
    return filt(b, a, delta)


# ---------------------------------------------------------------------------
# conv
# ---------------------------------------------------------------------------

def _device_of(device, *vals):
    """The device of the first tensor among vals, else `device`."""
    for v in vals:
        if isinstance(v, torch.Tensor):
            return v.device
    return device


# host copies of dsptpu/ops/mxfft.py's size helpers: optimal_os_nfft's
# cost model reads them (the port's FFTs are torch.fft and K4)
_MX_MIN_N = 8192
_MX_MAX_FACTOR = 512


def _mx_split(n):
    """n = L1 * L2 with both factors pow2 and as square as possible."""
    l1 = 1 << ((n.bit_length() - 1) // 2)
    return l1, n // l1


def _mx_supported(n):
    if n < _MX_MIN_N or n & (n - 1):
        return False
    l1, l2 = _mx_split(n)
    return l1 <= _MX_MAX_FACTOR and l2 <= _MX_MAX_FACTOR


def optimal_os_nfft(nu, nv):
    """Overlap-save FFT size minimizing cost per output sample, over
    powers of two: dsptpu's cost model, copied as it is (its terms were
    measured on a TPU; the port keeps them so that it picks the same
    nfft, and with it the same block boundaries, as the reference)."""
    first = max(2 * nv, 8)
    nfft = 1 << (first - 1).bit_length()
    best, best_cost = nfft, None
    n = nfft
    while n <= 4 * (nu + nv - 1):
        L = n - nv + 1
        if L > 0:
            if nv >= 2048 and _mx_supported(n):
                l1, l2 = _mx_split(n)
                cost = (n * (l1 + l2) / 24.0) / L
            else:
                cost = (n * (math.log2(n) + 3)) / L
            if best_cost is None or cost < best_cost:
                best, best_cost = n, cost
        n *= 2
    return best


def _conv_fft_simple(u, v, outsize):
    """Full convolution through one padded FFT per operand. N-D."""
    dtype = fftintype(torch.promote_types(u.dtype, v.dtype))
    nffts = tuple(1 << (s - 1).bit_length() for s in outsize)
    dims = tuple(range(len(outsize)))
    if dtype.is_complex:
        uf = torch.fft.fftn(u.to(dtype), s=nffts, dim=dims)
        vf = torch.fft.fftn(v.to(dtype), s=nffts, dim=dims)
        out = torch.fft.ifftn(uf * vf, dim=dims)
    else:
        uf = torch.fft.rfftn(u.to(dtype), s=nffts, dim=dims)
        vf = torch.fft.rfftn(v.to(dtype), s=nffts, dim=dims)
        out = torch.fft.irfftn(uf * vf, s=nffts, dim=dims)
    return out[tuple(slice(0, s) for s in outsize)].to(dtype)


def _conv_os_1d(u, v, nfft=None, out_len=None):
    """Overlap-save convolution along axis 0: u the long input (n,
    *chans), v the 1-D filter; the first out_len samples (default the
    full linear convolution, n + nv - 1).

    Real float32 input takes K4 (kernels/osconv.py) where dsptpu's gate
    `osconv_supported` holds for nfft. Otherwise every block of every
    channel goes through one batched torch.fft call (dsptpu's mxfft
    four-step matmul FFT has no module of its own in the port: its
    counterpart is torch.fft, cuFFT on the card), with the reference's
    block advance: L = nfft - nv + 1, cut to a multiple of 128 when
    L >= 256."""
    from ..kernels.osconv import os_fft, osconv, osconv_supported
    nu, nv = u.shape[0], v.shape[0]
    nout = nu + nv - 1 if out_len is None else min(out_len, nu + nv - 1)
    dtype = fftintype(torch.promote_types(u.dtype, v.dtype))
    if nfft is None:
        nfft = optimal_os_nfft(nu, nv)
    elif nfft < nv:
        raise ValueError("nfft must be at least the filter length")
    flat = u.reshape(nu, -1).to(dtype)
    if osconv_supported(nfft, nv, dtype):
        y = osconv(flat, v.to(dtype), nfft, nout)
        return y.reshape((nout,) + tuple(u.shape[1:]))
    L = nfft - nv + 1
    if L >= 256:
        L = (L // 128) * 128
    y = os_fft(flat, v.to(dtype), nfft, L, nout)
    return y.reshape((nout,) + tuple(u.shape[1:]))


def _os_frames_axis(x, K, L, W, axis):
    """Overlapped frames along `axis`: that axis (of length >=
    (K - 1) * L + W) becomes a (K, W) pair of axes in place, frame k
    covering x[..., k*L : k*L + W, ...]."""
    fr = x.movedim(axis, -1).unfold(-1, W, L)[..., :K, :]
    return fr.movedim((-2, -1), (axis, axis + 1))


def _vshape(ndim, wpos, vf_shape):
    """Broadcast shape placing the filter spectrum's nd axes at the
    framed array's FFT axis positions."""
    shape = [1] * ndim
    for d, p in enumerate(wpos):
        shape[p] = vf_shape[d]
    return tuple(shape)


def _conv_os_nd(u, v, outsize):
    """N-D overlap-save convolution: each dimension is cut into blocks
    where the cost model prefers small FFT blocks over one padded
    full-size FFT; all blocks batch into one rfftn/fftn over the block
    axes."""
    dtype = fftintype(torch.promote_types(u.dtype, v.dtype))
    nd = u.ndim
    nffts, Ls, Ks, blocked = [], [], [], []
    for d in range(nd):
        nu_d, nv_d = u.shape[d], v.shape[d]
        full = 1 << max(outsize[d] - 1, 1).bit_length()
        if nu_d >= nv_d > 1:
            osn = optimal_os_nfft(nu_d, nv_d)
            if osn < full:
                L = osn - nv_d + 1
                nffts.append(osn)
                Ls.append(L)
                Ks.append(-(-outsize[d] // L))
                blocked.append(True)
                continue
        nffts.append(full)
        Ls.append(outsize[d])
        Ks.append(1)
        blocked.append(False)
    if not any(blocked):
        return _conv_fft_simple(u, v, outsize)

    pads = []
    for d in range(nd):
        if blocked[d]:
            q = -(-(nffts[d] - Ls[d]) // Ls[d])
            total = (Ks[d] + q) * Ls[d]
            front = v.shape[d] - 1
            pads.append((front, total - front - u.shape[d]))
        else:
            pads.append((0, 0))
    # F.pad lists the last dimension first
    up = F.pad(u.to(dtype), [e for pr in reversed(pads) for e in pr])

    wpos = []
    p = 0
    for d in range(nd):
        if blocked[d]:
            up = _os_frames_axis(up, Ks[d], Ls[d], nffts[d], p)
            wpos.append(p + 1)
            p += 2
        else:
            wpos.append(p)
            p += 1
    dims = tuple(wpos)
    vdims = tuple(range(nd))
    if dtype.is_complex:
        Vf = torch.fft.fftn(v.to(dtype), s=nffts, dim=vdims)
        y = torch.fft.ifftn(torch.fft.fftn(up, s=nffts, dim=dims)
                            * Vf.reshape(_vshape(up.ndim, wpos, Vf.shape)),
                            dim=dims)
    else:
        Vf = torch.fft.rfftn(v.to(dtype), s=nffts, dim=vdims)
        y = torch.fft.irfftn(torch.fft.rfftn(up, s=nffts, dim=dims)
                             * Vf.reshape(_vshape(up.ndim, wpos, Vf.shape)),
                             s=nffts, dim=dims)
    sl = [slice(None)] * up.ndim
    for d in range(nd):
        if blocked[d]:
            sl[wpos[d]] = slice(v.shape[d] - 1, v.shape[d] - 1 + Ls[d])
        else:
            sl[wpos[d]] = slice(0, Ls[d])
    y = y[tuple(sl)]
    y = y.reshape(tuple(Ks[d] * Ls[d] for d in range(nd)))
    return y[tuple(slice(0, s) for s in outsize)].to(dtype)


_TORCH_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _conv_shift_add(u, v, outsize, dtype):
    """Full convolution as one shifted add of u per element of the
    smaller operand, accumulated in `dtype` (exact for integers)."""
    if u.numel() < v.numel():
        u, v = v, u
    out = torch.zeros(outsize, dtype=dtype, device=u.device)
    uc = u.to(dtype)
    vh = v.to(dtype)
    for idx in np.ndindex(*v.shape):
        sl = tuple(slice(i, i + s) for i, s in zip(idx, u.shape))
        out[sl] += vh[idx] * uc
    return out


def _conv_direct(u, v, outsize):
    """Direct N-D full convolution: float through F.conv1d/2d/3d with
    TF32 off; integers exactly, as shifted adds in their own type."""
    dtype = torch.promote_types(u.dtype, v.dtype)
    if dtype.is_complex:
        def parts(t):
            t = t.to(dtype)
            return t.real, t.imag
        ur, ui = parts(u)
        vr, vi = parts(v)
        rr = _conv_direct(ur, vr, outsize)
        ri = _conv_direct(ur, vi, outsize)
        ir = _conv_direct(ui, vr, outsize)
        ii = _conv_direct(ui, vi, outsize)
        return torch.complex(rr - ii, ri + ir)
    nd = u.ndim
    if not dtype.is_floating_point or nd not in _TORCH_CONV:
        return _conv_shift_add(u, v, outsize, dtype)
    lhs = u.to(dtype)[None, None]
    rhs = v.to(dtype).flip(tuple(range(nd)))[None, None]
    with no_tf32():
        out = _TORCH_CONV[nd](lhs, rhs, padding=tuple(s - 1 for s in v.shape))
    return out[0, 0]


def conv(u, v, A=None, algorithm="auto", device=None):
    """Full convolution of same-rank arrays u and v (output size
    su+sv-1 per dim). `conv(u, v, A)` computes the separable 2-D
    convolution of column u, row v with matrix A. `algorithm` in
    {"auto", "fast", "direct", "fft", "fft_simple", "fft_overlapsave"}."""
    dev = _device_of(device, u, v, A)
    if A is not None:
        u = _as_1d(u, "u", dev)
        v = _as_1d(v, "v", dev)
        A = as_tensor(A, dev)
        return conv(torch.outer(u, v), A, algorithm=algorithm)

    u = as_tensor(u, dev)
    v = as_tensor(v, dev)
    if u.ndim != v.ndim:
        # pad trailing singleton dims (Julia broadcasts trailing dims)
        nd = max(u.ndim, v.ndim)
        u = u.reshape(tuple(u.shape) + (1,) * (nd - u.ndim))
        v = v.reshape(tuple(v.shape) + (1,) * (nd - v.ndim))
    outsize = tuple(su + sv - 1 for su, sv in zip(u.shape, v.shape))

    dtype = torch.promote_types(u.dtype, v.dtype)
    is_float = dtype.is_floating_point or dtype.is_complex

    if algorithm == "auto":
        algorithm = "fast" if is_float else "direct"
    if algorithm == "fast":
        if u.numel() * v.numel() < _CONV_DIRECT_CUTOFF:
            algorithm = "direct"
        elif u.ndim == 1:
            nv, nu = sorted((u.shape[0], v.shape[0]))
            algorithm = ("fft_overlapsave"
                         if optimal_os_nfft(nu, nv) < nu + nv - 1
                         else "fft_simple")
        else:
            algorithm = "fft_overlapsave"
    if algorithm == "fft":
        algorithm = "fft_simple"

    if algorithm == "direct":
        return _conv_direct(u, v, outsize)
    if algorithm == "fft_simple":
        return _conv_fft_simple(u, v, outsize)
    if algorithm == "fft_overlapsave":
        if u.numel() < v.numel():
            u, v = v, u
        if u.ndim != 1:
            return _conv_os_nd(u, v, outsize)
        return _conv_os_1d(u, v)
    raise ValueError(f"unknown convolution algorithm {algorithm!r}")


def conv_with_offset(u, v, u_offsets=None, v_offsets=None,
                     algorithm="auto", device=None):
    """Offset-axes convolution: `u_offsets` / `v_offsets` (int or
    per-axis tuple) give the index of each array's first element on its
    global axis. Returns `(conv(u, v), out_offsets)` with
    `out_offsets[d] = u_offsets[d] + v_offsets[d]`."""
    dev = _device_of(device, u, v)
    u = as_tensor(u, dev)
    v = as_tensor(v, dev)
    nd = max(u.ndim, v.ndim)

    def norm(off, name):
        if off is None:
            return (0,) * nd
        if np.isscalar(off):
            off = (int(off),) * nd
        off = tuple(int(o) for o in off)
        if len(off) != nd:
            raise ValueError(f"{name} must have one offset per axis "
                             f"({nd}), got {len(off)}")
        return off

    uo = norm(u_offsets, "u_offsets")
    vo = norm(v_offsets, "v_offsets")
    out = conv(u, v, algorithm=algorithm)
    return out, tuple(a + b for a, b in zip(uo, vo))


# ---------------------------------------------------------------------------
# xcorr
# ---------------------------------------------------------------------------

def xcorr(u, v=None, padmode="none", scaling="none", device=None):
    """Cross-correlation of vectors u and v; conjugates the *second*
    argument. padmode in {"none", "longest"}; scaling in {"none",
    "biased"}."""
    u = _as_1d(u, "u", _device_of(device, u, v))
    v = u if v is None else _as_1d(v, "v", u.device)
    su, sv = u.shape[0], v.shape[0]

    if scaling == "biased" and su != sv:
        raise ValueError("scaling only valid for vectors of same length")
    if padmode == "longest":
        n = max(su, sv)
        if su < n:
            u = F.pad(u, (0, n - su))
        if sv < n:
            v = F.pad(v, (0, n - sv))
    elif padmode != "none":
        raise ValueError("padmode must be either 'none' or 'longest'")

    res = conv(u, v.conj().resolve_conj().flip(0))
    if scaling == "biased":
        res = res / su
    elif scaling != "none":
        raise ValueError("scaling must be either 'none' or 'biased'")
    return res
