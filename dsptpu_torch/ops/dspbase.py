"""FIR/IIR `filt` on torch tensors: the filt half of dsptpu/ops/dspbase.py.

Same routing and gates as the reference, along axis 0 with trailing
channel dims:
  * short/medium real taps on a long float32 signal (n >= 32768,
    n >= 4 nb, nb <= 512) go through K1, the hand-written FIR kernel
    (kernels/fir.py);
  * other short/medium taps run as a block-Toeplitz matrix product
    (filters/stream_filt._block_matmul);
  * short signals (n < 4 nb) run as a convolution, with TF32 off;
  * taps longer than 512 take the overlap-save route, which waits for
    K4 (ROADMAP Queue 1 item 7);
  * (b, a) filters with a stable denominator run through the block
    state-space pass of filters/filt.py (K2); others through the
    sequential transposed direct-form II recurrence.

Device rule: a tensor argument stays on its device; a numpy array or a
list goes to `device=` (default "cuda", which must be present).
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import as_tensor, no_tf32

__all__ = ["filt"]

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
                # long taps: overlap-save FFTs (K4)
                raise NotImplementedError(
                    "filt with more than 512 taps takes the overlap-save "
                    "route, which is not ported yet (ROADMAP Queue 1 "
                    "item 7, kernel K4)")
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
