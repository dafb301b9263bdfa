"""Phase unwrapping (port of dsptpu/utils/unwrap.py).

Two regimes, as in dsptpu:

  * `unwrap(m, dims=k)` -- unwrap along one dimension, on tensors: the
    cumulative-sum form of the reference's sequential `accumulate!`
    kernel (src/unwrap.jl:10-34). A numpy array or list goes to
    `device`, "cuda" by default.
  * `unwrap(m, dims=range(m.ndim))` -- N-D reliability-guided unwrap
    (Herraez/Abdul-Rahman; reference src/unwrap.jl:113-306). Its
    union-find region merging is pointer-chasing and host-sequential:
    the code below is a copy of dsptpu's host numpy version, with the
    same explicit `rng` (a numpy Generator). A tensor input is read back
    and the result returned as a tensor on its device; a numpy input
    gives a numpy result.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .device import as_tensor

__all__ = ["unwrap"]


def unwrap(m, dims=None, range=2 * np.pi, circular_dims=None, rng=None,
           device=None):
    """Unwrap phase `m` along `dims` (an int for one-dimensional
    unwrapping, or `builtins.range(m.ndim)` / tuple of all dims for the
    N-D algorithm). `range` is the wrap period; `circular_dims` marks
    axes whose edges connect (N-D only); `rng` is a numpy Generator for
    the N-D random reliability seed."""
    period = range
    ndim = m.ndim if isinstance(m, torch.Tensor) else np.ndim(m)
    if dims is None:
        if ndim != 1:
            raise ValueError("unwrap: keyword `dims` required for N-D input")
        dims = 0
    if isinstance(dims, int):
        return _unwrap_along(as_tensor(m, device), dims, period)
    dims = tuple(dims)
    if dims == tuple(np.arange(ndim)):
        if isinstance(m, torch.Tensor):
            out = _unwrap_nd(m.detach().cpu().numpy(), period,
                             circular_dims, rng)
            return torch.as_tensor(out, device=m.device)
        return _unwrap_nd(np.asarray(m), period, circular_dims, rng)
    raise ValueError(f"unwrap: invalid dims {dims!r}")


def _unwrap_along(m, axis, period):
    """Cumulative correction form of y[i] = m[i] - round((m[i]-y[i-1])/T)*T."""
    axis = axis % m.ndim
    steps = torch.round(torch.diff(m, dim=axis) / period)
    corr = -torch.cumsum(steps, dim=axis) * period
    pad = [0, 0] * (m.ndim - 1 - axis) + [1, 0]
    return m + F.pad(corr, pad)


# ---------------------------------------------------------------------------
# N-D reliability-guided unwrapping (host)
# ---------------------------------------------------------------------------

def _wrap_val(x, period):
    return x - period * np.round(x / period)


def _unwrap_nd(m, period, circular_dims, rng):
    shape = m.shape
    nd = m.ndim
    if circular_dims is None:
        circular_dims = (False,) * nd
    if rng is None:
        rng = np.random.default_rng(0)

    flat = m.reshape(-1).astype(np.float64)
    n = flat.size

    rel = _reliability(m.astype(np.float64), period, circular_dims, rng)

    # Build edges along every dimension (+ wraparound when circular).
    edges_a, edges_b = [], []
    idx = np.arange(n).reshape(shape)
    for ax in range(nd):
        a = _take_slice(idx, ax, slice(0, shape[ax] - 1)).reshape(-1)
        b = _take_slice(idx, ax, slice(1, shape[ax])).reshape(-1)
        edges_a.append(a)
        edges_b.append(b)
        if circular_dims[ax] and shape[ax] > 2:
            edges_a.append(_take_slice(idx, ax, slice(shape[ax] - 1, shape[ax])).reshape(-1))
            edges_b.append(_take_slice(idx, ax, slice(0, 1)).reshape(-1))
    ea = np.concatenate(edges_a)
    eb = np.concatenate(edges_b)

    # Most reliable edges first (small summed unreliability).
    order = np.argsort(rel.reshape(-1)[ea] + rel.reshape(-1)[eb], kind="stable")
    ea, eb = ea[order], eb[order]

    parent = np.arange(n)
    size = np.ones(n, dtype=np.int64)
    poff = np.zeros(n, dtype=np.int64)  # periods relative to parent

    def find(i):
        # iterative find with full path compression, accumulating offsets
        path = []
        while parent[i] != i:
            path.append(i)
            i = parent[i]
        acc = 0
        for j in reversed(path):
            acc += poff[j]
            parent[j] = i
            poff[j] = acc
        return i

    for a, b in zip(ea, eb):
        ra, rb = find(a), find(b)
        if ra == rb:
            continue
        if size[ra] < size[rb]:
            parent[ra] = rb
            poff[ra] = _attach_offset(flat, period, poff, a, b)
            size[rb] += size[ra]
        else:
            parent[rb] = ra
            poff[rb] = _attach_offset(flat, period, poff, b, a)
            size[ra] += size[rb]

    for i in np.arange(n):
        find(i)  # compress fully so poff is root-relative everywhere
    out = flat + period * poff
    return out.reshape(shape).astype(m.dtype, copy=False)


def _attach_offset(flat, period, poff, child_px, anchor_px):
    """Period offset for child's root when attached under anchor's root,
    chosen so child_px and anchor_px unwrap to within half a period.
    poff[child_px]/poff[anchor_px] must already be root-relative (i.e.
    find() was just called on both)."""
    ua = flat[anchor_px] + period * poff[anchor_px]
    ub = flat[child_px] + period * poff[child_px]
    return int(np.round((ua - ub) / period))


def _take_slice(arr, axis, sl):
    slicer = [slice(None)] * arr.ndim
    slicer[axis] = sl
    return arr[tuple(slicer)]


def _reliability(m, period, circular_dims, rng):
    """Second-difference unreliability (Herraez et al.); border pixels
    (non-circular axes) get a random large-ish value like the reference
    (src/unwrap.jl:147-158,255-306). Lower = more reliable."""
    acc = np.zeros_like(m)
    interior = np.ones(m.shape, dtype=bool)
    for ax in range(m.ndim):
        prev = np.roll(m, 1, axis=ax)
        nxt = np.roll(m, -1, axis=ax)
        d = _wrap_val(prev - m, period) - _wrap_val(m - nxt, period)
        acc += d * d
        if not circular_dims[ax]:
            _set_border(interior, ax)
    rel = np.sqrt(acc)
    noise = rng.random(m.shape) * 0.1
    rel = rel + noise
    big = rel.max() + 1.0 if rel.size else 1.0
    rel[~interior] = big + rng.random((~interior).sum())
    return rel


def _set_border(mask, axis):
    _take_slice(mask, axis, slice(0, 1))[...] = False
    _take_slice(mask, axis, slice(-1, None))[...] = False
