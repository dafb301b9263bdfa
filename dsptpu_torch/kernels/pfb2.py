"""K6: rational polyphase resampling of a 1-D stream, a hand-written CUDA
kernel (csrc/pfb2.cu).

Replaces dsptpu/kernels/pfb2.py:pfb2_resample_pallas (:487; resident
`_pfb2_jit` :400 and grouped `_pfb2_jit_grouped` :440, one function
here). With xcat = hist ‖ x, L/M the rate, a (taps, L) polyphase bank
(taps2pfb layout), q_j = phi0 - 1 + j M and w_j = deficit - taps +
floor(q_j / L) the 0-based start of output j's window in xcat:

    y_j = sum_{t < taps} pfb[t, q_j mod L] * xcat[w_j + t],

zero where w_j + t falls outside xcat (the zero history of a fresh
stream). Mid-stream, `deficit` is already shifted by len(hist), as
dsptpu's FIRFilter passes it; `hist_len` > 0 also returns the new
history, the last hist_len samples of xcat, as a copy.

Bound on an H100: the bytes, 4 per input and 4 per output sample
(76.75 MB at 147/160 over 10,000,000 samples). What holds it back is
shared memory, one 32-bank wavefront a cycle per SM, so the kernel
reads one shared word per multiply-add: each thread keeps one phase
column's taps in registers (a compile-time count, a multiple of 8 up to
64; longer banks in chunks of consecutive taps, taps // nch or one more
each) and walks that column
down the rows of a tile of `_ROWS` x k L outputs, whose input span the
block stages while it computes the tile before. `_launch_geometry`
picks the lanes of a warp, the warps of a block and k for the fewest
wavefronts per output. The zero taps that pad a chunk to the template's
count are not multiplied, so an Inf or NaN just past an output's window
leaves that output finite, as in the plain version. See csrc/pfb2.cu.

The TPU kernel's geometry (superchunks, lane-mixing tap tables, the
grouped mode) is not ported. Its host gates are, unchanged:
`pfb2_supported`, `pfb2_default_on` and the helpers they need, numpy
only; they stay the route's gate until an H100 measurement says
otherwise.

`pfb2` launches the kernel for a CUDA tensor and runs
`pfb2_reference`, the plain PyTorch version (a gather and a dot per
tap), for a CPU tensor. `launches["pfb2"]` counts kernel launches.
"""

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from ..utils.profiling import spanned

__all__ = ["pfb2", "pfb2_reference", "pfb2_supported", "pfb2_default_on",
           "launches"]

launches = {"pfb2": 0}

_ROWS = 8            # rows of a tile (csrc/pfb2.cu kRows)
_MAX_WARPS = 8       # warps of a block (csrc/pfb2.cu kMaxThreads / 32)
_MAX_SPAN = 12288    # samples a tile stages, 48 KB in each of two buffers

# dsptpu_pfb2(hist, hl, x, n, pfb, taps, L, M, phi0m1, deficit, out_len,
#             nt, nch, lanes, warps, k, span, y, stream)
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
              ctypes.c_longlong, ctypes.c_void_p]
             + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
             + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)


# -- dsptpu's gate (kernels/pfb2.py:78-162), host numpy --------------------

_RESIDENT_CAP = 4 << 20      # dsptpu: whole table rides in VMEM below this
_GRP_CAP_ROWS = 15360        # dsptpu: 7.5 MB per single-buffered group


def _superchunk(L, M):
    """Smallest k with k*M % 1024 == 0 (P_in a multiple of 8 rows) and
    k*L % 128 == 0 (whole output rows)."""
    k = 1024 // math.gcd(M, 1024)
    k *= 128 // math.gcd(k * L, 128)
    assert k * M % 1024 == 0 and k * L % 128 == 0
    return k


def pfb2_supported(L, M, taps, dtype):
    if dtype != torch.float32:
        return False
    if L < 1 or M < 1 or taps < 2:
        return False
    k = _superchunk(L, M)
    if k * M // 128 > 4096:  # degenerate geometry (huge superchunks)
        return False
    # boundary spill must fit the 8-row side views
    return (M + taps - 1) <= 7 * 128 and taps - 1 <= 8 * 128


def _class_geometry(taps, L, M, phi0, deficit):
    """Window starts/PFB columns per output lane of each class, and
    the per-class input-row band: the geometry alone, without the
    O(O_r*D*128*128) table build."""
    k = _superchunk(L, M)
    P_in = k * M // 128
    O_r = k * L // 128
    j = np.arange(k * L)
    b, p = j // L, j % L
    q = phi0 - 1 + M * p
    w = (deficit - 1 - (taps - 1)) + b * M + q // L
    col = q % L
    w = w.reshape(O_r, 128)
    col = col.reshape(O_r, 128)
    r_lo = np.floor_divide(w.min(axis=1), 128)            # (O_r,)
    r_hi = np.floor_divide(w.max(axis=1) + taps - 1, 128)
    D_c = (r_hi - r_lo + 1).astype(np.int64)              # per-class band
    return k, P_in, O_r, w, col, r_lo, D_c


def pfb2_default_on(taps, L, M, phi0, deficit, max_G=3):
    """dsptpu's analytic dispatch verdict (no table build): True for
    plans whose TPU tap table fits VMEM, and for grouped plans of few
    groups."""
    *_, D_c = _class_geometry(taps, L, M, int(phi0), int(deficit))
    if int(D_c.sum()) * 128 * 128 * 4 <= _RESIDENT_CAP:
        return True
    _, G, _ = _group_partition(D_c)
    return 1 < G <= max_G


def _group_partition(D_c, cap_rows=_GRP_CAP_ROWS):
    """Largest class-block size Cg (< O_r) dividing O_r whose packed
    per-group table fits cap_rows; returns (Cg, G, rows_per_group)."""
    Dc = np.asarray(D_c)
    O_r = len(Dc)
    for C in sorted((c for c in range(1, O_r) if O_r % c == 0),
                    reverse=True):
        G = O_r // C
        rows = [int(Dc[g * C:(g + 1) * C].sum()) * 128 for g in range(G)]
        if max(rows) <= cap_rows:
            return C, G, rows
    return 1, O_r, [int(v) * 128 for v in Dc]


# -- the CUDA kernel's geometry, mirrored for the host and the tests -------

def _tap_split(taps):
    """(taps a pass, passes): passes of taps // passes consecutive taps
    or one more, at most 64, padded with zero taps at the end to one
    count, a multiple of 8 (at most 8 zero taps a pass)."""
    nch = -(-taps // 64)
    return 8 * -(-taps // (8 * nch)), nch


def _wavefronts(lanes, L, M):
    """Shared-memory wavefronts of one warp load whose `lanes` lanes take
    consecutive outputs, at the worst column the warp can start on: the
    most distinct words that fall in one of the 32 banks (lanes that read
    one word share it)."""
    phi = np.arange(L if L <= 4096 else 4096, dtype=np.int64)[:, None]
    phi = phi * (L // phi.shape[0])
    words = (phi + np.arange(lanes, dtype=np.int64) * M) // L
    first = np.ones(words.shape, bool)              # words rise with lane
    first[:, 1:] = np.diff(words, axis=1) != 0
    key = np.arange(len(words))[:, None] * 32 + words % 32
    return int(np.bincount(key[first], minlength=32).max())


def _span(nt, nch, L, M, k, phi0):
    """Samples a tile stages: its last row's last window, padded taps
    included, from the first window's start."""
    return ((_ROWS - 1) * k * M + (phi0 - 1 + (k * L - 1) * M) // L
            + nt * nch)


@functools.lru_cache(maxsize=None)
def _columns(taps, L, M):
    """(nt, nch, lanes, warps, k) with the fewest wavefronts per output
    and tap: `warps` warps of `lanes` lanes each keep one column of a row
    of k L outputs (passes over the row where it is longer), and the
    tile's span fits _MAX_SPAN for any entry phase (at k = 1 the gate's
    M + taps - 1 <= 896 keeps it under 8248). Ties go to more lanes,
    then more warps."""
    nt, nch = _tap_split(taps)
    best = None
    for lanes in range(32, 0, -1):
        wf = _wavefronts(lanes, L, M)
        for warps in range(_MAX_WARPS, 0, -1):
            slots = lanes * warps
            k = max(1, slots // L)
            while k > 1 and _span(nt, nch, L, M, k, L) > _MAX_SPAN:
                k -= 1
            cost = warps * wf * -(-k * L // slots) / (k * L)
            if best is None or cost < best[0]:
                best = (cost, lanes, warps, k)
    return (nt, nch) + best[1:]


def _launch_geometry(taps, L, M, phi0):
    """The kernel's geometry for one call: nt, nch, lanes, warps, k and
    the span a tile stages."""
    nt, nch, lanes, warps, k = _columns(taps, L, M)
    return nt, nch, lanes, warps, k, _span(nt, nch, L, M, k, phi0)


# -- plain version and wrapper ---------------------------------------------

def _new_history(hist, x, hist_len):
    """The last hist_len samples of hist ‖ x, as a copy."""
    xcat = x if hist is None or x.shape[0] >= hist_len else torch.cat(
        [hist, x])
    return xcat[max(xcat.shape[0] - hist_len, 0):].clone()


def pfb2_reference(hist, x, pfb, L, M, phi0, deficit, out_len, hist_len=0):
    """Plain PyTorch version: the same sum as a gather and a dot per tap
    (filters.stream_filt._pfb_dot) over zero-padded xcat."""
    from ..filters.stream_filt import _pfb_dot
    taps = pfb.shape[0]
    xcat = x if hist is None else torch.cat([hist, x])
    n = xcat.shape[0]
    base = deficit - taps
    w_first = base + (phi0 - 1) // L
    w_end = base + (phi0 - 1 + (out_len - 1) * M) // L + taps
    front, back = max(0, -w_first), max(0, w_end - n)
    xp = F.pad(xcat, (front, back))
    j = torch.arange(out_len, dtype=torch.int64, device=x.device)
    q = (phi0 - 1) + j * M
    end = base + front + taps - 1 + torch.div(q, L, rounding_mode="floor")
    y = _pfb_dot(xp, pfb.T, end, q % L, taps)
    if hist_len:
        return y, _new_history(hist, x, hist_len)
    return y


@spanned("kernel.pfb2")
def pfb2(hist, x, pfb, L, M, phi0, deficit, out_len, hist_len=0):
    """Rational L/M polyphase resampling of the 1-D float32 stream
    hist ‖ x (hist None: a fresh stream, zero history) with the (taps,
    L) float32 bank `pfb`; (out_len,) float32, and with hist_len > 0
    also the new history (hist_len,). `phi0` is the 1-based entry phase,
    `deficit` the 1-based input deficit counted from the start of
    xcat."""
    if x.device.type == "cpu":
        return pfb2_reference(hist, x, pfb, L, M, phi0, deficit, out_len,
                              hist_len)
    ts = [x, pfb] + ([] if hist is None else [hist])
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("pfb2 kernel takes float32 signal, history and bank")
    if (x.ndim != 1 or pfb.ndim != 2 or pfb.shape[1] != L
            or (hist is not None and hist.ndim != 1)):
        raise ValueError("pfb2 kernel takes a 1-D signal and history and "
                         "a (taps, L) bank")
    if any(t.device != x.device for t in ts) or not all(
            t.is_contiguous() for t in ts):
        raise ValueError("pfb2 kernel takes contiguous tensors on one "
                         "device")
    taps = pfb.shape[0]
    if not pfb2_supported(L, M, taps, torch.float32):
        raise ValueError(f"pfb2 kernel: L={L} M={M} taps={taps} fails the "
                         "gate ((M + taps - 1) <= 896, taps <= 1025, "
                         "superchunk <= 4096 rows)")
    if not (1 <= phi0 <= L) or out_len < 1:
        raise ValueError(f"pfb2 kernel: phi0={phi0} out of [1, {L}] or "
                         f"out_len={out_len} < 1")
    geometry = _launch_geometry(taps, int(L), int(M), int(phi0))
    y = torch.empty(out_len, dtype=torch.float32, device=x.device)
    f = _build.entry("pfb2", "dsptpu_pfb2", _ARGTYPES)
    err = f(0 if hist is None else hist.data_ptr(),
            0 if hist is None else hist.shape[0], x.data_ptr(), x.shape[0],
            pfb.data_ptr(), taps, int(L), int(M), int(phi0) - 1,
            int(deficit), int(out_len), *geometry, y.data_ptr(),
            _build.stream_of(x))
    _build.check("pfb2", err, "pfb2 kernel launch")
    launches["pfb2"] += 1
    if hist_len:
        return y, _new_history(hist, x, hist_len)
    return y
