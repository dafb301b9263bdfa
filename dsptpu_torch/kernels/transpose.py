"""K8a-c: the layout kernels of dsptpu/kernels/transpose.py, hand-written
CUDA (csrc/transpose.cu).

Counterparts of dsptpu's public transpose2d_pallas (:51),
transpose_tall_pallas (:147) and spectro_permute_pallas (:193). No route
of the library calls them (the port's K3 writes bins in order and reads
frames straight from the time-major signal); they are kept because
dsptpu exposes them.

  * transpose2d(x): (M, N) float32 -> exactly x.T, (N, M).
  * transpose_tall(x, TR, pad_to): (M, C) -> (C, out_len), out_len =
    ceil(max(M, pad_to) / TR) * TR, zero at and past M. TR sets only the
    output's length; the kernel's tiling is its own.
  * spectro_permute(tile, l2): (C, nb, N1, TB, 128) ->
    (l2, N1, nb*TB, C), out[k2, k1, b*TB + t, c] = tile[c, b, k1, t, k2]
    for k2 < l2.

A transpose is exact: kernel, plain version and dsptpu agree bit for
bit. Bound on an H100: the bytes (each input element read once, each
output element written once) at 3.35 TB/s. K8a and K8b share one 32 x 32
shared-memory tile transpose; K8c stages (frames x channels x bins)
blocks with 16-byte loads and writes each bin's contiguous run with
16-byte stores (scalar where a view's storage offset leaves its rows
unaligned or C is not a multiple of 4). Device time with the L2 flushed
(tools/k8_ab.py; NVIDIA H100 80GB HBM3, 700.00 W), at chip_smoke.py's
K8 shapes: K8a 0.034 ms (bound 0.025), K8b 0.186-0.189 (0.153), K8c
0.224 (0.163).

Each wrapper launches its kernel for a CUDA tensor and runs its plain
PyTorch version (an index gather: out.flat[i] = x.flat[src(i)]) for a
CPU tensor. `launches` counts each wrapper's kernel launches under its
name.
"""

import ctypes

import torch

from . import _build
from ..utils.profiling import spanned

__all__ = ["transpose2d", "transpose2d_reference", "transpose_tall",
           "transpose_tall_reference", "tall_out_len", "spectro_permute",
           "spectro_permute_reference", "launches"]

launches = {"transpose2d": 0, "transpose_tall": 0, "spectro_permute": 0}

# dsptpu_transpose2d(x, out, M, N, stream)
_ARGS_2D = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_void_p]
# dsptpu_transpose_tall(x, out, M, C, L, stream)
_ARGS_TALL = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_longlong, ctypes.c_void_p]
# dsptpu_spectro_permute(in, out, C, nb, N1, TB, l2, stream)
_ARGS_PERM = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _check_f32(x, ndim, what):
    if x.dtype != torch.float32:
        raise TypeError(f"{what} kernel takes float32")
    if x.ndim != ndim or x.numel() == 0:
        raise ValueError(f"{what} kernel takes a non-empty {ndim}-D tensor")


def _arange(n, like):
    return torch.arange(n, device=like.device)


def transpose2d_reference(x):
    """Plain PyTorch version: out[j, i] = x[i, j] as a gather."""
    M, N = x.shape
    src = _arange(N, x)[:, None] + N * _arange(M, x)[None, :]
    return x.reshape(-1)[src]


@spanned("kernel.transpose2d")
def transpose2d(x):
    """x (M, N) float32 transposed, (N, M)."""
    if x.device.type == "cpu":
        return transpose2d_reference(x)
    _check_f32(x, 2, "transpose2d")
    xc = x.contiguous()
    M, N = xc.shape
    out = torch.empty((N, M), dtype=torch.float32, device=xc.device)
    f = _build.entry("transpose", "dsptpu_transpose2d", _ARGS_2D)
    err = f(xc.data_ptr(), out.data_ptr(), M, N, _build.stream_of(xc))
    _build.check("transpose", err, "transpose2d kernel launch")
    launches["transpose2d"] += 1
    return out


def tall_out_len(M, TR=8192, pad_to=None):
    """transpose_tall's output length: ceil(max(M, pad_to) / TR) * TR."""
    return -(-max(M, pad_to or 0) // TR) * TR


def transpose_tall_reference(x, TR=8192, pad_to=None):
    """Plain PyTorch version: a gather of x's columns, then zeros at and
    past M."""
    M, C = x.shape
    L = tall_out_len(M, TR, pad_to)
    t = _arange(L, x)
    src = t.clamp(max=M - 1)[None, :] * C + _arange(C, x)[:, None]
    return torch.where(t[None, :] < M, x.reshape(-1)[src],
                       torch.zeros((), dtype=x.dtype, device=x.device))


@spanned("kernel.transpose_tall")
def transpose_tall(x, TR=8192, pad_to=None):
    """x (M, C) float32 -> (C, out_len), x.T followed by zeros up to
    out_len = tall_out_len(M, TR, pad_to)."""
    if x.device.type == "cpu":
        return transpose_tall_reference(x, TR, pad_to)
    _check_f32(x, 2, "transpose_tall")
    xc = x.contiguous()
    M, C = xc.shape
    L = tall_out_len(M, TR, pad_to)
    out = torch.empty((C, L), dtype=torch.float32, device=xc.device)
    f = _build.entry("transpose", "dsptpu_transpose_tall", _ARGS_TALL)
    err = f(xc.data_ptr(), out.data_ptr(), M, C, L, _build.stream_of(xc))
    _build.check("transpose", err, "transpose_tall kernel launch")
    launches["transpose_tall"] += 1
    return out


def spectro_permute_reference(tile, l2):
    """Plain PyTorch version: out[k2, k1, b*TB + t, c] =
    tile[c, b, k1, t, k2] as a gather."""
    C, nb, N1, TB, _ = tile.shape

    def ax(n, pos):
        shape = [1] * 5
        shape[pos] = n
        return _arange(n, tile).reshape(shape)
    # output axes (k2, k1, b, t, c)
    src = ((((ax(C, 4) * nb + ax(nb, 2)) * N1 + ax(N1, 1)) * TB + ax(TB, 3))
           * 128 + ax(l2, 0))
    return tile.reshape(-1)[src].reshape(l2, N1, nb * TB, C)


@spanned("kernel.spectro_permute")
def spectro_permute(tile, l2):
    """tile (C, nb, N1, TB, 128) float32 -> (l2, N1, nb*TB, C), bins
    k2 < l2 (1 <= l2 <= 128) moved to the front and channels to the
    back."""
    l2 = int(l2)
    if tile.ndim != 5 or tile.shape[-1] != 128 or not 1 <= l2 <= 128:
        raise ValueError("spectro_permute takes (C, nb, N1, TB, 128) and "
                         "1 <= l2 <= 128")
    if tile.device.type == "cpu":
        return spectro_permute_reference(tile, l2)
    _check_f32(tile, 5, "spectro_permute")
    tc = tile.contiguous()
    C, nb, N1, TB, _ = tc.shape
    out = torch.empty((l2, N1, nb * TB, C), dtype=torch.float32,
                      device=tc.device)
    f = _build.entry("transpose", "dsptpu_spectro_permute", _ARGS_PERM)
    err = f(tc.data_ptr(), out.data_ptr(), C, nb, N1, TB, l2,
            _build.stream_of(tc))
    _build.check("transpose", err, "spectro_permute kernel launch")
    launches["spectro_permute"] += 1
    return out

