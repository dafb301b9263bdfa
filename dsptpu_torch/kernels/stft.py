"""K3: fused windowed-segment power spectra, a hand-written CUDA kernel
(csrc/stft.cu), with K3b folded into its load stage.

Replaces dsptpu/kernels/stft.py:stft_pow_pallas (:295; Pallas `_kernel`
:132) and kernels/transpose.py:regroup_planes_pallas (:132), the TPU
kernel's input-layout pass: the CUDA kernel reads each frame straight
from the time-major (n, C) signal at f*hop, zero past n. Per frame it
applies the window, a length-nfft DFT (nfft = N1*128 with 2 <= N1 <= 16)
and |X|^2, then either writes the scaled bins in order per frame,
(nbins, nframes, C), or sums them over the frames (Welch), (nbins, C),
through per-block partial sums and a second pass: no atomics, so results
repeat from run to run.

The window may be one (nfft,) window or a stack (K, nfft) (multitaper:
fold a per-taper weight into its window as w_m / sqrt(r_m)); |X|^2 is
summed over the K windows in order and the bin scale applied once at
the store.

The kernel is a register-resident mixed-radix FFT of two real channels
per complex transform: an N1-point DFT per column, a 16-point and an
8-point FFT per 128-point row, two exchanges through shared memory, and
the channels separated where the thread holding bin k also holds bin
nfft - k. Each thread keeps its bins' sums over windows and frames in
registers. Blocks are one wave on the card, each over a fixed run of
frames (their count comes from the kernel's entry point,
`dsptpu_stft_blocks`); the entry point also decides whether the windows
fit in shared memory. Any K >= 1 launches.

Bound on an H100: HBM bytes at K = 1 (reading the signal; per frame,
also writing nbins floats per frame and channel); a real FFT with the
window and |X|^2 (~2.5 nfft log2 nfft flops per frame and window) at
67 TFLOP/s bounds the K-window stack.

`stft_pow` launches the kernel for a CUDA tensor and runs
`stft_pow_reference`, the plain PyTorch version (the four-step DFT as
tensor products), for a CPU tensor. `launches["stft"]` counts kernel
launches.
"""

import ctypes

import numpy as np
import torch

from . import _build
from ..utils.profiling import spanned, table_cache

__all__ = ["stft_pow", "stft_pow_reference", "stft_supported", "launches"]

launches = {"stft": 0}

# dsptpu_stft_pow(x, win, r1, tw, r128, scale, part, out, n, C, N1, hop,
#                 nframes, nbins, accumulate, K, stream)
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [
    ctypes.c_int] * 7 + [ctypes.c_void_p]
# dsptpu_stft_blocks(N1, C, nframes, K, &nblk)
_BLOCKS_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]


def stft_supported(nfft, hop, dtype):
    """The gate of dsptpu's kernels/stft.py:stft_supported."""
    return (nfft % 128 == 0 and hop % 128 == 0 and 2 <= nfft // 128 <= 16
            and dtype == torch.float32)


@table_cache("stft", lambda nfft, device: (nfft, str(device)))
def _tables(nfft, device):
    """float64 host tables cast to float32, on `device`, as (re, im)
    pairs: r1 (16, 2) roots W_N1^m for m < N1 (zero past N1), tw
    (N1, 128, 2) twiddles W_nfft^(k1 j2), r128 (256, 2): roots W_128^m
    for m < 128, then the 16-point pass's twiddles W_128^(i q) at
    128 + 8 i + q (i < 16, q < 8); and the bin map idx (nfft,) of the
    plain version into rows k1 <= N1/2 of its (R, 128) four-step output
    (mirrored rows k1 > N1/2), host int64."""
    N1 = nfft // 128
    r1 = np.zeros(16, np.complex128)
    r1[:N1] = np.exp(-2j * np.pi * np.arange(N1) / N1)
    tw = np.exp(-2j * np.pi * np.outer(np.arange(N1), np.arange(128))
                / nfft)
    r128 = np.exp(-2j * np.pi * np.concatenate([
        np.arange(128), np.outer(np.arange(16), np.arange(8)).ravel()])
        / 128)

    def pairs(z):
        return torch.as_tensor(np.stack([z.real, z.imag], -1).astype(
            np.float32), device=device)

    k = np.arange(nfft)
    k1, k2 = k % N1, k // N1
    idx = np.where(k1 <= N1 // 2, k1 * 128 + k2,
                   (N1 - k1) * 128 + (127 - k2))
    return pairs(r1), pairs(tw), pairs(r128), idx


def _f32_on(a, device):
    """a as float32 on device; host arrays are uploaded once and cached
    by content (a pageable upload waits for the stream)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return _upload(np.ascontiguousarray(a, dtype=np.float32), device)


@table_cache("stft_host", lambda a, device: (a.shape, a.tobytes(),
                                             str(device)), 64)
def _upload(a, device):
    return torch.as_tensor(a, device=device)


def stft_pow_reference(x, win, nfft, hop, nframes, accumulate, scale):
    """Plain PyTorch version: the same four-step DFT with float32
    tables, as tensor products, one window of the stack at a time (the
    memory of one window) and |X|^2 summed over the windows in order.
    x (n, C) float32, win (nfft,) or (K, nfft), scale (nbins,) on x's
    device."""
    n, C = x.shape
    N1 = nfft // 128
    R = N1 // 2 + 1
    nbins = scale.shape[0]
    need = (nframes - 1) * hop + nfft
    xp = torch.zeros((max(need, n), C), dtype=x.dtype, device=x.device)
    xp[:n] = x
    raw = xp.T.unfold(1, nfft, hop)[:, :nframes]            # (C, k, nfft)
    dev = x.device
    r1, tw, _, idx = _tables(nfft, dev)
    TW = tw[:R]
    m = (np.arange(R)[:, None] * np.arange(N1)[None, :]) % N1
    W1 = r1[torch.as_tensor(m, device=dev)]                 # (R, N1, 2)
    w2 = np.exp(-2j * np.pi * np.outer(np.arange(128), np.arange(128))
                / 128)
    W2re = torch.as_tensor(w2.real.astype(np.float32), device=dev)
    W2im = torch.as_tensor(w2.imag.astype(np.float32), device=dev)
    bins = torch.as_tensor(idx[:nbins], device=dev)
    pw = None
    for w in win.reshape(-1, nfft):
        planes = (raw * w).reshape(C, nframes, N1, 128)
        bre = torch.einsum("rj,ckjl->ckrl", W1[..., 0], planes)
        bim = torch.einsum("rj,ckjl->ckrl", W1[..., 1], planes)
        cre = bre * TW[..., 0] - bim * TW[..., 1]
        cim = bre * TW[..., 1] + bim * TW[..., 0]
        del planes, bre, bim
        xre = cre @ W2re - cim @ W2im
        xim = cre @ W2im + cim @ W2re
        del cre, cim
        p = (xre * xre + xim * xim).reshape(C, nframes, R * 128)[..., bins]
        del xre, xim
        pw = p if pw is None else pw + p                    # (C, k, nbins)
    if accumulate:
        return (pw.sum(1) * scale).T.contiguous()
    return (pw * scale).permute(2, 1, 0).contiguous()


@spanned("kernel.stft")
def stft_pow(x, win, nfft, hop, nframes, accumulate, scale):
    """Power spectra of frames f < nframes of x (n, C) float32 starting
    at f*hop, windowed by win (nfft,) or by each window of a stack
    (K, nfft) with |X|^2 summed over the K windows, scaled per bin by
    scale (nbins,): (nbins, nframes, C), or (nbins, C) summed over
    frames when accumulate. win and scale may be numpy arrays (float64
    host values are cast to float32)."""
    win = _f32_on(win, x.device)
    scale = _f32_on(scale, x.device)
    if x.device.type == "cpu":
        return stft_pow_reference(x, win, nfft, hop, nframes, accumulate,
                                  scale)
    if x.ndim != 2 or not stft_supported(nfft, hop, x.dtype):
        raise ValueError("stft kernel takes (n, C) float32, nfft and hop "
                         "multiples of 128, 2 <= nfft/128 <= 16")
    K = win.shape[0] if win.ndim == 2 else 1
    if (win.shape not in ((nfft,), (K, nfft)) or K < 1 or nframes < 1
            or not (scale.ndim == 1 and 1 <= scale.shape[0] <= nfft)):
        raise ValueError("stft kernel takes an (nfft,) or (K, nfft) window, "
                         "nframes >= 1 and 1 <= nbins <= nfft scales")
    xc = x.contiguous()
    n, C = xc.shape
    N1 = nfft // 128
    nbins = scale.shape[0]
    dev = xc.device
    r1, tw, r128, _ = _tables(nfft, dev)
    win = win.contiguous()
    scale = scale.contiguous()
    part = None
    if accumulate:
        nblk = ctypes.c_int(0)
        blocks = _build.entry("stft", "dsptpu_stft_blocks", _BLOCKS_ARGTYPES)
        _build.check("stft", blocks(N1, C, nframes, K, ctypes.byref(nblk)),
                     "stft kernel plan")
        part = torch.empty((nblk.value, nbins, C), dtype=torch.float32,
                           device=dev)
        out = torch.empty((nbins, C), dtype=torch.float32, device=dev)
    else:
        out = torch.empty((nbins, nframes, C), dtype=torch.float32,
                          device=dev)
    f = _build.entry("stft", "dsptpu_stft_pow", _ARGTYPES)
    err = f(xc.data_ptr(), win.data_ptr(), r1.data_ptr(), tw.data_ptr(),
            r128.data_ptr(), scale.data_ptr(),
            part.data_ptr() if part is not None else None, out.data_ptr(),
            n, C, N1, hop, nframes, nbins, int(accumulate), K,
            _build.stream_of(xc))
    _build.check("stft", err, "stft kernel launch")
    launches["stft"] += 1
    return out
