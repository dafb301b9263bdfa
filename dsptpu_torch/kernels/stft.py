"""K3: fused windowed-segment power spectra, a hand-written CUDA kernel
(csrc/stft.cu), with K3b folded into its load stage.

Replaces dsptpu/kernels/stft.py:stft_pow_pallas (:295; Pallas `_kernel`
:132) and kernels/transpose.py:regroup_planes_pallas (:132), the TPU
kernel's input-layout pass: the CUDA kernel reads each frame straight
from the time-major (n, C) signal at f*hop, zero past n. Per frame it
applies the window, a length-nfft real DFT (the four-step split of the
TPU kernel, nfft = N1*128 with 2 <= N1 <= 16) and |X|^2, then either
writes the scaled bins in order per frame, (nbins, nframes, C), or sums
them over the frames (Welch), (nbins, C), through per-block partial sums
and a second pass: no atomics, so results repeat from run to run.

The window may be one (nfft,) window or a stack (K, nfft) (multitaper:
fold a per-taper weight into its window as w_m / sqrt(r_m)). The
kernel loads each frame into shared memory once (windowed by a single
window, raw for a stack), runs the DFT per window and sums |X|^2 over
the windows, in order, in a per-frame accumulator in shared memory; the
bin scale is applied once at the store. The windows stay in global
memory, so K is not bounded by shared memory; the kernel's channel
group (channels per block) halves from 8 where its buffers would not
fit in the 227 KB a block may have (nfft 2048, all nfft bins, K > 1,
summed: 4).

Bound on an H100: HBM bytes in both modes at K = 1. A real FFT with the
window and |X|^2 needs ~28 f32 flops per sample per frame at nfft 1024,
under the time to read the signal once (summed over frames) or to read
it and write nbins floats per frame and channel (per frame); K windows
need K times the flops, which bound the per-frame mode from K = 3 on.

`stft_pow` launches the kernel for a CUDA tensor and runs
`stft_pow_reference`, the plain PyTorch version of the same four-step
arithmetic, for a CPU tensor. `launches["stft"]` counts kernel
launches.
"""

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["stft_pow", "stft_pow_reference", "stft_supported", "launches"]

launches = {"stft": 0}

# dsptpu_stft_pow(x, win, w1, tw, w128, scale, part, out, n, C, N1, hop,
#                 nframes, nbins, fpb, accumulate, K, stream)
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [
    ctypes.c_int] * 8 + [ctypes.c_void_p]

_FPB_SUM = 16      # frames per block when summing (partials per channel)
_tab_cache = {}
_host_cache = {}


def stft_supported(nfft, hop, dtype):
    """The gate of dsptpu's kernels/stft.py:stft_supported."""
    return (nfft % 128 == 0 and hop % 128 == 0 and 2 <= nfft // 128 <= 16
            and dtype == torch.float32)


def _tables(nfft, device):
    """float64 host tables cast to float32, on `device`: w1 (N1, 2)
    roots of the first stage, twiddles tw (R, 128, 2) for rows
    k1 < R = N1//2 + 1, w128 (64, 2) roots of the 128-point FFT, as
    (re, im) pairs; and the bin map idx (nfft,) into the (R, 128) rows
    (mirrored rows k1 > N1/2), host int64."""
    key = (nfft, str(device))
    hit = _tab_cache.get(key)
    if hit is None:
        N1 = nfft // 128
        R = N1 // 2 + 1
        w1 = np.exp(-2j * np.pi * np.arange(N1) / N1)
        tw = np.exp(-2j * np.pi * np.outer(np.arange(R), np.arange(128))
                    / nfft)
        w128 = np.exp(-2j * np.pi * np.arange(64) / 128)

        def pairs(z):
            return torch.as_tensor(np.stack([z.real, z.imag], -1).astype(
                np.float32), device=device)

        k = np.arange(nfft)
        k1, k2 = k % N1, k // N1
        idx = np.where(k1 <= N1 // 2, k1 * 128 + k2,
                       (N1 - k1) * 128 + (127 - k2))
        hit = (pairs(w1), pairs(tw), pairs(w128), idx)
        _tab_cache[key] = hit
    return hit


def _f32_on(a, device):
    """a as float32 on device; host arrays are uploaded once and cached
    by content (a pageable upload waits for the stream)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    a = np.ascontiguousarray(a, dtype=np.float32)
    key = (a.shape, a.tobytes(), str(device))
    hit = _host_cache.get(key)
    if hit is None:
        if len(_host_cache) > 64:
            _host_cache.clear()
        hit = _host_cache[key] = torch.as_tensor(a, device=device)
    return hit


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
    w1, TW, _, idx = _tables(nfft, dev)
    m = (np.arange(R)[:, None] * np.arange(N1)[None, :]) % N1
    W1 = w1[torch.as_tensor(m, device=dev)]                 # (R, N1, 2)
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
    w1, tw, w128, _ = _tables(nfft, dev)
    win = win.contiguous()
    scale = scale.contiguous()
    if accumulate:
        fpb = _FPB_SUM
        nblk = -(-nframes // fpb)
        part = torch.empty((nblk, nbins, C), dtype=torch.float32,
                           device=dev)
        out = torch.empty((nbins, C), dtype=torch.float32, device=dev)
    else:
        fpb = 1
        part = None
        out = torch.empty((nbins, nframes, C), dtype=torch.float32,
                          device=dev)
    f = _build.entry("stft", "dsptpu_stft_pow", _ARGTYPES)
    err = f(xc.data_ptr(), win.data_ptr(), w1.data_ptr(), tw.data_ptr(),
            w128.data_ptr(), scale.data_ptr(),
            part.data_ptr() if part is not None else None, out.data_ptr(),
            n, C, N1, hop, nframes, nbins, fpb, int(accumulate), K,
            _build.stream_of(xc))
    _build.check("stft", err, "stft kernel launch")
    launches["stft"] += 1
    return out
