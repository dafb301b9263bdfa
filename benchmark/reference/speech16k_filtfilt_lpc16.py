"""Plain reference of the `speech16k_filtfilt_lpc16` configuration:
zero-phase Butterworth filtering of every channel, and the LPC of the
non-overlapping frames of channel 0.

filtfilt: the block is extended at both ends by odd reflection about
its end samples (edge_pad samples each side, 3 x the order). Each pass
starts in the steady state of a constant input equal to its first
sample, which is the same as the pass having seen that sample forever:
the reference puts `impulse_len` copies of it in front, filters from
rest by FFT with the filter's impulse response (worked out from the
poles, gain included), and drops them. The second pass runs the same
way over the reversed first pass; the result is reversed back and cut
to the block.

LPC: for each frame the biased autocorrelation lags R[0..p] (divided by
the frame length), then the normal equations T a = -R[1..p], T[i, j] =
R[|i - j|], solved directly (not by a recursion); the prediction error
is R[0] + sum_i a_i R[i].
"""

import torch

from benchmark.reference import common


def _pass(x, h, precision):
    """One forward pass over x (n, C) from the steady state of x[0]."""
    lead = h.shape[0]
    e = torch.cat([x[:1].expand(lead, x.shape[1]), x])
    return common.fft_filter(e, h, precision)[lead:]


def filtfilt(cfg, x, precision="float64"):
    order = cfg["iir_order"]
    poles, g = common.butterworth_lowpass(order, cfg["iir_cutoff"])
    h = common.iir_impulse(poles, order, g, cfg["impulse_len"], x.device)
    pad = min(cfg["edge_pad"], x.shape[0] - 1)
    xr = x.to(common.real_dtype(precision))
    ext = torch.cat([2 * xr[:1] - xr[1:pad + 1].flip(0), xr,
                     2 * xr[-1:] - xr[-pad - 1:-1].flip(0)])
    y1 = _pass(ext, h, precision)
    y2 = _pass(y1.flip(0), h, precision).flip(0)
    return y2[pad: pad + x.shape[0]]


def lpc(cfg, x, precision="float64"):
    """(a (p, frames), err (frames,)) of channel 0's frames."""
    p, flen = cfg["lpc_order"], cfg["frame_len"]
    nfr = x.shape[0] // flen
    f = common.operand(x[: nfr * flen, 0].reshape(nfr, flen), precision)
    lags = torch.stack([(f[:, : flen - k] * f[:, k:]).sum(1) / flen
                        for k in range(p + 1)], 1)          # (nfr, p+1)
    idx = torch.arange(p, device=x.device)
    r = common.operand(lags, precision)
    toeplitz = r[:, (idx[:, None] - idx[None, :]).abs()]
    a = torch.linalg.solve(toeplitz, -r[:, 1:])
    err = lags[:, 0] + (a * lags[:, 1:]).sum(1)
    return a.T, err


def reference(cfg, x, precision="float64"):
    """{"filtfilt": (n, C), "lpc_a": (p, frames), "lpc_err": (frames,)}
    of the block x (n, C)."""
    a, err = lpc(cfg, x, precision)
    return {"filtfilt": filtfilt(cfg, x, precision), "lpc_a": a,
            "lpc_err": err}
