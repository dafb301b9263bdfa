"""Block-polyphase matrix product of dsptpu/filters/stream_filt.py.

Only `_block_matmul` is ported so far: the FIR path of `filt` uses it.
FIRFilter, the polyphase kernels and resample wait (ROADMAP Queue 1
item 10).
"""

import torch
import torch.nn.functional as F


def _block_matmul(xcat, G, s0, B, M, W, out_len):
    """Block-polyphase filtering as a regular matmul.

    Outputs are grouped into B blocks of L = G.shape[1] consecutive
    outputs; block b reads the input window xcat[s0 + b*M : +W] (frames
    built from shifted strided reshapes, no gather) and multiplies the
    (W, L) banded matrix G whose column p holds the taps of the p-th
    in-block output at its intra-block offset. xcat: (n, *chans)."""
    L = G.shape[1]
    xc = xcat.movedim(0, -1)                           # (*chans, n)
    q = -(-(W - M) // M) if W > M else 0
    needed = s0 + (B + q + 1) * M
    pad = max(needed - xc.shape[-1], 0)
    if pad:
        xc = F.pad(xc, (0, pad))
    dt = torch.promote_types(xc.dtype, G.dtype)
    Gd = G.to(dt)
    lead = tuple(xc.shape[:-1])
    parts = [xc[..., s0 + j * M: s0 + (B + j) * M].reshape(lead + (B, M))
             for j in range(q + 1)]
    if 1 <= q <= 3:
        # few wide parts: multiply each part against its row band of G
        # and sum, without building the concatenated frame matrix
        Gp = F.pad(Gd, (0, 0, 0, (q + 1) * M - W))
        y = None
        for j in range(q + 1):
            fj = parts[j].reshape(-1, M).to(dt)
            t = fj @ Gp[j * M: (j + 1) * M]
            y = t if y is None else y + t
    else:
        frames = torch.cat(parts, -1)[..., :W]
        y = frames.reshape(-1, frames.shape[-1]).to(dt) @ Gd
    y = y.reshape(lead + (B * L,))[..., :out_len]
    return y.movedim(-1, 0)
