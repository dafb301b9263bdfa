#!/usr/bin/env python3
"""K3's times at the shapes of the paths that run it, for the
dsptpu_torch package under ROOT (default: this checkout):

    python3 tools/k3_ab.py [ROOT]

Builds ROOT's kernels, then times on the card (CUDA-event medians) the
two unfused K3 calls at the main path's shapes (Welch sum and per-frame
spectrogram of its 1,000,000 x 64 float32 stream, nfft 1024, hop 512,
its window) and, where ROOT has it, the fused call that gives both;
path D's K-window stack (7 DPSS tapers over the same stream) and entry()
and multitaper_entry() end to end. Also the device time by kernel of
those calls and of entry() (torch.profiler over 10 calls), whether the
fused call's outputs equal the unfused calls' bit for bit, and K3's
`-Xptxas -v` lines. Prints the card (nvidia-smi name and power limit)
and one JSON line. To compare two checkouts, run it on both in one
call, in the order parent, change, change, parent.
"""

import json

from ab_common import device_ms_by_kernel, open_root, ptxas_lines, time_ms


def main():
    import torch
    root = open_root("k3_ab")
    import dsptpu_torch
    from dsptpu_torch.kernels import stft
    from dsptpu_torch.ops.multitaper import MTConfig
    from dsptpu_torch.pipeline import (MT_NFFT, MT_NTAPERS, MT_NW,
                                       MT_OVERLAP, chain_params)
    dev = torch.device("cuda")

    res = {"root": root, "ptxas": ptxas_lines("stft")}
    forward, (x,) = dsptpu_torch.entry(device="cuda")
    n, C = x.shape
    nfft, hop = 1024, 512
    k = (n - nfft) // hop + 1
    win = torch.as_tensor(chain_params()[2], device=dev)
    sc = torch.ones(nfft // 2 + 1, device=dev)
    ss = torch.full((nfft // 2 + 1,), 1.0 / k, device=dev)

    def unfused():
        return (stft.stft_pow(x, win, nfft, hop, k, False, sc),
                stft.stft_pow(x, win, nfft, hop, k, True, ss))
    res["welch_ms"] = time_ms(lambda: stft.stft_pow(x, win, nfft, hop, k,
                                                    True, ss),
                              reps=10, warmup=2)
    res["frames_ms"] = time_ms(lambda: stft.stft_pow(x, win, nfft, hop, k,
                                                     False, sc),
                               reps=10, warmup=2)
    res["main_k3_ms"] = res["welch_ms"] + res["frames_ms"]
    res["unfused_device"] = device_ms_by_kernel(unfused, calls=10)
    if hasattr(stft, "stft_pow_fused"):
        def fused():
            return stft.stft_pow_fused(x, win, nfft, hop, k, sc, ss)
        res["fused_ms"] = time_ms(fused, reps=10, warmup=2)
        res["fused_device"] = device_ms_by_kernel(fused, calls=10)
        (fa, fb), (ua, ub) = fused(), unfused()
        torch.cuda.synchronize()
        res["fused_equal"] = [torch.equal(fa, ua), torch.equal(fb, ub)]
        del fa, fb, ua, ub
    res["main_ms"] = time_ms(lambda: forward(x), reps=5, warmup=1)
    res["main_device"] = device_ms_by_kernel(lambda: forward(x), calls=10)
    del forward, x
    torch.cuda.empty_cache()

    forward, (x,) = dsptpu_torch.multitaper_entry(device="cuda")
    nfft, hop = MT_NFFT, MT_NFFT - MT_OVERLAP
    k = (x.shape[0] - nfft) // hop + 1
    mt = MTConfig.create(nfft, nfft=nfft, nw=MT_NW, ntapers=MT_NTAPERS)
    W = mt.const("stack", dev, torch.float32)
    scd = mt.const("stack_scale", dev, torch.float32)
    res["stack_ms"] = time_ms(lambda: stft.stft_pow(x, W, nfft, hop, k,
                                                    False, scd),
                              reps=10, warmup=2)
    res["path_d_ms"] = time_ms(lambda: forward(x), reps=5, warmup=1)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
