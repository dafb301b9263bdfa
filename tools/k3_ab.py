#!/usr/bin/env python3
"""K3's times at the shapes of the paths that run it, for the
dsptpu_torch package under ROOT (default: this checkout):

    python3 tools/k3_ab.py [ROOT]

Builds ROOT's kernels, then times on the card (CUDA-event medians) the
main path's two K3 calls (Welch sum and per-frame spectrogram of its
1,000,000 x 64 float32 stream, nfft 1024, hop 512, its window), path D's
K-window stack (7 DPSS tapers over the same stream) and entry() and
multitaper_entry() end to end. Prints the card (nvidia-smi name and
power limit) and one JSON line. To compare two checkouts, run it on
both in one call, in the order parent, change, change, parent.
"""

import json
import os
import statistics
import subprocess
import sys


def time_ms(fn, reps=10, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k3_ab: CUDA is not available")
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.join(os.path.dirname(__file__), ".."))
    sys.path.insert(0, root)
    import dsptpu_torch
    from dsptpu_torch.kernels import _build, stft
    from dsptpu_torch.ops.multitaper import MTConfig
    from dsptpu_torch.pipeline import (MT_NFFT, MT_NTAPERS, MT_NW,
                                       MT_OVERLAP, chain_params)
    if not os.path.abspath(dsptpu_torch.__file__).startswith(root):
        raise SystemExit(f"k3_ab: imported {dsptpu_torch.__file__}, "
                         f"not the package under {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    _build.build_all()
    dev = torch.device("cuda")

    res = {"root": root}
    forward, (x,) = dsptpu_torch.entry(device="cuda")
    n, C = x.shape
    nfft, hop = 1024, 512
    k = (n - nfft) // hop + 1
    win = torch.as_tensor(chain_params()[2], device=dev)
    sc = torch.ones(nfft // 2 + 1, device=dev)
    res["welch_ms"] = time_ms(lambda: stft.stft_pow(x, win, nfft, hop, k,
                                                    True, sc))
    res["frames_ms"] = time_ms(lambda: stft.stft_pow(x, win, nfft, hop, k,
                                                     False, sc))
    res["main_k3_ms"] = res["welch_ms"] + res["frames_ms"]
    res["main_ms"] = time_ms(lambda: forward(x), reps=5, warmup=1)
    del forward, x
    torch.cuda.empty_cache()

    forward, (x,) = dsptpu_torch.multitaper_entry(device="cuda")
    nfft, hop = MT_NFFT, MT_NFFT - MT_OVERLAP
    k = (x.shape[0] - nfft) // hop + 1
    mt = MTConfig.create(nfft, nfft=nfft, nw=MT_NW, ntapers=MT_NTAPERS)
    W = mt.const("stack", dev, torch.float32)
    scd = mt.const("stack_scale", dev, torch.float32)
    res["stack_ms"] = time_ms(lambda: stft.stft_pow(x, W, nfft, hop, k,
                                                    False, scd))
    res["path_d_ms"] = time_ms(lambda: forward(x), reps=5, warmup=1)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
