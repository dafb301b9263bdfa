#!/usr/bin/env python3
"""K1's times for the dsptpu_torch package under ROOT (default: this
checkout):

    python3 tools/k1_ab.py [ROOT]

Builds ROOT's kernels, then times on the card, by CUDA events (median of
20 runs, each 10 calls back to back, divided by 10), K1 at the main
path's shapes (1,000,000 x 64 float32, the 127-tap Lowpass(0.25)
Hamming taps of pipeline.chain_params) and at BASELINE config 1's shape
(10,000,000 x 1, the same taps), the device time of K1's kernel per
call at both shapes (torch.profiler over 10 calls), and entry() end to
end (median of 5 calls). Each K1 result is held to the plain version
(3e-5 of max |ref|). Prints the card (nvidia-smi name and power limit)
and one JSON line. To compare two checkouts, run it on both in one call,
in the order parent, change, change, parent.
"""

import json

from ab_common import device_ms, open_root, time_ms


def main():
    import numpy as np
    import torch
    root = open_root("k1_ab")
    import dsptpu_torch
    from dsptpu_torch.kernels import fir
    from dsptpu_torch.pipeline import chain_params
    dev = torch.device("cuda")
    taps = torch.as_tensor(chain_params()[0], device=dev)
    res = {"root": root}

    forward, (x,) = dsptpu_torch.entry(device="cuda")
    x1 = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (10_000_000, 1)).astype(np.float32), device=dev)
    for key, xs in (("main", x), ("c1", x1)):
        want = fir.fir_reference(xs, taps)
        got = fir.fir(xs, taps)
        torch.cuda.synchronize()
        rel = ((got.double() - want.double()).abs().max()
               / want.double().abs().max()).item()
        if not rel <= 3e-5:
            raise SystemExit(f"k1_ab: K1 at {key} off by {rel:.3e}")
        del want, got
        res[f"k1_{key}_ms"] = time_ms(lambda: fir.fir(xs, taps), reps=20,
                                      warmup=3, inner=10)
        res[f"k1_{key}_device_ms"] = device_ms(lambda: fir.fir(xs, taps),
                                               "fir_kernel", calls=10)
    del x1
    torch.cuda.empty_cache()
    res["main_ms"] = time_ms(lambda: forward(x), reps=5, warmup=1)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
