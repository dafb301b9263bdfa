#!/usr/bin/env python3
"""K6's times for the dsptpu_torch package under ROOT (default: this
checkout):

    python3 tools/k6_ab.py [ROOT]

Builds ROOT's kernels, then times on the card K6 on x (10,000,000,)
float32, a fresh stream, with resample_filter's float32 taps: at path
C's two rational rates as resample_entry() calls it (147/160 with a 41 x
147 bank, 3/2 with 37 x 3), and at three rates off path C: 1/4 (147
taps, three passes of at most 64), 5 (37 x 5) and 441/640 (53 x 441: a
row of 441 outputs is wider than a block, so its columns run in passes;
the route's gate keeps this rate off, so it is a direct call). For each:
CUDA events (median of 20 runs, each 10 calls back to back, divided by
10) and the device time of K6's kernel per call (torch.profiler over 10
calls). Then resample_entry()'s forward end to end (median of 5 calls),
its device time per call (torch.profiler over 2 calls, every kernel
summed) and the idle share 1 - device / call. Each K6 result is held to
the plain version (3e-5 of max |ref|). Prints the card (nvidia-smi name
and power limit) and one JSON line. To compare two checkouts, run it on
both in one call, in the order parent, change, change, parent.
"""

import json
from fractions import Fraction

from ab_common import device_ms, open_root, time_ms

OFF_PATH_RATES = (Fraction(1, 4), Fraction(5), Fraction(441, 640))


def main():
    import numpy as np
    import torch
    root = open_root("k6_ab")
    import dsptpu_torch
    from dsptpu_torch.kernels import pfb2
    from dsptpu_torch.pipeline import RESAMPLE_RATES
    dev = torch.device("cuda")
    res = {"root": root}

    forward, (x,) = dsptpu_torch.resample_entry(device="cuda")
    n = x.shape[0]
    for r in RESAMPLE_RATES[:2] + OFF_PATH_RATES:
        h = np.asarray(dsptpu_torch.resample_filter(r), dtype=np.float32)
        f = dsptpu_torch.FIRFilter(h, r)
        L, M = r.numerator, r.denominator
        pfb = torch.as_tensor(dsptpu_torch.taps2pfb(h, L), device=dev)
        args = (None, x, pfb, L, M, 1, 1, f.kernel.output_length(n))
        hl = f.history_len
        want = pfb2.pfb2_reference(*args)
        got = pfb2.pfb2(*args, hist_len=hl)[0]
        torch.cuda.synchronize()
        rel = ((got.double() - want.double()).abs().max()
               / want.double().abs().max()).item()
        if not rel <= 3e-5:
            raise SystemExit(f"k6_ab: K6 at {r} off by {rel:.3e}")
        del want, got
        key = f"{L}_{M}"
        res[f"k6_{key}_taps"] = pfb.shape[0]
        res[f"k6_{key}_rel_err"] = rel
        res[f"k6_{key}_ms"] = time_ms(lambda: pfb2.pfb2(*args, hist_len=hl),
                                      reps=20, warmup=3, inner=10)
        res[f"k6_{key}_device_ms"] = device_ms(
            lambda: pfb2.pfb2(*args, hist_len=hl), "pfb2_kernel", calls=10)
        torch.cuda.empty_cache()
    res["path_c_ms"] = time_ms(lambda: forward(x), reps=5, warmup=1)
    res["path_c_device_ms"] = device_ms(lambda: forward(x), calls=2)
    res["path_c_idle_share"] = 1 - res["path_c_device_ms"] / res["path_c_ms"]
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
