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
import os
import statistics
import subprocess
import sys


def time_ms(fn, reps=20, warmup=3, inner=10):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / inner)
    return statistics.median(ts)


def device_ms(fn, calls=10):
    """Device time of the kernels named *fir_kernel* per call of fn."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and "fir_kernel" in e.key) / 1e3 / calls


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k1_ab: CUDA is not available")
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.join(os.path.dirname(__file__), ".."))
    sys.path.insert(0, root)
    import dsptpu_torch
    from dsptpu_torch.kernels import _build, fir
    from dsptpu_torch.pipeline import chain_params
    if not os.path.abspath(dsptpu_torch.__file__).startswith(root):
        raise SystemExit(f"k1_ab: imported {dsptpu_torch.__file__}, "
                         f"not the package under {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    _build.build_all()
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
        res[f"k1_{key}_ms"] = time_ms(lambda: fir.fir(xs, taps))
        res[f"k1_{key}_device_ms"] = device_ms(lambda: fir.fir(xs, taps))
    del x1
    torch.cuda.empty_cache()
    res["main_ms"] = time_ms(lambda: forward(x), reps=5, warmup=1, inner=1)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
