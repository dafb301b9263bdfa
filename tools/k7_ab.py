#!/usr/bin/env python3
"""K7's times for the dsptpu_torch package under ROOT (default: this
checkout):

    python3 tools/k7_ab.py [ROOT]

Builds ROOT's kernels, then times on the card K7 as path C runs it,
through the route only (FIRFilter(h, rate).filt with resample_filter's
float32 taps), so that it runs on any version of the wrapper:

  * K7 at path C's shapes: x[:2,500,000] of resample_entry()'s stream at
    0.9997, reset and filt of one FIRFilter (its stream state repeats,
    so the route's cached decision is reused): CUDA events (median of 20
    runs, each 10 calls back to back, divided by 10) and the device time
    of the kernels whose name holds "arbd" per call (torch.profiler over
    10 calls), held to the same call in float64 (3e-5 of max |ref|);
  * a new stream state, at 0.9997 and 0.9990: a fresh FIRFilter's first
    filt of the 2,500,000 samples, by host clock with the card
    synchronised before and after (median of 5 filters);
  * a stream of 25 chunks of 100,000 samples at 0.9997 through one
    FIRFilter: host ms a chunk (median, first and max);
  * resample_entry()'s forward end to end (median of 5 calls), its device
    time per call (torch.profiler over 2 calls, every kernel summed) and
    the idle share 1 - device / call.

Prints the card (nvidia-smi name and power limit), the `-Xptxas -v`
lines of csrc/arbd.cu and one JSON line. To compare two checkouts, run
it on both in one call, in the order parent, change, change, parent.
"""

import json
import statistics
import time

from ab_common import (device_ms, device_ms_by_kernel, open_root,
                       ptxas_lines, time_ms)

RATES = (0.9997, 0.9990)


def main():
    import numpy as np
    import torch
    root = open_root("k7_ab")
    import dsptpu_torch
    for line in ptxas_lines("arbd"):
        print(f"  arbd: {line}", flush=True)
    res = {"root": root}

    forward, (x,) = dsptpu_torch.resample_entry(device="cuda")
    xa = x[:2_500_000]
    taps = {r: np.asarray(dsptpu_torch.resample_filter(r), np.float32)
            for r in RATES}
    f = dsptpu_torch.FIRFilter(taps[RATES[0]], RATES[0])
    y = f.reset().filt(xa)
    want = f.reset().filt(xa.double())
    rel = ((y.double() - want).abs().max() / want.abs().max()).item()
    if not rel <= 3e-5:
        raise SystemExit(f"k7_ab: K7 off by {rel:.3e}")
    del y, want
    res["k7_outputs"] = f.reset().output_length(xa.shape[0])
    res["k7_rel_err"] = rel

    def call():
        return f.reset().filt(xa)
    res["k7_route_ms"] = time_ms(call, reps=20, warmup=3, inner=10)
    res["k7_device_ms_by_kernel"] = device_ms_by_kernel(call, "arbd",
                                                        calls=10)
    res["k7_device_ms"] = sum(res["k7_device_ms_by_kernel"].values())

    for r in RATES:
        dsptpu_torch.FIRFilter(taps[r], r).filt(xa)      # warm
        ts = []
        for _ in range(5):
            g = dsptpu_torch.FIRFilter(taps[r], r)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g.filt(xa)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        res[f"new_state_{r}_host_ms"] = statistics.median(ts)

    g = dsptpu_torch.FIRFilter(taps[RATES[0]], RATES[0])
    per_chunk = []
    for c in torch.split(xa, 100_000):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g.filt(c)
        torch.cuda.synchronize()
        per_chunk.append((time.perf_counter() - t0) * 1e3)
    res["chunk_host_ms"] = statistics.median(per_chunk)
    res["chunk_host_ms_first"] = per_chunk[0]
    res["chunk_host_ms_max"] = max(per_chunk)
    res["chunks"] = len(per_chunk)

    res["path_c_ms"] = time_ms(lambda: forward(x), reps=5, warmup=1)
    res["path_c_device_ms"] = device_ms(lambda: forward(x), calls=2)
    res["path_c_idle_share"] = 1 - res["path_c_device_ms"] / res["path_c_ms"]
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
