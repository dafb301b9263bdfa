#!/usr/bin/env python3
"""K5's times for the dsptpu_torch package under ROOT (default: this
checkout):

    python3 tools/k5_ab.py [ROOT]

Builds ROOT's kernels, then times on the card the Levinson kernel
through its wrapper, `levinson.levinson(R, p)`, at three shapes: path
B's (p 16, C 2500), p 64 at C 2500, and the wide batch p 16, C 160,000
(the 2500 frames of 400 samples of all 64 channels). R holds the biased
lags of standard normal frames, formed by the 17-sum form. For each
shape:

  * agreement with the plain version (max|d| / max|ref| <= 1e-4);
  * the device time per call of the kernels whose name holds "levinson",
    by torch.profiler over 10 calls (the number that decides);
  * CUDA events: one call (median of 20 runs; the wrapper's host time
    and the launch) and 10 calls back to back (median of 20 runs,
    divided by 10);
  * at the wide batch also the device time with the L2 flushed by a
    128 MB write before each call (R, 11 MB, otherwise stays in L2).

At path B's shape, the host time of a wrapper call by the host clock
(2000 calls enqueued back to back, then one synchronize), and of two of
its parts: the output's torch.empty and the current stream's handle.

Then path B's LPC stage, `lpc(frames, 16, "levinson")` on the (400,
2500) frames of filtfilt_lpc_entry: its CUDA-event time (one call), its
device time and kernel launches per call (torch.profiler, 10 calls), and
the same for the lag formation alone: the 17-sum form (17 products and
sums, a stack) and, where ROOT has it, ops.lpc._biased_lags (one
batched pass), with their agreement (max|d| / R[0] <= 1e-6). Last, path
B end to end (filtfilt_lpc_entry's forward): call ms (events, median of
10), device ms per call (torch.profiler over 3 calls, leading spin left
out) and the idle share 1 - device / call.

Prints the card (nvidia-smi name and power limit), the `-Xptxas -v`
lines of csrc/levinson.cu and one JSON line. To compare two checkouts,
run it on both in one call, in the order parent, change, change, parent.
"""

import importlib
import json
import time

from ab_common import device_by_kernel, device_ms, open_root, \
    ptxas_lines, time_ms

SHAPES = [(16, 2500), (64, 2500), (16, 160_000)]


def lags_17(x, p):
    """The 17-sum form of the biased lags (p+1 products and sums)."""
    import torch
    n = x.shape[0]
    return torch.stack([(x[: n - l] * x[l:]).sum(0) / n
                        for l in range(p + 1)])


def host_us(fn, n=2000):
    """Host microseconds a call of fn, n calls back to back."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def rel(got, want):
    d = (got.double() - want.double()).abs().max().item()
    return d / max(want.double().abs().max().item(), 1e-30)


def main():
    import torch
    root = open_root("k5_ab")
    import dsptpu_torch
    from dsptpu_torch.kernels import levinson as lev
    # the module (ops/__init__ binds the name lpc to the function)
    lpc_mod = importlib.import_module("dsptpu_torch.ops.lpc")
    for line in ptxas_lines("levinson"):
        print(f"  levinson: {line}", flush=True)
    res = {"root": root}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(32 << 20, device=dev)       # 128 MB

    for p, C in SHAPES:
        x = torch.randn(400, C, device=dev, generator=gen)
        R = lags_17(x, p)
        del x
        err = max(rel(g, w) for g, w in zip(lev.levinson(R, p),
                                           lev.levinson_reference(R, p)))
        if not err <= 1e-4:
            raise SystemExit(f"k5_ab: p {p} C {C}: relative error {err}")
        tag = f"p{p}_C{C}"
        res[f"{tag}_rel_err"] = err
        res[f"{tag}_device_ms"] = device_ms(lambda: lev.levinson(R, p),
                                            "levinson", calls=10)
        res[f"{tag}_event_1_ms"] = time_ms(lambda: lev.levinson(R, p),
                                           reps=20, warmup=3)
        res[f"{tag}_event_10_ms"] = time_ms(lambda: lev.levinson(R, p),
                                            reps=20, warmup=3, inner=10)
        if C > 100_000:
            def flushed():
                flush.zero_()
                lev.levinson(R, p)
            res[f"{tag}_flushed_device_ms"] = device_ms(flushed, "levinson",
                                                        calls=10)
            print(f"  K5 p {p} C {C}: device with the L2 flushed "
                  f"{res[f'{tag}_flushed_device_ms']:.5f} ms", flush=True)
        print(f"  K5 p {p} C {C}: device {res[f'{tag}_device_ms']:.5f} ms, "
              f"events one call {res[f'{tag}_event_1_ms']:.5f} ms, 10 "
              f"calls {res[f'{tag}_event_10_ms']:.5f} ms a call, rel err "
              f"{err:.2e}", flush=True)
        if (p, C) == SHAPES[0]:
            ix = R.get_device()
            for name, fn in (
                    ("wrapper", lambda: lev.levinson(R, p)),
                    ("empty", lambda: torch.empty((2 * p + 1, C),
                                                  device=dev)),
                    ("stream", lambda: torch.cuda.current_stream(
                        ix).cuda_stream)):
                res[f"host_us_{name}"] = host_us(fn)
            print("  host us a call at p 16 C 2500: " + ", ".join(
                f"{k[8:]} {v:.2f}" for k, v in res.items()
                if k.startswith("host_us_")), flush=True)

    forward, (xs,) = dsptpu_torch.filtfilt_lpc_entry(device="cuda")
    p, flen = 16, 400
    nfr = xs.shape[0] // flen
    frames = xs[: nfr * flen, 0].reshape(nfr, flen).T.contiguous()
    forms = {"lags_17": lambda: lags_17(frames, p),
             "lpc_stage": lambda: dsptpu_torch.lpc(frames, p, "levinson")}
    if hasattr(lpc_mod, "_biased_lags"):
        forms["lags_batched"] = lambda: lpc_mod._biased_lags(frames, p)
        R17 = lags_17(frames, p)
        res["lags_batched_max_d_over_R0"] = ((
            lpc_mod._biased_lags(frames, p) - R17).abs().max()
            / R17[0].abs().max()).item()
    for name, fn in forms.items():
        by = device_by_kernel(fn, "", calls=10)
        res[f"{name}_device_ms"] = sum(v[0] for v in by.values())
        res[f"{name}_device_ms_by_kernel"] = by
        res[f"{name}_launches"] = sum(v[1] for v in by.values())
        res[f"{name}_event_1_ms"] = time_ms(fn, reps=20, warmup=3)
        print(f"  {name}: device {res[f'{name}_device_ms']:.5f} ms in "
              f"{res[f'{name}_launches']:.0f} launches, events one call "
              f"{res[f'{name}_event_1_ms']:.5f} ms", flush=True)

    call = time_ms(lambda: forward(xs), reps=10, warmup=2)
    busy = device_ms(lambda: forward(xs), "", calls=3)
    res.update(path_b_call_ms=call, path_b_device_ms=busy,
               path_b_idle_share=max(0.0, 1 - busy / call))
    print(f"  path B: call {call:.4f} ms, device {busy:.4f} ms, idle share "
          f"{res['path_b_idle_share']:.3f}", flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
