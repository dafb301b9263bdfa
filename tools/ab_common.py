"""The harness the per-kernel A/B scripts (tools/k*_ab.py) share: each
times the dsptpu_torch package under ROOT on the card, so that two
checkouts can be compared in one call (parent, change, change, parent).
"""

import os
import re
import statistics
import subprocess
import sys


def open_root(tool):
    """Put ROOT (argv[1], default this checkout) first on sys.path, check
    that its dsptpu_torch is the one imported, print the card's nvidia-smi
    name and power limit, build ROOT's kernels, and return ROOT."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: CUDA is not available")
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.join(os.path.dirname(__file__), ".."))
    sys.path.insert(0, root)
    import dsptpu_torch
    from dsptpu_torch.kernels import _build
    if not os.path.abspath(dsptpu_torch.__file__).startswith(root):
        raise SystemExit(f"{tool}: imported {dsptpu_torch.__file__}, "
                         f"not the package under {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    _build.build_all()
    return root


def time_ms(fn, reps, warmup, inner=1):
    """Median over `reps` runs of the CUDA-event time of `inner` calls of
    fn back to back, divided by `inner`, after `warmup` calls."""
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


def ptxas_lines(source):
    """The `-Xptxas -v` lines (entries, registers, stack frames) of kernel
    source `source` from the build log of the package imported last."""
    from dsptpu_torch.kernels import _build
    log = os.path.join(os.path.dirname(_build.build_all()[source]),
                       f"{source}.log")
    return [line.strip() for line in open(log)
            if "Compiling entry" in line or "registers" in line
            or "stack frame" in line]


def device_by_kernel(fn, name="", calls=1, exclude=()):
    """Device time and launches per call of fn, {kernel name: [ms,
    launches]}, of the kernels whose name holds `name` (every kernel for
    "") and none of the strings in `exclude`, by torch.profiler over
    `calls` calls after one unprofiled call. The window starts with a
    spin kernel of about a millisecond, left out of the sum: the device
    records of a window's first fraction of a millisecond can go
    missing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(2_000_000)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if (e.device_type == DeviceType.CUDA and not e.is_user_annotation
                and "spin" not in e.key and name in e.key
                and not any(x in e.key for x in exclude)):
            m = re.search(r"(\w+(?:<[^>]*>)?)\(", e.key)
            key = m.group(1) if m else e.key[:60]
            v = out.setdefault(key, [0.0, 0.0])
            v[0] += e.self_device_time_total / 1e3 / calls
            v[1] += e.count / calls
    return out


def device_ms_by_kernel(fn, name="", calls=1, exclude=()):
    """Device time per call of fn, {kernel name: ms}: device_by_kernel
    without the launches."""
    return {k: v[0] for k, v in
            device_by_kernel(fn, name, calls, exclude).items()}


def device_ms(fn, name="", calls=1):
    """The sum of device_ms_by_kernel: device time per call of fn of the
    kernels whose name holds `name`."""
    return sum(device_ms_by_kernel(fn, name, calls).values())
