"""Tracing/profiling and roofline accounting (dsptpu's utils/profiling.py
on torch.profiler and CUDA events).

`trace` writes a torch.profiler trace that Perfetto (or
chrome://tracing) opens; `annotate` names a region in it; `Roofline`
turns a time into shares of the card's peaks; `measure` times a call on
the card with CUDA events.
"""

import contextlib
import math
import os
import time

import torch

__all__ = ["trace", "annotate", "Roofline", "measure"]

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit): HBM3
# bytes/s and float32 FLOP/s on the CUDA cores, outside the tensor cores.
# Override for other cards via Roofline(...).
H100_HBM_BW = 3.35e12
H100_F32_FLOPS = 67e12


@contextlib.contextmanager
def trace(logdir):
    """Collect a torch.profiler trace of the block (CPU activity, and the
    card's where CUDA is available) into `logdir` as a Chrome trace JSON
    file, trace_<pid>_<ns>.json, that Perfetto opens. Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name):
    """Named region that shows up in profiler traces."""
    return torch.profiler.record_function(name)


class Roofline:
    """Roofline accounting for one kernel or op call, against the card's
    peaks (default: one H100 SXM at 700 W)."""

    def __init__(self, hbm_bw=H100_HBM_BW, peak_flops=H100_F32_FLOPS):
        self.hbm_bw = hbm_bw
        self.peak_flops = peak_flops

    def fractions(self, seconds, min_bytes=None, flops=None,
                  precision="highest"):
        """Achieved shares of the memory and compute rooflines, with the
        key names of dsptpu's Roofline so that callers port unchanged:
        "hbm_frac", the bytes the call must move (`min_bytes`) per second
        over the device memory rate; "mxu_frac", the useful float32
        operations (`flops`) per second over the float32 peak of the
        CUDA cores (on the TPU it was the matrix unit's, counted in six
        bf16 passes; the port computes float32 in full float32, so only
        precision="highest" is taken); "tflops", operations per second
        in units of 10^12."""
        if precision != "highest":
            raise ValueError("the port computes float32 in full float32: "
                             "precision must be 'highest'")
        out = {}
        if min_bytes is not None:
            out["hbm_frac"] = (min_bytes / seconds) / self.hbm_bw
        if flops is not None:
            out["mxu_frac"] = (flops / seconds) / self.peak_flops
            out["tflops"] = flops / seconds / 1e12
        return out


def measure(fn, *args, reps=3, k=8, latency=0.0):
    """Best of `reps` CUDA-event times, in seconds per call, of k calls of
    fn(*args) back to back after one warm-up call, minus `latency` per
    run of k (timed as tools/ab_common.py's time_ms times, which takes
    the median where this takes the best). Raises without CUDA: there is
    no device to time."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure times the card: CUDA is not available")
    fn(*args)
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(k):
            fn(*args)
        b.record()
        b.synchronize()
        best = min(best, (a.elapsed_time(b) / 1e3 - latency) / k)
    return max(best, 1e-9)
