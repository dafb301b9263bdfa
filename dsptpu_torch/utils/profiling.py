"""Tracing/profiling and roofline accounting (dsptpu's utils/profiling.py
on torch.profiler and CUDA events).

`trace` writes a torch.profiler trace that Perfetto (or
chrome://tracing) opens; `annotate` names a region in it; `Roofline`
turns a time into shares of the card's peaks; `measure` times a call on
the card with CUDA events; `device_by_kernel` sums a call's device time
by kernel from a torch.profiler window.
"""

import contextlib
import math
import os
import re
import time

import torch

__all__ = ["trace", "annotate", "Roofline", "measure", "device_by_kernel"]

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


def _device_events(fn, calls, flush):
    """(kernel name, device µs, launches) of each CUDA kernel of `calls`
    calls of fn() under torch.profiler. The window opens with a spin of
    about 1 ms, left out: the device records of a window's first
    fraction of a millisecond have gone missing on the H100. With
    `flush`, each call follows flush.zero_(), whose fill kernel is left
    out too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(2_000_000)
        for _ in range(calls):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            and "spin" not in e.key
            and not (flush is not None and "FillFunctor" in e.key)]


def device_by_kernel(fn, calls=10, flush=None, log=print, name="",
                     exclude=()):
    """Device time and launches per call of fn() by kernel, {name: [ms,
    launches]}, by torch.profiler over `calls` calls after one warm-up
    call (see _device_events for the leading spin and `flush`, a write
    larger than the L2 before each call), of the kernels whose signature
    holds `name` (every kernel for "") and none of the strings in
    `exclude`. A profile that holds no device record is reported through
    `log` and taken again once; if that one is empty too, raises
    RuntimeError: a call on the card runs kernels, so an empty profile
    is a failed measurement, never a time of 0."""
    fn()
    torch.cuda.synchronize()
    for attempt in (1, 2):
        events = _device_events(fn, calls, flush)
        if events:
            break
        log(f"device_by_kernel: profile {attempt} of {calls} calls holds "
            "no device record")
    else:
        raise RuntimeError("torch.profiler recorded no device time in two "
                           "profiles of the call")
    out = {}
    for key, us, count in events:
        if name not in key or any(x in key for x in exclude):
            continue
        m = re.search(r"(\w+(?:<[^>]*>)?)\(", key)
        v = out.setdefault(m.group(1) if m else key[:60], [0.0, 0.0])
        v[0] += us / 1e3 / calls
        v[1] += count / calls
    return out
