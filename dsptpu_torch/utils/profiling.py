"""Tracing/profiling and roofline accounting (dsptpu's utils/profiling.py
on torch.profiler and CUDA events).

`trace` writes a torch.profiler trace that Perfetto (or
chrome://tracing) opens; `span` names a region of the program in it and
in the span ring that `self_times` reads; `count` and `counters` are
the program's always-on counters, `table_cache` a keyed cache of tables
that counts its lookups; `Roofline` turns a time into shares of the card's
peaks; `measure` times a call on the card with CUDA events;
`device_by_kernel` sums a call's device time by kernel from a
torch.profiler window.

Spans. Tracing is on while a torch profiler records, or after
`tracing(True)`. With tracing off, `span(name)` returns one shared
no-op context (a flag check and no allocation) and `spanned` calls the
function straight through. With tracing on, each span appends one
record, (call id, parent index, name, start ns, end ns) by
`time.perf_counter_ns()`, to a ring of the last RING_RECORDS spans, and
under a profiler also enters a `_RecordFunctionFast` range, on the
profiler's clock beside the device's records. A span opened with no
span open is a root: it opens a new call id, which every span inside it
shares. The ring, the open spans and the counters are module state of
one thread; `reset` (called by `kernels.reset_launches`) empties the
ring and the counters.
"""

import contextlib
import functools
import math
import os
import re
import time

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["trace", "span", "spanned", "tracing", "spans", "self_times",
           "count", "counters", "reset", "table_cache", "Roofline", "measure",
           "device_by_kernel"]

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit): HBM3
# bytes/s and float32 FLOP/s on the CUDA cores, outside the tensor cores.
# Override for other cards via Roofline(...).
H100_HBM_BW = 3.35e12
H100_F32_FLOPS = 67e12


@contextlib.contextmanager
def trace(logdir):
    """Collect a torch.profiler trace of the block (CPU activity, and the
    card's where CUDA is available) into `logdir` as a Chrome trace JSON
    file, trace_<pid>_<ns>.json, that Perfetto opens; the program's
    spans show in it as ranges. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


# spans: a ring of the last RING_RECORDS records, [call id, parent index
# (-1 for a root), name, start ns, end ns (0 while open)]; a record's index
# counts the spans opened since import
RING_RECORDS = 1 << 17
_ring = [None] * RING_RECORDS
_next = 0                   # index of the next record
_first = 0                  # index of the first record since the last reset
_open = []                  # (index, call id) of open spans, innermost last
_calls = 0                  # call ids given out
_tracing = False
_counts = {}
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast


class _Off:
    """The shared no-op span of tracing off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "rec", "rf")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        global _next, _calls
        if _open:
            parent, call = _open[-1]
        else:
            parent, call = -1, _calls
            _calls += 1
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = _RecordFunctionFast(self.name)
            self.rf.__enter__()
        self.rec = [call, parent, self.name, time.perf_counter_ns(), 0]
        _ring[_next % RING_RECORDS] = self.rec
        _open.append((_next, call))
        _next += 1
        return None

    def __exit__(self, *exc):
        self.rec[4] = time.perf_counter_ns()
        _open.pop()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


def span(name):
    """Context: a named region of the program (see the module's
    docstring); a shared no-op while tracing is off."""
    if _tracing or _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


def spanned(name):
    """Decorator: each call of the function inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _tracing or _autograd_profiler._is_profiler_enabled:
                with _Span(name):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        return call
    return wrap


def tracing(on):
    """Record spans (on=True) whether or not a profiler records; with
    False, only while one does."""
    global _tracing
    _tracing = bool(on)


def spans():
    """The ring's records since the last reset, oldest first, as tuples
    (index, call id, parent index, name, start ns, end ns); the end is 0
    while the span is open."""
    lo = max(_first, _next - RING_RECORDS)
    return [(i, *_ring[i % RING_RECORDS]) for i in range(lo, _next)]


def self_times(calls):
    """{span name: mean self seconds a call} over the first `calls` root
    spans of the ring that have closed, or None where it holds fewer. A
    span's self time is its duration less its child spans' durations;
    the self times of a call sum to its root's duration."""
    recs = {r[0]: r for r in spans()}
    roots = [r[1] for r in recs.values() if r[2] < 0 and r[5]][:calls]
    if len(roots) < calls or calls < 1:
        return None
    keep = set(roots)
    ns = {}
    for i, call, parent, name, start, end in recs.values():
        if call in keep:
            ns[name] = ns.get(name, 0) + end - start
            if parent >= 0:
                pname = recs[parent][3]
                ns[pname] = ns.get(pname, 0) - (end - start)
    return {k: v / 1e9 / calls for k, v in ns.items()}


def count(name, k=1):
    """Add k to the counter `name` (always on)."""
    _counts[name] = _counts.get(name, 0) + k


def counters():
    """{counter name: count} since the last reset."""
    return dict(_counts)


def reset():
    """Empty the span ring and the counters."""
    global _first
    _first = _next
    _counts.clear()


def table_cache(name, key, bound=None):
    """Decorator: a keyed cache of the function's results (tables built
    on the host), where key(*args, **kwargs) is a call's key; each
    lookup counts `table.<name>.hit` or `table.<name>.miss`, and a miss
    that finds more than `bound` entries (None: no bound) clears the
    cache first. The cache is the function's `entries` dict."""
    hit, miss = f"table.{name}.hit", f"table.{name}.miss"

    def wrap(build):
        entries = {}

        @functools.wraps(build)
        def get(*args, **kwargs):
            k = key(*args, **kwargs)
            v = entries.get(k)
            if v is not None:
                count(hit)
                return v
            count(miss)
            v = build(*args, **kwargs)
            if bound is not None and len(entries) > bound:
                entries.clear()
            entries[k] = v
            return v
        get.entries = entries
        return get
    return wrap


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
