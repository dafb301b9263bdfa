"""The host's waits on the card in each benchmark cell, and what tracing
costs the host, at the cells' own shapes on the card.

    python3 tools/probes/host_waits.py waits [CELL ...]
    python3 tools/probes/host_waits.py cost [CELL ...]

Each cell's forward is built by its configuration (benchmark/configs)
on the cell's traffic shape and warmed on a pool of blocks made on the
card.

waits: for each cell, (1) the synchronizing operations of 3 warm calls
under torch.cuda.set_sync_debug_mode("warn"), by the program's frames
that issued them, against the sum of the program's `sync.*` counters
(utils.device) of the same calls; (2) a torch.profiler window of 20
warm calls with the host's activity: the runtime calls that block the
host (cudaStreamSynchronize, cudaDeviceSynchronize,
cudaEventSynchronize) and every cudaMemcpyAsync a call, the device's
memcpy records a call by kind (the profiler names pageable copies), and
the program's `sync.*` ranges a call. One JSON line a cell.

cost: for each cell, the host time a call (forward's return, before the
synchronize that closes each closed-loop call) over 1000 warm calls,
in 8 alternating blocks of 125 with tracing off and on
(utils.profiling.tracing), as mean and median ms; the spans a traced
call records and how many of them are `sync.*`; and the host's cost of
one span with tracing on (100,000 empty spans inside a root). One JSON
line a cell, then one of the span cost.
"""

import collections
import json
import os
import statistics
import sys
import time
import traceback
import warnings

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from dsptpu_torch import kernels  # noqa: E402
from dsptpu_torch.utils import profiling  # noqa: E402

CELLS = ("chain64.block1m", "speech.mono1m", "speech.batch64",
         "chain64.epoch64k", "fftfilt16.block10m", "multitaper64.block1m",
         "chain64.sharded1")
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize")


def built(name, seed=12345):
    cell = harness.Cell(ROOT, name)
    rows, channels, npool = cell.shape()
    dev = torch.device("cuda")
    fwd = cell.config.build(cell.cfg, rows, channels, dev)
    pool = harness.make_pool(rows, channels, npool, seed, dev)
    for i in range(max(4, npool)):
        fwd(pool[i % npool])
        torch.cuda.synchronize()
    return fwd, pool


def _frames():
    """The program's frames of the current stack, innermost first."""
    out = []
    for f in reversed(traceback.extract_stack()[:-2]):
        rel = os.path.relpath(f.filename, ROOT)
        if rel.startswith(("dsptpu_torch", "benchmark")):
            out.append(f"{rel}:{f.lineno} {f.name}")
    return " <- ".join(out[:4])


def sync_audit(fwd, pool, calls=3):
    """({issuing frames: warnings a call}, warnings a call, sync.*
    counted a call) of `calls` warm calls under sync debug mode."""
    sites = collections.Counter()
    kernels.reset_launches()

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" in str(message):
            sites[_frames()] += 1
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(calls):
                fwd(pool[i % len(pool)])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    counted = sum(v for k, v in profiling.counters().items()
                  if k.startswith("sync."))
    return ({k: v / calls for k, v in sites.items()},
            sum(sites.values()) / calls, counted / calls)


def profiled_waits(fwd, pool, calls=20):
    """Runtime calls, memcpy records and sync ranges a call, from a
    torch.profiler window of `calls` warm calls with the host's
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fwd(pool[i % len(pool)])
            torch.cuda.synchronize()
    runtime, memcpy, spans = (collections.Counter() for _ in range(3))
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name.startswith("Memcpy"):
            memcpy[e.name] += 1
        elif e.name in BLOCKING or e.name == "cudaMemcpyAsync":
            runtime[e.name] += 1
        elif e.name.startswith("sync."):
            spans[e.name] += 1
    # each call ends with the loop's own torch.cuda.synchronize
    runtime["cudaDeviceSynchronize"] -= calls
    per = lambda c: {k: v / calls for k, v in sorted(c.items()) if v}
    return {"runtime": per(runtime), "memcpy": per(memcpy),
            "sync_spans": per(spans)}


def waits(names):
    for name in names:
        fwd, pool = built(name)
        sites, warned, counted = sync_audit(fwd, pool)
        line = {"cell": name, "sync_warnings": warned,
                "sync_counted": counted, "sites": sites}
        line.update(profiled_waits(fwd, pool))
        print(json.dumps(line), flush=True)
        del fwd, pool
        torch.cuda.empty_cache()


def host_ms(fwd, pool, calls):
    out = []
    for i in range(calls):
        a = time.perf_counter()
        o = fwd(pool[i % len(pool)])
        out.append(time.perf_counter() - a)
        torch.cuda.synchronize()
        del o
    return out


def cost(names, calls=1000, blocks=8):
    for name in names:
        fwd, pool = built(name)
        t = {False: [], True: []}
        for b in range(blocks):
            on = bool(b % 2)
            profiling.tracing(on)
            t[on] += host_ms(fwd, pool, calls // blocks)
        profiling.tracing(False)
        kernels.reset_launches()
        profiling.tracing(True)
        fwd(pool[0])
        torch.cuda.synchronize()
        profiling.tracing(False)
        recs = profiling.spans()
        line = {"cell": name, "calls": calls, "card": harness.card_line()}
        for on, key in ((False, "off"), (True, "on")):
            line[f"host_ms_{key}_mean"] = 1e3 * statistics.fmean(t[on])
            line[f"host_ms_{key}_median"] = 1e3 * statistics.median(t[on])
        line["spans_a_call"] = len(recs)
        line["sync_spans_a_call"] = sum(r[3].startswith("sync.")
                                        for r in recs)
        print(json.dumps(line), flush=True)
        del fwd, pool
        torch.cuda.empty_cache()
    n = 100_000
    profiling.tracing(True)
    with profiling.span("root"):
        a = time.perf_counter()
        for _ in range(n):
            with profiling.span("sync.probe"):
                pass
        on = (time.perf_counter() - a) / n
    profiling.tracing(False)
    a = time.perf_counter()
    for _ in range(n):
        with profiling.span("sync.probe"):
            pass
    off = (time.perf_counter() - a) / n
    kernels.reset_launches()
    print(json.dumps({"span_us_on": 1e6 * on, "span_us_off": 1e6 * off}),
          flush=True)


if __name__ == "__main__":
    what, names = sys.argv[1], sys.argv[2:] or CELLS
    {"waits": waits, "cost": cost}[what](names)
