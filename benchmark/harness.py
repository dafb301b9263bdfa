"""One run of one cell: set-up, the measured window, the traced window,
the check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is found by its name in BENCHMARK.json:

    benchmark/configs/<config>.json   the configuration as it is run
    benchmark/configs/<config>.py     build(), outputs(), counts()
    benchmark/reference/<config>.py   reference(cfg, x, precision)
    benchmark/traffic/<traffic>.json  the traffic mix's parameters
    benchmark/cells/<cell>.json       the limits of the check
    benchmark/metrics/<metric>.py     read(trace) of a per-layer metric

Traffic is closed-loop, one caller: each call's block comes from a pool
of distinct blocks made on the device from the seed and used in turn,
and the next call is issued once the last call's outputs are ready.
"""

import argparse
import gc
import importlib.util
import json
import math
import random
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

import torch

from benchmark import devtrace, roofline

# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "dsptpu")
GIB = float(1 << 30)


def _load(path, kind):
    """The module in `path`, under a name of its own per kind and file."""
    name = f"benchmark._{kind}_" + "".join(
        c if c.isalnum() else "_" for c in path.stem)
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return mod


def _one(entries, name, what):
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"BENCHMARK.json has no single {what} {name!r}")
    return found[0]


class Cell:
    """A workload of BENCHMARK.json with its files, loaded by name."""

    def __init__(self, root, workload):
        root = Path(root)
        spec = json.loads((root / "BENCHMARK.json").read_text())
        self.workload = _one(spec["workloads"], workload, "workload")
        self.name = workload
        self.config_entry = _one(spec["configs"], self.workload["config"],
                                 "config")
        cfg_file = root / self.config_entry["file"]
        self.cfg = json.loads(cfg_file.read_text())
        self.config = _load(cfg_file.with_suffix(".py"), "config")
        bench = root / "benchmark"
        self.reference = _load(
            bench / "reference" / f"{self.config_entry['name']}.py",
            "reference")
        self.traffic = json.loads((bench / "traffic" / (
            self.workload["traffic"] + ".json")).read_text())
        self.limits = json.loads((bench / "cells" / (
            workload + ".json")).read_text())["limits"]
        missing = set(self.config.OUTPUTS) - set(self.limits)
        if missing:
            raise KeyError(f"cell {workload}: no limit for {sorted(missing)}")
        self.end_to_end = [m for m in spec["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        moves = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if workload in m.get("workloads", [])
                          or ("workloads" not in m and m["moves"] in moves)]
        self.readers = {m["name"]: _load(bench / "metrics" / (
            m["name"] + ".py"), "metric") for m in self.per_layer}

    def shape(self, override=None):
        """(rows, channels, pool) of the traffic, with `override`."""
        t = dict(self.traffic, **(override or {}))
        return t["rows"], t["channels"], t["pool"]


class Sample:
    """A uniform sample of `k` calls of the window (reservoir sampling,
    drawn from the seed): [(call, block, outputs)]."""

    def __init__(self, k, seed):
        self.k, self.rng, self.kept = k, random.Random(seed), []

    def offer(self, call, block, out):
        if len(self.kept) < self.k:
            self.kept.append((call, block, out))
        else:
            j = self.rng.randrange(call + 1)
            if j < self.k:
                self.kept[j] = (call, block, out)


def make_pool(rows, channels, pool, seed, device):
    """`pool` distinct standard normal float32 blocks (rows, channels),
    made on the device in one call from the seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 64))
    blocks = torch.randn((pool, rows, channels), generator=gen,
                         device=device, dtype=torch.float32)
    return list(blocks.unbind(0))


def _sync(device):
    if device.type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def closed_loop(forward, pool, seconds=None, calls=None, sample=None,
                sync=None):
    """Calls forward(pool[i % len(pool)]) back to back, each after the
    last one's outputs are ready, until `seconds` have passed (the call
    that crosses the line ends the window) or `calls` are done. Returns
    (latency of each call, host time of each call before its
    synchronize, window seconds)."""
    sync = sync or (lambda: None)
    lat, host = [], []
    i = 0
    t0 = time.perf_counter()
    while True:
        b = i % len(pool)
        a = time.perf_counter()
        out = forward(pool[b])
        h = time.perf_counter()
        sync()
        e = time.perf_counter()
        lat.append(e - a)
        host.append(h - a)
        if sample is not None:
            sample.offer(i, b, out)
        del out
        i += 1
        if (calls is not None and i >= calls) or (
                seconds is not None and e - t0 >= seconds):
            return lat, host, e - t0


def percentile(values, q):
    """The q-th percentile of values, linear between order statistics."""
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def gap(got, ref):
    """max |got - ref| / max |ref|, in float64; inf for a wrong shape or a
    value that is not finite."""
    if tuple(got.shape) != tuple(ref.shape):
        return math.inf
    ref = ref.to(torch.float64)
    d = float((got.to(torch.float64) - ref).abs().max())
    s = float(ref.abs().max())
    v = d / s if s > 0 else (0.0 if d == 0 else math.inf)
    return v if math.isfinite(v) else math.inf


def judge(cell, sample, pool, candidate=None):
    """[{output name: gap}] of each sampled call: the program's outputs
    (or, with `candidate`, candidate(block): the control) against the
    float64 reference of the same block."""
    per_call = []
    for _, b, out in sample.kept:
        ref = cell.reference.reference(cell.cfg, pool[b], "float64")
        got = (cell.config.outputs(out) if candidate is None
               else candidate(pool[b]))
        per_call.append({k: gap(got[k], ref[k]) for k in cell.config.OUTPUTS})
        del ref, got
    return per_call


def widest(per_call, names):
    """{output name: the widest gap over the calls}."""
    return {k: max((r[k] for r in per_call), default=0.0) for k in names}


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def card_line():
    """nvidia-smi's name and power limit of the card."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def _fmt(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def run_cell(root, workload, seed, seconds, trace, device="cuda",
             t_start=None, shape=None, out=None, err=None):
    """One run of `workload`; prints the result line and returns it.

    shape: overrides of the traffic's parameters (tests at a tiny size
    on the CPU). device: "cuda" for every run of the benchmark; "cpu"
    only from the tests, with the plain versions."""
    out, err = out or sys.stdout, err or sys.stderr
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(root, workload)
    dev = torch.device(device)
    sync = _sync(dev)
    cuda = dev.type == "cuda"
    rows, channels, npool = cell.shape(shape)
    t = dict(cell.traffic, **(shape or {}))

    marks = [("imports", time.perf_counter())]
    forward = cell.config.build(cell.cfg, rows, channels, dev)
    marks.append(("entry", time.perf_counter()))
    pool = make_pool(rows, channels, npool, seed, dev)
    sync()
    marks.append(("pool", time.perf_counter()))
    # warm-up: every shape of the window, with the window's retention
    closed_loop(forward, pool, calls=t["warmup_calls"],
                sample=Sample(t["check_calls"], seed), sync=sync)
    sync()
    gc.collect()
    marks.append(("warm-up", time.perf_counter()))
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    last = t_start
    parts = []
    for what, at in marks:
        parts.append(f"{what} {at - last:.3f} s")
        last = at
    print(f"set-up {setup_s:.3f} s: " + ", ".join(parts), file=err)

    sample = Sample(t["check_calls"], seed)
    lat, host, window = closed_loop(forward, pool, seconds=seconds,
                                    sample=sample, sync=sync)
    calls = len(lat)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    e2e = {
        "samples_per_s": calls * rows * channels / window,
        "call_p95_ms": 1e3 * percentile(lat, 95),
        "setup_s": setup_s,
    }
    if cuda:
        e2e["peak_mem_gib"] = window_peak / GIB
    print(f"window: {calls} calls in {window:.4f} s, call median "
          f"{1e3 * percentile(lat, 50):.4f} ms, p95 "
          f"{e2e['call_p95_ms']:.4f} ms, host median "
          f"{1e3 * percentile(host, 50):.4f} ms", file=err)

    result = {"correct": False, "attempted": calls, "failed": 0}
    extra = {}
    if trace:
        metrics, extra = _traced(cell, forward, pool, host, rows, channels,
                                 t["profile_calls"], dev, err)
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in e2e}
    peak = max(setup_peak, window_peak,
               torch.cuda.max_memory_allocated()) if cuda else 0
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda
                   else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    device_info.update(extra.pop("device", {}))

    # the check, once the program's state is freed
    del forward
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    per_call = judge(cell, sample, pool)
    readings = widest(per_call, cell.config.OUTPUTS)
    failed = [k for k, v in readings.items()
              if not v <= cell.limits[k]["limit"]]
    failed_calls = sum(any(not r[k] <= cell.limits[k]["limit"] for k in r)
                       for r in per_call)
    print(f"check: {len(sample.kept)} sampled calls of {calls} (calls "
          f"{sorted(c for c, _, _ in sample.kept)}) in "
          f"{time.perf_counter() - t0:.2f} s", file=err)
    result.update(correct=not failed, failed=failed_calls, metrics=metrics,
                  device=device_info)
    result.update(extra)
    if cuda:
        result["card"] = card_line()
    result["checks"] = {k: {"value": _fmt(v),
                            "limit": cell.limits[k]["limit"]}
                        for k, v in readings.items()}

    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=err)
        raise SystemExit(4)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}"
              + ("" if k not in failed else " FAILED"), file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return result


def _profiled(forward, pool, n, dev, host_activity):
    """torch.profiler over n closed-loop calls, after a spin of about 1
    ms on the card; returns (profile, host-clock seconds of the calls).
    With host_activity the host's operations are recorded too (which
    slows the host), inside a record_function(WINDOW) range."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = dev.type == "cuda"
    sync = _sync(dev)
    acts = ([ProfilerActivity.CUDA] if cuda else []) + (
        [ProfilerActivity.CPU] if host_activity or not cuda else [])
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*clears events.*")
        with profile(activities=acts) as prof:
            if cuda:
                torch.cuda._sleep(2_000_000)
                sync()
            t0 = time.perf_counter()
            with record_function(devtrace.WINDOW):
                for j in range(n):
                    with record_function(devtrace.CALL):
                        out = forward(pool[j % len(pool)])
                        sync()
                        del out
            seconds = time.perf_counter() - t0
        prof.events()
    return prof, seconds


def _traced(cell, forward, pool, host_s, rows, channels, n, dev, err):
    """The per-layer metrics of the traced run; returns (metrics, extra
    keys of the result line).

    Two profiled windows of n closed-loop calls: the first records the
    device alone, so that the host runs at its own speed, and gives
    every device figure (busy and window seconds, launches, device time,
    idle share, the device operations); the second records the host's
    operations too, only to name what the host was doing in the
    device's idle gaps (its gaps are longer by the profiler's own host
    cost). A device profile with no record is taken again once, then
    fails the run: calls on the card run kernels, so an empty profile
    is a failed measurement, never a time of 0."""
    # the kernel wrappers' own launch counters, read beside the profile
    from dsptpu_torch import kernels
    for attempt in (1, 2):
        kernels.reset_launches()
        prof, window_s = _profiled(forward, pool, n, dev,
                                   host_activity=False)
        dev_recs, _, _ = devtrace.records(prof)
        if dev_recs or dev.type != "cuda":
            break
        print(f"traced: device profile {attempt} holds no record", file=err)
    else:
        raise RuntimeError("torch.profiler recorded no device work in two "
                           "profiles")
    counters = {k: v / n for k, v in kernels.launch_counts().items() if v}
    start = min((r.start for r in dev_recs), default=0.0)
    c = cell.config.counts(cell.cfg, rows, channels)
    tr = devtrace.Trace(calls=n, window=(start, start + window_s),
                        device=dev_recs, host=[], host_s=host_s,
                        bound_s=roofline.bound_s(c["bytes"], c["flops"]))
    prof_h, _ = _profiled(forward, pool, n, dev, host_activity=True)
    dev_h, host_h, window_h = devtrace.records(prof_h)
    tr_h = devtrace.Trace(calls=n, window=window_h, device=dev_h,
                          host=host_h, host_s=host_s)
    metrics = {}
    for m in cell.per_layer:
        v = cell.readers[m["name"]].read(tr)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    kinds, route = {}, {}
    for r in tr.in_window():
        kinds[r.kind] = kinds.get(r.kind, 0) + 1
        if r.kind == "kernel":
            k = devtrace.short_name(r.name)
            route[k] = route.get(k, 0) + 1
    per_call = {k: round(v / n, 3) for k, v in kinds.items()}
    print(f"traced: {n} calls in {window_s:.4f} s (device alone), "
          f"{tr_h.window_s():.4f} s (with the host's operations); device "
          f"records a call {per_call}; bound {1e3 * tr.bound_s:.6f} ms "
          f"({c['bytes']} B, {c['flops']:.6g} flop); program launch "
          f"counters a call {counters}", file=err)
    extra = {"device": {"busy_s": tr.busy_s(), "window_s": tr.window_s()}
             if dev.type == "cuda" else {},
             "breakdown": {"device_ops": devtrace.device_ops(tr),
                           "idle_gaps": devtrace.idle_gaps(tr_h)},
             "route": {"kernels": {k: round(v / n, 3)
                                   for k, v in route.items()},
                       "counters": counters,
                       "records_per_call": per_call}}
    return metrics, extra


def main(argv, root, t_start):
    ap = argparse.ArgumentParser(
        prog="benchmark/run.py",
        description="One run of one cell of BENCHMARK.json on the card")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = Cell(root, args.workload)
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark runs on the card only",
                  file=sys.stderr)
            return 3
        chips = cell.workload["chips"]
        if torch.cuda.device_count() < chips:
            print(f"the cell needs {chips} cards, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 3
        run_cell(root, args.workload, args.seed, args.seconds, args.trace,
                 t_start=t_start)
    except SystemExit:
        raise
    except Exception:
        traceback.print_exc()
        return 1
    return 0
