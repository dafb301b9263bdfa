"""The readers of the program's spans and counters (route_ms,
wrapper_ms, table_hit_share) on a synthetic trace with one device
record, over spans and counters that a tiny CPU call of each
configuration's entry records with tracing on."""

import pytest
import torch

from benchmark import devtrace, harness
from benchmark.tests.helpers import ROOT, tiny

R = devtrace.Record
CALLS = 3


def reader(name):
    return harness._load(ROOT / "benchmark" / "metrics" / f"{name}.py",
                         "metric")


def trace(calls=CALLS, device=True):
    return devtrace.Trace(
        calls=calls, window=(10.0, 10.010),
        device=[R("void k(float*)", 10.001, 10.002, "kernel")] if device
        else [], host=[], host_s=[0.001] * calls)


@pytest.fixture(params=["chain64.epoch64k", "speech.mono1m"])
def recorded(request):
    """Spans and counters of CALLS calls of the cell's entry, on tiny
    warm blocks on the CPU; the ring's records."""
    from dsptpu_torch import kernels
    from dsptpu_torch.utils import profiling
    cell = harness.Cell(ROOT, request.param)
    t = tiny(request.param)
    forward = cell.config.build(cell.cfg, t["rows"], t["channels"],
                                torch.device("cpu"))
    x = torch.randn(t["rows"], t["channels"])
    forward(x)
    kernels.reset_launches()
    profiling.tracing(True)
    try:
        for _ in range(CALLS):
            forward(x)
    finally:
        profiling.tracing(False)
    yield profiling.spans()
    kernels.reset_launches()


def test_route_and_wrapper_split_the_entry(recorded):
    route = reader("route_ms").read(trace())
    wrapper = reader("wrapper_ms").read(trace())
    entries = [r for r in recorded if r[3] == "entry"]
    assert len(entries) == CALLS and all(r[2] < 0 for r in entries)
    mean_entry_ms = sum(r[5] - r[4] for r in entries) / CALLS / 1e6
    assert route > 0 and wrapper > 0
    assert route + wrapper == pytest.approx(mean_entry_ms, abs=1e-9)


def test_table_hit_share_of_warm_calls(recorded):
    assert reader("table_hit_share").read(trace()) == 1.0


@pytest.mark.parametrize("name", ["route_ms", "wrapper_ms",
                                  "table_hit_share"])
def test_no_device_record_reads_nothing(recorded, name):
    assert reader(name).read(trace(device=False)) is None


def test_too_few_root_spans_read_nothing(recorded):
    for name in ("route_ms", "wrapper_ms"):
        assert reader(name).read(trace(calls=CALLS + 1)) is None


def test_no_spans_or_lookups_read_nothing(monkeypatch):
    """A reset ring and counters, and a program without spans or
    counters (one older than them), read None."""
    from dsptpu_torch import kernels
    from dsptpu_torch.utils import profiling
    kernels.reset_launches()
    for name in ("route_ms", "wrapper_ms", "table_hit_share"):
        assert reader(name).read(trace()) is None
    profiling.count("table.probe.miss")
    monkeypatch.delattr(profiling, "self_times")
    monkeypatch.delattr(profiling, "counters")
    for name in ("route_ms", "wrapper_ms", "table_hit_share"):
        assert reader(name).read(trace()) is None
    kernels.reset_launches()
