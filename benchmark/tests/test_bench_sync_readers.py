"""The readers of the host's waits on the card (host_syncs, sync_wait_ms,
upload_kib) on synthetic traces with one device record: their sums and
per-call division over the program's own counters and spans, 0.0 where
the program counts its waits and none has a `sync.` or `upload.bytes`
name, None with no device record or in a program that does not count
its waits; on the spans and counters of tiny warm calls of the sharded
chain on the CPU; and every cell loading the three readers."""

import json

import pytest
import torch
import torch.distributed as dist

from benchmark import devtrace, harness
from benchmark.tests.helpers import ROOT, SEED

R = devtrace.Record
NAMES = ("host_syncs", "sync_wait_ms", "upload_kib")
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def reader(name):
    return harness._load(ROOT / "benchmark" / "metrics" / f"{name}.py",
                         "metric")


def trace(calls=2, device=True):
    return devtrace.Trace(
        calls=calls, window=(10.0, 10.010),
        device=[R("void k(float*)", 10.001, 10.002, "kernel")] if device
        else [], host=[], host_s=[0.001] * calls)


@pytest.fixture
def clean():
    """Tracing off, the ring and counters empty, before and after."""
    from dsptpu_torch import kernels
    from dsptpu_torch.utils import profiling
    profiling.tracing(False)
    kernels.reset_launches()
    yield profiling
    profiling.tracing(False)
    kernels.reset_launches()


def test_counter_readers_sum_and_divide(clean):
    # both profiled windows of 2 calls each: 4 calls
    clean.count("sync.a.window", 4)
    clean.count("sync.b.scale", 8)
    clean.count("table.biir.hit", 40)
    clean.count("shard.reblock.bytes", 1 << 20)
    clean.count("upload.bytes", 4 * 8200)
    assert reader("host_syncs").read(trace()) == 3.0
    assert reader("upload_kib").read(trace()) == pytest.approx(8200 / 1024)
    assert reader("host_syncs").read(trace(calls=4)) == 1.5


def test_sync_wait_ms_sums_the_sync_self_times(clean):
    clean.tracing(True)
    for _ in range(3):
        with clean.span("entry"):
            torch.ones(1000).cumsum(0)
            with clean.span("sync.a.window"):
                torch.ones(1000).cumsum(0)
                with clean.span("inner"):
                    torch.ones(1000).cumsum(0)
            with clean.span("sync.b.scale"):
                pass
    recs = clean.spans()
    first2 = [r[1] for r in recs if r[2] < 0][:2]
    inner = {r[1]: r[5] - r[4] for r in recs if r[3] == "inner"}
    want = sum(r[5] - r[4] - (inner[r[1]] if r[3] == "sync.a.window" else 0)
               for r in recs if r[1] in first2 and r[3].startswith("sync."))
    got = reader("sync_wait_ms").read(trace(calls=2))
    assert got == pytest.approx(want / 2 / 1e6, abs=1e-9)
    assert 0 < got < 1e3 * sum(clean.self_times(2).values())
    assert reader("sync_wait_ms").read(trace(calls=4)) is None


def test_no_sync_name_reads_zero(clean):
    clean.count("table.biir.hit", 3)
    clean.tracing(True)
    for _ in range(2):
        with clean.span("entry"):
            with clean.span("kernel.biir"):
                pass
    for name in NAMES:
        assert reader(name).read(trace()) == 0.0
    # counters and ring reset: nothing counted is no wait either
    clean.reset()
    assert reader("host_syncs").read(trace()) == 0.0
    assert reader("upload_kib").read(trace()) == 0.0


@pytest.mark.parametrize("name", NAMES)
def test_no_device_record_reads_nothing(clean, name):
    clean.count("sync.a.window", 4)
    clean.count("upload.bytes", 64)
    clean.tracing(True)
    for _ in range(2):
        with clean.span("entry"):
            with clean.span("sync.a.window"):
                pass
    assert reader(name).read(trace()) is not None
    assert reader(name).read(trace(device=False)) is None


@pytest.mark.parametrize("name", NAMES)
def test_program_without_wait_counting_reads_nothing(clean, monkeypatch,
                                                     name):
    """A program older than the wait counters (it has no to_host) reads
    None, not a false 0."""
    from dsptpu_torch.utils import device
    clean.count("table.biir.hit", 3)
    clean.tracing(True)
    for _ in range(2):
        with clean.span("entry"):
            pass
    assert reader(name).read(trace()) == 0.0
    monkeypatch.delattr(device, "to_host")
    assert reader(name).read(trace()) is None


@pytest.fixture
def sharded_calls(clean):
    """Spans and counters of 4 warm calls of chain64.sharded1's forward
    on a tiny block on the CPU (a world-size-1 gloo mesh), with tracing
    on; the process group is destroyed after."""
    made = not dist.is_initialized()
    cell = harness.Cell(ROOT, "chain64.sharded1")
    try:
        forward = cell.config.build(cell.cfg, 8192, 2, "cpu")
        x = torch.randn(8192, 2,
                        generator=torch.Generator().manual_seed(SEED))
        forward(x)
        clean.reset()
        clean.tracing(True)
        for _ in range(4):
            forward(x)
        clean.tracing(False)
        yield clean.spans()
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


def test_readers_on_the_sharded_chain(sharded_calls, clean):
    """A warm call waits three times in shard_welch: the float64 window's
    upload (1024 points, 8 KiB) and the one-sided weights' two host
    scalars (4 bytes each); the counters cover 4 calls, the readers' 2 x
    2."""
    c = clean.counters()
    assert {k: v for k, v in c.items() if k.startswith("sync.")} == {
        "sync.shard_welch.window": 4, "sync.shard_welch.scale": 8}
    assert c["upload.bytes"] == 4 * (8 * 1024 + 2 * 4)
    assert reader("host_syncs").read(trace()) == 3.0
    assert reader("upload_kib").read(trace()) == pytest.approx(
        8200 / 1024)
    syncs = [r for r in sharded_calls if r[3].startswith("sync.")]
    assert len(syncs) == 12
    parents = {r[0]: r[3] for r in sharded_calls}
    assert {parents[r[2]] for r in syncs} == {"shard_welch"}
    first2 = [r[1] for r in sharded_calls if r[2] < 0][:2]
    want = sum(r[5] - r[4] for r in syncs if r[1] in first2) / 2 / 1e6
    assert reader("sync_wait_ms").read(trace()) == pytest.approx(
        want, abs=1e-9)


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_loads_the_three_readers(workload):
    cell = harness.Cell(ROOT, workload)
    assert set(NAMES) <= set(cell.readers)
    for name in NAMES:
        m = next(m for m in cell.per_layer if m["name"] == name)
        assert m["layer"] == "ops and routing (host)"
        assert m["moves"] == "call_p95_ms" and m["better"] == "lower"
    assert len(CELLS) == 7
