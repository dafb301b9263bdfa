"""The `os4096_16ch` configuration and its cell `fftfilt16.block10m` at a
tiny size on the CPU (K4's plain version): the cell's result line and
its check; the counts against values worked out by hand; the control
(the reference in TF32) and faults planted in the timed path failing
the limit; the cell's four readers on synthetic profiler records and on
the spans and counters of tiny calls of the entry; and the imports."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import devtrace, harness, readings, roofline
from benchmark.tests.helpers import ROOT, SEED, run_tiny
from dsptpu_torch import kernels, pipeline
from dsptpu_torch.utils import profiling

CELL = "fftfilt16.block10m"
TINY = {"rows": 50_000, "channels": 3, "pool": 3, "warmup_calls": 4,
        "profile_calls": 8}
R = devtrace.Record


def reader(name):
    return harness._load(ROOT / "benchmark" / "metrics" / f"{name}.py",
                         "metric")


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_tiny_cpu_line(trace):
    res, _, err = run_tiny(CELL, trace, shape=TINY)
    assert res["correct"] is True, err
    assert res["attempted"] > 0 and res["failed"] == 0
    cell = harness.Cell(ROOT, CELL)
    assert list(res["checks"]) == ["y"]
    assert res["checks"]["y"]["value"] <= cell.limits["y"]["limit"]
    if trace:
        # no device records on the CPU: none of the four reads anything
        assert res["metrics"] == {}
    else:
        # the end-to-end metrics that list no cells; peak_mem_gib is
        # read on the card only
        assert set(res["metrics"]) == {"call_p95_ms", "setup_s"}


def test_cell_entries():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = [w for w in spec["workloads"] if w["name"] == CELL]
    assert len(w) == 1 and w[0]["chips"] == 1
    cell = harness.Cell(ROOT, CELL)
    assert cell.cfg["reduced"] == [] and cell.config_entry["reduced"] == []
    assert {m["name"] for m in cell.end_to_end} == {
        "call_p95_ms", "peak_mem_gib", "setup_s"}
    assert [m["name"] for m in cell.per_layer] == [
        "osconv_ms", "osconv_roofline", "fftfilt_host_ms",
        "os_table_hit_share"]
    assert all(m["workloads"] == [CELL] and m["moves"] == "call_p95_ms"
               for m in cell.per_layer)


def test_counts_by_hand():
    cell = harness.Cell(ROOT, CELL)
    c = cell.config.counts(cell.cfg, 10_000_000, 16)
    # the block read once and written once
    assert c["bytes"] == 1.28e9
    # overlap-save's best block at 4096 taps: N = 65,536, two real FFTs
    # of 2.5 N log2 N and 32,769 complex products for 61,441 outputs
    per = (2 * 2.5 * 65536 * 16 + 6 * 32769) / 61441
    assert cell.config.fir_ops_per_output(4096) == pytest.approx(per)
    assert per == pytest.approx(88.53, abs=5e-3)
    assert c["flops"] == pytest.approx(per * 1.6e8)
    # bytes bound: 0.3821 ms, over the 0.2114 ms of the operations
    assert roofline.bound_s(c["bytes"], c["flops"]) == pytest.approx(
        1.28e9 / 3.35e12)
    assert c["flops"] / 67e12 == pytest.approx(2.1142e-4, rel=1e-4)
    # short taps: the direct form is fewer
    assert cell.config.fir_ops_per_output(9) == 18.0


def test_control_fails_the_limit():
    cell = harness.Cell(ROOT, CELL)
    got = readings.control_readings(cell, SEED, torch.device("cpu"),
                                    shape=TINY)
    assert got["y"] > cell.limits["y"]["limit"], got


def _altered_tap(taps):
    def broken(n=4096):
        h = taps(n).copy()
        h[n // 2] *= 1.01
        return h
    return broken


def _half_channels(fftfilt):
    def broken(h, x):
        y = fftfilt(h, x[:, : max(1, x.shape[1] // 2)])
        return torch.cat([y, x[:, y.shape[1]:]], 1)
    return broken


def _one_sample_late(fftfilt):
    def broken(h, x):
        y = fftfilt(h, x)
        return torch.cat([torch.zeros_like(y[:1]), y[:-1]])
    return broken


FAULTS = [("fftfilt_taps", _altered_tap), ("fftfilt", _half_channels),
          ("fftfilt", _one_sample_late)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f.__name__.strip("_") for _, f in FAULTS])
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    monkeypatch.setattr(pipeline, name, fault(getattr(pipeline, name)))
    res, _, err = run_tiny(CELL, shape=TINY)
    assert res["correct"] is False, err
    assert res["failed"] > 0
    assert "FAILED" in err


def trace(calls=2, device=None, bound_s=0.0005):
    if device is None:
        device = [
            R("void (anonymous namespace)::osconv_kernel<16384, false>"
              "(float const*, float2 const*)", 10.001, 10.003, "kernel"),
            R("Memset (Device)", 10.0035, 10.0036, "memset"),
            R("void (anonymous namespace)::osconv_kernel<16384, false>"
              "(float const*, float2 const*)", 10.005, 10.0072, "kernel"),
            R("void at::native::vectorized_elementwise_kernel<4>(int)",
              10.008, 10.0081, "kernel"),
            # outside the window: left out
            R("void (anonymous namespace)::osconv_kernel<16384, false>"
              "(float const*)", 9.990, 9.999, "kernel")]
    return devtrace.Trace(calls=calls, window=(10.0, 10.010), device=device,
                          host=[], host_s=[0.001] * calls, bound_s=bound_s)


def test_osconv_readers_on_synthetic_records():
    t = trace()
    # 2.0 + 2.2 ms of K4 over two calls
    assert reader("osconv_ms").read(t) == pytest.approx(2.1)
    assert reader("osconv_roofline").read(t) == pytest.approx(
        100 * 0.0005 / 0.0021)
    assert reader("osconv_roofline").read(trace(bound_s=None)) is None
    # a call that took another route: no K4 record, nothing to read
    other = trace(device=[R("void regular_fft_kernel(float2*)", 10.001,
                            10.002, "kernel")])
    for name in ("osconv_ms", "osconv_roofline"):
        assert reader(name).read(other) is None
        assert reader(name).read(trace(device=[])) is None


@pytest.fixture
def recorded():
    """Spans and counters of 3 warm calls of the entry on a tiny block on
    the CPU, with tracing on."""
    fwd, (x,) = pipeline.fftfilt_entry(device="cpu", n=40_000, channels=2)
    fwd(x)
    kernels.reset_launches()
    profiling.tracing(True)
    try:
        for _ in range(3):
            fwd(x)
    finally:
        profiling.tracing(False)
    yield profiling.spans()
    kernels.reset_launches()


def test_fftfilt_host_ms_is_the_entry_span(recorded):
    entries = [r for r in recorded if r[3] == "entry"]
    assert len(entries) == 3
    mean_ms = sum(r[5] - r[4] for r in entries) / 3 / 1e6
    t = trace(calls=3)
    assert reader("fftfilt_host_ms").read(t) == pytest.approx(mean_ms,
                                                               abs=1e-9)
    assert reader("fftfilt_host_ms").read(trace(calls=4)) is None
    assert reader("fftfilt_host_ms").read(trace(calls=3, device=[])) is None


def test_fftfilt_host_ms_without_a_span_of_path_a(monkeypatch):
    """A program whose spans hold none of path A's reads None."""
    from benchmark import spans
    monkeypatch.setattr(spans, "self_times", lambda t: {"sosfilt": 1e-4})
    assert reader("fftfilt_host_ms").read(trace()) is None
    monkeypatch.setattr(spans, "self_times",
                        lambda t: {"entry": 1e-5, "kernel.osconv": 2e-5})
    assert reader("fftfilt_host_ms").read(trace()) == pytest.approx(0.03)


def test_os_table_hit_share(recorded):
    r = reader("os_table_hit_share")
    # K4's tables are looked up on the card only: nothing yet
    assert r.read(trace()) is None
    profiling.count("table.osconv.hit", 3)
    profiling.count("table.os_spec.hit", 2)
    profiling.count("table.os_spec.miss", 1)
    profiling.count("table.biir.miss", 5)   # another path's: left out
    assert r.read(trace()) == pytest.approx(5 / 6)
    assert r.read(trace(device=[])) is None


def test_config_and_reference_load_no_jax():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "from benchmark import harness\n"
            f"c = harness.Cell({str(ROOT)!r}, {CELL!r})\n"
            "mods = lambda: {m.split('.')[0] for m in sys.modules}\n"
            "assert not mods() & {'jax', 'jaxlib', 'flax', 'dsptpu', "
            "'dsptpu_torch'}, mods()\n"
            "c.config.build(c.cfg, 20000, 2, 'cpu')\n"
            "print(sorted(mods() & {'jax', 'jaxlib', 'flax', 'dsptpu', "
            "'dsptpu_torch'}))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "['dsptpu_torch']"
