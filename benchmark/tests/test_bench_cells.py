"""Every cell runs at a tiny size through the plain versions on the CPU
and prints a result line in the benchmark's format; its check passes."""

import json

import pytest

from benchmark import harness
from benchmark.tests.helpers import CELLS, ROOT, run_tiny

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_tiny_cpu_line(workload, trace):
    res, _, err = run_tiny(workload, trace)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, err
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    cell = harness.Cell(ROOT, workload)
    for name, v in res["checks"].items():
        assert v["value"] <= v["limit"] == cell.limits[name]["limit"]
    names = set(res["metrics"])
    if trace:
        # no device records on the CPU: only the host's reading is left
        assert names == {"host_ms"}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        # peak_mem_gib is read on the card only
        assert names == {m["name"] for m in cell.end_to_end} - {
            "peak_mem_gib"}
        assert "setup_s" in names and len(names) >= 2
    for m in res["metrics"].values():
        assert m["value"] > 0
    # the stderr ends with one line a compared number, beside its limit
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert [ln.split()[1] for ln in tail] == list(res["checks"])
    assert all("limit" in ln for ln in tail)


def test_spec_names_every_cell_and_metric():
    assert [w["name"] for w in SPEC["workloads"]] == list(CELLS)
    assert all(w["chips"] == 1 for w in SPEC["workloads"])
    for m in SPEC["per_layer"]:
        # every cell reports the end-to-end metric its per-layer ones move
        assert m["moves"] == "call_p95_ms"
        assert sorted(m["workloads"]) == sorted(CELLS)
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
    assert {m["name"] for m in SPEC["end_to_end"]} == {
        "samples_per_s", "call_p95_ms", "peak_mem_gib", "setup_s"}
    for w in CELLS:
        cell = harness.Cell(ROOT, w)
        assert {"call_p95_ms", "setup_s"} <= {
            m["name"] for m in cell.end_to_end}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_card(workload, tmp_path):
    """A short run of the cell on the card through the command line."""
    import subprocess
    import sys

    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"),
                        "--workload", workload, "--seed", "4000000007",
                        "--seconds", "2", "--trace", "0"],
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, r.stderr[-4000:]
    assert res["device"]["platform"] == "gpu"
