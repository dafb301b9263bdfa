"""A configuration, a traffic mix, a cell and a per-layer metric added
as new files, with their entries in BENCHMARK.json, are found and run
without an edit to any file that is there."""

import hashlib
import json
import shutil

from benchmark.tests.helpers import ROOT, run_tiny

NEW_FILES = {
    "configs/dummy_gain.json": json.dumps(
        {"name": "dummy_gain", "gain": 2.0, "reduced": []}),
    "configs/dummy_gain.py": '''
OUTPUTS = ("y",)


def build(cfg, rows, channels, device):
    return lambda x: x * cfg["gain"]


def outputs(out):
    return {"y": out}


def counts(cfg, rows, channels):
    return {"bytes": 8 * rows * channels, "flops": rows * channels}
''',
    "reference/dummy_gain.py": '''
def reference(cfg, x, precision="float64"):
    return {"y": x.double() * cfg["gain"]}
''',
    "traffic/tiny_x2.json": json.dumps(
        {"rows": 64, "channels": 2, "pool": 2, "warmup_calls": 2,
         "check_calls": 2, "profile_calls": 5}),
    "cells/dummy.tiny.json": json.dumps({"limits": {"y": {"limit": 0.0}}}),
    "metrics/dummy_calls.py": '''
def read(trace):
    return float(trace.calls)
''',
}


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_config_and_metric_as_files(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _digests(tmp_path)
    for rel, text in NEW_FILES.items():
        (tmp_path / "benchmark" / rel).write_text(text)
    spec["configs"].append({"name": "dummy_gain", "source": "x",
                            "file": "benchmark/configs/dummy_gain.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "dummy.tiny", "config": "dummy_gain",
                              "traffic": "tiny_x2", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "dummy_calls", "unit": "count",
                              "better": "lower", "source": "host_clock",
                              "layer": "test", "moves": "call_p95_ms",
                              "workloads": ["dummy.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    res, _, err = run_tiny("dummy.tiny", trace=0, root=tmp_path,
                           shape={})
    assert res["correct"] is True, err
    # the end-to-end metrics that list no cells (peak_mem_gib is read on
    # the card only)
    assert set(res["metrics"]) == {"call_p95_ms", "setup_s"}
    res, _, err = run_tiny("dummy.tiny", trace=1, root=tmp_path, shape={})
    assert res["metrics"]["dummy_calls"]["value"] == 5.0
    # the four cells' per-layer metrics list their cells, not this one
    assert set(res["metrics"]) == {"dummy_calls"}
    after = _digests(tmp_path)
    assert {k: after[k] for k in before} == before
