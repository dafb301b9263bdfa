"""Shared helpers of the benchmark's tests: tiny shapes of each cell,
and one run of a cell in-process on the CPU (the plain versions)."""

import io
import json
from pathlib import Path

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("chain64.block1m", "speech.mono1m", "speech.batch64",
         "chain64.epoch64k")
# a large seed, as the checks draw them
SEED = 2 ** 31 + 12345


def tiny(workload):
    """The traffic's parameters of a tiny run of the cell."""
    calls = {"pool": 3, "warmup_calls": 4, "profile_calls": 8}
    if workload.startswith("chain64"):
        return {"rows": 8192, "channels": 4, **calls}
    return {"rows": 8000, "channels": 4 if "batch" in workload else 1,
            **calls}


def run_tiny(workload, trace=0, root=ROOT, seconds=0.2, seed=SEED,
             shape=None):
    """(result line as parsed, stdout, stderr) of a tiny CPU run."""
    out, err = io.StringIO(), io.StringIO()
    harness.run_cell(root, workload, seed, seconds, trace, device="cpu",
                     shape=tiny(workload) if shape is None else shape,
                     out=out, err=err)
    last = out.getvalue().strip().splitlines()[-1]
    return json.loads(last), out.getvalue(), err.getvalue()
