"""The readings that the limits of a cell's check are set from, in one
process on the card:

    python3 benchmark/readings.py --workload <cell> --seconds 2 \
        --seeds <n> ... --control-seeds <n> ...

For each of --seeds: the program's closed loop at the cell's own load
for --seconds, then the check of a sample of its calls as a run makes
it (the lower reading is the largest over the seeds). For each of
--control-seeds: the control, the plain reference computed in TF32
(benchmark/reference/common.py) in the program's place, on as many
blocks of that seed's pool as a run checks (the upper reading is the
smallest over the seeds). One JSON line a seed; then the largest
program reading and the smallest control reading of each output.
The benchmark's own runs do not run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[0] = str(ROOT)

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def program_readings(cell, forward, seed, seconds, dev, shape=None):
    """{output: widest gap} of the program's sampled calls, and calls."""
    rows, channels, npool = cell.shape(shape)
    sync = harness._sync(dev)
    pool = harness.make_pool(rows, channels, npool, seed, dev)
    t = cell.traffic
    harness.closed_loop(forward, pool, calls=t["warmup_calls"], sync=sync)
    sample = harness.Sample(t["check_calls"], seed)
    lat, _, _ = harness.closed_loop(forward, pool, seconds=seconds,
                                    sample=sample, sync=sync)
    return harness.widest(harness.judge(cell, sample, pool),
                          cell.config.OUTPUTS), len(lat)


def control_readings(cell, seed, dev, shape=None):
    """{output: widest gap} of the control on check_calls blocks."""
    rows, channels, npool = cell.shape(shape)
    pool = harness.make_pool(rows, channels, npool, seed, dev)
    sample = harness.Sample(cell.traffic["check_calls"], seed)
    for i in range(cell.traffic["check_calls"]):
        sample.offer(i, i % npool, None)
    return harness.widest(harness.judge(
        cell, sample, pool,
        candidate=lambda x: cell.reference.reference(cell.cfg, x, "tf32")),
        cell.config.OUTPUTS)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="benchmark/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the readings are taken on the card",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    cell = harness.Cell(ROOT, args.workload)
    rows, channels, _ = cell.shape()
    lower, upper = {}, {}
    if args.seeds:
        forward = cell.config.build(cell.cfg, rows, channels, dev)
        for seed in args.seeds:
            r, calls = program_readings(cell, forward, seed, args.seconds,
                                        dev)
            print(json.dumps({"workload": args.workload, "kind": "program",
                              "seed": seed, "calls": calls, "readings": r}),
                  flush=True)
            for k, v in r.items():
                lower[k] = max(lower.get(k, 0.0), v)
        del forward
    for seed in args.control_seeds:
        r = control_readings(cell, seed, dev)
        print(json.dumps({"workload": args.workload, "kind": "control",
                          "seed": seed, "readings": r}), flush=True)
        for k, v in r.items():
            upper[k] = min(upper.get(k, float("inf")), v)
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper, "card": harness.card_line(),
                      "seconds": time.perf_counter() - T_START}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
