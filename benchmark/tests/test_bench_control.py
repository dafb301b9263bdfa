"""The check fails what it has to fail, at a tiny size on the CPU:

- the control, the plain reference computed in TF32 in the program's
  place, reads above the cell's limits;
- a run whose timed path is broken underneath comes out not correct:
  half of the batch left out (the Welch mean over half of the frames;
  half of the channels not filtered), and an answer altered where it is
  produced (one STFT bin, one LPC coefficient).
The cells hold no state across calls and run on one chip, so the faults
of a state returned unchanged and of a lost exchange between chips do
not apply.
"""

import pytest
import torch

from benchmark import harness, readings
from benchmark.tests.helpers import CELLS, ROOT, SEED, run_tiny, tiny
from dsptpu_torch import pipeline


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits(workload):
    cell = harness.Cell(ROOT, workload)
    got = readings.control_readings(cell, SEED, torch.device("cpu"),
                                    shape=tiny(workload))
    over = {k: v for k, v in got.items() if v > cell.limits[k]["limit"]}
    assert over, got


def _half_frames(welch):
    def broken(y, *a, **k):
        return welch(y[: y.shape[0] // 2], *a, **k)
    return broken


def _half_channels(filtfilt):
    def broken(f, x):
        y = filtfilt(f, x[:, : max(1, x.shape[1] // 2)])
        return torch.cat([y, x[:, y.shape[1]:]], 1)
    return broken


def _altered_bin(stft):
    def broken(*a, **k):
        s = stft(*a, **k).clone()
        s[1, 0, 0] *= 1.001
        return s
    return broken


def _altered_coefficient(lpc):
    def broken(*a, **k):
        a_, err = lpc(*a, **k)
        a_ = a_.clone()
        a_[0, 0] += 1e-3
        return a_, err
    return broken


FAULTS = [
    ("chain64.block1m", "welch_pgram", _half_frames),
    ("chain64.epoch64k", "stft", _altered_bin),
    ("speech.batch64", "filtfilt", _half_channels),
    ("speech.mono1m", "lpc", _altered_coefficient),
]


@pytest.mark.parametrize("workload,name,fault", FAULTS,
                         ids=[f"{w}-{n}" for w, n, _ in FAULTS])
def test_broken_timed_path_is_not_correct(workload, name, fault,
                                          monkeypatch):
    ok, _, _ = run_tiny(workload)
    assert ok["correct"] is True
    monkeypatch.setattr(pipeline, name, fault(getattr(pipeline, name)))
    res, _, err = run_tiny(workload)
    assert res["correct"] is False, err
    assert res["failed"] > 0
    assert "FAILED" in err
