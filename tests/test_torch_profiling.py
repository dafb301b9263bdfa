"""The port's profiling helpers (dsptpu_torch.utils.profiling): Roofline
arithmetic against hand values and against dsptpu's Roofline with one
f32 pass, a torch.profiler trace written as a Chrome trace file with
its annotated region, and measure refusing to time without a card."""

import json

import pytest
import torch

from dsptpu.utils import profiling as jprof
from dsptpu_torch.utils import profiling


def test_roofline_hand_values():
    r = profiling.Roofline()
    assert (r.hbm_bw, r.peak_flops) == (3.35e12, 67e12)
    # 3.35 GB in 2 ms is half the rate; 67 GFLOP in 4 ms a quarter
    out = r.fractions(2e-3, min_bytes=3.35e9)
    assert out == {"hbm_frac": pytest.approx(0.5)}
    out = r.fractions(4e-3, flops=67e9)
    assert out["mxu_frac"] == pytest.approx(0.25)
    assert out["tflops"] == pytest.approx(16.75)
    assert r.fractions(1.0) == {}


@pytest.mark.parametrize("seconds,nbytes,flops", [
    (1e-3, 1e9, 2e10), (2.5e-4, 3.2e8, 5e11)])
def test_roofline_matches_dsptpu(seconds, nbytes, flops):
    # the same arithmetic as dsptpu's with one pass per float32 product
    ours = profiling.Roofline(1.5e12, 4e13).fractions(
        seconds, min_bytes=nbytes, flops=flops)
    ref = jprof.Roofline(1.5e12, 4e13, f32_passes=1).fractions(
        seconds, min_bytes=nbytes, flops=flops, precision="default")
    assert ours.keys() == ref.keys()
    for k in ours:
        assert ours[k] == pytest.approx(ref[k], rel=1e-15)


def test_roofline_takes_full_f32_only():
    with pytest.raises(ValueError, match="full float32"):
        profiling.Roofline().fractions(1.0, flops=1.0, precision="high")


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.annotate("dsptpu_region"):
            torch.ones(64).cumsum(0)
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "dsptpu_region" for e in events)


def test_measure_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profiling.measure(torch.ones, 8)
