"""The port's profiling helpers (dsptpu_torch.utils.profiling): Roofline
arithmetic against hand values and against dsptpu's Roofline with one
f32 pass, a torch.profiler trace written as a Chrome trace file with
its annotated region, measure refusing to time without a card, and
device_by_kernel on fake profiles: an empty one taken again once, two
failing the call (and with it chip_smoke.py's sharded-phase times and
tools/ab_common.py's readers), and its name and exclude filters."""

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


def fake_profiles(monkeypatch, profiles):
    """device_by_kernel's profiles taken in turn from `profiles`, lists of
    (kernel name, device µs, launches) as _device_events gives them, with
    torch.cuda.synchronize a no-op; returns the list of calls made."""
    it = iter(profiles)
    calls = []

    def fake(fn, n, flush):
        calls.append(n)
        return next(it)
    monkeypatch.setattr(profiling, "_device_events", fake)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    return calls


def test_device_by_kernel_sums_by_kernel(monkeypatch):
    fake_profiles(monkeypatch, [[("fir_kernel(float const*, float*)",
                                  800.0, 10),
                                 ("spin_free_copy(float*)", 100.0, 20)]])
    out = profiling.device_by_kernel(lambda: None, calls=10)
    assert out == {"fir_kernel": [pytest.approx(0.08), 1.0],
                   "spin_free_copy": [pytest.approx(0.01), 2.0]}


def test_device_by_kernel_takes_an_empty_profile_again(monkeypatch):
    calls = fake_profiles(monkeypatch, [
        [], [("levinson_kernel(float*)", 30.0, 10)]])
    logged = []
    out = profiling.device_by_kernel(lambda: None, calls=10,
                                     log=logged.append)
    assert calls == [10, 10] and len(logged) == 1
    assert out == {"levinson_kernel": [pytest.approx(0.003), 1.0]}


def test_device_by_kernel_fails_on_two_empty_profiles(monkeypatch):
    calls = fake_profiles(monkeypatch, [[], [], [("never_read", 1.0, 1)]])
    with pytest.raises(RuntimeError, match="no device time"):
        profiling.device_by_kernel(lambda: None, calls=2, log=lambda m: 0)
    assert calls == [2, 2]


def test_device_by_kernel_filters_by_name(monkeypatch):
    """`name` keeps the kernels whose signature holds it, `exclude` drops
    those that hold any of its strings; the tools' A/B harness
    (tools/ab_common.py) reads the profile through the same function, so
    it too fails on a profile that stays empty."""
    import importlib.util
    import pathlib
    spec = importlib.util.spec_from_file_location(
        "ab_common", pathlib.Path(__file__).resolve().parent.parent
        / "tools" / "ab_common.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    prof = [("arbd_kernel(float*)", 200.0, 2),
            ("arbd_plan_fill(float*)", 20.0, 2),
            ("fir_kernel(float*)", 100.0, 2)]
    fake_profiles(monkeypatch, [prof, prof, [], []])
    assert profiling.device_by_kernel(
        lambda: None, calls=2, name="arbd", exclude=("fill",)) == {
            "arbd_kernel": [pytest.approx(0.1), 1.0]}
    assert ab.device_ms_by_kernel(lambda: None, "", calls=2,
                                  exclude=("arbd",)) == {
        "fir_kernel": pytest.approx(0.05)}
    with pytest.raises(RuntimeError, match="no device time"):
        ab.device_ms(lambda: None, "arbd", calls=2)


def test_chip_smoke_sharded_times_fail_on_empty_profiles(monkeypatch):
    """chip_smoke.py's sharded phase times each call beside its unsharded
    counterpart (_timed_pair); two empty profiles of a call fail it, where
    it once logged device 0.000 and idle share 1.000."""
    import chip_smoke
    fake_profiles(monkeypatch, [[("k(float*)", 50.0, 2)], [], []])
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, **kw: 1.0)
    with pytest.raises(RuntimeError, match="no device time"):
        chip_smoke._timed_pair("filtfilt", lambda: None, lambda: None)
