"""The port's bench (dsptpu_torch.bench, bench_torch.py) on the CPU: the
five BASELINE configs at 1/SCALE of bench.py's lengths through the
plain versions, every witness within bench.py's _WITNESS_TOL; each
config's calls held to dsptpu's on the same inputs (bench.py's data at
this scale), dsptpu under jax.jit once per call (its stateful
FIRFilter eagerly, as bench.py calls it); a perturbed route and a
raising config make the run exit 1, as does "cuda" without a card; and
the weak-scaling mode on 2 gloo ranks at a small n.

Tolerances are bench.py's witness bounds, max|d| <= tol max|ref|: 3e-5
for the FIR, overlap-save, Welch, spectrogram and resampling calls,
1e-4 for filtfilt and LPC."""

import contextlib
import io
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from fractions import Fraction

import dsptpu
from dsptpu.filters import stream_filt as jsf
from dsptpu_torch import bench

# 1/500 of bench.py's lengths: 20,000 samples for the FIR, 2000 x 64 for
# Welch (2 frames), 2000 for filtfilt (5 LPC frames)
SCALE = 500
ARGS = ["--device", "cpu", "--scale", str(SCALE)]

PART_TOL = {"filt": 3e-5, "fftfilt": 3e-5, "welch": 3e-5,
            "spectrogram": 3e-5, "resample_147_160": 3e-5,
            "resample_3_2": 3e-5, "resample_arb_0p9997": 3e-5,
            "filtfilt": 1e-4, "lpc": 1e-4}


def run_main(argv):
    """bench.main(argv): (exit code, the last stdout line as JSON or
    None)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(argv)
    lines = out.getvalue().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


@pytest.fixture(scope="module")
def cpu_run():
    return run_main(ARGS)


def test_cpu_run_prints_one_json_line(cpu_run):
    rc, rec = cpu_run
    assert rc == 0
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert rec["unit"] == "samples/s" and rec["value"] > 0
    assert rec["vs_baseline"] > 0
    extra = rec["extra"]
    assert set(extra["configs"]) == set(bench.CONFIGS)
    assert extra["failed_configs"] == [] and extra["numerics_ok"]
    assert extra["card"] == "cpu"
    for name, parts in extra["detail"].items():
        for d in parts.values():
            # no device figure from a CPU run
            assert d["clock"] == "host" and "device_ms" not in d
            assert "hbm_frac" not in d
            assert d["call_ms_min"] <= d["call_ms"] <= d["call_ms_max"]
            assert d["bound_ms"] > 0 and d["bound_by"] in ("bytes",
                                                           "operations")


@pytest.mark.parametrize("witness", sorted(bench._WITNESS_TOL))
def test_cpu_run_witness_within_tolerance(cpu_run, witness):
    err = cpu_run[1]["extra"]["err"][witness]
    assert 0 <= err <= bench._WITNESS_TOL[witness]


@pytest.fixture(scope="module")
def configs():
    """The five configs on the CPU at 1/SCALE, built in order from
    bench.py's generator, so each holds the data of the bench's run."""
    rng = np.random.default_rng(1776)
    return {name: make(torch.device("cpu"), SCALE, rng)
            for name, make in bench.CONFIGS.items()}


def _jax_fir_filter(taps, rate, x):
    f = jsf.FIRFilter(taps, rate)
    f.reset()
    return f.filt(jnp.asarray(x))


def dsptpu_calls(name, data):
    """{part label: dsptpu's result on the config's inputs}."""
    if name == "fir_127tap":
        return {"filt": jax.jit(lambda b, s: dsptpu.filt(b, s))(
            data["h"], data["x"])}
    if name == "os_4096tap_16ch":
        return {"fftfilt": jax.jit(lambda b, s: dsptpu.fftfilt(b, s))(
            data["h"], data["x"])}
    if name == "welch_spectrogram_1024_64ch":
        win = data["win"]
        return {"welch": jax.jit(lambda s: dsptpu.power(dsptpu.welch_pgram(
                    s, 1024, 512, window=win)))(data["x"]),
                "spectrogram": jax.jit(lambda s: dsptpu.power(
                    dsptpu.spectrogram(s, 1024, 512, window=win)))(
                    data["x"])}
    if name == "resample_147_160":
        x, out = data["x"], {}
        for label, rate, m in (
                ("resample_147_160", Fraction(147, 160), len(x)),
                ("resample_3_2", Fraction(3, 2), len(x)),
                ("resample_arb_0p9997", 0.9997, len(x) // 4)):
            taps = np.asarray(dsptpu.resample_filter(rate)).astype(
                np.float32)
            np.testing.assert_array_equal(taps, data["taps"][label])
            out[label] = _jax_fir_filter(taps, rate, x[:m])
        return out
    f = dsptpu.filters.as_sos(dsptpu.digitalfilter(dsptpu.Lowpass(0.2),
                                                   dsptpu.Butterworth(8)))
    return {"filtfilt": jax.jit(lambda s: dsptpu.filtfilt(f, s))(data["x"]),
            "lpc": jax.jit(lambda fr: dsptpu.lpc(fr, 16, method="levinson"))(
                data["frames"])[0]}


@pytest.mark.parametrize("name", list(bench.CONFIGS))
def test_config_matches_dsptpu(configs, name):
    cfg = configs[name]
    want = dsptpu_calls(name, cfg.data)
    assert set(want) == {p.label for p in cfg.parts}
    for p in cfg.parts:
        got = p.call()
        if p.label == "lpc":
            got = got[0]
        w = np.asarray(want[p.label], np.float64)
        g = got.double().numpy()
        assert g.shape == w.shape, p.label
        err = np.max(np.abs(g - w)) / np.max(np.abs(w))
        assert err <= PART_TOL[p.label], (p.label, err)


def test_perturbed_route_exits_1(monkeypatch):
    filt = bench.filt
    monkeypatch.setattr(bench, "CONFIGS",
                        {"fir_127tap": bench.CONFIGS["fir_127tap"]})
    monkeypatch.setattr(bench, "filt",
                        lambda b, x: filt(b, x) * (1 + 1e-3))
    rc, rec = run_main(ARGS)
    assert rc == 1
    assert not rec["extra"]["numerics_ok"]
    assert rec["extra"]["err"]["fir_127tap"] > bench._WITNESS_TOL[
        "fir_127tap"]


def test_raising_config_exits_1(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("a route that raises")
    monkeypatch.setattr(bench, "CONFIGS", {
        k: bench.CONFIGS[k] for k in ("fir_127tap", "os_4096tap_16ch")})
    monkeypatch.setattr(bench, "fftfilt", broken)
    rc, rec = run_main(ARGS)
    assert rc == 1
    assert rec["extra"]["failed_configs"] == ["os_4096tap_16ch"]
    assert set(rec["extra"]["configs"]) == {"fir_127tap"}


def test_cuda_without_a_card_exits_1():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert run_main([]) == (1, None)


def test_weak_scaling_two_hosts():
    rec = bench.weak_scaling(2, n=4096)
    assert rec["unit"] == "efficiency" and rec["value"] > 0
    extra = rec["extra"]
    for key in ("aggregate_sps", "efficiency",
                "efficiency_extended_pipeline", "per_op_ms",
                "max_rel_err_vs_unsharded"):
        assert set(extra[key]) == {"1", "2"}, key
    assert extra["efficiency"]["1"] == 1.0
    assert rec["value"] == extra["efficiency"]["2"]
    assert set(extra["per_op_ms"]["2"]) == {"fir", "sosfilt", "welch",
                                            "filtfilt", "resample"}
    # each rank raised past bench.py's bounds; this is the largest error
    assert max(extra["max_rel_err_vs_unsharded"].values()) < 1e-4
