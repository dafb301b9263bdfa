"""The `array64_multitaper` configuration and its cell
`multitaper64.block1m` at a tiny size on the CPU (K3's plain version
stands in for the stack): the cell's result line and its check; the port
against the reference; the reference's tapers against an independent
formulation; the counts against values worked out by hand; the control
(the reference in TF32) and faults planted in the timed path failing
the limits; the cell's five readers on synthetic profiler records and on
the spans and counters of tiny calls of the entry; and the imports."""

import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import devtrace, harness, readings, roofline
from benchmark.reference import array64_multitaper as reference
from benchmark.reference import common
from benchmark.tests.helpers import ROOT, SEED, run_tiny
from dsptpu_torch import kernels, pipeline
from dsptpu_torch.ops import multitaper
from dsptpu_torch.utils import profiling

CELL = "multitaper64.block1m"
# rows >= the configuration's coh_n (16,384): 37 frames of 3 channels
TINY = {"rows": 20_000, "channels": 3, "pool": 3, "warmup_calls": 2,
        "profile_calls": 4}
R = devtrace.Record
METRICS = ["mt_stack_ms", "mt_stack_roofline", "mt_coherence_ms",
           "mt_host_ms", "mt_table_hit_share"]


def reader(name):
    return harness._load(ROOT / "benchmark" / "metrics" / f"{name}.py",
                         "metric")


def cfg():
    return harness.Cell(ROOT, CELL).cfg


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_tiny_cpu_line(trace):
    res, _, err = run_tiny(CELL, trace, shape=TINY)
    assert res["correct"] is True, err
    assert res["attempted"] > 0 and res["failed"] == 0
    cell = harness.Cell(ROOT, CELL)
    assert list(res["checks"]) == ["power", "coherence"]
    for k, v in res["checks"].items():
        assert v["value"] <= v["limit"] == cell.limits[k]["limit"]
    if trace:
        # no device records on the CPU: none of the five reads anything
        assert res["metrics"] == {}
    else:
        # the end-to-end metrics that list no cells; peak_mem_gib is
        # read on the card only
        assert set(res["metrics"]) == {"call_p95_ms", "setup_s"}


def test_cell_entries():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = [w for w in spec["workloads"] if w["name"] == CELL]
    assert len(w) == 1 and w[0]["chips"] == 1
    assert w[0]["traffic"] == "block1m_x64"
    cell = harness.Cell(ROOT, CELL)
    assert cell.cfg["reduced"] == [] and cell.config_entry["reduced"] == []
    assert {m["name"] for m in cell.end_to_end} == {
        "call_p95_ms", "peak_mem_gib", "setup_s"}
    assert [m["name"] for m in cell.per_layer] == METRICS
    assert all(m["workloads"] == [CELL] and m["moves"] == "call_p95_ms"
               for m in cell.per_layer)
    # the configuration's limits lie between their two readings
    for k, v in cell.limits.items():
        assert v["lower"] < v["limit"] < v["upper"]


@pytest.mark.parametrize("channels,coh_n", [(2, 4096), (5, 2048)])
def test_port_against_the_reference(channels, coh_n):
    c = dict(cfg(), coh_n=coh_n)
    fwd, _ = pipeline.multitaper_entry(device="cpu", n=12_000,
                                       channels=channels, coh_n=coh_n)
    gen = torch.Generator().manual_seed(SEED + channels)
    x = torch.randn((12_000, channels), generator=gen)
    power, coh = fwd(x)
    ref = reference.reference(c, x, "float64")
    assert power.shape == ref["power"].shape == (513, 22, channels)
    assert coh.shape == ref["coherence"].shape == (channels, channels,
                                                   coh_n // 2 + 1)
    assert harness.gap(power, ref["power"]) < 1e-6
    assert harness.gap(coh, ref["coherence"]) < 1e-5
    assert torch.equal(torch.diagonal(ref["coherence"]),
                       torch.ones(coh_n // 2 + 1, channels,
                                  dtype=torch.float64))


@pytest.mark.parametrize("n,nw,k", [(256, 4, 7), (500, 2.5, 4),
                                    (1024, 4, 7)])
def test_tapers_against_the_sinc_concentration_matrix(n, nw, k):
    """The first k eigenvectors of the dense concentration matrix
    sin(2 pi W (i-j)) / (pi (i-j)), 2W on the diagonal, up to sign."""
    w = nw / n
    d = torch.arange(n, dtype=torch.float64)
    d = d[:, None] - d[None, :]
    a = torch.where(d == 0, torch.full_like(d, 2 * w),
                    torch.sin(2 * math.pi * w * d) / (math.pi * d))
    vals, vecs = torch.linalg.eigh(a)
    want = vecs[:, -k:].flip(1).T                       # (k, n), largest first
    got = reference.dpss(n, nw, k)
    assert got.shape == (k, n)
    torch.testing.assert_close(got.norm(dim=1), torch.ones(k,
                               dtype=torch.float64))
    sign = torch.sign((got * want).sum(1, keepdim=True))
    assert float((got - sign * want).abs().max()) < 1e-8


def test_tapers_above_the_dense_size():
    """The MRRR route above DENSE_MAX: unit-norm sequences of the
    tridiagonal matrix (t v = lambda v) with descending eigenvalues."""
    n, nw, k = reference.DENSE_MAX + 1000, 4, 7
    v = reference.dpss(n, nw, k)
    i = torch.arange(n, dtype=torch.float64)
    dg = ((n - 1) / 2 - i) ** 2 * math.cos(2 * math.pi * nw / n)
    e = i[1:] * (n - i[1:]) / 2
    tv = dg * v
    tv[:, 1:] += e * v[:, :-1]
    tv[:, :-1] += e * v[:, 1:]
    lam = (tv * v).sum(1)
    assert bool((lam[:-1] > lam[1:]).all())
    assert float((tv - lam[:, None] * v).abs().max()) < 1e-6 * float(
        lam[0])
    torch.testing.assert_close(v.norm(dim=1), torch.ones(k,
                               dtype=torch.float64))


def test_counts_by_hand():
    cell = harness.Cell(ROOT, CELL)
    c = cell.config.counts(cell.cfg, 1_000_000, 64)
    s = cell.config.stack_counts(cell.cfg, 1_000_000, 64)
    # 1952 frames; the block read once, the spectrogram written once
    assert cell.config.frames(cell.cfg, 1_000_000) == 1952
    assert s["bytes"] == 4 * 64_000_000 + 4 * 513 * 1952 * 64
    # 874,496 transforms of 2.5 x 1024 x 10, 1024 taper products and
    # 4 x 513 for |X|^2 into the taper sum
    assert s["flops"] == 874_496 * (25_600 + 1024 + 2052)
    assert s["flops"] / 67e12 == pytest.approx(3.7428e-4, rel=1e-4)
    assert roofline.bound_s(s["bytes"], s["flops"]) == s["flops"] / 67e12
    p = c["parts"]
    assert p["stack"] == s["flops"]
    assert p["coh_fft"] == 448 * (2.5 * 16384 * 14 + 16384)
    assert p["cross"] == 8 * 2080 * 7 * 8193
    assert p["coh"] == 7 * 64 * 64 * 8193
    assert c["flops"] == sum(p.values())
    assert c["bytes"] == s["bytes"] + 4 * 64 * 64 * 8193
    assert roofline.bound_s(c["bytes"], c["flops"]) == pytest.approx(
        3.9598e-4, rel=1e-4)


def test_build_refuses_another_frame_or_taper_setting():
    with pytest.raises(ValueError, match="ntapers"):
        harness.Cell(ROOT, CELL).config.build(dict(cfg(), ntapers=5),
                                              20_000, 2, "cpu")


def test_control_fails_the_limits():
    cell = harness.Cell(ROOT, CELL)
    got = readings.control_readings(cell, SEED, torch.device("cpu"),
                                    shape=TINY)
    for k in cell.config.OUTPUTS:
        assert got[k] > cell.limits[k]["limit"], got


def _drop_a_taper(stack_args):
    def broken(config):
        W, scale = stack_args(config)
        W = W.copy()
        W[-1] = 0.0
        return W, scale
    return broken


def _tf32_cross_operands(tapered_fft):
    def broken(s, config):
        F = tapered_fft(s, config)
        return torch.complex(common.to_tf32(F.real), common.to_tf32(F.imag))
    return broken


def _edge_bins_doubled(onesided_scale):
    def broken(nfft, nfreq):
        scale = onesided_scale(nfft, nfreq).copy()
        scale[:] = 2.0
        return scale
    return broken


FAULTS = [("_stack_args", _drop_a_taper, "power"),
          ("_tapered_fft", _tf32_cross_operands, "coherence"),
          ("_onesided_scale", _edge_bins_doubled, "power")]


@pytest.mark.parametrize("name,fault,output", FAULTS,
                         ids=[f.__name__.strip("_") for _, f, _ in FAULTS])
def test_broken_timed_path_is_not_correct(name, fault, output, monkeypatch):
    monkeypatch.setattr(multitaper, name, fault(getattr(multitaper, name)))
    res, _, err = run_tiny(CELL, shape=TINY)
    assert res["correct"] is False, err
    assert res["failed"] > 0
    assert res["checks"][output]["value"] > res["checks"][output]["limit"]
    assert "FAILED" in err


def test_edge_correction_cancels_in_the_coherence(monkeypatch):
    """The cross spectra's edge-bin 1/sqrt(2) scales S_ll, S_mm and S_lm
    of a bin alike, so no output can show it left out: the planted
    fault of the edge bins is the spectrogram's doubling instead."""
    res, _, _ = run_tiny(CELL, shape=TINY)
    monkeypatch.setattr(multitaper, "_edge_corr",
                        lambda nfft, nfreq: np.ones(nfreq))
    without, _, _ = run_tiny(CELL, shape=TINY)
    assert without["correct"] is True
    assert without["checks"]["coherence"]["value"] == pytest.approx(
        res["checks"]["coherence"]["value"], rel=1e-3)


STACK = ("void (anonymous namespace)::stft_kernel<8>(float const*, "
         "float const*)")


def trace(calls=2, device=None, bound_s=0.0005):
    if device is None:
        device = [
            R(STACK, 10.001, 10.0024, "kernel"),
            R("void vector_fft<8192u>(float2*)", 10.0025, 10.0030,
              "kernel"),
            R("Memset (Device)", 10.0031, 10.0032, "memset"),
            R(STACK, 10.004, 10.0054, "kernel"),
            R("sm80_xmma_gemm_cf32cf32_f32f32_cf32_nn_n(float2*)", 10.0055,
              10.0062, "kernel"),
            # the chain's fused launch is not the stack
            R("void (anonymous namespace)::stft_fused_kernel<8>(float "
              "const*)", 10.007, 10.0072, "kernel"),
            # outside the window: left out
            R(STACK, 9.990, 9.999, "kernel")]
    return devtrace.Trace(calls=calls, window=(10.0, 10.010), device=device,
                          host=[], host_s=[0.001] * calls, bound_s=bound_s)


def test_device_readers_on_synthetic_records():
    t = trace()
    # 1.4 + 1.4 ms of the stack over two calls
    assert reader("mt_stack_ms").read(t) == pytest.approx(1.4)
    # everything else that is a kernel: 0.5 + 0.7 + 0.2 ms
    assert reader("mt_coherence_ms").read(t) == pytest.approx(0.7)
    # the stack's own bound at the cell's traffic, not the trace's
    bound = reader("mt_stack_roofline").stack_bound_s()
    assert bound == pytest.approx(3.7428e-4, rel=1e-4)
    assert reader("mt_stack_roofline").read(t) == pytest.approx(
        100 * bound / 0.0014)
    assert reader("mt_stack_roofline").read(trace(bound_s=None)) == \
        reader("mt_stack_roofline").read(t)
    # a spectrogram that took another route: no stack record
    other = trace(device=[R("void vector_fft<1024u>(float2*)", 10.001,
                            10.002, "kernel")])
    for name in ("mt_stack_ms", "mt_stack_roofline", "mt_coherence_ms"):
        assert reader(name).read(other) is None
        assert reader(name).read(trace(device=[])) is None


@pytest.fixture
def recorded():
    """Spans and counters of 3 warm calls of the entry on a tiny block on
    the CPU, with tracing on."""
    fwd, (x,) = pipeline.multitaper_entry(device="cpu", n=16_384,
                                          channels=2, coh_n=2048)
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


def test_mt_host_ms_is_the_entry_span(recorded):
    entries = [r for r in recorded if r[3] == "entry"]
    assert len(entries) == 3
    assert {r[3] for r in recorded} == {"entry", "mt_spectrogram",
                                        "kernel.stft", "mt_coherence",
                                        "mt_cross_spectra"}
    mean_ms = sum(r[5] - r[4] for r in entries) / 3 / 1e6
    t = trace(calls=3)
    assert reader("mt_host_ms").read(t) == pytest.approx(mean_ms, abs=1e-9)
    assert reader("mt_host_ms").read(trace(calls=4)) is None
    assert reader("mt_host_ms").read(trace(calls=3, device=[])) is None


def test_mt_host_ms_without_a_span_of_path_d(monkeypatch):
    """A program whose spans hold none of path D's but `entry` reads
    None."""
    from benchmark import spans
    monkeypatch.setattr(spans, "self_times", lambda t: {"entry": 1e-4,
                                                        "sosfilt": 1e-4})
    assert reader("mt_host_ms").read(trace()) is None
    monkeypatch.setattr(spans, "self_times",
                        lambda t: {"entry": 1e-5, "kernel.stft": 2e-5,
                                   "filt": 1.0})
    assert reader("mt_host_ms").read(trace()) == pytest.approx(0.03)


def test_mt_table_hit_share(recorded):
    r = reader("mt_table_hit_share")
    # the warm calls found all of their 5 constants a call
    assert profiling.counters()["table.mt_const.hit"] == 15
    assert r.read(trace()) == pytest.approx(1.0)
    profiling.count("table.mt_const.miss", 5)
    profiling.count("table.stft.miss", 7)   # another cache's: left out
    assert r.read(trace()) == pytest.approx(15 / 20)
    assert r.read(trace(device=[])) is None
    kernels.reset_launches()
    profiling.count("table.stft.hit", 3)
    assert r.read(trace()) is None


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
