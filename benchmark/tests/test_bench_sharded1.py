"""The `array64_chain_sharded` configuration and its cell
`chain64.sharded1` at a tiny size on the CPU (a world-size-1 gloo mesh;
K2's plain version): the cell's result line and its check; the port
against the reference; the counts against values worked out by hand; the
control (the reference in TF32) and faults planted in the timed path
failing the limit; the configuration's refusal of another chain; the
cell's four readers on synthetic profiler records and on the spans and
counters of tiny calls; and the imports. Every test destroys the
process group it made, so that none outlives it."""

import json
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate

from benchmark import devtrace, harness, readings, roofline
from benchmark.reference import array64_chain_sharded as reference
from benchmark.tests.helpers import ROOT, SEED, run_tiny
from dsptpu_torch import kernels, parallel
from dsptpu_torch.parallel import ops
from dsptpu_torch.utils import profiling

CELL = "chain64.sharded1"
TINY = {"rows": 8192, "channels": 4, "pool": 3, "warmup_calls": 2,
        "profile_calls": 4}
R = devtrace.Record
METRICS = ["shard_device_ms", "shard_roofline", "shard_host_ms",
           "shard_reblock_mib"]
# the keys of array64_chain.json that the chain's reference reads
CHAIN_KEYS = ("fir_taps", "fir_cutoff", "fir_window", "iir_order",
              "iir_cutoff", "iir_gain", "impulse_len", "nfft", "hop",
              "window")


@pytest.fixture(autouse=True)
def no_group_left():
    """Destroy the process group that the test made, if it made one."""
    before = dist.is_initialized()
    yield
    if not before and dist.is_initialized():
        dist.destroy_process_group()


def reader(name):
    return harness._load(ROOT / "benchmark" / "metrics" / f"{name}.py",
                         "metric")


def cell():
    return harness.Cell(ROOT, CELL)


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_tiny_cpu_line(trace):
    res, _, err = run_tiny(CELL, trace, shape=TINY)
    assert res["correct"] is True, err
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res["checks"]) == ["psd"]
    v = res["checks"]["psd"]
    assert v["value"] <= v["limit"] == cell().limits["psd"]["limit"]
    if trace:
        # no device records on the CPU: none of the four reads anything
        assert res["metrics"] == {}
    else:
        assert set(res["metrics"]) == {"call_p95_ms", "setup_s"}


def test_cell_entries():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = [w for w in spec["workloads"] if w["name"] == CELL]
    assert len(w) == 1 and w[0]["chips"] == 1
    assert w[0]["traffic"] == "block1m_x64"
    c = cell()
    assert c.cfg["reduced"] == c.config_entry["reduced"] == ["world_size"]
    assert c.cfg["world_size"] == 1 and c.cfg["mesh"] == {"channel": 1,
                                                          "time": 1}
    assert c.cfg["entry"] == "dsptpu_torch.pipeline.sharded_entry"
    assert c.cfg["source"] == c.config_entry["source"]
    assert {m["name"] for m in c.end_to_end} == {
        "call_p95_ms", "peak_mem_gib", "setup_s"}
    assert [m["name"] for m in c.per_layer] == METRICS
    assert all(m["workloads"] == [CELL] and m["moves"] == "call_p95_ms"
               for m in c.per_layer)
    for v in c.limits.values():
        assert v["lower"] < v["limit"] < v["upper"]


def test_config_states_the_chain_of_array64_chain():
    chain = json.loads((ROOT / "benchmark" / "configs"
                        / "array64_chain.json").read_text())
    cfg = cell().cfg
    assert {k: cfg[k] for k in CHAIN_KEYS} == {k: chain[k]
                                               for k in CHAIN_KEYS}


def test_counts_by_hand():
    c = cell()
    got = c.config.counts(c.cfg, 4096, 2)
    # the block read once, the PSD (513 bins) written once
    assert got["bytes"] == 4 * (4096 * 2 + 513 * 2)
    chain = harness.Cell(ROOT, "chain64.block1m")
    assert got["parts"] == chain.config.counts(chain.cfg, 4096, 2)["parts"]
    assert got["flops"] == sum(got["parts"].values())
    full = c.config.counts(c.cfg, 1_000_000, 64)
    assert full["bytes"] == 256_131_328
    # FIR 60.4 an output (overlap-save at N = 1024), 9 a section and
    # sample over 4 sections, 1952 frames of 64 channels
    fir = (2 * 2.5 * 1024 * 10 + 6 * 513) / 898
    assert full["parts"]["fir"] == pytest.approx(fir * 64e6)
    assert full["parts"]["cascade"] == 9 * 4 * 64e6
    assert full["parts"]["frames"] == 1952 * 64 * (25_600 + 1024 + 5 * 513)
    assert full["flops"] == pytest.approx(9.8189e9, rel=1e-4)
    assert roofline.bound_s(full["bytes"], full["flops"]) == pytest.approx(
        1.4655e-4, rel=1e-4)


@pytest.mark.parametrize("rows,channels", [(12_000, 2), (8192, 5)])
def test_port_against_the_reference(rows, channels):
    forward = cell().config.build(cell().cfg, rows, channels, "cpu")
    gen = torch.Generator().manual_seed(SEED + channels)
    x = torch.randn((rows, channels), generator=gen)
    out = forward(x)
    assert tuple(out.placements) == (Replicate(),) * 2
    psd = cell().config.outputs(out)["psd"]
    ref = reference.reference(cell().cfg, x, "float64")["psd"]
    assert psd.shape == ref.shape == (513, channels)
    assert harness.gap(psd, ref) < 1e-6


def test_timed_block_is_a_view():
    """shard_time places the pool's block at world size 1 without a
    copy."""
    mesh = parallel.make_mesh(device_type="cpu")
    x = torch.randn(3, 1000, 4).unbind(0)[1]
    d = parallel.shard_time(x, mesh)
    assert d.to_local().data_ptr() == x.data_ptr()
    assert tuple(d.shape) == (1000, 4)


@pytest.mark.parametrize("key,value", [("iir_order", 6), ("hop", 256),
                                       ("fir_taps", 63),
                                       ("window", "hamming"),
                                       ("iir_gain", "design")])
def test_build_refuses_another_chain_setting(key, value):
    with pytest.raises(ValueError, match="chain_params"):
        cell().config.build(dict(cell().cfg, **{key: value}), 8192, 2,
                            "cpu")
    assert not dist.is_initialized()


def test_control_fails_the_limit():
    c = cell()
    got = readings.control_readings(c, SEED, torch.device("cpu"),
                                    shape=TINY)
    assert got["psd"] > c.limits["psd"]["limit"], got


def _dc_doubled(onesided_scale):
    def broken(n, dtype, device):
        scale = onesided_scale(n, dtype, device).clone()
        scale[0] = 2.0
        return scale
    return broken


def _halo_from_the_block_end(fir_local):
    def broken(b, xcat):
        nb = b.shape[0]
        xcat = xcat.clone()
        xcat[: nb - 1] = xcat[-(nb - 1):]
        return fir_local(b, xcat)
    return broken


FAULTS = [("_onesided_scale", _dc_doubled),
          ("_fir_local", _halo_from_the_block_end)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f.__name__.strip("_") for _, f in FAULTS])
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    monkeypatch.setattr(ops, name, fault(getattr(ops, name)))
    res, _, err = run_tiny(CELL, shape=TINY)
    assert res["correct"] is False, err
    assert res["failed"] > 0
    assert res["checks"]["psd"]["value"] > res["checks"]["psd"]["limit"]
    assert "FAILED" in err


def trace(calls=2, device=None, bound_s=0.0005):
    if device is None:
        device = [
            R("cudnn::cnn::conv2d_grouped_direct_kernel<false>(float*)",
              10.001, 10.0048, "kernel"),
            R("Memcpy DtoD (Device -> Device)", 10.0048, 10.0050, "memcpy"),
            R("chunk_scan_sos_output_kernel<8, false>(float*)", 10.0049,
              10.0052, "kernel"),
            R("Memset (Device)", 10.006, 10.0061, "memset"),
            R("at::native::direct_copy_kernel_cuda(float*)", 10.0061,
              10.0090, "kernel"),
            # outside the window: left out
            R("abs_kernel_vectorized2_kernel(float*)", 9.990, 9.999,
              "kernel")]
    return devtrace.Trace(calls=calls, window=(10.0, 10.010), device=device,
                          host=[], host_s=[0.001] * calls, bound_s=bound_s)


def test_device_readers_on_synthetic_records():
    t = trace()
    # busy 10.001-10.0052 and 10.006-10.009: 7.2 ms over two calls
    assert reader("shard_device_ms").read(t) == pytest.approx(3.6)
    assert reader("shard_device_ms").read(t) == reader("device_ms").read(t)
    assert reader("shard_roofline").read(t) == pytest.approx(
        100 * 0.0005 / 0.0036)
    assert reader("shard_roofline").read(t) == reader(
        "call_roofline").read(t)
    for name in ("shard_device_ms", "shard_roofline"):
        assert reader(name).read(trace(device=[])) is None
    assert reader("shard_roofline").read(trace(bound_s=None)) is None


@pytest.fixture
def recorded():
    """Spans and counters of 4 warm calls of the cell's forward on a tiny
    block on the CPU, with tracing on."""
    forward = cell().config.build(cell().cfg, 8192, 2, "cpu")
    x = torch.randn(8192, 2, generator=torch.Generator().manual_seed(SEED))
    forward(x)
    kernels.reset_launches()
    profiling.tracing(True)
    try:
        for _ in range(4):
            forward(x)
    finally:
        profiling.tracing(False)
    yield profiling.spans()
    kernels.reset_launches()


def test_shard_host_ms_is_the_entry_span(recorded):
    entries = [r for r in recorded if r[3] == "entry"]
    assert len(entries) == 4
    assert {r[3] for r in recorded} == {"entry", "shard_fir",
                                        "shard.reblock", "shard_sosfilt",
                                        "kernel.biir", "shard_welch"}
    # the self times of a call's spans sum to its root's duration
    mean_ms = sum(r[5] - r[4] for r in entries[:2]) / 2 / 1e6
    assert reader("shard_host_ms").read(trace(calls=2)) == pytest.approx(
        mean_ms, abs=1e-9)
    assert reader("shard_host_ms").read(trace(calls=5)) is None
    assert reader("shard_host_ms").read(trace(calls=2, device=[])) is None


def test_shard_host_ms_without_a_shard_span(monkeypatch):
    """A program whose spans hold none of the shard_ ones (the parent's)
    reads None."""
    from benchmark import spans
    monkeypatch.setattr(spans, "self_times",
                        lambda t: {"entry": 1e-4, "kernel.biir": 1e-4})
    assert reader("shard_host_ms").read(trace()) is None
    monkeypatch.setattr(spans, "self_times",
                        lambda t: {"entry": 1e-5, "shard_fir": 2e-5,
                                   "filt": 1.0})
    assert reader("shard_host_ms").read(trace()) == pytest.approx(0.03)


def test_shard_reblock_mib(recorded):
    r = reader("shard_reblock_mib")
    # the FIR's block with its 126-row halo and Welch's 8704 rows (17
    # hops and the 512-row halo), 2 channels of 4 bytes, 4 calls
    per_call = 4 * 2 * ((8192 + 126) + (8192 + 512))
    assert profiling.counters()["shard.reblock.bytes"] == 4 * per_call
    # the counters cover both profiled windows: 2 x 2 calls
    assert r.read(trace(calls=2)) == pytest.approx(per_call / 2 ** 20)
    assert r.read(trace(calls=2, device=[])) is None
    kernels.reset_launches()
    profiling.count("table.biir.hit", 3)
    assert r.read(trace()) is None


def test_config_and_reference_load_no_jax():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "from benchmark import harness\n"
            f"c = harness.Cell({str(ROOT)!r}, {CELL!r})\n"
            "mods = lambda: {m.split('.')[0] for m in sys.modules}\n"
            "assert not mods() & {'jax', 'jaxlib', 'flax', 'dsptpu', "
            "'dsptpu_torch'}, mods()\n"
            "c.config.build(c.cfg, 8192, 2, 'cpu')\n"
            "print(sorted(mods() & {'jax', 'jaxlib', 'flax', 'dsptpu', "
            "'dsptpu_torch'}))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "['dsptpu_torch']"
