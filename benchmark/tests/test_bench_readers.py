"""The per-layer readers and the trace reduction on synthetic profiler
records."""

import pytest

from benchmark import devtrace, harness
from benchmark.tests.helpers import ROOT

R = devtrace.Record


def trace(**kw):
    base = dict(
        calls=2, window=(10.0, 10.010),
        device=[R("void fir_kernel<16>(float const*)", 10.001, 10.003,
                  "kernel"),
                R("void biir_scan(float*)", 10.002, 10.004, "kernel"),
                R("Memcpy HtoD (Pageable -> Device)", 10.0045, 10.005,
                  "memcpy"),
                R("void stft_pow(float*)", 10.006, 10.008, "kernel"),
                R("Memset (Device)", 10.0085, 10.0086, "memset"),
                # outside the window: left out
                R("void spin_kernel(long)", 9.990, 9.999, "kernel")],
        host=[R("benchmark.call", 10.0, 10.005, "host"),
              R("aten::cat", 10.0041, 10.0046, "host"),
              R("benchmark.call", 10.005, 10.010, "host"),
              R("cudaStreamSynchronize", 10.0086, 10.0099, "host")],
        host_s=[0.001, 0.003], bound_s=0.0005)
    base.update(kw)
    return devtrace.Trace(**base)


def reader(name):
    return harness._load(ROOT / "benchmark" / "metrics" / f"{name}.py",
                         "metric")


def test_union_merges_overlaps():
    recs = [R("a", 1.0, 3.0, "kernel"), R("b", 2.0, 4.0, "kernel"),
            R("c", 5.0, 6.0, "kernel"), R("d", 6.0, 6.5, "kernel")]
    assert devtrace.union(recs) == [(1.0, 4.0), (5.0, 6.5)]
    assert devtrace.union([]) == []


def test_busy_and_idle_share():
    t = trace()
    # 10.001-10.004, 10.0045-10.005, 10.006-10.008, 10.0085-10.0086
    busy = 0.003 + 0.0005 + 0.002 + 0.0001
    assert t.busy_s() == pytest.approx(busy, abs=1e-12)
    assert reader("idle_share").read(t) == pytest.approx(1 - busy / 0.010)
    assert reader("device_ms").read(t) == pytest.approx(1e3 * busy / 2)


def test_launches_count_kernels_only():
    # three kernels in the window over two calls; memcpy and memset apart
    assert reader("launches").read(trace()) == pytest.approx(1.5)
    assert reader("launches").read(trace(device=[])) is None


def test_roofline_and_host_ms():
    t = trace()
    assert reader("call_roofline").read(t) == pytest.approx(
        100 * 0.0005 / (t.busy_s() / 2))
    assert reader("call_roofline").read(trace(bound_s=None)) is None
    assert reader("host_ms").read(t) == pytest.approx(2.0)
    assert reader("host_ms").read(trace(host_s=[])) is None


def test_empty_trace_reads_nothing():
    t = trace(device=[])
    for name in ("idle_share", "device_ms", "call_roofline", "launches"):
        assert reader(name).read(t) is None


def test_breakdown_ranks_ops_and_labels_gaps():
    ops = dict(devtrace.device_ops(trace()))
    assert list(ops)[:3] == ["fir_kernel<16>", "biir_scan", "stft_pow"]
    assert "spin_kernel" not in ops
    gaps = dict(devtrace.idle_gaps(trace()))
    # 10.0-10.001 python at the call's start, 10.004-10.0045 in aten::cat,
    # 10.005-10.006, 10.008-10.0085, 10.0086-10.010 in the synchronize
    assert gaps["aten::cat"] == pytest.approx(0.0005)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(0.0014)
    assert sum(gaps.values()) == pytest.approx(0.010 - trace().busy_s())


def test_short_name_and_kind():
    assert devtrace.short_name("void k<int, 4>(float const*, int)") \
        == "k<int, 4>"
    assert devtrace.short_name(
        "void at::native::(anonymous namespace)::CatArrayBatchedCopy<int>"
        "(int*)") == "at::native::CatArrayBatchedCopy<int>"
    assert devtrace.short_name(
        "void (anonymous namespace)::stft_kernel<8>(float*)") \
        == "stft_kernel<8>"
    assert devtrace.device_kind("Memcpy DtoD (Device -> Device)") \
        == "memcpy"
    assert devtrace.device_kind("Memset (Device)") == "memset"
    assert devtrace.device_kind("void f()") == "kernel"


def test_percentile_and_gap():
    import torch
    assert harness.percentile([1, 2, 3, 4, 5], 50) == 3
    assert harness.percentile(list(range(101)), 95) == 95
    ref = torch.tensor([1.0, -4.0])
    assert harness.gap(torch.tensor([1.0, -3.0]), ref) == pytest.approx(0.25)
    assert harness.gap(torch.tensor([1.0]), ref) == float("inf")
    assert harness.gap(torch.tensor([float("nan"), 1.0]), ref) \
        == float("inf")


def test_sample_is_uniform_and_seeded():
    a, b = harness.Sample(3, 7), harness.Sample(3, 7)
    for i in range(1000):
        a.offer(i, i % 2, i)
        b.offer(i, i % 2, i)
    assert [c for c, _, _ in a.kept] == [c for c, _, _ in b.kept]
    assert len(a.kept) == 3 and max(c for c, _, _ in a.kept) >= 3
