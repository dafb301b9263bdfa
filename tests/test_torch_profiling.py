"""The port's profiling helpers (dsptpu_torch.utils.profiling): Roofline
arithmetic against hand values and against dsptpu's Roofline with one
f32 pass, a torch.profiler trace written as a Chrome trace file with
its span, measure refusing to time without a card, and
device_by_kernel on fake profiles: an empty one taken again once, two
failing the call (and with it chip_smoke.py's sharded-phase times and
tools/ab_common.py's readers), and its name and exclude filters.

The spans and counters: nothing recorded and no profiler range entered
with tracing off; nesting, parent indices and call ids; self times that
split the root; the ring's bound; counters, the counted table caches
and their reset by kernels.reset_launches; the span names in a CPU
torch.profiler trace of path B (chip_smoke.py reads its "lpc" range);
and the span tree and table hits of both benchmarked entries at a tiny
size on the CPU."""

import importlib
import json

import pytest
import torch

from dsptpu.utils import profiling as jprof
from dsptpu_torch import kernels, pipeline
from dsptpu_torch.kernels import biir, stft
from dsptpu_torch.utils import profiling


@pytest.fixture
def clean_ring():
    """Tracing off, the ring and counters empty, before and after."""
    profiling.tracing(False)
    profiling.reset()
    yield
    profiling.tracing(False)
    profiling.reset()


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


def test_trace_writes_a_chrome_trace(tmp_path, clean_ring):
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.span("dsptpu_region"):
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


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------

class _Refused:
    def __init__(self, name):
        raise AssertionError(f"profiler range {name!r} entered")


@profiling.spanned("decorated")
def _decorated(v):
    with profiling.span("inner"):
        return v + 1


def test_off_records_nothing_and_enters_no_range(monkeypatch, clean_ring):
    monkeypatch.setattr(profiling, "_RecordFunctionFast", _Refused)
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a"):
        assert _decorated(1) == 2
    fwd, (x,) = pipeline.entry(device="cpu", n=2048, channels=1, nfft=256)
    fwd(x)
    assert profiling.spans() == []
    assert profiling.self_times(1) is None
    # on without a profiler: records, still no profiler range
    profiling.tracing(True)
    with profiling.span("a"):
        _decorated(1)
    assert [r[3] for r in profiling.spans()] == ["a", "decorated", "inner"]


def test_nesting_parents_and_call_ids(clean_ring):
    profiling.tracing(True)
    for _ in range(2):
        with profiling.span("root"):
            with profiling.span("child"):
                with profiling.span("leaf"):
                    pass
            _decorated(0)
    with profiling.span("root"):
        pass
    recs = profiling.spans()
    assert [r[3] for r in recs] == ["root", "child", "leaf", "decorated",
                                    "inner"] * 2 + ["root"]
    idx = [r[0] for r in recs]
    assert idx == list(range(idx[0], idx[0] + 11))
    r0, r1 = idx[0], idx[5]
    assert [r[2] for r in recs] == [-1, r0, r0 + 1, r0, r0 + 3,
                                    -1, r1, r1 + 1, r1, r1 + 3, -1]
    calls = [r[1] for r in recs]
    assert calls[:5] == [calls[0]] * 5 and calls[5:10] == [calls[5]] * 5
    assert len({calls[0], calls[5], calls[10]}) == 3
    for i, call, parent, name, start, end in recs:
        assert 0 < start <= end
        if parent >= 0:
            p = recs[parent - idx[0]]
            assert p[4] <= start and end <= p[5]


def test_self_times_split_the_root(clean_ring):
    profiling.tracing(True)
    for _ in range(3):
        with profiling.span("root"):
            torch.ones(1000).cumsum(0)
            with profiling.span("child"):
                torch.ones(1000).cumsum(0)
                _decorated(0)
            with profiling.span("child"):
                pass
    recs = profiling.spans()
    roots = [r for r in recs if r[2] < 0]
    st = profiling.self_times(2)
    assert set(st) == {"root", "child", "decorated", "inner"}
    assert all(v >= 0 for v in st.values())
    mean_root = sum(r[5] - r[4] for r in roots[:2]) / 2 / 1e9
    assert sum(st.values()) == pytest.approx(mean_root, abs=1e-9)
    child = sum(r[5] - r[4] for r in recs if r[3] == "child"
                and r[1] in {roots[0][1], roots[1][1]}) / 2 / 1e9
    assert st["root"] == pytest.approx(mean_root - child, abs=1e-9)
    assert profiling.self_times(4) is None
    assert profiling.self_times(0) is None


def test_ring_keeps_its_bound(monkeypatch, clean_ring):
    assert profiling.RING_RECORDS >= 1 << 17
    monkeypatch.setattr(profiling, "RING_RECORDS", 8)
    monkeypatch.setattr(profiling, "_ring", [None] * 8)
    profiling.reset()
    profiling.tracing(True)
    for _ in range(7):
        with profiling.span("root"):
            with profiling.span("child"):
                pass
    recs = profiling.spans()
    assert len(recs) == 8 and len(profiling._ring) == 8
    assert [r[3] for r in recs] == ["root", "child"] * 4
    # the first four roots left the ring; the others are read
    assert profiling.self_times(4) is not None
    assert profiling.self_times(5) is None


def test_counters_and_reset(clean_ring):
    profiling.count("x")
    profiling.count("x", 4)
    profiling.count("y", 2)
    assert profiling.counters() == {"x": 5, "y": 2}
    built = []

    @profiling.table_cache("probe", lambda k, v: k, bound=1)
    def build(k, v):
        built.append(v)
        return [v]
    assert build("a", 1) == [1] and build("a", 2) == [1]
    build("b", 3)
    build("c", 4)                 # a miss over the bound clears the cache
    assert built == [1, 3, 4] and list(build.entries) == ["c"]
    c = profiling.counters()
    assert (c["table.probe.hit"], c["table.probe.miss"]) == (1, 3)
    profiling.tracing(True)
    with profiling.span("a"):
        pass
    kernels.reset_launches()
    assert profiling.counters() == {} and profiling.spans() == []
    assert set(kernels.launch_counts()) == set(kernels.KERNELS) | {
        "biir_reverse"}


def test_span_names_in_a_cpu_profiler_trace(tmp_path, clean_ring):
    """A profiler turns tracing on: the ring records, and each span is a
    range of the Chrome trace and of key_averages (chip_smoke.py reads
    path B's "lpc" range by name)."""
    from torch.profiler import ProfilerActivity, profile
    fwd, (x,) = pipeline.filtfilt_lpc_entry(device="cpu", n=51200,
                                            channels=1)
    fwd(x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fwd(x)
    names = {"entry", "filtfilt", "filtfilt.design", "filtfilt.tables",
             "filtfilt.edges", "kernel.biir", "frames", "lpc", "lpc.lags",
             "kernel.levinson"}
    assert {e.key for e in prof.key_averages()} >= names
    assert {r[3] for r in profiling.spans()} == names
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert {e.get("name") for e in events} >= names


def _tree(recs):
    """{name: set of parent names} of one call's records."""
    first = recs[0][0]
    out = {}
    for i, call, parent, name, start, end in recs:
        out.setdefault(name, set()).add(
            None if parent < 0 else recs[parent - first][3])
    return out


def _tables_used():
    # the module, not the function that filters/__init__ binds to `filt`
    filt_mod = importlib.import_module("dsptpu_torch.filters.filt")
    return (filt_mod._blockss, filt_mod._ff_dev_tables,
            filt_mod._ff_edge_tables, filt_mod._rec_tables, biir._tables,
            stft._tables, stft._upload)


CHAIN_TREE = {"entry": {None}, "filt": {"entry"}, "kernel.fir": {"filt"},
              "sosfilt": {"entry"}, "kernel.biir": {"sosfilt"},
              "welch_pgram": {"entry"},
              "kernel.stft": {"welch_pgram", "stft"}, "stft": {"entry"},
              "power": {"entry"}}
PATH_B_TREE = {"entry": {None}, "filtfilt": {"entry"},
               "filtfilt.design": {"filtfilt"},
               "filtfilt.tables": {"filtfilt"},
               "filtfilt.edges": {"filtfilt"}, "kernel.biir": {"filtfilt"},
               "frames": {"entry"}, "lpc": {"entry"},
               "lpc.lags": {"lpc"}, "kernel.levinson": {"lpc"}}


@pytest.mark.parametrize("which", ["chain", "path_b"])
def test_entry_span_tree_and_table_hits(which, clean_ring):
    """The entries' stage and wrapper spans under `entry` (K1 needs 32768
    rows, K5 128 frames), and their table caches: on a first call one
    miss a key, then hits only."""
    if which == "chain":
        fwd, (x,) = pipeline.entry(device="cpu", n=32768, channels=2,
                                   nfft=256)
        tree, order = CHAIN_TREE, ["entry", "filt", "kernel.fir",
                                   "sosfilt", "kernel.biir",
                                   "welch_pgram", "kernel.stft", "stft",
                                   "kernel.stft", "power"]
        first = {"blockss": (0, 1), "biir": (0, 1), "stft": (1, 1),
                 "stft_host": (1, 3)}
        second = {"blockss": (1, 0), "biir": (1, 0), "stft": (2, 0),
                  "stft_host": (4, 0)}
    else:
        fwd, (x,) = pipeline.filtfilt_lpc_entry(device="cpu", n=51200,
                                                channels=1)
        tree, order = PATH_B_TREE, [
            "entry", "filtfilt", "filtfilt.design", "filtfilt.tables",
            "filtfilt.edges", "kernel.biir", "filtfilt.edges",
            "kernel.biir", "filtfilt.edges", "frames", "lpc", "lpc.lags",
            "kernel.levinson"]
        first = {"blockss": (0, 1), "ff_dev": (0, 1), "ff_edge": (0, 1),
                 "biir": (1, 1)}
        second = {"blockss": (1, 0), "ff_dev": (1, 0), "biir": (2, 0)}
    for t in _tables_used():
        t.entries.clear()
    profiling.tracing(True)
    for want in (first, second):
        kernels.reset_launches()
        fwd(x)
        recs = profiling.spans()
        assert [r[3] for r in recs] == order
        assert _tree(recs) == tree
        assert len({r[1] for r in recs}) == 1
        c = profiling.counters()
        got = {k.split(".")[1]: (c.get(f"table.{k.split('.')[1]}.hit", 0),
                                 c.get(f"table.{k.split('.')[1]}.miss", 0))
               for k in c}
        assert got == want
    st = profiling.self_times(1)
    root = recs[0][5] - recs[0][4]
    assert sum(st.values()) == pytest.approx(root / 1e9, abs=1e-9)
