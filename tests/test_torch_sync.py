"""The host's waits on the card, counted and spanned where they happen
(dsptpu_torch.utils.device's transfer helpers, and the waits counted in
the ops' own code): the helpers return exactly what the plain calls
return; they count `sync.<site>` and `upload.bytes` on the CPU, and a
tensor that passes through counts nothing; with tracing off they record
no span and enter no profiler range; under a CPU torch.profiler each
`sync.<site>` is a range on the profiler's clock; the read-back sites of
the ops count where they run; and the counts of a warm call of each of
the five benchmarked entries at a tiny size on the CPU."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dsptpu_torch import kernels, pipeline
from dsptpu_torch.utils import device, profiling


@pytest.fixture
def clean():
    """Tracing off, the ring and counters empty, before and after."""
    profiling.tracing(False)
    kernels.reset_launches()
    yield
    profiling.tracing(False)
    kernels.reset_launches()


def _waits():
    return {k: v for k, v in profiling.counters().items()
            if k.startswith(("sync.", "upload."))}


HOST_VALUES = [
    np.arange(12, dtype=np.float32).reshape(3, 4),
    np.linspace(-1, 1, 7),
    np.arange(5, dtype=np.int64),
    [1.5, -2.0, 3.25],
    [1, 2, 3],
    2.5,
    7,
    np.float32(0.5),
]


@pytest.mark.parametrize("v", HOST_VALUES, ids=lambda v: type(v).__name__)
def test_as_tensor_is_the_plain_upload(v, clean):
    got = device.as_tensor(v, "cpu", site="probe.up")
    want = torch.as_tensor(np.asarray(v), device="cpu")
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert _waits() == {"sync.probe.up": 1,
                        "upload.bytes": np.asarray(v).nbytes}


@pytest.mark.parametrize("t", [
    torch.arange(6, dtype=torch.float32).reshape(2, 3),
    torch.randn(5, dtype=torch.float64),
    torch.arange(4).requires_grad_(False),
    torch.ones(3, requires_grad=True),
], ids=["f32", "f64", "i64", "grad"])
def test_to_host_is_the_plain_read_back(t, clean):
    got = device.to_host(t, "probe.down")
    want = t.detach().cpu().numpy()
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype
    assert np.array_equal(got, want)
    assert _waits() == {"sync.probe.down": 1}


def test_passing_through_counts_nothing(clean):
    t = torch.randn(4, 3)
    assert device.as_tensor(t, "cpu", site="probe.up") is t
    a = np.arange(3.0)
    h = device.to_host(a, "probe.down")
    assert np.array_equal(h, a) and h.dtype == a.dtype
    assert np.array_equal(device.to_host([1, 2], "probe.down"), [1, 2])
    assert _waits() == {}
    # each transfer counts once, its bytes add up
    device.as_tensor(np.zeros(10, np.float32), "cpu", site="probe.up")
    device.as_tensor(np.zeros(3), "cpu", site="probe.up")
    device.to_host(t, "probe.down")
    device.to_host(t, "probe.down")
    assert _waits() == {"sync.probe.up": 2, "sync.probe.down": 2,
                        "upload.bytes": 40 + 24}
    # the default site of as_tensor
    device.as_tensor([0.0], "cpu")
    assert _waits()["sync.as_tensor"] == 1


class _Refused:
    def __init__(self, name):
        raise AssertionError(f"profiler range {name!r} entered")


def test_off_records_no_span_and_enters_no_range(monkeypatch, clean):
    monkeypatch.setattr(profiling, "_RecordFunctionFast", _Refused)
    device.as_tensor(np.ones(4), "cpu", site="probe.up")
    device.to_host(torch.ones(4), "probe.down")
    assert profiling.spans() == []
    assert _waits() == {"sync.probe.up": 1, "sync.probe.down": 1,
                        "upload.bytes": 32}
    # on without a profiler: the ring records, still no profiler range
    profiling.tracing(True)
    with profiling.span("entry"):
        device.as_tensor(np.ones(4), "cpu", site="probe.up")
        device.to_host(torch.ones(4), "probe.down")
    recs = profiling.spans()
    assert [r[3] for r in recs] == ["entry", "sync.probe.up",
                                    "sync.probe.down"]
    assert [r[2] for r in recs[1:]] == [recs[0][0]] * 2


def test_sync_spans_are_ranges_on_the_profiler_clock(clean):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("entry"):
            device.as_tensor(np.ones(64, np.float32), "cpu",
                             site="probe.up")
            device.to_host(torch.ones(64), "probe.down")
    events = {e.name: e for e in prof.events()}
    assert {"entry", "sync.probe.up", "sync.probe.down"} <= set(events)
    outer = events["entry"].time_range
    for name in ("sync.probe.up", "sync.probe.down"):
        r = events[name].time_range
        assert outer.start <= r.start <= r.end <= outer.end
    # the profiler turned tracing on: the ring holds the same spans
    assert [r[3] for r in profiling.spans()] == [
        "entry", "sync.probe.up", "sync.probe.down"]


def test_read_back_sites_of_the_ops_count(clean):
    """A tensor where an op wants host coefficients or a window is read
    back, once, at its site; the result equals the host arrays'. (Host
    coefficients of an IIR filt are uploaded, then read back at the same
    sites.)"""
    from dsptpu_torch import filters, sosfilt, welch_pgram
    from dsptpu_torch.ops import dspbase
    from dsptpu_torch.pipeline import chain_params
    x = torch.randn(4096, 2, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    b, a = np.array([0.2, 0.3, 0.2]), np.array([1.0, -0.5, 0.1])

    def sites(call, *names):
        kernels.reset_launches()
        out = call()
        c = _waits()
        return out, [c.get("sync." + k, 0) for k in names]

    want, n = sites(lambda: dspbase.filt(b, a, x), "filt.b", "filt.a")
    assert n == [1, 1]
    got, n = sites(lambda: dspbase.filt(torch.as_tensor(b),
                                        torch.as_tensor(a), x),
                   "filt.b", "filt.a")
    assert torch.equal(got, want) and n == [1, 1]
    sos = chain_params()[1].astype(np.float64)
    want, n = sites(lambda: sosfilt(sos, x), "sosfilt.sos")
    assert n == [0]
    got, n = sites(lambda: sosfilt(torch.as_tensor(sos), x), "sosfilt.sos")
    assert torch.equal(got, want) and n == [1]
    win = np.hanning(256)
    want, n = sites(lambda: welch_pgram(x, 256, 128, window=win).power,
                    "window")
    assert n == [0]
    got, n = sites(lambda: welch_pgram(x, 256, 128,
                                       window=torch.as_tensor(win)).power,
                   "window")
    assert torch.equal(torch.as_tensor(got), torch.as_tensor(want))
    assert n == [1]
    want, n = sites(lambda: filters.filtfilt(b, a, x), "filtfilt.coefs")
    assert n == [0]
    got, n = sites(lambda: filters.filtfilt(torch.as_tensor(b),
                                            torch.as_tensor(a), x),
                   "filtfilt.coefs")
    assert torch.equal(got, want) and n == [2]


@pytest.mark.parametrize("n,writes", [(1024, 2), (1023, 1), (2, 2),
                                      (1, 1)])
def test_welch_one_sided_scale_counts_its_host_scalars(n, writes, clean):
    from dsptpu_torch.parallel.ops import _onesided_scale
    scale = _onesided_scale(n, torch.float32, torch.device("cpu"))
    want = np.full(n // 2 + 1, 2.0, np.float32)
    want[0] = 1.0
    if n % 2 == 0:
        want[-1] = 1.0
    assert np.array_equal(scale.numpy(), want)
    assert _waits() == {"sync.shard_welch.scale": writes,
                        "upload.bytes": 4 * writes}


# the sync.* counts and upload.bytes of one warm call of each entry on
# the CPU, at a tiny size; K1 needs 32,768 rows, K5 128 frames
ENTRIES = {
    "entry": ({}, lambda: pipeline.entry(device="cpu", n=32768,
                                         channels=2, nfft=256)),
    "filtfilt_lpc_entry": ({}, lambda: pipeline.filtfilt_lpc_entry(
        device="cpu", n=51200, channels=2)),
    "fftfilt_entry": ({}, lambda: pipeline.fftfilt_entry(
        device="cpu", n=40000, channels=2)),
    "multitaper_entry": ({}, lambda: pipeline.multitaper_entry(
        device="cpu", n=8192, channels=2, coh_n=2048)),
    # shard_welch: the float64 Hann window of 1024 points (8 KiB) and
    # the one-sided weights' two float32 host scalars
    "sharded_entry": ({"sync.shard_welch.window": 1,
                       "sync.shard_welch.scale": 2,
                       "upload.bytes": 8 * 1024 + 2 * 4}, None),
}


@pytest.mark.parametrize("name", list(ENTRIES))
def test_warm_call_counts_of_each_entry(name, clean):
    want, make = ENTRIES[name]
    made = False
    try:
        if make is None:
            from dsptpu_torch import parallel
            made = not dist.is_initialized()
            mesh = parallel.make_mesh(device_type="cpu")
            fwd, (x,) = pipeline.sharded_entry(mesh, n=8192, channels=2)
        else:
            fwd, (x,) = make()
        fwd(x)
        for calls in (1, 3):
            kernels.reset_launches()
            profiling.tracing(True)
            for _ in range(calls):
                fwd(x)
            profiling.tracing(False)
            assert _waits() == {k: calls * v for k, v in want.items()}
            spans = {}
            for r in profiling.spans():
                if r[3].startswith("sync."):
                    spans[r[3]] = spans.get(r[3], 0) + 1
            assert spans == {k: calls * v for k, v in want.items()
                             if k.startswith("sync.")}
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()
