"""Path A as the benchmark's `os4096_16ch` deployment runs it, at small
sizes on the CPU, where K4's plain version stands in for the kernel:

- `pipeline.fftfilt_entry` against the benchmark's plain float64
  reference (benchmark/reference/os4096_16ch.py) within bench.py's
  overlap-save tolerance, 3e-5 of max|ref|, which the reference computed
  in TF32 misses;
- `fftfilt` with seeded random taps against one whole-block FFT
  convolution in float64;
- the call's spans (`entry` -> `fftfilt` -> `kernel.osconv`), its route
  counters (`route.conv_os.k4`, or `route.conv_os.fft` for float64), and
  the filter-spectrum cache's `table.os_spec.hit`/`.miss` counters with
  its identity and version check.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import common
from benchmark.reference import os4096_16ch as reference
from dsptpu_torch import kernels, pipeline
from dsptpu_torch.filters.filt import fftfilt
from dsptpu_torch.kernels import osconv
from dsptpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "benchmark" / "configs" / "os4096_16ch.json")
                 .read_text())
# bench.py's tolerance of the overlap-save config: max |y - ref| / max |ref|
TOL = 3e-5


def _gap(got, ref):
    ref = ref.to(torch.float64)
    return float((got.to(torch.float64) - ref).abs().max()
                 / ref.abs().max())


@pytest.fixture
def clean_ring():
    """Tracing off, the ring and counters empty, before and after."""
    profiling.tracing(False)
    kernels.reset_launches()
    yield
    profiling.tracing(False)
    kernels.reset_launches()


def test_entry_matches_the_benchmark_reference():
    fwd, _ = pipeline.fftfilt_entry(device="cpu", n=50_000, channels=3,
                                    taps=CFG["taps"])
    gen = torch.Generator().manual_seed(2 ** 31 + 21)
    x = torch.randn((50_000, 3), generator=gen)
    y = fwd(x)
    assert y.shape == x.shape and y.dtype == torch.float32
    ref = reference.reference(CFG, x, "float64")["y"]
    assert _gap(y, ref) <= TOL
    # the control: the reference computed in TF32 fails the tolerance
    tf32 = reference.reference(CFG, x, "tf32")["y"]
    assert _gap(tf32, ref) > TOL


def test_entry_taps_are_the_reference_design():
    h = pipeline.fftfilt_taps(CFG["taps"])
    ref = common.fir_lowpass(CFG["taps"], CFG["cutoff"], CFG["window"],
                             "cpu")
    np.testing.assert_allclose(h, ref.numpy(), rtol=0, atol=1e-8)


@pytest.mark.parametrize("ntaps", [600, 4096])
def test_fftfilt_random_taps(ntaps):
    rng = np.random.default_rng(ntaps)
    x = torch.as_tensor(rng.standard_normal((30_000, 2)), dtype=torch.float32)
    h = torch.as_tensor(rng.standard_normal(ntaps), dtype=torch.float32)
    y = fftfilt(h, x)
    assert y.shape == x.shape
    assert _gap(y, common.fft_filter(x, h, "float64")) <= TOL


def test_spans_and_route_counters(clean_ring):
    fwd, (x,) = pipeline.fftfilt_entry(device="cpu", n=40_000, channels=2)
    profiling.tracing(True)
    fwd(x)
    recs = profiling.spans()
    assert [r[3] for r in recs] == ["entry", "fftfilt", "kernel.osconv"]
    # each span is the child of the one before it, in one call
    assert [r[2] for r in recs] == [-1, recs[0][0], recs[1][0]]
    assert len({r[1] for r in recs}) == 1
    assert profiling.counters() == {"route.conv_os.k4": 1}
    # float64 fails K4's gate: batched torch.fft frames
    kernels.reset_launches()
    fftfilt(torch.as_tensor(pipeline.fftfilt_taps(4096), dtype=torch.float64),
            x.double())
    assert profiling.counters() == {"route.conv_os.fft": 1}
    assert [r[3] for r in profiling.spans()] == ["fftfilt"]


def test_spectrum_cache_counts_hits_and_misses(clean_ring):
    v = torch.as_tensor(pipeline.fftfilt_taps(600))
    first = osconv._spectrum(v, 8192)
    assert profiling.counters() == {"table.os_spec.miss": 1}
    again = osconv._spectrum(v, 8192)
    assert again is first
    assert profiling.counters() == {"table.os_spec.miss": 1,
                                    "table.os_spec.hit": 1}
    # an in-place change of the filter misses (its version counter)
    v.mul_(2.0)
    changed = osconv._spectrum(v, 8192)
    assert profiling.counters() == {"table.os_spec.miss": 2,
                                    "table.os_spec.hit": 1}
    torch.testing.assert_close(changed, 2.0 * first)
