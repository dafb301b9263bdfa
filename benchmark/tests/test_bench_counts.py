"""The byte and operation counts of each configuration against values
worked out by hand at a small shape."""

import pytest

from benchmark import harness, roofline
from benchmark.tests.helpers import ROOT


def cell(workload):
    return harness.Cell(ROOT, workload)


def test_chain_counts_by_hand():
    c = cell("chain64.block1m")
    got = c.config.counts(c.cfg, 4096, 2)
    # frames (4096 - 1024) / 512 + 1 = 7, bins 513
    assert got["bytes"] == 4 * (4096 * 2 + 513 * 2 + 513 * 7 * 2)
    # overlap-save's best block at 127 taps: N = 1024, two real FFTs of
    # 2.5 N log2 N and 513 complex products for 898 outputs
    fir = (2 * 2.5 * 1024 * 10 + 6 * 513) / 898
    assert c.config.fir_ops_per_output(127) == pytest.approx(fir)
    assert got["parts"]["fir"] == pytest.approx(fir * 8192)
    assert got["parts"]["cascade"] == 9 * 4 * 8192
    assert got["parts"]["frames"] == 7 * 2 * (2.5 * 1024 * 10 + 1024
                                              + 5 * 513)
    assert got["flops"] == pytest.approx(sum(got["parts"].values()))


def test_fir_direct_form_wins_for_short_taps():
    c = cell("chain64.block1m")
    assert c.config.fir_ops_per_output(9) == 18.0


def test_speech_counts_by_hand():
    c = cell("speech.mono1m")
    got = c.config.counts(c.cfg, 8000, 2)
    # 20 frames of 400; 16 coefficients and the error a frame
    assert got["bytes"] == 4 * (2 * 8000 * 2 + 17 * 20)
    assert got["parts"]["filtfilt"] == 2 * 9 * 4 * (8000 + 48) * 2
    lags = sum(2 * (400 - k) for k in range(17))
    assert got["parts"]["lpc"] == 20 * (lags + 2 * 16 * 16 + 2 * 16)


def test_full_size_bounds():
    c = cell("chain64.block1m")
    got = c.config.counts(c.cfg, 1_000_000, 64)
    # 1952 frames; bytes bound 512.5 MB / 3.35 TB/s
    assert got["bytes"] == 4 * (64_000_000 + 513 * 64 + 513 * 1952 * 64)
    assert roofline.bound_s(got["bytes"], got["flops"]) == pytest.approx(
        got["bytes"] / 3.35e12)
    s = cell("speech.batch64")
    got = s.config.counts(s.cfg, 1_000_000, 64)
    assert roofline.bound_s(got["bytes"], got["flops"]) == pytest.approx(
        4 * (128_000_000 + 17 * 2500) / 3.35e12)
