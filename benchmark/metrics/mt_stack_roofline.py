"""mt_stack_roofline: K3's multitaper stack's share of its roofline, in
%: the least time the stack could take on the card (the configuration's
stack_counts(), the spectrogram's own bytes and operations, against the
card's peaks, benchmark/roofline.py) over its device time a call
(mt_stack_ms). The trace's bound is the whole call's, so the stack's
count is taken from the cell's configuration and traffic files. None
where the window holds no stack record. Layer: kernels and device
ops."""

from pathlib import Path

from benchmark import harness, roofline

CELL = "multitaper64.block1m"
ROOT = Path(__file__).resolve().parents[2]


def stack_bound_s():
    """The stack's bound at the cell's traffic, in seconds."""
    cell = harness.Cell(ROOT, CELL)
    rows, channels, _ = cell.shape()
    c = cell.config.stack_counts(cell.cfg, rows, channels)
    return roofline.bound_s(c["bytes"], c["flops"])


def read(trace):
    stack = harness._load(Path(__file__).with_name("mt_stack_ms.py"),
                          "metric")
    s = stack.stack_s(trace)
    if s is None or s <= 0:
        return None
    return 100.0 * stack_bound_s() / s
