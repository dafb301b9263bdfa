"""osconv_roofline: K4's share of its roofline, in %: the least time the
call could take on the card (the configuration's bytes and operations
against the card's peaks, benchmark/roofline.py) over K4's device time
a call (osconv_ms). A call of path A is K4 alone, so the call's counts
are K4's. None where the window holds no K4 record. Layer: kernels and
device ops."""

from pathlib import Path

from benchmark import harness


def read(trace):
    k4 = harness._load(Path(__file__).with_name("osconv_ms.py"), "metric")
    s = k4.osconv_s(trace)
    if trace.bound_s is None or s is None or s <= 0:
        return None
    return 100.0 * trace.bound_s / s
