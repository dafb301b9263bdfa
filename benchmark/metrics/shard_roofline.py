"""shard_roofline: the sharded chain's share of its roofline, in %: the
least time one call could take on the card (the configuration's bytes
and operations against the card's peaks, benchmark/roofline.py) over
the device time the call took (shard_device_ms), as call_roofline reads
it. The sharded route adds no kernel of its own, so this is the call's
share. Layer: kernels and device ops."""

from pathlib import Path

from benchmark import harness


def read(trace):
    return harness._load(Path(__file__).with_name("call_roofline.py"),
                         "metric").read(trace)
