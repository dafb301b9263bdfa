"""shard_device_ms: the sharded chain's device time a call, in ms: the
union of the device's busy intervals (kernels, memcpy, memset) in the
traced window over its calls, as device_ms reads it. Every device
operation of a `chain64.sharded1` call is the sharded layer's local
route (_reblock's copies, the local FIR, K2, the local Welch). Layer:
kernels and device ops."""

from pathlib import Path

from benchmark import harness


def read(trace):
    return harness._load(Path(__file__).with_name("device_ms.py"),
                         "metric").read(trace)
