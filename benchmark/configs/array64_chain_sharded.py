"""The `array64_chain_sharded` configuration: the chain's multi-host
form, dsptpu_torch.pipeline.sharded_entry (shard_fir -> shard_sosfilt
-> shard_welch) on a mesh of every rank, here one, on blocks of (rows,
channels) float32. Each block reaches the entry as this rank's time
block of the stream, a DTensor placed by parallel.shard_time.

counts() holds the work one call needs, whatever implements it:

- bytes: the block read once (4 n C) and the PSD written once (4 B C,
  B = nfft/2 + 1 bins); no STFT power is written. The taps and window
  are too small to count.
- operations: the FIR, the cascade and the frames as
  array64_chain.counts counts them (the frames' part counts |X|^2, the
  PSD weight and Welch's sum of every bin as before).
"""

from pathlib import Path

import numpy as np

OUTPUTS = ("psd",)


def _chain():
    from benchmark import harness
    return harness._load(Path(__file__).with_name("array64_chain.py"),
                         "config")


def _check(cfg):
    """Raise ValueError where the configuration's chain is not
    sharded_entry's: chain_params()'s taps, sections and window, hop
    nfft/2, sections at gain 1, fs 1."""
    from dsptpu_torch import pipeline
    from dsptpu_torch.filters import FIRWindow, Lowpass, digitalfilter
    from dsptpu_torch.ops import windows
    fir_win = np.asarray(getattr(windows, cfg["fir_window"])(cfg["fir_taps"]))
    want = (np.asarray(digitalfilter(Lowpass(cfg["fir_cutoff"]),
                                     FIRWindow.create(fir_win)),
                       dtype=np.float32),
            pipeline.chain_params(cfg["iir_order"], cfg["iir_cutoff"],
                                  cfg["nfft"])[1],
            np.asarray(getattr(windows, cfg["window"])(
                cfg["nfft"])).astype(np.float32))
    got = pipeline.chain_params()
    if not (all(a.shape == b.shape and np.array_equal(a, b)
                for a, b in zip(want, got))
            and cfg["hop"] == cfg["nfft"] - cfg["nfft"] // 2
            and cfg["iir_gain"] == "unity" and cfg["fs"] == 1):
        keys = ("fir_taps", "fir_cutoff", "fir_window", "iir_order",
                "iir_cutoff", "iir_gain", "nfft", "hop", "window", "fs")
        raise ValueError(
            "sharded_entry runs chain_params()'s taps, sections and window "
            "at hop nfft/2, gain 1 and fs 1; the configuration states "
            + str({k: cfg[k] for k in keys}))


def build(cfg, rows, channels, device):
    """forward(x) of the port's sharded entry for blocks of (rows,
    channels): x placed as this rank's DTensor block, then the entry's
    forward; the entry's own input is dropped. The mesh covers every
    rank of the process group, started with one rank where none exists
    (NCCL on the card, gloo on the CPU)."""
    import atexit

    import torch
    import torch.distributed as dist
    from dsptpu_torch import parallel, pipeline
    _check(cfg)
    started = not dist.is_initialized()
    mesh = parallel.make_mesh(device_type=torch.device(device).type)
    if started:
        atexit.register(_destroy)
    fwd, (x,) = pipeline.sharded_entry(mesh, n=rows, channels=channels)
    del x

    def forward(x):
        return fwd(parallel.shard_time(x, mesh))
    return forward


def _destroy():
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def outputs(out):
    """The forward's output by the reference's name: this rank's PSD,
    replicated over time."""
    return {"psd": out.to_local()}


def counts(cfg, rows, channels):
    """{"bytes", "flops"} one call needs, with the parts of each."""
    bins = cfg["nfft"] // 2 + 1
    parts = _chain().counts(cfg, rows, channels)["parts"]
    return {"bytes": 4 * (rows * channels + bins * channels),
            "flops": sum(parts.values()), "parts": parts}
