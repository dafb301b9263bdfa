"""The `os4096_16ch` configuration: the port's path A,
dsptpu_torch.pipeline.fftfilt_entry (fftfilt of every channel by a
4096-tap Lowpass(0.1) Hamming FIR, by overlap-save blocks), on blocks
of (rows, channels) float32.

counts() holds the work one call needs, whatever implements it:

- bytes: the block read once (4 n C) and the filtered block written
  once (4 n C); the taps are too small to count.
- operations: the fewer of the direct form, 2 x taps an output, and
  FFT overlap-save at its best power-of-2 block, counted as
  array64_chain's FIR is (fir_ops_per_output). At 4096 taps the best is
  N = 65,536, 88.53 an output, against 8192 direct.
"""

import math

OUTPUTS = ("y",)


def build(cfg, rows, channels, device):
    """forward(x) of the port's entry for blocks of (rows, channels); the
    entry's own input is dropped."""
    from dsptpu_torch.pipeline import fftfilt_entry
    forward, (x,) = fftfilt_entry(device=device, n=rows, channels=channels,
                                  taps=cfg["taps"])
    del x
    return forward


def outputs(out):
    """The forward's output by the reference's name."""
    return {"y": out}


def fir_ops_per_output(taps):
    """Operations an output of a `taps`-tap FIR: the fewer of the direct
    form, 2 x taps, and FFT overlap-save at its best block: per block of
    N points, a real forward and inverse transform of 2.5 N log2 N each
    (the usual count of a real FFT, half of 5 N log2 N) and the product
    of N/2 + 1 complex bins (6 each), for N - taps + 1 outputs; N over
    the powers of 2 from 2 taps up."""
    direct = 2.0 * taps
    best, n = math.inf, 1 << (2 * taps - 1).bit_length()
    while n <= 1 << 22:
        per_block = 2 * 2.5 * n * math.log2(n) + 6 * (n // 2 + 1)
        best = min(best, per_block / (n - taps + 1))
        n *= 2
    return min(direct, best)


def counts(cfg, rows, channels):
    """{"bytes", "flops"} one call needs, with the parts of each."""
    samples = rows * channels
    parts = {"fir": fir_ops_per_output(cfg["taps"]) * samples}
    return {"bytes": 8 * samples, "flops": sum(parts.values()),
            "parts": parts}
