"""The `array64_chain` configuration: the port's flagship chain,
dsptpu_torch.pipeline.entry (127-tap FIR -> Butterworth(8) cascade ->
Welch PSD + STFT power), on blocks of (rows, channels) float32.

counts() holds the work one call needs, whatever implements it:

- bytes: the block read once (4 n C) and the two outputs written once:
  the PSD (4 B C) and the STFT power (4 B K C), B = nfft/2 + 1 bins, K
  frames; the taps and window are too small to count.
- operations:
  - FIR: the fewer of the direct form, 2 x taps an output, and FFT
    overlap-save at its best block: per block of N points, a real
    forward and inverse transform of 2.5 N log2 N each (the usual count
    of a real FFT, half of 5 N log2 N) and the product of N/2 + 1
    complex bins (6 each), for N - taps + 1 outputs; N over the powers
    of 2 from 2 taps up. At 127 taps the best is N = 1024, 60.4 an
    output, against 254 direct.
  - cascade: 9 operations a section a sample (5 multiplies and 4 adds
    of a biquad).
  - frames: one real transform of nfft points a frame (2.5 nfft log2
    nfft), the window (nfft multiplies), |X|^2 (3 a bin), the PSD
    weight (1 a bin) and Welch's sum over the frames (1 a bin); the
    transform is counted once although the PSD and the STFT both come
    from it.
"""

import math

OUTPUTS = ("psd", "stft")


def build(cfg, rows, channels, device):
    """forward(x) of the port's entry for blocks of (rows, channels); the
    entry's own input is dropped."""
    from dsptpu_torch.pipeline import entry
    forward, (x,) = entry(device=device, n=rows, channels=channels,
                          order=cfg["iir_order"], cutoff=cfg["iir_cutoff"],
                          nfft=cfg["nfft"])
    del x
    return forward


def outputs(out):
    """The forward's outputs by the reference's names."""
    psd, stft = out
    return {"psd": psd, "stft": stft}


def fir_ops_per_output(taps):
    direct = 2.0 * taps
    best, n = math.inf, 1 << (2 * taps - 1).bit_length()
    while n <= 1 << 22:
        per_block = 2 * 2.5 * n * math.log2(n) + 6 * (n // 2 + 1)
        best = min(best, per_block / (n - taps + 1))
        n *= 2
    return min(direct, best)


def counts(cfg, rows, channels):
    """{"bytes", "flops"} one call needs, with the parts of each."""
    nfft, hop = cfg["nfft"], cfg["hop"]
    bins = nfft // 2 + 1
    frames = (rows - nfft) // hop + 1
    samples = rows * channels
    nbytes = 4 * (samples + bins * channels + bins * frames * channels)
    sections = (cfg["iir_order"] + 1) // 2
    parts = {
        "fir": fir_ops_per_output(cfg["fir_taps"]) * samples,
        "cascade": 9.0 * sections * samples,
        "frames": frames * channels * (2.5 * nfft * math.log2(nfft) + nfft
                                       + 5.0 * bins),
    }
    return {"bytes": nbytes, "flops": sum(parts.values()), "parts": parts}
