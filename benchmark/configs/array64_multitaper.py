"""The `array64_multitaper` configuration: the port's path D,
dsptpu_torch.pipeline.multitaper_entry (the multitaper spectrogram of
every channel through K3's 7-window stack, then the all-pairs coherence
of the block's first coh_n rows), on blocks of (rows, channels) float32.

counts() holds the work one call needs, whatever implements it:

- bytes: the block read once (4 n C), the spectrogram written once
  (4 B T C: B = nfft/2 + 1 bins, T frames) and the coherence written
  once (4 C^2 (coh_n/2 + 1)); the tapers are too small to count.
- operations, in `parts`:
  - stack: stack_counts(), the spectrogram: per frame, channel and
    taper, one real transform of nfft points (2.5 nfft log2 nfft, as
    os4096_16ch.fir_ops_per_output counts a real FFT), the taper's
    products (nfft), and |X|^2 added into the taper sum (4 a bin: two
    multiplies and two adds);
  - coh_fft: the coherence's C x K real transforms of coh_n points
    (2.5 coh_n log2 coh_n each) and their taper products (coh_n each);
  - cross: the cross-spectral product over the Hermitian half, pairs
    l <= m: a complex multiply-add (8) a pair, taper and bin;
  - coh: per entry of the (C, C, bins) output, |S| (2 multiplies, an
    add, a square root), the diagonal's product and its square root
    (2) and the division (1): 7.
"""

import math

OUTPUTS = ("power", "coherence")


def build(cfg, rows, channels, device):
    """forward(x) of the port's entry for blocks of (rows, channels); the
    entry's own input is dropped. The entry's frame and taper constants
    are the configuration's."""
    from dsptpu_torch import pipeline
    got = (pipeline.MT_NFFT, pipeline.MT_OVERLAP, pipeline.MT_NW,
           pipeline.MT_NTAPERS)
    want = (cfg["nfft"], cfg["overlap"], cfg["nw"], cfg["ntapers"])
    if got != want or cfg["fs"] != 1 or cfg["demean"]:
        raise ValueError(f"multitaper_entry runs nfft, overlap, nw, "
                         f"ntapers {got} at fs 1 without demeaning; the "
                         f"configuration states {want}")
    forward, (x,) = pipeline.multitaper_entry(
        device=device, n=rows, channels=channels, coh_n=cfg["coh_n"])
    del x
    return forward


def outputs(out):
    """The forward's outputs by the reference's names."""
    power, coherence = out
    return {"power": power, "coherence": coherence}


def frames(cfg, rows):
    """The spectrogram's frame count at `rows`."""
    hop = cfg["nfft"] - cfg["overlap"]
    return (rows - cfg["nfft"]) // hop + 1


def real_fft_ops(n):
    """Operations of a real transform of n points: 2.5 n log2 n."""
    return 2.5 * n * math.log2(n)


def stack_counts(cfg, rows, channels):
    """{"bytes", "flops"} of the spectrogram alone (K3's stack): the
    block read once, the spectrogram written once; the transforms, taper
    products and |X|^2 sums of every frame, channel and taper."""
    nfft, bins = cfg["nfft"], cfg["nfft"] // 2 + 1
    t = frames(cfg, rows)
    transforms = cfg["ntapers"] * t * channels
    flops = transforms * (real_fft_ops(nfft) + nfft + 4 * bins)
    return {"bytes": 4 * rows * channels + 4 * bins * t * channels,
            "flops": flops}


def counts(cfg, rows, channels):
    """{"bytes", "flops"} one call needs, with the parts of each."""
    stack = stack_counts(cfg, rows, channels)
    n, k = cfg["coh_n"], cfg["ntapers"]
    bins = n // 2 + 1
    pairs = channels * (channels + 1) // 2
    parts = {"stack": stack["flops"],
             "coh_fft": channels * k * (real_fft_ops(n) + n),
             "cross": 8 * pairs * k * bins,
             "coh": 7 * channels * channels * bins}
    return {"bytes": stack["bytes"] + 4 * channels * channels * bins,
            "flops": sum(parts.values()), "parts": parts}
