"""The `speech16k_filtfilt_lpc16` configuration: the port's path B,
dsptpu_torch.pipeline.filtfilt_lpc_entry (filtfilt of every channel by
Butterworth(8) with its gain; LPC-16 by Levinson of channel 0's
non-overlapping 400-sample frames), on blocks of (rows, channels)
float32.

counts() holds the work one call needs, whatever implements it:

- bytes: the block read once (4 n C; the LPC's frames are part of it),
  the filtered block written once (4 n C), and the LPC's coefficients
  and errors (4 (p + 1) F for F frames).
- operations:
  - filtfilt: two passes of 9 operations a section a sample (5
    multiplies and 4 adds of a biquad) over the block extended by
    edge_pad (3 x order) samples at each end.
  - LPC: per frame the p + 1 biased lags by direct sums, 2 (L - k)
    operations for lag k of an L-sample frame (an FFT autocorrelation
    of a 400-sample frame costs more), and the Levinson recursion,
    4 (m - 1) + 4 at order m, 2 p^2 + 2 p in all.
"""

OUTPUTS = ("filtfilt", "lpc_a", "lpc_err")


def build(cfg, rows, channels, device):
    """forward(x) of the port's entry for blocks of (rows, channels); the
    entry's own input is dropped."""
    from dsptpu_torch.pipeline import filtfilt_lpc_entry
    forward, (x,) = filtfilt_lpc_entry(
        device=device, n=rows, channels=channels, order=cfg["iir_order"],
        cutoff=cfg["iir_cutoff"], lpc_order=cfg["lpc_order"],
        flen=cfg["frame_len"])
    del x
    return forward


def outputs(out):
    """The forward's outputs by the reference's names."""
    y, (a, err) = out
    return {"filtfilt": y, "lpc_a": a, "lpc_err": err}


def counts(cfg, rows, channels):
    """{"bytes", "flops"} one call needs, with the parts of each."""
    p, flen = cfg["lpc_order"], cfg["frame_len"]
    frames = rows // flen
    sections = (cfg["iir_order"] + 1) // 2
    extended = rows + 2 * cfg["edge_pad"]
    nbytes = 4 * (2 * rows * channels + (p + 1) * frames)
    parts = {
        "filtfilt": 2 * 9.0 * sections * extended * channels,
        "lpc": frames * (2.0 * ((p + 1) * flen - p * (p + 1) // 2)
                         + 2.0 * p * p + 2.0 * p),
    }
    return {"bytes": nbytes, "flops": sum(parts.values()), "parts": parts}
