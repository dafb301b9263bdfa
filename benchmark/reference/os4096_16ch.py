"""Plain reference of the `os4096_16ch` configuration: the windowed-sinc
lowpass worked out again in float64 from the configuration's taps,
cutoff and window, applied to every channel from rest by one FFT
convolution over the whole block (complex128 for the reference), and
cut to the block's length. It shares nothing with the program's
overlap-save blocks.
"""

from benchmark.reference import common

# channels a chunk of the whole-block FFT: at 10,000,000 rows a 2^24-point
# transform of 4 channels holds about 2 GB in complex128
CHUNK = 4


def reference(cfg, x, precision="float64"):
    """{"y": (n, C)} of the block x (n, C) under the configuration `cfg`
    (its JSON file)."""
    taps = common.fir_lowpass(cfg["taps"], cfg["cutoff"], cfg["window"],
                              x.device)
    return {"y": common.fft_filter(x, taps, precision, chunk=CHUNK)}
