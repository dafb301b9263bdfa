"""Streaming IO example on dsptpu_torch, the PyTorch / CUDA port
(examples/streaming_io.py on torch tensors): the C++ prefetching reader
into a stateful filter.

native.StreamReader (dsptpu_torch/native/ringbuffer.cpp) keeps chunks
ahead of the consumer, so disk or pipe reads overlap device work, and
hands each chunk to the card through a pinned buffer; FIRFilter carries
its streaming state across chunks, so the chunked output equals
filtering the whole file at once (the reference's stateful-stream
contract, stream_filt.jl:137-141). Runs on the card unless asked for
the CPU:

    PYTHONPATH=. python3 examples/torch_streaming_io.py [--device cpu]

Prints each claim with its check, and exits 1 if one is false.
"""

import argparse
import os
import tempfile
from fractions import Fraction

import numpy as np
import torch

import dsptpu_torch as dsp
from dsptpu_torch.native import StreamReader, native_available


def claim(what, ok):
    print(f"{what}: {bool(ok)}")
    if not ok:
        raise SystemExit(f"false claim: {what}")


def main(device="cuda"):
    """Stream a 4 s file through the 48 kHz -> 44.1 kHz resampler on
    `device`; returns the chunked and whole-file outputs as numpy."""
    fs = 48_000.0
    rng = np.random.default_rng(0)

    # a 4 s float32 PCM file
    n = int(4 * fs)
    t = np.arange(n) / fs
    x = (np.sin(2 * np.pi * 1000.0 * t)
         + 0.1 * rng.standard_normal(n)).astype(np.float32)
    claim("native reader available", native_available())

    # design once (host), stream forever: 48 kHz -> 44.1 kHz
    ratio = Fraction(147, 160)
    h = np.asarray(dsp.resample_filter(ratio)).astype(np.float32)
    sf = dsp.FIRFilter(h, ratio)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stream.f32")
        x.tofile(path)
        with StreamReader(path, chunk=65_536, device=device) as sr:
            y_stream = torch.cat([sf.filt(chunk) for chunk in sr])

    # whole-file reference: the same output (streaming state contract)
    y_whole = dsp.FIRFilter(h, ratio).filt(torch.as_tensor(x, device=device))
    err = float((y_stream - y_whole[: len(y_stream)]).abs().max())
    claim(f"chunked == whole: max err {err:.2e} over {len(y_stream)} "
          "samples", err < 2e-5)

    # spectral sanity: the 1 kHz tone survives resampling at 44.1 kHz
    F = np.abs(np.fft.rfft(y_stream[: 1 << 16].cpu().numpy()))
    peak = np.fft.rfftfreq(1 << 16, 1 / (fs * 147 / 160))[np.argmax(F)]
    claim(f"peak after 48k->44.1k resample: {peak:.1f} Hz (expect 1000)",
          abs(peak - 1000.0) < 5)
    print("OK")
    return {"y_stream": y_stream.cpu().numpy(),
            "y_whole": y_whole.cpu().numpy()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
