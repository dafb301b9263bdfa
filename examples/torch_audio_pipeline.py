"""End-to-end example: a DSP.jl user's workflow on dsptpu_torch, the
PyTorch / CUDA port (examples/audio_pipeline.py on torch tensors).

Mirrors the canonical DSP.jl snippets (docs/src/index.md and the
filters/periodograms doc pages); every step names the DSP.jl call it
replaces. Runs on the card unless asked for the CPU:

    PYTHONPATH=. python3 examples/torch_audio_pipeline.py [--device cpu]

Prints each claim with its check, and exits 1 if one is false.
"""

import argparse
from fractions import Fraction

import numpy as np
import torch

import dsptpu_torch as dsp


def claim(what, ok):
    print(f"{what}: {bool(ok)}")
    if not ok:
        raise SystemExit(f"false claim: {what}")


def main(device="cuda"):
    """Run the pipeline on `device`; returns its arrays as numpy."""
    fs = 48_000.0
    rng = np.random.default_rng(0)

    # a noisy two-tone test signal, 2 s at 48 kHz
    t = np.arange(int(2 * fs)) / fs
    x = (np.sin(2 * np.pi * 440.0 * t) + 0.5 * np.sin(2 * np.pi * 9000.0 * t)
         + 0.1 * rng.standard_normal(t.size)).astype(np.float32)
    xt = torch.as_tensor(x, device=device)

    # --- IIR design + zero-phase filtering -------------------------------
    # DSP.jl: f = digitalfilter(Lowpass(2000; fs), Butterworth(8));
    #         y = filtfilt(f, x)
    f = dsp.digitalfilter(dsp.Lowpass(2 * 2000.0 / fs), dsp.Butterworth(8))
    y = dsp.filtfilt(f, xt)
    claim(f"filtfilt: {tuple(y.shape)}, 9 kHz tone attenuated",
          float(y.std()) < float(xt.std()))

    # --- FIR design + streaming filtering --------------------------------
    # DSP.jl: h = digitalfilter(Lowpass(0.25), FIRWindow(hamming(127)));
    #         filt(h, x) / FIRFilter for streaming
    h = np.asarray(dsp.digitalfilter(dsp.Lowpass(0.25), dsp.FIRWindow.create(
        np.asarray(dsp.windows.hamming(127)))), np.float32)
    sf = dsp.FIRFilter(h)
    y_stream = torch.cat([sf.filt(xt[i:i + 16384])
                          for i in range(0, x.size, 16384)])
    y_once = dsp.filt(torch.as_tensor(h, device=device), xt)
    claim("streaming == one-shot", torch.allclose(y_stream, y_once,
                                                  atol=1e-4))

    # --- rational resampling 48 kHz -> 44.1 kHz --------------------------
    # DSP.jl: resample(x, 147//160)
    z = dsp.resample(y, Fraction(147, 160))
    claim(f"resample: {x.size} -> {z.shape[0]} samples",
          z.shape[0] == -(-x.size * 147 // 160))

    # --- spectral analysis ------------------------------------------------
    # DSP.jl: welch_pgram(x, 1024, 512; window=hanning, fs),
    #         spectrogram(x, 1024, 512; window=hanning, fs)
    win = np.asarray(dsp.windows.hanning(1024)).astype(np.float32)
    p = dsp.welch_pgram(y, 1024, 512, window=win, fs=fs)
    psd = dsp.power(p)
    peak = float(np.asarray(dsp.freq(p))[int(psd.argmax())])
    claim(f"welch peak at {peak:.0f} Hz (expect ~440, bins of "
          f"{fs / 1024:.1f} Hz)", abs(peak - 440.0) < fs / 1024)

    sg = dsp.spectrogram(y, 1024, 512, window=win, fs=fs)
    sgp = dsp.power(sg)
    claim(f"spectrogram: {tuple(sgp.shape)}, times "
          f"{np.asarray(dsp.time(sg))[:2]} ...",
          tuple(sgp.shape) == (513, (x.size - 1024) // 512 + 1))

    # --- LPC on speech-style frames ---------------------------------------
    # DSP.jl: lpc(frame, 16, LPCLevinson())
    frames = y[: (y.shape[0] // 400) * 400].reshape(-1, 400).T
    a, err = dsp.lpc(frames, 16, dsp.LPCLevinson())
    claim(f"lpc coefficients per frame: {tuple(a.shape)}",
          tuple(a.shape) == (16, frames.shape[1])
          and bool(torch.isfinite(a).all()))

    print("pipeline OK")
    return {k: v.cpu().numpy() for k, v in dict(
        y=y, y_stream=y_stream, z=z, psd=psd, sg=sgp, a=a).items()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
