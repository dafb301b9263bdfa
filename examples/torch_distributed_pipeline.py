"""Distributed example on dsptpu_torch, the PyTorch / CUDA port
(examples/distributed_pipeline.py on torch.distributed): the same DSP
pipeline sharded over a ('channel', 'time') DeviceMesh.

DSP.jl has no distributed layer (SURVEY.md section 2.10). The sharded
ops exchange FIR halos between neighbouring ranks, chain IIR states
across time shards and sum Welch's segments with an all_reduce; each
matches its single-device counterpart (tests/test_torch_parallel.py).

    PYTHONPATH=. python3 examples/torch_distributed_pipeline.py \
        --device cpu --hosts 4
    PYTHONPATH=. python3 examples/torch_distributed_pipeline.py

With --device cpu the pipeline runs on `hosts` gloo ranks on the CPU
(parallel.simulate_hosts), a mesh of 2 channel groups x hosts/2 time
shards for an even count: the counterpart of the JAX example's 8
virtual CPU devices. On the card (the default) it runs on a single-rank
NCCL mesh of (1, 1): the same code path, with nothing crossing ranks.
On several GPUs, start one process per GPU (torchrun) and build the
mesh with parallel.global_mesh.

Prints each claim with its check, and exits 1 if one is false.
"""

import argparse

import numpy as np
import torch
import torch.distributed as dist

import dsptpu_torch as dsp
from dsptpu_torch.parallel import (make_mesh, shard_filtfilt, shard_fir,
                                   shard_sosfilt, shard_spectrogram,
                                   shard_welch, simulate_hosts)

FS = 48_000.0


def claim(what, ok):
    print(f"{what}: {bool(ok)}")
    if not ok:
        raise SystemExit(f"false claim: {what}")


def signal():
    """8 channels of a 440 Hz tone in noise, 262,144 samples at 48 kHz."""
    rng = np.random.default_rng(0)
    nch, n = 8, 262_144
    t = np.arange(n) / FS
    return (np.sin(2 * np.pi * 440.0 * t)[:, None]
            + 0.1 * rng.standard_normal((n, nch))).astype(np.float32)


def design():
    """(FIR bandpass taps, the Butterworth(6) lowpass as sections, its
    section array and gain, the Hanning window)."""
    b = np.asarray(dsp.digitalfilter(
        dsp.Bandpass(2 * 300.0 / FS, 2 * 3000.0 / FS),
        dsp.FIRWindow(dsp.windows.hamming(255)))).astype(np.float32)
    fsos = dsp.as_sos(dsp.digitalfilter(dsp.Lowpass(2 * 4000.0 / FS),
                                        dsp.Butterworth(6)))
    sos, g = dsp.sos_arrays(fsos)
    win = np.asarray(dsp.windows.hanning(1024)).astype(np.float32)
    return b, fsos, sos, g, win


def pipeline(mesh=None):
    """The sharded pipeline on this rank of `mesh`; every rank returns
    the same numpy results (each DTensor gathered whole)."""
    b, _, sos, g, win = design()
    x = signal()
    kw = dict(time_axis="time", channel_axis="channel")
    # --- FIR bandpass, time+channel sharded ------------------------------
    y = shard_fir(b, x, mesh, **kw)
    # --- IIR (SOS cascade) with cross-shard state chaining ----------------
    y2 = shard_sosfilt(sos, g, y, mesh, **kw)
    # --- zero-phase filtering, both passes shard-local --------------------
    y3 = shard_filtfilt(sos, g, y2, mesh, **kw)
    # --- Welch PSD: segment-parallel with an all_reduce -------------------
    psd, freqs = shard_welch(y3, 1024, 512, win, mesh, fs=FS, **kw)
    # --- sharded spectrogram (segments stay sharded over time) ------------
    pw, _, _ = shard_spectrogram(x, 1024, 512, win, mesh,
                                 channel_axis="channel")

    def whole(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).cpu() \
            .numpy()
    return {"mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
            "shapes": [tuple(v.shape) for v in (y, y2, y3)],
            "psd": whole(psd), "freqs": whole(torch.as_tensor(freqs)),
            "pw": whole(pw)}


def main(device="cuda", hosts=4):
    """The pipeline on `hosts` gloo ranks (device "cpu") or a single-rank
    NCCL mesh on the card, against the single-device computation on
    `device`; returns the sharded and single-device arrays as numpy."""
    if device == "cpu":
        ch = 2 if hosts % 2 == 0 else 1
        with simulate_hosts(hosts) as pool:
            out = pool.run(pipeline, mesh=(ch, hosts // ch))[0]
    else:
        started = not dist.is_initialized()
        mesh = make_mesh((1, 1), ("channel", "time"), device_type="cuda")
        try:
            out = pipeline(mesh)
        finally:
            if started:
                dist.destroy_process_group()
    print(f"mesh: {out['mesh']}")
    for name, shape in zip(("shard_fir", "shard_sosfilt", "shard_filtfilt"),
                           out["shapes"]):
        claim(f"{name}: {shape}", shape == (262_144, 8))
    psd, freqs = out["psd"], out["freqs"]
    peak = freqs[int(np.argmax(psd.mean(axis=-1)))]
    claim(f"shard_welch: {psd.shape}, peak at {peak:.0f} Hz (expect 440, "
          f"bins of {FS / 1024:.1f} Hz)", abs(peak - 440.0) < FS / 1024)
    print(f"shard_spectrogram: {out['pw'].shape}")

    # --- correctness vs single-device -------------------------------------
    b, fsos, _, _, win = design()
    x = torch.as_tensor(signal(), device=device)
    y_ref = dsp.filt(torch.as_tensor(b, device=device), x)
    y_ref = dsp.sosfilt(fsos, y_ref)
    y_ref = dsp.filtfilt(fsos, y_ref)
    ref = dsp.power(dsp.welch_pgram(y_ref, 1024, 512, window=win,
                                    fs=FS)).cpu().numpy()
    err = float(np.max(np.abs(psd - ref)))
    claim(f"max |sharded - single-device| = {err:.2e} (within 1e-4 of the "
          "largest bin)", err < 1e-4 * float(np.max(ref)))
    print("OK: the sharded pipeline matches the single-device computation")
    return {"psd": psd, "pw": out["pw"], "ref": ref}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--hosts", type=int, default=4,
                    help="gloo ranks with --device cpu (default 4)")
    a = ap.parse_args()
    main(a.device, a.hosts)
