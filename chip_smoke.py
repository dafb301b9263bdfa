#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (dsptpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from dsptpu_torch/csrc, holds each one
against its plain PyTorch version on the card (at one ragged small shape
per case and at the shapes of the main path), then drives the main path
once through dsptpu_torch.entry(device="cuda") at full width (x of
1,000,000 x 64 float32: 127-tap FIR -> 8th-order Butterworth SOS cascade
-> Welch + STFT power, nfft 1024, hop 512), checks that every kernel of
the path was launched, and compares its output with a float64 run of the
same chain on the card. The STFT kernel is also held to its plain
version bin by bin, on white input at the main path's shapes. Kernel
times are CUDA-event medians; one more
call of the main path runs under torch.profiler, for the device time by
kernel and the device's busy share.

Prints, in order: the card (nvidia-smi name and power limit), the build,
one line per comparison, the main path, a JSON line {"kernels": [...]}
and, last, {"ok": true, "device": {...}}. Any failure raises, so the
script exits non-zero and prints no result; it also fails without CUDA.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 on CUDA cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

TOL = {"fir": 3e-5, "biir": 1e-4, "stft": 3e-5}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps=10, warmup=2):
    """Median CUDA-event time of fn() over reps runs after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def bound(nbytes, flops):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def report(row):
    """One line per kernel: its time, its plain version's, the library
    call's and the bound, at the main path's shapes."""
    lib = row["library_ms"]
    bms, by = row["bound"]
    log(f"  {row['name']}: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, library "
        f"{'none' if lib is None else f'{lib:.4f} ms'}, bound {bms:.4f} ms "
        f"({by})")


def per_bin(a):
    """max |a| over everything but axis 0 (the bins): one value per bin."""
    return a.abs().reshape(a.shape[0], -1).amax(1)


def compare(name, got, want, what, by_bin=False, tol=None):
    """max |got - want| and that over max |want|; raise past tol
    (TOL[name] by default). by_bin: the error is relative per bin (axis
    0), max |d| over frames and channels over the same max of |want|,
    and the worst bin is held to the tolerance."""
    import torch
    torch.cuda.synchronize()
    tol = TOL[name] if tol is None else tol
    got = got.double()
    want = want.double()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name} {what}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite values")
    d = got - want
    err = d.abs().max().item()
    if by_bin:
        rel = (per_bin(d) / per_bin(want).clamp_min(1e-30)).max().item()
        how = "max over bins of max|d|/max|ref|"
    else:
        rel = err / max(want.abs().max().item(), 1e-30)
        how = "max|d|/max|ref|"
    log(f"  {name} {what}: max|d| {err:.3e}  {how} {rel:.3e} "
        f"(tol {tol:.0e})")
    if not rel <= tol:
        raise AssertionError(f"{name} {what}: relative error {rel:.3e} "
                             f"> {tol:.0e}")
    return err


def small_cases(dev):
    """Every kernel against its plain version at small ragged shapes."""
    import torch
    from dsptpu_torch.filters.filt import _blockss, _stack_cascade
    from dsptpu_torch.filters.filt import _single_ss
    from dsptpu_torch.kernels import biir, fir, stft
    from dsptpu_torch import Butterworth, Lowpass, as_sos, digitalfilter
    rng = np.random.default_rng(1)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    for n, C, nb in [(40037, 1, 2), (40037, 3, 127), (33001, 64, 300),
                     (50000, 33, 512), (40000, 40, 1536)]:
        x = t(rng.standard_normal((n, C)))
        b = t(rng.standard_normal(nb))
        compare("fir", fir.fir(x, b), fir.fir_reference(x, b),
                f"n={n} C={C} nb={nb}")
    x1 = t(rng.standard_normal(40037))
    b1 = t(rng.standard_normal(127))
    compare("fir", fir.fir(x1, b1), fir.fir_reference(x1, b1), "1-D n=40037")

    # a well-damped 10-section cascade (p = 20, tables padded to 32)
    r, th = rng.uniform(0.3, 0.8, 10), rng.uniform(0.1, 3.0, 10)
    sos10 = np.column_stack([np.ones(10), rng.uniform(-1, 1, (10, 2)),
                             -2 * r * np.cos(th), r * r])
    for sos, g in [(as_sos(digitalfilter(Lowpass(cut), Butterworth(order))),
                    None) for order, cut in [(8, 0.2), (12, 0.3)]] + [
                   (sos10, 1.0)]:
        if g is None:
            sos, g = sos.sos_array(), sos.g
        ss = _blockss(*_stack_cascade(sos, g))
        for n, C in [(5003, 3), (4096, 64), (70001, 2)]:
            x = t(rng.standard_normal((n, C)))
            z0 = t(rng.standard_normal((ss.p, C)))
            compare("biir", biir.blockss_filt(ss, x, z0),
                    biir.blockss_reference(ss, x, z0),
                    f"p={ss.p} n={n} C={C}")
            y, zf = biir.blockss_filt(ss, x, z0, need_state=True)
            yr, zr = biir.blockss_reference(ss, x, z0, need_state=True)
            compare("biir", y, yr, f"need_state y p={ss.p} n={n} C={C}")
            compare("biir", zf, zr, f"need_state z p={ss.p} n={n} C={C}")
    ss = _blockss(*_single_ss([0.2, 0.1, 0.05, 0.02],
                              [1.0, -0.5, 0.25, -0.1]))
    x = t(rng.standard_normal((1000, 5)))
    z0 = t(rng.standard_normal((ss.p, 5)))
    compare("biir", biir.blockss_filt(ss, x, z0),
            biir.blockss_reference(ss, x, z0), "p=3 n=1000 C=5")

    for n, C, nfft, hop in [(5000, 3, 256, 128), (7001, 3, 384, 128),
                            (9000, 2, 640, 256), (20000, 5, 2048, 1024),
                            (3000, 1, 1024, 512), (30011, 9, 1920, 640)]:
        x = t(rng.standard_normal((n, C)))
        k = (n - nfft) // hop + 1
        win = t(rng.uniform(0.1, 1.0, nfft))
        for acc, nbins in [(True, nfft // 2 + 1), (False, nfft // 2 + 1),
                           (False, nfft)]:
            sc = t(rng.uniform(0.5, 2.0, nbins))
            compare("stft", stft.stft_pow(x, win, nfft, hop, k, acc, sc),
                    stft.stft_pow_reference(x, win, nfft, hop, k, acc, sc),
                    f"{'sum' if acc else 'frames'} n={n} C={C} "
                    f"nfft={nfft} hop={hop} nbins={nbins}", by_bin=True)


def profile_main_path(forward, x, call_ms):
    """Device time by kernel over one call of the main path
    (torch.profiler), and its share of call_ms, the call's unprofiled
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    forward(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        forward(x)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    log(avg.table(sort_by="self_cuda_time_total", row_limit=14,
                  max_name_column_width=40))
    busy_ms = sum(e.self_device_time_total for e in avg) / 1e3
    log(f"profile: device busy {busy_ms:.3f} ms of a {call_ms:.3f} ms call "
        f"(idle share {max(0.0, 1 - busy_ms / call_ms):.3f})")


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import dsptpu_torch
    from dsptpu_torch import kernels
    from dsptpu_torch.kernels import _build, biir, fir, stft
    from dsptpu_torch.filters.filt import _blockss, _stack_cascade
    from dsptpu_torch.ops.periodograms import _psd_weights
    from dsptpu_torch.pipeline import chain_params
    from dsptpu_torch.utils.device import check_full_f32, no_tf32

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    log("card (nvidia-smi name, power.limit):")
    log(smi.splitlines()[0])
    log(f"torch.cuda.get_device_name: {kind}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    check_full_f32()
    dev = torch.device("cuda")

    # 2. the build
    t0 = time.time()
    paths = _build.build_all()
    log(f"build: {time.time() - t0:.1f} s, "
        f"{os.path.dirname(paths['fir'])}")
    for name in _build.SOURCES:
        logf = os.path.join(os.path.dirname(paths[name]), f"{name}.log")
        if os.path.exists(logf):
            for line in open(logf):
                if "registers" in line or "spill" in line.lower():
                    log(f"  {name}: {line.strip()}")
    log("kernels to build and check: " + ", ".join(_build.SOURCES))

    # 3. each kernel against its plain version, small ragged shapes
    log("small shapes:")
    small_cases(dev)

    # 4. each kernel at the shapes of the main path
    nfft, hop = 1024, 512
    forward, (x,) = dsptpu_torch.entry(device="cuda")
    n, C = x.shape
    taps_np, sos_np, win_np = chain_params()
    taps = torch.as_tensor(taps_np, device=dev)
    win = torch.as_tensor(win_np, device=dev)
    nb = taps.shape[0]
    log(f"main-path shapes: x ({n}, {C}) float32")
    rows = []

    y1 = fir.fir(x, taps)
    err = compare("fir", y1, fir.fir_reference(x, taps), "main path")
    xc = torch.nn.functional.pad(x.T[:, None, :], (nb - 1, 0)).contiguous()
    rhs = taps.flip(0)[None, None, :]

    def conv():
        with no_tf32():
            return torch.nn.functional.conv1d(xc, rhs)
    rows.append(dict(
        name="fir", route="cuda", source="dsptpu_torch/csrc/fir.cu",
        replaces="dsptpu/kernels/fir.py:140", max_abs_err=err,
        ms=time_ms(lambda: fir.fir(x, taps)),
        plain_ms=time_ms(lambda: fir.fir_reference(x, taps)),
        library_ms=time_ms(conv),
        bound=bound(2 * n * C * 4 + nb * 4, 2 * nb * n * C)))
    report(rows[-1])
    del xc

    ss = _blockss(*_stack_cascade(sos_np.astype(np.float64), 1.0))
    z0 = torch.zeros((ss.p, C), device=dev)
    y2 = biir.blockss_filt(ss, y1, z0)
    err = compare("biir", y2, biir.blockss_reference(ss, y1, z0),
                  "main path")
    # the cascade's own work: 5 multiply-adds per section per sample
    flops = 10 * sos_np.shape[0] * n * C
    rows.append(dict(
        name="biir", route="cuda", source="dsptpu_torch/csrc/biir.cu",
        replaces="dsptpu/kernels/biir.py:242", max_abs_err=err,
        ms=time_ms(lambda: biir.blockss_filt(ss, y1, z0)),
        plain_ms=time_ms(lambda: biir.blockss_reference(ss, y1, z0)),
        library_ms=None, bound=bound(2 * n * C * 4, flops)))
    report(rows[-1])

    k = (n - nfft) // hop + 1
    nbins = nfft // 2 + 1
    # what the function needs per frame and channel: a real FFT
    # (2.5 nfft log2 nfft), the window, |X|^2 and the sum or the scale
    flops_frame = 2.5 * nfft * np.log2(nfft) + nfft + 4 * nbins
    parts = {}
    errs = []
    for mode, acc, r in [("welch", True, k * float(np.sum(
            win_np.astype(np.float64) ** 2))), ("frames", False, float(
            np.sum(win_np.astype(np.float64) ** 2)))]:
        sc = torch.as_tensor(_psd_weights(nfft, r, True), device=dev)
        # y2's stopband bins lie 50-200 dB under its passband, below the
        # float32 rounding of any DFT of the whole frame, so on y2 only
        # the error relative to the largest bin means something. The
        # white x puts every bin at one level: there each bin is held to
        # the tolerance, at the main path's shapes.
        got = stft.stft_pow(y2, win, nfft, hop, k, acc, sc)
        errs.append(compare("stft", got, stft.stft_pow_reference(
            y2, win, nfft, hop, k, acc, sc), f"main path ({mode})"))
        del got
        compare("stft", stft.stft_pow(x, win, nfft, hop, k, acc, sc),
                stft.stft_pow_reference(x, win, nfft, hop, k, acc, sc),
                f"main-path shapes, white x ({mode})", by_bin=True)
        fr = y2.T.unfold(1, nfft, hop)

        def lib_call(acc=acc):
            pw = torch.fft.rfft(fr * win, dim=-1).abs().square()
            return pw.sum(1) if acc else pw
        out_bytes = nbins * C * 4 * (1 if acc else k)
        parts[mode] = dict(
            ms=time_ms(lambda: stft.stft_pow(y2, win, nfft, hop, k, acc,
                                             sc)),
            plain_ms=time_ms(lambda: stft.stft_pow_reference(
                y2, win, nfft, hop, k, acc, sc)),
            library_ms=time_ms(lib_call),
            nbytes=n * C * 4 + nfft * 4 + out_bytes,
            flops=k * C * flops_frame)
        bms, by = bound(parts[mode]["nbytes"], parts[mode]["flops"])
        log(f"  stft {mode}: kernel {parts[mode]['ms']:.4f} ms, plain "
            f"{parts[mode]['plain_ms']:.4f} ms, rfft "
            f"{parts[mode]['library_ms']:.4f} ms, bound {bms:.4f} ms "
            f"({by})")
        del fr
    tot = {key: sum(v[key] for v in parts.values())
           for key in ("ms", "plain_ms", "library_ms", "nbytes", "flops")}
    rows.append(dict(
        name="stft", route="cuda", source="dsptpu_torch/csrc/stft.cu",
        replaces="dsptpu/kernels/stft.py:295", max_abs_err=max(errs),
        ms=tot["ms"], plain_ms=tot["plain_ms"],
        library_ms=tot["library_ms"], bound=bound(tot["nbytes"],
                                                  tot["flops"])))
    report(rows[-1])
    del y1, y2

    # 5. the main path, full width, through the entry point
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    psd, spow = forward(x)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launch_counts()
    log(f"main path: launches {counts}, first call {first_ms:.1f} ms")
    if counts["fir"] < 1 or counts["biir"] < 1 or counts["stft"] < 2:
        raise AssertionError(f"main path missed a kernel: {counts}")
    if psd.shape != (nbins, C) or spow.shape != (nbins, k, C):
        raise AssertionError(f"shapes {psd.shape} {spow.shape}")
    if not (torch.isfinite(psd).all() and torch.isfinite(spow).all()):
        raise AssertionError("non-finite output")
    e2e = time_ms(lambda: forward(x), reps=5, warmup=1)
    log(f"main path end to end: {e2e:.3f} ms (median of 5)")
    profile_main_path(forward, x, e2e)
    # Against the same chain in float64: relative to the largest bin, and
    # per bin over the bins within 40 dB of it. Further down the stopband
    # the float32 signal's own rounding (about 1e-7 of the passband's
    # amplitude) outweighs the signal; the kernels are held there by the
    # white-x comparisons above.
    psd64, spow64 = forward(x.double())
    for name, got, want in [("psd", psd, psd64), ("stft", spow, spow64)]:
        top = per_bin(want) >= 1e-4 * want.abs().max()
        compare(name, got, want, "vs float64 chain", tol=1e-4)
        compare(name, got[top], want[top],
                f"vs float64 chain, {int(top.sum())} bins within 40 dB",
                by_bin=True, tol=1e-4)

    out = []
    for r in rows:
        bms, by = r.pop("bound")
        r.update(launches=counts[r["name"]], bound_ms=bms, bound_by=by)
        out.append({key: r[key] for key in (
            "name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")})
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
