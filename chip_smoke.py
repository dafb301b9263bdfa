#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (dsptpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from dsptpu_torch/csrc, holds each one
against its plain PyTorch version on the card (at small ragged shapes
and at the shapes of the path that runs it), then drives five paths at
full width through their entry points, each with the launch counts set
to 0 just before it and read just after:

  * the main path, dsptpu_torch.entry(device="cuda"): x of 1,000,000 x 64
    float32, 127-tap FIR (K1) -> 8th-order Butterworth SOS cascade (K2)
    -> Welch + STFT power (K3), nfft 1024, hop 512;
  * path A, fftfilt_entry(): fftfilt of x (10,000,000 x 16) float32 with
    a 4096-tap FIR by overlap-save blocks of 16384 points (K4);
  * path B, filtfilt_lpc_entry(): zero-phase Butterworth(8) filtfilt of
    x (1,000,000 x 64) float32 (K2 forward, then reverse with n_eff) and
    order-16 Levinson LPC of 2500 frames of 400 samples (K5); then the
    single-channel filtfilt (1,000,000 x 1) of dsptpu's BASELINE;
  * path C, resample_entry(): streaming polyphase resampling of a
    10,000,000-sample float32 stream at 147/160 and 3/2 (K6) and of its
    first 2,500,000 samples at the arbitrary rate 0.9997 (K7), one
    FIRFilter per rate, reset and filt on each call; then resample()
    at each rate and the stream in chunks;
  * path D, multitaper_entry(): the multitaper spectrogram of x
    (1,000,000 x 64) float32 with 7 DPSS tapers (NW 4), nfft 1024, hop
    512, through K3's K-window stack in one launch, and the 64 x 64
    multitaper coherence of its first 16384 samples;
  * the K8 phase: the three transpose kernels (K8a-c), which no route
    calls, each called once through its wrapper at full size and held
    bit for bit to its plain version;
  * the sharded phase: dsptpu_torch.parallel on a single-rank NCCL
    process group (init_distributed) at world size 1, each sharded call
    against the unsharded port call on the card: sharded_entry() (the
    main path's chain up to Welch, K2 with need_state), shard_filtfilt
    of the main stream, shard_fftfilt of path A's stream (K4),
    shard_resample at 3/2 through compact_shards and shard_mt_coherence
    at path D's shape; each K2 and K4 launch of those calls against its
    plain version on the input the call gave it (K4 on the
    halo-extended block, K2 on shard_filtfilt's padded and flipped
    blocks); K2 with need_state against its plain version at
    1,000,000 x 64 on the stream; the main stream read from a file through
    native.StreamReader to the card; utils.profiling on K1;
  * the bench phase: dsptpu_torch.bench, dsptpu's five BASELINE configs
    at full scale (K1, K4, K3, K6 and K7, K2 and K5), each call held to
    bench.py's float64 witnesses and timed (events, device time, idle
    share, bound, launches); its JSON line is logged;
  * the examples phase: examples/torch_audio_pipeline.py,
    torch_distributed_pipeline.py (a single-rank NCCL mesh) and
    torch_streaming_io.py on the card, each checking its own claims.

Each path's output is compared with a float64 run of the same call on
the card. The STFT kernel is also held to its plain version bin by bin,
on white input at the main path's shapes. Kernel times are CUDA-event
medians; two more calls of each path run under torch.profiler, for the
device time by kernel and the device's busy share.

Prints, in order: the card (nvidia-smi name and power limit), the build,
one line per comparison, the main path, a JSON line {"kernels": [...]}
and, last, {"ok": true, "device": {...}}. Any failure raises, so the
script exits non-zero and prints no result; it also fails without CUDA.
"""

import inspect
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

TOL = {"fir": 3e-5, "biir": 1e-4, "stft": 3e-5, "osconv": 3e-5,
       "biir_reverse": 1e-4, "levinson": 1e-4, "pfb2": 3e-5, "arbd": 3e-5,
       "stft_mt": 3e-5, "coherence": 1e-4, "lags": 1e-6}

# K8c's tile edges (bins kept, channels, frames a block), also in
# tests/test_torch_cuda.py
PERM_L2, PERM_C, PERM_TB = (1, 4, 65, 128), (1, 5, 64, 130), (7, 257)

# K5's order-class edges, also in tests/test_torch_cuda.py
K5_ORDERS = (2, 8, 9, 16, 17, 32, 33, 64)

# K3's edge cases (K, nfft, hop, C, nbins), also in tests/test_torch_cuda.py
STFT_EDGES = [(15, 2048, 1024, 9, 1025), (64, 2048, 1024, 3, 2048),
              (1, 1024, 512, 1, 513), (7, 1024, 512, 64, 513),
              (1, 1024, 1024, 5, 513), (3, 640, 1280, 4, 640),
              (1, 1024, 512, 64, 1), (2, 384, 128, 3, 7)]


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps=10, warmup=2, inner=1):
    """Median CUDA-event time of fn() over reps runs after warm-up. With
    inner > 1 each run is inner calls back to back, and its time is
    divided by inner: for a kernel shorter than its wrapper's host work,
    the card then waits less between launches."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / inner)
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


def exact(name, got, want, what):
    """Raise unless got equals want bit for bit (same shape)."""
    import torch
    torch.cuda.synchronize()
    same = got.shape == want.shape and torch.equal(got, want)
    log(f"  {name} {what}: {tuple(got.shape)} equal bit for bit: {same}")
    if not same:
        raise AssertionError(f"{name} {what}: differs from its reference")


def small_cases(dev):
    """Every kernel against its plain version at small ragged shapes."""
    import torch
    from dsptpu_torch.filters.filt import (_blockss, _cascade_ss,
                                           _single_ss, _stack_cascade)
    from dsptpu_torch.kernels import biir, fir, levinson, osconv, stft
    from dsptpu_torch import Butterworth, Lowpass, as_sos, digitalfilter
    rng = np.random.default_rng(1)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    # K1: every C template (C = 1, 2, ragged last groups at 31, 33, 100)
    # at nb from 2 to 1536, n just above 4 nb, n a tile +- 1, and long
    # streams whose blocks walk runs of many tiles (as in
    # tests/test_torch_cuda.py)
    fir_cases = [(40037, 1, 2), (40037, 3, 127), (33001, 64, 300),
                 (50000, 33, 512), (40000, 40, 1536), (300_007, 33, 129),
                 (2_000_003, 1, 17), (200_003, 100, 1536), (500_001, 2, 512)]
    for C in (1, 2, 31, 32, 33, 64, 100):
        fir_cases += [(4 * nb + 1 + C, C, nb)
                      for nb in (2, 16, 17, 127, 128, 129, 512, 1536)]
        tt = fir._plan(1, C, 127)["tt"]
        fir_cases += [(2 * tt - 1, C, 127), (2 * tt + 1, C, 127)]
    for n, C, nb in fir_cases:
        x = t(rng.standard_normal((n, C)))
        b = t(rng.standard_normal(nb))
        compare("fir", fir.fir(x, b), fir.fir_reference(x, b),
                f"n={n} C={C} nb={nb}")
    x1 = t(rng.standard_normal(40037))
    b1 = t(rng.standard_normal(127))
    compare("fir", fir.fir(x1, b1), fir.fir_reference(x1, b1), "1-D n=40037")

    # a well-damped 10-section cascade (p = 20, tables padded to 32); each
    # cascade with its sections (the SOS output stage) and without them
    # (the general F stage), 1 to 16 sections
    r, th = rng.uniform(0.3, 0.8, 10), rng.uniform(0.1, 3.0, 10)
    sos10 = np.column_stack([np.ones(10), rng.uniform(-1, 1, (10, 2)),
                             -2 * r * np.cos(th), r * r])
    cascades = [(sos10, 0.8)] + [
        (f.sos_array(), 1.3 * f.g) for f in (
            as_sos(digitalfilter(Lowpass(cut), Butterworth(order)))
            for order, cut in [(2, 0.3), (8, 0.2), (12, 0.3), (32, 0.35)])]
    for ss in [_blockss(*_stack_cascade(sos, g)) for sos, g in cascades] + [
            _cascade_ss(sos, g) for sos, g in cascades]:
        stage = "F" if ss.sections is None else "SOS"
        # n at 64 rows of 128 (K2's chunk) - 1, + 0, + 1, and ragged
        for n, C in [(5003, 3), (4096, 64), (70001, 2), (8191, 33),
                     (8192, 1), (8193, 64), (12289, 5)]:
            x = t(rng.standard_normal((n, C)))
            z0 = t(rng.standard_normal((ss.p, C)))
            compare("biir", biir.blockss_filt(ss, x, z0),
                    biir.blockss_reference(ss, x, z0),
                    f"{stage} p={ss.p} n={n} C={C}")
            y, zf = biir.blockss_filt(ss, x, z0, need_state=True)
            yr, zr = biir.blockss_reference(ss, x, z0, need_state=True)
            compare("biir", y, yr,
                    f"{stage} need_state y p={ss.p} n={n} C={C}")
            compare("biir", zf, zr,
                    f"{stage} need_state z p={ss.p} n={n} C={C}")
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

    # K3 at every N1 (one kernel template each) with a (K, nfft) window
    # stack (multitaper; K = 1 a single window), both modes; odd N1 take
    # all nfft bins
    for K in (1, 2, 7):
        for N1 in range(2, 17):
            nfft, hop = 128 * N1, 128 * max(1, N1 // 2)
            n, C = 7 * hop + nfft + 37, 9
            k = (n - nfft) // hop + 1
            x = t(rng.standard_normal((n, C)))
            win = t(rng.uniform(0.1, 1.0, (K, nfft)))
            nbins = nfft if N1 % 2 else nfft // 2 + 1
            sc = t(rng.uniform(0.5, 2.0, nbins))
            for acc in (True, False):
                compare("stft", stft.stft_pow(x, win, nfft, hop, k, acc, sc),
                        stft.stft_pow_reference(x, win, nfft, hop, k, acc,
                                                sc),
                        f"stack K={K} {'sum' if acc else 'frames'} n={n} "
                        f"C={C} nfft={nfft} nbins={nbins}", by_bin=True)
    # K3's edges: windows past the shared-memory budget (K 15 and 64 at
    # nfft 2048), C 1 and 64, hop nfft and 2 nfft, nbins 1 and 7
    for K, nfft, hop, C, nbins in STFT_EDGES:
        n = 6 * hop + nfft + 37
        k = (n - nfft) // hop + 1
        x = t(rng.standard_normal((n, C)))
        win = t(rng.uniform(0.1, 1.0, (K, nfft)))
        sc = t(rng.uniform(0.5, 2.0, nbins))
        for acc in (True, False):
            compare("stft", stft.stft_pow(x, win, nfft, hop, k, acc, sc),
                    stft.stft_pow_reference(x, win, nfft, hop, k, acc, sc),
                    f"edge K={K} {'sum' if acc else 'frames'} n={n} C={C} "
                    f"nfft={nfft} hop={hop} nbins={nbins}", by_bin=True)
    # the Welch sum repeats bit for bit (fixed partition, no atomics)
    x = t(rng.standard_normal((200_000, 64)))
    win = t(np.hanning(1024))
    sc = t(np.ones(513))
    k = (200_000 - 1024) // 512 + 1
    exact("stft", stft.stft_pow(x, win, 1024, 512, k, True, sc),
          stft.stft_pow(x, win, 1024, 512, k, True, sc), "Welch twice")

    # K8a-c, exact; K8c's tile edges (l2 1 .. 128 bins, C 1 .. 130
    # channels, runs of frames cut at TB 7 and 257), and views with a
    # storage offset of 1 float (rows not 16-byte aligned: the kernels'
    # one-float path) and of 4 floats
    from dsptpu_torch.kernels import transpose as tp
    for shape in [(1024, 512), (1000, 300), (513, 2048), (3, 70001),
                  (4097, 33)]:
        x = t(rng.standard_normal(shape))
        exact("transpose2d", tp.transpose2d(x), tp.transpose2d_reference(x),
              f"{shape}")
    for M, C, TR, pad_to in [(10_000, 8, 2048, 12_000),
                             (70_001, 64, 8192, None), (33, 3, 128, 300)]:
        x = t(rng.standard_normal((M, C)))
        exact("transpose_tall", tp.transpose_tall(x, TR, pad_to),
              tp.transpose_tall_reference(x, TR, pad_to),
              f"M={M} C={C} TR={TR} pad_to={pad_to}")
    perm_cases = [(3, 2, 8, 16, 65), (1, 1, 4, 8, 33), (64, 2, 8, 32, 65),
                  (40, 1, 16, 8, 128)]
    perm_cases += [(C, 1, 2, TB, l2) for l2 in PERM_L2 for C in PERM_C
                   for TB in PERM_TB]
    for C, nb, N1, TB, l2 in perm_cases:
        x = t(rng.standard_normal((C, nb, N1, TB, 128)))
        exact("spectro_permute", tp.spectro_permute(x, l2),
              tp.spectro_permute_reference(x, l2),
              f"C={C} nb={nb} N1={N1} TB={TB} l2={l2}")

    def view(off, *shape):
        n = int(np.prod(shape))
        return t(rng.standard_normal(n + off))[off:].view(*shape)
    for off in (1, 4):
        x = view(off, 1025, 300)
        exact("transpose2d", tp.transpose2d(x), tp.transpose2d_reference(x),
              f"(1025, 300) at storage offset {off}")
        x = view(off, 10_001, 8)
        exact("transpose_tall", tp.transpose_tall(x, 2048),
              tp.transpose_tall_reference(x, 2048),
              f"(10001, 8) TR=2048 at storage offset {off}")
        for C, l2 in [(64, 65), (5, 128)]:
            x = view(off, C, 1, 3, 9, 128)
            exact("spectro_permute", tp.spectro_permute(x, l2),
                  tp.spectro_permute_reference(x, l2),
                  f"C={C} nb=1 N1=3 TB=9 l2={l2} at storage offset {off}")

    # K4: one nfft per M template (256 ... 16384), with a short filter
    # and, for some, the longest its gate takes (advance L >= max(128,
    # 16 N1)); three sizes with an odd factor run the radix-m stage (384:
    # the M = 128 template)
    for nfft, nvs in [(256, (100,)), (512, (300,)), (1024, (127, 897)),
                      (2048, (1025,)), (4096, (1025, 3585)),
                      (8192, (300, 7169)), (16384, (4096, 14337)),
                      (1920, (500,)), (384, (200,)), (640, (300,))]:
        for nv in nvs:
            for n, C in [(nfft * 3 + 77, 1), (nfft * 5 + 13, 3),
                         (nfft * 2 + 101, 16), (nfft * 4 + 1, 17)]:
                x = t(rng.standard_normal((n, C)))
                v = t(rng.standard_normal(nv))
                for out_len in (n + nv - 1, n):
                    compare("osconv", osconv.osconv(x, v, nfft, out_len),
                            osconv.osconv_reference(x, v, nfft, out_len),
                            f"nfft={nfft} nv={nv} n={n} C={C} "
                            f"out_len={out_len}")

    # K2 reverse, whole signal and n_eff, p = 3, 8, 20
    ss3 = _blockss(*_single_ss([0.2, 0.1, 0.05, 0.02],
                               [1.0, -0.5, 0.25, -0.1]))
    sos8 = as_sos(digitalfilter(Lowpass(0.2), Butterworth(8)))
    ss8 = _blockss(*_stack_cascade(sos8.sos_array(), sos8.g))
    ss20 = _blockss(*_stack_cascade(sos10, 1.0))
    for ss in (ss3, ss8, ss20, _cascade_ss(sos8.sos_array(), 1.3 * sos8.g),
               _cascade_ss(sos10, 0.8), _cascade_ss(*cascades[1]),
               _cascade_ss(*cascades[-1])):
        for n, C in [(5003, 1), (4097, 3), (70001, 64)]:
            x = t(rng.standard_normal((n, C)))
            z0 = t(rng.standard_normal((ss.p, C)))
            for m in (None, (n // 128) * 128):
                compare("biir_reverse",
                        biir.blockss_filt(ss, x, z0, reverse=True, n_eff=m),
                        biir.blockss_reference(ss, x, z0, reverse=True,
                                               n_eff=m),
                        f"{'F' if ss.sections is None else 'SOS'} "
                        f"p={ss.p} n={n} C={C} n_eff={m}")

    # K5 at each order class's edges (classes 8, 16, 32, 64)
    for p in K5_ORDERS:
        for C in (128, 130, 300, 2500):
            x = t(rng.standard_normal((400, C)))
            R = torch.stack([(x[: 400 - lag] * x[lag:]).sum(0) / 400
                             for lag in range(p + 1)])
            for name, g, w in zip(("a", "err", "refl"),
                                  levinson.levinson(R, p),
                                  levinson.levinson_reference(R, p)):
                compare("levinson", g, w, f"{name} p={p} C={C}")

    # K6 and K7, fresh and mid-stream
    from dsptpu_torch.kernels import arbd, pfb2
    for rate in ("147/160", "3/2", "1/4", "5", "441/640"):
        for n in (1061, 40000, 61951):
            for history in (False, True):
                a = k6_args(dev, rate, n, history, rng)
                y, h = pfb2.pfb2(*a[:-1], hist_len=a[-1])
                yr, hr = pfb2.pfb2_reference(*a[:-1], hist_len=a[-1])
                compare("pfb2", y, yr, f"{rate} n={n} "
                        f"{'history' if history else 'fresh'}")
                if not torch.equal(h, hr):
                    raise AssertionError(f"pfb2 {rate} n={n}: new history")
    # every tap template (8, 16, ..., 64), banks of more than 64 taps (in
    # chunks) and L larger than a block's lanes (columns in passes), with
    # random banks, fresh and mid-stream
    for taps, L, M in ([(t, 7, 5) for t in (5, 16, 21, 29, 40, 41, 56, 64)]
                       + [(t, 147, 160) for t in (5, 21, 41, 64)]
                       + [(65, 7, 5), (200, 3, 2), (800, 7, 5),
                          (40, 1201, 800), (9, 300, 7)]):
        for history in (False, True):
            a = k6_random_args(dev, taps, L, M, 40037, history, rng)
            compare("pfb2", pfb2.pfb2(*a), pfb2.pfb2_reference(*a),
                    f"random {taps} x {L} bank, M {M}, geometry "
                    f"{pfb2._launch_geometry(taps, L, M, a[5])[:5]} "
                    f"{'history' if history else 'fresh'}")
    # an Inf and a NaN in the stream reach only the outputs whose windows
    # hold them: no zero tap that pads a pass meets a sample past them
    for taps, L, M in ((41, 147, 160), (37, 3, 2), (5, 7, 5), (147, 1, 4),
                       (200, 3, 2)):
        for history in (False, True):
            a = list(k6_random_args(dev, taps, L, M, 40037, history, rng))
            a[1][1000], a[1][5001] = float("inf"), float("nan")
            y, yr = pfb2.pfb2(*a), pfb2.pfb2_reference(*a)
            fin = torch.isfinite(yr)
            what = (f"random {taps} x {L} bank, M {M}, Inf and NaN in x, "
                    f"{'history' if history else 'fresh'}")
            if not torch.equal(torch.isfinite(y), fin) or fin.all():
                raise AssertionError(f"pfb2 {what}: non-finite outputs "
                                     f"{int((~torch.isfinite(y)).sum())}, "
                                     f"plain {int((~fin).sum())}")
            compare("pfb2", y[fin], yr[fin], what + f", {int((~fin).sum())} "
                    f"non-finite as in the plain version")
    for rate in (0.9997, 0.99999, 0.999):
        for mid in (False, True, "J0"):
            a, plan = k7_args(dev, rate, 40037, mid, rng)
            compare("arbd", arbd.arbd(*a), k7_plain(a, plan),
                    f"rate={rate} n=40037 "
                    f"{ {False: 'fresh', True: 'mid-stream'}.get(mid, mid)}")


def k6_args(dev, rate, n, history, rng):
    """One pfb2 call's arguments from a FIRFilter's kernel at `rate`
    ("L/M") with resample_filter's float32 taps: a fresh stream, or one
    mid-stream with a random history, entry phase L//2 + 1 and input
    deficit 3."""
    import torch
    from fractions import Fraction
    import dsptpu_torch
    rate = Fraction(rate)
    h = np.asarray(dsptpu_torch.resample_filter(rate), dtype=np.float32)
    f = dsptpu_torch.FIRFilter(h, rate)
    k = f.kernel
    L, M, hl = rate.numerator, rate.denominator, f.history_len
    hist = None
    if history:
        if hasattr(k, "phi_idx"):
            k.phi_idx = L // 2 + 1
        k.input_deficit = 3
        hist = torch.as_tensor(rng.standard_normal(hl).astype(np.float32),
                               device=dev)
    x = torch.as_tensor(rng.standard_normal(n).astype(np.float32),
                        device=dev)
    pfb = torch.as_tensor(dsptpu_torch.taps2pfb(h, L), device=dev)
    return (hist, x, pfb, L, M, getattr(k, "phi_idx", 1),
            k.input_deficit + (hl if history else 0), k.output_length(n), hl)


def k6_random_args(dev, taps, L, M, n, history, rng):
    """One pfb2 call with a random (taps, L) bank at rate L/M: fresh, or
    mid-stream with a random history of taps + 5 samples, entry phase
    L // 2 + 1 and input deficit 3."""
    import torch

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=dev)
    hl = taps + 5
    return (t(hl) if history else None, t(n), t(taps, L), L, M,
            L // 2 + 1 if history else 1, 3 + hl if history else 1,
            n * L // M)


def k7_args(dev, rate, n, mid_stream, rng):
    """One arbd call's arguments (the stream's anchor in place of a plan)
    at `rate` with resample_filter's float32 taps (nphi 32), and the host
    plan's arrays (FIRArbitrary.plan) for the plain version: fresh, after
    a first chunk of 30011 samples, or (mid_stream "J0") at J0 >= 10^8,
    the last two with a random history. Returns (hist, x, anchor, pfb,
    dpfb, out_len), (end0, phi, alpha)."""
    import torch
    import dsptpu_torch
    from dsptpu_torch.kernels import arbd
    h = np.asarray(dsptpu_torch.resample_filter(rate), dtype=np.float32)
    f = dsptpu_torch.FIRFilter(h, rate)
    k = f.kernel
    hl = f.history_len
    if mid_stream == "J0":
        xl = 10 ** 8 + 12345
        k.commit(xl, arbd.arbd_out_len(k.anchor(hl), xl))
    elif mid_stream:
        _, _, o1 = k.plan(30011)
        k.commit(30011, o1)
    head, alpha, out_len = k.plan(n)

    def t(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a, dt), device=dev)
    hist = t(rng.standard_normal(hl) if mid_stream else np.zeros(hl),
             np.float32)
    return ((hist, t(rng.standard_normal(n), np.float32), k.anchor(hl),
             t(k.pfb_t.T, np.float32), t(k.dpfb_t.T, np.float32), out_len),
            (t(hl + head[0] - 1, np.int64), t(head[1], np.int64),
             t(alpha, np.float32)))


def k7_plain(args, plan):
    """K7's plain version on the host plan's arrays for arbd's args."""
    from dsptpu_torch.kernels import arbd
    hist, x, _, pfb, dpfb, out_len = args
    return arbd.arbd_reference(hist, x, *plan, pfb, dpfb, out_len)


# the __global__ kernels each launch counter stands for (name parts, as
# torch.profiler reports them), each launched once a counted call; K2's
# are its SOS route's (every K2 call on the paths runs a cascade);
# "biir_reverse" counts a subset of biir's calls, so it asks for the same
# kernels
K2_STAGES = ("chunk_reduce_kernel", "carry_kernel",
             "chunk_scan_sos_output_kernel")
DEVICE_KERNELS = {
    "fir": ("fir_kernel",), "stft": ("stft_kernel",),
    "biir": K2_STAGES, "biir_reverse": K2_STAGES,
    "osconv": ("osconv_kernel",), "levinson": ("levinson_kernel",),
    "pfb2": ("pfb2_kernel",), "arbd": ("arbd_kernel",)}


CALLS_PROFILED = 2


def _profile_once(forward, x):
    """key_averages() of CALLS_PROFILED calls of forward(x) under
    torch.profiler, after a warm-up step inside the profiler's schedule.
    Each step starts with a spin kernel of about a millisecond: the
    device records of a window's first fraction of a millisecond have gone
    missing (K6 in runs of path C, K1 in one of the main path; a spin of
    0.1 ms still lost the first K6 of path C), so the spin takes that
    place and the path's kernels follow it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    traces = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traces.append(p.key_averages())
                 ) as prof:
        for _ in range(2):
            torch.cuda._sleep(2_000_000)
            for _ in range(CALLS_PROFILED):
                forward(x)
            torch.cuda.synchronize()
            prof.step()
    return traces[0]


def profile_main_path(forward, x, call_ms, counts, label="main path",
                      stage=None):
    """Device time by kernel per call of a path (torch.profiler over
    CALLS_PROFILED calls), and its share of call_ms, the call's
    unprofiled time. Every kernel that `counts` (the launch counters of
    the path's run) says was launched must have one device record for
    each launch in the profiled calls: the profile is taken again once
    if one is missing, and the run fails if it is still missing. Logs
    K2's device time per pass by stage where the path ran K2, and for
    `stage`, the name of a span (utils.profiling.span) in the path, its
    host time (the range's CPU events) and the device time of its
    kernels."""
    import torch
    from torch.autograd import DeviceType
    forward(x)
    torch.cuda.synchronize()
    want = sorted({part for name, c in counts.items() if c
                   for part in DEVICE_KERNELS[name]})
    for attempt in (1, 2):
        avg = _profile_once(forward, x)
        dev_events = [e for e in avg if e.device_type == DeviceType.CUDA
                      and not e.is_user_annotation and "spin" not in e.key]
        missing = [w for w in want
                   if not any(w in e.key for e in dev_events)]
        missing += [f"{c * CALLS_PROFILED} x {w}"
                    for name, c in counts.items() if c
                    for w in DEVICE_KERNELS[name]
                    if sum(e.count for e in dev_events if w in e.key)
                    < c * CALLS_PROFILED]
        if not missing:
            break
        log(f"profile ({label}), attempt {attempt}: no device record of "
            f"{missing} (launch counts {counts}); device records: "
            + "; ".join(e.key[:60] for e in dev_events))
    else:
        raise AssertionError(f"profile ({label}): counted kernels without "
                             f"a device record: {missing}")
    log(avg.table(sort_by="self_cuda_time_total", row_limit=14,
                  max_name_column_width=40))
    for w in want:
        ms = sum(e.self_device_time_total for e in dev_events
                 if w in e.key) / 1e3 / CALLS_PROFILED
        log(f"  device time of {w} per call: {ms:.4f} ms")
    if counts.get("biir"):
        stage_ms = {w: sum(e.self_device_time_total for e in dev_events
                           if w in e.key) / 1e3 / CALLS_PROFILED
                    / counts["biir"] for w in K2_STAGES}
        log(f"profile ({label}): K2 device time per pass by stage: "
            + ", ".join(f"{w} {ms:.4f} ms" for w, ms in stage_ms.items())
            + f", sum {sum(stage_ms.values()):.4f} ms ({counts['biir']} "
            "passes a call)")
    # device-side events only: a torch op's own entry repeats the time
    # of the kernels it launched
    busy_ms = sum(e.self_device_time_total
                  for e in dev_events) / 1e3 / CALLS_PROFILED
    log(f"profile ({label}): device busy {busy_ms:.3f} ms per call of "
        f"{call_ms:.3f} ms (idle share "
        f"{max(0.0, 1 - busy_ms / call_ms):.3f}; the table sums "
        f"{CALLS_PROFILED} calls)")
    if stage:
        ev = [e for e in avg if e.key == stage
              and e.device_type == DeviceType.CPU]
        if not ev:
            raise AssertionError(f"profile ({label}): no range {stage}")
        log(f"profile ({label}): stage {stage}: host "
            f"{sum(e.cpu_time_total for e in ev) / 1e3 / CALLS_PROFILED:.4f}"
            " ms a call (its CPU events), device "
            f"{sum(e.device_time_total for e in ev) / 1e3 / CALLS_PROFILED:.4f}"
            " ms a call (its kernels)")


def path_a(dev):
    """Path A at full width: K4 against its plain version and the
    library's overlap-save at the path's shapes, fftfilt_entry() with its
    launch counts, its time, and float32 against float64 on the card."""
    import torch
    import dsptpu_torch
    from dsptpu_torch import kernels
    from dsptpu_torch.kernels import osconv
    from dsptpu_torch.ops.dspbase import optimal_os_nfft
    from dsptpu_torch.pipeline import fftfilt_taps

    forward, (x,) = dsptpu_torch.fftfilt_entry(device="cuda")
    n, C = x.shape
    h = torch.as_tensor(fftfilt_taps(), device=dev)
    nv = h.shape[0]
    nfft = optimal_os_nfft(n, nv)
    if not osconv.osconv_supported(nfft, nv, torch.float32):
        raise AssertionError(f"path A: nfft {nfft} fails K4's gate")
    L = ((nfft - nv + 1) // 128) * 128
    K = -(-n // L)
    log(f"path A: x ({n}, {C}) float32, {nv} taps, nfft {nfft}, advance "
        f"{L}, {K} frames per channel")
    y = osconv.osconv(x, h, nfft, n)
    err = compare("osconv", y, osconv.osconv_reference(x, h, nfft, n),
                  "path A shapes")
    del y

    def library():
        # cuFFT overlap-save over unfolded frames, as one would write it
        # with torch alone
        S = nfft - L
        fr = torch.nn.functional.pad(x.T, (S, (K - 1) * L + nfft - S - n))
        fr = fr.unfold(-1, nfft, L)
        H = torch.fft.rfft(h, n=nfft)
        yy = torch.fft.irfft(torch.fft.rfft(fr, dim=-1) * H, n=nfft, dim=-1)
        return yy[..., S:].reshape(C, K * L)[:, :n].T

    # what the function needs per frame: two real FFTs and the product
    flops = C * K * (5 * nfft * np.log2(nfft) + 6 * nfft)
    row = dict(
        name="osconv", route="cuda", source="dsptpu_torch/csrc/osconv.cu",
        replaces="dsptpu/kernels/osconv.py:267", max_abs_err=err,
        ms=time_ms(lambda: osconv.osconv(x, h, nfft, n)),
        plain_ms=time_ms(lambda: osconv.osconv_reference(x, h, nfft, n)),
        library_ms=time_ms(library),
        bound=bound(2 * n * C * 4 + nv * 4, flops))
    report(row)

    kernels.reset_launches()
    torch.cuda.synchronize()
    y = forward(x)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"path A: launches {counts}")
    if counts["osconv"] < 1 or counts["fir"] != 0:
        raise AssertionError(f"path A missed K4 or took K1: {counts}")
    if y.shape != (n, C) or not torch.isfinite(y).all():
        raise AssertionError(f"path A: shape {tuple(y.shape)} or "
                             "non-finite output")
    e2e = time_ms(lambda: forward(x), reps=5, warmup=1)
    log(f"path A end to end: {e2e:.3f} ms (median of 5)")
    profile_main_path(forward, x, e2e, counts, "path A")
    compare("osconv", y, forward(x.double()), "path A fftfilt vs float64")
    return counts, [row]


def path_b(dev):
    """Path B at full width: K2's reverse pass with n_eff and K5 against
    their plain versions at the path's shapes, filtfilt_lpc_entry() with
    its launch counts, its time, float32 against float64 on the card,
    and the BASELINE's single-channel filtfilt."""
    import torch
    import dsptpu_torch
    from dsptpu_torch import kernels
    from dsptpu_torch.filters.filt import _cascade_ss
    from dsptpu_torch.kernels import biir, levinson
    from dsptpu_torch.ops.lpc import _biased_lags
    from dsptpu_torch.utils import profiling

    forward, (x,) = dsptpu_torch.filtfilt_lpc_entry(device="cuda")
    n, C = x.shape
    f = dsptpu_torch.as_sos(dsptpu_torch.digitalfilter(
        dsptpu_torch.Lowpass(0.2), dsptpu_torch.Butterworth(8)))
    ss = _cascade_ss(f.sos_array(), f.g)       # as filtfilt builds it
    pad = 6 * len(f.biquads)
    m = (n // 128) * 128
    log(f"path B: x ({n}, {C}) float32, {len(f.biquads)} sections "
        f"(p = {ss.p}), pad {pad}, reverse pass over n_eff = {m}")
    # the reverse pass's input is the forward pass's output over n + pad
    xe = torch.cat([x, x[n - 1 - pad: n - 1].flip(0)], 0)
    z0 = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (ss.p, C)).astype(np.float32), device=dev)
    y1 = biir.blockss_filt(ss, xe, z0)
    del xe
    err_r = compare("biir_reverse",
                    biir.blockss_filt(ss, y1, z0, reverse=True, n_eff=m),
                    biir.blockss_reference(ss, y1, z0, reverse=True,
                                           n_eff=m), "path B shapes")
    rows = [dict(
        name="biir_reverse", route="cuda", source="dsptpu_torch/csrc/biir.cu",
        replaces="dsptpu/kernels/biir.py:242", max_abs_err=err_r,
        ms=time_ms(lambda: biir.blockss_filt(ss, y1, z0, reverse=True,
                                             n_eff=m)),
        plain_ms=time_ms(lambda: biir.blockss_reference(
            ss, y1, z0, reverse=True, n_eff=m)),
        library_ms=None,
        bound=bound(2 * m * C * 4, 10 * len(f.biquads) * m * C))]
    report(rows[-1])
    del y1

    p, flen = 16, 400
    nfr = n // flen

    def lags_17(f, p):
        # the lags as p+1 products and sums (17 at p 16): the yardstick
        # of the batched pass
        return torch.stack([(f[: flen - lag] * f[lag:]).sum(0) / flen
                            for lag in range(p + 1)])
    # the frames as filtfilt_lpc_entry copies them
    frames = x[: nfr * flen, 0].reshape(nfr, flen).T.contiguous()
    R = _biased_lags(frames, p)
    compare("lags", R, lags_17(frames, p), "path B lags, one batched pass "
            "vs 17 sums (max|ref| = R[0])")
    lag_launches = {}
    for form, fn in (("17 sums", lambda: lags_17(frames, p)),
                     ("one batched pass", lambda: _biased_lags(frames, p))):
        by = profiling.device_by_kernel(fn, log=log)
        lag_launches[form] = sum(v[1] for v in by.values())
        log(f"  path B lags ({form}): device "
            f"{sum(v[0] for v in by.values()):.4f} ms in "
            f"{lag_launches[form]:.0f} launches a call (profiler, 10 "
            f"calls): " + ", ".join(f"{k} {v[0]:.4f} ms x {v[1]:.0f}"
                                     for k, v in by.items()))
    if lag_launches["one batched pass"] > 4:
        raise AssertionError(f"path B lags: {lag_launches} launches")
    errs = [compare("levinson", g, w, f"{name}, path B shapes")
            for name, g, w in zip(("a", "err", "refl"),
                                  levinson.levinson(R, p),
                                  levinson.levinson_reference(R, p))]
    # K5 by device time at path B's shape, at p 64 and over the 2500
    # frames of all C channels (the wide batch)
    xw = x[: nfr * flen].reshape(nfr, flen, C).transpose(0, 1).reshape(
        flen, nfr * C)
    for pk, Rk in ((p, R), (64, _biased_lags(frames, 64)),
                   (p, lags_17(xw, p))):
        what = f"p {pk} C {Rk.shape[1]}"
        if Rk is not R:
            for name, g, w in zip(("a", "err", "refl"),
                                  levinson.levinson(Rk, pk),
                                  levinson.levinson_reference(Rk, pk)):
                compare("levinson", g, w, f"{name}, {what}")
        by = profiling.device_by_kernel(lambda: levinson.levinson(Rk, pk),
                                        log=log)
        log(f"  levinson at {what}: device "
            f"{sum(v[0] for v in by.values()):.5f} ms a call (profiler, 10 "
            f"calls), events "
            f"{time_ms(lambda: levinson.levinson(Rk, pk), inner=10):.5f} ms "
            "a call (10 back to back), one call "
            f"{time_ms(lambda: levinson.levinson(Rk, pk)):.5f} ms (events: "
            "the wrapper's host time and the launch); bytes bound "
            f"{bound(4 * Rk.shape[1] * (3 * pk + 2), 0)[0]:.5f} ms")
    del xw
    idx = torch.arange(p, device=dev)
    toe = (idx[:, None] - idx[None, :]).abs()

    def library():
        # the (nfr, p, p) Toeplitz normal equations, solved batched
        # (gives a only)
        return torch.linalg.solve(R[:p].T[:, toe], -R[1:].T)
    rows.append(dict(
        name="levinson", route="cuda", source="dsptpu_torch/csrc/levinson.cu",
        replaces="dsptpu/kernels/levinson.py:75", max_abs_err=max(errs),
        ms=time_ms(lambda: levinson.levinson(R, p), inner=10),
        plain_ms=time_ms(lambda: levinson.levinson_reference(R, p)),
        library_ms=time_ms(library),
        bound=bound(4 * nfr * (3 * p + 2), 2 * p * p * nfr)))
    report(rows[-1])

    kernels.reset_launches()
    torch.cuda.synchronize()
    y, (a, e) = forward(x)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"path B: launches {counts}")
    if (counts["biir"] < 2 or counts["biir_reverse"] < 1
            or counts["levinson"] < 1):
        raise AssertionError(f"path B missed a kernel: {counts}")
    if (y.shape != (n, C) or a.shape != (p, nfr) or e.shape != (nfr,)
            or not all(torch.isfinite(t).all() for t in (y, a, e))):
        raise AssertionError("path B: shapes or non-finite output")
    e2e = time_ms(lambda: forward(x), reps=5, warmup=1)
    log(f"path B end to end: {e2e:.3f} ms (median of 5)")
    profile_main_path(forward, x, e2e, counts, "path B", stage="lpc")
    y64, (a64, e64) = forward(x.double())
    compare("biir_reverse", y, y64, "path B filtfilt vs float64")
    compare("levinson", a, a64, "path B lpc a vs float64")
    compare("levinson", e, e64, "path B lpc err vs float64")
    del y, y64

    # the BASELINE's own configuration: one channel, C = 1 the carry
    # pass's worst case
    x1 = x[:, :1].contiguous()
    kernels.reset_launches()
    y1 = dsptpu_torch.filtfilt(f, x1)
    torch.cuda.synchronize()
    c1 = kernels.launch_counts()
    if c1["biir"] != 2 or c1["biir_reverse"] != 1:
        raise AssertionError(f"single-channel filtfilt: launches {c1}")
    compare("biir_reverse", y1, dsptpu_torch.filtfilt(f, x1.double()),
            f"single-channel filtfilt ({n} x 1) vs float64")
    log(f"single-channel filtfilt: "
        f"{time_ms(lambda: dsptpu_torch.filtfilt(f, x1), reps=5):.3f} ms "
        "(median of 5)")
    return counts, rows


def path_c(dev, n=10_000_000, arb_n=2_500_000):
    """Path C at full width (n, arb_n as resample_entry's defaults): K6 at 147/160 and 3/2 and K7 at 0.9997
    against their plain versions and their library yardsticks at the
    path's shapes, each rate's float32 call and resample() against
    float64 on the card, the stream in chunks, resample_entry()'s
    forward with its launch counts, its time and a profile."""
    import torch
    import dsptpu_torch
    from fractions import Fraction
    from dsptpu_torch import kernels
    from dsptpu_torch.filters.stream_filt import _block_filt_step
    from dsptpu_torch.kernels import arbd, pfb2
    from dsptpu_torch.pipeline import RESAMPLE_RATES
    from dsptpu_torch.utils.device import no_tf32

    forward, (x,) = dsptpu_torch.resample_entry(device="cuda", n=n,
                                                arb_n=arb_n)
    xa = x[:arb_n]
    fs = {r: dsptpu_torch.FIRFilter(np.asarray(
        dsptpu_torch.resample_filter(r), dtype=np.float32), r)
        for r in RESAMPLE_RATES}
    log(f"path C: x ({n},) float32; rates "
        + ", ".join(str(r) for r in RESAMPLE_RATES)
        + f"; the arbitrary rate on x[:{arb_n}]")
    rows = []
    k6_full = []

    # K6 at each rational rate, fresh stream, as the path calls it
    for r, name in [(Fraction(147, 160), "pfb2"), (Fraction(3, 2),
                                                   "pfb2_3_2")]:
        f = fs[r]
        k = f.kernel
        L, M = r.numerator, r.denominator
        pfb = torch.as_tensor(np.ascontiguousarray(k.pfb_t.T, np.float32),
                              device=dev)
        taps = pfb.shape[0]
        out_len = k.output_length(n)
        hl = f.history_len
        args = (None, x, pfb, L, M, 1, 1, out_len)
        k6_full.append((args, hl))
        log(f"  {r}: {L} phases x {taps} taps, history {hl}, "
            f"{out_len} outputs, geometry (taps a pass, passes, lanes, "
            f"warps, k, span) {pfb2._launch_geometry(taps, L, M, 1)}")
        y = pfb2.pfb2(*args, hist_len=hl)[0]
        err = compare("pfb2", y, pfb2.pfb2_reference(*args),
                      f"{r} path C shapes")
        # the library yardstick: the port's non-kernel route on the same
        # stream, the zero history joined to x and the block matmul
        # (torch.matmul in full float32)
        G, s0, B, Mb, W, ol = f._block_args(n)
        Gd = torch.as_tensor(G, dtype=torch.float32, device=dev)
        h0 = torch.zeros(hl, device=dev)

        def library():
            return _block_filt_step(h0, x, Gd, s0, B, Mb, W, ol)[0]
        compare("pfb2", library(), y, f"{r} block matmul vs kernel")
        del y
        rows.append(dict(
            name=name, route="cuda", source="dsptpu_torch/csrc/pfb2.cu",
            replaces="dsptpu/kernels/pfb2.py:487", max_abs_err=err,
            ms=time_ms(lambda: pfb2.pfb2(*args, hist_len=hl), inner=10),
            plain_ms=time_ms(lambda: pfb2.pfb2_reference(*args), inner=10),
            library_ms=time_ms(library, inner=10),
            bound=bound(4 * (n + out_len), 2 * taps * out_len)))
        report(rows[-1])

    # K7 at 0.9997, fresh stream: the kernel takes the stream's anchor
    # and derives its plan on the card; the plain version and the library
    # call take the host plan's arrays
    ra = RESAMPLE_RATES[2]
    f = fs[ra]
    k = f.kernel
    head, alpha, out_len = k.plan(arb_n)
    hl, W, nphi = f.history_len, k.taps_per_phi, k.nphi

    def t(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a, dt), device=dev)
    end0 = t(hl + head[0] - 1, np.int64)
    phi = t(head[1], np.int64)
    al = t(alpha, np.float32)
    pfb, dpfb = t(k.pfb_t.T, np.float32), t(k.dpfb_t.T, np.float32)
    hist = torch.zeros(hl, device=dev)
    anchor = k.anchor(hl)
    args = (hist, xa, anchor, pfb, dpfb, out_len)
    plain = (hist, xa, end0, phi, al, pfb, dpfb, out_len)
    log(f"  {ra}: {nphi} phases x {W} taps, {out_len} outputs; {anchor}; "
        f"gate from the anchor "
        f"{arbd.arbd_accepts_anchor(anchor, out_len, hl + arb_n)}, on the "
        f"host plan {arbd.arbd_accepts(head[0], out_len, hl + arb_n)}")
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    y = arbd.arbd(*args, counts=counts)
    err = compare("arbd", y, arbd.arbd_reference(*plain), "path C shapes")
    runs = -(-out_len // arbd.RUN)
    slow, split = counts.tolist()
    log(f"  arbd: runs of {arbd.RUN} outputs computed one output at a time "
        f"{slow} of {runs} (share {slow / runs:.3g}); outputs of the "
        f"split passes {split} of {out_len} (share {split / out_len:.3g})")
    if slow:
        raise AssertionError("arbd: runs outside the two-phase geometry "
                             "under the gate")
    exact("arbd", arbd.arbd(*args), y, "a second call vs the first")
    # the on-card plan, bit for bit the host plan, fresh and at J0 >= 1e8
    g = dsptpu_torch.FIRFilter(np.asarray(dsptpu_torch.resample_filter(ra),
                                          dtype=np.float32), ra)
    xl = 10 ** 8 + 12345
    g.kernel.commit(xl, arbd.arbd_out_len(g.kernel.anchor(hl), xl))
    ghead, galpha, gout = g.kernel.plan(arb_n)
    for what, an, want in (
            ("fresh", anchor, (end0, phi, al)),
            (f"at J0 {g.kernel._j_total}", g.kernel.anchor(hl),
             (t(hl + ghead[0] - 1, np.int64), t(ghead[1], np.int64),
              t(galpha, np.float32)))):
        e, p, a = arbd.arbd_plan(an, out_len if what == "fresh" else gout,
                                 dev)
        exact("arbd", e, want[0], f"plan on the card, end0, {what}")
        exact("arbd", p.long(), want[1], f"plan on the card, phi, {what}")
        exact("arbd", a.view(torch.int32), want[2].view(torch.int32),
              f"plan on the card, alpha bits, {what}")
    del y, ghead, galpha

    def library():
        # every (position, phase) output of both banks by one float32
        # convolution (2 nphi output channels), then one gather
        xcat = torch.cat([hist, xa])
        both = torch.cat([pfb.T, dpfb.T])[:, None, :]
        with no_tf32():
            z = torch.nn.functional.conv1d(xcat[None, None], both)[0]
        nw = z.shape[1]
        flat = phi * nw + (end0 - (W - 1))
        z = z.reshape(-1)
        return z[flat] + al * z[flat + nphi * nw]
    compare("arbd", library(), arbd.arbd(*args),
            "all-phase convolution vs kernel")
    rows.append(dict(
        name="arbd", route="cuda", source="dsptpu_torch/csrc/arbd.cu",
        replaces="dsptpu/kernels/arbd.py:359", max_abs_err=err,
        ms=time_ms(lambda: arbd.arbd(*args), inner=10),
        plain_ms=time_ms(lambda: arbd.arbd_reference(*plain), inner=10),
        library_ms=time_ms(library, inner=10),
        bound=bound(4 * (hl + arb_n + out_len), (4 * W + 2) * out_len)))
    report(rows[-1])
    alone = [time_ms(lambda: pfb2.pfb2(*a, hist_len=h)) for a, h in k6_full]
    alone.append(time_ms(lambda: arbd.arbd(*args)))
    log("  one call per timed run (the rows above: 10 back to back): "
        + ", ".join(f"{r['name']} {t:.4f} ms" for r, t in zip(rows, alone)))
    # a new stream state's host time: a fresh FIRFilter's first filt (the
    # route's decision from the anchor, the banks' upload, one launch),
    # and a stream of 100,000-sample chunks, by host clock
    h_a = np.asarray(dsptpu_torch.resample_filter(ra), dtype=np.float32)
    first = []
    for _ in range(5):
        g = dsptpu_torch.FIRFilter(h_a, ra)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g.filt(xa)
        torch.cuda.synchronize()
        first.append((time.perf_counter() - t0) * 1e3)
    g = dsptpu_torch.FIRFilter(h_a, ra)
    per_chunk = []
    for c in torch.split(xa, 100_000):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g.filt(c)
        torch.cuda.synchronize()
        per_chunk.append((time.perf_counter() - t0) * 1e3)
    log(f"  {ra}: a fresh FIRFilter's first filt of {arb_n} samples "
        f"{statistics.median(first):.3f} ms (median of 5, host clock); "
        f"{len(per_chunk)} chunks of 100,000: "
        f"{statistics.median(per_chunk):.3f} ms a chunk (median; first "
        f"{per_chunk[0]:.3f}, max {max(per_chunk):.3f})")

    # each rate's float32 filter and resample() against float64; the
    # float64 calls take the non-kernel routes
    for r, xs in zip(RESAMPLE_RATES, (x, x, xa)):
        f = fs[r]
        name = "arbd" if isinstance(r, float) else "pfb2"
        kernels.reset_launches()
        y = f.reset().filt(xs)
        if kernels.launch_counts()[name] != 1:
            raise AssertionError(f"{r}: filt launched "
                                 f"{kernels.launch_counts()}")
        compare(name, y, f.reset().filt(xs.double()),
                f"{r} FIRFilter vs float64")
        kernels.reset_launches()
        y = dsptpu_torch.resample(xs, r)
        if kernels.launch_counts()[name] != 1:
            raise AssertionError(f"{r}: resample launched "
                                 f"{kernels.launch_counts()}")
        compare(name, y, dsptpu_torch.resample(xs.double(), r),
                f"{r} resample vs float64")
        del y

    # the stream in chunks through one FIRFilter, against one-shot
    for r in RESAMPLE_RATES[:2]:
        f = fs[r]
        one = f.reset().filt(x)
        f.reset()
        kernels.reset_launches()
        # at n = 10,000,000: cuts at 2,500,000, 5,000,037 and 7,777,777
        parts = [f.filt(c) for c in torch.tensor_split(
            x, [n // 4, n // 2 + 37, n * 7_777_777 // 10_000_000])]
        if kernels.launch_counts()["pfb2"] != 4:
            raise AssertionError(f"{r} chunks: launches "
                                 f"{kernels.launch_counts()}")
        exact("pfb2", torch.cat(parts), one,
              f"{r} in 4 chunks vs one-shot (bit for bit)")
        del one, parts
    f = fs[ra]
    k = f.kernel
    f.reset()
    got, want = [], []
    kernels.reset_launches()
    # at arb_n = 2,500,000: cuts at 800,000 and 1,650,001
    for c in torch.tensor_split(xa, [arb_n * 8 // 25, arb_n * 33 // 50 + 1]):
        hist = torch.zeros(hl, device=dev) if f.history is None \
            else f.history
        head, alpha, o = k.plan(c.shape[0])
        cargs = (hist, c, t(hl + head[0] - 1, np.int64),
                 t(head[1], np.int64), t(alpha, np.float32), pfb, dpfb, o)
        got.append(f.filt(c))
        want.append(arbd.arbd_reference(*cargs))
    if kernels.launch_counts()["arbd"] != 3:
        raise AssertionError(f"{ra} chunks: launches "
                             f"{kernels.launch_counts()}")
    got = torch.cat(got)
    compare("arbd", got, torch.cat(want),
            f"{ra} in 3 chunks vs plain on the same chunks")
    one = f.reset().filt(xa)
    exact("arbd", got, one, f"{ra} in 3 chunks vs one-shot")
    del got, want, one

    # the path through its entry point
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ys = forward(x)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launch_counts()
    log(f"path C: launches {counts}, first call {first_ms:.1f} ms")
    if (counts["pfb2"], counts["arbd"], counts["fir"],
            counts["osconv"]) != (2, 1, 0, 0):
        raise AssertionError(f"path C launches: {counts}")
    shapes = tuple(tuple(y.shape) for y in ys)
    want_shapes = ((fs[RESAMPLE_RATES[0]].reset().output_length(n),),
                   (fs[RESAMPLE_RATES[1]].reset().output_length(n),),
                   (fs[ra].reset().output_length(arb_n),))
    if shapes != want_shapes or not all(torch.isfinite(y).all()
                                        for y in ys):
        raise AssertionError(f"path C: shapes {shapes} (want "
                             f"{want_shapes}) or non-finite output")
    del ys
    e2e = time_ms(lambda: forward(x), reps=5, warmup=1)
    log(f"path C end to end: {e2e:.3f} ms (median of 5)")
    for r, xs in zip(RESAMPLE_RATES, (x, x, xa)):
        f = fs[r]
        log(f"  {r}: reset + filt "
            f"{time_ms(lambda: f.reset().filt(xs), reps=5):.3f} ms "
            "(median of 5)")
    profile_main_path(forward, x, e2e, counts, "path C")
    rows[0]["launches"] = rows[1]["launches"] = counts["pfb2"]
    rows[2]["launches"] = counts["arbd"]
    return counts, rows


def path_d(dev, n=1_000_000, coh_n=16384):
    """Path D at full width (n, coh_n as multitaper_entry's defaults):
    K3's K-window stack against its plain version and the library's
    rfft at the path's shapes, multitaper_entry()'s forward with its
    launch counts, its time and a profile, and float32 against float64
    on the card."""
    import torch
    import dsptpu_torch
    from dsptpu_torch import kernels
    from dsptpu_torch.kernels import stft
    from dsptpu_torch.ops.multitaper import MTConfig
    from dsptpu_torch.pipeline import MT_NFFT, MT_NTAPERS, MT_NW, MT_OVERLAP

    nfft, hop, K = MT_NFFT, MT_NFFT - MT_OVERLAP, MT_NTAPERS
    forward, (x,) = dsptpu_torch.multitaper_entry(device="cuda", n=n,
                                                  coh_n=coh_n)
    n, C = x.shape
    k = (n - nfft) // hop + 1
    # the path's taper stack W_m = w_m / sqrt(r_m) and one-sided scale,
    # as the entry's config uploads them for K3
    mt = MTConfig.create(nfft, nfft=nfft, nw=MT_NW, ntapers=K)
    Wd = mt.const("stack", dev, torch.float32)
    scd = mt.const("stack_scale", dev, torch.float32)
    nbins = scd.shape[0]
    log(f"path D: x ({n}, {C}) float32, {K} DPSS tapers (NW {MT_NW}), "
        f"nfft {nfft}, hop {hop}, {k} frames; coherence of x[:{coh_n}]")
    got = stft.stft_pow(x, Wd, nfft, hop, k, False, scd)
    err = compare("stft_mt", got, stft.stft_pow_reference(
        x, Wd, nfft, hop, k, False, scd), "path D shapes, white x",
        by_bin=True)
    fr = x.T.unfold(1, nfft, hop)[:, :k]                # (C, k, nfft)

    def library():
        # rfft of the K tapered copies of the unfolded frames, |X|^2
        # summed over the tapers: (C, k, nbins)
        X = torch.fft.rfft(fr[:, :, None, :] * Wd, dim=-1)
        return X.abs().square().sum(2) * scd
    compare("stft_mt", library().permute(2, 1, 0), got,
            "library rfft vs kernel", by_bin=True)
    del got
    # per frame and channel: K real FFTs, windows, |X|^2 and the sum
    flops = K * (2.5 * nfft * np.log2(nfft) + nfft + 4 * nbins) * k * C
    row = dict(
        name="stft_mt", route="cuda", source="dsptpu_torch/csrc/stft.cu",
        replaces="dsptpu/kernels/stft.py:295", max_abs_err=err,
        ms=time_ms(lambda: stft.stft_pow(x, Wd, nfft, hop, k, False, scd)),
        plain_ms=time_ms(lambda: stft.stft_pow_reference(
            x, Wd, nfft, hop, k, False, scd), reps=5, warmup=1),
        library_ms=time_ms(library, reps=5, warmup=1),
        bound=bound(4 * (n * C + K * nfft + nbins * k * C), flops))
    report(row)
    del fr

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spec, coh = forward(x)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launch_counts()
    log(f"path D: launches {counts}, first call {first_ms:.1f} ms")
    if counts["stft"] < 1:
        raise AssertionError(f"path D missed K3: {counts}")
    nf = coh_n // 2 + 1
    if (spec.shape != (nbins, k, C) or coh.shape != (C, C, nf)
            or not (torch.isfinite(spec).all() and torch.isfinite(coh).all())):
        raise AssertionError(f"path D: shapes {tuple(spec.shape)} "
                             f"{tuple(coh.shape)} or non-finite output")
    e2e = time_ms(lambda: forward(x), reps=5, warmup=1)
    log(f"path D end to end: {e2e:.3f} ms (median of 5)")
    profile_main_path(forward, x, e2e, counts, "path D")
    # against float64 on the card (the float64 spectrogram takes
    # torch.fft): relative to the largest bin, and per bin over the bins
    # within 40 dB of it; the coherence lies in [0, 1], so its bound is
    # absolute
    spec64, coh64 = forward(x.double())
    top = per_bin(spec64) >= 1e-4 * spec64.abs().max()
    compare("stft_mt", spec, spec64, "path D spectrogram vs float64")
    compare("stft_mt", spec[top], spec64[top], f"path D spectrogram vs "
            f"float64, {int(top.sum())} bins within 40 dB", by_bin=True)
    compare("coherence", coh, coh64, "path D coherence vs float64")
    row["launches"] = counts["stft"]
    return counts, [row]


def path_k8(dev, n=1_000_000, C=64, M2=(3000, 3500),
            perm=(64, 8, 8, 256, 65), TR=8192):
    """The K8 phase: the transpose kernels, which no route of the port
    (or of dsptpu) calls, driven directly at full size as dsptpu's tests
    drive its own: transpose2d of an M2 matrix, transpose_tall of the
    main path's stream (n, C) with TR, and spectro_permute of the raw
    (C, nb, N1, TB, 128) power layout that the main path's spectrogram
    has on the TPU (perm = (C, nb, N1, TB, l2)). Each kernel equals its
    plain version bit for bit; its time, the library's and the bound
    (bytes) follow. Times are CUDA-event medians of runs of 10 calls back
    to back (the wrapper's host work then overlaps the card), and each
    kernel's device time per call is by torch.profiler over 10 calls,
    each after a 128 MB write that flushes the L2."""
    import torch
    from dsptpu_torch import kernels
    from dsptpu_torch.kernels import transpose as tp
    from dsptpu_torch.utils import profiling

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((n, C)).astype(np.float32),
                        device=dev)
    a = torch.as_tensor(rng.standard_normal(M2).astype(np.float32),
                        device=dev)
    Cp, nb, N1, TB, l2 = perm
    tile = torch.as_tensor(rng.standard_normal(
        (Cp, nb, N1, TB, 128)).astype(np.float32), device=dev)
    L = tp.tall_out_len(n, TR)
    flush = torch.empty(32 << 20, device=dev)       # 128 MB
    log(f"K8 phase: transpose2d {M2}, transpose_tall ({n}, {C}) TR {TR} "
        f"-> ({C}, {L}), spectro_permute {tuple(tile.shape)} l2 {l2}")

    kernels.reset_launches()
    torch.cuda.synchronize()
    outs = (tp.transpose2d(a), tp.transpose_tall(x, TR),
            tp.spectro_permute(tile, l2))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"K8 phase: launches {counts}")
    rows = []
    for (name, line, kern, plain, lib, nbytes), out in zip([
            ("transpose2d", 51, lambda: tp.transpose2d(a),
             lambda: tp.transpose2d_reference(a),
             lambda: a.T.contiguous(), 2 * a.numel() * 4),
            ("transpose_tall", 147, lambda: tp.transpose_tall(x, TR),
             lambda: tp.transpose_tall_reference(x, TR),
             lambda: torch.nn.functional.pad(x.T, (0, L - n)),
             4 * (n * C + C * L)),
            # the function reads the l2 bins it keeps, not the whole tile
            ("spectro_permute", 193, lambda: tp.spectro_permute(tile, l2),
             lambda: tp.spectro_permute_reference(tile, l2),
             lambda: tile[..., :l2].permute(4, 2, 1, 3, 0).contiguous().view(
                 l2, N1, nb * TB, Cp), 2 * 4 * Cp * nb * N1 * TB * l2)],
            outs):
        if counts[name] < 1:
            raise AssertionError(f"K8 phase: {name} not launched: {counts}")
        exact(name, out, plain(), "full size vs plain")
        exact(name, lib(), out, "library vs kernel")
        rows.append(dict(
            name=name, route="cuda", source="dsptpu_torch/csrc/transpose.cu",
            replaces=f"dsptpu/kernels/transpose.py:{line}",
            launches=counts[name], max_abs_err=0.0,
            ms=time_ms(kern, inner=10), plain_ms=time_ms(plain, reps=5),
            library_ms=time_ms(lib, inner=10), bound=bound(nbytes, 0)))
        report(rows[-1])
        dev_ms = {k: v[0] for k, v in profiling.device_by_kernel(
            kern, flush=flush, log=log).items()}
        log(f"  {name}: device time per call {sum(dev_ms.values()):.4f} ms "
            f"(L2 flushed before each call) by kernel {dev_ms}")
    return counts, rows


def _free_port():
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def _timed_pair(label, sharded, plain):
    """One line per sharded call beside its unsharded counterpart: the
    call's CUDA-event ms (median of 5), its device ms by torch.profiler
    (the leading spin left out) and its idle share; then the sharded
    call's five largest device times by kernel."""
    from dsptpu_torch.utils import profiling
    out = {}
    for what, fn in (("sharded", sharded), ("unsharded", plain)):
        ms = time_ms(fn, reps=5, warmup=1)
        by = profiling.device_by_kernel(fn, calls=2, log=log)
        out[what] = (ms, sum(v[0] for v in by.values()))
        if what == "sharded":
            top = sorted(by.items(), key=lambda kv: -kv[1][0])[:5]
    log(f"  {label}: " + "; ".join(
        f"{what} {ms:.3f} ms, device {dev_ms:.3f} ms, idle share "
        f"{max(0.0, 1 - dev_ms / ms):.3f}"
        for what, (ms, dev_ms) in out.items()))
    log(f"    {label} sharded, device ms a call by kernel: " + ", ".join(
        f"{k[:48]} {v[0]:.3f} x {v[1]:.0f}" for k, v in top))
    return out


class KernelInputs:
    """Within a `with` block, every call of the wrappers named in `names`
    ({module: [function name]}) records its arguments, tensors cloned
    before the call, and then runs as before (its launch counted as
    before); the wrappers are restored on exit. `calls[name]` lists the
    (args, kwargs) of each call in order."""

    def __init__(self, names):
        self.names = names
        self.calls = {f: [] for fs in names.values() for f in fs}

    def __enter__(self):
        import torch

        def own(v):
            return v.clone() if isinstance(v, torch.Tensor) else v

        def recording(fn, into):
            def call(*a, **kw):
                into.append(([own(v) for v in a],
                             {k: own(v) for k, v in kw.items()}))
                return fn(*a, **kw)
            return call
        self.saved = []
        for mod, fs in self.names.items():
            for f in fs:
                self.saved.append((mod, f, getattr(mod, f)))
                setattr(mod, f, recording(getattr(mod, f), self.calls[f]))
        return self

    def __exit__(self, *exc):
        for mod, f, fn in self.saved:
            setattr(mod, f, fn)


def path_sharded(dev, n=1_000_000, C=64, na=10_000_000, Ca=16,
                 nc=10_000_000, coh_n=16384):
    """The sharded phase at world size 1 (full width by default): the
    port's parallel/ ops on a single-rank process group (NCCL on the
    card) joined through init_distributed, each against the unsharded
    port call at the bound chip_smoke holds that call to; K2 with
    need_state at (n, C) against its plain version; the K2 and K4
    launches of the sharded calls; native.StreamReader reading the main
    stream from a file to the device; profiling.measure and
    Roofline.fractions on K1. Destroys the process group at the end."""
    import torch
    import torch.distributed as dist
    from dsptpu_torch import parallel

    port = _free_port()
    if not parallel.init_distributed(f"localhost:{port}", 1, 0,
                                     device_type=dev.type):
        raise AssertionError("sharded phase: a process group exists")
    try:
        mesh = parallel.make_mesh(device_type=dev.type)
        one = torch.ones(1, device=dev)
        dist.all_reduce(one, group=mesh.get_group("time"))
        log(f"sharded phase: {dist.get_backend()} process group of "
            f"{dist.get_world_size()} rank on localhost:{port}, mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}, "
            f"all_reduce {one.item()}")
        return _sharded_calls(dev, mesh, n, C, na, Ca, nc, coh_n)
    finally:
        dist.destroy_process_group()


def _sharded_calls(dev, mesh, n, C, na, Ca, nc, coh_n):
    """path_sharded's calls and checks on `mesh`; returns (the launch
    counts of the sharded calls, {call: {"sharded"/"unsharded": (ms,
    device ms)}})."""
    import tempfile
    import torch
    import dsptpu_torch
    from fractions import Fraction
    from dsptpu_torch import kernels, native, parallel
    from dsptpu_torch.filters.filt import _cascade_ss
    from dsptpu_torch.kernels import biir, fir, osconv
    from dsptpu_torch.pipeline import (MT_NTAPERS, MT_NW, chain_params,
                                       fftfilt_taps)
    from dsptpu_torch.utils import profiling

    taps, sos, win = chain_params()
    nfft = win.shape[0]
    fwd, (xd,) = dsptpu_torch.sharded_entry(mesh, n=n, channels=C)
    x = xd.to_local()                       # world size 1: the whole stream
    f = dsptpu_torch.as_sos(dsptpu_torch.digitalfilter(
        dsptpu_torch.Lowpass(0.2), dsptpu_torch.Butterworth(8)))
    tt = torch.as_tensor(taps, device=dev)
    h = torch.as_tensor(fftfilt_taps(), device=dev)
    xa = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (na, Ca)).astype(np.float32), device=dev)
    xc = torch.as_tensor(np.random.default_rng(0).standard_normal(
        nc).astype(np.float32), device=dev)
    r32 = Fraction(3, 2)
    h32 = np.asarray(dsptpu_torch.resample_filter(r32), dtype=np.float32)
    coh_cfg = dsptpu_torch.MTCoherenceConfig.create(
        C, mt_config=dsptpu_torch.MTConfig.create(
            coh_n, nfft=coh_n, nw=MT_NW, ntapers=MT_NTAPERS))
    xm = x[:coh_n].T

    def welch_chain(x):
        y = dsptpu_torch.sosfilt(sos, dsptpu_torch.filt(tt, x))
        return dsptpu_torch.power(dsptpu_torch.welch_pgram(
            y, nfft, nfft // 2, window=win))

    def resample_sharded():
        y, cnt = parallel.shard_resample(h32, r32, xc, mesh)
        return parallel.compact_shards(y, cnt)

    calls = {
        "sharded_entry": (lambda: fwd(xd), lambda: welch_chain(x)),
        "shard_filtfilt": (
            lambda: parallel.shard_filtfilt(f.sos_array(), f.g, xd, mesh),
            lambda: dsptpu_torch.filtfilt(f, x)),
        "shard_fftfilt": (
            lambda: parallel.shard_fftfilt(h, xa, mesh),
            lambda: dsptpu_torch.fftfilt(h, xa)),
        "shard_resample": (
            resample_sharded,
            lambda: dsptpu_torch.FIRFilter(h32, r32).filt(xc)),
        "shard_mt_coherence": (
            lambda: parallel.shard_mt_coherence(xm, mesh,
                                                config=coh_cfg).coherence,
            lambda: dsptpu_torch.mt_coherence(xm, config=coh_cfg).coherence)}
    log(f"sharded phase: main stream ({n}, {C}), path A's ({na}, {Ca}) "
        f"with {h.shape[0]} taps, path C's ({nc},) at {r32}, coherence of "
        f"({C}, {coh_n})")

    # each sharded call once, with the launch counts set to 0 just before
    # and read just after, and the inputs of its K2 and K4 launches kept;
    # its result against the unsharded call's
    counts = {}
    outs = {}
    seen = {}
    kernels.reset_launches()
    torch.cuda.synchronize()
    for name, (sharded, _) in calls.items():
        before = kernels.launch_counts()
        with KernelInputs({biir: ["blockss_filt"],
                           osconv: ["osconv"]}) as got:
            outs[name] = sharded()
            torch.cuda.synchronize()
        after = kernels.launch_counts()
        counts[name] = {k: after[k] - before[k] for k in after
                        if after[k] - before[k]}
        seen[name] = got.calls
        if (len(got.calls["blockss_filt"]) != counts[name].get("biir", 0)
                or len(got.calls["osconv"])
                != counts[name].get("osconv", 0)):
            raise AssertionError(f"{name}: K2/K4 launches {counts[name]} "
                                 "not all through the wrappers")
    total = kernels.launch_counts()
    log(f"sharded phase: launches {counts}")
    if total["biir"] < 2 or total["osconv"] < 1:
        raise AssertionError(f"sharded phase missed K2 or K4: {counts}")
    for name in ("sharded_entry", "shard_filtfilt"):
        if counts[name].get("biir", 0) < 1:
            raise AssertionError(f"{name}: no K2 pass: {counts[name]}")
    if counts["shard_fftfilt"].get("osconv", 0) < 1:
        raise AssertionError(f"shard_fftfilt: no K4 launch: "
                             f"{counts['shard_fftfilt']}")

    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t
    psd = local(outs["sharded_entry"])
    ref = welch_chain(x)
    top = per_bin(ref) >= 1e-4 * ref.abs().max()
    compare("psd", psd, ref, "sharded_entry vs the main path's chain to "
            "Welch", tol=1e-4)
    compare("psd", psd[top], ref[top], f"sharded_entry vs the main path's "
            f"chain, {int(top.sum())} bins within 40 dB", by_bin=True,
            tol=1e-4)
    compare("biir_reverse", local(outs["shard_filtfilt"]),
            dsptpu_torch.filtfilt(f, x), "shard_filtfilt vs filtfilt")
    compare("osconv", local(outs["shard_fftfilt"]), calls["shard_fftfilt"][1](),
            "shard_fftfilt vs fftfilt")
    compare("pfb2", local(outs["shard_resample"]), calls["shard_resample"][1](),
            "shard_resample + compact_shards vs FIRFilter.filt")
    compare("coherence", local(outs["shard_mt_coherence"]),
            calls["shard_mt_coherence"][1](),
            "shard_mt_coherence vs mt_coherence")
    del outs

    # each K2 and K4 launch of the sharded calls against its plain
    # version on the same input: K4 on shard_fftfilt's halo-extended
    # block, K2 on shard_filtfilt's padded block, its masked and flipped
    # forward output and its zero-input responses, K2 with need_state in
    # sharded_entry
    def bound_args(fn, a, kw):
        b = inspect.signature(fn).bind(*a, **kw)
        b.apply_defaults()
        return b.arguments

    for name, got in seen.items():
        for i, (a, kw) in enumerate(got["blockss_filt"]):
            g = bound_args(biir.blockss_filt, a, kw)
            what = (f"{name}'s launch {i + 1} ({tuple(g['x'].shape)}, "
                    f"need_state {g['need_state']}, reverse {g['reverse']},"
                    f" n_eff {g['n_eff']}, z0 "
                    f"{'set' if g['z0'].any() else '0'})")
            y = biir.blockss_filt(*a, **kw)
            yr = biir.blockss_reference(*a, **kw)
            if g["need_state"]:
                compare("biir", y[0], yr[0], f"{what} y")
                compare("biir", y[1], yr[1], f"{what} final state")
            else:
                compare("biir", y, yr, f"{what} y")
            del y, yr
        for i, (a, kw) in enumerate(got["osconv"]):
            g = bound_args(osconv.osconv, a, kw)
            what = (f"{name}'s launch {i + 1} ({tuple(g['u'].shape)}, "
                    f"{g['v'].shape[0]} taps, nfft {g['nfft']}, out_len "
                    f"{g['out_len']})")
            compare("osconv", osconv.osconv(*a, **kw),
                    osconv.osconv_reference(*a, **kw), what)
    del seen

    # K2 with need_state at the main path's width, against its plain
    # version: y and the final state
    ss = _cascade_ss(sos.astype(np.float64), 1.0)
    z0 = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (ss.p, C)).astype(np.float32), device=dev)
    y, zf = biir.blockss_filt(ss, x, z0, need_state=True)
    yr, zr = biir.blockss_reference(ss, x, z0, need_state=True)
    compare("biir", y, yr, f"need_state y ({n}, {C})")
    compare("biir", zf, zr, f"need_state final state ({n}, {C})")
    del y, yr

    # each sharded call's time beside the unsharded call's
    log("sharded phase, times (world size 1):")
    times = {name: _timed_pair(name, *pair) for name, pair in calls.items()}

    # the main stream through a file and the native reader to the device
    if not native.native_available():
        raise AssertionError("native: the ring buffer did not build")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stream.f32")
        x.cpu().numpy().tofile(path)
        chunk = 1 << 16
        t0 = time.perf_counter()
        with native.StreamReader(path, chunk=chunk, dtype=np.float32,
                                 channels=C, device=dev) as sr:
            parts = list(sr)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        if parts[0].device.type != dev.type:
            raise AssertionError("native: chunks not on the device")
        exact("stream", torch.cat(parts), x, f"StreamReader, {len(parts)} "
              f"chunks of {chunk} x {C}, vs the stream")
        log(f"  native StreamReader: {x.numel() * 4 / 1e6:.0f} MB in "
            f"{read_s * 1e3:.1f} ms ({x.numel() * 4 / read_s / 1e9:.2f} "
            "GB/s, file in the page cache, host clock)")
        del parts

    # profiling.measure and Roofline.fractions on K1 at the main path's
    # shape
    sec = profiling.measure(fir.fir, x, tt)
    nb = tt.shape[0]
    fr = profiling.Roofline().fractions(sec, min_bytes=2 * n * C * 4 + nb * 4,
                                        flops=2 * nb * n * C)
    log(f"  profiling.measure(fir.fir) {sec * 1e3:.4f} ms, Roofline "
        + ", ".join(f"{k} {v:.3f}" for k, v in fr.items()))
    return total, times


# the kernels each bench config's calls must launch on the card
BENCH_KERNELS = {
    "fir_127tap": {"filt": ("fir",)},
    "os_4096tap_16ch": {"fftfilt": ("osconv",)},
    "welch_spectrogram_1024_64ch": {"welch": ("stft",),
                                    "spectrogram": ("stft",)},
    "resample_147_160": {"resample_147_160": ("pfb2",),
                         "resample_3_2": ("pfb2",),
                         "resample_arb_0p9997": ("arbd",)},
    "filtfilt_lpc16": {"filtfilt": ("biir",), "lpc": ("levinson",)}}


def path_bench():
    """The bench phase: dsptpu_torch.bench's five BASELINE configs at full
    scale on the card, with the kernels chip_smoke built. Logs the
    bench's JSON line and each call's times; fails if a config raised,
    a witness is past its tolerance, a profile held no device record or
    a call missed its kernel."""
    from dsptpu_torch import bench
    t0 = time.perf_counter()
    record, failed = bench.run("cuda")
    log(f"bench phase ({time.perf_counter() - t0:.1f} s), JSON line: "
        + json.dumps(record))
    if failed:
        raise AssertionError(f"bench phase: {failed}")
    detail = record["extra"]["detail"]
    for name, calls in BENCH_KERNELS.items():
        for label, want in calls.items():
            d = detail[name][label]
            log(f"  bench {name}/{label}: call {d['call_ms']:.4f} ms "
                f"({d['call_ms_min']:.4f}-{d['call_ms_max']:.4f}), device "
                f"{d['device_ms']:.4f} ms, idle share {d['idle_share']:.3f}"
                f", bound {d['bound_ms']:.4f} ms ({d['bound_by']}), "
                f"launches {d['launches']}")
            missing = [k for k in want if not d["launches"].get(k)]
            if missing or not d["device_ms"] > 0:
                raise AssertionError(f"bench {name}/{label}: no launch of "
                                     f"{missing} or no device time: {d}")
    log("bench phase: witnesses " + ", ".join(
        f"{k} {v:.2e}" for k, v in record["extra"]["err"].items())
        + f"; geomean {record['value']:.4g} samples/s, vs scipy "
        f"{record['vs_baseline']:.4g}")


def path_examples(root):
    """The examples phase: the three examples' main(device="cuda"); a
    false claim raises SystemExit, which fails the run."""
    sys.path.insert(0, os.path.join(root, "examples"))
    import torch_audio_pipeline
    import torch_distributed_pipeline
    import torch_streaming_io
    for mod in (torch_audio_pipeline, torch_distributed_pipeline,
                torch_streaming_io):
        log(f"example {mod.__name__} on the card:")
        t0 = time.perf_counter()
        mod.main(device="cuda")
        log(f"example {mod.__name__}: {time.perf_counter() - t0:.1f} s")


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import dsptpu_torch
    from dsptpu_torch import kernels
    from dsptpu_torch.kernels import _build, biir, fir, stft
    from dsptpu_torch.filters.filt import _cascade_ss
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
    framed = []
    for name in _build.SOURCES:
        logf = os.path.join(os.path.dirname(paths[name]), f"{name}.log")
        if os.path.exists(logf):
            entry = ""
            for line in open(logf):
                if "Compiling entry" in line:
                    entry = line.split("'")[1] if "'" in line else line
                if ("registers" in line or "spill" in line.lower()
                        or (name in ("stft", "osconv", "biir", "pfb2", "arbd",
                                     "levinson")
                            and "Compiling entry" in line)):
                    log(f"  {name}: {line.strip()}")
                if ("bytes stack frame" in line and not
                        line.strip().startswith("0 bytes stack frame")):
                    framed.append(f"{name}:{entry}")
    log(f"build: kernels with a stack frame (register arrays in local "
        f"memory): {framed if framed else 'none'}")
    for name in ("pfb2", "biir", "arbd", "transpose", "levinson"):
        if any(f.startswith(f"{name}:") for f in framed):
            raise AssertionError(f"{name}: a template keeps registers in a "
                                 "stack frame")
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
    # K1 at BASELINE config 1's shape (10,000,000 x 1, the same taps),
    # logged on its own; the kernels line keeps the main path's shapes
    x1 = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (10_000_000, 1)).astype(np.float32), device=dev)
    compare("fir", fir.fir(x1, taps), fir.fir_reference(x1, taps),
            "10,000,000 x 1")
    bms, by = bound(2 * x1.numel() * 4 + nb * 4, 2 * nb * x1.numel())
    log(f"  fir at 10,000,000 x 1: kernel "
        f"{time_ms(lambda: fir.fir(x1, taps), inner=10):.4f} ms, bound "
        f"{bms:.4f} ms ({by})")
    del x1

    ss = _cascade_ss(sos_np.astype(np.float64), 1.0)   # as sosfilt builds it
    z0 = torch.zeros((ss.p, C), device=dev)
    y2 = biir.blockss_filt(ss, y1, z0)
    err = compare("biir", y2, biir.blockss_reference(ss, y1, z0),
                  "main path")
    exact("biir", biir.blockss_filt(ss, y1, z0), y2, "main path twice")
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
    profile_main_path(forward, x, e2e, counts)
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

    del x, psd, spow, psd64, spow64
    torch.cuda.empty_cache()
    counts_a, rows_a = path_a(dev)
    counts_b, rows_b = path_b(dev)
    _, rows_c = path_c(dev)
    torch.cuda.empty_cache()
    _, rows_d = path_d(dev)
    torch.cuda.empty_cache()
    _, rows_k8 = path_k8(dev)
    torch.cuda.empty_cache()
    path_sharded(dev)
    torch.cuda.empty_cache()
    path_bench()
    torch.cuda.empty_cache()
    path_examples(os.path.dirname(os.path.abspath(__file__)))
    torch.cuda.empty_cache()
    for r in rows:
        r["launches"] = counts[r["name"]]
    for r in rows_a:
        r["launches"] = counts_a[r["name"]]
    for r in rows_b:
        r["launches"] = counts_b[r["name"]]
    rows += rows_a + rows_b + rows_c + rows_d + rows_k8
    for r in rows:
        if r["launches"] < 1:
            raise AssertionError(f"{r['name']}: no launch on its path")

    out = []
    for r in rows:
        bms, by = r.pop("bound")
        r.update(bound_ms=bms, bound_by=by)
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
