"""Benchmark of the port: dsptpu's bench.py on dsptpu_torch.

    python3 bench_torch.py                            # the card, full size
    python3 bench_torch.py --device cpu --scale 100   # plain versions
    python3 bench_torch.py --hosts 4 [n]              # weak scaling

`main` runs the five BASELINE configs of bench.py at its shapes, seeds
and data (numpy default_rng(1776), float32): a 127-tap FIR of
10,000,000 x 1 (K1), a 4096-tap overlap-save of 10,000,000 x 16 (K4),
Welch and a spectrogram of 1,000,000 x 64 (K3), streaming resampling of
10,000,000 samples at 147/160 and 3/2 (K6) and of the first 2,500,000
at 0.9997 (K7), and a Butterworth(8) filtfilt of 1,000,000 x 1 (K2)
with order-16 Levinson LPC of 2500 frames of 400 (K5). `--scale K`
makes every length K times shorter.

Each config's outputs are held, on a strided slice, to bench.py's
float64 oracles (eight witnesses, `_WITNESS_TOL`). Each call is timed
by CUDA events (median, min and max of 10 calls after a warm-up),
its device time taken by torch.profiler, and its launches read from the
kernel wrappers' counters; the bound is the larger of the bytes the call
must move over the card's memory rate and the operations it needs over
its float32 rate (utils.profiling.Roofline). On the CPU the calls are
timed by the host clock and nothing is reported as a device figure.

Prints one JSON line to stdout, with bench.py's keys: metric, value (the
geometric mean of samples/s over the configs), unit, vs_baseline (the
same geomean against scipy on the host's CPU, subsampled and scaled as
bench.py does) and extra; the detail goes to stderr. Exits 1 if a config
raised, a witness is past its tolerance, a profile held no device
record, or, on "cuda", if there is no card; it never falls back to the
CPU.

`weak_scaling(N, n)` runs bench.py's weak-scaling mode: shard_fir ->
shard_sosfilt -> shard_welch, plus shard_filtfilt and shard_resample at
3/2, on h gloo ranks on the CPU (parallel.simulate_hosts) for h = 1..N,
each rank holding n x 64 samples, with every op held to the unsharded
port op on each rank's rows first. It writes no file.
"""

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
from fractions import Fraction

import numpy as np
import torch

from . import kernels
from .filters import (Butterworth, FIRFilter, Lowpass, as_sos, digitalfilter,
                      resample_filter, sos_arrays)
from .filters.filt import fftfilt, filt_stepstate_sos, filtfilt
from .filters.stream_filt import taps2pfb
from .ops import windows
from .ops.dspbase import filt, optimal_os_nfft
from .ops.lpc import lpc
from .ops.periodograms import power, spectrogram, welch_pgram
from .utils import profiling
from .utils.device import check_full_f32, no_tf32, resolve_device

__all__ = ["main", "run", "weak_scaling", "CONFIGS"]

# bench.py's bounds on each witness's max|d| / max|ref| against its
# float64 oracle (bench.py:134-143), ~100x above a correct float32
# kernel's error
_WITNESS_TOL = {
    "fir_127tap": 3e-5,
    "os_4096tap_16ch": 3e-5,
    "welch_1024_64ch": 3e-5,
    "spectrogram_1024_64ch": 3e-5,
    "resample_147_160": 3e-5,
    "resample_arb_0p9997": 3e-5,
    "filtfilt_butter8": 1e-4,   # IIR recurrence accumulates f32 error
    "lpc16_levinson": 1e-4,     # order-16 recursion on f32 autocorr
}


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Part:
    """One timed call of a config: call() computes it on the config's
    device-resident inputs. nbytes: the bytes the function must move
    (each input read once, each output written once); flops: the
    operations it needs (bench.py's algorithmic minimum)."""
    label: str
    call: object
    nbytes: float
    flops: float


@dataclasses.dataclass
class Config:
    """A BASELINE config: its parts, the samples one run of `record`'s
    parts filters (bench.py's count), its host inputs, witness(outs)
    ({part label: output} -> {witness: max|d| / max|ref|}),
    cpu_seconds(), scipy's time for the same work on the host's CPU, and
    bench.py's other rates of it, {extra key: (part label, items a
    call)}."""
    name: str
    nsamples: int
    parts: list
    data: dict
    witness: object
    cpu_seconds: object
    record: tuple = None      # labels whose times count; None: all
    rates: dict = dataclasses.field(default_factory=dict)


def _cpu_time(fn, reps=3):
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _rel_err(dev_vals, oracle_vals):
    o = np.asarray(oracle_vals, np.float64)
    d = np.asarray(dev_vals, np.float64)
    return float(np.max(np.abs(d - o)) / max(float(np.max(np.abs(o))),
                                              1e-300))


def _gather(y, idx):
    """y.ravel()[idx] (idx host ints), gathered on y's device, as numpy."""
    i = torch.as_tensor(np.asarray(idx, np.int64), device=y.device)
    return y.reshape(-1)[i].cpu().numpy()


def _np_levinson(R, p):
    """bench.py's float64 Levinson-Durbin (ops/lpc.py:105 in numpy);
    R (p+1, C) -> a (p, C)."""
    R = np.asarray(R, np.float64)
    k = -R[1] / R[0]
    pred = R[0] * (1 - k * k)
    a = np.zeros((p,) + R.shape[1:])
    a[0] = k
    for m in range(2, p + 1):
        acc = R[m] + np.sum(R[1:m] * a[:m - 1][::-1], axis=0)
        k = -acc / pred
        a[:m - 1] = a[:m - 1] + k * a[:m - 1][::-1]
        a[m - 1] = k
        pred = pred * (1 - k * k)
    return a


# ---------------------------------------------------------------------------
# the five configs (bench.py:289-658), each drawing its data from the
# shared generator in bench.py's order
# ---------------------------------------------------------------------------

def _fir_127tap(dev, scale, rng):
    from scipy import signal as sp
    n = 10_000_000 // scale
    h = sp.firwin(127, 0.25).astype(np.float32)
    x = (np.sin(2 * np.pi * 0.01 * np.arange(n))
         + 0.1 * rng.standard_normal(n)).astype(np.float32)
    hd, xd = torch.as_tensor(h, device=dev), torch.as_tensor(x, device=dev)

    def witness(out):
        idx = np.arange(0, n, max(n // 8192, 1))
        ora = sp.lfilter(h.astype(np.float64), [1.0], x.astype(np.float64))
        return {"fir_127tap": _rel_err(_gather(out["filt"], idx), ora[idx])}

    return Config(
        "fir_127tap", n,
        [Part("filt", lambda: filt(hd, xd), 2 * 4 * n + 4 * 127,
              2.0 * n * 127)],
        dict(h=h, x=x), witness,
        lambda: _cpu_time(lambda: sp.lfilter(h, [1.0], x[: n // 8])) * 8)


def _os_4096tap_16ch(dev, scale, rng):
    from scipy import signal as sp
    nch, n = 16, 10_000_000 // scale
    h = sp.firwin(4096, 0.1).astype(np.float32)
    x = rng.standard_normal((n, nch)).astype(np.float32)
    hd, xd = torch.as_tensor(h, device=dev), torch.as_tensor(x, device=dev)
    # rFFT-based overlap-save: two real transforms of nfft points (2.5 N
    # log2 N each) and the spectrum product per block of nfft - 4095
    # outputs
    nfft = optimal_os_nfft(n, 4096)
    blocks = -(-n // (nfft - 4096 + 1))
    flops = nch * blocks * (5 * nfft * math.log2(nfft) + 6 * nfft)

    def witness(out):
        # 2 of 16 channels (the float64 FFT convolution is the causal
        # filter)
        rsel = np.arange(0, n, max(n // 4096, 1))
        idx = (rsel[:, None] * nch + np.array([0, 1])).ravel()
        ora = sp.oaconvolve(x[:, :2].astype(np.float64),
                            h.astype(np.float64)[:, None], axes=0)[:n]
        return {"os_4096tap_16ch": _rel_err(_gather(out["fftfilt"], idx),
                                            ora[rsel].ravel())}

    return Config(
        "os_4096tap_16ch", n * nch,
        [Part("fftfilt", lambda: fftfilt(hd, xd),
              2 * 4 * n * nch + 4 * 4096, flops)],
        dict(h=h, x=x), witness,
        lambda: _cpu_time(lambda: sp.oaconvolve(
            x[: n // 16], h[:, None], axes=0)) * 16)


def _welch_spectrogram_1024_64ch(dev, scale, rng):
    from scipy import signal as sp
    nch, n = 64, 1_000_000 // scale
    x = rng.standard_normal((n, nch)).astype(np.float32)
    xd = torch.as_tensor(x, device=dev)
    win = np.asarray(windows.hanning(1024)).astype(np.float32)
    nfr = (n - 1024) // 512 + 1
    # a frame: one 1024-point rFFT, the window and |X|^2 with its sum
    flops = nfr * nch * (2.5 * 1024 * 10 + 4 * 1024)

    def witness(out):
        # the whole PSD, and 16 frames of 8 channels of the spectrogram,
        # against the algorithm's definition: sum_k |rfft(win * frame)|^2
        # * wts, one-sided doubling, r = k * sum(win^2)
        win64 = win.astype(np.float64)
        wts = np.full(513, 1.0 / (nfr * float(np.sum(win64 ** 2))))
        wts[1:] *= 2.0
        wts[-1] /= 2.0
        acc = np.zeros((513, nch))
        for c0 in range(0, nch, 8):
            fr = np.lib.stride_tricks.sliding_window_view(
                x[:, c0:c0 + 8].astype(np.float64), 1024, axis=0)[::512]
            F = np.fft.rfft(fr * win64, axis=-1)
            acc[:, c0:c0 + 8] = ((F.real ** 2 + F.imag ** 2).sum(axis=0).T
                                 * wts[:, None])
        err = {"welch_1024_64ch": _rel_err(_gather(
            out["welch"], np.arange(513 * nch)), acc.ravel())}
        fidx = np.linspace(0, nfr - 1, 16).astype(np.int64)
        csel = np.arange(0, nch, 8)
        ora = np.zeros((513, len(fidx), len(csel)))
        for fi, f0 in enumerate(fidx):
            seg = x[f0 * 512: f0 * 512 + 1024, csel].astype(np.float64)
            F = np.fft.rfft(seg * win64[:, None], axis=0)
            ora[:, fi, :] = (F.real ** 2 + F.imag ** 2) * (wts * nfr)[:, None]
        idx = ((np.arange(513)[:, None, None] * nfr + fidx[None, :, None])
               * nch + csel[None, None, :]).ravel()
        err["spectrogram_1024_64ch"] = _rel_err(
            _gather(out["spectrogram"], idx), ora.ravel())
        return err

    def cpu_seconds():
        # an eighth of the stream, as bench.py takes, or less at a scale
        # where an eighth holds no frame
        k = max(1, min(8, n // 1024))
        xs = x[: n // k]
        return k * (_cpu_time(lambda: sp.welch(
            xs, axis=0, nperseg=1024, noverlap=512, window=win))
            + _cpu_time(lambda: sp.spectrogram(
                xs, axis=0, nperseg=1024, noverlap=512, window=win)))

    return Config(
        "welch_spectrogram_1024_64ch", 2 * n * nch,
        [Part("welch", lambda: power(welch_pgram(xd, 1024, 512,
                                                 window=win)),
              4 * (n * nch + 1024 + 513 * nch), flops),
         Part("spectrogram", lambda: power(spectrogram(xd, 1024, 512,
                                                       window=win)),
              4 * (n * nch + 1024 + 513 * nfr * nch), flops)],
        dict(x=x, win=win), witness, cpu_seconds,
        rates={"stft_frames_per_s": ("spectrogram", nfr * nch)})


def _resample_147_160(dev, scale, rng):
    from scipy import signal as sp
    n = 10_000_000 // scale
    x = rng.standard_normal(n).astype(np.float32)
    xd = torch.as_tensor(x, device=dev)
    na = n // 4
    rates = {"resample_147_160": Fraction(147, 160),
             "resample_3_2": Fraction(3, 2), "resample_arb_0p9997": 0.9997}
    taps = {k: np.asarray(resample_filter(r)).astype(np.float32)
            for k, r in rates.items()}
    sfs = {k: FIRFilter(taps[k], r) for k, r in rates.items()}

    def call(label, xs):
        # bench.py's poly_dev: the same filter, reset, then filt
        def run():
            sfs[label].reset()
            return sfs[label].filt(xs)
        return run

    def part(label, xs, m, per_out):
        # per_out: operations an output needs (one bank's dot; the
        # arbitrary rate takes two and the interpolation)
        olen = m * float(rates[label])
        return Part(label, call(label, xs), 4 * (m + olen) + 4 * len(
            taps[label]), per_out * olen)

    karb = sfs["resample_arb_0p9997"].kernel
    parts = [
        part("resample_147_160", xd, n, 2 * len(taps["resample_147_160"])
             / 147),
        part("resample_3_2", xd, n, 2 * len(taps["resample_3_2"]) / 3),
        part("resample_arb_0p9997", xd[:na], na, 4 * karb.taps_per_phi + 2)]

    def witness(out):
        # the kernels' own host plans evaluated in float64
        sf = sfs["resample_147_160"]
        sf.reset()
        e_idx, p_idx, olen = sf.kernel.plan(n)
        tpp, hist = sf.kernel.taps_per_phi, sf.kernel.history_len
        sel = np.arange(0, olen, max(olen // 8192, 1))
        xcat = np.concatenate([np.zeros(hist), x.astype(np.float64)])
        e0 = hist + e_idx[sel] - 1
        wins = xcat[e0[:, None] + np.arange(-tpp + 1, 1)[None, :]]
        pfb = taps2pfb(taps["resample_147_160"].astype(np.float64), 147)
        ora = np.sum(wins * pfb[:, p_idx[sel]].T, axis=1)
        err = {"resample_147_160": _rel_err(
            _gather(out["resample_147_160"], sel), ora)}
        sf = sfs["resample_arb_0p9997"]
        sf.reset()
        (x_idx, phi, _), alpha, olen = sf.kernel.plan(na)
        tpp, hist = sf.kernel.taps_per_phi, sf.kernel.history_len
        sel = np.arange(0, olen, max(olen // 8192, 1))
        xcat = np.concatenate([np.zeros(hist), x[:na].astype(np.float64)])
        e0 = hist + x_idx[sel] - 1
        wins = xcat[e0[:, None] + np.arange(-tpp + 1, 1)[None, :]]
        h64 = taps["resample_arb_0p9997"].astype(np.float64)
        pfb = taps2pfb(h64, sf.kernel.nphi)
        dpfb = taps2pfb(np.append(np.diff(h64), 0.0), sf.kernel.nphi)
        ora = (np.sum(wins * pfb[:, phi[sel]].T, axis=1)
               + alpha[sel] * np.sum(wins * dpfb[:, phi[sel]].T, axis=1))
        err["resample_arb_0p9997"] = _rel_err(
            _gather(out["resample_arb_0p9997"], sel), ora)
        return err

    return Config(
        "resample_147_160", n, parts, dict(x=x, taps=taps), witness,
        lambda: _cpu_time(lambda: sp.resample_poly(x[: n // 8], 147,
                                                   160)) * 8,
        record=("resample_147_160",),
        rates={"resample_3_2_msps": ("resample_3_2", n / 1e6),
               "resample_arb_0p9997_msps": ("resample_arb_0p9997",
                                            na / 1e6)})


def _filtfilt_lpc16(dev, scale, rng):
    from scipy import signal as sp
    n = 1_000_000 // scale
    x = rng.standard_normal(n).astype(np.float32)
    f = as_sos(digitalfilter(Lowpass(0.2), Butterworth(8)))
    sos = f.sos_array()
    nsec = sos.shape[0]
    sos_sp = np.column_stack([sos[:, :3], np.ones((nsec, 1)), sos[:, 3:]])
    # speech-frame LPC: 25 ms frames at 16 kHz (400 samples), order 16
    flen, p = 400, 16
    nfr = n // flen
    frames = x[: nfr * flen].reshape(nfr, flen).T.copy()     # (flen, nfr)
    xd = torch.as_tensor(x, device=dev)
    fd = torch.as_tensor(frames, device=dev)

    def witness(out):
        # odd extension, the steady-state initial conditions and two
        # scipy sosfilt passes in float64 (filt.jl:261-360 semantics)
        pad = min(6 * nsec, n - 1)
        x64 = x.astype(np.float64)
        ext = np.concatenate([2 * x64[0] - x64[pad:0:-1], x64,
                              2 * x64[-1] - x64[-2:-pad - 2:-1]])
        zi = np.swapaxes(np.asarray(filt_stepstate_sos(
            np.asarray(sos, np.float64))), 0, 1)
        y1, _ = sp.sosfilt(sos_sp, ext, zi=zi * ext[0])
        y1r = (y1 * f.g)[::-1]
        y2, _ = sp.sosfilt(sos_sp, y1r, zi=zi * y1r[0])
        ora = (y2 * f.g)[::-1][pad: pad + n]
        sel = np.arange(0, n, max(n // 8192, 1))
        err = {"filtfilt_butter8": _rel_err(_gather(out["filtfilt"], sel),
                                            ora[sel])}
        fsel = np.arange(0, nfr, max(nfr // 32, 1))
        fr64 = frames[:, fsel].astype(np.float64)
        R = np.stack([np.sum(fr64[: flen - k] * fr64[k:], axis=0) / flen
                      for k in range(p + 1)], axis=0)
        idx = (np.arange(p)[:, None] * nfr + fsel[None, :]).ravel()
        err["lpc16_levinson"] = _rel_err(_gather(out["lpc"][0], idx),
                                         _np_levinson(R, p).ravel())
        return err

    def cpu_seconds():
        def cpu_lpc():
            fr = frames[:, : nfr // 8]
            for i in range(fr.shape[1]):
                c = np.correlate(fr[:, i], fr[:, i], "full")[
                    flen - 1: flen + p]
                np.linalg.solve(np.array([[c[abs(j - k)] for k in range(p)]
                                          for j in range(p)]), -c[1:p + 1])
        sos_g = sos_sp.copy()
        sos_g[0, :3] *= f.g
        xs = x[: n // 8]
        return 8 * (_cpu_time(lambda: sp.sosfiltfilt(sos_g, xs))
                    + _cpu_time(cpu_lpc, reps=1))

    return Config(
        "filtfilt_lpc16", n + nfr * flen,
        [Part("filtfilt", lambda: filtfilt(f, xd), 2 * 4 * n,
              2 * nsec * 9 * n),
         # the p + 1 biased lags by direct sums (ops/lpc.py's
         # _biased_lags) and the order-16 recursion
         Part("lpc", lambda: lpc(fd, p, method="levinson"),
              4 * (flen * nfr + (p + 1) * nfr),
              nfr * (2 * (p + 1) * flen + 4 * p * p))],
        dict(x=x, frames=frames), witness, cpu_seconds)


CONFIGS = {"fir_127tap": _fir_127tap,
           "os_4096tap_16ch": _os_4096tap_16ch,
           "welch_spectrogram_1024_64ch": _welch_spectrogram_1024_64ch,
           "resample_147_160": _resample_147_160,
           "filtfilt_lpc16": _filtfilt_lpc16}


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

# calls timed, and calls profiled, of each part
REPS = 10


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _call_ms(fn, dev):
    """(median, min, max) ms of REPS calls after one warm-up call: CUDA
    events around each call on the card, the host clock on the CPU."""
    fn()
    _sync(dev)
    ts = []
    for _ in range(REPS):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), min(ts), max(ts)


def _measure(cfg, dev):
    """Run and time each part of cfg; returns ({label: output}, {label:
    detail})."""
    roof = profiling.Roofline()
    outs, detail = {}, {}
    for p in cfg.parts:
        kernels.reset_launches()
        _sync(dev)
        outs[p.label] = p.call()
        _sync(dev)
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        med, lo, hi = _call_ms(p.call, dev)
        tb, tf = p.nbytes / roof.hbm_bw, p.flops / roof.peak_flops
        d = {"call_ms": med, "call_ms_min": lo, "call_ms_max": hi,
             "clock": "cuda events" if dev.type == "cuda" else "host",
             "launches": launches, "bytes": p.nbytes, "flops": p.flops,
             "bound_ms": max(tb, tf) * 1e3,
             "bound_by": "bytes" if tb >= tf else "operations"}
        if dev.type == "cuda":
            by = profiling.device_by_kernel(p.call, calls=REPS, log=_log)
            dev_ms = sum(v[0] for v in by.values())
            d.update(device_ms=dev_ms, idle_share=1 - dev_ms / med,
                     device_by_kernel={k: v[0] for k, v in by.items()},
                     **roof.fractions(med / 1e3, min_bytes=p.nbytes,
                                      flops=p.flops))
        detail[p.label] = d
        _log(f"  {cfg.name}/{p.label}: " + ", ".join(
            f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in d.items() if k != "device_by_kernel"))
    return outs, detail


def _card_line():
    """The card's nvidia-smi name and power limit line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def run(device="cuda", scale=1):
    """The BASELINE configs of CONFIGS on `device` at 1/scale of their
    lengths; returns (the JSON record, the list of what failed: configs
    that raised, witnesses past their tolerance). Raises if `device` is
    "cuda" and there is no card."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    card = _card_line() if cuda else "cpu"
    if cuda:
        check_full_f32()
        _log(f"card (nvidia-smi name, power.limit): {card}")
    rng = np.random.default_rng(1776)
    sps, ratios, werr, detail, rates = {}, {}, {}, {}, {}
    failed = []
    with no_tf32():
        for name, make in CONFIGS.items():
            try:
                cfg = make(dev, scale, rng)
                outs, detail[name] = _measure(cfg, dev)
                werr.update(cfg.witness(outs))
                del outs
                t = sum(detail[name][k]["call_ms"]
                        for k in (cfg.record or detail[name])) / 1e3
                sps[name] = cfg.nsamples / t
                ratios[name] = sps[name] * cfg.cpu_seconds() / cfg.nsamples
                _log(f"{name}: {sps[name] / 1e6:.1f} MS/s (vs scipy "
                     f"x{ratios[name]:.2f})")
                for key, (label, items) in cfg.rates.items():
                    rates[key] = items / (detail[name][label]["call_ms"]
                                          / 1e3)
            except Exception as e:
                _log(f"CONFIG FAILED {name}: {type(e).__name__}: "
                     f"{str(e)[:300]}")
                _log(traceback.format_exc())
                failed.append(name)
            finally:
                if cuda:
                    torch.cuda.empty_cache()
    bad = {k: v for k, v in werr.items() if not v <= _WITNESS_TOL[k]}
    for k, v in werr.items():
        _log(f"witness {k}: max rel err vs f64 oracle {v:.2e} (tol "
             f"{_WITNESS_TOL[k]:.0e})" + (" FAIL" if k in bad else ""))

    def geomean(v):
        return (math.exp(sum(math.log(a) for a in v.values()) / len(v))
                if v else None)
    extra = {"device": str(dev), "card": card, "scale": scale, "reps": REPS,
             "configs": sps, "err": werr, "numerics_ok": not bad,
             "failed_configs": failed, **rates, "detail": detail}
    record = {
        "metric": "filtered samples/s/chip (geomean: FIR, overlap-save, "
                  "Welch+spectrogram, polyphase resample, filtfilt+LPC); "
                  "STFT frames/s/chip in extra.stft_frames_per_s",
        "value": geomean(sps),
        "unit": "samples/s",
        "vs_baseline": geomean(ratios),
        "extra": extra}
    return record, failed + [f"witness {k}" for k in bad]


# ---------------------------------------------------------------------------
# weak scaling (bench.py:686-1037)
# ---------------------------------------------------------------------------

# the most rows a rank holds in the sharded-equals-unsharded check
# (bench.py's n_chk, seed 7), and the channels of both phases
_CHECK_N, _NCH = 65536, 64


def _chain_ops():
    """bench.py's weak-scaling filters and ops: (FIR taps, scipy's
    Butterworth(8) sections, the Hanning window, the 3/2 resampling
    taps, {name: fn(x, mesh)} on a ('channel', 'time') mesh of (1, h))."""
    from scipy import signal as sp
    from .parallel import (shard_filtfilt, shard_fir, shard_resample,
                           shard_sosfilt, shard_welch)
    b = sp.firwin(127, 0.25).astype(np.float32)
    sos_sp = sp.butter(8, 0.2, output="sos")
    sos = np.column_stack([sos_sp[:, :3], sos_sp[:, 4:]])
    win = np.asarray(windows.hanning(1024)).astype(np.float32)
    h_rs = np.asarray(resample_filter(Fraction(3, 2))).astype(np.float32)
    sos_ff, g_ff = sos_arrays(as_sos(digitalfilter(Lowpass(0.2),
                                                   Butterworth(8))))
    return b, sos_sp, win, h_rs, {
        "fir": lambda x, m: shard_fir(b, x, m),
        "sosfilt": lambda x, m: shard_sosfilt(sos, 1.0, x, m),
        "welch": lambda x, m: shard_welch(x, 1024, 512, win, m)[0],
        "filtfilt": lambda x, m: shard_filtfilt(sos_ff, g_ff, x, m),
        "resample": lambda x, m: shard_resample(h_rs, Fraction(3, 2), x,
                                                m)}


def _weak_rank(n_local, n_check, mesh=None):
    """One rank of the weak-scaling run (HostPool.run with mesh=(1, h)):
    the sharded ops against the unsharded ones on this rank's rows of an
    (n_check h, 64) signal, then the best of 3 host-clock times of each
    op, and of the fir -> sosfilt -> welch chain, on this rank's own
    (n_local, 64) block (seed 100 + rank), every rank starting each run
    at a barrier. Returns its times in s and its errors."""
    import torch.distributed as dist
    from scipy import signal as sp
    from .parallel import compact_shards, shard_time
    from .parallel.ops import _as_dtensor
    rank, h = dist.get_rank(), dist.get_world_size()
    if hasattr(os, "sched_setaffinity"):
        # constant resources per host: one core each, as bench.py pins
        # its hosts with taskset
        cores = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, {cores[rank % len(cores)]})
    b, sos_sp, win, h_rs, ops = _chain_ops()

    def chain(x):
        y = ops["sosfilt"](ops["fir"](x, mesh), mesh)
        return ops["welch"](y, mesh)

    def local(y):
        return y.to_local() if hasattr(y, "to_local") else y

    def rel(got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        return float(np.max(np.abs(got - want)) / max(
            float(np.max(np.abs(want))), 1e-9))

    # sharded == unsharded, each rank on its own rows
    x_np = np.random.default_rng(7).standard_normal(
        (n_check * h, _NCH)).astype(np.float32)
    xg = shard_time(x_np, mesh)
    lo, hi = rank * n_check, (rank + 1) * n_check
    y_ref = sp.sosfilt(sos_sp, sp.lfilter(b, [1.0], x_np, axis=0), axis=0)
    psd_ref = power(welch_pgram(torch.as_tensor(y_ref.astype(np.float32)),
                                1024, 512, window=win))
    errs = {"chain": rel(local(chain(xg)), psd_ref)}
    ff = filtfilt(as_sos(digitalfilter(Lowpass(0.2), Butterworth(8))),
                  torch.as_tensor(x_np))
    errs["filtfilt"] = rel(local(ops["filtfilt"](xg, mesh)), ff[lo:hi])
    rs = FIRFilter(h_rs, Fraction(3, 2)).filt(torch.as_tensor(x_np))
    errs["resample"] = rel(compact_shards(*ops["resample"](
        xg, mesh)).full_tensor(), rs)
    if not (errs["chain"] < 1e-5 and errs["filtfilt"] < 1e-4
            and errs["resample"] < 1e-5):
        raise AssertionError(f"rank {rank}: sharded != unsharded: {errs}")

    # weak scaling: each rank its own n_local rows
    xl = torch.as_tensor(np.random.default_rng(100 + rank).standard_normal(
        (n_local, _NCH)).astype(np.float32))
    xg = _as_dtensor(xl, mesh, {"time": 0}, (n_local * h, _NCH))

    def best(fn):
        fn(xg)
        t = math.inf
        for _ in range(3):
            dist.barrier()
            t0 = time.perf_counter()
            fn(xg)
            t = min(t, time.perf_counter() - t0)
        return t
    per_op = {k: best(lambda x, f=f: f(x, mesh)) for k, f in ops.items()}
    t = best(chain)
    return {"t": t, "t_ext": t + per_op["filtfilt"] + per_op["resample"],
            "per_op": per_op, "errs": errs}


def weak_scaling(max_hosts, n=1_000_000):
    """bench.py's weak-scaling mode on h = 1..max_hosts gloo ranks on the
    CPU (each n x 64 samples, and min(65,536, n) x 64 in the check that
    the sharded ops equal the unsharded ones); returns its JSON record.
    Efficiency is parallel.weak_scaling_efficiency of the aggregate
    rates, for the chain and for the chain plus filtfilt and resample. A host-clock
    measurement of CPU processes: no device figure."""
    from .parallel import simulate_hosts, weak_scaling_efficiency
    ncores = (len(os.sched_getaffinity(0))
              if hasattr(os, "sched_getaffinity") else os.cpu_count())
    if max_hosts > ncores:
        _log(f"warning: {max_hosts} hosts > {ncores} cores: the hosts "
             "contend for cores and the efficiency says little")
    n_check = min(_CHECK_N, n)
    rates, rates_ext, per_op, errs = {}, {}, {}, {}
    for h in range(1, max_hosts + 1):
        with simulate_hosts(h) as pool:
            recs = pool.run(_weak_rank, n, n_check, mesh=(1, h))
        t = max(r["t"] for r in recs)     # the ranks finish together
        rates[h] = h * n * _NCH / t
        rates_ext[h] = h * n * _NCH / max(r["t_ext"] for r in recs)
        per_op[h] = {k: max(r["per_op"][k] for r in recs) * 1e3
                     for k in recs[0]["per_op"]}
        errs[h] = max(max(r["errs"].values()) for r in recs)
        _log(f"hosts={h}: {rates[h] / 1e6:.1f} MS/s aggregate (chain "
             f"{t * 1e3:.1f} ms, max sharded-vs-unsharded rel err "
             f"{errs[h]:.2e}; per-op ms "
             + ", ".join(f"{k} {v:.1f}" for k, v in per_op[h].items())
             + ")")
    eff = weak_scaling_efficiency(rates)
    eff_ext = weak_scaling_efficiency(rates_ext)
    for h in eff:
        _log(f"weak-scaling efficiency {h} hosts: {100 * eff[h]:.1f}% "
             f"(with filtfilt and resample: {100 * eff_ext[h]:.1f}%)")
    return {
        "metric": f"weak scaling efficiency {max_hosts} hosts (64ch "
                  "FIR+SOS+Welch chain, torch.distributed gloo ranks on "
                  "the CPU, host clock)",
        "value": eff[max_hosts],
        "unit": "efficiency",
        "vs_baseline": eff[max_hosts] / 0.85,
        "extra": {"aggregate_sps": {str(k): v for k, v in rates.items()},
                  "efficiency": {str(k): v for k, v in eff.items()},
                  "efficiency_extended_pipeline":
                      {str(k): v for k, v in eff_ext.items()},
                  "per_op_ms": {str(k): v for k, v in per_op.items()},
                  "n_local": n, "n_check": n_check, "cores": ncores,
                  "max_rel_err_vs_unsharded": {str(k): v
                                               for k, v in errs.items()}}}


def main(argv=None):
    """The command line (bench_torch.py); returns the exit code."""
    ap = argparse.ArgumentParser(prog="bench_torch.py", description=(
        "dsptpu's bench.py on the port: the five BASELINE configs with "
        "their float64 witnesses, or the weak-scaling mode"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--scale", type=int, default=1,
                    help="run every config this many times shorter")
    ap.add_argument("--hosts", type=int, nargs="+", metavar=("N", "n"),
                    help="weak scaling on 1..N gloo ranks of n x 64 "
                         "samples each (n 1,000,000 by default)")
    args = ap.parse_args(argv)
    if args.hosts:
        if len(args.hosts) > 2:
            ap.error("--hosts takes N and at most one n")
        print(json.dumps(weak_scaling(*args.hosts)), flush=True)
        return 0
    try:
        record, failed = run(args.device, args.scale)
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        _log(f"bench: {type(e).__name__}: {e}")
        return 1
    print(json.dumps(record), flush=True)
    if failed:
        _log(f"bench FAILED: {failed}")
        return 1
    return 0
