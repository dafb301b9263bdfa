"""The flagship chain on torch tensors: the port's counterpart of
dsptpu's __graft_entry__.entry; and the drivers of the other paths
(fftfilt_entry, filtfilt_lpc_entry, resample_entry, multitaper_entry).

    filt(b, x)  (127-tap FIR, K1) -> sosfilt(sos, y)  (SOS cascade, K2)
    -> welch_pgram + stft(psdonly=True)  (K3) -> power

Each entry's forward runs inside span("entry") (utils.profiling), the
root of its call's spans when tracing is on; filtfilt_lpc_entry's
forward also puts its frames' copy in span("frames"). The ops and the
kernel wrappers open their own spans below.

`sharded_entry()` runs dsptpu's multi-chip chain (bench.py's
weak-scaling pipeline, shard_fir -> shard_sosfilt -> shard_welch) on a
DeviceMesh of every rank; `dryrun_multichip(n)` holds the sharded ops
against the unsharded ones on n simulated hosts (gloo ranks on the CPU).

`entry()` defaults to the full-width configuration, the 64-channel
stream of dsptpu's BASELINE.json (bench.py's welch/spectrogram config
and weak-scaling pipeline): x (1,000,000 x 64) float32, the 127-tap
Lowpass(0.25) Hamming FIR, Butterworth(8) at 0.2 as 4 sections, and
nfft 1024 with hop 512 and a Hanning window (1952 frames). At this size
every kernel gate of the reference holds. The reference entry's own
configuration is entry(n=16384, channels=4, order=6, cutoff=0.3,
nfft=256); it is too short for the FIR kernel (n < 32768).

As in the reference entry, the cascade is passed as its (nsec, 5)
float32 section array, so sosfilt applies gain 1 (the design's overall
gain g is not applied). The sections and the window stay host numpy
arrays: they are design-time constants that the routing reads on the
host, and a device copy would have to be read back, which waits for the
stream.
"""

from fractions import Fraction

import numpy as np
import torch

from .filters import (Butterworth, FIRWindow, Lowpass, as_sos, digitalfilter,
                      resample_filter)
from .filters.filt import fftfilt, filtfilt, sosfilt
from .ops import windows
from .ops.dspbase import filt
from .ops.lpc import lpc
from .filters.stream_filt import FIRFilter
from .ops.multitaper import (MTCoherenceConfig, MTConfig,
                             MTSpectrogramConfig, mt_coherence,
                             mt_spectrogram)
from .ops.periodograms import power, stft, welch_pgram
from .utils.device import check_full_f32, resolve_device
from .utils.profiling import span

__all__ = ["entry", "chain_params", "fftfilt_entry", "fftfilt_taps",
           "filtfilt_lpc_entry", "resample_entry", "RESAMPLE_RATES",
           "multitaper_entry", "MT_NFFT", "MT_OVERLAP", "MT_NW", "MT_NTAPERS",
           "sharded_entry", "dryrun_multichip"]


def chain_params(order=8, cutoff=0.2, nfft=1024):
    """Host float32 parameters of the chain: (taps (127,), sos (nsec, 5),
    window (nfft,))."""
    taps = np.asarray(digitalfilter(Lowpass(0.25), FIRWindow.create(
        np.asarray(windows.hamming(127)))), dtype=np.float32)
    sos = as_sos(digitalfilter(Lowpass(cutoff), Butterworth(order)))
    win = np.asarray(windows.hanning(nfft)).astype(np.float32)
    return taps, sos.sos_array().astype(np.float32), win


def entry(device="cuda", n=1_000_000, channels=64, order=8, cutoff=0.2,
          nfft=1024):
    """(forward, (x,)): forward(x) maps x (n, channels) to
    (psd (nfft//2+1, channels), stft power (nfft//2+1, frames, channels));
    x is standard normal float32 from numpy seed 0, on `device`
    (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        check_full_f32()
    taps, sos, win = chain_params(order, cutoff, nfft)
    taps = torch.as_tensor(taps, device=dev)

    def forward(x):
        """x: (n, channels) -> (psd, stft_power), in x's dtype."""
        with span("entry"):
            y = filt(taps, x)
            y = sosfilt(sos, y)
            p = welch_pgram(y, nfft, nfft // 2, window=win)
            s = stft(y, nfft, nfft // 2, window=win, psdonly=True)
            return power(p), s

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((n, channels)).astype(np.float32),
                        device=dev)
    return forward, (x,)


def _stream(dev, n, channels):
    """x (n, channels): standard normal float32 from numpy seed 0."""
    rng = np.random.default_rng(0)
    return torch.as_tensor(rng.standard_normal((n, channels)).astype(
        np.float32), device=dev)


def fftfilt_taps(taps=4096):
    """Host float32 taps of path A: the Lowpass(0.1) Hamming FIR."""
    return np.asarray(digitalfilter(Lowpass(0.1), FIRWindow.create(
        np.asarray(windows.hamming(taps)))), dtype=np.float32)


def fftfilt_entry(device="cuda", n=10_000_000, channels=16, taps=4096):
    """(forward, (x,)): forward(x) = fftfilt(h, x), (n, channels), with
    h = fftfilt_taps(taps) on `device`."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        check_full_f32()
    h = torch.as_tensor(fftfilt_taps(taps), device=dev)

    def forward(x):
        """x: (n, channels) -> fftfilt(h, x), in x's dtype."""
        with span("entry"):
            return fftfilt(h, x)

    return forward, (_stream(dev, n, channels),)


def filtfilt_lpc_entry(device="cuda", n=1_000_000, channels=64, order=8,
                       cutoff=0.2, lpc_order=16, flen=400):
    """(forward, (x,)): forward(x) maps x (n, channels) to
    (filtfilt(f, x) (n, channels), (a (lpc_order, nfr), err (nfr,))),
    f the Butterworth(order) lowpass at `cutoff` as sections with its
    gain, and the LPC of the nfr = n // flen frames of flen samples of
    channel 0 of x, as columns of an (flen, nfr) matrix."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        check_full_f32()
    f = as_sos(digitalfilter(Lowpass(cutoff), Butterworth(order)))
    nfr = n // flen

    def forward(x):
        """x: (n, channels) -> (y, (a, err)), in x's dtype."""
        with span("entry"):
            y = filtfilt(f, x)
            # one copy of the frames, as bench.py makes them (.T.copy()):
            # the lag sums then read 4 MB contiguously, not a strided
            # column
            with span("frames"):
                frames = x[: nfr * flen, 0].reshape(nfr, flen).T.contiguous()
            return y, lpc(frames, lpc_order, method="levinson")

    return forward, (_stream(dev, n, channels),)


# path C's rates: 44.1 kHz -> 48 kHz, 3/2 and a clock-drift correction
RESAMPLE_RATES = (Fraction(147, 160), Fraction(3, 2), 0.9997)


def resample_entry(device="cuda", n=10_000_000, arb_n=2_500_000):
    """(forward, (x,)): forward(x) maps the 1-D stream x (n,) to
    (y_147_160, y_3_2, y_arb), x resampled by the streaming polyphase
    FIRFilter at each rate of RESAMPLE_RATES with the float32 taps of
    resample_filter(rate); the arbitrary rate 0.9997 (32-phase dual PFB)
    takes x[:arb_n]. As bench.py's config 4 does, forward holds one
    FIRFilter per rate and calls reset() then filt() on each call, so
    host plans are cached across calls. x is standard normal float32
    from numpy seed 0, on `device` (CUDA unless the caller asks for the
    CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        check_full_f32()
    fs = [FIRFilter(np.asarray(resample_filter(r), dtype=np.float32), r)
          for r in RESAMPLE_RATES]

    def forward(x):
        """x: (n,) -> one output per rate, in x's dtype."""
        with span("entry"):
            out = []
            for f, xs in zip(fs, (x, x, x[:arb_n])):
                f.reset()
                out.append(f.filt(xs))
            return tuple(out)

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal(n).astype(np.float32),
                        device=dev)
    return forward, (x,)


# path D's multitaper geometry: BASELINE config 3's frames (nfft 1024,
# hop 512) with 7 DPSS tapers of half-bandwidth 4
MT_NFFT, MT_OVERLAP, MT_NW, MT_NTAPERS = 1024, 512, 4, 7


def multitaper_entry(device="cuda", n=1_000_000, channels=64, coh_n=16384):
    """(forward, (x,)): forward(x) maps x (n, channels) to
    (mt_spectrogram power (MT_NFFT//2+1, frames, channels), mt_coherence
    (channels, channels, coh_n//2+1)). The spectrogram takes frames of
    MT_NFFT samples overlapping by MT_OVERLAP (1952 frames at the default
    n) with MT_NTAPERS DPSS tapers of half-bandwidth MT_NW, uniformly
    weighted, fs 1 (K3's K-window stack); the coherence takes the first
    coh_n samples as a channel-major (channels, coh_n) matrix with the
    same tapers, nfft coh_n. x is standard normal float32 from numpy
    seed 0, on `device` (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        check_full_f32()
    spec_cfg = MTSpectrogramConfig.create(
        n, n_overlap_samples=MT_OVERLAP, mt_config=MTConfig.create(
            MT_NFFT, nfft=MT_NFFT, nw=MT_NW, ntapers=MT_NTAPERS))
    coh_cfg = MTCoherenceConfig.create(channels, mt_config=MTConfig.create(
        coh_n, nfft=coh_n, nw=MT_NW, ntapers=MT_NTAPERS))

    def forward(x):
        """x: (n, channels) -> (spectrogram power, coherence), in x's
        dtype."""
        with span("entry"):
            p = mt_spectrogram(x, config=spec_cfg).power
            return p, mt_coherence(x[:coh_n].T, config=coh_cfg).coherence

    return forward, (_stream(dev, n, channels),)


def sharded_entry(mesh=None, device="cuda", n=1_000_000, channels=64):
    """(forward, (x,)): dsptpu's multi-chip chain (bench.py's weak-scaling
    pipeline) on `mesh` (default: make_mesh() over every rank, started
    with one rank if no process group exists, on `device`). forward(x)
    maps x (n, channels) to the Welch PSD (nfft//2+1, channels),
    replicated over the mesh's time axis:

        shard_fir (127-tap Lowpass(0.25) Hamming) -> shard_sosfilt
        (Butterworth(8) at 0.2 as 4 sections, gain 1) -> shard_welch
        (nfft 1024, hop 512, Hanning)

    the taps, sections and window of entry(), whose chain up to Welch it
    equals. x is this rank's block of the standard normal float32 stream
    of numpy seed 0 (entry()'s x), as a DTensor sharded along time: the
    counterpart of the global array bench.py assembles from each host's
    block."""
    from .parallel import (make_mesh, shard_fir, shard_sosfilt, shard_time,
                           shard_welch)
    if mesh is None:
        mesh = make_mesh(device_type=resolve_device(device).type)
    if mesh.device_type == "cuda":
        check_full_f32()
    taps, sos, win = chain_params()
    nfft = win.shape[0]
    taps = torch.as_tensor(taps, device=mesh.device_type)

    def forward(x):
        """x: (n, channels) -> psd (nfft//2+1, channels), in x's dtype."""
        with span("entry"):
            y = shard_fir(taps, x, mesh)
            y = shard_sosfilt(sos, 1.0, y, mesh)
            return shard_welch(y, nfft, nfft // 2, win, mesh)[0]

    rng = np.random.default_rng(0)
    x = shard_time(rng.standard_normal((n, channels)).astype(np.float32),
                   mesh)
    return forward, (x,)


def _max_err(name, got, want, atol):
    """max |got - want| of a sharded result (its full value) against the
    unsharded one; raises past atol."""
    from torch.distributed.tensor import DTensor
    if isinstance(got, DTensor):
        got = got.full_tensor()
    got, want = got.double(), want.double()
    if got.shape != want.shape:
        raise AssertionError(f"sharded {name}: shape {tuple(got.shape)}, "
                             f"unsharded {tuple(want.shape)}")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not err <= atol:
        raise AssertionError(f"sharded {name} != unsharded: max|d| {err:.3e}"
                             f" > {atol:.0e}")
    return err


def _dryrun_witnesses(mesh):
    """dryrun_multichip's step on one rank: the sharded fir + sosfilt +
    welch chain, spectrogram, resample through compact_shards and
    filtfilt, each against the unsharded op on the whole signal (tiny
    shapes: 128 samples a time shard), and sharded_entry's chain against
    entry()'s. Returns {name: max|d|}."""
    from .filters import Biquad, SecondOrderSections, resample_filter
    from .ops.periodograms import spectrogram
    from .parallel import (compact_shards, shard_filtfilt, shard_fir,
                           shard_resample, shard_sosfilt, shard_spectrogram,
                           shard_time, shard_welch)
    ntime = mesh.size(mesh.mesh_dim_names.index("time"))
    nch = mesh.size(mesh.mesh_dim_names.index("channel"))
    n, nchan, nseg, hop = 128 * ntime, 2 * nch, 32, 16
    rng = np.random.default_rng(0)
    x_np = rng.standard_normal((n, nchan)).astype(np.float32)
    b = np.asarray(digitalfilter(Lowpass(0.3), FIRWindow.create(
        np.asarray(windows.hamming(17)))), dtype=np.float32)
    sos = np.asarray([[0.2, 0.1, 0.05, -0.3, 0.2],
                      [0.15, 0.05, 0.02, -0.1, 0.05]], np.float32)
    win = np.asarray(windows.hanning(nseg)).astype(np.float32)
    dev = torch.device(mesh.device_type)
    x = torch.as_tensor(x_np, device=dev)
    xs = shard_time(x_np, mesh, channel_axis="channel")
    errs = {}

    y = shard_fir(b, xs, mesh, channel_axis="channel")
    y = shard_sosfilt(sos, 1.0, y, mesh, channel_axis="channel")
    psd, _ = shard_welch(y, nseg, nseg - hop, win, mesh,
                         channel_axis="channel")
    y_ref = sosfilt(sos, filt(torch.as_tensor(b, device=dev), x))
    psd_ref = power(welch_pgram(y_ref, nseg, nseg - hop, window=win))
    errs["fir+sosfilt+welch"] = _max_err("fir+sosfilt+welch", psd, psd_ref,
                                         1e-4)

    pw, _, _ = shard_spectrogram(x, nseg, hop, win, mesh,
                                 channel_axis="channel")
    ref = spectrogram(x, nseg, nseg - hop, window=win).power
    pw = pw.full_tensor()
    k = ref.shape[1]
    if pw[k:].abs().max() != 0:
        raise AssertionError("sharded spectrogram: non-zero masked rows")
    errs["spectrogram"] = _max_err("spectrogram", pw[:k], ref.movedim(0, 1),
                                   1e-4)

    ratio = Fraction(3, 2)
    h = np.asarray(resample_filter(ratio)).astype(np.float32)
    yr, cnt = shard_resample(h, ratio, xs, mesh, channel_axis="channel")
    errs["resample"] = _max_err("resample", compact_shards(yr, cnt),
                                FIRFilter(h, ratio).filt(x), 1e-5)

    yz = shard_filtfilt(sos, 1.0, xs, mesh, channel_axis="channel")
    sos_obj = SecondOrderSections([Biquad(*row) for row in
                                   np.asarray(sos, np.float64)])
    errs["filtfilt"] = _max_err("filtfilt", yz, filtfilt(sos_obj, x), 1e-4)

    # sharded_entry's chain (nfft 1024) against entry()'s, at 1024
    # samples a time shard, relative to the PSD's largest bin
    fwd, (xe,) = sharded_entry(mesh, n=1024 * ntime, channels=nchan)
    ref, _ = entry(device=mesh.device_type, n=1024 * ntime,
                   channels=nchan)[0](xe.full_tensor())
    top = ref.abs().max()
    errs["sharded_entry"] = _max_err("sharded_entry", fwd(xe) / top,
                                     ref / top, 3e-5)
    return errs


def dryrun_multichip(n_devices):
    """The counterpart of dsptpu's __graft_entry__.dryrun_multichip: n
    simulated hosts (gloo ranks on the CPU, parallel.simulate_hosts) on
    a ('channel', 'time') mesh of (2, n/2) for even n > 1, else (1, n),
    run the sharded fir + sosfilt + welch chain, spectrogram, resample
    through compact_shards and filtfilt, each against the unsharded op,
    and sharded_entry's chain against entry()'s; raises on a mismatch.
    Prints and returns {name: max|d|}."""
    from .parallel import simulate_hosts
    nch = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    with simulate_hosts(n_devices) as pool:
        errs = pool.run(_dryrun_witnesses,
                        mesh=(nch, n_devices // nch))[0]
    print(f"dryrun_multichip OK on {n_devices} simulated hosts (mesh "
          f"{nch} x {n_devices // nch}); max|sharded-unsharded|: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    return errs
