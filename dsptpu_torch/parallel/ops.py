"""Sharded DSP ops on a torch DeviceMesh (dsptpu's parallel/ops.py):
time-block sequence parallelism with halo exchange, and channel data
parallelism.

Each op takes its signal as the global tensor (every rank passes the
same one and takes its own block, as dsptpu's shard_map does) or as a
DTensor sharded along axis 0 over the mesh's time axis (shard_time; a
rank holds its torch.chunk block, the last ones shorter or empty), and
returns what dsptpu's out_specs give, as a DTensor: sharded the same way
(a time-sharded result in torch.chunk blocks, so its full_tensor() is
dsptpu's result), replicated over time for shard_welch's PSD, replicated
over the mesh for the cross spectra.

No op gathers the signal whole. Only these cross ranks, on the time
group (mesh.get_group(time_axis)):
  * halos and block moves: one dist.batch_isend_irecv of the rows each
    rank needs from each other rank (_reblock); rank 0's left halo and
    the last rank's right halo are zeros, as dsptpu's `where` makes them;
  * the (2 nsec, C) boundary states of the IIR chains: an all_gather,
    then each rank's exclusive prefix (or suffix) in a fixed order with
    the host T = A^nlocal (_affine_scan), so the result does not
    depend on timing; only rounding order differs from dsptpu's
    log-depth ppermute;
  * spectral sums and one-row broadcasts: all_reduce, as lax.psum.

Locally every op runs the port's own hooks, the ones dsptpu's ops call,
by the gates the unsharded port applies: for the FIR, K1
(kernels/fir.py) where dspbase.filt takes it (real float32, 2-512 taps,
a block of at least 32,768 and 4 nb rows), _conv_os_1d above 512 taps
(K4 where its gate holds), else ops.dspbase._fir_causal (F.conv1d in
full float32); filters.filt._blockss_apply with
need_state (K2 forward with need_state where its gate holds: float32,
p <= 32, n >= 512 per shard; the reverse pass with state flips the
block and takes the same forward pass, where dsptpu mirrors its tables
on the XLA route); torch.fft for the spectra (dsptpu's jnp.fft);
stream_filt._block_matmul for resampling; multitaper._mt_power.

As in the unsharded port, float32 input is computed in float32 (dsptpu
under x64 promotes float32 signals with float64 windows to float64).

Tracing (utils.profiling): each public op runs inside a span of its own
name (shard_fir, shard_welch, ..., compact_shards; shard_time, which
only places a block, has none), and _reblock's work inside
span("shard.reblock") where the layouts differ. Counters, always on:
`shard.reblock.bytes`, the bytes of each block _reblock builds (its own
rows copied and the rows received); `shard.p2p`, `shard.all_reduce` and
`shard.all_gather`, one for each collective call issued (none at world
size 1); `route.shard_fir.k1` (K1), `route.shard_fir.os` (_conv_os_1d)
or `route.shard_fir.direct` (F.conv1d), once a _fir_local call.
Each upload and read-back counts `sync.<site>` inside a span of that
name (utils.device), an upload's bytes `upload.bytes`: on the card the
host waits for the stream there. A warm shard_welch call has three:
`sync.shard_welch.window` (the float64 window's upload) and two
`sync.shard_welch.scale` (the one-sided weights' two host scalars).
"""

from fractions import Fraction

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..utils.device import as_tensor, full_f32, to_host
from ..utils.profiling import count, span, spanned

__all__ = ["shard_fir", "shard_fftfilt", "shard_welch", "shard_sosfilt",
           "shard_filtfilt",
           "shard_stft_pow", "shard_spectrogram", "shard_mt_spectrogram",
           "shard_mt_cross_power_spectra", "shard_mt_coherence",
           "shard_resample", "compact_shards", "shard_time"]


# ---------------------------------------------------------------------------
# the mesh, blocks and placements
# ---------------------------------------------------------------------------

def _axis_size(mesh, axis):
    names = mesh.mesh_dim_names
    return mesh.size(names.index(axis)) if axis in names else 1


def _axis_rank(mesh, axis):
    return mesh.get_local_rank(axis) if axis in mesh.mesh_dim_names else 0


def _placements(mesh, dims):
    """One placement per mesh dim: Shard(dims[name]) for a mesh dim named
    in `dims` (mesh axis -> tensor dim), else Replicate()."""
    return tuple(Shard(dims[name]) if dims.get(name) is not None
                 else Replicate() for name in mesh.mesh_dim_names)


def _chunks(n, nsh):
    """torch.chunk's (DTensor's Shard) blocks of n rows over nsh ranks."""
    c = -(-n // nsh)
    return [(min(k * c, n), min((k + 1) * c, n)) for k in range(nsh)]


def _blocks(nlocal, nsh, n=None):
    """The ops' padded blocks [k nlocal, (k+1) nlocal), cut at n if given
    (then the same as _chunks(n, nsh) where nlocal is its block size)."""
    if n is None:
        return [(k * nlocal, (k + 1) * nlocal) for k in range(nsh)]
    return [(min(k * nlocal, n), min((k + 1) * nlocal, n))
            for k in range(nsh)]


def _reblock(local, have, want, mesh, axis):
    """Rows of a signal sharded along axis 0 over mesh axis `axis`, moved
    from one block layout to another: rank r holds global rows have[r]
    (`local` is this rank's) and receives want[r], zeros where no rank
    holds a row. One dist.batch_isend_irecv: each rank sends each other
    rank only what it holds of that rank's range (a halo, a block edge)."""
    if have == want:
        return local
    with span("shard.reblock"):
        me = _axis_rank(mesh, axis)
        lo, hi = want[me]
        h0 = have[me][0]
        out = local.new_zeros((hi - lo,) + tuple(local.shape[1:]))
        count("shard.reblock.bytes", out.numel() * out.element_size())
        group = mesh.get_group(axis) if len(have) > 1 else None
        ops = []
        for r in range(len(want)):
            a, b = max(have[me][0], want[r][0]), min(have[me][1], want[r][1])
            if a < b:
                if r == me:
                    out[a - lo: b - lo] = local[a - h0: b - h0]
                else:
                    ops.append(dist.P2POp(
                        dist.isend, local[a - h0: b - h0].contiguous(),
                        dist.get_global_rank(group, r), group))
            if r != me:
                a, b = max(have[r][0], lo), min(have[r][1], hi)
                if a < b:
                    ops.append(dist.P2POp(
                        dist.irecv, out[a - lo: b - lo],
                        dist.get_global_rank(group, r), group))
        if ops:
            count("shard.p2p")
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out


def _all_reduce(t, mesh, axis):
    """lax.psum over a mesh axis (in place on t; t when the axis has one
    rank)."""
    if _axis_size(mesh, axis) > 1:
        count("shard.all_reduce")
        dist.all_reduce(t, group=mesh.get_group(axis))
    return t


def _mesh_device(mesh):
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _signal(x, mesh):
    """x as a tensor (a DTensor stays one); a numpy array or list goes to
    the mesh's device."""
    if isinstance(x, torch.Tensor):
        return x
    return as_tensor(x, _mesh_device(mesh), "shard.signal")


def _channel_axis(x, channel_axis):
    """dsptpu's spec: a 1-D signal never shards channels."""
    return None if x.ndim == 1 else channel_axis


def shard_time(x, mesh, time_axis="time", channel_axis=None):
    """This rank's block of the global signal x as a DTensor sharded along
    axis 0 over `time_axis` in torch.chunk blocks (and along axis 1 over
    `channel_axis`, if given): the form of input the ops take in place,
    and the counterpart of a global jax.Array with P(time, channel)."""
    cax = _channel_axis(x, channel_axis)
    k = _axis_rank(mesh, time_axis)
    lo, hi = _chunks(x.shape[0], _axis_size(mesh, time_axis))[k]
    # a host array is cut before its upload: only the block moves
    local = _signal(_channel_block(x[lo:hi], mesh, cax), mesh)
    return _as_dtensor(local, mesh, {time_axis: 0, cax: 1}, x.shape)


def _channel_block(x, mesh, channel_axis):
    """This rank's part of axis 1 of x over `channel_axis` (even split)."""
    if channel_axis is None:
        return x
    nch = _axis_size(mesh, channel_axis)
    if x.shape[1] % nch:
        raise ValueError(f"{x.shape[1]} channels do not split over "
                         f"{nch} ranks of mesh axis {channel_axis!r}")
    w = x.shape[1] // nch
    c = _axis_rank(mesh, channel_axis)
    return x[:, c * w: (c + 1) * w]


def _local_rows(x, mesh, time_axis, channel_axis, nlocal, before=0,
                after=0):
    """This rank's rows [k nlocal - before, (k+1) nlocal + after) of the
    signal zero-padded on both sides (its channel block, if channel_axis
    is given): its own padded block, then halos from its neighbours.
    A DTensor input moves from its torch.chunk blocks in the same
    exchange."""
    nsh = _axis_size(mesh, time_axis)
    k = _axis_rank(mesh, time_axis)
    n = x.shape[0]
    if isinstance(x, DTensor):
        want_pl = _placements(mesh, {time_axis: 0, channel_axis: 1})
        if tuple(x.placements) != want_pl:
            raise ValueError(f"a DTensor signal needs placements {want_pl} "
                             f"on this mesh, not {tuple(x.placements)}")
        local, have = x.to_local(), _chunks(n, nsh)
    else:
        local = _channel_block(x[k * nlocal: (k + 1) * nlocal], mesh,
                               channel_axis)
        if local.shape[0] < nlocal:
            local = torch.cat([local, local.new_zeros(
                (nlocal - local.shape[0],) + tuple(local.shape[1:]))], 0)
        have = _blocks(nlocal, nsh)
    want = [(lo - before, hi + after) for lo, hi in _blocks(nlocal, nsh)]
    return _reblock(local, have, want, mesh, time_axis)


def _time_output(block, mesh, time_axis, channel_axis, shape, nlocal):
    """A time-sharded result from each rank's padded block [k nlocal,
    (k+1) nlocal) as a DTensor of global `shape` in torch.chunk blocks
    (the padded tail cut; rows move between ranks only where the blocks
    differ from torch.chunk's)."""
    n = shape[0]
    nsh = _axis_size(mesh, time_axis)
    k = _axis_rank(mesh, time_axis)
    have = _blocks(nlocal, nsh, n)
    lo, hi = have[k]
    local = _reblock(block[: hi - lo], have, _chunks(n, nsh), mesh,
                     time_axis)
    return _as_dtensor(local, mesh, {time_axis: 0, channel_axis: 1}, shape)


def _as_dtensor(local, mesh, dims, shape):
    shape = torch.Size(shape)
    stride = tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))
    return DTensor.from_local(local.contiguous(), mesh,
                              _placements(mesh, dims), run_check=False,
                              shape=shape, stride=stride)


# ---------------------------------------------------------------------------
# FIR
# ---------------------------------------------------------------------------

def _fir_local(b, xcat):
    """Causal FIR on the halo-extended local block; valid part only. K1
    filters the block from zero history, so its rows nb - 1 on, whose
    history the halo holds, are the valid part."""
    from ..kernels.fir import fir, fir_supported
    from ..ops.dspbase import _FIR_OS_CUTOFF, _conv_os_1d, _fir_causal
    nb = b.shape[0]
    flat = xcat.reshape(xcat.shape[0], -1)
    n = flat.shape[0]
    rtype = torch.promote_types(b.dtype, flat.dtype)
    if nb > _FIR_OS_CUTOFF:
        count("route.shard_fir.os")
        y = _conv_os_1d(flat, b, out_len=n)[:n]
    elif fir_supported(nb, rtype) and n >= max(32768, 4 * nb):
        # dspbase.filt's gate for K1: a real float32 result
        count("route.shard_fir.k1")
        y = fir(flat.to(rtype), b.to(rtype))
    else:
        count("route.shard_fir.direct")
        y = _fir_causal(b, flat)
    return y[nb - 1:].reshape((xcat.shape[0] - nb + 1,) + xcat.shape[1:])


@spanned("shard_fir")
def shard_fir(b, x, mesh, time_axis="time", channel_axis=None):
    """Causal FIR filt along axis 0, time-sharded with halo exchange.
    Arbitrary lengths: the signal is zero-padded to split evenly over
    the 'time' mesh axis and the padded tail is cut off (causal filter,
    so padding never affects earlier outputs)."""
    from ..ops.dspbase import _as_1d
    x = _signal(x, mesh)
    b = _as_1d(b, "b", x.device)
    nb = b.shape[0]
    n_orig = x.shape[0]
    nlocal = -(-n_orig // _axis_size(mesh, time_axis))
    if nb - 1 > nlocal:
        raise ValueError(f"filter history ({nb - 1}) exceeds the "
                         f"per-shard length ({nlocal})")
    cax = _channel_axis(x, channel_axis)
    xcat = _local_rows(x, mesh, time_axis, cax, nlocal, before=nb - 1)
    return _time_output(_fir_local(b, xcat), mesh, time_axis, cax, x.shape,
                        nlocal)


# shard_fftfilt shares the halo-exchange structure; the local compute is
# the overlap-save path (K4), which _fir_local selects for long taps.
@spanned("shard_fftfilt")
def shard_fftfilt(b, x, mesh, time_axis="time", channel_axis=None):
    return shard_fir(b, x, mesh, time_axis, channel_axis)


# ---------------------------------------------------------------------------
# Welch, STFT power, spectrogram, multitaper spectrogram
# ---------------------------------------------------------------------------

def _segments(x, n, noverlap, mesh, time_axis, channel_axis):
    """The segments that start in this rank's block, framed: (frames
    (nseg, *chans, n), valid (nseg,) bool, nseg, n_valid), with
    the n - hop halo from the right neighbour. Blocks are hop multiples;
    segments reaching past the signal's end are masked (valid False), so
    every rank holds nlocal // hop of them, and n_valid counts the valid
    ones over all ranks."""
    hop = n - noverlap
    ntime = _axis_size(mesh, time_axis)
    n_orig = x.shape[0]
    nlocal = -(-n_orig // (ntime * hop)) * hop
    if noverlap > nlocal:
        raise ValueError("noverlap (the cross-shard halo) must not exceed "
                         "the local shard length")
    xcat = _local_rows(x, mesh, time_axis, channel_axis, nlocal,
                       after=n - hop)
    nseg = nlocal // hop
    gstart = (_axis_rank(mesh, time_axis) * nlocal
              + torch.arange(nseg, device=xcat.device) * hop)
    valid = gstart + n <= n_orig
    n_valid = min(ntime * nseg, max(0, (n_orig - n) // hop + 1))
    return xcat.unfold(0, n, hop), valid, nseg, n_valid


def _bshape(v, ndim, dim):
    """v (a 1-D tensor) shaped to broadcast along `dim` of an ndim array."""
    shape = [1] * ndim
    shape[dim] = -1
    return v.reshape(shape)


def _onesided_scale(n, dtype, device):
    """Welch's one-sided weights of the n//2 + 1 bins on the device: 2,
    and 1 at DC and (n even) at Nyquist."""
    scale = torch.full((n // 2 + 1,), 2.0, dtype=dtype, device=device)
    # each write of a host scalar is an upload of one element, which
    # waits for the stream on the card
    for i in ((0, -1) if n % 2 == 0 else (0,)):
        count("sync.shard_welch.scale")
        count("upload.bytes", scale.element_size())
        with span("sync.shard_welch.scale"):
            scale[i] = 1.0
    return scale


@spanned("shard_welch")
def shard_welch(x, n, noverlap, window, mesh, time_axis="time",
                channel_axis=None, fs=1.0):
    """Distributed one-sided Welch PSD over axis 0 of real x.

    Each time shard computes the PSDs of the segments that *start*
    inside it (pulling n - hop cross-boundary samples from its right
    neighbour), then all-reduces the per-shard sums. Arbitrary lengths:
    the signal is zero-padded so the per-shard length is a hop multiple;
    segments reaching past the true signal end are masked out of the sum
    (valid-count normalization unchanged). Returns (psd, freqs): psd
    (n//2+1, *chans) replicated over the time axis, freqs (float64)."""
    x = _signal(x, mesh)
    cax = _channel_axis(x, channel_axis)
    win = np.asarray(to_host(window, "shard_welch.window"), dtype=np.float64)
    frames, valid, nseg, n_valid = _segments(x, n, noverlap, mesh,
                                             time_axis, cax)
    winnorm = 1.0 / (float(np.sum(win ** 2)) * fs)
    win = as_tensor(win, frames.device, "shard_welch.window").to(
        frames.dtype)
    p = torch.fft.rfft(frames * win, dim=-1).abs() ** 2   # (nseg, *ch, nf)
    nfreq = n // 2 + 1
    scale = _onesided_scale(n, p.dtype, p.device)
    p = p * _bshape(valid.to(p.dtype), p.ndim, 0) * scale
    total = _all_reduce(p.sum(0) * winnorm, mesh, time_axis)
    psd = (total / n_valid).movedim(-1, 0)               # (nf, *ch)
    out = _as_dtensor(psd, mesh, {cax: 1},
                      (nfreq,) + tuple(x.shape[1:]))
    freqs = torch.fft.rfftfreq(n, d=1.0 / fs, dtype=torch.float64,
                               device=x.device)
    return out, freqs


@spanned("shard_stft_pow")
def shard_stft_pow(x, n, noverlap, window, mesh, time_axis="time",
                   channel_axis=None, fs=1.0, onesided=True):
    """Time-sharded spectrogram/STFT power: each shard computes the
    windowed-segment PSDs of the segments *starting* inside it (pulling
    the n - hop halo from its right neighbour, like shard_welch) and
    keeps them: the output stays sharded over the segment axis (axis 0
    of the returned (nseg, nfreq, *chans) DTensor), with the masked
    segments past the signal's end as zero rows. Returns (pw, freqs,
    t), freqs and t numpy."""
    x = _signal(x, mesh)
    cax = _channel_axis(x, channel_axis)
    hop = n - noverlap
    frames, valid, nseg, _ = _segments(x, n, noverlap, mesh, time_axis,
                                       cax)
    if window is None:
        norm2 = float(n)
    else:
        win = np.asarray(to_host(window, "shard_stft_pow.window"),
                         dtype=np.float64)
        norm2 = float(np.sum(win ** 2))
        frames = frames * as_tensor(win, frames.device,
                                    "shard_stft_pow.window").to(frames.dtype)
    F = (torch.fft.rfft(frames, dim=-1) if onesided
         else torch.fft.fft(frames, dim=-1))
    pw = (F.abs() ** 2).movedim(-1, 1)                  # (nseg, nf, *ch)
    scale = np.full(pw.shape[1], 1.0 / (fs * norm2))
    if onesided:
        scale[1:] *= 2.0
        if n % 2 == 0:
            scale[-1] /= 2.0
    scale = as_tensor(scale, pw.device, "shard_stft_pow.scale").to(pw.dtype)
    pw = pw * _bshape(scale, pw.ndim, 1) * _bshape(valid.to(pw.dtype),
                                                   pw.ndim, 0)
    ntime = _axis_size(mesh, time_axis)
    out = _as_dtensor(pw, mesh, {time_axis: 0, cax: 2},
                      (ntime * nseg, pw.shape[1]) + tuple(x.shape[1:]))
    freqs = (np.fft.rfftfreq(n, 1.0 / fs) if onesided
             else np.fft.fftfreq(n, 1.0 / fs))
    t = (np.arange(ntime * nseg) * hop + n / 2) / fs
    return out, freqs, t


@spanned("shard_spectrogram")
def shard_spectrogram(x, n, noverlap, window, mesh, time_axis="time",
                      channel_axis=None, fs=1.0):
    """Sharded spectrogram (PSD mode); see shard_stft_pow. Segments
    whose window would run past the global signal end are zero rows on
    the owning shard, mirroring shard_welch's masking."""
    return shard_stft_pow(x, n, noverlap, window, mesh, time_axis,
                          channel_axis, fs=fs, onesided=True)


@spanned("shard_mt_spectrogram")
def shard_mt_spectrogram(x, config, n_overlap=None, mesh=None,
                         time_axis="time", channel_axis=None):
    """Time-sharded multitaper spectrogram: per-shard segment framing
    with right-neighbour halo (as shard_stft_pow) and the taper-weighted
    PSD reduction (ops.multitaper._mt_power) on each shard's segments.
    `config` is an MTConfig (segment geometry) or MTSpectrogramConfig,
    n_overlap the overlap in samples (default n >> 1). Output stays
    sharded over the segment axis: (nseg, nfreq, *chans); invalid tail
    rows are zero."""
    from ..ops.multitaper import MTSpectrogramConfig, _mt_power
    if isinstance(config, MTSpectrogramConfig):
        n_overlap = config.n_overlap_samples
        config = config.mt_config
    x = _signal(x, mesh)
    cax = _channel_axis(x, channel_axis)
    n = config.n_samples
    if n_overlap is None:
        n_overlap = n >> 1
    frames, valid, nseg, _ = _segments(x, n, n_overlap, mesh, time_axis,
                                       cax)
    pw = _mt_power(frames, config).movedim(-1, 1)       # (nseg, nf, *ch)
    pw = pw * _bshape(valid.to(pw.dtype), pw.ndim, 0)
    ntime = _axis_size(mesh, time_axis)
    return _as_dtensor(pw, mesh, {time_axis: 0, cax: 2},
                       (ntime * nseg, pw.shape[1]) + tuple(x.shape[1:]))


# ---------------------------------------------------------------------------
# IIR: state chains across shards
# ---------------------------------------------------------------------------

def _gathered_states(v, mesh, axis):
    """Every time rank's (p, C) state, in rank order."""
    nsh = _axis_size(mesh, axis)
    if nsh == 1:
        return [v]
    vs = [torch.empty_like(v) for _ in range(nsh)]
    count("shard.all_gather")
    dist.all_gather(vs, v.contiguous(), group=mesh.get_group(axis))
    return vs


@full_f32()
def _affine_scan(T_np, v, mesh, axis, reverse=False):
    """Exclusive affine prefix over a mesh axis: shard k receives
    zin_k = sum_{j<k} T^{k-1-j} v_j (zin_0 = 0); with reverse, the
    suffix zin_k = sum_{j>k} T^{j-1-k} v_j (zin_{nsh-1} = 0) for
    right-to-left (anti-causal) chains. From an all_gather of the states
    and a Horner walk in rank order (the same order on every rank and in
    every run). v: (p, C)."""
    vs = _gathered_states(v, mesh, axis)
    T = as_tensor(T_np, v.device, "shard_scan.T").to(v.dtype)
    k = _axis_rank(mesh, axis)
    z = torch.zeros_like(v)
    for j in (range(len(vs) - 1, k, -1) if reverse else range(k)):
        z = T @ z + vs[j]
    return z


def _zir(ss, zin, like):
    """The zero-input response y[t] = w' A^t zin over like's rows (the
    block pass on zeros from zin: K2 where its gate holds). zin: (p, C)."""
    from ..filters.filt import _blockss_apply
    return _blockss_apply(ss, torch.zeros_like(like), zin,
                          need_state=False)[0]


def _sos_host(sos, op):
    return np.asarray(to_host(sos, op + ".sos"),
                      dtype=np.float64).reshape(-1, 5)


def _w_of(ss):
    """The output map w from the block tables: G[0] = (A^0)'w."""
    return ss.G[0]


def _apow(T_np, nsh):
    """A^{k nlocal} for k = 0..nsh-1 (T = A^nlocal): propagates the
    edge-transient entering states to every shard."""
    p = T_np.shape[0]
    out = np.empty((nsh, p, p))
    out[0] = np.eye(p)
    for k in range(1, nsh):
        out[k] = T_np @ out[k - 1]
    return out


def _table(a, like):
    """A host table of shard_filtfilt as a tensor beside like (an upload,
    counted as `sync.shard_filtfilt.table`)."""
    from ..filters.filt import _const
    return _const(a, like, "shard_filtfilt.table")


def _filtfilt_forward(ss, flat, zst, pad, T_np, mesh, time_axis):
    """shard_filtfilt's forward pass over this rank's block flat (nlocal,
    C): one pass from zero state (K2 with need_state), the state chain
    across ranks, and rank 0's front extension ext = 2 x0 - x[pad:0:-1]
    folded in as the state entering after it from the steady-state
    init. Returns (y1, the state entering the block, the block's own
    end state from zero)."""
    from ..filters.filt import _blockss_apply
    nlocal = flat.shape[0]
    idx = _axis_rank(mesh, time_axis)
    powers = ss.powers
    Kf = np.stack([powers[pad - 1 - j] @ ss.c for j in range(pad)], axis=1)
    y0, v = _blockss_apply(ss, flat, flat.new_zeros((ss.p, flat.shape[1])),
                           need_state=True)
    front = 2 * flat[:1] - flat[1: pad + 1].flip(0)        # (pad, C)
    z_e = _table(powers[pad], flat) @ (zst * front[0][None, :]) + _table(
        Kf, flat) @ front
    z_e = _all_reduce(z_e if idx == 0 else torch.zeros_like(z_e), mesh,
                      time_axis)
    zin = _affine_scan(T_np, v, mesh, time_axis)
    zin = zin + _table(_apow(T_np, _axis_size(mesh, time_axis))[idx],
                       flat) @ z_e
    return y0 + _zir(ss, zin, flat), zin, v


@spanned("shard_sosfilt")
def shard_sosfilt(sos, g, x, mesh, time_axis="time", channel_axis=None):
    """Time-sharded biquad cascade via the stacked block state-space pass
    (filters.filt._blockss_apply): each shard filters its block from zero
    state in ONE pass (K2 with need_state where its gate holds), the
    (2 nsec, C) boundary states chain across shards (_affine_scan), and
    the entering-state correction is the zero-input response (_zir: the
    same pass on zeros from the entering state)."""
    from ..filters.filt import _blockss_apply, _cascade_ss
    sos = _sos_host(sos, "shard_sosfilt")
    x = _signal(x, mesh)
    cax = _channel_axis(x, channel_axis)
    p = 2 * sos.shape[0]
    nsh = _axis_size(mesh, time_axis)
    n_local = -(-x.shape[0] // nsh)
    ss = _cascade_ss(sos, float(g))
    xs = _local_rows(x, mesh, time_axis, cax, n_local)
    flat = xs.reshape(n_local, -1)
    z0 = flat.new_zeros((p, flat.shape[1]))
    y, v = _blockss_apply(ss, flat, z0, need_state=True)
    if nsh > 1:
        # whole-shard transition T = A^n_local (host)
        T_np = np.linalg.matrix_power(ss.A, n_local)
        zin = _affine_scan(T_np, v, mesh, time_axis)
        y = y + _zir(ss, zin, flat)
    return _time_output(y.reshape(xs.shape), mesh, time_axis, cax, x.shape,
                        n_local)


@spanned("shard_filtfilt")
def shard_filtfilt(sos, g, x, mesh, time_axis="time", channel_axis=None):
    """Zero-phase (forward + anti-causal) SOS filtering across time
    shards, the distributed form of filters.filtfilt, with the same
    odd-symmetric edge extrapolation and steady-state initial
    conditions.

    Each shard runs BOTH block state-space passes locally from zero
    state; the (2 nsec, C) boundary states chain across shards with a
    prefix (forward) and a suffix (anti-causal), and the edge-extension
    transients (pad = 6 nsec samples) fold in closed form into the first
    and last shard's entering states via host tables. The anti-causal
    pass is _blockss_apply's reverse mode (here the block flipped and
    the forward pass; dsptpu mirrors its tables instead).

    Arbitrary lengths: when n does not split into 128-multiple shards,
    the signal is extended in-array with the odd-symmetric back extension
    plus zeros, and the anti-causal initial state is injected at the true
    extension end (_shard_filtfilt_padded)."""
    sos = _sos_host(sos, "shard_filtfilt")
    x = _signal(x, mesh)
    cax = _channel_axis(x, channel_axis)
    nsec = sos.shape[0]
    nsh = _axis_size(mesh, time_axis)
    n = x.shape[0]
    pad = min(6 * nsec, n - 1)
    if n % nsh or (n // nsh) % 128 or pad + 2 > n // nsh:
        return _shard_filtfilt_padded(sos, g, x, mesh, time_axis, cax, nsh)
    return _filtfilt_blocks(sos, g, x, mesh, time_axis, cax, nsh)


@full_f32()
def _filtfilt_blocks(sos, g, x, mesh, time_axis, cax, nsh):
    """shard_filtfilt on blocks of n / nsh samples, a multiple of 128."""
    from ..filters.filt import (_blockss_apply, _cascade_ss,
                                filt_stepstate_sos)
    from ..ops.dspbase import _float_type
    nsec = sos.shape[0]
    p = 2 * nsec
    n = x.shape[0]
    pad = min(6 * nsec, n - 1)
    nlocal = n // nsh
    ss = _cascade_ss(sos, float(g))
    T_np = np.linalg.matrix_power(ss.A, nlocal)
    Apow = _apow(T_np, nsh)
    powers = ss.powers
    Apad = powers[pad]
    Kr = np.stack([powers[j] @ ss.c for j in range(pad)], axis=1)
    h = np.empty(pad)
    h[0] = float(ss.F[0, 0])                              # = d
    if pad > 1:
        h[1:] = (powers[: pad - 1] @ ss.c) @ _w_of(ss)
    i_, j_ = np.ogrid[:pad, :pad]
    Fpad = np.where(i_ >= j_, h[np.clip(i_ - j_, 0, pad - 1)], 0.0)
    Gpad = powers[:pad].transpose(0, 2, 1) @ _w_of(ss)    # (pad, p)
    zstack = np.swapaxes(filt_stepstate_sos(sos), 0, 1).reshape(p)

    xs = _local_rows(x, mesh, time_axis, cax, nlocal)
    flat = xs.reshape(nlocal, -1)
    flat = flat.to(_float_type(flat.dtype, torch.float32))
    idx = _axis_rank(mesh, time_axis)
    zst = _table(zstack, flat)[:, None]                   # (p, 1)

    y1, zin, v = _filtfilt_forward(ss, flat, zst, pad, T_np, mesh,
                                   time_axis)

    # ---- back extension (forward through it, then reversed) ----
    exit_s = _table(T_np, flat) @ zin + v
    back = 2 * flat[-1:] - flat[nlocal - pad - 1: nlocal - 1].flip(0)
    y1b = _table(Fpad, flat) @ back + _table(Gpad, flat) @ exit_s
    z_re = _table(Apad, flat) @ (zst * y1b[-1][None, :]) + _table(
        Kr, flat) @ y1b
    z_re = _all_reduce(z_re if idx == nsh - 1 else torch.zeros_like(z_re),
                       mesh, time_axis)

    # ---- anti-causal pass ----
    yr, w = _blockss_apply(ss, y1, flat.new_zeros((p, flat.shape[1])),
                           need_state=True, reverse=True)
    zrin = _affine_scan(T_np, w, mesh, time_axis, reverse=True)
    zrin = zrin + _table(Apow[nsh - 1 - idx], flat) @ z_re
    # reverse zero-input response == time-flipped forward response
    y2 = yr + _zir(ss, zrin, flat).flip(0)
    return _time_output(y2.reshape((nlocal,) + tuple(xs.shape[1:])), mesh,
                        time_axis, cax, x.shape, nlocal)


def _back_rows(x, mesh, time_axis, cax, n_orig, pad, nlocal):
    """The odd-symmetric back extension 2 x[n-1] - x[n-1-pad:n-1][::-1]
    (pad, C) on each rank whose block holds part of [n, n + pad) (others
    get an empty block): from the global signal directly, from a DTensor
    by moving its last pad + 1 rows to those ranks."""
    nsh = _axis_size(mesh, time_axis)
    k = _axis_rank(mesh, time_axis)
    lo = n_orig - 1 - pad
    needs = [max(j * nlocal, n_orig) < min((j + 1) * nlocal, n_orig + pad)
             for j in range(nsh)]
    if isinstance(x, DTensor):
        tail = _reblock(x.to_local(), _chunks(n_orig, nsh),
                        [(lo, n_orig) if nd else (0, 0) for nd in needs],
                        mesh, time_axis)
    else:
        tail = _channel_block(x[lo:n_orig], mesh, cax)
    if not needs[k]:
        return None
    return 2 * tail[-1:] - tail[:-1].flip(0)


@full_f32()
def _shard_filtfilt_padded(sos, g, x, mesh, time_axis, cax, nsh):
    """shard_filtfilt for lengths that do not split into 128-multiple
    shards. The signal is extended with the actual odd-symmetric back
    extension followed by zeros, so the forward pass computes the
    back-extension response in-array; the anti-causal pass then zeroes
    the decay tail and injects its initial state zst y1[n_inj-1] at the
    true extension end n_inj = n + pad, propagated per shard with host
    A-power tables (shards past the injection point take a row-shifted
    zero-input response)."""
    from ..filters.filt import (_blockss_apply, _cascade_ss,
                                filt_stepstate_sos)
    from ..ops.dspbase import _float_type
    nsec = sos.shape[0]
    p = 2 * nsec
    n_orig = x.shape[0]
    pad = min(6 * nsec, n_orig - 1)
    nlocal = max((-(-n_orig // nsh) + 127) // 128 * 128, 128)
    while nlocal * nsh - n_orig < pad or pad + 2 > nlocal:
        nlocal += 128
    n_inj = n_orig + pad

    ss = _cascade_ss(sos, float(g))
    A = ss.A
    T_np = np.linalg.matrix_power(A, nlocal)
    zstack = np.swapaxes(filt_stepstate_sos(sos), 0, 1).reshape(p)
    # per-shard back-injection propagation: shards ending at or before
    # n_inj propagate A^{n_inj - end}; the shard containing n_inj (and
    # any fully padded shard) row-shifts the response instead
    ends = (np.arange(nsh) + 1) * nlocal
    Aadj = np.stack([np.linalg.matrix_power(A, int(max(n_inj - e, 0)))
                     for e in ends])
    sshift = np.clip(ends - n_inj, 0, nlocal)
    k_star = (n_inj - 1) // nlocal
    r_star = (n_inj - 1) % nlocal

    # this rank's block of xe = [x, back extension, zeros]
    idx = _axis_rank(mesh, time_axis)
    xs = _local_rows(x, mesh, time_axis, cax, nlocal)
    back = _back_rows(x, mesh, time_axis, cax, n_orig, pad, nlocal)
    if back is not None:
        lo = max(idx * nlocal, n_orig)
        hi = min((idx + 1) * nlocal, n_inj)
        xs = xs.clone()
        xs[lo - idx * nlocal: hi - idx * nlocal] = back[lo - n_orig:
                                                        hi - n_orig]
    flat = xs.reshape(nlocal, -1)
    flat = flat.to(_float_type(flat.dtype, torch.float32))
    zst = _table(zstack, flat)[:, None]

    y1, _, _ = _filtfilt_forward(ss, flat, zst, pad, T_np, mesh, time_axis)

    # ---- anti-causal pass ----
    # initial state zst y1[n_inj-1], taken from its shard
    row = y1[r_star] if idx == k_star else y1.new_zeros(y1.shape[1])
    z_inj = zst * _all_reduce(row.clone(), mesh, time_axis)[None, :]
    # zero the forward decay tail past the extension end
    keep = max(0, min(nlocal, n_inj - idx * nlocal))
    y1m = torch.cat([y1[:keep], y1.new_zeros((nlocal - keep,)
                                             + tuple(y1.shape[1:]))], 0)
    yr, w = _blockss_apply(ss, y1m, torch.zeros_like(z_inj), need_state=True,
                           reverse=True)
    zrin = _affine_scan(T_np, w, mesh, time_axis, reverse=True)
    # the last rank's suffix is empty
    corr0 = _zir(ss, zrin, flat).flip(0) if idx < nsh - 1 else 0
    zadj = _table(Aadj[idx], flat) @ z_inj
    resp = _zir(ss, zadj, flat).flip(0)
    s = int(sshift[idx])
    shifted = torch.cat([resp[s:], resp.new_zeros((s,)
                                                  + tuple(resp.shape[1:]))])
    y2 = yr + corr0 + shifted
    return _time_output(y2.reshape((nlocal,) + tuple(xs.shape[1:])), mesh,
                        time_axis, cax, x.shape, nlocal)


# ---------------------------------------------------------------------------
# resampling
# ---------------------------------------------------------------------------

@spanned("shard_resample")
def shard_resample(h, ratio, x, mesh, time_axis="time", channel_axis=None):
    """Time-sharded streaming polyphase resample (rational ratio or
    integer interp/decim): the distributed form of FIRFilter's
    deficit/history/phase state carry.

    The stream state entering shard k after k n_local consumed samples
    has an O(1) closed form (the kernels' commit algebra), so every
    shard's (deficit, phase) is host-precomputed; the shard's phase
    shift folds into a row-shifted banded tap matrix G_k, leaving one
    program per shard: halo the tapsPerPhi - 1 history from the left
    neighbour, one block matmul, and an output-count mask. The result
    equals chunked FIRFilter.filt, sample for sample.

    Returns (y, out_counts): y is (nsh out_max, *chans) sharded along
    axis 0 with each shard's tail zero-padded to out_max; out_counts
    gives the valid count per shard (compact_shards squeezes them)."""
    from ..filters.stream_filt import (FIRFilter, _block_matmul, _tap_dtype,
                                       outputlength, taps2pfb)
    ratio = Fraction(ratio)
    L, M = ratio.numerator, ratio.denominator
    x = _signal(x, mesh)
    cax = _channel_axis(x, channel_axis)
    h = to_host(h, "shard_resample.h")
    nsh = _axis_size(mesh, time_axis)
    n_orig = x.shape[0]
    n_local = -(-n_orig // nsh)

    # polyphase bank and per-shard entry state (host O(nsh))
    pfb = taps2pfb(h, L)                    # (tapsPerPhi, L)
    taps = pfb.shape[0]
    hl = taps - 1                           # history halo length
    if hl > n_local:
        raise ValueError(
            f"per-phase history ({hl}) exceeds the per-shard length "
            f"({n_local}); use fewer time shards or longer input")
    pfb_t = pfb.T                           # (L, taps)
    k0 = FIRFilter(h, ratio if (L > 1 or M > 1) else 1).kernel
    states = []
    valid_counts = []
    for k in range(nsh):
        phi = getattr(k0, "phi_idx", 1)
        deficit = getattr(k0, "input_deficit", 1)
        states.append((deficit, phi))
        out_k = (outputlength(n_local - deficit + 1, ratio, phi)
                 if n_local >= deficit else 0)
        # valid outputs consume only the shard's real (unpadded) samples
        r_k = max(min(n_orig - k * n_local, n_local), 0)
        valid_counts.append(
            max(outputlength(r_k - deficit + 1, ratio, phi), 0)
            if r_k >= deficit else 0)
        k0.commit(n_local, out_k)
    out_counts = np.array(valid_counts)
    Bmax = int((-(-out_counts // L)).max())
    out_max = Bmax * L
    # per-shard G with the deficit folded in as a row shift (so the
    # frame start is 0 for every shard)
    Gs = []
    for d, phi in states:
        offs = [d - 1 + (phi - 1 + M * q) // L for q in range(L)]
        G = np.zeros((max(offs) + taps, L), dtype=pfb_t.dtype)
        for q in range(L):
            G[offs[q]: offs[q] + taps, q] = pfb_t[(phi - 1 + M * q) % L]
        Gs.append(G)
    Wmax = max(G.shape[0] for G in Gs)
    k = _axis_rank(mesh, time_axis)
    dt = _tap_dtype(pfb_t.dtype, x.dtype)
    Gk = torch.zeros((Wmax, L), dtype=dt, device=x.device)
    Gk[: Gs[k].shape[0]] = torch.as_tensor(Gs[k], device=x.device).to(dt)

    xcat = _local_rows(x, mesh, time_axis, cax, n_local, before=hl)
    y = _block_matmul(xcat.to(dt), Gk, 0, Bmax, M, Wmax, out_max)
    y[int(out_counts[k]):] = 0
    return (_as_dtensor(y, mesh, {time_axis: 0, cax: 1},
                        (nsh * out_max,) + tuple(x.shape[1:])), out_counts)


@spanned("compact_shards")
def compact_shards(y, out_counts):
    """Squeeze the per-shard zero padding out of a shard_resample
    result. A DTensor's valid rows move to torch.chunk blocks of the
    compact length (only block edges cross ranks); a global tensor
    takes one index_select of a host index plan."""
    out_counts = np.asarray(out_counts)
    nsh = len(out_counts)
    if not isinstance(y, DTensor):
        out_max = y.shape[0] // nsh
        idx = np.concatenate([k * out_max + np.arange(c)
                              for k, c in enumerate(out_counts)])
        return y.index_select(0, torch.as_tensor(idx, device=y.device))
    mesh = y.device_mesh
    time_axis = mesh.mesh_dim_names[list(y.placements).index(Shard(0))]
    k = _axis_rank(mesh, time_axis)
    ends = np.cumsum(out_counts)
    have = [(int(e - c), int(e)) for e, c in zip(ends, out_counts)]
    total = int(ends[-1])
    local = _reblock(y.to_local()[: int(out_counts[k])], have,
                     _chunks(total, nsh), mesh, time_axis)
    shape = (total,) + tuple(y.shape[1:])
    stride = tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))
    return DTensor.from_local(local.contiguous(), mesh, y.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


# ---------------------------------------------------------------------------
# multitaper cross spectra: the tapers shard
# ---------------------------------------------------------------------------

def _replicated(signal, mesh):
    """A replicated signal as its local tensor (a sharded DTensor would
    need a gather, which the ops never make)."""
    if isinstance(signal, DTensor):
        if not all(isinstance(pl, Replicate) for pl in signal.placements):
            raise ValueError("the cross spectra take a replicated signal")
        return signal.to_local()
    return _signal(signal, mesh)


@spanned("shard_mt_cross_power_spectra")
def shard_mt_cross_power_spectra(signal, mesh, config=None,
                                 shard_axis="time", fs=1.0, demean=False,
                                 freq_range=None, **kwargs):
    """Taper-sharded multitaper cross power spectra (the distributed form
    of the chan x chan x freq x taper accumulation).

    The taper bank is split over the mesh axis `shard_axis` (each rank
    rffts and accumulates S^{lm} for its tapers only), then one
    all_reduce gives the full cross-spectral matrix on every rank. The
    signal (n_channels, n_samples) is replicated: the lm pairing needs
    all channels on each rank, but the taper dimension is embarrassingly
    parallel and carries the whole FFT cost. Tapers pad to a multiple of
    the axis size with zero-weight zero tapers (they add exactly 0). As
    in dsptpu, the tapers and weights are cast to the signal's dtype.

    Returns CrossPowerSpectra: power a DTensor replicated over the
    mesh."""
    from ..ops.multitaper import (CrossPowerSpectra, MTConfig,
                                  MTCrossSpectraConfig, _freq_mask)
    signal = _replicated(signal, mesh)
    if signal.is_complex():
        raise ValueError("only real signals supported (onesided)")
    n_channels, n_samples = signal.shape
    if isinstance(config, MTCrossSpectraConfig):
        if n_channels != config.n_channels:
            raise ValueError("channel count does not match config")
        demean = config.demean
        freq_range = config.freq_range
        config = config.mt_config
    elif config is None:
        config = MTConfig.create(n_samples, fs=fs, onesided=True, **kwargs)
    if not config.onesided:
        raise ValueError("cross power spectra are onesided")
    if demean:
        signal = signal - signal.mean(dim=1, keepdim=True)
    nsh = _axis_size(mesh, shard_axis)
    # host: taper bank (ntapers, n) + weights, zero-padded to nsh | K
    tap = np.asarray(config.window_array).T            # (ntapers, n)
    w = 2.0 / np.asarray(config.r)                     # (ntapers,)
    K = tap.shape[0]
    Kp = -(-K // nsh) * nsh
    if Kp != K:
        tap = np.concatenate([tap, np.zeros((Kp - K, tap.shape[1]))])
        w = np.concatenate([w, np.zeros(Kp - K)])
    kl = Kp // nsh
    k = _axis_rank(mesh, shard_axis)
    nfft = config.nfft
    nfreq = nfft // 2 + 1
    corr = np.ones(nfreq)
    corr[0] = 1 / np.sqrt(2)
    if nfft % 2 == 0:
        corr[-1] = 1 / np.sqrt(2)
    idx, freqs = _freq_mask(config.freq, freq_range)

    def const(a):
        return torch.as_tensor(np.ascontiguousarray(a),
                               device=signal.device).to(signal.dtype)
    F = torch.fft.rfft(signal[:, None, :] * const(tap[k * kl: (k + 1) * kl]),
                       n=nfft, dim=-1) * const(corr)  # (nch, kl, nfreq)
    if not isinstance(idx, slice):
        F = F[:, :, torch.as_tensor(idx, device=F.device)]
    with full_f32():
        part = torch.einsum("lkf,mkf->lmf",
                            F * const(w[k * kl: (k + 1) * kl])[:, None],
                            F.conj())
    power = _all_reduce(part, mesh, shard_axis)
    return CrossPowerSpectra(_as_dtensor(power, mesh, {}, power.shape),
                             freqs)


@spanned("shard_mt_coherence")
def shard_mt_coherence(signal, mesh, config=None, shard_axis="time",
                       fs=1.0, demean=False, freq_range=None, **kwargs):
    """Pairwise channel coherences from the taper-sharded cross spectra.
    The coherence normalization runs replicated on every rank (it is
    O(nch^2 nfreq), negligible next to the sharded FFTs)."""
    from ..ops.multitaper import (Coherence, MTCoherenceConfig,
                                  coherence_from_cs)
    if isinstance(config, MTCoherenceConfig):
        config = config.cs_config
    cs = shard_mt_cross_power_spectra(
        signal, mesh, config=config, shard_axis=shard_axis, fs=fs,
        demean=demean, freq_range=freq_range, **kwargs)
    coh = coherence_from_cs(cs.power.to_local())
    return Coherence(_as_dtensor(coh, mesh, {}, coh.shape), cs.freq)
