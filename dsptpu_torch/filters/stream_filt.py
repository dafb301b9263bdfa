"""Streaming polyphase FIR engine: single-rate, interpolation,
decimation, rational and arbitrary-rate resampling. The port of
dsptpu/filters/stream_filt.py.

Capability parity with reference src/Filters/stream_filt.jl (kernels
:8-134, FIRFilter :137-210, setphase!/reset! :216-276, taps2pfb
:294-307, length algebra :317-403, filt! :409-625, resample :663-775).

The reference's inner loop is a data-dependent while loop doing one
tapsPerPhi-dot per output (stream_filt.jl:476-515). Here the per-output
index sequences (input index, phase index, intra-phase alpha) have
exact closed forms given the entry state, computed by host integer
algebra (the kernel classes below, numpy, copied from dsptpu) that
reproduces the reference's sample-exact stream semantics
(inputDeficit, history, phase carry).

Device routes, in the order `FIRFilter.filt` tries them:

* rational, interpolating and decimating streams, 1-D real float32:
  K6 (kernels/pfb2.py, csrc/pfb2.cu) where dsptpu's pfb2 gate holds;
* arbitrary rate, 1-D real float32: K7 (kernels/arbd.py, csrc/arbd.cu)
  where dsptpu's arbd gate and plan checks accept;
* otherwise the block matmul (`_block_matmul`, torch.matmul in full
  float32) for rational rates, `_pfb_dot_arb` for arbitrary rates and
  dspbase.filt for single-rate filters.

Both kernel routes are taken for CPU tensors too, where the wrappers
run their plain PyTorch versions.
"""

from fractions import Fraction
import math

import numpy as np
import torch
import torch.nn.functional as F

from .design import resample_filter
from ..kernels import arbd as _arbd
from ..kernels import pfb2 as _pfb2
from ..utils.device import as_tensor, full_f32

__all__ = ["FIRFilter", "taps2pfb", "outputlength", "inputlength",
           "resample", "polyphase_filt", "timedelay"]


def timedelay(f):
    """Group delay of a streaming filter in input samples (reference
    stream_filt.jl:400-403 exports the free function form)."""
    return f.timedelay()


def taps2pfb(h, nphi):
    """Reshape taps into a (tapsPerPhi, nphi) polyphase bank, flipped
    so a column dotted with a chronological input window applies the
    convolution (reference stream_filt.jl:294-307)."""
    h = np.asarray(h)
    hlen = len(h)
    taps_per_phi = -(-hlen // nphi)
    padded = np.zeros(taps_per_phi * nphi, h.dtype)
    padded[:hlen] = h
    # row r (0-based, bottom-up time order), col c holds h[r*nphi + c]
    return padded.reshape(taps_per_phi, nphi)[::-1].copy()


# ---------------------------------------------------------------------------
# device routes outside the kernels
# ---------------------------------------------------------------------------

def _torch_dtype(dt):
    if isinstance(dt, torch.dtype):
        return dt
    return torch.from_numpy(np.zeros(0, np.dtype(dt))).dtype


def _tap_dtype(h_dtype, x_dtype):
    """Computation dtype for taps h applied to input x: keep the
    input's precision, but never silently discard complex taps
    (the reference FIRFilter is generic over tap eltype,
    stream_filt.jl:137-210). Takes numpy or torch dtypes."""
    h_dtype = _torch_dtype(h_dtype)
    x_dtype = _torch_dtype(x_dtype)
    if not (x_dtype.is_floating_point or x_dtype.is_complex):
        x_dtype = torch.promote_types(x_dtype, torch.float32)
    if h_dtype.is_complex and not x_dtype.is_complex:
        return torch.promote_types(h_dtype, x_dtype)
    return x_dtype


@full_f32()
def _block_matmul(xcat, G, s0, B, M, W, out_len):
    """Block-polyphase filtering as a regular matmul.

    Outputs are grouped into B blocks of L = G.shape[1] consecutive
    outputs; block b reads the input window xcat[s0 + b*M : +W] (frames
    built from shifted strided reshapes, no gather) and multiplies the
    (W, L) banded matrix G whose column p holds the taps of the p-th
    in-block output at its intra-block offset. xcat: (n, *chans)."""
    L = G.shape[1]
    xc = xcat.movedim(0, -1)                           # (*chans, n)
    q = -(-(W - M) // M) if W > M else 0
    needed = s0 + (B + q + 1) * M
    pad = max(needed - xc.shape[-1], 0)
    if pad:
        xc = F.pad(xc, (0, pad))
    dt = torch.promote_types(xc.dtype, G.dtype)
    Gd = G.to(dt)
    lead = tuple(xc.shape[:-1])
    parts = [xc[..., s0 + j * M: s0 + (B + j) * M].reshape(lead + (B, M))
             for j in range(q + 1)]
    if 1 <= q <= 3:
        # few wide parts: multiply each part against its row band of G
        # and sum, without building the concatenated frame matrix
        Gp = F.pad(Gd, (0, 0, 0, (q + 1) * M - W))
        y = None
        for j in range(q + 1):
            fj = parts[j].reshape(-1, M).to(dt)
            t = fj @ Gp[j * M: (j + 1) * M]
            y = t if y is None else y + t
    else:
        frames = torch.cat(parts, -1)[..., :W]
        y = frames.reshape(-1, frames.shape[-1]).to(dt) @ Gd
    y = y.reshape(lead + (B * L,))[..., :out_len]
    return y.movedim(-1, 0)


def _tail(xcat, keep):
    """The last `keep` samples of xcat, as a copy (a view would change
    if the caller later wrote into its chunk)."""
    return xcat[xcat.shape[0] - keep:].clone()


def _block_filt_step(history, x, G, s0, B, M, W, out_len):
    """One streaming step: history concat, block matmul, history tail."""
    keep = history.shape[0]
    xcat = torch.cat([history, x], 0) if keep else x
    y = _block_matmul(xcat, G, s0, B, M, W, out_len)
    return y, (_tail(xcat, keep) if keep else None)


def _standard_filt_step(history, x, h):
    from ..ops import dspbase
    keep = history.shape[0]
    xcat = torch.cat([history, x], 0) if keep else x
    y = dspbase.filt(h, None, xcat)
    return y[keep:], (_tail(xcat, keep) if keep else None)


def _pfb_dot(xcat, pfb_t, end_idx, phi_idx, winlen):
    """y[j] = dot(pfb_t[phi[j]], xcat[end[j]-winlen+1 : end[j]+1]).
    xcat: (n, *chans); pfb_t: (nphi, winlen); returns (outLen, *chans).

    One gather of xcat per tap, summed in tap order, so no
    (outLen, winlen) window matrix is ever held."""
    start = end_idx.long() - (winlen - 1)
    phi = phi_idx.long()
    dt = torch.promote_types(xcat.dtype, pfb_t.dtype)
    cols = pfb_t.to(dt)
    y = None
    for t in range(winlen):
        win = xcat[start + t].to(dt)                   # (o, *chans)
        c = cols[phi, t]
        term = win * c.reshape(c.shape + (1,) * (win.ndim - 1))
        y = term if y is None else y + term
    return y


def _pfb_dot_arb(xcat, pfb_t, dpfb_t, end_idx, phi_idx, alpha, winlen):
    """Arbitrary rate: linear interpolation between a phase filter and
    its derivative bank (reference stream_filt.jl:579-625),
    y = lo + alpha * hi with lo and hi the two banks' dots.

    The port's counterpart of both of dsptpu's non-kernel arbitrary-rate
    routes: the all-phase convolution with a gather (`_pfb_dot_arb`,
    which holds a (2 nphi, n) tensor) and the gather-free drift scan
    (`_arb_drift_plan`, `_arb_drift_table`, `_pfb_dot_arb_drift`). The
    drift scan exists because gathers are slow on a TPU; on the card the
    dual-PFB dot is a plain gather per tap."""
    lo = _pfb_dot(xcat, pfb_t, end_idx, phi_idx, winlen)
    hi = _pfb_dot(xcat, dpfb_t, end_idx, phi_idx, winlen)
    a = alpha.to(lo.dtype)
    return lo + a.reshape(a.shape + (1,) * (lo.ndim - 1)) * hi


# ---------------------------------------------------------------------------
# kernel state objects (host ints and numpy coefficient arrays)
# ---------------------------------------------------------------------------

class FIRStandard:
    def __init__(self, h):
        self.h = np.asarray(h)
        self.hlen = len(self.h)
        self.history_len = self.hlen - 1
        self.pfb_t = np.ascontiguousarray(self.h[::-1][None, :])  # (1, hlen)

    def reset(self):
        pass

    def plan(self, xlen):
        """Return (end_idx, phi_idx, out_len); indices are 1-based input
        positions (window end), to be offset by history_len."""
        j = np.arange(xlen)
        return j + 1, np.zeros(xlen, np.int64), xlen

    def commit(self, xlen, out_len):
        pass

    def output_length(self, xlen):
        return xlen

    def input_length(self, outlen, roundup=False):
        return outlen

    def timedelay(self):
        return (self.hlen - 1) / 2


class FIRInterpolator:
    def __init__(self, h, interpolation):
        pfb = taps2pfb(h, interpolation)
        self.pfb_t = np.ascontiguousarray(pfb.T)
        self.taps_per_phi, self.nphi = pfb.shape
        self.interpolation = interpolation
        self.hlen = len(np.asarray(h))
        self.history_len = self.taps_per_phi - 1
        self.input_deficit = 1
        self.phi_idx = 1

    def reset(self):
        self.input_deficit = 1
        self.phi_idx = 1

    def plan(self, xlen):
        if xlen < self.input_deficit:
            return None, None, 0
        out_len = outputlength(xlen - self.input_deficit + 1,
                               Fraction(self.interpolation), self.phi_idx)
        q = self.phi_idx - 1 + np.arange(out_len)
        end_idx = self.input_deficit + q // self.nphi
        phi_idx = q % self.nphi
        return end_idx, phi_idx, out_len

    def commit(self, xlen, out_len):
        if out_len == 0:
            self.input_deficit -= xlen
            return
        q_next = self.phi_idx - 1 + out_len
        # after the last emitted output the loop leaves inputIdx at
        # deficit + q_next//nphi; all inputs consumed -> deficit resets
        self.phi_idx = q_next % self.nphi + 1
        self.input_deficit = 1

    def output_length(self, xlen):
        return outputlength(xlen - self.input_deficit + 1,
                            Fraction(self.interpolation), self.phi_idx)

    def input_length(self, outlen, roundup=False):
        return (inputlength(outlen, Fraction(self.interpolation),
                            self.phi_idx, roundup)
                + self.input_deficit - 1)

    def timedelay(self):
        return (self.hlen - 1) / (2 * self.nphi)


class FIRDecimator:
    def __init__(self, h, decimation):
        self.h = np.asarray(h)
        self.hlen = len(self.h)
        self.decimation = decimation
        self.history_len = self.hlen - 1
        self.input_deficit = 1
        self.pfb_t = np.ascontiguousarray(self.h[::-1][None, :])

    def reset(self):
        self.input_deficit = 1

    def plan(self, xlen):
        if xlen < self.input_deficit:
            return None, None, 0
        out_len = (xlen - self.input_deficit) // self.decimation + 1
        end_idx = self.input_deficit + self.decimation * np.arange(out_len)
        return end_idx, np.zeros(out_len, np.int64), out_len

    def commit(self, xlen, out_len):
        if out_len == 0:
            self.input_deficit -= xlen
            return
        last = self.input_deficit + self.decimation * (out_len - 1)
        self.input_deficit = last + self.decimation - xlen

    def output_length(self, xlen):
        return outputlength(xlen - self.input_deficit + 1,
                            Fraction(1, self.decimation), 1)

    def input_length(self, outlen, roundup=False):
        return (inputlength(outlen, Fraction(1, self.decimation), 1, roundup)
                + self.input_deficit - 1)

    def timedelay(self):
        return (self.hlen - 1) / 2


class FIRRational:
    def __init__(self, h, ratio):
        ratio = Fraction(ratio)
        self.ratio = ratio
        pfb = taps2pfb(h, ratio.numerator)
        self.pfb_t = np.ascontiguousarray(pfb.T)
        self.taps_per_phi, self.nphi = pfb.shape
        self.hlen = len(np.asarray(h))
        self.history_len = self.taps_per_phi - 1
        self.phi_idx = 1
        self.input_deficit = 1

    def reset(self):
        self.phi_idx = 1
        self.input_deficit = 1

    def plan(self, xlen):
        if xlen < self.input_deficit:
            return None, None, 0
        num, den = self.ratio.numerator, self.ratio.denominator
        out_len = outputlength(xlen - self.input_deficit + 1, self.ratio,
                               self.phi_idx)
        j = np.arange(out_len)
        q = self.phi_idx - 1 + j * den
        end_idx = self.input_deficit + q // num
        phi_idx = q % num
        return end_idx, phi_idx, out_len

    def commit(self, xlen, out_len):
        if out_len == 0:
            self.input_deficit -= xlen
            return
        num, den = self.ratio.numerator, self.ratio.denominator
        q_next = self.phi_idx - 1 + out_len * den
        self.input_deficit = self.input_deficit + q_next // num - xlen
        self.phi_idx = q_next % num + 1

    def output_length(self, xlen):
        return outputlength(xlen - self.input_deficit + 1, self.ratio,
                            self.phi_idx)

    def input_length(self, outlen, roundup=False):
        return (inputlength(outlen, self.ratio, self.phi_idx, roundup)
                + self.input_deficit - 1)

    def timedelay(self):
        return (self.hlen - 1) / (2 * self.nphi)


class FIRArbitrary:
    """Dual-PFB arbitrary-rate resampler: polyphase filter plus its
    derivative bank for intra-phase linear interpolation (reference
    stream_filt.jl:92-134; Harris 7.6.1)."""

    def __init__(self, h, rate, nphi=32):
        if rate <= 0:
            raise ValueError("rate must be greater than 0")
        h = np.asarray(h)
        if not np.issubdtype(h.dtype, np.inexact):
            h = h.astype(np.float64)
        dh = np.append(np.diff(h), h.dtype.type(0))
        pfb = taps2pfb(h, nphi)
        dpfb = taps2pfb(dh, nphi)
        self.pfb_t = np.ascontiguousarray(pfb.T)
        self.dpfb_t = np.ascontiguousarray(dpfb.T)
        self.rate = float(rate)
        self.nphi = nphi
        self.taps_per_phi = pfb.shape[0]
        self.hlen = len(h)
        self.history_len = self.taps_per_phi - 1
        self.delta = nphi / rate
        self.phi_accumulator = 0.0
        self.input_deficit = 1
        self._anchor()

    def _anchor(self):
        """Re-anchor the stream's closed form at the CURRENT state.
        Chunked streaming stays bit-identical to one-shot because every
        output's accumulator is evaluated with the SAME float64
        expression acc_base + J*delta at its stream-global index J.
        Re-basing the accumulator each chunk (mod and re-add) rounds
        differently and flips phase-wrap boundaries (the reference's
        sequential accumulation, stream_filt.jl:567-577, is
        chunk-invariant by construction)."""
        self._acc_base = float(self.phi_accumulator)
        self._deficit_base = int(self.input_deficit)
        self._j_total = 0
        self._consumed_total = 0

    def reset(self):
        self.phi_accumulator = 0.0
        self.input_deficit = 1
        self._anchor()

    def plan(self, xlen):
        if xlen < self.input_deficit:
            return None, None, 0
        # closed form of the reference's accumulator recurrence
        # (stream_filt.jl:567-577): acc_J = acc_base + J*delta at the
        # stream-global output index J (see _anchor)
        est = int(math.ceil((xlen - self.input_deficit + 1) * self.rate
                            - self.phi_accumulator / self.delta)) + 2
        est = max(est, 1)
        while True:
            j = self._j_total + np.arange(est)
            acc = self._acc_base + j * self.delta
            x_idx = (self._deficit_base - self._consumed_total
                     + np.floor(acc / self.nphi).astype(np.int64))
            valid = x_idx <= xlen
            if not valid.all():
                break
            est *= 2  # estimate undershot (rare, pathological rates)
        out_len = int(np.count_nonzero(valid))
        if out_len == 0:
            return None, None, 0
        acc = acc[:out_len]
        rem = np.mod(acc, self.nphi)
        phi_idx = np.floor(rem).astype(np.int64)
        alpha = rem - phi_idx
        return (x_idx[:out_len], phi_idx, out_len), alpha, out_len

    def commit(self, xlen, out_len):
        self._j_total += out_len
        self._consumed_total += xlen
        acc_next = self._acc_base + self._j_total * self.delta
        self.input_deficit = (self._deficit_base - self._consumed_total
                              + int(math.floor(acc_next / self.nphi)))
        self.phi_accumulator = float(np.mod(acc_next, self.nphi))

    def output_length(self, xlen):
        return int(math.ceil((xlen - self.input_deficit + 1) * self.rate
                             - self.phi_accumulator / self.delta))

    def input_length(self, outlen, roundup=False):
        d = 1 if roundup else 0
        inlen = math.floor((outlen - d + self.phi_accumulator / self.delta)
                           / self.rate) + d
        return int(inlen) + self.input_deficit - 1

    def timedelay(self):
        return (self.hlen - 1) / (2 * self.nphi)


# ---------------------------------------------------------------------------
# length algebra (reference stream_filt.jl:317-393): integer math
# ---------------------------------------------------------------------------

def outputlength(input_length, ratio, initial_phi):
    ratio = Fraction(ratio)
    num, den = ratio.numerator, ratio.denominator
    return -(-(input_length * num - initial_phi + 1) // den)


def inputlength(output_length, ratio, initial_phi, roundup=False):
    ratio = Fraction(ratio)
    num, den = ratio.numerator, ratio.denominator
    d = den if roundup else 1
    val = Fraction(output_length * den + initial_phi - d, num)
    if roundup:
        return int(math.ceil(val))
    return int(math.floor(val))


# ---------------------------------------------------------------------------
# FIRFilter
# ---------------------------------------------------------------------------

def _rate_lm(k):
    """(L, M, phi0) of a rational, interpolating or decimating kernel."""
    if isinstance(k, FIRRational):
        return k.ratio.numerator, k.ratio.denominator, k.phi_idx
    if isinstance(k, FIRInterpolator):
        return k.interpolation, 1, k.phi_idx
    if isinstance(k, FIRDecimator):
        return 1, k.decimation, 1
    raise TypeError(type(k))


def _dev_copy(k, attr, arr, dtype, device):
    """arr as a tensor of `dtype` on `device`, uploaded once and cached
    on the kernel object under `attr`."""
    key = (dtype, str(device))
    hit = getattr(k, attr, None)
    if hit is None or hit[0] != key:
        hit = (key, torch.as_tensor(np.ascontiguousarray(arr)).to(
            device=device, dtype=dtype))
        setattr(k, attr, hit)
    return hit[1]


class FIRFilter:
    """Stateful streaming polyphase FIR filter (reference
    stream_filt.jl:137-210). Accepts a tap vector and a rate:

      FIRFilter(h)                  single-rate
      FIRFilter(h, 3)               interpolate by 3
      FIRFilter(h, Fraction(2, 3))  rational resample
      FIRFilter(h, 0.997, 32)       arbitrary rate, 32-phase dual PFB
      FIRFilter(rate)               taps from resample_filter(rate)

    Chunked `filt` calls carry history/phase/deficit state so the
    concatenated output equals one-shot filtering. Inputs may have
    trailing channel dims (a superset of the reference, which is
    vector-only and maps slices). Taps stay host numpy; a numpy or list
    input goes to `device=` of `filt` (CUDA by default)."""

    def __init__(self, h, rate=None, nphi=32):
        if np.ndim(h) == 0:
            # FIRFilter(rate[, nphi]): design the taps (reference
            # stream_filt.jl:202-210)
            rate = h
            h = (resample_filter(rate, nphi) if isinstance(rate, float)
                 else resample_filter(Fraction(rate)))
        h = np.asarray(h)
        if rate is None:
            rate = 1
        if isinstance(rate, float):
            # a float rate always selects the dual-PFB arbitrary kernel,
            # matching the reference's Float dispatch
            self.kernel = FIRArbitrary(h, rate, nphi)
        else:
            ratio = Fraction(rate)
            if ratio == 1:
                self.kernel = FIRStandard(h)
            elif ratio.denominator == 1:
                self.kernel = FIRInterpolator(h, ratio.numerator)
            elif ratio.numerator == 1:
                self.kernel = FIRDecimator(h, ratio.denominator)
            else:
                self.kernel = FIRRational(h, ratio)
        self.h = h
        self.history_len = self.kernel.history_len
        self.history = None  # allocated lazily to match channel dims

    # -- state management ---------------------------------------------------

    def reset(self):
        self.history = None
        self.kernel.reset()
        # a restarted stream gets its streaming-kernel budget back
        # (the <= 4 distinct-state guard is per active stream, not per
        # filter-object lifetime)
        if hasattr(self.kernel, "_pfb2_states"):
            self.kernel._pfb2_states.clear()
        return self

    def setphase(self, phi):
        """Adjust the stream phase (reference setphase!
        stream_filt.jl:216-241)."""
        if phi < 0:
            raise ValueError("phi must be >= 0")
        k = self.kernel
        if isinstance(k, FIRStandard):
            raise TypeError("setphase undefined for single-rate filters")
        if isinstance(k, FIRDecimator):
            k.input_deficit += int(round(phi))
        elif isinstance(k, (FIRInterpolator, FIRRational)):
            throwaway, phi_idx = divmod(int(round(phi * k.nphi)), k.nphi)
            k.input_deficit += throwaway
            k.phi_idx = phi_idx + 1
        else:  # FIRArbitrary
            frac, whole = math.modf(phi)
            k.input_deficit += int(round(whole))
            k.phi_accumulator = frac * k.nphi
            k._anchor()
        return self

    def output_length(self, xlen):
        return self.kernel.output_length(xlen)

    def input_length(self, outlen, roundup=False):
        return self.kernel.input_length(outlen, roundup)

    def timedelay(self):
        return self.kernel.timedelay()

    # -- filtering ----------------------------------------------------------

    def _ensure_history(self, x):
        if (self.history is None or self.history.shape[1:] != x.shape[1:]
                or self.history.dtype != x.dtype
                or self.history.device != x.device):
            # cache the zero history: reset() + filt() per chunk would
            # otherwise allocate it every call. Nothing writes into it.
            key = (tuple(x.shape[1:]), x.dtype, str(x.device))
            zc = getattr(self, "_zero_hist", None)
            if zc is None or zc[0] != key:
                self._zero_hist = zc = (key, torch.zeros(
                    (self.history_len,) + tuple(x.shape[1:]),
                    dtype=x.dtype, device=x.device))
            self.history = zc[1]

    def _pfb2_filt(self, k, x, xlen, out_len):
        """K6 route (kernels/pfb2) for 1-D real float32 rational,
        interpolating and decimating streams: fresh (the resample() hot
        path) or mid-stream (the window geometry shifts by history_len,
        exactly the block matmul's s0). Returns (y, new_history) or None
        for the block matmul (channels, other types, geometry outside
        dsptpu's gate, or streams that churn through entry states)."""
        if x.ndim != 1 or x.dtype != torch.float32:
            return None
        if np.iscomplexobj(k.pfb_t):
            return None
        fresh = (self.history_len == 0
                 or (getattr(self, "_zero_hist", None) is not None
                     and self.history is self._zero_hist[1]))
        # dsptpu's kernel needs >= 8 rows of 128 samples
        if (0 if fresh else self.history_len) + xlen < 8 * 128:
            return None
        if not fresh:
            # dsptpu builds a multi-MB tap table per (phi0, deficit)
            # entry state and allows a handful per stream (periodic
            # chunk streams repeat quickly); churners take the block
            # matmul for good. The port keeps the budget as the route's
            # gate. A state takes its slot before the gate below runs.
            if self.history.is_complex():
                return None
            seen = getattr(k, "_pfb2_states", None)
            if seen is None:
                seen = k._pfb2_states = set()
            state = (int(k.phi_idx) if hasattr(k, "phi_idx") else 1,
                     int(k.input_deficit), int(xlen))
            if state not in seen:
                if len(seen) >= 4:
                    return None
                seen.add(state)
        L, M, phi0 = _rate_lm(k)
        deficit_eff = int(k.input_deficit) + (
            0 if fresh else int(self.history_len))
        # the gate verdict is cached per entry state: the gate runs per
        # filt() call on the resample hot path
        cached = getattr(k, "_pfb2_gate", None)
        if cached is None or cached[0] != (phi0, deficit_eff):
            taps = k.pfb_t.shape[1]
            ok = _pfb2.pfb2_supported(L, M, taps, torch.float32)
            # dsptpu's analytic verdict, from the window geometry alone
            fast = ok and _pfb2.pfb2_default_on(taps, L, M, int(phi0),
                                                deficit_eff)
            k._pfb2_gate = cached = ((phi0, deficit_eff), ok and fast)
        if not cached[1]:
            return None
        pfb = _dev_copy(k, "_pfb2_dev", k.pfb_t.T, torch.float32, x.device)
        if fresh:
            hl = self.history_len if (self.history_len
                                      and xlen >= self.history_len) else 0
            hist_arg = None
        else:
            hl = self.history_len
            hist_arg = self.history
        res = _pfb2.pfb2(hist_arg, x.contiguous(), pfb, L, M, phi0,
                         deficit_eff, out_len, hist_len=hl)
        return res if hl else (res, None)

    def _block_args(self, xlen):
        """Host-side planning for the block-matmul route: build the
        (W, L) banded tap matrix G for the kernel's current phase and
        the block geometry. Returns (G, s0, B, M, W, out_len)."""
        k = self.kernel
        L, M, phi0 = _rate_lm(k)
        pfb_t = k.pfb_t
        taps = k.hlen if isinstance(k, FIRDecimator) else k.taps_per_phi
        deficit = k.input_deficit
        out_len = k.output_length(xlen)
        cache = getattr(k, "_g_cache", None)
        if cache is None:
            cache = k._g_cache = {}
        key = phi0
        if key in cache:
            G, W, L, M = cache[key]
        else:
            offs = [(phi0 - 1 + M * p) // L for p in range(L)]
            W = max(offs) + taps
            G = np.zeros((W, L), dtype=pfb_t.dtype)
            for p in range(L):
                G[offs[p]: offs[p] + taps, p] = pfb_t[(phi0 - 1 + M * p) % L]
            if M < 128:
                # dsptpu super-blocks S base blocks so that the input
                # advance per block is >= 512 samples (a TPU layout
                # choice: M-sample frames pad to 128 lanes); it changes
                # no output, and the port keeps it
                S = -(-512 // M)
                Ws = (S - 1) * M + W
                Gs = np.zeros((Ws, S * L), dtype=G.dtype)
                for s in range(S):
                    Gs[s * M: s * M + W, s * L: (s + 1) * L] = G
                G, W, L, M = Gs, Ws, S * L, S * M
            cache[key] = (G, W, L, M)
        s0 = self.history_len + deficit - 1 - (taps - 1)
        B = -(-out_len // L)
        return G, s0, B, M, W, out_len

    def _filt_arbitrary(self, k, x, xlen):
        """Arbitrary rate: the host plan (cached per stream state), then
        K7 where dsptpu's arbd gate and plan checks accept, else
        _pfb_dot_arb. Returns (y, out_len, xcat or None)."""
        # the plan key includes the stream-global anchor counters:
        # (deficit, phi_accumulator) alone is not a complete state under
        # the global-index plan (a chunk that ends exactly on a phase
        # cycle reproduces (1, 0.0) mid-stream)
        key = (xlen, k.input_deficit, k.phi_accumulator, k._j_total,
               k._consumed_total, x.dtype, str(x.device), x.ndim == 1)
        cache = getattr(k, "_plan_cache", None)
        if cache is None or cache[0] != key:
            head, alpha, out_len = k.plan(xlen)
            dev = None
            use_kernel = False
            if out_len:
                x_idx, phi_idx = head[0], head[1]
                adt = (x.dtype if x.dtype.is_floating_point
                       else torch.float32)
                end0 = self.history_len + x_idx - 1   # 0-based in xcat
                dev = tuple(torch.as_tensor(a).to(x.device) for a in (
                    end0.astype(np.int32), phi_idx.astype(np.int32)))
                dev += (torch.as_tensor(alpha).to(device=x.device,
                                                  dtype=adt),)
                use_kernel = (
                    x.ndim == 1 and x.dtype == torch.float32
                    and not np.iscomplexobj(k.pfb_t)
                    and _arbd.arbd_supported(k.nphi, k.taps_per_phi,
                                             torch.float32)
                    and _arbd.arbd_accepts(x_idx, out_len,
                                           self.history_len + xlen))
            cache = k._plan_cache = (key, dev, out_len, use_kernel)
        _, dev, out_len, use_kernel = cache
        if not out_len:
            return torch.zeros((0,) + tuple(x.shape[1:]),
                               dtype=_tap_dtype(self.h.dtype, x.dtype),
                               device=x.device), 0, None
        if use_kernel:
            pfb = _dev_copy(k, "_pfb_dev", k.pfb_t.T, torch.float32,
                            x.device)
            dpfb = _dev_copy(k, "_dpfb_dev", k.dpfb_t.T, torch.float32,
                             x.device)
            hist = self.history if self.history_len else None
            y = _arbd.arbd(hist, x.contiguous(), dev[0], dev[1], dev[2],
                           pfb, dpfb, out_len)
            return y, out_len, None
        xcat = (torch.cat([self.history, x], 0) if self.history_len
                else x)
        dt = _tap_dtype(k.pfb_t.dtype, x.dtype)
        pfb_t = _dev_copy(k, "_pfb_t_dev", k.pfb_t, dt, x.device)
        dpfb_t = _dev_copy(k, "_dpfb_t_dev", k.dpfb_t, dt, x.device)
        y = _pfb_dot_arb(xcat, pfb_t, dpfb_t, dev[0], dev[1], dev[2],
                         k.taps_per_phi)
        return y, out_len, xcat

    def filt(self, x, device=None):
        x = as_tensor(x, device)
        xlen = x.shape[0]
        self._ensure_history(x)
        k = self.kernel
        newhist = None
        xcat = None
        if isinstance(k, FIRArbitrary):
            y, out_len, xcat = self._filt_arbitrary(k, x, xlen)
        elif isinstance(k, FIRStandard):
            out_len = xlen
            h = _dev_copy(k, "_h_dev", k.h, _tap_dtype(k.h.dtype, x.dtype),
                          x.device)
            if self.history_len:
                y, newhist = _standard_filt_step(self.history, x, h)
            else:
                from ..ops import dspbase
                y = dspbase.filt(h, None, x)
        else:
            out_len = (k.output_length(xlen)
                       if xlen >= k.input_deficit else 0)
            pfb2_res = (self._pfb2_filt(k, x, xlen, out_len)
                        if out_len else None)
            if pfb2_res is not None:
                y, newhist = pfb2_res
            elif out_len:
                G, s0, B, M, W, out_len = self._block_args(xlen)
                # device copy cached per G: a fresh upload every call
                # would cost a host-to-device copy per chunk
                gdt = _tap_dtype(G.dtype, x.dtype)
                key = (id(G), gdt, str(x.device))
                dcache = getattr(k, "_g_dev", None)
                if dcache is None or dcache[0] != key:
                    k._g_dev = dcache = (key, torch.as_tensor(G).to(
                        device=x.device, dtype=gdt))
                Gd = dcache[1]
                if self.history_len:
                    y, newhist = _block_filt_step(self.history, x, Gd,
                                                  s0, B, M, W, out_len)
                else:
                    y = _block_matmul(x, Gd, s0, B, M, W, out_len)
            else:
                y = torch.zeros((0,) + tuple(x.shape[1:]),
                                dtype=_tap_dtype(self.h.dtype, x.dtype),
                                device=x.device)
        k.commit(xlen, out_len)
        if self.history_len:
            if newhist is not None:
                self.history = newhist
            elif xcat is not None:
                self.history = _tail(xcat, self.history_len)
            elif xlen >= self.history_len:
                # tail of x alone: the kernel routes never build
                # history + x
                self.history = _tail(x, self.history_len)
            else:
                self.history = _tail(torch.cat([self.history, x], 0),
                                     self.history_len)
        return y

    __call__ = filt


def polyphase_filt(h, x, rate, nphi=32, device=None):
    """Stateless one-shot `filt(h, x, rate)` (reference
    stream_filt.jl:663-672)."""
    return FIRFilter(h, rate, nphi).filt(x, device)


# ---------------------------------------------------------------------------
# resample
# ---------------------------------------------------------------------------

def _undelay(sf):
    sf.setphase(sf.timedelay())


def resample(x, rate, h=None, nphi=32, dims=None, device=None):
    """Resample x at rational or arbitrary `rate`, compensating the
    filter delay and zero-padding so input/output align (reference
    stream_filt.jl:688-775). `dims` selects the axis for N-D input."""
    x = as_tensor(x, device)
    if dims is None:
        if x.ndim != 1:
            raise ValueError("N-D input requires dims")
        axis = 0
    else:
        axis = dims % x.ndim
        x = x.movedim(axis, 0)

    if isinstance(rate, float):
        sf = FIRFilter(resample_filter(rate, nphi) if h is None else h,
                       rate, nphi)
        eff_rate = rate
    else:
        ratio = Fraction(rate)
        sf = FIRFilter(resample_filter(ratio) if h is None else h, ratio)
        eff_rate = ratio

    _undelay(sf)
    out_len = int(math.ceil(x.shape[0] * eff_rate))
    in_len = sf.input_length(out_len, roundup=True)
    pad = max(in_len - x.shape[0], 0)
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], 0)
    y = sf.filt(x)
    if y.shape[0] < out_len:
        raise AssertionError("resample output shorter than expected")
    y = y[:out_len]
    if dims is not None:
        y = y.movedim(0, axis)
    return y
