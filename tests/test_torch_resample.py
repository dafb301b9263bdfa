"""Port parity for streaming polyphase resampling: dsptpu_torch's
stream_filt (host stream algebra, FIRFilter, polyphase_filt, resample),
the plain versions of K6 (kernels/pfb2.pfb2_reference) and K7
(kernels/arbd.arbd_reference), which the wrappers run on CPU tensors,
their gates, convert.firfilter_from_numpy and resample_entry, against
dsptpu on the same inputs.

Inputs come from a numpy seed and go to both packages as explicit
arrays. Tolerances: the host algebra, resample_filter and the gates are
exact; max|d| <= 1e-10 max|ref| in float64 (dsptpu runs under x64
here) and <= 3e-5 max|ref| in float32 (bench.py's resample bound), for
the plain versions against dsptpu's Pallas kernels in interpret mode as
for the whole filters. The arbitrary-rate stream is bit-exact chunked
against one-shot, as dsptpu's is."""

from fractions import Fraction

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
import jax.numpy as jnp

import dsptpu
import dsptpu_torch
from dsptpu.filters import stream_filt as jsf
from dsptpu.kernels import arbd as jarbd
from dsptpu.kernels import pfb2 as jpfb2
from dsptpu.ops import dspbase as jdspbase
from dsptpu_torch import convert, kernels
from dsptpu_torch.filters import stream_filt as tsf
from dsptpu_torch.kernels import arbd as tarbd
from dsptpu_torch.kernels import pfb2 as tpfb2

TOL = {np.float64: 1e-10, np.float32: 3e-5}
KINDS = [Fraction(1), Fraction(3), Fraction(1, 4), Fraction(3, 2),
         Fraction(147, 160), 0.9997, 1.25]


def check(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.max(np.abs(got.astype(np.float64) - want))
    assert err <= tol * np.max(np.abs(want)), err


def taps(rate, dtype=np.float64):
    """resample_filter(rate), or a 31-tap Hanning lowpass at rate 1."""
    if rate == 1:
        h = np.hanning(33)[1:-1]
        return (h / h.sum()).astype(dtype)
    return np.asarray(dsptpu.resample_filter(rate)).astype(dtype)


def signal(seed, shape, dtype):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def state_of(k):
    return {a: getattr(k, a) for a in (
        "phi_idx", "input_deficit", "phi_accumulator", "_acc_base",
        "_deficit_base", "_j_total", "_consumed_total") if hasattr(k, a)}


# -- host algebra: exact ----------------------------------------------------

@pytest.mark.parametrize("rate", [Fraction(147, 160), Fraction(3, 2),
                                  Fraction(1, 4), 5, 0.9997])
def test_resample_filter_is_dsptpus(rate):
    want = np.asarray(dsptpu.resample_filter(rate))
    got = np.asarray(dsptpu_torch.resample_filter(rate))
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_taps2pfb_and_length_algebra_are_dsptpus():
    rng = np.random.default_rng(0)
    for hlen in (1, 9, 32, 100, 111):
        h = rng.standard_normal(hlen)
        for nphi in (1, 3, 4, 32, 147):
            assert np.array_equal(tsf.taps2pfb(h, nphi),
                                  jsf.taps2pfb(h, nphi))
    for ratio in (Fraction(3, 2), Fraction(2, 3), Fraction(5),
                  Fraction(1, 4), Fraction(147, 160)):
        for phi0 in range(1, min(ratio.numerator, 20) + 1):
            for n in (1, 10, 147, 1000, 10_000_000):
                out = tsf.outputlength(n, ratio, phi0)
                assert out == jsf.outputlength(n, ratio, phi0)
                for up in (False, True):
                    assert (tsf.inputlength(out, ratio, phi0, up)
                            == jsf.inputlength(out, ratio, phi0, up))


@pytest.mark.parametrize("rate", KINDS)
def test_kernel_state_sequence_is_dsptpus(rate):
    """plan / commit over ragged chunks (some shorter than the window),
    setphase, the length methods and timedelay: exact."""
    h = taps(rate)
    fj, ft = jsf.FIRFilter(h, rate), tsf.FIRFilter(h, rate)
    assert type(ft.kernel).__name__ == type(fj.kernel).__name__
    if rate == 1:
        with pytest.raises(TypeError):
            ft.setphase(0.5)
    else:
        fj.setphase(fj.timedelay())
        ft.setphase(ft.timedelay())
    assert ft.timedelay() == fj.timedelay() == tsf.timedelay(ft)
    assert ft.history_len == fj.history_len
    for xlen in (1, 7, 100, 3, 2000, 57, 4096):
        kj, kt = fj.kernel, ft.kernel
        assert ft.output_length(xlen) == fj.output_length(xlen)
        for up in (False, True):
            assert ft.input_length(xlen, up) == fj.input_length(xlen, up)
        pj, pt = kj.plan(xlen), kt.plan(xlen)
        if isinstance(rate, float):
            (hj, aj, oj), (ht, at, ot) = pj, pt
            assert oj == ot
            if oj:
                for a, b in zip(hj, ht):
                    assert np.array_equal(np.asarray(a), np.asarray(b))
                assert np.array_equal(aj, at)
        else:
            assert pj[2] == pt[2]
            for a, b in zip(pj[:2], pt[:2]):
                assert (a is None and b is None) or np.array_equal(a, b)
        out_len = pj[2]
        kj.commit(xlen, out_len)
        kt.commit(xlen, out_len)
        assert state_of(kt) == state_of(kj)


# -- FIRFilter, polyphase_filt and resample against dsptpu -----------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("chans", [(), (3,)])
@pytest.mark.parametrize("rate", KINDS)
def test_firfilter_matches_dsptpu(rate, chans, dtype):
    """1-D float32 takes the kernel routes (plain versions here), the
    rest the block matmul, _pfb_dot_arb or dspbase.filt."""
    n = 40000 if not chans else 5000
    h, x = taps(rate, dtype), signal(n, (n,) + chans, dtype)
    want = jsf.FIRFilter(h, rate).filt(jnp.asarray(x))
    kernels.reset_launches()
    got = tsf.FIRFilter(h, rate).filt(torch.as_tensor(x))
    assert got.dtype == torch.from_numpy(x).dtype
    assert set(kernels.launch_counts().values()) == {0}
    check(got, want, TOL[dtype])


@pytest.mark.parametrize("rate", KINDS)
def test_routes_on_cpu_tensors(rate):
    """1-D float32 streams take K6 (rational rates where dsptpu's pfb2
    gate holds) and K7 (near-unity rates its arbd gate accepts) with
    the plain versions; channels take the non-kernel routes."""
    h = taps(rate, np.float32)
    f = tsf.FIRFilter(h, rate)
    f.filt(torch.as_tensor(signal(1, 40000, np.float32)))
    k = f.kernel
    if rate in (Fraction(1, 4), Fraction(3), Fraction(3, 2),
                Fraction(147, 160)):
        assert k._pfb2_gate[1]
    elif rate == 0.9997:
        assert k._plan_cache[3]
    elif rate == 1.25:             # duplicate positions: no K7
        assert not k._plan_cache[3]
    f = tsf.FIRFilter(h, rate)
    f.filt(torch.as_tensor(signal(1, (40000, 2), np.float32)))
    assert getattr(f.kernel, "_pfb2_gate", None) is None
    assert not getattr(f.kernel, "_plan_cache", (0, 0, 0, False))[3]


@pytest.mark.parametrize("rate", KINDS)
def test_chunked_equals_oneshot(rate):
    """Ragged chunks (one shorter than the window) equal one-shot and
    dsptpu's one-shot; the arbitrary rate bit for bit."""
    h = taps(rate, np.float32)
    x = signal(2, 40000, np.float32)
    cuts = [2500, 2503, 13001, 27777]
    one = tsf.FIRFilter(h, rate).filt(torch.as_tensor(x))
    f = tsf.FIRFilter(h, rate)
    got = torch.cat([f.filt(torch.as_tensor(c)) for c in np.split(x, cuts)])
    want = jsf.FIRFilter(h, rate).filt(jnp.asarray(x))
    if isinstance(rate, float):
        assert torch.equal(got, one)
    check(got, one.numpy().astype(np.float64), TOL[np.float32])
    check(got, want, TOL[np.float32])


def test_sample_by_sample_streaming_float64():
    """The first 60 inputs one at a time (the reference's harshest
    streaming pattern, test/filt_stream.jl:100-111), then the rest."""
    for rate in (Fraction(3), Fraction(1, 4), Fraction(147, 160), 0.9997):
        h = taps(rate)
        x = signal(3, 3000, np.float64)
        want = jsf.FIRFilter(h, rate).filt(jnp.asarray(x))
        f = tsf.FIRFilter(h, rate)
        parts = [f.filt(torch.as_tensor(x[i:i + 1])) for i in range(60)]
        parts.append(f.filt(torch.as_tensor(x[60:])))
        check(torch.cat(parts), want, TOL[np.float64])


def test_designed_taps_and_polyphase_filt():
    x = signal(4, 3000, np.float64)
    for rate in (Fraction(3, 2), 0.99):
        check(tsf.FIRFilter(rate).filt(torch.as_tensor(x)),
              jsf.FIRFilter(rate).filt(jnp.asarray(x)), TOL[np.float64])
        h = taps(rate)
        check(dsptpu_torch.polyphase_filt(h, torch.as_tensor(x), rate),
              jsf.polyphase_filt(h, jnp.asarray(x), rate), TOL[np.float64])


@pytest.mark.parametrize("dtype,n", [(np.float64, 3000),
                                     (np.float32, 40000)])
@pytest.mark.parametrize("rate", [Fraction(3, 2), Fraction(147, 160),
                                  Fraction(1, 2), 0.9997, 3.14159])
def test_resample_matches_dsptpu(rate, dtype, n):
    x = signal(5, n, dtype)
    want = dsptpu.resample(jnp.asarray(x), rate)
    got = dsptpu_torch.resample(torch.as_tensor(x), rate)
    check(got, want, TOL[dtype])


def test_resample_dims():
    x = signal(6, (73, 5), np.float64)
    for rate in (Fraction(3, 2), Fraction(1, 2), 1.2):
        check(dsptpu_torch.resample(torch.as_tensor(x), rate, dims=0),
              dsptpu.resample(jnp.asarray(x), rate, dims=0),
              TOL[np.float64])
    x = signal(7, (4, 100), np.float64)
    check(dsptpu_torch.resample(torch.as_tensor(x), Fraction(1, 2), dims=1),
          dsptpu.resample(jnp.asarray(x), Fraction(1, 2), dims=1),
          TOL[np.float64])
    with pytest.raises(ValueError):
        dsptpu_torch.resample(torch.as_tensor(x), Fraction(1, 2))


# -- K6: plain version and gates -------------------------------------------

def k6_case(rate, n, history, seed=8):
    """Arguments of one pfb2 call from a FIRFilter's kernel: fresh, or
    mid-stream with a random history, entry phase and deficit."""
    h = taps(rate, np.float32)
    L, M = rate.numerator, rate.denominator
    f = tsf.FIRFilter(h, rate)
    k = f.kernel
    hl = f.history_len
    rng = np.random.default_rng(seed)
    hist = None
    if history:
        if hasattr(k, "phi_idx"):
            k.phi_idx = L // 2 + 1
        k.input_deficit = 3
        hist = rng.standard_normal(hl).astype(np.float32)
    phi0 = getattr(k, "phi_idx", 1)
    out_len = k.output_length(n)
    deficit = k.input_deficit + (hl if history else 0)
    pfb = tsf.taps2pfb(h, L)
    x = rng.standard_normal(n).astype(np.float32)
    return hist, x, pfb, L, M, phi0, deficit, out_len, hl


@pytest.mark.parametrize("history", [False, True])
@pytest.mark.parametrize("rate", [Fraction(3, 2), Fraction(1, 4)])
def test_pfb2_plain_matches_pallas_interpret(rate, history):
    hist, x, pfb, L, M, phi0, deficit, out_len, hl = k6_case(rate, 40000,
                                                             history)
    yj, hj = jpfb2.pfb2_resample_pallas(
        x, pfb, L, M, phi0, deficit, out_len, S=4, interpret=True,
        hist_len=hl, hist=hist)
    y, h = tpfb2.pfb2(None if hist is None else torch.as_tensor(hist),
                      torch.as_tensor(x), torch.as_tensor(pfb), L, M, phi0,
                      deficit, out_len, hist_len=hl)
    check(y, yj, TOL[np.float32])
    assert np.array_equal(h.numpy(), np.asarray(hj))


@pytest.mark.parametrize("rate", [Fraction(147, 160), Fraction(441, 640)])
def test_pfb2_plain_matches_dsptpu_filter(rate):
    """147/160 (and the 441-phase bank of 441/640, whose L is the reduced
    numerator) against dsptpu's block matmul route, which dsptpu's own
    tests hold equal to its kernel: fresh, then mid-stream."""
    h = taps(rate, np.float32)
    x = signal(9, 61951, np.float32)
    fj = jsf.FIRFilter(h, rate)
    L, M = rate.numerator, rate.denominator
    pfb = torch.as_tensor(tsf.taps2pfb(h, L))
    hist = None
    for c in np.split(x, [40000]):
        k = fj.kernel
        hl = fj.history_len
        deficit = k.input_deficit + (0 if hist is None else hl)
        out_len = k.output_length(len(c))
        y, hist = tpfb2.pfb2(hist, torch.as_tensor(c), pfb, L, M,
                             k.phi_idx, deficit, out_len, hist_len=hl)
        check(y, fj.filt(jnp.asarray(c)), TOL[np.float32])


@pytest.mark.parametrize("rate", [Fraction(147, 160), Fraction(3, 2),
                                  Fraction(1, 4), Fraction(441, 640),
                                  Fraction(5)])
@pytest.mark.parametrize("history", [False, True])
def test_pfb2_block_spans_cover_every_window(rate, history):
    """csrc/pfb2.cu's tiles: the span each tile stages (from the first
    window of its first row) holds every window of its outputs, padding
    taps included, and fits the shared memory the wrapper sizes; and
    the plain version indexes those windows."""
    _, x, pfb, L, M, phi0, deficit, out_len, _ = k6_case(rate, 61951,
                                                         history)
    taps_ = pfb.shape[0]
    nt, nch, lanes, warps, k, span = tpfb2._launch_geometry(taps_, L, M,
                                                            phi0)
    assert nt % 8 == 0 and nt <= 64 and 0 <= nt * nch - taps_ < 8 * nch
    assert span <= tpfb2._MAX_SPAN and warps <= tpfb2._MAX_WARPS
    j = np.arange(out_len, dtype=np.int64)
    w = deficit - taps_ + (phi0 - 1 + j * M) // L
    tile = j // (tpfb2._ROWS * k * L)
    w0 = deficit - taps_ + tile * tpfb2._ROWS * k * M
    assert np.all(w >= w0) and np.all(w + nt * nch <= w0 + span)
    # the plain version's windows, through its own zero padding
    y = tpfb2.pfb2_reference(None, torch.as_tensor(x), torch.as_tensor(pfb),
                             L, M, phi0, deficit, out_len)
    xc = np.pad(x.astype(np.float64), (taps_ + 2, taps_ + 2))
    idx = w[:, None] + np.arange(taps_) + taps_ + 2
    want = np.sum(xc[idx] * pfb[:, (phi0 - 1 + j * M) % L].T, axis=1)
    check(y, want, TOL[np.float32])


def emulate_k6(hist, x, pfb, L, M, phi0, deficit, out_len):
    """float64 numpy emulation of csrc/pfb2.cu's walk, from the wrapper's
    geometry: tiles of _ROWS rows of P = k L outputs; thread slot
    (warp * lanes + lane, lane < lanes) keeps column (phi0 - 1 + c M) mod
    L for c = slot, slot + slots, ... < P, its window offset moving by
    k M a row, and by the carried step of (slots M) mod L a pass; each
    tile's shared span is staged from hist ‖ x (zero outside it) and NaN
    past it; taps pass in nch chunks of ct consecutive taps, taps // nch
    or one more, in nt register slots (nt - 8 <= ct <= nt), of which only
    the first ct are multiplied: no padding slot meets a sample past the
    window. Returns y, how often each output was written, and the most
    wavefronts (the most distinct words in one bank) that one warp's load
    took."""
    taps_ = pfb.shape[0]
    nt, nch, lanes, warps, k, span = tpfb2._launch_geometry(taps_, L, M,
                                                            phi0)
    rows = tpfb2._ROWS
    P, kM, slots = k * L, k * M, lanes * warps
    xcat = np.concatenate([[] if hist is None else hist, x])
    tiles = -(-out_len // (rows * P))
    pos = deficit - taps_ + (np.arange(tiles)[:, None] * rows * kM
                             + np.arange(span))
    inside = (pos >= 0) & (pos < len(xcat))
    xs = np.full((tiles, span + rows * kM + nt * nch), np.nan)
    xs[:, :span] = np.where(inside, xcat[np.clip(pos, 0, len(xcat) - 1)],
                            0.0)
    tid = np.arange(warps * 32)
    lane, warp = tid % 32, tid // 32
    slot = warp * lanes + lane
    active = (lane < lanes) & (slot < P)
    slot, warp = slot[active], warp[active]
    q0 = phi0 - 1 + slot * M
    col, off = q0 % L, q0 // L
    doff, dcol = divmod(slots * M, L)
    y = np.full(out_len, np.nan)
    written = np.zeros(out_len, np.int64)
    r, t = np.arange(rows), np.arange(nt)
    c, wavefronts = slot.copy(), 0
    while (m := c < P).any():
        for w_ in np.unique(warp[m]):     # one warp's load: its offsets
            o = off[m & (warp == w_)]
            wavefronts = max(wavefronts, max(
                len(np.unique(o[o % 32 == b])) for b in range(32)))
        acc = np.zeros((tiles, m.sum(), rows))
        cq, cr = divmod(taps_, nch)
        for ch in range(nch):
            t0, ct = ch * cq + min(ch, cr), cq + (ch < cr)
            assert nt - 8 <= ct <= nt
            h = pfb[t0 + t[:ct]][:, col[m]]
            idx = (off[m][:, None, None] + t0
                   + r[None, :, None] * kM + t[None, None, :ct])
            assert idx.max() + nt - ct < span   # padded windows fit too
            acc += np.einsum("sjrt,tj->sjr", xs[:, idx], h)
        j = (np.arange(tiles)[:, None, None] * rows * P
             + c[m][None, :, None] + r[None, None, :] * P)
        keep = j < out_len
        y[j[keep]] = acc[keep]
        np.add.at(written, j[keep], 1)
        c += slots
        col, off = col + dcol, off + doff
        off += col >= L
        col = np.where(col >= L, col - L, col)
    return y, written, wavefronts


EMU_RATES = [Fraction(147, 160), Fraction(3, 2), Fraction(441, 640),
             Fraction(1, 3), Fraction(7, 5), Fraction(1, 4)]


@pytest.mark.parametrize("history", [False, True])
@pytest.mark.parametrize("rate", EMU_RATES)
def test_pfb2_kernel_walk_emulated(rate, history):
    """The new K6 walk, emulated in float64, against the plain version
    (and, at 3/2 and 1/4, dsptpu's Pallas kernel in interpret mode):
    every output written once, no NaN (no read past a tile's staged
    span), no more wavefronts than the wrapper's model counted, and one
    a warp load at path C's two rates. 441/640 (a direct call; the gate
    keeps the route off it) runs its 441 columns in passes; 1/3's 111
    and 1/4's 147 taps run in chunks."""
    hist, x, pfb, L, M, phi0, deficit, out_len, hl = k6_case(rate, 40000,
                                                             history)
    taps_ = pfb.shape[0]
    assert (taps_ > 64) == (rate in (Fraction(1, 3), Fraction(1, 4)))
    y, written, wf = emulate_k6(hist, x, pfb, L, M, phi0, deficit, out_len)
    assert np.all(written == 1) and np.isfinite(y).all()
    lanes = tpfb2._columns(taps_, L, M)[2]
    assert wf <= tpfb2._wavefronts(lanes, L, M)
    if rate in (Fraction(147, 160), Fraction(3, 2)):
        assert wf == 1
    want = tpfb2.pfb2_reference(None if hist is None else torch.as_tensor(
        hist), torch.as_tensor(x), torch.as_tensor(pfb), L, M, phi0,
        deficit, out_len)
    check(torch.as_tensor(y), want.double().numpy(), TOL[np.float32])
    if rate in (Fraction(3, 2), Fraction(1, 4)):
        yj, _ = jpfb2.pfb2_resample_pallas(
            x, pfb, L, M, phi0, deficit, out_len, S=4, interpret=True,
            hist_len=hl, hist=hist)
        check(torch.as_tensor(y), np.asarray(yj, np.float64),
              TOL[np.float32])


@pytest.mark.parametrize("history", [False, True])
@pytest.mark.parametrize("rate", [Fraction(147, 160), Fraction(3, 2),
                                  Fraction(1, 4), "5 taps at 7/5"])
def test_pfb2_kernel_walk_emulated_nonfinite(rate, history):
    """An Inf and a NaN in the stream reach only the outputs whose windows
    hold them, in the emulated walk as in the plain version: no zero tap
    that pads a pass meets a sample past them (a random 5-tap bank takes
    the 8-slot template, 3 of its slots padding)."""
    if isinstance(rate, str):
        rng = np.random.default_rng(9)
        L, M, hl = 7, 5, 10
        pfb = rng.standard_normal((5, L))
        hist = rng.standard_normal(hl) if history else None
        x = rng.standard_normal(20000)
        phi0, deficit = (L // 2 + 1, 3 + hl) if history else (1, 1)
        out_len = 20000 * L // M
    else:
        hist, x, pfb, L, M, phi0, deficit, out_len, _ = k6_case(
            rate, 20000, history)
    x = x.copy()
    x[1000], x[5001] = np.inf, np.nan
    y, written, _ = emulate_k6(hist, x, pfb, L, M, phi0, deficit, out_len)
    want = tpfb2.pfb2_reference(None if hist is None else torch.as_tensor(
        hist), torch.as_tensor(x), torch.as_tensor(pfb), L, M, phi0,
        deficit, out_len).double().numpy()
    fin = np.isfinite(want)
    assert np.all(written == 1)
    assert 0 < (~fin).sum() <= 2 * (pfb.shape[0] * L // M + 1)
    assert np.array_equal(np.isfinite(y), fin)
    check(torch.as_tensor(y[fin]), want[fin], TOL[np.float32])


def test_pfb2_gates_are_dsptpus():
    for L, M, taps_ in [(147, 160, 41), (3, 2, 37), (1, 4, 129), (5, 1, 25),
                        (441, 640, 61), (1, 896, 2), (1, 800, 200),
                        (2, 3, 1026), (7, 5, 1), (1000, 999, 40)]:
        assert (tpfb2.pfb2_supported(L, M, taps_, torch.float32)
                == jpfb2.pfb2_supported(L, M, taps_, jnp.float32))
        assert not tpfb2.pfb2_supported(L, M, taps_, torch.float64)
        if tpfb2.pfb2_supported(L, M, taps_, torch.float32):
            for phi0, deficit in [(1, 1), (L, 3), (L // 2 + 1, 40)]:
                assert (tpfb2.pfb2_default_on(taps_, L, M, phi0, deficit)
                        == jpfb2.pfb2_default_on(taps_, L, M, phi0,
                                                 deficit))


# -- K7: plain version and gates -------------------------------------------

@pytest.mark.parametrize("rate", [0.9997, 0.999])
def test_arbd_plain_matches_pallas_interpret(rate, monkeypatch):
    """dsptpu's FIRFilter with its kernel forced on runs arbd in
    interpret mode on the CPU; the port's 1-D float32 stream runs K7's
    plain version. Fresh, then a second chunk mid-stream."""
    monkeypatch.setattr(jdspbase, "_PALLAS_OS", True)
    h = taps(rate, np.float32)
    fj, ft = jsf.FIRFilter(h, rate), tsf.FIRFilter(h, rate)
    x = signal(10, 80000 if rate == 0.9997 else 40000, np.float32)
    for c in np.split(x, [40000]) if rate == 0.9997 else [x]:
        want = fj.filt(jnp.asarray(c))
        assert fj.kernel._plan_cache[4] is not None
        got = ft.filt(torch.as_tensor(c))
        assert ft.kernel._plan_cache[3]
        check(got, want, TOL[np.float32])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_arbd_plain_matches_drift_path(dtype, monkeypatch):
    """dsptpu's XLA drift path (kernel off) where _arb_drift_plan
    accepts; float64 takes the port's _pfb_dot_arb, float32 K7's plain
    version."""
    monkeypatch.setattr(jdspbase, "_PALLAS_OS", False)
    rate = 0.9997
    h = taps(rate, dtype)
    x = signal(11, 50000, dtype)
    fj = jsf.FIRFilter(h, rate)
    k = fj.kernel
    head, alpha, out_len = k.plan(len(x))
    assert jsf._arb_drift_plan(head[0], head[1], alpha, out_len, k.nphi,
                               k.taps_per_phi) is not None
    want = fj.filt(jnp.asarray(x))
    ft = tsf.FIRFilter(h, rate)
    got = ft.filt(torch.as_tensor(x))
    assert ft.kernel._plan_cache[3] == (dtype == np.float32)
    check(got, want, TOL[dtype])


def test_arbd_gates_are_dsptpus():
    for nphi, taps_ in [(32, 38), (4, 2), (64, 38), (30, 38), (32, 129),
                        (32, 1), (8, 128)]:
        assert (tarbd.arbd_supported(nphi, taps_, torch.float32)
                == jarbd.arbd_supported(nphi, taps_, jnp.float32))
    assert not tarbd.arbd_supported(32, 38, torch.float64)
    for rate, n in [(0.9997, 40000), (0.99999, 40000), (0.999, 40000),
                    (1.0003, 40000), (0.93, 40000), (0.998, 70000),
                    (0.9997, 30000)]:
        f = jsf.FIRFilter(taps(rate, np.float32), rate)
        k = f.kernel
        head, alpha, out_len = k.plan(n)
        for xlen in (f.history_len + n, n):
            want = jarbd.arbd_plan(head[0], head[1], alpha, out_len,
                                   k.nphi, k.taps_per_phi, xlen)
            assert tarbd.arbd_accepts(head[0], out_len, xlen) == (
                want is not None), (rate, n, xlen)


# -- K7: the anchor (the plan's closed form) and the kernel's walk ---------

def arb_taps(rate):
    """resample_filter(rate) as float32, rate 1.0 included (taps() gives
    a 31-tap lowpass there, one tap a phase: no K7)."""
    return np.asarray(dsptpu.resample_filter(float(rate)), np.float32)


def _arb_state(rate, nphi, acc_base, j0, chunks, taps_per_phi=6):
    """A FIRArbitrary with phase accumulator acc_base, after `chunks`
    real chunks of 3001 samples and then a jump of about j0 outputs
    (stream state advanced by commit with the anchor's output count)."""
    k = tsf.FIRArbitrary(np.hanning(nphi * taps_per_phi), rate, nphi)
    k.phi_accumulator = float(acc_base)
    k._anchor()
    for _ in range(chunks):
        k.commit(3001, k.plan(3001)[2])
    if j0:
        xl = int(j0 / rate)
        an = k.anchor(5)
        k.commit(xl, 0 if xl < k.input_deficit
                 else tarbd.arbd_out_len(an, xl))
    return k


def _plan_matches(k, n, hl=5):
    """arbd_plan_from_anchor and arbd_out_len against FIRArbitrary.plan,
    bit for bit: end0 = hl + x_idx - 1, phi, alpha cast to float32."""
    head, alpha, out_len = k.plan(n)
    an = k.anchor(hl)
    got_len = 0 if n < k.input_deficit else tarbd.arbd_out_len(an, n)
    assert got_len == out_len
    if out_len:
        end0, phi, al = tarbd.arbd_plan_from_anchor(an, out_len)
        assert np.array_equal(end0, hl + head[0] - 1)
        assert np.array_equal(phi, head[1])
        assert np.array_equal(al.view(np.int32),
                              alpha.astype(np.float32).view(np.int32))
    return out_len


@pytest.mark.parametrize("nphi", list(range(4, 33, 4)))
def test_arbd_plan_from_anchor_is_the_host_plan(nphi):
    """The closed form K7 evaluates on the card equals FIRArbitrary.plan
    bit for bit: rates 0.9997, 0.5, 0.75, 0.999999, 1.0, 0.9 and 0.618,
    random acc_base, fresh, after chunks and at J0 up to 10^8."""
    rng = np.random.default_rng(nphi)
    for rate in (0.9997, 0.5, 0.75, 0.999999, 1.0, 0.9, 0.618):
        for chunks, j0 in ((0, 0), (2, 0), (1, int(rng.integers(10**6,
                                                                10**8)))):
            k = _arb_state(rate, nphi, rng.uniform(0, nphi), j0, chunks)
            assert _plan_matches(k, 4099) > 0


@settings(max_examples=60, deadline=None, derandomize=True)
@given(nphi=st.sampled_from(list(range(4, 33, 4))),
       rate=st.one_of(st.floats(0.9988, 1.0), st.sampled_from([0.5, 0.75])),
       frac=st.floats(0.0, 1.0, exclude_max=True),
       j0=st.integers(0, 2 ** 40), chunks=st.integers(0, 2))
def test_arbd_plan_from_anchor_hypothesis(nphi, rate, frac, j0, chunks):
    """The same, over drawn nphi (4-32 in steps of 4), rates in [0.9988,
    1.0] and 0.5, 0.75, acc_base, J0 up to 2^40, fresh or after
    chunks."""
    k = _arb_state(rate, nphi, frac * nphi, j0, chunks)
    _plan_matches(k, 2999)


GATE_CASES = [(0.9997, 40000), (0.99999, 40000), (0.999, 40000),
              (0.9990, 70000), (1.0003, 40000), (1.0, 40000),
              (0.93, 40000), (0.998, 70000), (0.9997, 30000),
              (0.9997, 32776), (0.9997, 32777), (0.9997, 32778),
              (0.99999, 32767), (0.99999, 32768), (0.9988, 40000)]


@pytest.mark.parametrize("state", ["fresh", "chunk", "J0 1e8"])
@pytest.mark.parametrize("rate,n", GATE_CASES)
def test_arbd_anchor_gate_is_the_array_gate(rate, n, state):
    """arbd_out_len and arbd_accepts_anchor from the anchor equal the
    host plan's out_len and arbd_accepts on its x_idx, and dsptpu's
    arbd_plan, for xlen = history + n and n, with out_len around SEG
    (32767-32778 samples: 32767-32769 outputs fresh), fresh, after a chunk and at J0 >= 10^8. The
    closed form decides without host arrays at rates below 1 (0.9997
    always); rate 1.0 asks for them."""
    f = tsf.FIRFilter(arb_taps(rate), rate)
    k = f.kernel
    hl = f.history_len
    if state == "chunk":
        k.commit(30011, k.plan(30011)[2])
    elif state == "J0 1e8":
        xl = 10 ** 8 + 12345
        k.commit(xl, tarbd.arbd_out_len(k.anchor(hl), xl))
    head, alpha, out_len = k.plan(n)
    an = k.anchor(hl)
    assert tarbd.arbd_out_len(an, n) == out_len
    for xlen in (hl + n, n):
        tarbd.gate_counts.update(anchor=0, host_arrays=0)
        got = tarbd.arbd_accepts_anchor(an, out_len, xlen)
        assert got == tarbd.arbd_accepts(head[0], out_len, xlen)
        want = jarbd.arbd_plan(head[0], head[1], alpha, out_len, k.nphi,
                               k.taps_per_phi, xlen)
        assert got == (want is not None), (rate, n, state, xlen)
        if out_len >= tarbd.SEG and rate < 1:
            assert tarbd.gate_counts == {"anchor": 1, "host_arrays": 0}
        if out_len >= tarbd.SEG and rate == 1.0:
            assert tarbd.gate_counts["host_arrays"] == 1


def test_arbd_route_builds_no_host_plan(monkeypatch):
    """The kernel route at 0.9997 (a CPU float32 stream, K7's plain
    version) never calls FIRArbitrary.plan, in one shot or in chunks
    of at least SEG outputs each,
    and gives what the host plan gives."""
    h = taps(0.9997, np.float32)
    x = signal(13, 110000, np.float32)
    want = tsf.FIRFilter(h, 0.9997).filt(torch.as_tensor(x))
    ref = tsf.FIRFilter(h, 0.9997)
    ref.kernel.plan(len(x))            # the host plan exists here
    tarbd.gate_counts.update(anchor=0, host_arrays=0)

    def no_plan(self, xlen):
        raise AssertionError("host plan built on the kernel route")
    monkeypatch.setattr(tsf.FIRArbitrary, "plan", no_plan)
    f = tsf.FIRFilter(h, 0.9997)
    assert torch.equal(f.filt(torch.as_tensor(x)), want)
    assert f.kernel._plan_cache[3]
    f = tsf.FIRFilter(h, 0.9997)
    got = torch.cat([f.filt(torch.as_tensor(c))
                     for c in np.split(x, [36001, 72007])])
    assert torch.equal(got, want)
    assert tarbd.gate_counts["host_arrays"] == 0


def emulate_k7(hist, x, anchor, pfb, dpfb, out_len):
    """float64 numpy emulation of csrc/arbd.cu's walk from the anchor:
    tiles of 256 R outputs (R = RUN) staging xcat[e_first - (W - 1),
    e_last + 2) from their first and last outputs' window ends (the whole
    tile's, past out_len too), NaN past the span and zero outside xcat,
    or nothing where the span exceeds the buffer. A thread's run of R
    outputs in the two-phase geometry (phase A, then from the split ks
    phase B and at most one extra input step) takes the window path for
    its outputs below ks (slot m's window starts at s0 + m, phase A)
    and leaves those from ks on to its block's split pass, one output a
    thread; a run outside it is computed one output at a time. Returns y,
    the runs computed one output at a time, the outputs of the split
    passes, the slot window positions the window path read and each
    tile's staged span."""
    R, threads = tarbd.RUN, 256
    tile = threads * R
    W = pfb.shape[0]
    cap = tile + tile // 8 + W + 8
    xcat = np.concatenate([[] if hist is None else hist, x]).astype(
        np.float64)
    tiles = -(-out_len // tile)
    e, ph, al = tarbd.arbd_plan_from_anchor(anchor, tiles * tile)
    e, ph, al = (a.reshape(tiles * threads, R) for a in (e, ph, al))
    et = e.reshape(tiles, -1)
    e_first, e_last = et[:, 0], et[:, -1]
    base = e_first - (W - 1)
    span = e_last - e_first + W + 1
    staged = span <= cap
    pos = base[:, None] + np.arange(cap)
    inside = (pos >= 0) & (pos < len(xcat))
    bufs = np.where(inside, xcat[np.clip(pos, 0, len(xcat) - 1)], 0.0)
    bufs[np.arange(cap)[None, :] >= span[:, None]] = np.nan
    run_tile = np.arange(tiles * threads) // threads
    i0 = np.arange(tiles * threads) * R
    live = i0 < out_len
    k = np.arange(R)
    e0, p0 = e[:, 0], ph[:, 0]
    isa = ph == p0[:, None]
    ks = np.where(isa.all(1), R, np.argmin(isa, 1))
    at = np.minimum(ks, R - 1)
    rows = np.arange(len(e0))
    d = e - e0[:, None] - k
    pb = np.where(ks < R, ph[rows, at], p0)
    step = np.where(ks < R, d[rows, at], 0)
    after = k[None, :] >= ks[:, None]
    ok = (staged[run_tile] & (e0 >= e_first[run_tile])
          & (e0 + R - 1 <= e_last[run_tile]) & ((step == 0) | (step == 1))
          & np.where(after, (ph == pb[:, None]) & (d == step[:, None]),
                     d == 0).all(1))
    y = np.full(tiles * tile, np.nan).reshape(-1, R)
    # window path: R slots of phase A, slot m's window at e0 - (W-1) + m;
    # output k < ks takes slot k
    f = np.flatnonzero(ok & live)
    wpos = e0[f, None, None] - (W - 1) + k[None, :, None] + np.arange(W)
    xw = bufs[run_tile[f, None, None], wpos - base[run_tile[f], None, None]]
    lo = np.einsum("smt,ts->sm", xw, pfb[:, p0[f]])
    hi = np.einsum("smt,ts->sm", xw, dpfb[:, p0[f]])
    y[f] = np.where(after[f], np.nan, lo + al[f] * hi)
    # the split passes and the runs outside the geometry: one output at
    # a time, from the span (split passes: always staged) or from xcat

    def one(r, kk):
        w = e[r, kk] - (W - 1) + np.arange(W)
        t_ = run_tile[r]
        if staged[t_]:
            assert w[0] >= base[t_] and w[-1] < base[t_] + span[t_]
            xv = bufs[t_, w - base[t_]]
        else:
            xv = np.where((w >= 0) & (w < len(xcat)),
                          xcat[np.clip(w, 0, len(xcat) - 1)], 0.0)
        return xv @ pfb[:, ph[r, kk]] + al[r, kk] * (xv @ dpfb[:, ph[r, kk]])
    split = 0
    for r in f[ks[f] < R]:
        for kk in range(ks[r], R):
            if i0[r] + kk < out_len:
                y[r, kk] = one(r, kk)
                split += 1
    slow = np.flatnonzero(~ok & live)
    for r in slow:
        for kk in range(R):
            y[r, kk] = one(r, kk)
    return (y.reshape(-1)[:out_len], len(slow), split,
            (run_tile[f], wpos), (base, span, staged))


K7_EMU_CASES = [(0.9997, "fresh"), (0.9997, "J0 1e8"), (0.9990, "fresh"),
                (0.9990, "chunk"), (0.99999, "fresh"), (0.99999, "chunk"),
                (1.0, "fresh"), (1.0, "chunk"), (0.9, "chunk"),
                (0.5, "fresh")]


@pytest.mark.parametrize("rate,state", K7_EMU_CASES)
def test_arbd_kernel_walk_emulated(rate, state):
    """The new K7 walk, emulated in float64 from the anchor, against the
    plain version on the host plan (3e-5 of max |ref|): every window the
    window path and the split passes read lies in its tile's staged span
    (and reads no NaN), and under dsptpu's gate no run is computed one
    output at a time and the split passes take fewer than R outputs a
    phase change. 0.9 (gate rejects: a phase every 3 outputs) and 0.5 (a
    tile's windows exceed the buffer: read from xcat) run one output at a
    time, still right."""
    f = tsf.FIRFilter(arb_taps(rate), rate)
    k = f.kernel
    hl = f.history_len
    rng = np.random.default_rng(14)
    hist = np.zeros(hl, np.float32)
    if state == "chunk":
        k.commit(30011, k.plan(30011)[2])
        hist = rng.standard_normal(hl).astype(np.float32)
    elif state == "J0 1e8":
        xl = 10 ** 8 + 12345
        k.commit(xl, tarbd.arbd_out_len(k.anchor(hl), xl))
        hist = rng.standard_normal(hl).astype(np.float32)
    n = 40037
    x = rng.standard_normal(n).astype(np.float32)
    head, alpha, out_len = k.plan(n)
    an = k.anchor(hl)
    pfb = np.ascontiguousarray(k.pfb_t.T, np.float32)
    dpfb = np.ascontiguousarray(k.dpfb_t.T, np.float32)
    y, slow, split, (ft, wpos), (base, span, staged) = emulate_k7(
        hist, x, an, pfb.astype(np.float64), dpfb.astype(np.float64),
        out_len)
    assert np.all(wpos >= base[ft, None, None])
    assert np.all(wpos < (base + span)[ft, None, None])
    gate = tarbd.arbd_accepts(head[0], out_len, hl + n)
    assert gate == (rate in (0.9997, 0.9990, 0.99999, 1.0))
    if gate:
        assert slow == 0 and staged.all()
        # a split pass takes the outputs from each phase change on in a
        # run: fewer than R for every change (one per nphi / (32 (1 /
        # rate - 1)) outputs), none at rate 1
        changes = np.count_nonzero(np.diff(head[1]))
        assert split < tarbd.RUN * (changes + 1)
        assert (split == 0) == (rate == 1.0)
    else:
        assert slow > 0
    assert (rate == 0.5) == (not staged.all())
    want = tarbd.arbd_reference(
        torch.as_tensor(hist), torch.as_tensor(x),
        torch.as_tensor(hl + head[0] - 1), torch.as_tensor(head[1]),
        torch.as_tensor(alpha.astype(np.float32)), torch.as_tensor(pfb),
        torch.as_tensor(dpfb), out_len)
    check(torch.as_tensor(y), want.double().numpy(), TOL[np.float32])


def test_arbd_wrapper_on_cpu_is_the_plain_version():
    """On a CPU tensor arbd builds the plan from the anchor and runs
    arbd_reference: bit for bit the plain version on the host plan;
    arbd_plan on the CPU is arbd_plan_from_anchor; a history that is not
    the anchor's is refused."""
    f = tsf.FIRFilter(taps(0.9997, np.float32), 0.9997)
    k, hl = f.kernel, f.history_len
    k.commit(30011, k.plan(30011)[2])
    rng = np.random.default_rng(15)
    hist = torch.as_tensor(rng.standard_normal(hl).astype(np.float32))
    x = torch.as_tensor(rng.standard_normal(40037).astype(np.float32))
    head, alpha, out_len = k.plan(40037)
    an = k.anchor(hl)
    pfb = torch.as_tensor(np.ascontiguousarray(k.pfb_t.T, np.float32))
    dpfb = torch.as_tensor(np.ascontiguousarray(k.dpfb_t.T, np.float32))
    kernels.reset_launches()
    got = tarbd.arbd(hist, x, an, pfb, dpfb, out_len)
    assert kernels.launch_counts()["arbd"] == 0
    want = tarbd.arbd_reference(
        hist, x, torch.as_tensor(hl + head[0] - 1), torch.as_tensor(head[1]),
        torch.as_tensor(alpha.astype(np.float32)), pfb, dpfb, out_len)
    assert torch.equal(got, want)
    e, p, a = tarbd.arbd_plan(an, out_len, "cpu")
    assert (e.dtype, p.dtype, a.dtype) == (torch.int64, torch.int32,
                                           torch.float32)
    assert np.array_equal(e.numpy(), hl + head[0] - 1)
    assert np.array_equal(p.numpy(), head[1])
    with pytest.raises(ValueError, match="history"):
        tarbd.arbd(hist[1:], x, an, pfb, dpfb, out_len)


# -- carried state, the driver, the device rule ----------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rate", [Fraction(1), Fraction(3), Fraction(1, 4),
                                  Fraction(147, 160), 0.9997])
def test_firfilter_from_numpy_carries_state(rate, dtype):
    """State read off a dsptpu FIRFilter mid-stream; both filters then
    continue on the same chunk (float32: the kernel routes' plain
    versions mid-stream)."""
    h = taps(rate, dtype)
    x = signal(12, 77777, dtype)
    fj = jsf.FIRFilter(h, rate)
    fj.filt(jnp.asarray(x[:33333]))
    state = state_of(fj.kernel)
    state["history"] = np.asarray(fj.history)
    ft = convert.firfilter_from_numpy(h, rate, state=state, device="cpu")
    assert state_of(ft.kernel) == state_of(fj.kernel)
    got = ft.filt(torch.as_tensor(x[33333:]))
    check(got, fj.filt(jnp.asarray(x[33333:])), TOL[dtype])
    assert state_of(ft.kernel) == state_of(fj.kernel)
    if dtype == np.float32 and rate == Fraction(147, 160):
        assert ft.kernel._pfb2_states       # the mid-stream K6 route


def test_resample_entry_matches_dsptpu():
    """resample_entry on the CPU at a small n: each rate against
    dsptpu's FIRFilter with the same taps and the same reset/filt
    calls; the kernel routes are taken (plain versions, no launch), and
    a second call gives the same outputs from the cached plans."""
    fwd, (x,) = dsptpu_torch.resample_entry(device="cpu", n=50000,
                                            arb_n=40000)
    assert np.array_equal(
        x.numpy(),
        np.random.default_rng(0).standard_normal(50000).astype(np.float32))
    kernels.reset_launches()
    ys = fwd(x)
    assert set(kernels.launch_counts().values()) == {0}
    xs = (x.numpy(), x.numpy(), x.numpy()[:40000])
    for r, y, xr in zip(dsptpu_torch.pipeline.RESAMPLE_RATES, ys, xs):
        want = jsf.FIRFilter(taps(r, np.float32), r).filt(jnp.asarray(xr))
        assert y.dtype == torch.float32
        check(y, want, TOL[np.float32])
    for y, y2 in zip(ys, fwd(x)):
        assert torch.equal(y, y2)


def test_resample_entry_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("the refusal shows only without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        dsptpu_torch.resample_entry(n=1000)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsf.FIRFilter(taps(Fraction(3, 2)), Fraction(3, 2)).filt(
            np.zeros(100))
