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
