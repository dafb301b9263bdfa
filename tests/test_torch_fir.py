"""Port parity for the FIR path: dsptpu_torch's filt(b, x) against
dsptpu.filt, and the plain version of K1 (kernels/fir.fir_reference,
what the wrapper runs on a CPU tensor) against dsptpu's Pallas FIR
kernel in interpret mode.

Inputs come from a numpy seed and go to both packages as explicit
float32 or float64 arrays. Tolerances: max|d| <= 1e-10 max|ref| in
float64, <= 3e-5 max|ref| in float32 (bench.py's FIR bound)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import dsptpu
import dsptpu_torch
from dsptpu.kernels.fir import fir_pallas
from dsptpu_torch.convert import taps_from_numpy
from dsptpu_torch.kernels import fir as tfir

TOL = {np.float64: 1e-10, np.float32: 3e-5}


def check(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.max(np.abs(got.astype(np.float64) - want))
    assert err <= tol * np.max(np.abs(want)), err


@pytest.mark.parametrize("n,shape,nb,dtype", [
    (5000, (3,), 127, np.float64),      # block-Toeplitz product
    (40000, (3,), 127, np.float32),     # K1 gate (plain K1 on the CPU)
    (40001, (), 127, np.float32),       # K1 gate, 1-D signal
    (33000, (2, 2), 300, np.float32),   # K1 gate, 2 channel dims
    (300, (2,), 127, np.float64),       # n < 4 nb: convolution
    (3000, (2,), 31, np.float32),       # block-Toeplitz in float32
])
def test_filt_fir_matches_dsptpu(n, shape, nb, dtype):
    rng = np.random.default_rng(n + nb)
    x = rng.standard_normal((n,) + shape).astype(dtype)
    b = rng.standard_normal(nb).astype(dtype)
    want = dsptpu.filt(jnp.asarray(b), jnp.asarray(x))
    got = dsptpu_torch.filt(taps_from_numpy(b, "cpu"), torch.as_tensor(x))
    assert got.dtype == torch.from_numpy(x).dtype
    check(got, want, TOL[dtype])


def test_filt_fir_complex_short_signal():
    """Complex input below 4 nb: four real convolutions."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((200, 2)) + 1j * rng.standard_normal((200, 2))
    b = rng.standard_normal(64)
    want = np.asarray(dsptpu.filt(jnp.asarray(b), jnp.asarray(x)))
    got = dsptpu_torch.filt(torch.as_tensor(b), torch.as_tensor(x)).numpy()
    assert np.max(np.abs(got - want)) <= 1e-10 * np.max(np.abs(want))


def test_filt_fir_a0_normalization():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2000, 2))
    b = rng.standard_normal(17)
    want = dsptpu.filt(jnp.asarray(b), 2.0, jnp.asarray(x))
    got = dsptpu_torch.filt(torch.as_tensor(b), 2.0, torch.as_tensor(x))
    check(got, want, 1e-10)


@pytest.mark.parametrize("nb", [2, 127, 300])
@pytest.mark.parametrize("C", [1, 3])
def test_fir_plain_matches_pallas_interpret(nb, C):
    rng = np.random.default_rng(10 * nb + C)
    n = 4 * 1024 + 77                   # ragged: not a multiple of 128
    x = rng.standard_normal((n, C)).astype(np.float32)
    b = rng.standard_normal(nb).astype(np.float32)
    want = fir_pallas(jnp.asarray(x), jnp.asarray(b), interpret=True)
    got = tfir.fir(torch.as_tensor(x), torch.as_tensor(b))
    check(got, want, 3e-5)
    assert tfir.launches["fir"] == 0


def test_fir_cpu_tensor_runs_plain_version():
    x = torch.randn(1000, 2)
    b = torch.randn(9)
    assert torch.equal(tfir.fir(x, b), tfir.fir_reference(x, b))
    assert tfir.launches["fir"] == 0


def test_long_taps_route_not_ported():
    """More than 512 taps: the overlap-save route matches dsptpu's, in
    float64 and in float32."""
    rng = np.random.default_rng(11)
    for dtype in (np.float64, np.float32):
        x = rng.standard_normal((5000, 2)).astype(dtype)
        b = rng.standard_normal(600).astype(dtype)
        want = dsptpu.filt(jnp.asarray(b), jnp.asarray(x))
        got = dsptpu_torch.filt(torch.as_tensor(b), torch.as_tensor(x))
        check(got, want, TOL[dtype])


def emulate_fir_kernel(x, b, wave):
    """float64 emulation of csrc/fir.cu's walk, all blocks of a launch at
    once: the wrapper's plan (`_plan`, `_runs` for `wave` resident
    blocks), each block's ring of segments staged with zero fill outside
    [0, n) x [0, C) (the next tile before the current one computes, as
    the kernel orders it), and each thread's registers: cur and nxt
    slide down one row per tap, read at the kernel's shared addresses.
    Ring cells never staged hold NaN, so a read of one shows."""
    n, C = x.shape
    nb = b.shape[0]
    p = tfir._plan(n, C, nb)
    runs = tfir._runs(p, wave)
    R, cw, v, ncl, tt = tfir.R, p["cw"], p["v"], p["ncl"], p["tt"]
    nbp, nseg, sseg, ntiles = p["nbp"], p["nseg"], p["sseg"], p["ntiles"]
    obuf = tfir.THREADS * (R + 1) if v == 1 else 0
    assert p["smem"] == 4 * (nbp + nseg * sseg + obuf) <= tfir.MAX_SMEM
    assert nseg * R == nbp + 2 * tt and nbp % (2 * R) == 0
    nblk = p["groups"] * runs
    blk = np.arange(nblk)
    cbase = blk // runs * cw
    run = blk % runs
    tile0, tile1 = ntiles * run // runs, ntiles * (run + 1) // runs
    tbase = tile0 * tt - nbp
    hs = np.zeros(nbp)
    hs[:nb] = b
    ring = np.full((nblk, nseg * sseg), np.nan)

    # 16-byte copies (W = 4) where C is a multiple of 4: a thread keeps
    # one column of W floats and steps down the rows
    W = 4 if cw >= 4 and C % 4 == 0 else 1
    per_row = cw // W

    def stage(r0, rows, live):
        tid = np.arange(tfir.THREADS)
        r = tid // per_row + np.arange(0, rows, tfir.THREADS // per_row)[
            :, None]
        col = np.broadcast_to(tid % per_row * W, r.shape)
        keep = r < rows
        r, col = r[keep][:, None], col[keep][:, None] + np.arange(W)
        r, col = np.broadcast_arrays(r, col)
        r, col = r.ravel(), col.ravel()
        assert len(np.unique(r * cw + col)) == rows * cw
        slot = r0 // R % nseg + r // R
        slot = np.where(slot >= nseg, slot - nseg, slot)
        t = tbase[:, None] + r0 + r
        c = cbase[:, None] + col
        ok = (t >= 0) & (t < n) & (c < C)
        val = np.where(ok, x[np.clip(t, 0, n - 1), np.clip(c, 0, C - 1)], 0)
        addr = slot * sseg + r % R * cw + col
        ring[np.ix_(live, addr)] = val[live]

    stage(0, nbp + tt, blk >= 0)
    tid = np.arange(tfir.THREADS)
    tl, cl = tid // ncl, tid % ncl
    lane = v * cl[:, None] + np.arange(v)            # (threads, v)
    y = np.full((n, C), np.nan)
    written = np.zeros((n, C), int)
    for m in range(int((tile1 - tile0).max())):
        live = tile0 + m < tile1
        rtile = nbp + m * tt
        if (tile0 + m + 1 < tile1).any():
            stage(rtile + tt, tt, tile0 + m + 1 < tile1)
        rme = rtile + tl * R
        s = rme // R % nseg

        def rows(s, i):     # (blocks, threads, v) at segment s, row i
            return ring[:, s[:, None] * sseg + i * cw + lane]
        cur = np.stack([rows(s, j) for j in range(R)])
        acc = np.zeros_like(cur)
        nxt = np.empty_like(cur)
        for k0 in range(0, nbp, R):
            s = np.where(s == 0, nseg - 1, s - 1)
            for kk in range(R):
                if kk:
                    nxt[R - kk] = rows(s, R - kk)
                w = np.concatenate([nxt[R - kk:], cur[:R - kk]])
                acc += hs[k0 + kk] * w
            nxt[0] = rows(s, 0)
            cur, nxt = nxt, cur
        t = tbase[None, :, None, None] + rme[None, None, :, None] + \
            np.arange(R)[:, None, None, None]
        c = cbase[None, :, None, None] + lane[None, None]
        ok = (t < n) & (c < C) & live[None, :, None, None]
        t, c = np.broadcast_arrays(t, c)
        y[t[ok], c[ok]] = acc[ok]
        np.add.at(written, (t[ok], c[ok]), 1)
    assert (written == 1).all()         # every output stored exactly once
    return y, p, runs


@pytest.mark.parametrize("nb", [2, 17, 127, 512, 1536])
@pytest.mark.parametrize("C", [1, 3, 33, 64])
def test_fir_kernel_walk_emulated(C, nb):
    """The kernel's index arithmetic in float64 against lfilter at 1e-10:
    runs that start mid-stream and carry their ring from tile to tile,
    zero fill before t = 0 and past n, ragged channel groups (C = 3 and
    33), n ragged against the tile, nb not a multiple of R."""
    from scipy.signal import lfilter
    rng = np.random.default_rng(C * 1000 + nb)
    p = tfir._plan(1, C, nb)
    n = max(4 * nb + 1, 5 * p["tt"] + 3)
    x = rng.standard_normal((n, C))
    b = rng.standard_normal(nb)
    want = lfilter(b, [1.0], x, axis=0)
    groups = tfir._plan(n, C, nb)["groups"]
    for wave in (2 * groups, 3 * groups + 1):   # runs of 2 or 3 tiles, ragged
        got, plan, runs = emulate_fir_kernel(x, b, wave)
        assert runs > 1 and plan["ntiles"] // runs >= 1
        assert np.isfinite(got).all()
        check(got, want, 1e-10)
