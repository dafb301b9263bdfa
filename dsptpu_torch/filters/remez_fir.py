"""Copy of dsptpu/filters/remez_fir.py (numpy only).

Parks-McClellan optimal equiripple FIR design (remez exchange).

Capability parity with reference src/Filters/remez_fir.jl (grid
construction :117-200, barycentric machinery :100-109,211, exchange
loop :394-770, scipy-compatible 3-arg API :841-863). NOT a translation
of that file's goto-structured FORTRAN lineage: this is a structured
reimplementation of the classic algorithm (McClellan/Parks/Rabiner
1973) — dense-grid Chebyshev approximation with barycentric Lagrange
interpolation and multiple-exchange extremal updates — with the
impulse response recovered by exact frequency sampling of the
converged amplitude response (type I-IV linear phase) instead of
per-case coefficient recursions. Host-side float64; the output is a
tap vector for the device filtering kernels.

Two call forms (mirroring the reference):
  remez(numtaps, bands, desired, weight=None, Hz=1.0,
        filter_type="bandpass"|"differentiator"|"hilbert", ...)
  remez(numtaps, band_defs, Hz=1.0, neg=False, ...)
where band_defs is a list of ((f_lo, f_hi), desired) or
((f_lo, f_hi), (desired, weight)) pairs whose desired/weight entries
may be scalars or functions of the frequency in Hz.
"""

import math
import warnings

import numpy as np

__all__ = ["remez", "RemezFilterType", "filter_type_bandpass",
           "filter_type_differentiator", "filter_type_hilbert"]


class RemezFilterType:
    bandpass = "bandpass"
    differentiator = "differentiator"
    hilbert = "hilbert"


# reference-named constants (remez_fir.jl:91)
filter_type_bandpass = RemezFilterType.bandpass
filter_type_differentiator = RemezFilterType.differentiator
filter_type_hilbert = RemezFilterType.hilbert


def _normalize_band_defs(numtaps, band_defs, desired, weight, Hz,
                         filter_type, neg):
    """Produce (bands_norm, D_fns, W_fns, neg); frequencies normalized
    to [0, 0.5]; D/W callables take normalized frequency."""
    if desired is not None:
        # scipy-compatible form (reference remez_fir.jl:841-863)
        bands = np.asarray(band_defs, dtype=np.float64)
        desired = np.asarray(desired, dtype=np.float64)
        if bands.ndim != 1 or len(bands) != 2 * len(desired):
            raise ValueError("bands must have twice the entries of desired")
        if weight is None:
            weight = np.ones(len(desired))
        else:
            weight = np.asarray(weight, dtype=np.float64)
            if len(weight) != len(desired):
                raise ValueError("weight must match desired in length")
        if np.any(np.diff(bands) <= 0):
            raise ValueError("bands must be strictly increasing")
        if bands[0] < 0 or bands[-1] > Hz / 2:
            raise ValueError("band edges must lie in [0, Hz/2]")
        bn = bands / Hz
        edges = [(bn[2 * i], bn[2 * i + 1]) for i in range(len(desired))]
        neg = filter_type in (RemezFilterType.differentiator,
                              RemezFilterType.hilbert)
        dfns, wfns = [], []
        for i, (d, w) in enumerate(zip(desired, weight)):
            if filter_type == RemezFilterType.differentiator:
                # slope spec: D = d * 2f, relative weight 1/f on
                # non-zero bands (scipy semantics)
                if d != 0:
                    dfns.append(lambda f, d=d: d * f)
                    wfns.append(lambda f, w=w: w / f)
                else:
                    dfns.append(lambda f, d=d: 0.0 * f)
                    wfns.append(lambda f, w=w: w + 0.0 * f)
            else:
                dfns.append(lambda f, d=d: d + 0.0 * f)
                wfns.append(lambda f, w=w: w + 0.0 * f)
        return edges, dfns, wfns, neg

    # band_defs form: [((lo, hi), desired_or_(desired, weight)), ...]
    edges, dfns, wfns = [], [], []
    prev = -1.0
    for bd, dw in band_defs:
        lo, hi = float(bd[0]), float(bd[1])
        if lo < 0 or hi > Hz / 2 or lo >= hi or lo < prev:
            raise ValueError("band edges must be increasing within [0, Hz/2]")
        prev = hi
        edges.append((lo / Hz, hi / Hz))
        if isinstance(dw, tuple):
            d, w = dw
        else:
            d, w = dw, 1.0
        if callable(d):
            dfns.append(lambda f, d=d: np.vectorize(d)(f * Hz))
        else:
            dfns.append(lambda f, d=d: d + 0.0 * np.asarray(f))
        if callable(w):
            wfns.append(lambda f, w=w: np.vectorize(w)(f * Hz))
        else:
            wfns.append(lambda f, w=w: w + 0.0 * np.asarray(f))
    return edges, dfns, wfns, neg


def _build_grid(numtaps, edges, dfns, wfns, neg, grid_density):
    """Dense frequency grid with desired/weight values, with the
    change-of-variable for the four linear-phase cases (reference
    build_grid remez_fir.jl:117-200)."""
    nodd = numtaps % 2
    r = numtaps // 2
    if nodd and not neg:
        r += 1
    delf = 0.5 / (grid_density * r)

    grid, Dv, Wv = [], [], []
    for (lo, hi), dfn, wfn in zip(edges, dfns, wfns):
        # basis vanishes at f=0 (neg) and f=0.5 (even sym / odd neg):
        # nudge grid off those points
        glo, ghi = lo, hi
        if neg and glo < delf:
            glo = delf
        if (not nodd or neg) and ghi > 0.5 - delf:
            if (not nodd and not neg) or (nodd and neg):
                ghi = 0.5 - delf
        # stepped grid of spacing delf whose final point is the band
        # edge (the classic construction; the discrete-grid optimum
        # depends on these exact points)
        npts = max(int(math.floor((ghi - glo) / delf)) + 1, 1)
        fs = glo + delf * np.arange(npts)
        if ghi - fs[-1] > delf / 2:
            fs = np.append(fs, ghi)
        else:
            fs[-1] = ghi
        grid.append(fs)
        Dv.append(np.asarray(dfn(fs), dtype=np.float64))
        Wv.append(np.asarray(wfn(fs), dtype=np.float64))
    grid = np.concatenate(grid)
    D = np.concatenate(Dv)
    W = np.concatenate(Wv)

    # change of variable: A(f) = q(f) * G(f) with G a cosine series
    if nodd and not neg:
        q = np.ones_like(grid)
    elif not nodd and not neg:
        q = np.cos(np.pi * grid)
    elif nodd:
        q = np.sin(2 * np.pi * grid)
    else:
        q = np.sin(np.pi * grid)
    D = D / q
    W = W * q
    return grid, D, W, r, nodd


def _barycentric_weights(x):
    """gamma_k = 1 / prod_{j != k} (x_k - x_j), stabilized pairwise."""
    n = len(x)
    gamma = np.ones(n)
    for k in range(n):
        d = x[k] - x
        d[k] = 1.0
        # scale to avoid under/overflow
        gamma[k] = 1.0 / np.prod(d)
    return gamma


def _compute_delta_and_interp(grid, D, W, iext):
    """Deviation delta and the barycentric interpolant values of the
    approximant on the whole grid."""
    fe = grid[iext]
    x = np.cos(2 * np.pi * fe)
    gamma = _barycentric_weights(x)
    signs = (-1.0) ** np.arange(len(iext))
    delta = np.dot(gamma, D[iext]) / np.dot(gamma, signs / W[iext])
    # interpolation nodes: all but the last extremal; values C_k
    C = D[iext] - signs * delta / W[iext]
    xn = x[:-1]
    wn = gamma[:-1] * (x[:-1] - x[-1])  # weights for the reduced node set
    xg = np.cos(2 * np.pi * grid)
    # barycentric evaluation, exact at nodes
    denom_terms = xg[:, None] - xn[None, :]
    exact = np.isclose(denom_terms, 0.0, atol=0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratios = wn[None, :] / denom_terms
        P = (ratios @ C[:-1]) / np.sum(ratios, axis=1)
    hit_rows, hit_cols = np.nonzero(exact)
    P[hit_rows] = C[:-1][hit_cols]
    return delta, P


def _select_extremals(E, r, delta):
    """Choose r+1 alternating extremal indices of the weighted error
    (multiple exchange). Returns None if alternation cannot be
    satisfied."""
    n = len(E)
    # local extrema of E (peaks of either sign), plus endpoints
    dE = np.diff(E)
    cand = [0]
    for i in range(1, n - 1):
        if (E[i] - E[i - 1]) * (E[i + 1] - E[i]) <= 0 \
                and (E[i] != E[i - 1] or E[i] != E[i + 1]):
            cand.append(i)
    cand.append(n - 1)
    # keep only meaningful peaks and enforce sign alternation: among
    # consecutive same-sign candidates keep the largest |E|
    kept = []
    for i in cand:
        if not kept:
            kept.append(i)
            continue
        if np.sign(E[i]) == np.sign(E[kept[-1]]) or E[i] == 0:
            if abs(E[i]) > abs(E[kept[-1]]):
                kept[-1] = i
        else:
            kept.append(i)
    if len(kept) < r + 1:
        return None
    # too many alternations: drop from the ends, smaller |E| first
    while len(kept) > r + 1:
        if len(kept) - (r + 1) >= 2 and abs(E[kept[0]]) <= abs(E[kept[-1]]):
            kept.pop(0)
        elif len(kept) - (r + 1) >= 2:
            kept.pop()
        elif abs(E[kept[0]]) <= abs(E[kept[-1]]):
            kept.pop(0)
        else:
            kept.pop()
    return np.asarray(kept)


def _amplitude_eval(f, grid, D, W, iext, delta):
    """Evaluate the converged approximant G at arbitrary normalized
    frequencies f (barycentric through the final extremal nodes)."""
    fe = grid[iext]
    x = np.cos(2 * np.pi * fe)
    gamma = _barycentric_weights(x)
    signs = (-1.0) ** np.arange(len(iext))
    C = D[iext] - signs * delta / W[iext]
    xn = x[:-1]
    wn = gamma[:-1] * (x[:-1] - x[-1])
    xq = np.cos(2 * np.pi * np.asarray(f, dtype=np.float64))
    out = np.empty_like(xq)
    denom = xq[:, None] - xn[None, :]
    exact = np.isclose(denom, 0.0, atol=1e-15)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratios = wn[None, :] / denom
        out = (ratios @ C[:-1]) / np.sum(ratios, axis=1)
    hit_rows, hit_cols = np.nonzero(exact)
    out[hit_rows] = C[:-1][hit_cols]
    return out


def remez(numtaps, bands, desired=None, weight=None, Hz=1.0,
          filter_type=RemezFilterType.bandpass, neg=False, maxiter=25,
          grid_density=16):
    """Parks-McClellan optimal FIR design (reference
    remez_fir.jl:394-770,841-863). Returns a length-numtaps tap vector."""
    edges, dfns, wfns, neg = _normalize_band_defs(
        numtaps, bands, desired, weight, Hz, filter_type, neg)
    grid, D, W, r, nodd = _build_grid(numtaps, edges, dfns, wfns, neg,
                                      grid_density)
    ngrid = len(grid)
    if r + 1 > ngrid:
        raise ValueError("grid too small for the requested order")

    # initial extremals: equally spaced over the grid
    iext = np.round(np.linspace(0, ngrid - 1, r + 1)).astype(int)

    delta = 0.0
    converged = False
    last_dev = 0.0
    for _ in range(maxiter):
        delta, P = _compute_delta_and_interp(grid, D, W, iext)
        E = W * (D - P)
        new_iext = _select_extremals(E, r, delta)
        if new_iext is None:
            raise RuntimeError(
                "remez failed to converge: could not find enough "
                "alternations (transition band too wide?)")
        dev = abs(delta)
        if dev < last_dev * (1 - 1e-12) and last_dev > 0:
            # the deviation should grow monotonically in exact
            # arithmetic, but the discrete multiple-exchange can jitter
            # on hard-but-feasible specs; warn and return the current
            # iterate instead of hard-failing (the reference and scipy
            # only warn on non-convergence)
            warnings.warn("remez deviation decreased between iterations; "
                          "result may not be optimal")
            converged = True
            break
        if np.array_equal(new_iext, iext):
            converged = True
            iext = new_iext
            break
        last_dev = dev
        iext = new_iext
    if not converged:
        warnings.warn(f"filter is not converged after {maxiter} iterations")

    # exact frequency-sampling reconstruction of the type I-IV filter
    N = numtaps
    m = np.arange(N // 2 + 1)
    fm = m / N
    G = _amplitude_eval(fm, grid, D, W, iext, delta)
    if nodd and not neg:
        q = np.ones_like(fm)
    elif not nodd and not neg:
        q = np.cos(np.pi * fm)
    elif nodd:
        q = np.sin(2 * np.pi * fm)
    else:
        q = np.sin(np.pi * fm)
    A = G * q
    phase = np.exp(-1j * np.pi * fm * (N - 1))
    # antisymmetric (type III/IV): H = j A e^{-j pi f (N-1)} with the
    # scipy sign convention
    H_half = A * phase * (1j if neg else 1.0)
    H = np.zeros(N, dtype=complex)
    H[: N // 2 + 1] = H_half
    H[N // 2 + 1:] = np.conj(H_half[1: (N + 1) // 2][::-1])
    h = np.fft.ifft(H).real
    return h
