"""Copy of dsptpu/filters/filt_order.py (numpy only).

Filter order estimation: buttord, cheb1ord, cheb2ord, ellipord,
remezord.

Capability parity with reference src/Filters/filt_order.jl (prototype
warps :61-87, order formulas :89-110, bandstop passband-edge
minimization :112-225, buttord :240-324, ellipord/cheb1ord :329-371,
cheb2ord :413-470, remezord :489-498; that file derives from scipy —
see its license header). Host-side float64 numpy: these produce two
scalars consumed by the design layer. The complete elliptic integral
uses an AGM implementation (no SpecialFunctions dependency); the
bandstop edge optimization uses a bounded scalar minimizer.
"""

import math

import numpy as np

from .design import Lowpass, Highpass, Bandpass, Bandstop

__all__ = ["buttord", "ellipord", "cheb1ord", "cheb2ord", "remezord",
           "ellipk_agm"]


def _db2pow(db):
    return 10.0 ** (db / 10.0)


def ellipk_agm(m):
    """Complete elliptic integral of the first kind K(m) via the
    arithmetic-geometric mean (replaces SpecialFunctions.ellipk used at
    reference filt_order.jl:99-100)."""
    if m == 1.0:
        return math.inf
    a, b = 1.0, math.sqrt(1.0 - m)
    for _ in range(60):
        if abs(a - b) < 1e-17 * a:
            break
        a, b = (a + b) / 2, math.sqrt(a * b)
    return math.pi / (2 * a)


def _sort2(w):
    a, b = float(w[0]), float(w[1])
    return (a, b) if a <= b else (b, a)


def _warp(w, domain):
    if domain == "z":
        if np.ndim(w):
            return tuple(math.tan(math.pi * v / 2) for v in w)
        return math.tan(math.pi * w / 2)
    return w


# -- order formulas (reference filt_order.jl:89-110) ------------------------

def _butterworth_order(Rp, Rs, warp):
    return (math.log(_db2pow(Rs) - 1) - math.log(_db2pow(Rp) - 1)) \
        / (2 * math.log(warp))


def _butterworth_natfreq(warp, Rs, order):
    return warp / (_db2pow(Rs) - 1) ** (1 / (2 * order))


def _elliptic_order(Rp, Rs, Wa):
    eps = math.sqrt(_db2pow(Rp) - 1)
    k1 = eps / math.sqrt(_db2pow(Rs) - 1)
    k = 1.0 / Wa
    if k * k >= 1:
        raise ValueError("transition width too narrow for elliptic design")
    if 1 - k1 * k1 >= 1:
        raise ValueError("stopband too deep for elliptic design")
    K = (ellipk_agm(k * k), ellipk_agm(1 - k * k))
    K1 = (ellipk_agm(k1 * k1), ellipk_agm(1 - k1 * k1))
    return (K[0] * K1[1]) / (K[1] * K1[0])


def _chebyshev_order(Rp, Rs, Wa):
    es, ep = _db2pow(Rs) - 1, _db2pow(Rp) - 1
    return math.acosh(math.sqrt(es / ep)) / math.acosh(Wa)


# -- bandstop passband-edge adjustment (reference :197-225) -----------------

def _bsf_warp(Wp, Ws):
    Wa = [(Ws[i] * (Wp[0] - Wp[1])) / (Ws[i] ** 2 - Wp[0] * Wp[1])
          for i in range(2)]
    return min(abs(Wa[0]), abs(Wa[1]))


def brent_min(f, a, b, xatol=1e-12, maxiter=200):
    """Bounded scalar minimization on [a, b] by Brent's method (golden
    section + successive parabolic interpolation), self-contained like
    the reference's own brent (filt_order.jl:112-192). Returns the
    minimizer x."""
    golden = 0.5 * (3.0 - math.sqrt(5.0))
    x = w = v = a + golden * (b - a)
    fx = fw = fv = f(x)
    d = e = b - a
    for _ in range(maxiter):
        m = 0.5 * (a + b)
        tol = xatol + 4 * np.finfo(float).eps * abs(x)
        if abs(x - m) <= 2 * tol - 0.5 * (b - a):
            break
        p = q = r = 0.0
        if abs(e) > tol:
            # fit a parabola through (v, fv), (w, fw), (x, fx)
            r = (x - w) * (fx - fv)
            q = (x - v) * (fx - fw)
            p = (x - v) * q - (x - w) * r
            q = 2.0 * (q - r)
            if q > 0:
                p = -p
            q = abs(q)
            r, e = e, d
        if abs(p) < abs(0.5 * q * r) and q * (a - x) < p < q * (b - x):
            d = p / q                       # parabolic step
            u = x + d
            if (u - a) < 2 * tol or (b - u) < 2 * tol:
                d = tol if x < m else -tol
        else:
            e = (b if x < m else a) - x     # golden-section step
            d = golden * e
        u = x + (d if abs(d) >= tol else (tol if d > 0 else -tol))
        fu = f(u)
        if fu <= fx:
            if u < x:
                b = x
            else:
                a = x
            v, fv, w, fw, x, fx = w, fw, x, fx, u, fu
        else:
            if u < x:
                a = u
            else:
                b = u
            if fu <= fw or w == x:
                v, fv, w, fw = w, fw, u, fu
            elif fu <= fv or v == x or v == w:
                v, fv = u, fu
    return x


def _bsfmin(order_fn, Wp, Ws, Rp, Rs):
    """Adjust the bandstop passband edges toward the stopband to
    minimize the estimated order (reference bsfmin filt_order.jl:197-225)."""
    delta = np.finfo(float).eps ** (2 / 3)

    def cost_low(w):
        return order_fn(Rp, Rs, _bsf_warp((w, Wp[1]), Ws))

    p1 = float(brent_min(cost_low, Wp[0], Ws[0] - delta, xatol=1e-12))

    def cost_high(w):
        return order_fn(Rp, Rs, _bsf_warp((p1, w), Ws))

    p2 = float(brent_min(cost_high, Ws[1] + delta, Wp[1], xatol=1e-12))
    return _bsf_warp((p1, p2), Ws), (p1, p2)


# -- buttord ----------------------------------------------------------------

def _infer_lp_hp(Wp, Ws):
    return Lowpass if Wp < Ws else Highpass


def _infer_bp_bs(Wps, Wss):
    if (Wps[0] < Wss[0]) != (Wps[1] > Wss[1]):
        raise ValueError("pass and stopband edges must be ordered for "
                         "Bandpass/Bandstop filters")
    return Bandstop if Wps[0] < Wss[0] else Bandpass


def buttord(Wp, Ws, Rp, Rs, domain="z"):
    """Butterworth order + natural ('-3 dB') frequency estimate
    (reference filt_order.jl:240-324). Scalars give LP/HP (inferred
    from edge ordering), 2-tuples give BP/BS. domain 'z' treats
    frequencies as normalized (1 = Nyquist); 's' as rad/s."""
    if np.ndim(Wp):
        Wps, Wss = _sort2(Wp), _sort2(Ws)
        ftype = _infer_bp_bs(Wps, Wss)
        Op, Os = _warp(Wps, domain), _warp(Wss, domain)
        if ftype is Bandstop:
            wa, wpadj = _bsfmin(_butterworth_order, Op, Os, Rp, Rs)
        else:
            wa = _bsf_warp_bp(Op, Os)
            wpadj = Op
        N = math.ceil(_butterworth_order(Rp, Rs, wa))
        wscale = _butterworth_natfreq(wa, Rs, N)
        wn = _from_proto_tuple(wpadj, wscale, ftype)
        if domain == "z":
            wn = tuple((2 / math.pi) * math.atan(v) for v in wn)
        return N, wn
    ftype = _infer_lp_hp(Wp, Ws)
    Op, Os = _warp(Wp, domain), _warp(Ws, domain)
    wa = Os / Op if ftype is Lowpass else Op / Os
    N = math.ceil(_butterworth_order(Rp, Rs, wa))
    wscale = _butterworth_natfreq(wa, Rs, N)
    wn = Op * wscale if ftype is Lowpass else Op / wscale
    if domain == "z":
        wn = (2 / math.pi) * math.atan(wn)
    return N, wn


def _bsf_warp_bp(Op, Os):
    """Bandpass prototype warp (reference toprototype filt_order.jl:63-67)."""
    Wa = [(Os[i] ** 2 - Op[0] * Op[1]) / (Os[i] * (Op[0] - Op[1]))
          for i in range(2)]
    return min(abs(Wa[0]), abs(Wa[1]))


def _from_proto_tuple(Wp, wscale, ftype):
    """Bandpass/Bandstop prototype-to-analog natural frequencies
    (reference fromprototype filt_order.jl:72-87)."""
    diff = Wp[1] - Wp[0]
    prod = Wp[1] * Wp[0]
    if ftype is Bandstop:
        k = math.sqrt(4 * wscale ** 2 * prod + diff ** 2)
        Wa = ((diff + k) / (2 * wscale), (diff - k) / (2 * wscale))
    else:
        r = math.sqrt(wscale ** 2 / 4 * diff ** 2 + prod)
        Wa = (r + wscale * diff / 2, r - wscale * diff / 2)
    return _sort2((abs(Wa[0]), abs(Wa[1])))


# -- ellipord / cheb1ord (shared shape, reference :347-371) -----------------

def _ordfreq_est(order_fn, domain, Wp, Ws, Rp, Rs):
    if np.ndim(Wp):
        Wps, Wss = _sort2(Wp), _sort2(Ws)
        ftype = _infer_bp_bs(Wps, Wss)
        Op, Os = _warp(Wps, domain), _warp(Wss, domain)
        if ftype is Bandpass:
            Wa = [(Os[i] ** 2 - Op[0] * Op[1]) / (Os[i] * (Op[0] - Op[1]))
                  for i in range(2)]
            wa = min(abs(Wa[0]), abs(Wa[1]))
            Opadj = Op
        else:
            wa, Opadj = _bsfmin(order_fn, Op, Os, Rp, Rs)
        N = math.ceil(order_fn(Rp, Rs, wa))
        wn = Wps if domain == "z" else Opadj
        return N, wn
    ftype = _infer_lp_hp(Wp, Ws)
    Op, Os = _warp(Wp, domain), _warp(Ws, domain)
    wa = Os / Op if ftype is Lowpass else Op / Os
    N = math.ceil(order_fn(Rp, Rs, wa))
    wn = (2 / math.pi) * math.atan(Op) if domain == "z" else Op
    return N, wn


def ellipord(Wp, Ws, Rp, Rs, domain="z"):
    """Elliptic (Cauer) order estimate (reference filt_order.jl:347)."""
    return _ordfreq_est(_elliptic_order, domain, Wp, Ws, Rp, Rs)


def cheb1ord(Wp, Ws, Rp, Rs, domain="z"):
    """Chebyshev type-I order estimate (reference filt_order.jl:348)."""
    return _ordfreq_est(_chebyshev_order, domain, Wp, Ws, Rp, Rs)


def cheb2ord(Wp, Ws, Rp, Rs, domain="z"):
    """Chebyshev type-II (inverse) order estimate (reference
    filt_order.jl:413-470)."""
    if np.ndim(Wp):
        Wps, Wss = _sort2(Wp), _sort2(Ws)
        ftype = _infer_bp_bs(Wps, Wss)
        Op, Os = _warp(Wps, domain), _warp(Wss, domain)
        if ftype is Bandpass:
            prod = Op[0] * Op[1]
            diff = Op[0] - Op[1]
            Wa = [(Os[i] * Os[i] - prod) / (Os[i] * diff) for i in range(2)]
        else:
            wa_min, Opadj = _bsfmin(_chebyshev_order, Op, Os, Rp, Rs)
            Wa = [wa_min]
            prod = Opadj[0] * Opadj[1]
            diff = Opadj[0] - Opadj[1]
        N = math.ceil(_chebyshev_order(Rp, Rs, min(abs(v) for v in Wa)))
        wnew = 1 / math.cosh(
            1 / N * math.acosh(math.sqrt(_db2pow(Rs) - 1)
                               / math.sqrt(_db2pow(Rp) - 1)))
        if ftype is Bandpass:
            Wna1 = diff / (2 * wnew) + math.sqrt(diff ** 2 / (4 * wnew ** 2)
                                                 + prod)
        else:
            Wna1 = (diff * wnew) / 2 + math.sqrt(diff ** 2 * wnew ** 2 / 4
                                                 + prod)
        Wna2 = prod / Wna1
        if domain == "z":
            return N, ((2 / math.pi) * math.atan(Wna1),
                       (2 / math.pi) * math.atan(Wna2))
        return N, (Wna1, Wna2)
    ftype = _infer_lp_hp(Wp, Ws)
    Op, Os = _warp(Wp, domain), _warp(Ws, domain)
    wa = Os / Op if ftype is Lowpass else Op / Os
    N = math.ceil(_chebyshev_order(Rp, Rs, wa))
    wnew = 1 / math.cosh(1 / N * math.acosh(
        math.sqrt(_db2pow(Rs) - 1) / math.sqrt(_db2pow(Rp) - 1)))
    wa = Op / wnew if ftype is Lowpass else Op * wnew
    wn = (2 / math.pi) * math.atan(wa) if domain == "z" else wa
    return N, wn


def remezord(Wp, Ws, Rp, Rs):
    """Herrmann/Rabiner FIR order estimate; Rp/Rs are *linear* ripples
    (reference filt_order.jl:489-498)."""
    if not (0 < Wp < 0.5) or not (0 < Ws < 0.5):
        raise ValueError("band edges must be within (0, 0.5)")
    L1, L2 = math.log10(Rp), math.log10(Rs)
    df = abs(Ws - Wp)
    A = 5.309e-3 * L1 ** 2 + 7.114e-2 * L1 - 0.4761
    B = 2.66e-3 * L1 ** 2 + 0.5941 * L1 + 0.4278
    Kf = 0.51244 * (L1 - L2) + 11.01217
    D = A * L2 - B
    return math.ceil((-Kf * df ** 2 + D) / df)
