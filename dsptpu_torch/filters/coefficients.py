"""Copy of dsptpu/filters/coefficients.py (numpy only).

Filter coefficient representations and the full conversion lattice.

Capability parity with reference src/Filters/coefficients.jl: four forms
(ZeroPoleGain :23-53, PolynomialRatio :66-216, Biquad :235-283,
SecondOrderSections :295-341) with conversions between every pair,
arithmetic (*, inv, **), and the pole-zero pairing algorithm for
ZPK->SOS (:372-481).

These are *design-time* objects: pure host numpy in float64/complex128.
Device filtering kernels consume the flat arrays produced here
(`coefb`/`coefa`, `sos_array`) — the classes never enter traced code.
"""

import numpy as np

__all__ = [
    "FilterCoefficients", "ZeroPoleGain", "PolynomialRatio", "Biquad",
    "SecondOrderSections", "coefb", "coefa",
]


class FilterCoefficients:
    """Base class; `domain` is 'z' (digital) or 's' (analog)."""
    domain = "z"


def _trimz(c):
    """Strip leading (highest-power) zeros, keeping at least one coeff."""
    c = np.atleast_1d(np.asarray(c))
    nz = np.flatnonzero(c)
    if nz.size == 0:
        return c[-1:]
    return c[nz[0]:]


# ---------------------------------------------------------------------------
# ZeroPoleGain
# ---------------------------------------------------------------------------

class ZeroPoleGain(FilterCoefficients):
    """H(x) = k * prod(x - z_i) / prod(x - p_i)
    (reference coefficients.jl:23-53)."""

    def __init__(self, z, p, k, domain="z"):
        self.z = np.atleast_1d(np.asarray(z, dtype=np.complex128))
        self.p = np.atleast_1d(np.asarray(p, dtype=np.complex128))
        self.k = k
        self.domain = domain

    def __mul__(self, other):
        if isinstance(other, ZeroPoleGain):
            assert other.domain == self.domain
            return ZeroPoleGain(np.concatenate([self.z, other.z]),
                                np.concatenate([self.p, other.p]),
                                self.k * other.k, self.domain)
        return ZeroPoleGain(self.z, self.p, self.k * other, self.domain)

    __rmul__ = __mul__

    def inv(self):
        return ZeroPoleGain(self.p, self.z, 1.0 / self.k, self.domain)

    def __pow__(self, e):
        ae = abs(int(e))
        z, p = np.tile(self.z, ae), np.tile(self.p, ae)
        if e < 0:
            return ZeroPoleGain(p, z, (1.0 / self.k) ** ae, self.domain)
        return ZeroPoleGain(z, p, self.k ** ae, self.domain)

    def __repr__(self):
        return (f"ZeroPoleGain(domain={self.domain!r}, z={self.z!r}, "
                f"p={self.p!r}, k={self.k!r})")


# ---------------------------------------------------------------------------
# PolynomialRatio (transfer function)
# ---------------------------------------------------------------------------

class PolynomialRatio(FilterCoefficients):
    """Transfer function b(x)/a(x), coefficients highest power first.
    In the z domain the representation is normalized so a[0] == 1
    (reference coefficients.jl:70-92)."""

    def __init__(self, b, a, domain="z"):
        b = np.atleast_1d(np.asarray(b, dtype=np.float64)
                          if not np.iscomplexobj(b)
                          else np.asarray(b))
        a = np.atleast_1d(np.asarray(a, dtype=np.float64)
                          if not np.iscomplexobj(a)
                          else np.asarray(a))
        if not np.any(a):
            raise ValueError("filter must have non-zero denominator")
        if domain == "z":
            if a[0] == 0:
                raise ValueError(
                    "filter must have non-zero leading denominator coefficient")
            b = b / a[0]
            a = a / a[0]
        else:
            b = _trimz(b)
            a = _trimz(a)
        self.b = b
        self.a = a
        self.domain = domain

    def __mul__(self, other):
        if isinstance(other, PolynomialRatio):
            assert other.domain == self.domain
            return PolynomialRatio(np.polymul(self.b, other.b),
                                   np.polymul(self.a, other.a), self.domain)
        return PolynomialRatio(self.b * other, self.a, self.domain)

    __rmul__ = __mul__

    def inv(self):
        return PolynomialRatio(self.a, self.b, self.domain)

    def __pow__(self, e):
        ae = abs(int(e))
        b = a = np.ones(1)
        for _ in range(ae):
            b = np.polymul(b, self.b)
            a = np.polymul(a, self.a)
        if e < 0:
            b, a = a, b
        return PolynomialRatio(b, a, self.domain)

    def __repr__(self):
        return f"PolynomialRatio(domain={self.domain!r}, b={self.b!r}, a={self.a!r})"


def _trim_trailing(c):
    """Strip trailing zeros (harmless z^-k factors for filt), keeping
    at least one coefficient — the reference's Laurent polynomials
    carry minimal span."""
    nz = np.flatnonzero(c)
    return c[: nz[-1] + 1] if nz.size else c[:1]


def coefb(f):
    """Numerator coefficients, highest power first — the `b` for filt()
    (reference coefficients.jl:199-207)."""
    return _trim_trailing(as_polynomial_ratio(f).b)


def coefa(f):
    """Denominator coefficients, highest power first — the `a` for filt()
    (reference coefficients.jl:209-216)."""
    return _trim_trailing(as_polynomial_ratio(f).a)


# ---------------------------------------------------------------------------
# Biquad / SecondOrderSections
# ---------------------------------------------------------------------------

class Biquad(FilterCoefficients):
    """Single second-order section
    H = (b0 + b1 x^-1 + b2 x^-2) / (1 + a1 x^-1 + a2 x^-2)
    (reference coefficients.jl:235-283)."""

    def __init__(self, b0, b1, b2, a1, a2, domain="z"):
        self.b0, self.b1, self.b2 = float(b0), float(b1), float(b2)
        self.a1, self.a2 = float(a1), float(a2)
        self.domain = domain

    def __mul__(self, other):
        if isinstance(other, Biquad):
            return SecondOrderSections([self, other], 1.0, self.domain)
        if isinstance(other, SecondOrderSections):
            return SecondOrderSections([self] + list(other.biquads), other.g,
                                       self.domain)
        return Biquad(self.b0 * other, self.b1 * other, self.b2 * other,
                      self.a1, self.a2, self.domain)

    __rmul__ = __mul__

    def inv(self):
        """1/H as a Biquad — requires b0 != 0 (reference
        coefficients.jl Biquad inv)."""
        if self.b0 == 0:
            raise ValueError("cannot invert a Biquad with b0 == 0")
        b0 = self.b0
        return Biquad(1.0 / b0, self.a1 / b0, self.a2 / b0,
                      self.b1 / b0, self.b2 / b0, self.domain)

    def __pow__(self, e):
        return SecondOrderSections([self], 1.0, self.domain) ** e

    def __eq__(self, other):
        return (isinstance(other, Biquad) and self.domain == other.domain
                and (self.b0, self.b1, self.b2, self.a1, self.a2)
                == (other.b0, other.b1, other.b2, other.a1, other.a2))

    def __hash__(self):
        return hash((self.b0, self.b1, self.b2, self.a1, self.a2,
                     self.domain))

    def coefficients(self):
        return np.array([self.b0, self.b1, self.b2, self.a1, self.a2])

    def __repr__(self):
        return (f"Biquad(domain={self.domain!r}, b0={self.b0}, b1={self.b1}, "
                f"b2={self.b2}, a1={self.a1}, a2={self.a2})")


class SecondOrderSections(FilterCoefficients):
    """Cascade of biquads with overall gain g
    (reference coefficients.jl:295-341)."""

    def __init__(self, biquads, g=1.0, domain="z"):
        self.biquads = list(biquads)
        self.g = g
        self.domain = domain

    def __mul__(self, other):
        if isinstance(other, SecondOrderSections):
            return SecondOrderSections(self.biquads + other.biquads,
                                       self.g * other.g, self.domain)
        if isinstance(other, Biquad):
            return SecondOrderSections(self.biquads + [other], self.g,
                                       self.domain)
        return SecondOrderSections(self.biquads, self.g * other, self.domain)

    __rmul__ = __mul__

    def inv(self):
        """1/H: invert every section and the gain (requires every
        section's b0 != 0)."""
        return SecondOrderSections([q.inv() for q in self.biquads],
                                   1.0 / self.g, self.domain)

    def __pow__(self, e):
        e = int(e)
        if e == 0:
            return SecondOrderSections([Biquad(1.0, 0.0, 0.0, 0.0, 0.0,
                                               self.domain)], 1.0,
                                       self.domain)
        base = self.inv() if e < 0 else self
        ae = abs(e)
        return SecondOrderSections(list(base.biquads) * ae,
                                   base.g ** ae, self.domain)

    def sos_array(self):
        """(nsections, 5) float64 array [b0 b1 b2 a1 a2] per section —
        the flat form consumed by the device biquad-cascade kernel."""
        return np.array([[q.b0, q.b1, q.b2, q.a1, q.a2]
                         for q in self.biquads], dtype=np.float64).reshape(-1, 5)

    def __repr__(self):
        return (f"SecondOrderSections(domain={self.domain!r}, "
                f"n={len(self.biquads)}, g={self.g})")


# ---------------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------------

def _poly_from_roots(r):
    return np.poly(np.asarray(r, dtype=np.complex128)) if len(r) else np.ones(1)


def as_zpk(f):
    if isinstance(f, ZeroPoleGain):
        return f
    if isinstance(f, PolynomialRatio):
        if f.domain == "z":
            # filt arrays: coefficient i multiplies z^-i. Multiplying
            # num/den by z^(max len - 1) makes both POSITIVE-power
            # polynomials whose coefficient arrays are b/a padded with
            # TRAILING zeros — trailing-zero padding is what encodes
            # delay zeros/poles at the origin (do NOT strip leading
            # zeros first: b=[0,0,1] is the z^-2 delay, degree-0 in
            # positive powers, not z^2)
            b, a = np.atleast_1d(f.b), np.atleast_1d(f.a)
            if len(b) < len(a):
                b = np.concatenate([b, np.zeros(len(a) - len(b))])
            elif len(a) < len(b):
                a = np.concatenate([a, np.zeros(len(b) - len(a))])
        else:
            b, a = _trimz(f.b), _trimz(f.a)
        # cancel common trailing zeros (shared x^-1 / x factors), then
        # strip leading zeros — correct for positive-power polynomial
        # arrays (a delay numerator like [0, 0, 1] has degree 0)
        def _ntrail(c):
            nz = np.flatnonzero(c)
            return len(c) - 1 - nz[-1] if nz.size else 0
        t = min(_ntrail(b), _ntrail(a))
        bb = _trimz(b[: len(b) - t] if t else b)
        aa = _trimz(a[: len(a) - t] if t else a)
        z = np.roots(bb) if len(bb) > 1 else np.zeros(0, np.complex128)
        p = np.roots(aa) if len(aa) > 1 else np.zeros(0, np.complex128)
        k = (bb[0] / aa[0])
        return ZeroPoleGain(z, p, np.real_if_close(k) if not np.iscomplexobj(b)
                            else k, f.domain)
    if isinstance(f, Biquad):
        return as_zpk(as_polynomial_ratio(f))
    if isinstance(f, SecondOrderSections):
        zs, ps = [], []
        k = f.g
        for q in f.biquads:
            zpk = as_zpk(q)
            zs.append(zpk.z)
            ps.append(zpk.p)
            k = k * zpk.k
        return ZeroPoleGain(np.concatenate(zs) if zs else [],
                            np.concatenate(ps) if ps else [], k, f.domain)
    raise TypeError(f"cannot convert {type(f)} to ZeroPoleGain")


def as_polynomial_ratio(f):
    if isinstance(f, PolynomialRatio):
        return f
    if isinstance(f, ZeroPoleGain):
        b = f.k * _poly_from_roots(f.z)
        a = _poly_from_roots(f.p)
        if f.domain == "z" and len(b) != len(a):
            # filt arrays are z^-1 coefficients from index 0: a pole
            # surplus is a pure delay = LEADING zeros on b (reference
            # keeps this via its Laurent representation; MATLAB zp2sos
            # likewise emits [0, 0, 1] sections). A zero surplus would
            # need a[0] == 0 (non-causal) — the PolynomialRatio
            # constructor rejects it.
            n = max(len(b), len(a))
            b = np.concatenate([np.zeros(n - len(b)), b])
            a = np.concatenate([np.zeros(n - len(a)), a])

        def _realish(c):
            m = np.abs(c).max() if len(c) else 0.0
            if np.abs(np.imag(c)).max() <= 1e-10 * max(m, 1e-300):
                return np.real(c)
            return c
        return PolynomialRatio(_realish(b), _realish(a), f.domain)
    if isinstance(f, Biquad):
        return PolynomialRatio([f.b0, f.b1, f.b2], [1.0, f.a1, f.a2], f.domain)
    if isinstance(f, SecondOrderSections):
        return as_polynomial_ratio(as_zpk(f))
    raise TypeError(f"cannot convert {type(f)} to PolynomialRatio")


def as_biquad(f):
    if isinstance(f, Biquad):
        return f
    if isinstance(f, SecondOrderSections):
        if len(f.biquads) != 1:
            raise ValueError(
                "only a single second order section may be converted to a biquad")
        return as_biquad(f.biquads[0] * f.g)
    pr = as_polynomial_ratio(f)
    b, a = pr.b, pr.a
    if max(len(b), len(a)) > 3:
        raise ValueError("cannot convert a filter of length > 3 to Biquad")
    b3 = np.zeros(3)
    a3 = np.zeros(3)
    if pr.domain == "s":
        # s-domain: highest power (s^2) first, align at the back
        # (reference Biquad{:s}, coefficients.jl:235-283)
        b3[3 - len(b):] = b
        a3[3 - len(a):] = a
        if a3[0] == 0:
            raise ValueError(
                "s-domain Biquad requires a degree-2 denominator")
    else:
        b3[: len(b)] = b
        a3[: len(a)] = a
    if a3[0] != 1.0:
        b3 = b3 / a3[0]
        a3 = a3 / a3[0]
    return Biquad(b3[0], b3[1], b3[2], a3[1], a3[2], pr.domain)


def _split_real_complex(x, sortby=None):
    """Group values with their conjugates; returns (complex_list with
    conjugates adjacent, real_list). Raises if conjugates can't be
    matched (reference coefficients.jl:392-426)."""
    from collections import Counter

    def normal(v):
        re = abs(v.real) if v.real == 0 else v.real
        im = abs(v.imag) if v.imag == 0 else v.imag
        return complex(re, im)

    counts = Counter(normal(complex(v)) for v in x)
    keys = list(counts)
    if sortby is not None:
        keys.sort(key=sortby)
    cplx, reals = [], []
    for k in keys:
        if k.imag != 0:
            ck = normal(k.conjugate())
            if counts.get(ck, 0) != counts[k]:
                raise ValueError(
                    "complex values could not be matched to their conjugates")
            if k.imag > 0:
                for _ in range(counts[k]):
                    cplx.extend([k, k.conjugate()])
        else:
            reals.extend([k.real] * counts[k])
    return cplx, reals


def _groupzp(z, p):
    """Pair each pole (taken in order) with its nearest remaining zero;
    conjugate zeros travel together (reference coefficients.jl:372-387).
    Mutates z and p lists; returns the grouped zeros and consumed poles."""
    n = min(len(z), len(p))
    grouped = []
    i = 0
    while i < n:
        pi = p[i]
        j = min(range(len(z)), key=lambda jj: abs(z[jj] - pi))
        zj = z.pop(j)
        grouped.append(zj)
        if np.imag(zj) != 0:
            i += 1
            grouped.append(z.pop(j))
        i += 1
    consumed = p[:n]
    del p[:n]
    return grouped, consumed


def as_sos(f):
    """Convert to SecondOrderSections. For ZPK input, pairs poles
    (ordered by distance to the unit circle) with their nearest zeros
    and emits sections so the least-stable pair comes last (reference
    coefficients.jl:430-481)."""
    if isinstance(f, SecondOrderSections):
        return f
    if isinstance(f, Biquad):
        return SecondOrderSections([f], 1.0, f.domain)
    zpk = as_zpk(f)
    z, p = list(zpk.z), list(zpk.p)
    nz, n = len(z), len(p)
    if nz > n:
        raise ValueError("ZeroPoleGain must not have more zeros than poles")
    if n == 0:
        # pure gain: one identity section so downstream cascade kernels
        # always see >= 1 biquad
        return SecondOrderSections([Biquad(1.0, 0.0, 0.0, 0.0, 0.0,
                                           zpk.domain)], zpk.k, zpk.domain)

    cz, rz = _split_real_complex(z)
    cp, rp = _split_real_complex(p, sortby=lambda x: abs(abs(x) - 1))
    cz, rz, cp, rp = list(cz), list(rz), list(cp), list(rp)

    z1, p1 = _groupzp(cz, cp)       # complex poles with complex zeros
    z2, p2 = _groupzp(cz, rp)       # real poles with leftover complex zeros
    z3, p3 = _groupzp(rz, cp)       # leftover complex poles with real zeros
    z4, p4 = _groupzp(rz, rp)       # real with real

    groupedz = z1 + z2 + z3 + z4
    groupedp = p1 + p2 + p3 + p4 + cp + rp
    assert len(groupedz) == nz and len(groupedp) == n

    nsections = (n >> 1) + (n & 1)
    biquads = [None] * nsections
    npairs = n >> 1
    odd = n % 2 == 1
    for i in range(npairs):
        pairidx = 2 * (npairs - 1 - i)
        zz = groupedz[pairidx: min(pairidx + 2, nz)]
        pp = groupedp[pairidx: pairidx + 2]
        biquads[int(odd) + i] = as_biquad(
            as_polynomial_ratio(ZeroPoleGain(zz, pp, 1.0, zpk.domain)))
    if odd:
        zz = groupedz[n - 1:] if nz >= n else []
        biquads[0] = as_biquad(
            as_polynomial_ratio(ZeroPoleGain(zz, [groupedp[-1]], 1.0,
                                             zpk.domain)))
    return SecondOrderSections(biquads, zpk.k, zpk.domain)


# uniform conversion entry point
def convert(target, f):
    if target is ZeroPoleGain:
        return as_zpk(f)
    if target is PolynomialRatio:
        return as_polynomial_ratio(f)
    if target is Biquad:
        return as_biquad(f)
    if target is SecondOrderSections:
        return as_sos(f)
    raise TypeError(f"unknown target {target}")
