"""Copy of dsptpu/utils/special.py (numpy only).

Special functions needed by the design layer.

The reference library pulls these from external packages (Bessels.jl
`besseli0` used by the kaiser window, reference src/windows.jl:600-604;
SpecialFunctions.jl `ellipk` used by elliptic filter-order estimation,
reference src/Filters/filt_order.jl:99-100). We implement them from
scratch in float64 numpy: they run at *design time* on the host, so
accuracy matters more than device throughput.
"""

import numpy as np

__all__ = ["besseli0", "ellipk"]


def besseli0(x):
    """Modified Bessel function of the first kind, order zero, I0(x).

    Vectorized float64 implementation. Uses the all-positive power
    series (no cancellation, accurate to ~1 ulp per term count) for
    moderate arguments and the large-x asymptotic expansion beyond.
    """
    x = np.abs(np.asarray(x, dtype=np.float64))
    scalar = x.ndim == 0
    x = np.atleast_1d(x)
    out = np.empty_like(x)

    small = x <= 600.0
    if np.any(small):
        xs = x[small]
        # series: sum_k (x/2)^(2k) / (k!)^2, all terms positive
        t = np.square(0.5 * xs)  # (x/2)^2
        term = np.ones_like(xs)
        acc = np.ones_like(xs)
        for k in range(1, 1000):
            term = term * t / (k * k)
            acc = acc + term
            if np.all(term <= np.finfo(np.float64).eps * acc):
                break
        out[small] = acc

    big = ~small
    if np.any(big):
        xb = x[big]
        # I0(x) ~ e^x / sqrt(2 pi x) * sum_k a_k / x^k,
        # a_k = ((2k-1)!!)^2 / (8^k k!)
        inv = 1.0 / xb
        term = np.ones_like(xb)
        acc = np.ones_like(xb)
        a = 1.0
        for k in range(1, 25):
            a *= (2 * k - 1) ** 2 / (8.0 * k)
            new = a * inv**k
            acc = acc + new
            if np.all(new <= np.finfo(np.float64).eps * acc):
                break
        # split the exponential to avoid overflow near the float64 limit
        half = np.exp(0.5 * xb)
        out[big] = half * (acc / np.sqrt(2.0 * np.pi * xb)) * half

    return out[()] if scalar and out.shape == (1,) else (out[0] if scalar else out)


def ellipk(m):
    """Complete elliptic integral of the first kind K(m) (parameter m = k^2).

    AGM (arithmetic-geometric mean) iteration: K(m) = pi / (2 * agm(1, sqrt(1-m))).
    Accurate to float64 roundoff; quadratic convergence.
    """
    m = np.asarray(m, dtype=np.float64)
    if np.any(m >= 1.0) and not np.all(m[m >= 1.0] == 1.0):
        raise ValueError("ellipk requires m <= 1")
    a = np.ones_like(m)
    b = np.sqrt(1.0 - m)
    for _ in range(60):
        a, b = 0.5 * (a + b), np.sqrt(a * b)
        if np.all(np.abs(a - b) <= 4 * np.finfo(np.float64).eps * np.abs(a)):
            break
    out = np.pi / (2.0 * a)
    out = np.where(m == 1.0, np.inf, out)
    return out[()]
