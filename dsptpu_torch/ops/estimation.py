"""Copy of dsptpu/ops/estimation.py (numpy only; a tensor argument is
read back to the host first).

Frequency estimation: ESPRIT, Jacobsen's 3-bin interpolator, and
Quinn & Fernandes iterative refinement.

Capability parity with reference src/estimation.jl (esprit :67-75,
jacobsen :93-115, quinn :153-220). These are small-problem estimators
(SVD/eig of MxM matrices, scalar iterations): they run in host float64
numpy, with only the FFT-sized pieces device-friendly. Docstring
formulas cite the same papers as the reference.
"""

import numpy as np

__all__ = ["esprit", "jacobsen", "quinn"]


def _host(x):
    """x as a flat host numpy array (a tensor is read back)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x).reshape(-1)


def esprit(x, M, p, Fs=1.0):
    """ESPRIT frequency estimation (Roy, Paulraj & Kailath 1986;
    reference estimation.jl:67-75). x is a length-N (noisy) sum of p
    cisoids; M the correlation-window size. Returns p frequencies
    in Hz."""
    x = _host(x)
    N = len(x)
    if M > N:
        raise ValueError("M must be <= length(x)")
    # Hankel signal matrix: M x (N-M+1) shifted windows
    X = np.stack([x[i: i + N - M + 1] for i in range(M)])
    U, _, _ = np.linalg.svd(X, full_matrices=False)
    Up = U[:, :p]
    D = np.linalg.eigvals(np.linalg.lstsq(Up[:-1], Up[1:], rcond=None)[0])
    return np.angle(D) * (Fs / (2 * np.pi))


def jacobsen(x, Fs=1.0):
    """Jacobsen's fast frequency estimator (reference
    estimation.jl:93-115): parabolic-style 3-bin interpolation around
    the DFT peak."""
    x = _host(x)
    N = len(x)
    X = np.fft.fft(x)
    k = int(np.argmax(np.abs(X)))
    fpeak = np.fft.fftfreq(N, 1.0 / Fs)[k]
    Xkm1 = X[(k - 1) % N]
    Xkp1 = X[(k + 1) % N]
    delta = -np.real((Xkp1 - Xkm1) / (2 * X[k] - Xkm1 - Xkp1))
    estimate = fpeak + delta * Fs / N
    if not np.iscomplexobj(x):
        return abs(estimate)
    return estimate


def quinn(x, f0=None, Fs=1.0, tol=1e-6, maxiters=20):
    """Quinn & Fernandes (real, Biometrika 1991) / Quinn (complex, DSP
    2009) iterative frequency refinement (reference
    estimation.jl:153-220). Returns (estimate_hz, reached_maxiters)."""
    x = _host(x)
    if f0 is None:
        f0 = jacobsen(x, Fs)
    if np.iscomplexobj(x):
        return _quinn_complex(x, f0, Fs, tol, maxiters)
    return _quinn_real(x.astype(np.float64), f0, Fs, tol, maxiters)


def _quinn_real(x, f0, Fs, tol, maxiters):
    fn = Fs / 2
    w = np.pi * f0 / fn
    x = x - x.mean()
    N = len(x)
    alpha = 2 * np.cos(w)
    beta = 0.0
    xi = np.zeros(N)
    xi[0] = x[0]
    it = 0
    for it in range(1, maxiters + 1):
        xi[1] = alpha * xi[0] + x[1]
        beta = xi[1] / xi[0]
        for t in range(2, N):
            xi[t] = x[t] + alpha * xi[t - 1] - xi[t - 2]
            beta += (xi[t] + xi[t - 2]) * xi[t - 1]
        beta /= np.sum(xi[:-1] ** 2)
        if abs(alpha - beta) < tol:
            break
        alpha = 2 * beta - alpha
    return fn * np.arccos(0.5 * beta) / np.pi, it == maxiters


def _quinn_complex(x, f0, Fs, tol, maxiters):
    fn = Fs / 2
    w = np.pi * f0 / fn
    x = x - x.mean()
    N = len(x)
    xi = np.zeros(N, complex)
    xi[0] = x[0]
    it = 0
    for it in range(1, maxiters + 1):
        S = 0.0 + 0.0j
        cisw = np.exp(1j * w)
        for t in range(1, N):
            xi[t] = x[t] + cisw * xi[t - 1]
            S += x[t] * np.conj(xi[t - 1])
        num = np.imag(S * np.conj(cisw))
        den = np.sum(np.abs(xi[:-1]) ** 2)
        w += 2 * num / den
        if abs(2 * num / den) < tol:
            break
    return fn * w / np.pi, it == maxiters
