"""FFT size planning helpers (port of dsptpu/utils/fftutil.py; the
dtype helpers map to torch dtypes).

Capability parity with reference src/util.jl:107-135 (`nextfastfft` via
nextprod over {2,3,5,7}). On TPU, XLA's FFT strongly prefers power-of-2
sizes, so kernels in this package plan with `nextpow2` by default;
`nextfastfft` is kept for API/semantics parity (and because several
exact-output-length contracts in the reference depend on it).
"""

import math

import torch

__all__ = ["nextfastfft", "nextpow2", "nextprod",
           "fftintype", "fftouttype", "fftabs2type"]


def nextprod(factors, n):
    """Smallest integer >= n that is a product of powers of `factors`."""
    if n <= 1:
        return 1
    best = None
    factors = sorted(set(int(f) for f in factors))

    def search(i, prod):
        nonlocal best
        if best is not None and prod >= best:
            return
        if prod >= n:
            best = prod if best is None else min(best, prod)
            return
        if i == len(factors) - 1:
            f = factors[i]
            # multiply by f until >= n
            p = prod
            while p < n:
                p *= f
            if best is None or p < best:
                best = p
            return
        f = factors[i]
        p = prod
        while True:
            search(i + 1, p)
            if p >= n:
                break
            p *= f

    search(0, 1)
    return best


def nextfastfft(n):
    """Next size >= n that is a product of 2, 3, 5, 7 (reference src/util.jl:134)."""
    return nextprod((2, 3, 5, 7), int(n))


def nextpow2(n):
    """Next power of two >= n. Preferred FFT size on TPU (MXU/XLA-friendly)."""
    n = int(n)
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


# ---------------------------------------------------------------------------
# FFT dtype promotion policy (reference util.jl:92-104)
# ---------------------------------------------------------------------------
#
# One policy used by conv / periodograms / hilbert so integer and
# low-precision inputs promote consistently. The reference promotes
# non-FFTW types to Float64/ComplexF64; here the accelerator-native
# default is float32 (float64 only when x64 is enabled and the input
# is already 64-bit).

def fftintype(dtype):
    """Element type an FFT input of torch `dtype` is computed in."""
    if dtype.is_complex:
        return dtype
    if dtype in (torch.float32, torch.float64):
        return dtype
    if dtype.is_floating_point:  # f16/bf16 -> f32
        return torch.float32
    return torch.promote_types(dtype, torch.float32)


def fftouttype(dtype):
    """Element type an FFT of `dtype` input returns."""
    return torch.promote_types(fftintype(dtype), torch.complex64)


def fftabs2type(dtype):
    """Real element type of |FFT|^2 for `dtype` input."""
    t = fftintype(dtype)
    if t.is_complex:
        return torch.float64 if t == torch.complex128 else torch.float32
    return t
