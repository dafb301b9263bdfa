"""K9: all-pairs multitaper coherence from the tapered spectra, a
hand-written CUDA kernel (csrc/mtcoh.cu).

Replaces no TPU kernel: dsptpu leaves the coherence to a jnp.einsum and
elementwise passes (dsptpu/ops/multitaper.py:403). It is added because
those passes, on the port's full (C, C, nbins) complex64 cross-spectral
matrix, were the largest loss of path D's measured stages. From the
tapered one-sided spectra F (C, K, nbins) complex64, the taper weights w
(K,) and the one-sided edge correction corr (nbins,), both positive, it
writes the (C, C, nbins) float32 coherence once:

    g_lk = sqrt(w_k) corr_f F_lk,  d_l = sum_k |g_lk|^2,
    coh_lm = |sum_k g_lk conj(g_mk)| / sqrt(d_l d_m),  coh_ll = 1,

the cross-spectral matrix S_lm = sum_k w_k (corr F_lk) conj(corr F_mk)
of ops/multitaper.mt_cross_power_spectra taken straight to
coherence_from_cs's |S_lm| / sqrt(S_ll S_mm), never stored. Bound on an
H100: the bytes, F read once and the coherence written once (0.049 ms
at C 64, K 7, nbins 8193).

`mtcoh` launches the kernel for a CUDA tensor and runs
`mtcoh_reference`, the plain PyTorch version (the einsum of
mt_cross_power_spectra and coherence_from_cs's passes, the arithmetic
mt_coherence had before K9), for a CPU tensor. `launches["mtcoh"]`
counts kernel launches.
"""

import ctypes

import torch

from . import _build
from ..utils.device import full_f32
from ..utils.profiling import spanned

__all__ = ["mtcoh", "mtcoh_reference", "mtcoh_supported", "launches"]

launches = {"mtcoh": 0}

# the kernel's limits: its taper loops are unrolled to 16, and a block
# holds C K rows of 32 bins (8 bytes each) in 227 KB of shared memory
MAX_TAPERS = 16
MAX_ROWS = 232448 // (32 * 8)

# dsptpu_mtcoh(F, sc, sk, w, corr, out, C, K, nb, stream)
_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 2
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_entry = None


def mtcoh_supported(C, K, nbins, dtype):
    """K9's gate: complex64 spectra of C >= 1 channels, 1 <= K <= 16
    tapers, C K <= 908 rows and at least one bin."""
    return (dtype == torch.complex64 and C >= 1 and 1 <= K <= MAX_TAPERS
            and C * K <= MAX_ROWS and nbins >= 1)


def mtcoh_reference(F, w, corr):
    """Plain PyTorch version: the cross-spectral matrix by the einsum of
    mt_cross_power_spectra, then coherence_from_cs. F (C, K, nbins)
    complex, w (K,), corr (nbins,). Returns (C, C, nbins)."""
    from ..ops.multitaper import coherence_from_cs
    G = F * corr
    with full_f32():
        cs = torch.einsum("lkf,mkf->lmf", G * w[:, None], G.conj())
    return coherence_from_cs(cs)


@spanned("kernel.mtcoh")
def mtcoh(F, w, corr):
    """The (C, C, nbins) float32 coherence of the tapered spectra F
    (C, K, nbins) complex64 with taper weights w (K,) and edge
    correction corr (nbins,), float32, on one device. w and corr are
    contiguous; F's bins are adjacent (stride 1) and its (l, k) rows lie
    at any strides (the FFT of a transposed signal lays the tapers
    outermost)."""
    global _entry
    if F.is_cpu:
        return mtcoh_reference(F, w, corr)
    if (F.dtype != torch.complex64 or w.dtype != torch.float32
            or corr.dtype != torch.float32):
        raise TypeError("mtcoh kernel takes complex64 spectra and float32 "
                        "weights and correction")
    if F.ndim != 3:
        raise ValueError("mtcoh kernel takes (C, K, nbins) spectra")
    C, K, nb = F.shape
    if not mtcoh_supported(C, K, nb, F.dtype):
        raise ValueError(f"mtcoh kernel takes 1 <= K <= {MAX_TAPERS}, "
                         f"C K <= {MAX_ROWS} and nbins >= 1")
    if tuple(w.shape) != (K,) or tuple(corr.shape) != (nb,):
        raise ValueError("mtcoh kernel takes w (K,) and corr (nbins,)")
    if ((nb > 1 and F.stride(2) != 1) or F.is_conj()
            or not (w.is_contiguous() and corr.is_contiguous())):
        raise ValueError("mtcoh kernel takes spectra with adjacent bins "
                         "and contiguous w and corr")
    if w.device != F.device or corr.device != F.device:
        raise ValueError("mtcoh kernel takes its tensors on one device")
    out = torch.empty((C, C, nb), dtype=torch.float32, device=F.device)
    if _entry is None:
        _entry = _build.entry("mtcoh", "dsptpu_mtcoh", _ARGTYPES)
    code = _entry(F.data_ptr(), F.stride(0), F.stride(1), w.data_ptr(),
                  corr.data_ptr(), out.data_ptr(), C, K, nb,
                  _build.stream_of(F))
    _build.check("mtcoh", code, "mtcoh kernel launch")
    launches["mtcoh"] += 1
    return out
