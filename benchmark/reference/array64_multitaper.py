"""Plain reference of the `array64_multitaper` configuration: DSP.jl's
default multitaper estimators worked out again in float64 from the
configuration's numbers, sharing nothing with the program.

- Tapers: the first `ntapers` discrete prolate spheroidal sequences of
  n points and half-bandwidth nw, as the eigenvectors of the largest
  eigenvalues of Slepian's tridiagonal matrix (diagonal
  ((n-1)/2 - i)^2 cos(2 pi W), off-diagonal i (n - i) / 2, W = nw/n),
  of unit norm: `torch.linalg.eigh` of the dense matrix up to DENSE_MAX
  points, above it scipy's `eigh_tridiagonal` by LAPACK's MRRR routine
  (`stemr`). Kept per (n, nw, ntapers).
- Spectrogram: power[f, t, c] = scale_f sum_k |rfft(w_k frame)|^2 / r_k
  over frames of nfft samples every nfft - overlap, with uniform weights
  1/ntapers (r_k = fs ntapers) and scale_f the one-sided doubling, not
  at DC or Nyquist.
- Coherence of the block's first coh_n rows, not demeaned (the
  configuration's `demean` false): J_k^l = rfft(w_k x_l),
  with the DC and Nyquist bins scaled by 1/sqrt(2)
  (multitaper.jl:579-582); S_lm = sum_k (2/r_k) J_k^l conj(J_k^m);
  coh = |S_lm| / sqrt(S_ll S_mm), 1 on the diagonal.

Signs: an eigenvector's sign is arbitrary, and neither output depends on
it (|X|^2 and J^l conj(J^m) are the same for -w_k), so no sign
convention is copied. The edge bins' 1/sqrt(2) scales S_ll, S_mm and
S_lm alike and cancels in the coherence; it is kept as DSP.jl has it.

precision "tf32" (the control): the signal, the tapers, the weights and
J rounded to TF32 before each product, the products and transforms in
float32 (common.py).
"""

import math

import torch

from benchmark.reference import common

# the largest taper length whose dense eigenproblem is solved by torch
DENSE_MAX = 4096
# channels a block of frames in the spectrogram (about 1 GB of float64
# tapered frames at 1,000,000 rows)
CHUNK = 8

_tapers = {}


def dpss(n, nw, ntapers):
    """(ntapers, n) float64 on the CPU: the sequences by eigenvalue,
    largest first, of unit norm, in the solver's signs."""
    key = (n, float(nw), ntapers)
    if key not in _tapers:
        i = torch.arange(n, dtype=torch.float64)
        d = ((n - 1) / 2 - i) ** 2 * math.cos(2 * math.pi * nw / n)
        j = i[1:]
        e = j * (n - j) / 2
        if n <= DENSE_MAX:
            m = torch.diag(d) + torch.diag(e, 1) + torch.diag(e, -1)
            vecs = torch.linalg.eigh(m).eigenvectors[:, -ntapers:]
        else:
            from scipy.linalg import eigh_tridiagonal
            _, v = eigh_tridiagonal(d.numpy(), e.numpy(), select="i",
                                    select_range=(n - ntapers, n - 1),
                                    lapack_driver="stemr")
            vecs = torch.from_numpy(v)
        _tapers[key] = vecs.flip(1).T.contiguous()
    return _tapers[key]


def _tapers_as(cfg, n, x, precision):
    w = dpss(n, cfg["nw"], cfg["ntapers"]).to(x.device)
    return common.operand(w, precision)


def spectrogram(cfg, x, precision):
    """(nfft//2+1, frames, C) of the block x (n, C)."""
    nfft, hop = cfg["nfft"], cfg["nfft"] - cfg["overlap"]
    w = _tapers_as(cfg, nfft, x, precision)              # (K, nfft)
    r = cfg["fs"] * cfg["ntapers"]
    scale = torch.full((nfft // 2 + 1,), 2.0 / r,
                       dtype=common.real_dtype(precision), device=x.device)
    scale[0] = 1.0 / r
    if nfft % 2 == 0:
        scale[-1] = 1.0 / r
    outs = []
    for c0 in range(0, x.shape[1], CHUNK):
        fr = common.operand(x[:, c0:c0 + CHUNK], precision).unfold(
            0, nfft, hop)                                # (t, c, nfft)
        spec = torch.fft.rfft(fr[:, :, None, :] * w, dim=-1)
        p = (spec.real ** 2 + spec.imag ** 2).sum(2)     # (t, c, bins)
        outs.append((p * scale).permute(2, 0, 1))
        del fr, spec, p
    return torch.cat(outs, 2)


def coherence(cfg, x, precision):
    """(C, C, coh_n//2+1) of the block's first coh_n rows."""
    n = cfg["coh_n"]
    seg = common.operand(x[:n], precision).T             # (C, n)
    w = _tapers_as(cfg, n, x, precision)                 # (K, n)
    J = torch.fft.rfft(seg[:, None, :] * w, dim=-1)      # (C, K, bins)
    J[..., 0] /= math.sqrt(2)
    if n % 2 == 0:
        J[..., -1] /= math.sqrt(2)
    if precision == "tf32":
        J = torch.complex(common.to_tf32(J.real), common.to_tf32(J.imag))
    weight = common.operand(torch.tensor(
        2.0 / (cfg["fs"] * cfg["ntapers"]), dtype=torch.float64,
        device=x.device), precision)
    S = torch.einsum("lkf,mkf->lmf", J * weight, J.conj())
    d = torch.diagonal(S, dim1=0, dim2=1).real.T         # (C, bins)
    coh = S.abs() / torch.sqrt(d[:, None, :] * d[None, :, :])
    del S
    eye = torch.eye(x.shape[1], dtype=torch.bool, device=x.device)
    return torch.where(eye[:, :, None], torch.ones((), dtype=coh.dtype,
                                                   device=x.device), coh)


def reference(cfg, x, precision="float64"):
    """{"power", "coherence"} of the block x (n, C) under the
    configuration `cfg` (its JSON file)."""
    return {"power": spectrogram(cfg, x, precision),
            "coherence": coherence(cfg, x, precision)}
