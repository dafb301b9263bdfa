"""Carry parameters from the JAX package to the port.

The port imports nothing of dsptpu: parameters cross as numpy arrays
(`np.asarray(taps)`, `sos.sos_array()`, `sos.g`, `zpk.z`, ...), and these
helpers turn them into the port's tensors and coefficient objects.
Arrays keep their dtype; tensors go to `device` (default "cuda").
"""

import numpy as np

from .filters.coefficients import Biquad, SecondOrderSections, ZeroPoleGain
from .filters.stream_filt import FIRFilter
from .ops.multitaper import MTConfig
from .utils.device import as_tensor

__all__ = ["taps_from_numpy", "sos_from_numpy", "zpk_from_numpy",
           "state_from_numpy", "window_from_numpy", "firfilter_from_numpy",
           "mtconfig_from_numpy"]


def taps_from_numpy(b, device=None):
    """FIR taps (nb,) as a tensor."""
    return as_tensor(np.asarray(b).reshape(-1), device)


def sos_from_numpy(sos, g=1.0):
    """(nsec, 5) [b0 b1 b2 a1 a2] rows and gain g as the port's
    SecondOrderSections. Rows given in float32 (as dsptpu's
    __graft_entry__ passes them) are taken at their float64 values, as
    the reference does when it builds its tables."""
    rows = np.asarray(sos, dtype=np.float64).reshape(-1, 5)
    return SecondOrderSections([Biquad(*r) for r in rows], float(g))


def zpk_from_numpy(z, p, k):
    return ZeroPoleGain(np.asarray(z), np.asarray(p), k)


def state_from_numpy(si, device=None):
    """Filter state (sosfilt's (2, nsec, *chans) or filt's
    (order, *chans)) as a tensor."""
    return as_tensor(np.asarray(si), device)


def window_from_numpy(w, device=None):
    return as_tensor(np.asarray(w).reshape(-1), device)


_STREAM_STATE = ("phi_idx", "input_deficit", "phi_accumulator", "_acc_base",
                 "_deficit_base", "_j_total", "_consumed_total")


def firfilter_from_numpy(h, rate, nphi=32, state=None, device=None):
    """The port's FIRFilter(h, rate, nphi), continuing a stream: `state`
    is a dict of plain values read off a dsptpu FIRFilter mid-stream,
    `history` (numpy, or None for a fresh stream) and the kernel's
    counters phi_idx, input_deficit, phi_accumulator and the anchor
    counters _acc_base, _deficit_base, _j_total and _consumed_total
    (each where the filter's kind has it). The history goes to
    `device`."""
    f = FIRFilter(np.asarray(h), rate, nphi)
    if state:
        k = f.kernel
        for name in _STREAM_STATE:
            if name in state and hasattr(k, name):
                setattr(k, name, type(getattr(k, name))(state[name]))
        if state.get("history") is not None:
            f.history = as_tensor(np.array(state["history"]), device)
    return f


def mtconfig_from_numpy(n_samples, fs, nfft, ntapers, onesided, window, r):
    """The port's MTConfig from a dsptpu MTConfig's plain fields:
    `window` the (n_samples, ntapers) taper array (`cfg.window_array`)
    and `r` the per-taper normalization (`cfg.r`), both taken as float64.
    A config made by dsptpu's dpss_config (eigenvalue filtering or
    weighting) then runs unchanged through the port."""
    window = np.array(window, dtype=np.float64)
    r = np.array(r, dtype=np.float64).reshape(-1)
    if window.shape != (int(n_samples), int(ntapers)) or r.shape != (
            int(ntapers),):
        raise ValueError("window must be (n_samples, ntapers) and r "
                         "(ntapers,)")
    return MTConfig(int(n_samples), float(fs), int(nfft), int(ntapers),
                    bool(onesided), window, r)
