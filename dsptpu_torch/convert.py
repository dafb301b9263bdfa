"""Carry parameters from the JAX package to the port.

The port imports nothing of dsptpu: parameters cross as numpy arrays
(`np.asarray(taps)`, `sos.sos_array()`, `sos.g`, `zpk.z`, ...), and these
helpers turn them into the port's tensors and coefficient objects.
Arrays keep their dtype; tensors go to `device` (default "cuda").
"""

import numpy as np

from .filters.coefficients import Biquad, SecondOrderSections, ZeroPoleGain
from .utils.device import as_tensor

__all__ = ["taps_from_numpy", "sos_from_numpy", "zpk_from_numpy",
           "state_from_numpy", "window_from_numpy"]


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
