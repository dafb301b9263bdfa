"""Dirichlet kernel on torch tensors (port of dsptpu/utils/diric.py;
reference src/diric.jl:38-64)."""

import math

import torch

from .device import as_tensor

__all__ = ["diric"]


def diric(omega, n, device=None):
    """Periodic sinc / Dirichlet kernel diric(omega, n) =
    sin(n*omega/2) / (n*sin(omega/2)), with exact +/-1 at the period
    points. Elementwise over omega (a tensor, or values that go to
    `device`); integer omega is computed in float32."""
    if n <= 0:
        raise ValueError("n must be positive")
    omega = as_tensor(omega, device)
    if not omega.is_floating_point():
        omega = omega.to(torch.float32)
    two_pi = 2 * math.pi

    if n % 2 == 1:
        w = omega - two_pi * torch.round(omega / two_pi)  # [-pi, pi)
        sign = torch.ones_like(w)
    else:
        # [-2pi, 2pi), then folded into [-pi, pi] with the sign flip
        w = 2 * (omega / 2 - two_pi * torch.round(omega / (2 * two_pi)))
        one = torch.ones_like(w)
        sign = torch.where(w.abs() > math.pi, -one, one)
        w = torch.where(w > math.pi, w - two_pi,
                        torch.where(w < -math.pi, w + two_pi, w))

    denom = torch.sin(w / 2)
    near_zero = denom.abs() <= torch.finfo(omega.dtype).eps
    safe = torch.where(near_zero, torch.ones_like(denom), denom)
    val = sign * torch.sin(w * n / 2) / (n * safe)
    return torch.where(near_zero, sign, val)
