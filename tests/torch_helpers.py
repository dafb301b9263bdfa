"""Helpers shared by the dsptpu_torch tests and chip_smoke.py. They
import torch and the port only when called, so that the card's tests
run without JAX."""


def filtfilt_two_cats(ss, zst_np, x, pad):
    """dsptpu_torch's filtfilt kernel route (filters/filt.py:
    _filtfilt_kernel) in the form that copied the whole signal twice: the
    back extension appended to x before K2's forward pass, and the
    closed-form tail appended to the reverse pass's output. The route is
    held to it bit for bit. ss a K2 system, zst_np its step state, x
    (n, C) float32 with n >= 4*128 + pad."""
    import torch
    from dsptpu_torch.filters.filt import _ff_edge_tables
    from dsptpu_torch.kernels.biir import blockss_filt
    from dsptpu_torch.utils.device import full_f32
    n = x.shape[0]
    m = (n // ss.V) * ss.V
    q = n - m + pad
    with full_f32():
        Apad, Kf, Aq, Krq, Fr, Gr, zst = _ff_edge_tables(
            ss, zst_np, pad, q, n - m, x.device)
        front = 2 * x[0] - x[1: pad + 1].flip(0)
        z_e = Apad @ (zst[:, None] * front[0][None, :]) + Kf @ front
        back = 2 * x[-1] - x[n - 1 - pad: n - 1].flip(0)
        y1 = blockss_filt(ss, torch.cat([x, back], 0), z_e)
        seg = y1[m: n + pad]
        z0r = zst[:, None] * y1[n + pad - 1][None, :]
        z_rr = Aq @ z0r + Krq @ seg
        y2main = blockss_filt(ss, y1, z_rr, reverse=True, n_eff=m)
        return torch.cat([y2main, Fr @ seg + Gr @ z0r], 0)
