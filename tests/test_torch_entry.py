"""The whole slice: dsptpu_torch.entry's chain against dsptpu's
__graft_entry__.entry on its own (16384 x 4) input, and against the same
chain built from dsptpu at a size where every kernel gate holds (so the
CPU runs the plain version of each kernel). Also the device rule: with
no CUDA, entry() raises instead of running on the CPU, and CPU tensors
launch no kernel. Tolerance: max|d| <= 1e-4 max|ref| for the float32
chain (the IIR stage accumulates f32 error)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import dsptpu
import dsptpu_torch
from dsptpu_torch import kernels
from dsptpu_torch.pipeline import chain_params

import __graft_entry__


def check(got, want, tol=1e-4):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.max(np.abs(got - want))
    assert err <= tol * np.max(np.abs(want)), err


def test_entry_matches_graft_entry():
    fn, (x,) = __graft_entry__.entry()
    psd_ref, s_ref = fn(x)
    kernels.reset_launches()
    fwd, (xt,) = dsptpu_torch.entry(device="cpu", n=16384, channels=4,
                                    order=6, cutoff=0.3, nfft=256)
    assert np.array_equal(xt.numpy(), np.asarray(x))
    psd, s = fwd(xt)
    assert psd.dtype == torch.float32 and s.dtype == torch.float32
    check(psd, psd_ref)
    check(s, s_ref)
    assert kernels.launch_counts() == {"fir": 0, "biir": 0, "stft": 0}


def test_entry_at_kernel_gates_matches_dsptpu():
    """n >= 32768: the FIR, IIR and STFT gates all hold (the full-width
    configuration's routing, at 3 channels)."""
    n, C, nfft = 40000, 3, 1024
    taps, sos, win = chain_params(8, 0.2, nfft)
    fwd, (xt,) = dsptpu_torch.entry(device="cpu", n=n, channels=C)
    x = jnp.asarray(xt.numpy())
    y = dsptpu.filt(jnp.asarray(taps), x)
    y = dsptpu.sosfilt(jnp.asarray(sos), y)
    psd_ref = dsptpu.power(dsptpu.welch_pgram(y, nfft, nfft // 2,
                                              window=jnp.asarray(win)))
    s_ref = dsptpu.stft(y, nfft, nfft // 2, window=jnp.asarray(win),
                        psdonly=True)
    kernels.reset_launches()
    psd, s = fwd(xt)
    check(psd, psd_ref)
    check(s, s_ref)
    assert kernels.launch_counts() == {"fir": 0, "biir": 0, "stft": 0}


def test_entry_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: entry() runs on the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        dsptpu_torch.entry()


def test_numpy_input_goes_to_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: numpy input goes to the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        dsptpu_torch.filt(np.ones(5), np.zeros(100))
    y = dsptpu_torch.filt(np.ones(5), np.zeros(100), device="cpu")
    assert y.device.type == "cpu"
