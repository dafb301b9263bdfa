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
import jax
import jax.numpy as jnp

import dsptpu
import dsptpu_torch
from dsptpu_torch import kernels
from dsptpu_torch.pipeline import (MT_NFFT, MT_NTAPERS, MT_NW, MT_OVERLAP,
                                   chain_params)

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
    assert set(kernels.launch_counts().values()) == {0}


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
    assert set(kernels.launch_counts().values()) == {0}


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


def test_fftfilt_entry_matches_dsptpu():
    """Path A at 40000 x 3 with the full path's 4096 taps (nfft 16384,
    K4's gate; its plain version on the CPU). Tolerance 3e-5 (bench.py's
    overlap-save bound)."""
    fwd, (xt,) = dsptpu_torch.fftfilt_entry(device="cpu", n=40000,
                                            channels=3)
    h = np.asarray(dsptpu.digitalfilter(dsptpu.Lowpass(0.1),
                                        dsptpu.FIRWindow.create(np.asarray(
                                            dsptpu.windows.hamming(4096)))),
                   dtype=np.float32)
    want = dsptpu.fftfilt(jnp.asarray(h), jnp.asarray(xt.numpy()))
    kernels.reset_launches()
    got = fwd(xt)
    assert got.dtype == torch.float32
    check(got, want, 3e-5)
    assert set(kernels.launch_counts().values()) == {0}


def test_filtfilt_lpc_entry_matches_dsptpu():
    """Path B at 40000 x 3: filtfilt through the kernel route (K2
    forward, reverse with n_eff; plain versions on the CPU) and LPC of
    100 frames of channel 0. Tolerance 1e-4 (bench.py's filtfilt and LPC
    bound). The reference side runs under jax.jit."""
    fwd, (xt,) = dsptpu_torch.filtfilt_lpc_entry(device="cpu", n=40000,
                                                 channels=3)
    x = xt.numpy()
    f = dsptpu.filters.as_sos(dsptpu.digitalfilter(dsptpu.Lowpass(0.2),
                                                   dsptpu.Butterworth(8)))
    y_ref = jax.jit(lambda v: dsptpu.filtfilt(f, v))(jnp.asarray(x))
    a_ref, e_ref = jax.jit(lambda v: dsptpu.lpc(v, 16, method="levinson"))(
        jnp.asarray(x[:, 0].reshape(100, 400).T))
    kernels.reset_launches()
    y, (a, e) = fwd(xt)
    assert a.shape == (16, 100) and e.shape == (100,)
    check(y, y_ref)
    check(a, a_ref)
    check(e, e_ref)
    assert set(kernels.launch_counts().values()) == {0}


def test_multitaper_entry_matches_dsptpu():
    """Path D at 30000 x 3: the multitaper spectrogram through K3's
    K-window stack (its plain version on the CPU; nfft 1024, hop 512, 7
    DPSS tapers, NW 4) and the coherence of the first 2048 samples,
    against the same dsptpu calls. Tolerance 3e-5 (bench.py's
    spectrogram bound) for the spectrogram, 1e-4 for the coherence."""
    fwd, (xt,) = dsptpu_torch.multitaper_entry(device="cpu", n=30000,
                                               channels=3, coh_n=2048)
    x = jnp.asarray(xt.numpy())
    cfg = dsptpu.MTConfig.create(MT_NFFT, nfft=MT_NFFT, nw=MT_NW,
                                 ntapers=MT_NTAPERS)
    spec_ref = dsptpu.mt_spectrogram(x, config=cfg,
                                     n_overlap=MT_OVERLAP).power
    coh_ref = dsptpu.mt_coherence(x[:2048].T, nw=MT_NW, ntapers=MT_NTAPERS,
                                  nfft=2048).coherence
    kernels.reset_launches()
    spec, coh = fwd(xt)
    assert spec.shape == (513, 57, 3) and coh.shape == (3, 3, 1025)
    assert spec.dtype == torch.float32 and coh.dtype == torch.float32
    check(spec, spec_ref, 3e-5)
    check(coh, coh_ref)
    assert set(kernels.launch_counts().values()) == {0}


def test_path_entries_without_cuda_raise():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the entries run on the card")
    for make in (dsptpu_torch.fftfilt_entry,
                 dsptpu_torch.filtfilt_lpc_entry,
                 dsptpu_torch.multitaper_entry):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


@pytest.mark.parametrize("before", [False, True])
@pytest.mark.parametrize("how", ["exit", "exception", "decorator"])
def test_full_f32_restores_allow_tf32(before, how):
    """full_f32() turns TF32 off for float32 products inside it and gives
    the caller's allow_tf32 back on exit, also after an exception."""
    from dsptpu_torch.utils.device import full_f32
    mm = torch.backends.cuda.matmul
    saved = mm.allow_tf32
    try:
        mm.allow_tf32 = before
        seen = []

        @full_f32()
        def inner():
            seen.append(mm.allow_tf32)

        if how == "exit":
            with full_f32():
                seen.append(mm.allow_tf32)
        elif how == "exception":
            with pytest.raises(ValueError):
                with full_f32():
                    seen.append(mm.allow_tf32)
                    raise ValueError("inside")
        else:
            inner()
            inner()
        assert seen and not any(seen)
        assert mm.allow_tf32 == before
    finally:
        mm.allow_tf32 = saved


def test_full_f32_under_the_per_backend_api():
    """A caller who set TF32 through torch's per-backend fp32_precision
    (where the legacy flag cannot be read) gets "ieee" inside full_f32()
    and their own setting back after it."""
    from dsptpu_torch.utils.device import full_f32
    mm = torch.backends.cuda.matmul
    if not hasattr(torch._C, "_get_fp32_precision_getter"):
        pytest.skip("this torch has no per-backend fp32_precision")
    saved = mm.allow_tf32
    try:
        mm.fp32_precision = "tf32"
        with full_f32():
            assert mm.fp32_precision == "ieee"
        assert mm.fp32_precision == "tf32"
    finally:
        mm.fp32_precision = "ieee"
        mm.allow_tf32 = saved
