"""Port parity for the native stream reader (dsptpu_torch.native): the
port's own copy of ringbuffer.cpp, built under build/, read to CPU
tensors here (device="cpu"; the card's pinned-buffer route is in
tests/test_torch_cuda.py), against the file's samples and against
dsptpu's StreamReader chunk for chunk; chunked file streaming through
the stateful FIRFilter equals one-shot filtering and dsptpu's. A failed
build raises, and native=False reads through numpy.memmap."""

from fractions import Fraction

import numpy as np
import pytest
import torch

import dsptpu
import dsptpu_torch
from dsptpu.native import StreamReader as JaxStreamReader
from dsptpu_torch import native
from dsptpu_torch.native import StreamReader, native_available


@pytest.fixture
def sample_file(tmp_path):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(100_000).astype(np.float32)
    p = tmp_path / "stream.f32"
    x.tofile(p)
    return str(p), x


def test_native_compiles():
    assert native_available(), "C++ toolchain should be available"
    # built under build/, nothing next to the source
    assert "build" in native._build().parts
    assert not list(native._SRC.parent.glob("*.so"))


@pytest.mark.parametrize("use_native", [True, False])
def test_reads_whole_file(sample_file, use_native):
    path, x = sample_file
    with StreamReader(path, chunk=8192, device="cpu",
                      native=use_native) as sr:
        chunks = list(sr)
    assert all(isinstance(c, torch.Tensor) and c.dtype == torch.float32
               for c in chunks)
    np.testing.assert_array_equal(torch.cat(chunks).numpy(), x)
    assert len(chunks) == -(-len(x) // 8192)
    with JaxStreamReader(path, chunk=8192) as sr:
        for got, want in zip(chunks, sr):
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("use_native", [True, False])
def test_multichannel_chunks(tmp_path, use_native):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((5000, 4)).astype(np.float32)
    p = tmp_path / "mc.f32"
    x.tofile(p)  # interleaved
    with StreamReader(str(p), chunk=700, channels=4, device="cpu",
                      native=use_native) as sr:
        parts = list(sr)
    assert parts[0].shape == (700, 4) and parts[-1].shape == (100, 4)
    np.testing.assert_array_equal(torch.cat(parts).numpy(), x)


def test_other_dtype_and_small_ring(tmp_path):
    x = np.arange(10_001, dtype=np.int16)
    p = tmp_path / "i16.raw"
    x.tofile(p)
    with StreamReader(str(p), chunk=999, dtype=np.int16, nslots=2,
                      device="cpu") as sr:
        got = torch.cat(list(sr))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), x)


def test_streaming_pipeline_matches_oneshot(sample_file):
    path, x = sample_file
    ratio = Fraction(3, 2)
    h = np.asarray(dsptpu.resample_filter(ratio)).astype(np.float32)
    whole = dsptpu_torch.FIRFilter(h, ratio).filt(torch.as_tensor(x))
    sf = dsptpu_torch.FIRFilter(h, ratio)
    with StreamReader(path, chunk=10_000, device="cpu") as sr:
        got = torch.cat([sf.filt(c) for c in sr])
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-6)
    ref = np.asarray(dsptpu.FIRFilter(h, ratio).filt(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_missing_file_raises(tmp_path):
    with pytest.raises(OSError):
        StreamReader(str(tmp_path / "none.f32"), chunk=10, device="cpu")


def test_failed_build_raises(sample_file, monkeypatch):
    # no quiet fallback to memmap: a compiler that fails is an error
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_CXX", "/nonexistent/c++")
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        StreamReader(sample_file[0], chunk=10, device="cpu")
    assert not native_available()


def test_cuda_is_the_default_device(sample_file):
    # the reader goes to the card unless the caller asks for the CPU
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamReader(sample_file[0], chunk=10)
