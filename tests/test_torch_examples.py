"""The port's examples (examples/torch_*.py) on the CPU: each main(
device="cpu") checks its own claims (a false one raises SystemExit), and
its final arrays are held to those of the JAX example of the same name
(examples/*.py, run in its own namespace by runpy on the same seeded
input). The JAX scripts' slowest calls run under jax.jit, once each:
dsptpu's filtfilt and lpc in the audio pipeline, and its sharded ops in
the distributed one (eagerly they compile op by op, 78 s on this CPU).
The distributed example runs on simulate_hosts(4), a (2, 2) mesh of
gloo ranks; the JAX one on conftest's 8 virtual CPU devices, (2, 4).

Tolerances, max|d| <= tol max|ref|: bench.py's witness bounds, 3e-5 for
FIR, resampling and spectra, 1e-4 for filtfilt, LPC and the chains that
hold an IIR pass. Under x64 dsptpu computes the float32 signal in
float64 where its taps are float64; the port keeps float32. So the audio
pipeline's LPC, of ill-conditioned lowpassed frames, is held to dsptpu's
at 1e-9 on the JAX example's float64 frames and at 1e-3 from its own
float32 frames (see the test)."""

import pathlib
import runpy
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import dsptpu
import dsptpu.parallel as jpar
import dsptpu_torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"


@pytest.fixture(scope="module")
def examples():
    """The examples directory on sys.path, so that spawned gloo ranks
    can import the distributed example's rank function by name."""
    sys.path.insert(0, str(EXAMPLES))
    yield
    sys.path.remove(str(EXAMPLES))


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= tol, err


def jax_example(name):
    return runpy.run_path(str(EXAMPLES / f"{name}.py"))


def test_audio_pipeline(examples, monkeypatch, capsys):
    import torch_audio_pipeline
    got = torch_audio_pipeline.main(device="cpu")
    assert "pipeline OK" in capsys.readouterr().out
    ff, lpc = dsptpu.filtfilt, dsptpu.lpc
    monkeypatch.setattr(dsptpu, "filtfilt",
                        lambda f, x: jax.jit(lambda v: ff(f, v))(x))
    monkeypatch.setattr(dsptpu, "lpc", lambda x, p, m: jax.jit(
        lambda v: lpc(v, p, m))(x))
    ns = jax_example("audio_pipeline")
    close(got["y"], ns["y"], 1e-4)
    close(got["y_stream"], ns["y_stream"], 3e-5)
    close(got["z"], ns["z"], 1e-4)
    close(got["psd"], dsptpu.power(ns["p"]), 1e-4)
    close(got["sg"], dsptpu.power(ns["sg"]), 1e-4)
    # LPC of a 2 kHz lowpass at 48 kHz is ill-conditioned: from float32
    # frames the port's coefficients lie 2.2e-4 of max|a| from the
    # float64 ones (dsptpu's own lpc of the same float32 frames 3.3e-4),
    # so the stage is held to dsptpu on the JAX example's float64 frames,
    # and the example's float32 result to 1e-3
    a64 = dsptpu_torch.lpc(torch.as_tensor(np.array(ns["frames"])), 16,
                           dsptpu_torch.LPCLevinson())[0]
    close(a64, ns["a"], 1e-9)
    close(got["a"], ns["a"], 1e-3)


def test_streaming_io(examples, capsys):
    import torch_streaming_io
    got = torch_streaming_io.main(device="cpu")
    assert capsys.readouterr().out.endswith("OK\n")
    ns = jax_example("streaming_io")
    close(got["y_stream"], ns["y_stream"], 3e-5)
    close(got["y_whole"], ns["y_whole"], 3e-5)


def _jit_signal(fn, pos):
    """fn under jax.jit with its positional argument `pos` (the signal)
    traced and the rest closed over."""
    def call(*args, **kw):
        def f(v):
            a = list(args)
            a[pos] = v
            return fn(*a, **kw)
        return jax.jit(f)(jnp.asarray(args[pos]))
    return call


def test_distributed_pipeline(examples, monkeypatch, capsys):
    import torch_distributed_pipeline
    got = torch_distributed_pipeline.main(device="cpu", hosts=4)
    out = capsys.readouterr().out
    assert "mesh: {'channel': 2, 'time': 2}" in out
    assert out.endswith("matches the single-device computation\n")
    for name, pos in (("shard_fir", 1), ("shard_sosfilt", 2),
                      ("shard_filtfilt", 2), ("shard_welch", 0)):
        monkeypatch.setattr(jpar, name, _jit_signal(getattr(jpar, name),
                                                    pos))
    ns = jax_example("distributed_pipeline")
    close(got["psd"], ns["psd"], 1e-4)
    close(got["ref"], ns["ref"], 1e-4)
    close(got["pw"], ns["pw"], 3e-5)


@pytest.mark.parametrize("name", ["torch_audio_pipeline",
                                  "torch_distributed_pipeline",
                                  "torch_streaming_io"])
def test_example_needs_no_jax(name):
    """The examples import torch, numpy and dsptpu_torch, never JAX or
    dsptpu."""
    src = (EXAMPLES / f"{name}.py").read_text()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in ("jax", "dsptpu"), line
