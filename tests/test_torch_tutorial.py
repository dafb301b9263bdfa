"""docs/TUTORIAL_TORCH.md must stay executable, as tests/test_tutorial.py
keeps docs/TUTORIAL.md: every ```python block runs in one shared
namespace, in order, on the CPU (its first block sets device = "cpu").
The walkthrough's claims hold (the 440 Hz peak, |H| above 0.9 below
1 kHz and below 0.05 above 8 kHz), its signal is float32 (the dtype
every kernel's gate takes, so that with device = "cuda" the calls go
through the kernels), and its psd and H equal those of the JAX
tutorial's blocks, run in their own namespace as a JAX user runs them,
without x64 (so psd is float32 on both sides), within 1e-6 of their
largest value."""

import pathlib
import re

import jax
import numpy as np
import torch

DOCS = pathlib.Path(__file__).resolve().parent.parent / "docs"


def run_blocks(name):
    blocks = re.findall(r"```python\n(.*?)```", (DOCS / name).read_text(),
                        re.S)
    assert len(blocks) >= 8, f"{name} lost its code blocks"
    ns = {}
    for i, block in enumerate(blocks):
        try:
            exec(compile(block, f"{name}[block {i}]", "exec"), ns)
        except Exception as e:  # pragma: no cover
            raise AssertionError(
                f"{name} block {i} failed: {type(e).__name__}: {e}\n"
                f"---\n{block}") from e
    return ns


def test_torch_tutorial_blocks_execute():
    ns = run_blocks("TUTORIAL_TORCH.md")
    assert ns["device"] == "cpu" and ns["x"].dtype == torch.float32
    freqs, psd = ns["freqs"], ns["psd"]
    assert abs(freqs[psd.argmax()] - 440.0) < 44100 / 1024
    H = np.asarray(ns["H"])
    w, fs = ns["w"], ns["fs"]
    band = np.abs(H[w < 2 * np.pi * 1000 / fs])
    stop = np.abs(H[w > 2 * np.pi * 8000 / fs])
    assert band.min() > 0.9 and stop.max() < 0.05

    with jax.enable_x64(False):      # conftest turns x64 on
        ref = {k: np.asarray(v) for k, v in run_blocks("TUTORIAL.md").items()
               if k in ("freqs", "psd", "H")}
    for name in ("freqs", "psd", "H"):
        got, want = np.asarray(ns[name]), np.asarray(ref[name])
        assert got.shape == want.shape and got.dtype == want.dtype, name
        err = np.max(np.abs(got - want)) / np.max(np.abs(want))
        assert err <= 1e-6, (name, err)
