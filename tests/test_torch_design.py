"""Port parity: the host design layer of dsptpu_torch is a numpy copy of
dsptpu's, so windows, IIR/FIR designs and SOS conversion must agree
EXACTLY (np.array_equal). Also checks that the port imports neither jax
nor dsptpu."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

import dsptpu
import dsptpu_torch
from dsptpu.filters import as_sos as jax_as_sos

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name,args", [
    ("hamming", (127,)), ("hamming", (64,)), ("hanning", (1024,)),
    ("hanning", (256,)), ("hanning", (33,)), ("kaiser", (101, 3.0)),
    ("kaiser", (64, 8.6)),
])
def test_windows_exact(name, args):
    want = np.asarray(getattr(dsptpu.windows, name)(*args))
    got = np.asarray(getattr(dsptpu_torch.windows, name)(*args))
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("order,cut", [(2, 0.1), (6, 0.3), (8, 0.2),
                                       (9, 0.45)])
def test_butterworth_sos_exact(order, cut):
    ref = jax_as_sos(dsptpu.digitalfilter(dsptpu.Lowpass(cut),
                                          dsptpu.Butterworth(order)))
    got = dsptpu_torch.as_sos(dsptpu_torch.digitalfilter(
        dsptpu_torch.Lowpass(cut), dsptpu_torch.Butterworth(order)))
    assert np.array_equal(got.sos_array(), ref.sos_array())
    assert got.g == ref.g


@pytest.mark.parametrize("ntaps,cut,win", [(127, 0.25, "hamming"),
                                          (31, 0.1, "hanning"),
                                          (64, 0.4, "hamming")])
def test_firwindow_exact(ntaps, cut, win):
    ref = np.asarray(dsptpu.digitalfilter(dsptpu.Lowpass(cut),
                                          dsptpu.FIRWindow.create(np.asarray(
                                              getattr(dsptpu.windows,
                                                      win)(ntaps)))))
    got = np.asarray(dsptpu_torch.digitalfilter(
        dsptpu_torch.Lowpass(cut), dsptpu_torch.FIRWindow.create(
            np.asarray(getattr(dsptpu_torch.windows, win)(ntaps)))))
    assert np.array_equal(got, ref)


def test_import_pulls_in_neither_jax_nor_dsptpu():
    code = ("import sys; before = set(sys.modules); import dsptpu_torch; "
            "new = set(sys.modules) - before; "
            "print(sorted(m for m in new "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'dsptpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip()
    assert out == "[]"


def test_no_source_imports_jax_or_dsptpu():
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|dsptpu)\b", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "dsptpu_torch")):
        files += [os.path.join(d, f) for f in names if f.endswith(".py")]
    assert len(files) > 10
    bad = [f for f in files if pat.search(open(f).read())]
    assert not bad, bad
