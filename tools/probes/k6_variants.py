"""K6 probe: variants of dsptpu_torch/csrc/pfb2.cu, made by text
substitution into copies of this checkout's dsptpu_torch under
build/probe/k6/<variant>/, each compiled alone with -Xptxas -v (its
register and stack-frame lines printed) and timed by tools/k6_ab.py
(which holds every result to the plain version), in the order A, B, C,
BC, BC, C, B, A. Variants: B the source as it is; A with the tile's
column loop counter and row length in 64-bit integers; C as A with two
blocks an SM in __launch_bounds__ from 48 taps (not three); BC the
source with that bound.

    python3 tools/probes/k6_variants.py
"""
import os
import shutil
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, ROOT)
from dsptpu_torch.kernels import _build  # noqa: E402

OUT = os.path.join(ROOT, "build", "probe", "k6")
src = open(os.path.join(ROOT, "dsptpu_torch/csrc/pfb2.cu")).read()


def sub(s, old, new):
    assert old in s, old[:60]
    return s.replace(old, new)


def w64(s):
    s = sub(s, "const int P = k * L;", "const long long P = (long long)k * L;")
    return sub(s, "for (int c = slot; c < P; c += slots)",
               "for (long long c = slot; c < P; c += slots)")


def lb2(s):
    return sub(s, "__launch_bounds__(kMaxThreads, NT <= 48 ? 3 : 2)",
               "__launch_bounds__(kMaxThreads, NT <= 40 ? 3 : 2)")


V = {"A": w64(src), "B": src, "C": lb2(w64(src)), "BC": lb2(src)}
procs = {}
for name, s in V.items():
    tree = os.path.join(OUT, name)
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "dsptpu_torch"),
                    os.path.join(tree, "dsptpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = os.path.join(tree, "dsptpu_torch", "csrc", "pfb2.cu")
    open(cu, "w").write(s)
    procs[name] = subprocess.Popen(
        [_build._nvcc(), *_build._FLAGS, "-o",
         os.path.join(tree, "pfb2_probe.so"), cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
for name, p in procs.items():
    log, _ = p.communicate()
    for line in log.splitlines():
        if "pfb2_kernel" in line or "registers" in line or "stack" in line:
            print(f"{name}: {line.strip()}", flush=True)
    if p.returncode:
        raise SystemExit(f"variant {name}: nvcc failed\n{log}")
for name in list(V) + list(V)[::-1]:
    print(f"== variant {name}", flush=True)
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "k6_ab.py"),
                    os.path.join(OUT, name)], check=True)
