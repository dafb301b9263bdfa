"""K5 probe: variants of dsptpu_torch/csrc/levinson.cu, made by text
substitution into copies of this checkout's dsptpu_torch under
build/probe/k5/<variant>/. The variants' levinson.cu are built in
parallel (`-Xptxas -v`: registers and stack frames printed), then each
is called through its wrapper at path B's shape (p 16, C 2500), at p 32
and 64 with C 2500, and at p 16 and C 160,000: held to the plain version
(max|d| / max|ref| <= 1e-4), then timed: device ms of the kernels named
"levinson" per call (torch.profiler over 10 calls). T<n>: n threads a
block; A<n>: n accumulators for the order's dot; LB0: launch bounds
without a minimum of blocks an SM (P = 32 then spills); inc: refl's store address advanced a row
an order; seq: each order under its own `if (M <= p)`, not an early
return. Knock-out (timed
without the check): "nodiv" multiplies by err where the kernel divides
(the IEEE division's share of the chain). Variants run in the order
given, then in reverse.

    python3 tools/probes/k5_variants.py [NAME ...]
"""
import os
import shutil
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
OUT = os.path.join(ROOT, "build", "probe", "k5")
SRC = open(os.path.join(ROOT, "dsptpu_torch/csrc/levinson.cu")).read()

TIME = r'''
import json, sys
import torch
root, tools = sys.argv[1], sys.argv[2]
sys.path[:0] = [root, tools]
from dsptpu_torch.kernels import _build
_build.SOURCES = ("levinson",)
import dsptpu_torch
assert dsptpu_torch.__file__.startswith(root), dsptpu_torch.__file__
from dsptpu_torch.kernels import levinson as lev
from ab_common import device_ms
gen = torch.Generator(device="cuda").manual_seed(0)
res = {"root": root}
for p, C in [(16, 2500), (32, 2500), (64, 2500), (16, 160000)]:
    x = torch.randn(400, C, device="cuda", generator=gen)
    R = torch.stack([(x[: 400 - l] * x[l:]).sum(0) / 400
                     for l in range(p + 1)])
    if sys.argv[3] == "check":
        for g, w in zip(lev.levinson(R, p), lev.levinson_reference(R, p)):
            e = ((g - w).abs().max() / w.abs().max()).item()
            if not e <= 1e-4:
                raise SystemExit(f"k5 probe: p {p} C {C}: error {e}")
    res[f"p{p}_C{C}_device_ms"] = device_ms(lambda: lev.levinson(R, p),
                                            "levinson", calls=10)
print(json.dumps(res), flush=True)
'''


def sub(s, old, new):
    assert old in s, old[:60]
    return s.replace(old, new)


def threads(n):
    return lambda s: sub(s, "constexpr int kThreads = 128;",
                         f"constexpr int kThreads = {n};")


def accs(n):
    return lambda s: sub(s, "constexpr int kAcc = 4;",
                         f"constexpr int kAcc = {n};")


def nodiv(s):
    return sub(s, "const float k = -order_dot<P, M>(r, a) / err;",
               "const float k = -order_dot<P, M>(r, a) * err;")


def lb0(s):
    return sub(s, "__global__ void __launch_bounds__(kThreads, 1)",
               "__global__ void __launch_bounds__(kThreads)")


def inc(s):
    s = sub(s, "float* refl, long long C, int p) {",
            "float*& refl, long long C, int p) {")
    return sub(s, "        refl[(M - 1) * C] = k;\n",
               "        refl += C;\n        *refl = k;\n")


def seq(s):
    s = sub(s, "        if (M > p) return;\n", "        if (M <= p) {\n")
    return sub(s, "        orders<P, M + 1>(r, a, err, refl, C, p);\n    }\n}",
               "        }\n        orders<P, M + 1>(r, a, err, refl, C, p);"
               "\n    }\n}")


# name: (levinson.cu edit, held to the plain version)
VARIANTS = {
    "base": (None, True),
    "T32": (threads(32), True),
    "T64": (threads(64), True),
    "T256": (threads(256), True),
    "A1": (accs(1), True),
    "A2": (accs(2), True),
    "A8": (accs(8), True),
    "LB0": (lb0, True),
    "inc": (inc, True),
    "seq": (seq, True),
    "incseq": (lambda s: seq(inc(s)), True),
    "nodiv": (nodiv, False),
}


def main():
    names = sys.argv[1:] or list(VARIANTS)
    procs = {}
    for name in names:
        fs, _ = VARIANTS[name]
        tree = os.path.join(OUT, name)
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "dsptpu_torch"),
                        os.path.join(tree, "dsptpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        cu = os.path.join(tree, "dsptpu_torch", "csrc", "levinson.cu")
        open(cu, "w").write(fs(SRC) if fs else SRC)
        procs[name] = subprocess.Popen(
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, sys.argv[1]);"
             "from dsptpu_torch.kernels import _build;"
             "_build.SOURCES = ('levinson',);"
             "p = _build.build_all()['levinson'];"
             "import os; print(open(os.path.join(os.path.dirname(p),"
             " 'levinson.log')).read())", tree],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log, _ = p.communicate()
        entry = ""
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            if "registers" in line or "stack frame" in line:
                print(f"{name}: {entry}: {line.strip()}", flush=True)
        if p.returncode:
            raise SystemExit(f"variant {name}: build failed\n{log}")
    for name in names + names[::-1]:
        print(f"== variant {name}", flush=True)
        subprocess.run([sys.executable, "-c", TIME, os.path.join(OUT, name),
                        os.path.join(ROOT, "tools"),
                        "check" if VARIANTS[name][1] else "time"],
                       check=True)


if __name__ == "__main__":
    main()
