"""K8c probe: variants of dsptpu_torch/csrc/transpose.cu's spectro_permute
kernel, made by text substitution into copies of this checkout's
dsptpu_torch under build/probe/k8/<variant>/. The variants' transpose.cu
are built in parallel (`-Xptxas -v`: registers and stack frames
printed), then each is called through its wrapper at the K8 phase's
shape (tile (64, 8, 8, 256, 128), l2 65): held bit for bit to the plain
version, then timed: device ms of the kernels named "permute" per call
(torch.profiler over 10 calls, each after a 128 MB write that flushes
the L2) and CUDA-event ms (median of 10 runs of 10 calls). F<n>: n
staged floats a block (the tile's frames follow); L8: 8 16-byte loads
in flight a thread; stcs: streaming stores (__stcs); ldg, ldcs: loads
by __ldg or __ldcs; B6: launch bounds that ask for 6 blocks an SM.
Knock-outs (timed without the check): "loadonly" stores nothing,
"storeonly" loads nothing. Variants run in the order given, then in
reverse.

    python3 tools/probes/k8_variants.py [NAME ...]
"""
import os
import shutil
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
OUT = os.path.join(ROOT, "build", "probe", "k8")
SRC = open(os.path.join(ROOT, "dsptpu_torch/csrc/transpose.cu")).read()

TIME = r'''
import json, sys
import torch
root, tools = sys.argv[1], sys.argv[2]
sys.path[:0] = [root, tools]
from dsptpu_torch.kernels import _build
_build.SOURCES = ("transpose",)
import dsptpu_torch
assert dsptpu_torch.__file__.startswith(root), dsptpu_torch.__file__
from dsptpu_torch.kernels import transpose as tp
from ab_common import device_ms_by_kernel, time_ms
gen = torch.Generator(device="cuda").manual_seed(0)
tile = torch.randn(64, 8, 8, 256, 128, device="cuda", generator=gen)
flush = torch.empty(32 << 20, device="cuda")
res = {"root": root}
if sys.argv[3] == "check":
    res["exact"] = torch.equal(tp.spectro_permute(tile, 65),
                               tp.spectro_permute_reference(tile, 65))
    if not res["exact"]:
        raise SystemExit("k8 probe: differs from the plain version")
def call():
    flush.zero_()
    tp.spectro_permute(tile, 65)
res["device_ms"] = device_ms_by_kernel(call, "permute", calls=10)
res["event_ms"] = time_ms(lambda: tp.spectro_permute(tile, 65), reps=10,
                          warmup=3, inner=10)
print(json.dumps(res), flush=True)
'''


def sub(s, old, new):
    assert old in s, old[:60]
    return s.replace(old, new)


def floats(n):
    return lambda s: sub(s, "constexpr int kPermFloats = 12288;",
                         f"constexpr int kPermFloats = {n};")


def threads(n):
    return lambda s: sub(s, "constexpr int kPermThreads = 256;",
                         f"constexpr int kPermThreads = {n};")


def loads(n):
    return lambda s: sub(s, "constexpr int kPermLoads = 4;",
                         f"constexpr int kPermLoads = {n};")


def load_only(s):
    return sub(s, "        const int items = l2 * S4;",
               "        const int items = l2 * S4 * (C < 0);")


def store_only(s):
    return sub(s, "        const int items = (S + 3) / 4 * nkl * 32;",
               "        const int items = (S + 3) / 4 * nkl * 32 * (C < 0);")


def stcs(s):
    return sub(s, """            *reinterpret_cast<float4*>(dst + k * kstride + t * C + 4 * c4) =
                *reinterpret_cast<const float4*>(s + k * P +
                                                 ((4 * w) ^ swz(k)));""",
               """            __stcs(reinterpret_cast<float4*>(dst + k * kstride + t * C
                                             + 4 * c4),
                   *reinterpret_cast<const float4*>(s + k * P +
                                                    ((4 * w) ^ swz(k))));""")


def load_with(fn):
    return lambda s: sub(s, """                    q[r] = *reinterpret_cast<const float4*>(
                        src + c * plane + t * 128 + 4 * k4);""",
                         f"""                    q[r] = {fn}(reinterpret_cast<const float4*>(
                        src + c * plane + t * 128 + 4 * k4));""")


def min_blocks(n):
    return lambda s: sub(s, "__global__ void __launch_bounds__(kPermThreads)\n"
                         "permute_kernel(",
                         f"__global__ void __launch_bounds__(kPermThreads, {n})\n"
                         "permute_kernel(")


# name: (transpose.cu edit, held to the plain version)
VARIANTS = {
    "base": (None, True),
    "F8192": (floats(8192), True),
    "F16384": (floats(16384), True),
    "L8": (loads(8), True),
    "stcs": (stcs, True),
    "ldg": (load_with("__ldg"), True),
    "ldcs": (load_with("__ldcs"), True),
    "B6": (min_blocks(6), True),
    "loadonly": (load_only, False),
    "storeonly": (store_only, False),
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
        cu = os.path.join(tree, "dsptpu_torch", "csrc", "transpose.cu")
        open(cu, "w").write(fs(SRC) if fs else SRC)
        procs[name] = subprocess.Popen(
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, sys.argv[1]);"
             "from dsptpu_torch.kernels import _build;"
             "_build.SOURCES = ('transpose',);"
             "p = _build.build_all()['transpose'];"
             "import os; print(open(os.path.join(os.path.dirname(p),"
             " 'transpose.log')).read())", tree],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log, _ = p.communicate()
        entry = ""
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1][40:90] if "'" in line else line
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
