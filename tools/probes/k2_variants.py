"""K2 probe: variants of dsptpu_torch/csrc/biir.cu (and of the chunk
length `_CHUNK` in kernels/biir.py), made by text substitution into
copies of this checkout's dsptpu_torch under build/probe/k2/<variant>/.
Each variant gets a C entry appended that reports its three SOS-route
kernels' resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor
at the shared memory the wrapper's call asks for). The variants' biir.cu
are built in parallel (`-Xptxas -v`: registers and stack frames
printed), then each is held to the plain version and timed at the main
path's shapes (1,000,000 x 64 float32, the 8th-order Butterworth cascade
as sosfilt builds it, forward and reverse with n_eff): device ms per
`__global__` kernel (torch.profiler over 5 calls) and CUDA-event ms
(median of 10). Knock-out variants (each without one part of the work:
the cascade, the scan, the stores of y, the staging of x, the fold, the
reduce) are timed without the check. Variants run in the order given,
then in reverse.

    python3 tools/probes/k2_variants.py [NAME ...]
"""
import os
import shutil
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
OUT = os.path.join(ROOT, "build", "probe", "k2")
SRC = open(os.path.join(ROOT, "dsptpu_torch/csrc/biir.cu")).read()
PY = open(os.path.join(ROOT, "dsptpu_torch/kernels/biir.py")).read()

OCCUPANCY = r'''
extern "C" int dsptpu_biir_occupancy(int C, int L, int* out) {
    constexpr int P = 8;
    int cw = 1;
    while (cw < C && cw < 32) cw *= 2;
    const Tiles T(L, cw);
    const size_t sm1 = sizeof(float) *
        ((size_t)V * P + P * P + kStages * T.xs + kThreads * P + 2 * P * cw);
    const int CS = (5 * (P / 2) + 4) & ~3;
    const size_t sm3 = sizeof(float) *
        (CS + P * P + kStages * T.xs + (2 * (size_t)T.RG + 1) * P * cw);
    cudaError_t e = smem_limit(chunk_reduce_kernel<P>, sm1);
    if (!e) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, chunk_reduce_kernel<P>, kThreads, sm1);
    if (!e) e = smem_limit(chunk_scan_sos_output_kernel<P>, sm3);
    if (!e) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 1, chunk_scan_sos_output_kernel<P>, T.RG * cw, sm3);
    out[2] = (int)sm1;
    out[3] = (int)sm3;
    return (int)e;
}
'''

TIME = r'''
import json, sys
import numpy as np
import torch
root, tools = sys.argv[1], sys.argv[2]
sys.path[:0] = [root, tools]
from dsptpu_torch.kernels import _build
_build.SOURCES = ("biir",)
import ctypes
import re
import dsptpu_torch
assert dsptpu_torch.__file__.startswith(root), dsptpu_torch.__file__
from dsptpu_torch.kernels import biir
from dsptpu_torch.filters.filt import _cascade_ss
from dsptpu_torch.pipeline import chain_params
from ab_common import device_ms_by_kernel, time_ms
_, (x,) = dsptpu_torch.entry(device="cuda")
n, C = x.shape
ss = _cascade_ss(chain_params()[1].astype(np.float64), 1.0)
z0 = torch.zeros((ss.p, C), device="cuda")
m = (n // 128) * 128
res = {"root": root, "chunk": biir._CHUNK}
occ = (ctypes.c_int * 4)()
lib = _build.load("biir")
lib.dsptpu_biir_occupancy.argtypes = [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
if lib.dsptpu_biir_occupancy(C, biir._CHUNK, ctypes.addressof(occ)):
    raise SystemExit("k2 probe: occupancy query failed")
res["blocks_per_sm"] = {"chunk_reduce": occ[0],
                        "chunk_scan_sos_output": occ[1]}
res["smem_bytes"] = {"chunk_reduce": occ[2], "chunk_scan_sos_output": occ[3]}
for key, kw in (("forward", {}), ("reverse", dict(reverse=True, n_eff=m))):
    if sys.argv[3] == "check":
        got = biir.blockss_filt(ss, x, z0, **kw)
        want = biir.blockss_reference(ss, x, z0, **kw)
        torch.cuda.synchronize()
        rel = ((got.double() - want.double()).abs().max()
               / want.double().abs().max()).item()
        if not rel <= 1e-4:
            raise SystemExit(f"k2 probe: {key} off by {rel:.3e}")
        again = biir.blockss_filt(ss, x, z0, **kw)
        if not torch.equal(got, again):
            raise SystemExit(f"k2 probe: {key} not bit for bit")
        del got, want, again
    ms = {k: v for k, v in device_ms_by_kernel(
        lambda: biir.blockss_filt(ss, x, z0, **kw), calls=5).items()
        if re.fullmatch(r"\w+_kernel<\d+(?:, \w+)?>", k)}
    ms["total"] = sum(ms.values())
    res[key] = ms
    res[key + "_event_ms"] = time_ms(
        lambda: biir.blockss_filt(ss, x, z0, **kw), reps=10, warmup=2)
print(json.dumps(res), flush=True)
'''


def sub(s, old, new):
    assert old in s, old[:60]
    return s.replace(old, new)


def stages(k):
    return lambda s: sub(s, "constexpr int kStages = 3;",
                         f"constexpr int kStages = {k};")


def chunk(L):
    return lambda p: sub(p, "_CHUNK = 64 ", f"_CHUNK = {L} ")


# knock-outs: each removes one part of the work (its results are wrong,
# so they are timed without the check)
def no_cascade(s):
    return sub(s, "for (int q = 0; q < NS; ++q) {\n                        if",
               "for (int q = 0; q < 0; ++q) {\n                        if")


def no_scan(s):
    return sub(s, "for (int rr = 0; rr < RG && b0 + rr < B; ++rr) {\n"
               "                for (int i = tid;",
               "for (int rr = 0; rr < 0; ++rr) {\n"
               "                for (int i = tid;")


def no_fold(s):
    return sub(s, "for (int rr = 0; rr < RG && b0 + rr < B; ++rr) {\n"
               "                const float* z",
               "for (int rr = 0; rr < 0; ++rr) {\n"
               "                const float* z")


def no_stage(s):
    return sub(s, "    if (ti < NT) {\n        xs +=",
               "    if (false) {\n        xs +=")


def no_store(s):
    return sub(s, "if (u0 + i < len) *yp = wu[i];",
               "if (u0 + i < len && n < 0) *yp = wu[i];")


def no_reduce(s):
    return sub(s, "for (int u = 0; u < 16; ++u) {\n            const float xv",
               "for (int u = 0; u < 0; ++u) {\n            const float xv")


# name: (biir.cu edit, kernels/biir.py edit, held to the plain version)
VARIANTS = {
    "S3": (None, None, True),
    "S2": (stages(2), None, True),
    "S4": (stages(4), None, True),
    "S3L32": (None, chunk(32), True),
    "nocascade": (no_cascade, None, False),
    "noscan": (no_scan, None, False),
    "nostore": (no_store, None, False),
    "nostage": (no_stage, None, False),
    "nofold": (no_fold, None, False),
    "noreduce": (no_reduce, None, False),
}


def main():
    sys.path.insert(0, ROOT)
    from dsptpu_torch.kernels import _build
    names = sys.argv[1:] or list(VARIANTS)
    procs = {}
    for name in names:
        fs, fp, _ = VARIANTS[name]
        tree = os.path.join(OUT, name)
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "dsptpu_torch"),
                        os.path.join(tree, "dsptpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        cu = os.path.join(tree, "dsptpu_torch", "csrc", "biir.cu")
        src = (fs(SRC) if fs else SRC)
        open(cu, "w").write(sub(src, '\nextern "C" {',
                                OCCUPANCY + '\nextern "C" {'))
        if fp:
            open(os.path.join(tree, "dsptpu_torch", "kernels", "biir.py"),
                 "w").write(fp(PY))
        procs[name] = subprocess.Popen(
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, sys.argv[1]);"
             "from dsptpu_torch.kernels import _build;"
             "_build.SOURCES = ('biir',); p = _build.build_all()['biir'];"
             "import os; print(open(os.path.join(os.path.dirname(p),"
             " 'biir.log')).read())", tree],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log, _ = p.communicate()
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1][40:90] if "'" in line else line
            if "registers" in line or "stack frame" in line:
                print(f"{name}: {entry}: {line.strip()}", flush=True)
        if p.returncode:
            raise SystemExit(f"variant {name}: build failed\n{log}")
    del _build
    for name in names + names[::-1]:
        print(f"== variant {name}", flush=True)
        subprocess.run([sys.executable, "-c", TIME, os.path.join(OUT, name),
                        os.path.join(ROOT, "tools"),
                        "check" if VARIANTS[name][2] else "time"],
                       check=True)


if __name__ == "__main__":
    main()
