"""K7 probe: variants of dsptpu_torch/csrc/arbd.cu, made by text
substitution into copies of this checkout's dsptpu_torch under
build/probe/k7/<variant>/. Each variant gets a C entry appended that
reports the kernel's resident blocks an SM at the wrapper's shared
memory. The variants' arbd.cu are built in parallel (`-Xptxas -v`:
registers and stack frames printed), then each is called through its
wrapper at path C's shapes (x[:2,500,000] of resample_entry()'s stream
at 0.9997, the stream's anchor): held to the plain version on the host
plan (3e-5 of max |ref|) and to a second call bit for bit, then timed:
device ms of the K7 kernel per call (torch.profiler over 10 calls) and
CUDA-event ms (median of 10 runs of 10 calls). R7, R11: runs of 7 or 11
outputs; S3: three tile buffers (two tiles in flight); B3:
__launch_bounds__ asks for three blocks an SM; "pertile" launches one
block a tile, not a persistent wave. Knock-out variants (each without
one part of the work: the blocks' split passes, the window path's dots,
the staging, the double-precision plan, the stores) are timed without
the check.
Variants run in the order given, then in reverse.

    python3 tools/probes/k7_variants.py [NAME ...]
"""
import os
import shutil
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
OUT = os.path.join(ROOT, "build", "probe", "k7")
SRC = open(os.path.join(ROOT, "dsptpu_torch/csrc/arbd.cu")).read()
PY = open(os.path.join(ROOT, "dsptpu_torch/kernels/arbd.py")).read()

OCCUPANCY = r'''
extern "C" int dsptpu_arbd_occupancy(int W, int nphi, int* out) {
    int Wp, cap, cap_alloc;
    size_t smem;
    geometry(W, nphi, Wp, cap, cap_alloc, smem);
    cudaError_t e = cudaFuncSetAttribute(
        arbd_kernel<kRun>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (!e) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, arbd_kernel<kRun>, kThreads, smem);
    out[1] = (int)smem;
    return (int)e;
}
'''

TIME = r'''
import ctypes, json, sys
import numpy as np
import torch
root, tools = sys.argv[1], sys.argv[2]
sys.path[:0] = [root, tools]
from dsptpu_torch.kernels import _build
_build.SOURCES = ("arbd",)
import dsptpu_torch
assert dsptpu_torch.__file__.startswith(root), dsptpu_torch.__file__
from dsptpu_torch.kernels import arbd
from ab_common import device_ms_by_kernel, time_ms
_, (x,) = dsptpu_torch.resample_entry(device="cuda")
xa = x[:2_500_000]
r = 0.9997
f = dsptpu_torch.FIRFilter(np.asarray(dsptpu_torch.resample_filter(r),
                                      np.float32), r)
k, hl = f.kernel, f.history_len
head, alpha, out_len = k.plan(xa.shape[0])
def t(a, dt):
    return torch.as_tensor(np.ascontiguousarray(a, dt), device="cuda")
pfb, dpfb = t(k.pfb_t.T, np.float32), t(k.dpfb_t.T, np.float32)
hist = torch.zeros(hl, device="cuda")
args = (hist, xa, k.anchor(hl), pfb, dpfb, out_len)
res = {"root": root, "run": arbd.RUN}
occ = (ctypes.c_int * 2)()
lib = _build.load("arbd")
lib.dsptpu_arbd_occupancy.argtypes = [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
if lib.dsptpu_arbd_occupancy(pfb.shape[0], k.nphi, ctypes.addressof(occ)):
    raise SystemExit("k7 probe: occupancy query failed")
res["blocks_per_sm"], res["smem_bytes"] = occ[0], occ[1]
if sys.argv[3] == "check":
    counts = torch.zeros(2, dtype=torch.int32, device="cuda")
    got = arbd.arbd(*args, counts=counts)
    want = arbd.arbd_reference(hist, xa, t(hl + head[0] - 1, np.int64),
                               t(head[1], np.int64), t(alpha, np.float32),
                               pfb, dpfb, out_len)
    torch.cuda.synchronize()
    rel = ((got.double() - want.double()).abs().max()
           / want.double().abs().max()).item()
    if not rel <= 3e-5:
        raise SystemExit(f"k7 probe: off by {rel:.3e}")
    if not torch.equal(got, arbd.arbd(*args)):
        raise SystemExit("k7 probe: not bit for bit")
    res["rel_err"], res["counts"] = rel, counts.tolist()
    del got, want
ms = device_ms_by_kernel(lambda: arbd.arbd(*args), "arbd_kernel", calls=10)
res["device_ms"] = ms
res["event_ms"] = time_ms(lambda: arbd.arbd(*args), reps=10, warmup=3,
                          inner=10)
print(json.dumps(res), flush=True)
'''


def sub(s, old, new):
    assert old in s, old[:60]
    return s.replace(old, new)


def run_len(r):
    return (lambda s: sub(s, "constexpr int kRun = 9;",
                          f"constexpr int kRun = {r};"),
            lambda p: sub(p, "RUN = 9 ", f"RUN = {r} "))


def min_blocks(b):
    return lambda s: sub(s, "__global__ void __launch_bounds__(kThreads)\n"
                         "arbd_kernel(",
                         f"__global__ void __launch_bounds__(kThreads, {b})\n"
                         "arbd_kernel(")


def both(*fs):
    def g(s):
        for f in fs:
            s = f(s)
        return s
    return g


def stages(k):
    return lambda s: sub(s, "constexpr int kStages = 2;",
                         f"constexpr int kStages = {k};")


# knock-outs: each removes one part of the work (its results are wrong,
# so they are timed without the check)
def no_split(s):
    return sub(s, "    for (int i = threadIdx.x; i < total; i += kThreads) {",
               "    for (int i = threadIdx.x; i < total && a.n < 0; "
               "i += kThreads) {")


def no_dot(s):
    return sub(sub(s, "        slots<R>(buf +", "        if (a.n < 0) slots<R>(buf +"),
               "        float lo[R], hi[R];",
               "        float lo[R] = {}, hi[R] = {};")


def no_stage(s):
    return sub(s, "    const int nw = T.span ? T.sh + T.span : 0;",
               "    const int nw = 0;")


def no_plan(s):
    return sub(s, "    const double acc = __dadd_rn(a.acc_base, __dmul_rn(jd, a.delta));",
               "    if (a.nphi > 0) { q = jd; rem = 0.5; return; }\n"
               "    const double acc = __dadd_rn(a.acc_base, __dmul_rn(jd, a.delta));")


def per_tile(s):
    return sub(s, "    if (blocks > a.tiles) blocks = a.tiles;",
               "    blocks = a.tiles;")


def no_store(s):
    return sub(s, "if (wf + i < a.out_len) a.y[wf + i]",
               "if (wf + i < a.out_len && a.n < 0) a.y[wf + i]")


# name: (arbd.cu edit, kernels/arbd.py edit, held to the plain version)
VARIANTS = {
    "R9": (None, None, True),
    "S3": (stages(3), None, True),
    "R9B3": (min_blocks(3), None, True),
    "S3B3": (both(stages(3), min_blocks(3)), None, True),
    "R7": (*run_len(7), True),
    "R11": (*run_len(11), True),
    "R7B3": (both(run_len(7)[0], min_blocks(3)), run_len(7)[1], True),
    "pertile": (per_tile, None, True),
    "nosplit": (no_split, None, False),
    "nodot": (no_dot, None, False),
    "nostage": (no_stage, None, False),
    "noplan": (no_plan, None, False),
    "nostore": (no_store, None, False),
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
        cu = os.path.join(tree, "dsptpu_torch", "csrc", "arbd.cu")
        src = fs(SRC) if fs else SRC
        open(cu, "w").write(sub(src, '\nextern "C" {',
                                OCCUPANCY + '\nextern "C" {'))
        if fp:
            open(os.path.join(tree, "dsptpu_torch", "kernels", "arbd.py"),
                 "w").write(fp(PY))
        procs[name] = subprocess.Popen(
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, sys.argv[1]);"
             "from dsptpu_torch.kernels import _build;"
             "_build.SOURCES = ('arbd',); p = _build.build_all()['arbd'];"
             "import os; print(open(os.path.join(os.path.dirname(p),"
             " 'arbd.log')).read())", tree],
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
