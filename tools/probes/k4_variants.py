"""K4 probe: variants of dsptpu_torch/csrc/osconv.cu's cluster instance
(osconv_kernel_cluster<M>), made by text substitution into copies of this
checkout's dsptpu_torch under build/probe/k4/<variant>/. The variants'
osconv.cu are built in parallel (their `-Xptxas -v` lines of the cluster
instances printed), then each is called at path A's shape (10,000,000 x
16 float32, 4096 taps) at nfft 16384 and 8192: the cluster route held
bit for bit to the per-pair instance on the same input (the C entry
called with cluster = 0), then both timed by CUDA events (median of 10).
The per-pair instance is also timed at 80,000,000 x 2 and the cluster
instance at 20,000,000 x 8 (the same bytes; a warp's 16-byte accesses
then cover 4 cache lines, against 8 at C = 16). Variants: "phases"
times the cluster instance's phases (SM cycles of each CTA's thread 0 a
job, averaged over the CTAs' jobs: PHASES); "release" makes the arrival
after the gather a release (it then waits for the gather's stores).
Knock-outs (timed without the check): "noconv" skips the transform,
"noload" stages zeros instead of reading x, "nostore" gathers the
outputs but stores none, "pairnostore" stores nothing from the per-pair
instance. Variants run in the order given, then in reverse.

    python3 tools/probes/k4_variants.py [NAME ...]
"""
import os
import shutil
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
OUT = os.path.join(ROOT, "build", "probe", "k4")
SRC = open(os.path.join(ROOT, "dsptpu_torch/csrc/osconv.cu")).read()

TIME = r'''
import json, statistics, sys
import torch
root, check = sys.argv[1], sys.argv[2] == "check"
sys.path.insert(0, root)
from dsptpu_torch.kernels import _build
_build.SOURCES = ("osconv",)
import dsptpu_torch
assert dsptpu_torch.__file__.startswith(root), dsptpu_torch.__file__
from dsptpu_torch.kernels import osconv
from dsptpu_torch.pipeline import fftfilt_taps
dev = torch.device("cuda")
f = _build.entry("osconv", "dsptpu_osconv", osconv._ARGTYPES)
def launch(x, v, nfft, nout, cluster):
    n, C = x.shape
    Hp = osconv._spectrum(v, nfft)
    wn, tw2 = osconv._tables(nfft, dev)
    y = torch.empty((nout, C), dtype=torch.float32, device=dev)
    err = f(x.data_ptr(), Hp.data_ptr(), wn.data_ptr(), tw2.data_ptr(),
            y.data_ptr(), n, C, nfft, nfft, osconv._advance(nfft, len(v)),
            nout, int(cluster), _build.stream_of(x))
    _build.check("osconv", err, "launch")
    return y
def ms(fn):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(10):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); b.synchronize()
        ts.append(a.elapsed_time(b))
    return round(statistics.median(ts), 4)
gen = torch.Generator(device="cuda").manual_seed(0)
x = torch.randn(10_000_000, 16, device=dev, generator=gen)
h = torch.as_tensor(fftfilt_taps(), device=dev)
res = {}
for nfft in (16384, 8192):
    if check:
        res[f"exact_{nfft}"] = torch.equal(launch(x, h, nfft, len(x), True),
                                           launch(x, h, nfft, len(x), False))
    res[f"cluster_{nfft}"] = ms(lambda: launch(x, h, nfft, len(x), True))
    res[f"pair_{nfft}"] = ms(lambda: launch(x, h, nfft, len(x), False))
if hasattr(_build.load("osconv"), "dsptpu_osconv_phases"):
    import ctypes
    PHASES = PHASES_OF_THE_PROBE
    get = _build.load("osconv").dsptpu_osconv_phases
    get.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 8)()
    for nfft in (16384, 8192):
        get(buf)
        launch(x, h, nfft, len(x), True)
        torch.cuda.synchronize()
        get(buf)
        jobs = buf[7]
        res[f"phases_{nfft}"] = {name: round(buf[k] / jobs, 1)
                                 for k, name in enumerate(PHASES)}
x2 = x.view(-1)[:160_000_000].view(80_000_000, 2)
res["pair_80Mx2"] = ms(lambda: launch(x2, h, 16384, len(x2), False))
x8 = x.view(-1)[:160_000_000].view(20_000_000, 8)
res["cluster_20Mx8"] = ms(lambda: launch(x8, h, 16384, len(x8), True))
print(json.dumps(res), flush=True)
'''


def sub(s, old, new):
    assert old in s, old[:60]
    return s.replace(old, new)


def no_conv(s):
    return sub(s, "        convolve<M>(a, ex, threadIdx.x, 0, tw2, Hp);\n", "")


def no_load(s):
    return sub(s, """                v[u] = g >= 0 && g < n
                    ? __ldg(reinterpret_cast<const float4*>(
                          px + (long long)pl * C))
                    : make_float4(0.f, 0.f, 0.f, 0.f);""",
               "                v[u] = make_float4(g, 0.f, 0.f, 0.f);")


def release(s):
    return sub(s, "        cluster_arrive_relaxed();   // waited on before the next staging",
               "        cluster_arrive();")


PHASES = ("loads", "wait: last outputs read", "scatter",
          "wait: frame staged", "transform", "outputs, wait: written",
          "gather")


def phases(s):
    """SM cycles of thread 0 of every CTA between the phase boundaries,
    summed into g_phase[0..6] (g_phase[7]: jobs), read by
    dsptpu_osconv_phases."""
    def ph(k):
        return (f"if (threadIdx.x == 0) {{ const long long c_ = clock64(); "
                f"ph_[{k}] += c_ - ph_[7]; ph_[7] = c_; }}")
    s = sub(s, "namespace {\n", "namespace {\n__device__ unsigned long long "
            "g_phase[8];\n")
    s = sub(s, """    cluster_arrive();   // no outputs of a previous job to wait for
    float2 a[R];""", """    __shared__ long long ph_[8];
    if (threadIdx.x == 0) {
        for (int k = 0; k < 7; ++k) ph_[k] = 0;
        ph_[7] = clock64();
    }
    cluster_arrive();   // no outputs of a previous job to wait for
    float2 a[R];""")
    s = sub(s, "            cluster_wait();   // the cluster has read this CTA's last outputs\n",
            f"            {ph(0)}\n            cluster_wait();\n            {ph(1)}\n")
    s = sub(s, """        cluster_arrive();
        cluster_wait();       // every pair of the frame is with its owner""",
            f"""        {ph(2)}
        cluster_arrive();
        cluster_wait();
        {ph(3)}""")
    s = sub(s, "        convolve<M>(a, ex, threadIdx.x, 0, tw2, Hp);\n",
            f"        convolve<M>(a, ex, threadIdx.x, 0, tw2, Hp);\n        {ph(4)}\n")
    s = sub(s, """        cluster_arrive();
        cluster_wait();
        // rank k stores output rows""", f"""        cluster_arrive();
        cluster_wait();
        {ph(5)}
        // rank k stores output rows""")
    s = sub(s, "        cluster_arrive_relaxed();   // waited on before the next staging\n",
            f"        {ph(6)}\n        if (threadIdx.x == 0) atomicAdd(&g_phase[7], 1ull);\n"
            "        cluster_arrive_relaxed();\n")
    s = sub(s, "    cluster_wait();           // no CTA leaves while others read its memory\n}",
            "    cluster_wait();\n    if (threadIdx.x == 0)\n"
            "        for (int k = 0; k < 7; ++k)\n"
            "            atomicAdd(&g_phase[k], (unsigned long long)ph_[k]);\n}")
    return s + """
extern "C" int dsptpu_osconv_phases(unsigned long long* out) {
    cudaError_t e = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
    unsigned long long z[8] = {0};
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase, z, sizeof(z));
    return e;
}
"""


def pair_no_store(s):
    return sub(s, """                    store_at(py + i * step, two, vec2, a[i]);""",
               """                    if (a[i].x == 1234.5f) py[0] = 0.f;""")


def no_store(s):
    return sub(s, """                    *reinterpret_cast<float4*>(py + (long long)row * C) =
                        make_float4(u.x, u.y, w.x, w.y);""",
               "                    if (u.x == 1234.5f && w.y == 1.f) py[0] = 0.f;")


VARIANTS = {"base": (lambda s: s, True), "noconv": (no_conv, False),
            "noload": (no_load, False), "nostore": (no_store, False),
            "phases": (phases, True), "release": (release, True),
            "pairnostore": (pair_no_store, False)}


def build(name):
    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "dsptpu_torch"),
                    os.path.join(d, "dsptpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    open(os.path.join(d, "dsptpu_torch/csrc/osconv.cu"), "w").write(
        VARIANTS[name][0](SRC))
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from dsptpu_torch.kernels import _build;"
            "_build.SOURCES = ('osconv',); print(_build.build_all()['osconv'])")
    return subprocess.Popen([sys.executable, "-c", code, d],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def main():
    names = sys.argv[1:] or list(VARIANTS)
    procs = {n: build(n) for n in names}
    for n, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{n}: build failed\n{out[-6000:]}")
        log = os.path.join(os.path.dirname(out.strip().splitlines()[-1]),
                           "osconv.log")
        lines = open(log).read().splitlines()
        for i, line in enumerate(lines):
            if "osconv_kernel_cluster" in line:
                print(n, "ptxas:", " | ".join(x.strip() for x in
                                              lines[i + 1:i + 3]), flush=True)
    for n in names + names[::-1]:
        d = os.path.join(OUT, n)
        r = subprocess.run([sys.executable, "-c", TIME.replace(
                                "PHASES_OF_THE_PROBE", repr(PHASES)), d,
                            "check" if VARIANTS[n][1] else "time"],
                           capture_output=True, text=True, timeout=300)
        print(n, r.stdout.strip() or r.stderr[-3000:], flush=True)


if __name__ == "__main__":
    main()
