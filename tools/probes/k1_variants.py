"""K1 probe: variants of dsptpu_torch/csrc/fir.cu, made by text
substitution and built side by side with nvcc, each held to the plain
version and timed by CUDA events (median of 20 runs of 10 calls) at the
main path's shapes (1,000,000 x 64, the 127 chain_params taps) and at
10,000,000 x 1; prints each build's -Xptxas -v lines, SASS opcode counts
of the CW = 32 and C = 1 templates, and the SM clock and power while the
first variant runs. Variants: A the source as it is, D_nostage without
the staging of the next tile (results wrong: the compute alone), B_lb1
with one block an SM in __launch_bounds__.

    python3 tools/probes/k1_variants.py
"""
import collections, ctypes, json, os, re, statistics, subprocess, sys, time
import numpy as np, torch
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, ROOT)
from dsptpu_torch.kernels import fir as tfir
from dsptpu_torch.pipeline import chain_params
from dsptpu_torch.kernels import _build
NVCC = _build._nvcc()
CUOBJDUMP = os.path.join(os.path.dirname(NVCC), "cuobjdump")
OUT = os.path.join(ROOT, "build", "probe", "out"); os.makedirs(OUT, exist_ok=True)
src = open(os.path.join(ROOT, "dsptpu_torch/csrc/fir.cu")).read()

def sub(s, old, new):
    assert old in s, old[:60]
    return s.replace(old, new)

V = {"A": src,
     "D_nostage": sub(src, "if (it + 1 < tile1) stage_rows(rtile + TT, TT);", ""),
     "B_lb1": sub(src, "__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)"),
}
procs = {}
for name, s in V.items():
    cu = os.path.join(OUT, f"fir_{name}.cu"); open(cu, "w").write(s)
    so = os.path.join(OUT, f"libfir_{name}.so")
    procs[name] = (subprocess.Popen([NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
libs = {}
for name, (p, so) in procs.items():
    log, _ = p.communicate()
    print(f"== {name} rc={p.returncode}")
    for line in log.splitlines():
        if "registers" in line or "stack frame" in line or "error" in line:
            print("  ", line.strip())
    if p.returncode == 0:
        libs[name] = ctypes.CDLL(so)
        sass = subprocess.run([CUOBJDUMP, "-sass", so], capture_output=True, text=True).stdout
        for tmpl in ("ILi2ELi16E", "ILi1ELi1E"):
            m = re.search(r"Function : \S*" + tmpl + r"\S*\n(.*?)(?:\n\s*\.{10,}|Function :|\Z)", sass, re.S)
            if not m:
                print("  no sass for", tmpl); continue
            ops = collections.Counter()
            for l in m.group(1).splitlines():
                mm = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", l)
                if mm: ops[mm.group(1).split(".")[0]] += 1
            tot = sum(ops.values())
            print(f"   sass {tmpl}: {tot} instrs; " + ", ".join(f"{k} {v}" for k, v in ops.most_common(14)))
        if name == "A":
            open(os.path.join(OUT, "sass_A.txt"), "w").write(sass)

def time_ms(fn, reps=20, inner=10):
    for _ in range(3): fn()
    torch.cuda.synchronize(); ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True); b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner): fn()
        b.record(); b.synchronize(); ts.append(a.elapsed_time(b) / inner)
    return statistics.median(ts)

dev = torch.device("cuda")
taps = torch.as_tensor(chain_params()[0], device=dev)
rng = np.random.default_rng(0)
shapes = {"main": (1_000_000, 64), "c1": (10_000_000, 1)}
xs = {k: torch.as_tensor(rng.standard_normal(s).astype(np.float32), device=dev) for k, s in shapes.items()}
refs = {k: tfir.fir_reference(x, taps) for k, x in xs.items()}
sms = torch.cuda.get_device_properties(dev).multi_processor_count
res = {}
for name, lib in libs.items():
    f = lib.dsptpu_fir; f.argtypes = tfir._ARGTYPES; f.restype = ctypes.c_int
    occf = lib.dsptpu_fir_blocks_per_sm; occf.argtypes = tfir._OCC_ARGTYPES; occf.restype = ctypes.c_int
    for k, x in xs.items():
        n, C = x.shape; nb = taps.shape[0]
        p = tfir._plan(n, C, nb)
        per = ctypes.c_int(0); assert occf(p["cw"], p["smem"], ctypes.addressof(per)) == 0
        runs = tfir._runs(p, per.value * sms)
        y = torch.empty_like(x)
        st = torch.cuda.current_stream().cuda_stream
        call = lambda: f(x.data_ptr(), taps.data_ptr(), y.data_ptr(), n, C, nb, p["nbp"], p["cw"], p["nseg"], p["ntiles"], runs, p["smem"], st)
        assert call() == 0
        torch.cuda.synchronize()
        rel = ((y.double() - refs[k].double()).abs().max() / refs[k].double().abs().max()).item()
        ms = time_ms(call)
        res[f"{name}/{k}"] = dict(ms=ms, rel=rel, occ=per.value, runs=runs)
        print(f"{name} {k}: {ms:.4f} ms rel {rel:.2e} occ {per.value} runs {runs}", flush=True)
        if name == "A" and k == "main":
            smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader", "-lms", "200"], stdout=subprocess.PIPE, text=True)
            t0 = time.time()
            while time.time() - t0 < 2.5:
                for _ in range(50): call()
                torch.cuda.synchronize()
            smi.terminate(); out, _ = smi.communicate()
            print("clocks under load:", " | ".join(out.strip().splitlines()[-8:]))
print(json.dumps(res))
