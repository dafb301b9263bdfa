"""K9 probe: variants of dsptpu_torch/csrc/mtcoh.cu, made by text
substitution into copies of this checkout's dsptpu_torch under
build/probe/k9/<variant>/. The variants' mtcoh.cu are built in parallel
(`-Xptxas -v`: registers and stack frames printed), then each is called
through its wrapper at path D's coherence shape (the tapered spectra of
64 channels x 16,384 samples, 7 DPSS tapers, 8,193 bins): held to the
plain version within 1e-5, then timed: device ms of the kernels named
"mtcoh" per call (torch.profiler over 10 calls) and CUDA-event ms
(median of 10 runs of 10 calls). stcs: streaming stores (__stcs); R2:
groups of 2 channels in registers for K <= 8; T256: 8 warps a block.
Knock-outs (timed without the check): "nostore" computes every pair and
stores none of them, "nopairs" stores a constant for every pair (no
pair sums), "noload" loads no spectra, "wave1" runs only the first 132
blocks (one wave of one block an SM), "rowpad" writes rows padded to 32
floats (every run a whole 128-byte line) and "contig" writes each
block's runs one after another (524 KB contiguous a block), both into a
padded output. Variants run in the order given, then in reverse.

    python3 tools/probes/k9_variants.py [NAME ...]
"""
import os
import shutil
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
OUT = os.path.join(ROOT, "build", "probe", "k9")
SRC = open(os.path.join(ROOT, "dsptpu_torch/csrc/mtcoh.cu")).read()

TIME = r'''
import json, sys
import torch
root, tools = sys.argv[1], sys.argv[2]
sys.path[:0] = [root, tools]
from dsptpu_torch.kernels import _build
_build.SOURCES = ("mtcoh",)
import dsptpu_torch
assert dsptpu_torch.__file__.startswith(root), dsptpu_torch.__file__
from dsptpu_torch.kernels import mtcoh
from dsptpu_torch.ops.multitaper import _tapered_fft
from ab_common import device_ms_by_kernel, time_ms
gen = torch.Generator(device="cuda").manual_seed(0)
x = torch.randn(64, 16384, device="cuda", generator=gen)
mtc = dsptpu_torch.MTConfig.create(16384, nfft=16384, nw=4, ntapers=7)
F = _tapered_fft(x, mtc)
w = mtc.const("w2", F.device, torch.float32)
corr = mtc.const("corr", F.device, torch.float32)
res = {"root": root}
if sys.argv[3] == "check":
    d = (mtcoh.mtcoh(F, w, corr)
         - mtcoh.mtcoh_reference(F, w, corr)).abs().max().item()
    res["max_abs_err"] = d
    if not d <= 1e-5:
        raise SystemExit(f"k9 probe: {d} from the plain version")
res["device_ms"] = device_ms_by_kernel(lambda: mtcoh.mtcoh(F, w, corr),
                                       "mtcoh", calls=10)
res["event_ms"] = time_ms(lambda: mtcoh.mtcoh(F, w, corr), reps=10,
                          warmup=3, inner=10)
print(json.dumps(res), flush=True)
'''

STORES = """                out[((long long)l * C + m) * nbl + f] = c;
                out[((long long)m * C + l) * nbl + f] = c;"""


def sub(s, old, new):
    assert old in s, old[:60]
    return s.replace(old, new)


def no_store(s):
    return sub(s, STORES, """                if (c == -1.f) {
""" + STORES + """
                }""")


def no_pairs(s):
    return sub(s, "const float c = sqrtf(fmaf(re[r], re[r], im[r] * im[r]));",
               "const float c = 0.5f;")


def no_load(s):
    return sub(s, "v[k] = F[l * sc + k * sk + f];",
               "v[k] = make_float2(1.f + l, 0.5f + k);")


def stcs(s):
    for x, y in (("l", "m"), ("m", "l")):
        s = sub(s, f"out[((long long){x} * C + {y}) * nbl + f] = c;",
                f"__stcs(out + ((long long){x} * C + {y}) * nbl + f, c);")
    return s


def r2(s):
    return sub(s, "return launch<8, 4>(", "return launch<8, 2>(")


def threads(n):
    return lambda s: sub(s, "constexpr int kThreads = 512;",
                         f"constexpr int kThreads = {n};")


PAD_OUT = ("out = torch.empty((C, C, nb), dtype=torch.float32, "
           "device=F.device)",
           "out = torch.empty((C, C, (nb + 31) // 32 * 32), "
           "dtype=torch.float32, device=F.device)")


def row_pad(s):
    return sub(s, "const long long nbl = nb;",
               "const long long nbl = (nb + 31) / 32 * 32;")


def contig(s):
    for x, y in (("l", "l"), ("l", "m"), ("m", "l")):
        s = sub(s, f"out[((long long){x} * C + {y}) * nbl + f]",
                f"out[(((long long)blockIdx.x * C + {x}) * C + {y}) * kTB"
                " + lane]")
    return s


def wave1(s):
    return sub(s, "    const int lane = threadIdx.x & 31,",
               "    if (blockIdx.x >= 132) return;\n"
               "    const int lane = threadIdx.x & 31,")


# name: (mtcoh.cu edit, held to the plain version[, wrapper edit])
VARIANTS = {
    "base": (None, True),
    "stcs": (stcs, True),
    "R2": (r2, True),
    "T256": (threads(256), True),
    "nostore": (no_store, False),
    "nopairs": (no_pairs, False),
    "noload": (no_load, False),
    "wave1": (wave1, False),
    "rowpad": (row_pad, False, PAD_OUT),
    "contig": (contig, False, PAD_OUT),
}


def main():
    names = sys.argv[1:] or list(VARIANTS)
    procs = {}
    for name in names:
        fs, _, *py = VARIANTS[name]
        tree = os.path.join(OUT, name)
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "dsptpu_torch"),
                        os.path.join(tree, "dsptpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        cu = os.path.join(tree, "dsptpu_torch", "csrc", "mtcoh.cu")
        open(cu, "w").write(fs(SRC) if fs else SRC)
        wrapper = os.path.join(tree, "dsptpu_torch", "kernels", "mtcoh.py")
        for old, new in py:
            text = sub(open(wrapper).read(), old, new)
            open(wrapper, "w").write(text)
        procs[name] = subprocess.Popen(
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, sys.argv[1]);"
             "from dsptpu_torch.kernels import _build;"
             "_build.SOURCES = ('mtcoh',);"
             "p = _build.build_all()['mtcoh'];"
             "import os; print(open(os.path.join(os.path.dirname(p),"
             " 'mtcoh.log')).read())", tree],
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
