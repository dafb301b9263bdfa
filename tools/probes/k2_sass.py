"""K2 probe: SASS opcode counts of the P = 8 kernels of one or more
versions of csrc/biir.cu, each compiled for sm_90a to a cubin and read
back with cuobjdump -sass: for each `__global__` template <8>, the
instruction count and the 40 most frequent opcodes (e.g. how many shared
loads a kernel's body holds).

    python3 tools/probes/k2_sass.py FILE.cu [FILE.cu ...]

Pass the parent's source as a second file to compare (git show
PARENT:dsptpu_torch/csrc/biir.cu > build/parent_biir.cu).
"""
import collections
import os
import re
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, ROOT)
from dsptpu_torch.kernels import _build  # noqa: E402

OUT = os.path.join(ROOT, "build", "probe", "k2_sass")
OPCODE = re.compile(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)")


def main():
    os.makedirs(OUT, exist_ok=True)
    nvcc = _build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    for src in sys.argv[1:]:
        cubin = os.path.join(OUT, os.path.basename(src) + ".cubin")
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-cubin", "-o", cubin, src],
                       check=True)
        sass = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout
        for block in sass.split("Function : ")[1:]:
            name = block.split("\n")[0].strip()
            if "ILi8E" not in name:
                continue
            ops = collections.Counter(OPCODE.findall(block))
            m = re.search(r"\d\d?([a-z_]+_kernel)ILi8E", name)
            short = (m.group(1) if m else name) + "<8>"
            print(os.path.basename(src), short, sum(ops.values()),
                  dict(ops.most_common(40)), flush=True)


if __name__ == "__main__":
    main()
