"""Build and load the port's hand-written CUDA kernels.

Each source `dsptpu_torch/csrc/<name>.cu` is compiled by nvcc for
`sm_90a` into its own shared library with a plain C interface (no
PyTorch headers, so a build takes seconds) and loaded with ctypes.
Builds happen at first use, under `<repo>/build/dsptpu_torch/<hash>/`,
where the hash covers every source, header and flag; all sources that
are not built yet are compiled in parallel, one nvcc each.

Every C entry point returns `cudaGetLastError()` right after its
launches; `check()` turns a non-zero code into an exception.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "build_all", "load", "entry", "check", "stream_of"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "dsptpu_torch"
SOURCES = ("fir", "biir", "stft")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs = {}
_lock = threading.Lock()


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "nvcc (set CUDA_HOME or put nvcc on PATH)")


def _digest():
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for f in sorted(_CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_all():
    """Compile every kernel source that is not built yet (all nvcc
    processes started together); return {name: library path}."""
    out = _BUILD / _digest()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        so = out / f"lib{name}.so"
        if so.exists():
            continue
        tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        (out / f"{name}.log").write_text(log)
        if proc.returncode:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: out / f"lib{name}.so" for name in SOURCES}


def load(name):
    """The ctypes library of kernel source `name`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            lib.dsptpu_error_string.restype = ctypes.c_char_p
            lib.dsptpu_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
    return lib


def entry(name, symbol, argtypes):
    """C entry point `symbol` of kernel source `name`, typed: pointers and
    the stream as c_void_p, so that ctypes does not cut them to 32 bits."""
    fn = getattr(load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name, err, what):
    """Raise if a C entry of kernel source `name` returned a CUDA error."""
    if err:
        msg = load(name).dsptpu_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t):
    """PyTorch's current stream on t's device, as a C pointer value."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
