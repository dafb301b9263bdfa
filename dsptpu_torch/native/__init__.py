"""Native (C++) runtime components, bound with ctypes (dsptpu's native/).

`StreamReader`: a prefetching chunk reader (ringbuffer.cpp, the port's
own copy of dsptpu's source): a reader thread keeps `nslots` chunks ahead
of the consumer, so disk reads overlap device work. Each chunk goes
through a pinned host buffer and a non_blocking copy to the card.

The source is compiled with the system C++ compiler at first use, under
`<repo>/build/dsptpu_torch/native/<hash>/` (the hash covers the source,
the compiler and its flags); nothing is written next to the source.

Divergence from dsptpu: dsptpu falls back quietly to a numpy.memmap
reader when the build fails. Here a failed build raises, and the memmap
reader is taken only when the caller asks for it (native=False).
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["StreamReader", "native_available"]

_SRC = Path(__file__).resolve().parent / "ringbuffer.cpp"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "dsptpu_torch" / \
    "native"
_CXX = "c++"
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lock = threading.Lock()
_lib = None


def _build():
    """Compile ringbuffer.cpp once per (source, compiler, flags); return
    the library's path. Raises RuntimeError if the compiler fails."""
    h = hashlib.sha256(" ".join((_CXX,) + _FLAGS).encode())
    h.update(_SRC.read_bytes())
    out = _BUILD / h.hexdigest()[:16]
    so = out / "libringbuffer.so"
    if so.exists():
        return so
    out.mkdir(parents=True, exist_ok=True)
    tmp = out / f"libringbuffer.{os.getpid()}.tmp.so"
    try:
        proc = subprocess.run([_CXX, *_FLAGS, str(_SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run the C++ compiler {_CXX!r}: {e}") \
            from e
    if proc.returncode:
        raise RuntimeError(f"{_CXX} failed for {_SRC.name}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def _load():
    """The ring buffer's ctypes library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.rb_open.restype = ctypes.c_void_p
            lib.rb_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.c_int]
            lib.rb_next.restype = ctypes.c_size_t
            lib.rb_next.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_void_p)]
            lib.rb_release.restype = None
            lib.rb_release.argtypes = [ctypes.c_void_p]
            lib.rb_close.restype = None
            lib.rb_close.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


def native_available():
    """Whether the ring buffer builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


class StreamReader:
    """Iterate tensors of `chunk` samples from a raw interleaved sample
    file, on `device` (CUDA unless the caller asks for the CPU):

        with StreamReader(path, chunk=1 << 20, dtype=np.float32,
                          channels=4) as sr:
            for block in sr:       # (chunk, channels), the last may be
                process(block)     # shorter; (chunk,) for one channel

    For CUDA, each chunk is copied into one of `nslots` pinned host
    buffers and from there to the card with a non_blocking copy; a
    buffer is reused only after the copy that read it has finished
    (a CUDA event each). native=False reads through numpy.memmap
    without the prefetch thread (dsptpu's fallback, here only on
    request)."""

    def __init__(self, path, chunk, dtype=np.float32, channels=1, nslots=4,
                 device="cuda", native=True):
        self.path = str(path)
        self.dtype = np.dtype(dtype)
        self.tdtype = torch.from_numpy(np.empty(0, self.dtype)).dtype
        self.channels = int(channels)
        self.chunk = int(chunk)
        self.itemsize = self.dtype.itemsize * self.channels
        self.device = resolve_device(device)
        self._lib = _load() if native else None
        self._h = None
        self._mm = None
        self._pos = 0
        self._pinned = []
        self._events = []
        self._next_buf = 0
        if self._lib is not None:
            self._h = self._lib.rb_open(self.path.encode(),
                                        self.chunk * self.itemsize,
                                        int(nslots))
            if not self._h:
                raise OSError(f"cannot open {self.path}")
        else:
            self._mm = np.memmap(self.path, dtype=self.dtype, mode="r")
        if self.device.type == "cuda":
            nbytes = self.chunk * self.itemsize
            self._pinned = [torch.empty(nbytes, dtype=torch.uint8,
                                        pin_memory=True)
                            for _ in range(nslots)]
            self._events = [None] * nslots

    def __iter__(self):
        return self

    def _to_device(self, raw):
        """raw (uint8 numpy, whole samples) as a tensor on the device: a
        copy on the CPU; through the next pinned buffer for CUDA."""
        n = raw.shape[0] // self.itemsize
        shape = (n,) if self.channels == 1 else (n, self.channels)
        if self.device.type != "cuda":
            return torch.from_numpy(raw.copy()).view(self.tdtype).reshape(
                shape)
        i = self._next_buf
        self._next_buf = (i + 1) % len(self._pinned)
        if self._events[i] is not None:
            self._events[i].synchronize()
        buf = self._pinned[i][: raw.shape[0]]
        buf.numpy()[:] = raw
        out = buf.view(self.tdtype).reshape(shape).to(self.device,
                                                      non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._events[i] = ev
        return out

    def __next__(self):
        if self._h is not None:
            ptr = ctypes.c_void_p()
            nbytes = self._lib.rb_next(self._h, ctypes.byref(ptr))
            if nbytes == 0:
                raise StopIteration
            nbytes -= nbytes % self.itemsize
            raw = np.ctypeslib.as_array(
                (ctypes.c_uint8 * nbytes).from_address(ptr.value))
            try:
                return self._to_device(raw)
            finally:
                self._lib.rb_release(self._h)
        if self._mm is None:
            raise StopIteration
        total = self._mm.shape[0] // self.channels
        if self._pos >= total:
            raise StopIteration
        n = min(self.chunk, total - self._pos)
        raw = np.ascontiguousarray(self._mm[self._pos * self.channels:
                                            (self._pos + n) * self.channels])
        self._pos += n
        return self._to_device(raw.view(np.uint8))

    def close(self):
        if self._h is not None:
            self._lib.rb_close(self._h)
            self._h = None
        self._mm = None
        for ev in self._events:
            if ev is not None:
                ev.synchronize()
        self._events = [None] * len(self._events)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
