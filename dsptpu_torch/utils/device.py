"""Device placement, transfers and float32 precision rules of the port.

A tensor argument stays on its own device. A numpy array, list or
scalar goes to the `device` the caller names, "cuda" by default; if
CUDA is absent that raises, so nothing runs on the CPU by accident.

The two transfer helpers name the points where data crosses between
the host and the device: `as_tensor` uploads host data, `to_host` reads
a tensor back. Each transfer counts `sync.<site>` (utils.profiling's
always-on counters; an upload also adds its bytes to `upload.bytes`)
and runs inside span("sync.<site>"). They count on every device, so
tests on the CPU pin them; on a CUDA device each `sync.*` is a point
where the host waits for the stream: PyTorch's blocking copy to the
host synchronizes it, and so does an upload from pageable memory.
"""

import contextlib

import numpy as np
import torch

from .profiling import count, span

__all__ = ["as_tensor", "to_host", "resolve_device", "no_tf32", "full_f32",
           "check_full_f32"]


def resolve_device(device=None):
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return dev


def as_tensor(v, device=None, site="as_tensor"):
    """v itself if it is a tensor (uncounted), else v as a tensor on
    `device`: an upload, counted as `sync.<site>` and its bytes as
    `upload.bytes`, inside span("sync.<site>")."""
    if isinstance(v, torch.Tensor):
        return v
    a = np.asarray(v)
    dev = resolve_device(device)
    name = "sync." + site
    count(name)
    count("upload.bytes", a.nbytes)
    with span(name):
        return torch.as_tensor(a, device=dev)


def to_host(t, site):
    """t's value as a host numpy array: a tensor is read back, counted
    as `sync.<site>`, inside span("sync.<site>"); host data passes
    through uncounted, as np.asarray(t)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    name = "sync." + site
    count(name)
    with span(name):
        return t.detach().cpu().numpy()


def no_tf32():
    """Context for convolutions: cuDNN keeps its settings but computes
    float32 in full float32 (its default is TF32, ~3 digits)."""
    cd = torch.backends.cudnn
    return cd.flags(enabled=cd.enabled, benchmark=cd.benchmark,
                    deterministic=cd.deterministic, allow_tf32=False)


@contextlib.contextmanager
def full_f32():
    """Context (or decorator) for float32 matrix products: turns
    torch.backends.cuda.matmul.allow_tf32 off and restores the caller's
    value on exit, also on an exception. dsptpu pins these products to
    Precision.HIGHEST whatever the global setting; TF32 keeps ~3 digits."""
    mm = torch.backends.cuda.matmul
    try:
        name, prev, off = "allow_tf32", mm.allow_tf32, False
    except RuntimeError:
        # the caller set TF32 through the newer per-backend API, which
        # refuses a read of the legacy flag: use that API instead
        name, prev, off = "fp32_precision", mm.fp32_precision, "ieee"
    setattr(mm, name, off)
    try:
        yield
    finally:
        setattr(mm, name, prev)


def check_full_f32():
    """Raise if float32 matrix products on the card may use TF32."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is True: "
                           "float32 products would run in TF32")
