"""Device placement and float32 precision rules of the port.

A tensor argument stays on its own device. A numpy array, list or
scalar goes to the `device` the caller names, "cuda" by default; if
CUDA is absent that raises, so nothing runs on the CPU by accident.
"""

import numpy as np
import torch

__all__ = ["as_tensor", "resolve_device", "no_tf32", "check_full_f32"]


def resolve_device(device=None):
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return dev


def as_tensor(v, device=None):
    """v itself if it is a tensor, else v as a tensor on `device`."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.asarray(v), device=resolve_device(device))


def no_tf32():
    """Context for convolutions: cuDNN keeps its settings but computes
    float32 in full float32 (its default is TF32, ~3 digits)."""
    cd = torch.backends.cudnn
    return cd.flags(enabled=cd.enabled, benchmark=cd.benchmark,
                    deterministic=cd.deterministic, allow_tf32=False)


def check_full_f32():
    """Raise if float32 matrix products on the card may use TF32."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is True: "
                           "float32 products would run in TF32")
