"""Device mesh construction for multi-GPU DSP streams (dsptpu's
parallel/mesh.py on torch.distributed).

A 2-D ('channel', 'time') DeviceMesh: 'channel' carries the
embarrassingly parallel trailing channel dims, 'time' the block
decomposition of the sequence. The sharded ops in parallel.ops exchange
halos and boundary states point to point along 'time' and all-reduce
spectral sums (NCCL on the card, gloo on the CPU).

dsptpu builds a jax Mesh in one process with no distributed setup. To
match that, make_mesh starts a single-rank process group when none
exists (an in-process HashStore, NCCL for "cuda", gloo for "cpu"), so
one process can run the sharded ops at world size 1.
"""

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

__all__ = ["make_mesh", "default_mesh"]


def _backend(device_type):
    return "nccl" if device_type == "cuda" else "gloo"


def _ensure_group(device_type):
    """Start a single-rank process group if none exists."""
    if dist.is_initialized():
        return
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass "
                               "device_type='cpu' to run on the CPU")
        torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group(_backend(device_type), store=dist.HashStore(),
                            rank=0, world_size=1)


def make_mesh(shape=None, axis_names=("channel", "time"), device_type="cuda"):
    """A DeviceMesh over all ranks of the process group (started with
    one rank if there is none). `shape` defaults to (1, world size):
    pure time sharding."""
    _ensure_group(device_type)
    n = dist.get_world_size()
    if shape is None:
        shape = (1, n)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axis names "
                         f"{tuple(axis_names)}")
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names))


def default_mesh():
    return make_mesh()
