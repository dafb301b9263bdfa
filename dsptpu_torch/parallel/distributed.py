"""Multi-process execution helpers (dsptpu's parallel/distributed.py on
torch.distributed).

On real hardware every process runs the same program, one per GPU:
call `init_distributed()` first (it reads torchrun's environment), build
the mesh with `global_mesh()`, and run the sharded ops of parallel.ops;
their halo exchanges, state chains and sums are NCCL collectives.

Without several GPUs, `simulate_hosts(n)` runs the same code path on
the CPU: n gloo ranks in spawned processes stand in for n hosts. JAX
can force n virtual devices into one process; PyTorch cannot, so the
ranks are processes and the call returns a pool that runs a function
on every rank (see simulate_hosts).
"""

import dataclasses
import datetime
import multiprocessing
import os
import shutil
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

from .mesh import _backend, make_mesh

__all__ = ["init_distributed", "global_mesh", "simulate_hosts", "HostPool",
           "Sharded", "weak_scaling_efficiency"]

# a hung collective (a rank that raised while its peers wait) fails the
# call after this long instead of blocking for ever; a HostPool call
# waits a little longer for the ranks' results
_TIMEOUT = datetime.timedelta(seconds=120)
_POOL_TIMEOUT_S = 300.0


def init_distributed(coordinator=None, num_processes=None, process_id=None,
                     device_type="cuda"):
    """Join the process group from explicit arguments or torchrun's
    environment (MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK,
    LOCAL_RANK). `coordinator` is "host:port" or an init_method URL
    ("tcp://..." or "file://..."). For "cuda" the process takes GPU
    LOCAL_RANK (default: process_id modulo the GPU count) and NCCL;
    for "cpu", gloo. Returns False when there is nothing to join or a
    group already exists, True when it joined."""
    if dist.is_initialized():
        return False
    if coordinator is None and "MASTER_ADDR" in os.environ:
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    num_processes = num_processes or _env_int("WORLD_SIZE")
    process_id = (process_id if process_id is not None
                  else _env_int("RANK"))
    if coordinator is None and num_processes is None:
        return False
    num_processes = 1 if num_processes is None else num_processes
    process_id = 0 if process_id is None else process_id
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    if device_type == "cuda":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(process_id % torch.cuda.device_count()
                              if local is None else local)
    dist.init_process_group(_backend(device_type), init_method=coordinator,
                            world_size=num_processes, rank=process_id,
                            timeout=_TIMEOUT)
    return True


def _env_int(name):
    v = os.environ.get(name)
    return None if v is None else int(v)


def global_mesh(time=None, channel=None, device_type="cuda"):
    """Mesh over all processes' devices. With neither size given, a 1-D
    ('time',) mesh over every rank; otherwise a ('channel', 'time') mesh,
    the missing size the world size over the given one.

    dsptpu's global_mesh raises TypeError: it passes time= and channel=
    to a make_mesh that takes neither. The port builds the mesh its
    docstring describes (a divergence on purpose)."""
    from .mesh import _ensure_group
    _ensure_group(device_type)
    n = dist.get_world_size()
    if time is None and channel is None:
        return make_mesh((n,), ("time",), device_type)
    if time is None:
        time = n // channel
    if channel is None:
        channel = n // time
    return make_mesh((channel, time), ("channel", "time"), device_type)


@dataclasses.dataclass(frozen=True)
class Sharded:
    """An argument of HostPool.run that reaches each rank as its block of
    `array`: a DTensor sharded along axis 0 over the mesh's time axis
    (and along axis 1 over channel_axis, if given); parallel.ops.
    shard_time. The counterpart of the global jax.Array that dsptpu's
    weak-scaling bench assembles from each host's block."""
    array: np.ndarray
    channel_axis: str = None


def _to_host(obj):
    """Results as numpy: a DTensor as its full value (a collective, so
    every rank converts the same results in the same order), a tensor
    as its numpy copy, a DeviceMesh as {axis name: size}; tuples, lists,
    dicts and dataclasses by field."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor
    if isinstance(obj, DeviceMesh):
        return dict(zip(obj.mesh_dim_names, obj.mesh.shape))
    if isinstance(obj, DTensor):
        obj = obj.full_tensor()
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_host(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _to_host(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _host_main(init_method, n, rank, conn):
    """One simulated host: join the gloo group, then run each (fn, args,
    kwargs) the pool sends until it sends None. `mesh=` a shape becomes
    that ('channel', 'time') CPU mesh (built once per shape) and each
    Sharded argument this rank's DTensor block of it."""
    from .ops import shard_time
    torch.set_num_threads(1)
    init_distributed(init_method, n, rank, device_type="cpu")
    meshes = {}
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            fn, args, kwargs = msg
            try:
                shape = kwargs.get("mesh")
                if isinstance(shape, tuple):
                    if shape not in meshes:
                        names = (("time",) if len(shape) == 1
                                 else ("channel", "time"))
                        meshes[shape] = make_mesh(shape, names, "cpu")
                    mesh = kwargs["mesh"] = meshes[shape]

                    def place(v):
                        return (shard_time(v.array, mesh,
                                           channel_axis=v.channel_axis)
                                if isinstance(v, Sharded) else v)
                    args = tuple(place(v) for v in args)
                    kwargs = {k: place(v) for k, v in kwargs.items()}
                conn.send((True, _to_host(fn(*args, **kwargs))))
            except Exception:
                conn.send((False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class HostPool:
    """n gloo ranks on the CPU in spawned processes, kept alive between
    calls; see simulate_hosts. Close it (or use it as a context manager)
    to stop the processes."""

    def __init__(self, n):
        ctx = multiprocessing.get_context("spawn")
        self.n = n
        self._dir = tempfile.mkdtemp(prefix="dsptpu_torch_hosts_")
        init = "file://" + os.path.join(self._dir, "store")
        self._conns, self._procs = [], []
        for rank in range(n):
            mine, theirs = ctx.Pipe()
            p = ctx.Process(target=_host_main, args=(init, n, rank, theirs),
                            daemon=True)
            p.start()
            theirs.close()
            self._conns.append(mine)
            self._procs.append(p)

    def run(self, fn, *args, **kwargs):
        """fn(*args, **kwargs) on every rank; the list of the ranks'
        results as numpy (a DTensor as its full value). fn is passed by
        reference, so it must be a module-level function of an
        importable module (the ranks import only torch, numpy and
        dsptpu_torch). A tuple `mesh=` becomes that ('channel', 'time')
        mesh of CPU ranks (('time',) for a 1-tuple), and each Sharded
        argument this rank's block of its array. Raises if a rank
        raised."""
        if not self._procs:
            raise RuntimeError("the host pool is closed")
        for c in self._conns:
            c.send((fn, args, kwargs))
        out = []
        for c in self._conns:
            if not c.poll(_POOL_TIMEOUT_S):
                self.close()
                raise TimeoutError(f"a simulated host gave no result in "
                                   f"{_POOL_TIMEOUT_S} s")
            out.append(c.recv())
        failed = [r for ok, r in out if not ok]
        if failed:
            raise RuntimeError("a simulated host raised:\n" + failed[0])
        return [r for _, r in out]

    def close(self):
        for c, p in zip(self._conns, self._procs):
            if p.is_alive():
                try:
                    c.send(None)
                except OSError:
                    pass
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        for c in self._conns:
            c.close()
        self._conns, self._procs = [], []
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def simulate_hosts(n):
    """n simulated hosts: a HostPool of n gloo ranks on the CPU, started
    in spawned processes (each with one torch thread), whose .run(fn,
    *args) runs fn on every rank and returns the ranks' results as
    numpy.

    dsptpu's simulate_hosts(n) forces n virtual CPU devices into the
    calling process and returns whether the flag took; a later
    make_mesh then spans them. PyTorch has no virtual devices: a rank of
    torch.distributed is a process, so the port's counterpart returns
    the pool of processes that the sharded ops then run in."""
    return HostPool(n)


def weak_scaling_efficiency(rates):
    """rates: {n_hosts: samples_per_s_aggregate}. Efficiency of the
    largest configuration vs linear scaling from the smallest."""
    ns = sorted(rates)
    base = rates[ns[0]] / ns[0]
    return {n: rates[n] / (n * base) for n in ns}
