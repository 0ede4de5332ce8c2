"""Meshes over torch.distributed: make_mesh, the spawn launcher, and the
collectives of the multi-device modules (Axis).

Counterpart of kvxopt_tpu/parallel/batch.py's make_mesh and of the
shard_map/psum plumbing of the JAX package's sharded, arrow and
dist_chol modules.  JAX runs one program over a Mesh of devices; here
each rank is a process with its own device, every rank calls the same
functions with the same data (SPMD), keeps its own part, and the ranks
meet in collectives.  The mesh is a DeviceMesh over the initialized
process group, its dimensions named as JAX's mesh axes.

Every collective is an all_reduce or a broadcast (an all-gather is an
all_reduce of zero-padded buffers): gloo runs those two on CUDA tensors
as well as on CPU ones, and NCCL runs them on the card.
"""

from __future__ import annotations

import math
import os
import pickle
import tempfile
import time
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def make_mesh(n_devices=None, axis_names=("batch",), shape=None):
    """A DeviceMesh over the ranks of the initialized process group:
    1-D over all of them, or reshaped to `shape`, its dimensions named
    axis_names.  A hierarchical ('dcn', 'ici') mesh is 2-D; an Axis over
    the tuple reduces over both dimensions.

    Raises RuntimeError where no process group is initialized (start
    one with spawn, or torch.distributed.init_process_group): the mesh
    never makes a world of its own; ValueError where n_devices or shape
    does not match the world's size."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialized torch.distributed process "
            "group: start the ranks with kvxopt_tpu_torch.parallel.spawn "
            "or torch.distributed.init_process_group")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: n_devices={n_devices}, but the "
                         f"process group has {world} ranks")
    shape = (world,) if shape is None else tuple(int(s) for s in shape)
    if math.prod(shape) != world:
        raise ValueError(f"make_mesh: shape {shape} does not hold the "
                         f"{world} ranks of the process group")
    axis_names = tuple(axis_names)
    if len(axis_names) != len(shape):
        raise ValueError(f"make_mesh: {len(axis_names)} axis names for a "
                         f"{len(shape)}-D shape")
    from torch.distributed.device_mesh import DeviceMesh
    # the mesh's device type names the backend of its groups; gloo's
    # groups serve CUDA tensors too
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=axis_names)


class Axis:
    """One mesh axis, or a tuple of axes (hierarchical meshes), as the
    ranks along it: their number (size), this rank's index along it
    (row-major over a tuple) and the collectives over it, in place.
    Over a tuple, a collective runs over the last axis first, then over
    the ones before it."""

    def __init__(self, mesh, axis):
        names = axis if isinstance(axis, tuple) else (axis,)
        dims = [mesh.mesh_dim_names.index(a) for a in names]
        self.mesh, self.dims = mesh, dims
        self.groups = [mesh.get_group(a) for a in names]
        self.sizes = [mesh.size(d) for d in dims]
        self.size = math.prod(self.sizes)
        coord = mesh.get_coordinate()
        self.index = 0
        for d, s in zip(dims, self.sizes):
            self.index = self.index * s + coord[d]

    def all_reduce(self, t):
        """The sum of t over the ranks along the axis, in t."""
        buf = t.contiguous()       # the backends take dense buffers
        for g in reversed(self.groups):
            dist.all_reduce(buf, group=g)
        return t if buf is t else t.copy_(buf)

    def broadcast(self, t, src):
        """t of the rank at index `src` along the axis, in t on every rank
        along it (one broadcast per mesh axis in the tuple)."""
        buf = t.contiguous()
        cs = []
        for s in reversed(self.sizes):
            src, c = divmod(src, s)
            cs.append(c)
        mine = list(self.mesh.get_coordinate())
        for d, g, c in zip(reversed(self.dims), reversed(self.groups), cs):
            coord = list(mine)
            coord[d] = c
            dist.broadcast(buf, src=int(self.mesh.mesh[tuple(coord)]),
                           group=g)
        return t if buf is t else t.copy_(buf)

    def gather(self, local, total):
        """The ranks' consecutive slices of a leading axis of length
        `total` (this rank's `local` at index * len(local)), joined on
        every rank: an all_reduce of zero-padded buffers."""
        full = local.new_zeros((total,) + tuple(local.shape[1:]))
        k = local.shape[0]
        full[self.index * k:(self.index + 1) * k] = local
        return self.all_reduce(full)

    def part(self, total):
        """This rank's slice of a leading axis of length `total`, which
        the axis must divide."""
        if total % self.size:
            raise ValueError(f"{total} does not divide over the "
                             f"{self.size} ranks of the mesh axis")
        k = total // self.size
        return slice(self.index * k, (self.index + 1) * k)


def _rank_main(rank, fn, world_size, backend, device, init, result,
               args, timeout):
    """One rank of spawn: its device, the process group, fn, and (rank 0)
    its result pickled to the file `result`.  An exception leaves the
    rank with its traceback, which start_processes hands to spawn."""
    from .. import config  # noqa: F401  (TF32 off in every rank)
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout))
    try:
        out = fn(rank, world_size, dev, *args)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(result, "wb") as fh:
            pickle.dump(out, fh)


def _default_backend(dev, world_size):
    """NCCL where every rank has a card of its own (a world of one on a
    card, or 'cuda' over as many cards as ranks), gloo otherwise: CPU
    ranks, or several ranks on one card, which NCCL refuses."""
    if dev.type != "cuda":
        return "gloo"
    if world_size == 1 or (dev.index is None and
                           torch.cuda.device_count() >= world_size):
        return "nccl"
    return "gloo"


def spawn(fn, world_size, backend=None, device=None, args=(),
          timeout=600.0):
    """Run fn(rank, world_size, device, *args) in world_size new
    processes that form one torch.distributed world, and return rank
    0's result, which must pickle (numpy or CPU data).

    device: each rank's; None is config.default_device, the card, which
    raises where there is none.  'cuda' puts rank r on card r mod the
    count, 'cuda:i' every rank on card i, 'cpu' the ranks on the CPU.
    backend: 'gloo' or 'nccl'; None picks NCCL where every rank has a
    card of its own, gloo otherwise.

    The processes start by the 'spawn' method (torch.multiprocessing.
    start_processes) and meet at a file in a new temporary directory (no
    port).  A rank that raises or dies fails the call with its
    traceback, and one that has not finished within `timeout` seconds
    fails it too; every process is stopped before spawn returns or
    raises."""
    from ..solvers.coneprog import _solve_device
    dev = torch.device(device) if device is not None else _solve_device()
    if backend is None:
        backend = _default_backend(dev, world_size)
    with tempfile.TemporaryDirectory(prefix="kvxopt_spawn_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        result = os.path.join(tmp, "result.pickle")
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, backend, str(dev), init,
                              result, args, timeout),
            nprocs=world_size, join=False, daemon=True,
            start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, deadline -
                                           time.monotonic())):
                if time.monotonic() >= deadline:
                    late = [r for r, p in enumerate(ctx.processes)
                            if p.is_alive()]
                    raise TimeoutError(f"spawn: ranks {late} did not finish "
                                       f"within {timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RuntimeError(f"spawn: rank {e.error_index} failed:{e}") \
                from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
            for f in ctx.error_files:
                if os.path.exists(f):
                    os.unlink(f)
        if not os.path.exists(result):
            raise RuntimeError("spawn: rank 0 exited without a result")
        with open(result, "rb") as fh:
            return pickle.load(fh)
