"""The process group as the port's mesh (deeplab_tpu/parallel/mesh.py).

The JAX package shards the batch over a ('data', 'space') device mesh and
feeds each process its local rows of the global batch.  The port's data
parallelism is ``torch.distributed`` with one process per device: the
"mesh" is the process group, each process holds the replicated weights on
its own device and its local rows, and the collectives are NCCL on
``cuda`` and gloo on the CPU.  Nothing here starts a process group: the
caller (``torch.distributed.init_process_group``) or ``torchrun`` does.
Without one, every helper is the single-process identity.

Height (spatial) sharding is not ported: it needs convolution halos
exchanged between processes (ROADMAP A10s, spatial sharding).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from deeplab_tpu_torch import core


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def is_coordinator() -> bool:
    """True on the process that owns file writes (checkpoints, weight
    files, logs): rank 0, and always single-process."""
    return process_index() == 0


def _local_device(backend: str) -> torch.device:
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   process_index() % max(
                                       torch.cuda.device_count(), 1)))
        return torch.device("cuda", local)
    return torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data-parallel group: ``group`` (None is the default group),
    this process's ``rank`` in it, its ``world`` size, this process's
    ``device``, and whether a process group backs it (``grouped``: the
    collectives run, also over one process; otherwise the mesh is one
    process and they are the identity)."""
    group: Optional[object]
    rank: int
    world: int
    device: torch.device
    grouped: bool = False

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group's processes (in place; JAX's
        ``psum``).  The identity without a process group."""
        if self.grouped:
            dist.all_reduce(t, group=self.group)
        return t


def get_mesh(group=None, device=None) -> Mesh:
    """The mesh of ``group`` (default: the initialized default group; none:
    a one-process mesh on ``device``, the card unless the caller asks for
    the CPU).  The device defaults to ``cuda:LOCAL_RANK`` under NCCL and
    the CPU under gloo."""
    if not _initialized():
        return Mesh(None, 0, 1, core.resolve_device(device))
    backend = dist.get_backend(group)
    dev = torch.device(device) if device is not None else \
        _local_device(backend)
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), dev,
                grouped=True)


def warmup_collectives(mesh: Optional[Mesh] = None):
    """One ``all_reduce`` while every process is aligned (right after the
    group starts), so that the communicator exists before the first train
    step; checks that it sums to the world size.  No-op without a process
    group."""
    mesh = mesh if mesh is not None else get_mesh()
    if not mesh.grouped:
        return
    one = torch.ones((), device=mesh.device)
    total = mesh.all_sum(one).item()
    assert total == mesh.world, (total, mesh.world)


def local_batch_rows(x, mesh: Optional[Mesh] = None):
    """This process's rows of a global batch: the ``rank``-th of ``world``
    equal slices along the first axis (JAX ``put_global``'s convention)."""
    mesh = mesh if mesh is not None else get_mesh()
    n = x.shape[0]
    if n % mesh.world:
        raise ValueError(f"a global batch of {n} does not divide over "
                         f"{mesh.world} processes")
    per = n // mesh.world
    return x[mesh.rank * per:(mesh.rank + 1) * per]


def gather_rows(t: torch.Tensor, mesh: Optional[Mesh] = None
                ) -> torch.Tensor:
    """Every process's rows of ``t`` concatenated in rank order (the
    inverse of :func:`local_batch_rows`; JAX ``local_batch_rows`` of a
    global array).  Each process must pass the same shape."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh.world == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts)


def get_available_devices(kind: str = "cuda"):
    """Reference utils.py:94-96: this machine's devices of ``kind``
    (``"cuda"``, ``"cpu"`` or ``"all"``)."""
    devs = []
    if kind in ("cuda", "all"):
        devs += [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    if kind in ("cpu", "all"):
        devs.append(torch.device("cpu"))
    return devs
