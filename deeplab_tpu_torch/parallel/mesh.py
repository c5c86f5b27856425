"""The process group as the port's mesh (deeplab_tpu/parallel/mesh.py).

The JAX package shards the batch over a ('data', 'space') device mesh and
feeds each process its local rows of the global batch.  The port's mesh is
``torch.distributed`` with one process per device: the process group, laid
out as JAX's ``reshape(data, space)`` (``data_index = rank // space``,
``space_index = rank % space``).  Each process holds the replicated weights
on its own device.  Over the 'data' axis each process is fed its local rows
of the global batch; the ``space`` processes of one data slot hold the same
images and each computes one band of their rows (``parallel/spatial.py``,
the halo exchange in place of XLA's SPMD partitioner).  The collectives are
NCCL on ``cuda`` and gloo on the CPU; a gloo group whose processes hold
their tensors on ``cuda`` (several processes sharing one card, which NCCL
refuses) moves each collective's tensors through host memory, chosen by
the backend and said once when the mesh is made.  Nothing here starts a
process group: the caller (``torch.distributed.init_process_group``) or
``torchrun`` does.  Without one, every helper is the single-process
identity.
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
    """The mesh: ``group`` (None is the default group), this process's
    ``rank`` in it, its ``world`` size, this process's ``device``, and
    whether a process group backs it (``grouped``: the collectives run,
    also over one process; otherwise the mesh is one process and they are
    the identity).  ``data`` x ``space`` is the layout (``data`` defaults
    to ``world // space``), ``data_index`` and ``space_index`` this
    process's place in it; ``space_group`` holds the processes of this
    process's data slot (bands of the same images), ``data_group`` the
    processes of its space index.  ``host_transport``: the collectives
    move ``cuda`` tensors through host memory (a gloo group on the
    card)."""
    group: Optional[object]
    rank: int
    world: int
    device: torch.device
    grouped: bool = False
    space: int = 1
    data: Optional[int] = None
    space_group: Optional[object] = None
    data_group: Optional[object] = None
    host_transport: bool = False

    def __post_init__(self):
        if self.data is None:
            object.__setattr__(self, "data", self.world // self.space)
        if self.data * self.space != self.world:
            raise ValueError(f"{self.world} processes != data({self.data}) "
                             f"* space({self.space})")

    @property
    def data_index(self) -> int:
        return self.rank // self.space

    @property
    def space_index(self) -> int:
        return self.rank % self.space

    def _reduce(self, t: torch.Tensor, group) -> torch.Tensor:
        if self.host_transport and t.is_cuda:
            host = t.cpu()
            dist.all_reduce(host, group=group)
            return t.copy_(host)
        dist.all_reduce(t, group=group)
        return t

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group's processes (in place; JAX's
        ``psum``).  The identity without a process group."""
        if self.grouped:
            self._reduce(t, self.group)
        return t

    def space_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over this process's data slot, its ``space``
        processes (in place; JAX's ``psum`` over 'space')."""
        return self.space_axis().all_sum(t)

    def space_gather(self, t: torch.Tensor, sizes=None, dim: int = 0
                     ) -> torch.Tensor:
        """Every space process's ``t`` concatenated along ``dim`` in space
        order.  The parts may differ in size along ``dim`` only:
        ``sizes`` gives each process's (otherwise they must be equal)."""
        if not self.grouped or self.space == 1:
            return t
        sizes = list(sizes) if sizes is not None else [t.shape[dim]] * \
            self.space
        if sizes[self.space_index] != t.shape[dim]:
            raise ValueError(f"this process's part has {t.shape[dim]} "
                             f"along dim {dim}, not {sizes}")
        n = max(sizes)
        pad = [0, 0] * (t.dim() - 1 - dim % t.dim()) + [0, n - t.shape[dim]]
        part = torch.nn.functional.pad(t, pad).contiguous()
        parts = all_gather(part, self.space_group, self.host_transport)
        return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)],
                         dim=dim)

    def data_axis(self) -> "Mesh":
        """The mesh of this process's ``data_group``: one process a data
        slot, all of the same space index (a BN that sees each image
        once, a sum of per-image values)."""
        if self.space == 1:
            return self
        return Mesh(self.data_group, self.data_index, self.data, self.device,
                    grouped=self.grouped, host_transport=self.host_transport)

    def space_axis(self) -> "Mesh":
        """The mesh of this process's ``space_group``, its data slot."""
        if self.space == 1:
            return Mesh(None, 0, 1, self.device)
        return Mesh(self.space_group, self.space_index, self.space,
                    self.device, grouped=self.grouped,
                    host_transport=self.host_transport)


def all_gather(t: torch.Tensor, group, host_transport: bool = False):
    """Every process's ``t`` (equal shapes) in group order; through host
    memory with ``host_transport``."""
    n = dist.get_world_size(group)
    src = t.cpu() if host_transport and t.is_cuda else t
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts]


def get_mesh(group=None, device=None, space: int = 1) -> Mesh:
    """The mesh of ``group`` (default: the initialized default group; none:
    a one-process mesh on ``device``, the card unless the caller asks for
    the CPU) with ``space`` processes to a data slot (JAX ``get_mesh(devices,
    data, space)``; ``data`` is the world size over ``space``).  With
    ``space > 1`` every process of the default group must call it, in the
    same order as its other calls that make process groups: each makes
    every subgroup.  The device defaults to ``cuda:LOCAL_RANK`` under NCCL
    and the CPU under gloo."""
    if not _initialized():
        if space != 1:
            raise ValueError(f"space={space} needs a process group of at "
                             f"least {space} processes")
        return Mesh(None, 0, 1, core.resolve_device(device))
    backend = dist.get_backend(group)
    dev = torch.device(device) if device is not None else \
        _local_device(backend)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    if space < 1 or world % space:
        raise ValueError(f"space={space} does not divide the {world} "
                         f"processes of the group")
    host = backend == "gloo" and dev.type == "cuda"
    if host and rank == 0:
        print(f"mesh: gloo backend with tensors on {dev}: the collectives "
              f"move them through host memory", flush=True)
    space_group = data_group = None
    if space > 1:
        ranks = dist.get_process_group_ranks(group) if group is not None \
            else list(range(world))
        data = world // space
        for d in range(data):           # the data slots
            g = dist.new_group(ranks[d * space:(d + 1) * space])
            if rank // space == d:
                space_group = g
        for s in range(space):          # the space indices
            g = dist.new_group(ranks[s::space])
            if rank % space == s:
                data_group = g
    return Mesh(group, rank, world, dev, grouped=True, space=space,
                space_group=space_group, data_group=data_group,
                host_transport=host)


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
    """This process's rows of a global batch: its data slot's, the
    ``data_index``-th of ``data`` equal slices along the first axis (JAX
    ``put_global``'s convention; the space processes of a slot get the
    same rows)."""
    mesh = mesh if mesh is not None else get_mesh()
    n = x.shape[0]
    if n % mesh.data:
        raise ValueError(f"a global batch of {n} does not divide over "
                         f"{mesh.data} data slots")
    per = n // mesh.data
    return x[mesh.data_index * per:(mesh.data_index + 1) * per]


def gather_rows(t: torch.Tensor, mesh: Optional[Mesh] = None
                ) -> torch.Tensor:
    """Every data slot's rows of ``t`` concatenated in slot order (the
    inverse of :func:`local_batch_rows`; JAX ``local_batch_rows`` of a
    global array).  Each process must pass the same shape."""
    mesh = mesh if mesh is not None else get_mesh()
    axis = mesh.data_axis()
    if axis.world == 1:
        return t
    return torch.cat(all_gather(t.contiguous(), axis.group,
                                axis.host_transport))


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
