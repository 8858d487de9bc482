"""The ('data', 'model') layout of the ranks, and its collectives.

Counterpart of ``ap_adapter_tpu/parallel/mesh.py``. Rank ``r`` sits at
``(r // model, r % model)`` (rank-major, as JAX reshapes its device list);
each axis has one process group per line of the layout, built with
``torch.distributed.new_group`` on the default group's backend, so the
same code runs NCCL over several cards and gloo on one. A batch is split
over ``data`` (each rank keeps its own rows); the UNet's transformer
stacks over ``model`` (``parallel/tp.py``). Without a process group the
mesh has one rank and every collective is the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ap_adapter_torch.parallel.distributed import process_count, process_index, rank_device

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: Dict[str, int]                 # {"data": D, "model": M}
    coords: Dict[str, int]                # this rank's index along each axis
    members: Dict[str, Tuple[int, ...]]   # the global ranks of this rank's line along each axis
    groups: Dict[str, Optional[object]]   # their process group; None without one
    device: torch.device

    def rows(self, b_local: int) -> Tuple[int, int]:
        """(first row, global batch) of this rank's ``b_local`` rows."""

        return self.coords["data"] * b_local, b_local * self.shape["data"]


def _lines(data: int, model: int, axis: str) -> List[List[int]]:
    if axis == "model":
        return [[d * model + m for m in range(model)] for d in range(data)]
    return [[d * model + m for d in range(data)] for m in range(model)]


def create_mesh(data: Optional[int] = None, model: int = 1, device="cuda") -> Mesh:
    """The ('data', 'model') mesh over the world; ``data`` defaults to
    world / model, and ``data * model`` must equal the world size. Every
    rank must call it (``new_group`` is collective)."""

    world, rank = process_count(), process_index()
    data = world // model if data is None else data
    if data * model != world:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} ranks, the world has {world}")
    members, groups = {}, {}
    for axis in AXES:
        for line in _lines(data, model, axis):
            group = dist.new_group(line) if dist.is_initialized() else None
            if rank in line:
                members[axis], groups[axis] = tuple(line), group
    return Mesh({"data": data, "model": model}, {"data": rank // model, "model": rank % model}, members, groups,
                rank_device(device))


def shard_batch(mesh: Mesh, batch):
    """This rank's rows (leading axis) of a global batch, a tensor or a dict
    of tensors, on the mesh's device; the identity on the rows for one
    data rank."""

    def rows(t):
        t = torch.as_tensor(t)
        if t.shape[0] % mesh.shape["data"]:
            raise ValueError(f"batch {t.shape[0]} does not split over {mesh.shape['data']} data ranks")
        start, _ = mesh.rows(t.shape[0] // mesh.shape["data"])
        return t[start: start + t.shape[0] // mesh.shape["data"]].to(mesh.device)

    return {k: rows(v) for k, v in batch.items()} if isinstance(batch, dict) else rows(batch)


@torch.no_grad()
def replicate_params(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` broadcast, in place, from the
    first rank of this rank's line along ``data``."""

    if mesh.groups["data"] is not None:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=mesh.members["data"][0], group=mesh.groups["data"])
    return module


@torch.no_grad()
def all_reduce_mean_(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> None:
    """Each tensor, in place, becomes the mean of its values over the ranks
    of this rank's ``data`` line: one ``all_reduce`` of one fp32 buffer
    holding them all."""

    if mesh.groups["data"] is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=mesh.groups["data"])
    flat.div_(mesh.shape["data"])
    offset = 0
    for t in tensors:
        t.copy_(flat[offset: offset + t.numel()].view(t.shape))
        offset += t.numel()


def barrier(mesh: Mesh) -> None:
    """Every rank waits for the others (nothing without a process group)."""

    if mesh.groups["data"] is None:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[mesh.device.index])
    else:
        dist.barrier()
