"""Process-group initialization and the rank's share of a batch.

Counterpart of ``ap_adapter_tpu/parallel/distributed.py`` on
``torch.distributed``: one process per rank, each on its own device. The
environment contract is the JAX package's, or torchrun's:

    APX_COORDINATOR=<host:port>    (or MASTER_ADDR and MASTER_PORT)
    APX_NUM_PROCESSES=<world size> (or WORLD_SIZE)
    APX_PROCESS_ID=<0-based rank>  (or RANK)
    LOCAL_RANK=<the rank's card on its host>

The collectives of the port are ``all_reduce``, ``broadcast`` and
``barrier`` only (``parallel/mesh.py``): NCCL runs them over several cards,
and gloo runs them on CUDA tensors too, which is how two ranks share one
card. In the port the global batch is never assembled: each rank keeps its
own rows, and the mesh's collectives combine what the ranks computed.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist


def _env(*names: str) -> Optional[str]:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return None


def maybe_initialize(device="cuda", backend: Optional[str] = None, init_method: Optional[str] = None) -> bool:
    """Initialize the default process group when the environment names more
    than one process. Returns True when running multi-process (after the
    initialization, or when a group already exists), False for the ordinary
    single process. Idempotent.

    ``backend`` defaults to ``nccl`` for a CUDA ``device`` and ``gloo`` for
    the CPU; ``init_method`` defaults to ``tcp://<coordinator>`` from the
    JAX contract, else ``env://`` (torchrun). On CUDA a ``device`` without
    an index binds the rank to ``cuda:LOCAL_RANK``; one with an index is
    taken as given (every rank on one card)."""

    if dist.is_initialized():
        return True
    num = _env("APX_NUM_PROCESSES", "WORLD_SIZE")
    if num is None or int(num) <= 1:
        return False
    rank = _env("APX_PROCESS_ID", "RANK")
    if rank is None:
        raise ValueError(f"{num} processes named but no rank (APX_PROCESS_ID or RANK)")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev if dev.index is not None else int(os.environ.get("LOCAL_RANK", "0")))
    if init_method is None:
        coord = _env("APX_COORDINATOR")
        init_method = f"tcp://{coord}" if coord else "env://"
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"), init_method=init_method,
                            world_size=int(num), rank=int(rank))
    return True


def rank_device(device="cuda") -> torch.device:
    """The rank's device: ``cuda`` without an index resolves to the card
    that ``maybe_initialize`` bound (the current one); any other device is
    returned as given."""

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def host_local_batch_size(global_batch: int) -> int:
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not split over {n} processes")
    return global_batch // n


def shard_host_batch(mesh, batch: Any, spec: Sequence[Optional[str]] = ("data",)):
    """Each rank's local batch, placed on the rank's device: the JAX
    contract (distributed.py:92-116) without the assembly. ``batch`` is a
    tensor or a dict of tensors, all with the same local batch size on the
    axis that ``spec`` names "data": the leading one by default, the second
    for stacked micro-batches ``[K, B_local, ...]`` (``spec=(None,
    "data")``). The global batch is ``B_local * mesh.shape["data"]``, rank
    r of the data axis holding rows ``[r * B_local, (r + 1) * B_local)``."""

    axis = list(spec).index("data")
    leaves = batch.values() if isinstance(batch, dict) else [batch]
    sizes = {tuple(t.shape[: axis + 1]) for t in leaves}
    if len(sizes) != 1:
        raise ValueError(f"the batch's leaves disagree on their leading axes {sorted(sizes)}")
    place = lambda t: torch.as_tensor(t).to(mesh.device)
    return {k: place(v) for k, v in batch.items()} if isinstance(batch, dict) else place(batch)
