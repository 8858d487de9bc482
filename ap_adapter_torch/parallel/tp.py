"""Tensor-parallel serving: the UNet's transformer stacks split by heads
over the mesh's ``model`` axis.

Counterpart of ``ap_adapter_tpu/parallel/tp.py``, whose GSPMD shardings
become explicit narrowing here, keyed on the port's diffusers names:

  * column-parallel (``weight`` dim 0 of an ``nn.Linear``, the output
    features): ``to_q``, ``to_k``, ``to_v``, ``to_k_ip``, ``to_v_ip``. Each
    rank projects and attends its own heads;
  * row-parallel (``weight`` dim 1, the input features): ``to_out.0`` and
    ``ff.net.2``. Each rank contracts its heads or columns into a partial
    sum; one ``all_reduce`` over ``model`` adds them, and the bias, kept
    whole, is added once after it;
  * the GEGLU ``ff.net.0.proj``, Megatron-style: rank r holds the same
    column slice of the value half and of the gate half (rows of the weight,
    entries of the bias), so its local ``[value | gate]`` is a GEGLU of its
    own; ``ff.net.2``'s rows follow the same columns. JAX splits the
    ``[.., 2 * inner]`` axis contiguously (its tp.py:62), which at N = 2
    puts every value column on rank 0 and every gate column on rank 1;
  * everything else (convs, norms, the time embedding, every model but the
    UNet) is replicated.

Where ``model`` does not divide the head count or the FF inner width,
``tp_shard_unet_`` raises ``ValueError``: JAX replicates such a leaf, but
explicit collectives cannot mix split and whole sites. The sharded sites
take the route outside the kernels (``UNetConfig.force_xla_core``,
``models/unet_blocks.py``), as JAX's TP serving does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ap_adapter_torch.models.unet_blocks import CrossAttention, FeedForward

COL_PARALLEL = ("to_q", "to_k", "to_v", "to_k_ip", "to_v_ip")
ROW_PARALLEL = ("to_out.0", "ff.net.2")
GEGLU = "ff.net.0.proj"


def split_rule(key: str) -> Optional[Tuple[str, int]]:
    """How TP splits the UNet state-dict entry ``key``: ("column", 0),
    ("row", 1) or ("geglu", 0), the kind and the split dimension; None where
    it stays whole."""

    module, _, leaf = ("." + key).rpartition(".")
    if module.endswith("." + GEGLU):
        return "geglu", 0
    if leaf == "weight" and module.rpartition(".")[2] in COL_PARALLEL:
        return "column", 0
    if leaf == "weight" and module.endswith(tuple("." + r for r in ROW_PARALLEL)):
        return "row", 1
    return None


def shard(t: torch.Tensor, kind: str, n: int, r: int) -> torch.Tensor:
    """Rank ``r``'s part of ``t`` out of ``n`` under the rule ``kind``."""

    if kind == "geglu":
        inner = t.shape[0] // 2
        c = inner // n
        return torch.cat([t[r * c:(r + 1) * c], t[inner + r * c: inner + (r + 1) * c]])
    dim = 0 if kind == "column" else 1
    c = t.shape[dim] // n
    return t.narrow(dim, r * c, c).clone(memory_format=torch.contiguous_format)


def check_divisible(unet, n: int) -> None:
    """ValueError unless ``n`` divides the head count of every attention
    site of ``unet`` and the inner width of every feed-forward."""

    for name, m in unet.named_modules():
        width = m.heads if isinstance(m, CrossAttention) else (
            m.net[0].proj.weight.shape[0] // 2 if isinstance(m, FeedForward) else None)
        if width is not None and width % n:
            what = "heads" if isinstance(m, CrossAttention) else "feed-forward inner width"
            raise ValueError(f"tensor parallelism over {n} ranks: {name} has {width} {what}, which {n} does not "
                             "divide")


@torch.no_grad()
def tp_shard_unet_(unet, mesh) -> None:
    """Narrow, in place, every split weight of ``unet`` to this rank's part
    over the mesh's ``model`` axis, and switch every transformer site to the
    route outside the kernels on its local heads, reducing over the axis's
    process group. Load or import weights (the adapter too) before this."""

    n, r = mesh.shape["model"], mesh.coords["model"]
    check_divisible(unet, n)
    split = []
    for key, p in unet.named_parameters():
        rule = split_rule(key)
        if rule is not None:
            p.data = shard(p.data, rule[0], n, r)
            split.append(key)
    for m in unet.modules():
        if isinstance(m, (CrossAttention, FeedForward)):
            m.force_xla, m.use_int8, m.tp_group = True, False, mesh.groups["model"]
        if isinstance(m, CrossAttention):
            m.heads //= n
    unet.tp_split = tuple(split)
    unet.drop_graphs()


def count_sharded_leaves(unet) -> int:
    """How many UNet parameters ``tp_shard_unet_`` split."""

    return len(getattr(unet, "tp_split", ()))
