"""Adapter (decoupled audio-KV) parameters of the port's UNet.

Counterpart of ``ap_adapter_tpu/adapter/params.py``. The trainable surface is
the 32 pairs of ``to_k_ip``/``to_v_ip`` matrices at the UNet's adapter sites.
The port's UNet already carries the reference's torch names, so a site is its
state-dict prefix and the flat checkpoint keys are
``<site>.processor.to_{k,v}_ip.weight`` (Linear layout [out, in]).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ap_adapter_torch.configs import UNetConfig

NAMES = ("to_k_ip", "to_v_ip")


def adapter_sites(config: UNetConfig) -> List[str]:
    """The adapted attn2 prefixes, e.g.
    ``down_blocks.1.attentions.1.transformer_blocks.0.attn2``, in the JAX
    package's order."""

    n_dims = len(config.cross_attention_dims)
    idxs = [i for i, d in enumerate(config.cross_attention_dims)
            if d is not None and d == config.adapter_cross_attention_dim]
    sites = []

    def add(block: str, layer: int):
        for g in idxs:
            for t in range(config.transformer_layers_per_block):
                sites.append(f"{block}.attentions.{layer * n_dims + g}.transformer_blocks.{t}.attn2")

    n_blocks = len(config.block_out_channels)
    for b in range(n_blocks):
        if config.down_block_has_attn[b]:
            for l in range(config.layers_per_block):
                add(f"down_blocks.{b}", l)
    add("mid_block", 0)
    for b in range(n_blocks):
        if config.up_block_has_attn[b]:
            for l in range(config.layers_per_block + 1):
                add(f"up_blocks.{b}", l)
    return sites


def adapter_parameters(unet) -> Dict[str, torch.nn.Parameter]:
    """{flat key: parameter} of every adapter matrix of ``unet``."""

    return {f"{site}.processor.{nm}.weight": getattr(unet.get_submodule(f"{site}.processor"), nm).weight
            for site in adapter_sites(unet.config) for nm in NAMES}


def export_flat_adapter(unet) -> Dict[str, np.ndarray]:
    """The reference-format flat adapter dict (fp32 numpy, [out, in])."""

    return {k: p.detach().float().cpu().numpy() for k, p in adapter_parameters(unet).items()}


@torch.no_grad()
def import_flat_adapter(unet, flat: Dict[str, np.ndarray]) -> None:
    """Copy a reference-format flat adapter dict into ``unet`` in place (keys
    with or without ``.processor``, as the reference writes both)."""

    for key, p in adapter_parameters(unet).items():
        value = flat[key] if key in flat else flat[key.replace(".processor.", ".")]
        p.copy_(torch.as_tensor(np.asarray(value)))


@torch.no_grad()
def init_adapter_from_text_kv(unet) -> None:
    """Zero-delta init: each site's to_k_ip/to_v_ip := its frozen to_k/to_v
    (the reference's copy_weight.py)."""

    for site in adapter_sites(unet.config):
        attn = unet.get_submodule(site)
        attn.processor.to_k_ip.weight.copy_(attn.to_k.weight)
        attn.processor.to_v_ip.weight.copy_(attn.to_v.weight)
