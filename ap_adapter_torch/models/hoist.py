"""Step-invariant work of the denoise loop, computed once per generate call.

Counterpart of ``ap_adapter_tpu/models/hoist.py`` without the TPU's row and
head-lane padding: hoisted K/V stay in the natural ``[B, Sk, heads*d]``
layout that the K2 kernel reads.

* every cross-attention site's K/V (text stream, and the adapter's audio
  stream) for every transformer block, stacked over the blocks: [L, B, Sk, C];
* the T5 stream's additive padding bias [B, S1] (fp32, -10000 on padding);
* the per-resnet time-embedding rows for the whole schedule ([T, C] tables).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ap_adapter_torch.models.layers import get_timestep_embedding
from ap_adapter_torch.models.unet import AudioLDM2UNet


@torch.no_grad()
def precompute_cross_kv(
    unet: AudioLDM2UNet,
    ehs0: torch.Tensor,                   # [B, S0, D0] GPT-2 (+ AudioMAE) stream
    ehs1: torch.Tensor,                   # [B, S1, D1] T5 stream
    t5_mask: Optional[torch.Tensor],      # [B, S1] {0,1} or None
) -> Dict:
    """{group name: {"attentions_{idx}": (k, v, ki, vi)}, "__bias1__": bias or None};
    k/v/ki/vi are [L, B, Sk, C] in the UNet's dtype (ki/vi None where the site
    has no adapter tokens). Refuses a ``cn_text_only`` UNet, as the JAX
    hoist.py:150-153 does: that UNet strips ehs0 to its text tokens after
    this would have projected the whole context."""

    c = unet.config
    if c.cn_text_only:
        raise ValueError("K/V hoisting is not supported for cn_text_only (ControlNet-branch) UNets; "
                         "pass ctx_kv=None")
    dtype = unet.conv_in.weight.dtype
    out: Dict = {"__bias1__": None if t5_mask is None else (1.0 - t5_mask.float()) * -10000.0}
    for name, t2ds in unet.attention_groups():
        entry = {}
        for idx, (t2d, dim) in enumerate(zip(t2ds, c.cross_attention_dims)):
            if dim is None:
                continue
            ctx = (ehs0 if idx <= 1 else ehs1).to(dtype)
            per_block = [blk.attn2.project_kv(ctx) for blk in t2d.transformer_blocks]
            entry[f"attentions_{idx}"] = tuple(
                None if per_block[0][i] is None else torch.stack([p[i] for p in per_block])
                for i in range(4))
        out[name] = entry
    return out


@torch.no_grad()
def precompute_temb_rows(unet: AudioLDM2UNet, timesteps: np.ndarray) -> Dict[str, torch.Tensor]:
    """{resnet name: [T, C]}: silu(time_mlp(sincos(t))) @ W_r + b_r for the
    whole inference schedule (the rows are the same across the batch)."""

    c = unet.config
    dtype = unet.conv_in.weight.dtype
    ts = torch.as_tensor(np.asarray(timesteps), dtype=torch.float32, device=unet.conv_in.weight.device)
    emb = get_timestep_embedding(ts, c.block_out_channels[0], c.flip_sin_to_cos, c.freq_shift).to(dtype)
    st = F.silu(unet.time_embedding(emb))
    return {name: res.time_emb_proj(st) for name, res in unet.resnet_blocks()}
