"""T5 encoder (flan-t5-large) with HF ``T5EncoderModel`` key names.

Counterpart of ``ap_adapter_tpu/models/t5.py``: RMS layer norm in fp32,
unscaled attention scores, the relative-position bias held by block 0 and
shared by all blocks, gated-GELU (tanh) feed-forward.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ap_adapter_torch.configs import T5Config
from ap_adapter_torch.models.layers import RMSNorm
from ap_adapter_torch.ops.attention import mask_to_bias, sdpa


def relative_position_bucket(relative_position: np.ndarray, num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """Bidirectional T5 relative-position bucketing (HF formula)."""

    num_buckets //= 2
    buckets = (relative_position > 0).astype(np.int64) * num_buckets
    rp = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = rp < max_exact
    large = max_exact + (
        np.log(np.maximum(rp, 1) / max_exact) / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)).astype(np.int64)
    large = np.minimum(large, num_buckets - 1)
    return buckets + np.where(is_small, rp, large)


class T5Attention(nn.Module):
    def __init__(self, c: T5Config, has_relative_bias: bool):
        super().__init__()
        self.config = c
        inner = c.num_heads * c.d_kv
        self.q = nn.Linear(c.d_model, inner, bias=False)
        self.k = nn.Linear(c.d_model, inner, bias=False)
        self.v = nn.Linear(c.d_model, inner, bias=False)
        self.o = nn.Linear(inner, c.d_model, bias=False)
        self.relative_attention_bias = (nn.Embedding(c.relative_attention_num_buckets, c.num_heads)
                                        if has_relative_bias else None)

    def position_bias(self, n: int, device) -> torch.Tensor:
        c = self.config
        buckets = relative_position_bucket(np.arange(n)[None, :] - np.arange(n)[:, None],
                                           c.relative_attention_num_buckets,
                                           c.relative_attention_max_distance)
        table = self.relative_attention_bias(torch.as_tensor(buckets, device=device))  # [n, n, h]
        return table.permute(2, 0, 1)[None].float()

    def forward(self, x, mask_bias, position_bias):
        c = self.config
        b, n, _ = x.shape
        q, k, v = (m(x).reshape(b, n, c.num_heads, c.d_kv) for m in (self.q, self.k, self.v))
        if position_bias is None:
            position_bias = self.position_bias(n, x.device)
        bias = position_bias if mask_bias is None else position_bias + mask_bias
        out = sdpa(q, k, v, bias, scale=1.0).reshape(b, n, -1)   # T5 scores are unscaled
        return self.o(out), position_bias


class T5Block(nn.Module):
    def __init__(self, c: T5Config, has_relative_bias: bool):
        super().__init__()
        if c.feed_forward_proj == "gated-gelu":
            ff = {"wi_0": nn.Linear(c.d_model, c.d_ff, bias=False),
                  "wi_1": nn.Linear(c.d_model, c.d_ff, bias=False)}
        else:
            ff = {"wi": nn.Linear(c.d_model, c.d_ff, bias=False)}
        ff["wo"] = nn.Linear(c.d_ff, c.d_model, bias=False)
        self.layer = nn.ModuleList([
            nn.ModuleDict({"layer_norm": RMSNorm(c.d_model, c.layer_norm_eps),
                           "SelfAttention": T5Attention(c, has_relative_bias)}),
            nn.ModuleDict({"layer_norm": RMSNorm(c.d_model, c.layer_norm_eps),
                           "DenseReluDense": nn.ModuleDict(ff)}),
        ])

    def forward(self, x, mask_bias, position_bias):
        attn_l, ff_l = self.layer
        attn, position_bias = attn_l["SelfAttention"](attn_l["layer_norm"](x), mask_bias, position_bias)
        x = x + attn
        y = ff_l["layer_norm"](x)
        ff = ff_l["DenseReluDense"]
        if "wi_0" in ff:
            y = F.gelu(ff["wi_0"](y), approximate="tanh") * ff["wi_1"](y)
        else:
            y = F.relu(ff["wi"](y))
        return x + ff["wo"](y), position_bias


class T5Encoder(nn.Module):
    """input_ids [B, S] (+ mask) -> hidden states [B, S, d_model]."""

    def __init__(self, config: T5Config = T5Config()):
        super().__init__()
        c = self.config = config
        self.shared = nn.Embedding(c.vocab_size, c.d_model)
        self.encoder = nn.ModuleDict({
            "block": nn.ModuleList([T5Block(c, i == 0) for i in range(c.num_layers)]),
            "final_layer_norm": RMSNorm(c.d_model, c.layer_norm_eps),
        })

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.shared(input_ids)
        bias = mask_to_bias(attention_mask)
        position_bias = None
        for blk in self.encoder["block"]:
            x, position_bias = blk(x, bias, position_bias)
        return self.encoder["final_layer_norm"](x)
