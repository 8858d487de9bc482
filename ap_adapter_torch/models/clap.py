"""CLAP text branch: RoBERTa encoder + pooler + MLP projection + L2 norm.

Counterpart of ``ap_adapter_tpu/models/clap.py`` with HF ``ClapModel`` key
names (``text_model.*``, ``text_projection.linear1/2``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ap_adapter_torch.configs import ClapTextConfig
from ap_adapter_torch.ops.attention import mask_to_bias, sdpa


def roberta_position_ids(input_ids: torch.Tensor, padding_idx: int) -> torch.Tensor:
    """Positions count only non-pad tokens, offset by padding_idx; pads stay at padding_idx."""

    mask = (input_ids != padding_idx).long()
    return torch.cumsum(mask, dim=1) * mask + padding_idx


def _dense(i: int, o: int) -> nn.ModuleDict:
    return nn.ModuleDict({"dense": nn.Linear(i, o)})


class BertLayer(nn.Module):
    """Post-LN BERT layer with HF names (attention.self.query, attention.output.dense, ...)."""

    def __init__(self, c: ClapTextConfig):
        super().__init__()
        d = c.hidden_size
        self.heads = c.num_heads
        self.attention = nn.ModuleDict({
            "self": nn.ModuleDict({n: nn.Linear(d, d) for n in ("query", "key", "value")}),
            "output": nn.ModuleDict({"dense": nn.Linear(d, d),
                                     "LayerNorm": nn.LayerNorm(d, eps=c.layer_norm_eps)}),
        })
        self.intermediate = _dense(d, c.intermediate_size)
        self.output = nn.ModuleDict({"dense": nn.Linear(c.intermediate_size, d),
                                     "LayerNorm": nn.LayerNorm(d, eps=c.layer_norm_eps)})

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        h = self.heads
        sa = self.attention["self"]
        q, k, v = (sa[name](x).reshape(b, n, h, d // h) for name in ("query", "key", "value"))
        attn = sdpa(q, k, v, mask=bias).reshape(b, n, d)
        ao = self.attention["output"]
        x = ao["LayerNorm"](x + ao["dense"](attn))
        y = F.gelu(self.intermediate["dense"](x))
        return self.output["LayerNorm"](x + self.output["dense"](y))


class ClapTextEncoder(nn.Module):
    """input_ids [B, S] (+ mask) -> L2-normalised text features [B, projection_dim]."""

    def __init__(self, config: ClapTextConfig = ClapTextConfig()):
        super().__init__()
        c = self.config = config
        d = c.hidden_size
        self.text_model = nn.ModuleDict({
            "embeddings": nn.ModuleDict({
                "word_embeddings": nn.Embedding(c.vocab_size, d),
                "position_embeddings": nn.Embedding(c.max_position_embeddings, d),
                "token_type_embeddings": nn.Embedding(c.type_vocab_size, d),
                "LayerNorm": nn.LayerNorm(d, eps=c.layer_norm_eps),
            }),
            "encoder": nn.ModuleDict({"layer": nn.ModuleList([BertLayer(c) for _ in range(c.num_layers)])}),
            "pooler": _dense(d, d),
        })
        self.text_projection = nn.ModuleDict({
            "linear1": nn.Linear(d, c.projection_dim),
            "linear2": nn.Linear(c.projection_dim, c.projection_dim),
        })

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.config
        tm = self.text_model
        emb = tm["embeddings"]
        if attention_mask is None:
            attention_mask = (input_ids != c.pad_token_id).long()
        pos = roberta_position_ids(input_ids, c.pad_token_id)
        x = (emb["word_embeddings"](input_ids) + emb["token_type_embeddings"](torch.zeros_like(input_ids))
             + emb["position_embeddings"](pos))
        x = emb["LayerNorm"](x)
        bias = mask_to_bias(attention_mask)
        for layer in tm["encoder"]["layer"]:
            x = layer(x, bias)
        pooled = torch.tanh(tm["pooler"]["dense"](x[:, 0]))
        proj = self.text_projection
        y = proj["linear2"](F.relu(proj["linear1"](pooled))).float()
        return (y / y.norm(dim=-1, keepdim=True).clamp_min(1e-12)).to(x.dtype)
