"""GPT-2 "language of audio" model and its hidden-state generation loop.

Counterpart of ``ap_adapter_tpu/models/gpt2.py`` with HF ``GPT2Model`` key
names (Conv1D weights stored [in, out]). The generation feeds each step's last
hidden state back as the next input embedding over a preallocated KV cache.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ap_adapter_torch.configs import GPT2Config
from ap_adapter_torch.ops.attention import sdpa
from ap_adapter_torch.utils import trace

Cache = Tuple[torch.Tensor, torch.Tensor]  # k, v: [B, L, H, dk]


class Conv1D(nn.Module):
    """HF GPT-2 Conv1D: y = x @ W + b with W stored [in, out]."""

    def __init__(self, nin: int, nout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(nin, nout))
        self.bias = nn.Parameter(torch.zeros(nout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.t(), self.bias)


class GPT2Attention(nn.Module):
    def __init__(self, c: GPT2Config):
        super().__init__()
        self.heads = c.n_head
        self.c_attn = Conv1D(c.n_embd, 3 * c.n_embd)
        self.c_proj = Conv1D(c.n_embd, c.n_embd)

    def forward(self, x, bias, cache: Optional[Cache] = None, cache_index: int = 0):
        b, s, d = x.shape
        h = self.heads
        q, k, v = (t.reshape(b, s, h, d // h) for t in self.c_attn(x).split(d, dim=-1))
        if cache is not None:
            ck, cv = cache
            ck[:, cache_index:cache_index + s] = k.to(ck.dtype)
            cv[:, cache_index:cache_index + s] = v.to(cv.dtype)
            k, v = ck, cv
        return self.c_proj(sdpa(q, k, v, bias).reshape(b, s, d))


class GPT2Block(nn.Module):
    def __init__(self, c: GPT2Config):
        super().__init__()
        self.ln_1 = nn.LayerNorm(c.n_embd, eps=c.layer_norm_eps)
        self.attn = GPT2Attention(c)
        self.ln_2 = nn.LayerNorm(c.n_embd, eps=c.layer_norm_eps)
        self.mlp = nn.ModuleDict({"c_fc": Conv1D(c.n_embd, 4 * c.n_embd),
                                  "c_proj": Conv1D(4 * c.n_embd, c.n_embd)})

    def forward(self, x, bias, cache=None, cache_index: int = 0):
        x = x + self.attn(self.ln_1(x), bias, cache, cache_index)
        y = F.gelu(self.mlp["c_fc"](self.ln_2(x)), approximate="tanh")
        return x + self.mlp["c_proj"](y)


class GPT2Model(nn.Module):
    """Hidden-state GPT-2 over input embeddings (no token embedding table)."""

    def __init__(self, config: GPT2Config = GPT2Config()):
        super().__init__()
        c = self.config = config
        self.wpe = nn.Embedding(c.n_positions, c.n_embd)
        self.h = nn.ModuleList([GPT2Block(c) for _ in range(c.n_layer)])
        self.ln_f = nn.LayerNorm(c.n_embd, eps=c.layer_norm_eps)

    def forward(self, inputs_embeds: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                position_offset: int = 0, caches: Optional[List[Cache]] = None,
                cache_index: int = 0) -> torch.Tensor:
        """inputs_embeds [B, S, D]; attention_mask [B, L] over the KV length
        (L == S without a cache). Caches are written in place."""

        b, s, _ = inputs_embeds.shape
        dev = inputs_embeds.device
        positions = torch.arange(s, device=dev) + position_offset
        x = inputs_embeds.to(self.ln_f.weight.dtype) + self.wpe(positions)[None]
        kv_len = caches[0][0].shape[1] if caches is not None else s
        fmin = torch.finfo(torch.float32).min
        causal = torch.arange(kv_len, device=dev)[None, :] <= positions[:, None]
        bias = torch.where(causal, 0.0, fmin)[None, None]
        if attention_mask is not None:
            bias = bias + ((1.0 - attention_mask.float()) * fmin)[:, None, None, :]
        for i, blk in enumerate(self.h):
            x = blk(x, bias, caches[i] if caches is not None else None, cache_index)
        return self.ln_f(x)


@torch.no_grad()
def generate_hidden_states(model: GPT2Model, inputs_embeds: torch.Tensor,
                           attention_mask: Optional[torch.Tensor] = None,
                           max_new_tokens: Optional[int] = None) -> torch.Tensor:
    """Autoregressive hidden-state generation: returns [B, max_new_tokens, D] =
    [prefill_last, decode_1, ..., decode_{n-1}] (n - 1 decode forwards)."""

    c = model.config
    steps = max_new_tokens or c.max_new_tokens
    b, s0, d = inputs_embeds.shape
    dev = inputs_embeds.device
    with trace.span("ap.gpt2"):
        caches = [tuple(torch.zeros(b, s0 + steps, c.n_head, d // c.n_head, dtype=inputs_embeds.dtype,
                                    device=dev) for _ in range(2)) for _ in range(c.n_layer)]
        mask0 = attention_mask if attention_mask is not None else torch.ones(b, s0, dtype=torch.int32, device=dev)
        mask = torch.cat([mask0.int(), torch.zeros(b, steps, dtype=torch.int32, device=dev)], dim=1)
        last = model(inputs_embeds, mask, 0, caches, 0)[:, -1:]
        outs = [last[:, 0]]
        for i in range(steps - 1):
            mask[:, s0 + i] = 1
            last = model(last, mask, s0 + i, caches, s0 + i)
            outs.append(last[:, 0])
        return torch.stack(outs, dim=1)
