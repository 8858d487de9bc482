"""MusicGen decoder with transformers' ``MusicgenForCausalLM`` key names, and
its static decode cache.

The decoder (Copet et al., arXiv 2306.05284; transformers'
``models/musicgen/modeling_musicgen.py``): the sum of one embedding a
codebook plus a sinusoidal position (cos half first), pre-LN blocks of
causal self-attention, cross-attention to the projected text states and a
GELU (erf) feed-forward, none with a projection bias, a final LayerNorm and
one LM head a codebook.

A decode step writes its keys and values into ``DecodeState``, a cache
allocated once at its full length, at the position the device holds
(``DecodeState.pos``), attends over the whole cache under a mask of the
positions not yet written, and advances the position. Nothing of the step
lives on the host, so a CUDA forward under ``no_grad`` replays one captured
graph at every step (``models/graphs.py``): the cache, the hoisted cross
K/V and the position are ``StaticBuffers``, never copied in. The cross
sublayer is K2 (``ops/fused_cross.py``) on the card, over the K/V that
``models/hoist.py::precompute_decoder_cross_kv`` wrote once a call.

The delay pattern (transformers' ``build_delay_pattern_mask``): codebook k
lags by k positions, position 0 is the BOS, so ``frames`` codes take
``frames + num_codebooks`` positions and ``frames + num_codebooks - 1``
decoder forwards.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ap_adapter_torch.configs import MusicGenDecoderConfig
from ap_adapter_torch.models.graphs import GraphedModule, StaticBuffers
from ap_adapter_torch.ops.cuda_kernels import DECODE_FORWARDS
from ap_adapter_torch.ops.fused_cross import fused_ln_cross_attention_kv


def sinusoidal_table(n: int, dim: int) -> torch.Tensor:
    """transformers' ``MusicgenSinusoidalPositionalEmbedding.get_embedding``:
    [n, dim] float32, cos half first, computed on the CPU."""

    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.int64).float() * -(math.log(10000) / (half - 1)))
    ang = torch.arange(n, dtype=torch.int64).float()[:, None] * freq[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=1)


def delay_pattern_mask(codebooks: int, length: int, device=None) -> torch.Tensor:
    """[codebooks, length] bool, True where the delay pattern holds the pad:
    position j of codebook k is a pad for j <= k and for j >= length -
    codebooks + 1 + k."""

    j = torch.arange(length, device=device)[None]
    k = torch.arange(codebooks, device=device)[:, None]
    return (j <= k) | (j >= length - codebooks + 1 + k)


def revert_delay_pattern(seq: torch.Tensor) -> torch.Tensor:
    """The codes of a sequence in the delay pattern: [B, K, L] -> [B, K, L - K],
    codebook k's from positions k + 1 .. k + L - K."""

    k, n = seq.shape[1], seq.shape[2] - seq.shape[1]
    return torch.stack([seq[:, i, i + 1: i + 1 + n] for i in range(k)], dim=1)


class DecodeState(StaticBuffers):
    """The decode loop's buffers for ``rows`` rows, allocated once at their
    full sizes: the self-attention cache ``k``/``v`` [L, rows, heads,
    length, d], the cross K/V [L, rows, text, C] and their padding bias
    [rows, text] (fp32, -10000 at padding), the next position ``pos`` [1]
    (int64, on the device), the position table [length, C], the positions
    ``key_pos`` [length] and a zero bias [C] for the cross sublayer's
    output projection, which has none."""

    def __init__(self, c: MusicGenDecoderConfig, rows: int, length: int, text: int, device, dtype):
        heads, d = c.num_attention_heads, c.hidden_size // c.num_attention_heads
        shape = (c.num_hidden_layers, rows, heads, length, d)
        self.rows, self.length, self.text = rows, length, text
        self.k = torch.zeros(shape, device=device, dtype=dtype)
        self.v = torch.zeros(shape, device=device, dtype=dtype)
        self.cross_k = torch.zeros(c.num_hidden_layers, rows, text, c.hidden_size, device=device, dtype=dtype)
        self.cross_v = torch.zeros_like(self.cross_k)
        self.cross_bias = torch.zeros(rows, text, device=device, dtype=torch.float32)
        self.pos = torch.zeros(1, device=device, dtype=torch.int64)
        self.pos_table = sinusoidal_table(length, c.hidden_size).to(device=device, dtype=dtype)
        self.key_pos = torch.arange(length, device=device)
        self.zero_bias = torch.zeros(c.hidden_size, device=device, dtype=dtype)

    def tensors(self) -> Sequence[torch.Tensor]:
        return (self.k, self.v, self.cross_k, self.cross_v, self.cross_bias, self.pos, self.pos_table, self.key_pos,
                self.zero_bias)

    def matches(self, rows: int, length: int, text: int, device, dtype) -> bool:
        return ((self.rows, self.length, self.text, self.k.dtype) == (rows, length, text, dtype)
                and self.k.device == torch.device(device))


class MusicgenAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.k_proj = nn.Linear(dim, dim, bias=False)
        self.v_proj = nn.Linear(dim, dim, bias=False)
        self.q_proj = nn.Linear(dim, dim, bias=False)
        self.out_proj = nn.Linear(dim, dim, bias=False)


class MusicgenDecoderLayer(nn.Module):
    def __init__(self, c: MusicGenDecoderConfig):
        super().__init__()
        dim = c.hidden_size
        self.self_attn = MusicgenAttention(dim)
        self.self_attn_layer_norm = nn.LayerNorm(dim, eps=c.layer_norm_eps)
        self.encoder_attn = MusicgenAttention(dim)
        self.encoder_attn_layer_norm = nn.LayerNorm(dim, eps=c.layer_norm_eps)
        self.fc1 = nn.Linear(dim, c.ffn_dim, bias=False)
        self.fc2 = nn.Linear(c.ffn_dim, dim, bias=False)
        self.final_layer_norm = nn.LayerNorm(dim, eps=c.layer_norm_eps)


class MusicgenDecoder(nn.Module):
    def __init__(self, c: MusicGenDecoderConfig):
        super().__init__()
        self.embed_tokens = nn.ModuleList([nn.Embedding(c.vocab_size + 1, c.hidden_size)
                                           for _ in range(c.num_codebooks)])
        self.layers = nn.ModuleList([MusicgenDecoderLayer(c) for _ in range(c.num_hidden_layers)])
        self.layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)


def _residual_linear(x: torch.Tensor, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x + h W^T in one product (the residual as its addend)."""

    return torch.addmm(x.reshape(-1, x.shape[-1]), h.reshape(-1, w.shape[1]), w.t()).view(x.shape)


class MusicgenForCausalLM(GraphedModule):
    """The decoder and its LM heads: tokens [R, K, T] at the state's
    position -> logits [R, K, T, V]."""

    def __init__(self, config: MusicGenDecoderConfig = MusicGenDecoderConfig()):
        super().__init__()
        self.config = config
        self.model = nn.ModuleDict({"decoder": MusicgenDecoder(config)})
        self.lm_heads = nn.ModuleList([nn.Linear(config.hidden_size, config.vocab_size, bias=False)
                                       for _ in range(config.num_codebooks)])

    def forward(self, tokens: torch.Tensor, state: DecodeState) -> torch.Tensor:
        """Logits of positions ``state.pos`` .. + T - 1 from their tokens, the
        tokens' keys and values written into the cache, and ``state.pos``
        advanced by T. A CUDA forward under ``no_grad`` replays a captured
        graph: one for every step of a loop over one state."""

        capturable = tokens.is_cuda and not torch.is_grad_enabled()
        return self.graphed((tokens, state), 0.0, tokens.device, capturable, self._forward, DECODE_FORWARDS,
                            "ap.musicgen.replay")

    def _forward(self, tokens: torch.Tensor, state: DecodeState) -> torch.Tensor:
        c = self.config
        dec = self.model["decoder"]
        r, k, t = tokens.shape
        heads, d = c.num_attention_heads, c.hidden_size // c.num_attention_heads
        length = state.length
        positions = state.pos + torch.arange(t, device=tokens.device)
        x = dec.embed_tokens[0](tokens[:, 0])
        for i in range(1, k):
            x = x + dec.embed_tokens[i](tokens[:, i])
        x = x + state.pos_table.index_select(0, positions)[None]
        # the causal mask over the whole cache: -inf past each query's position
        bias = torch.zeros(t, length, device=x.device, dtype=x.dtype).masked_fill_(
            state.key_pos[None] > positions[:, None], float("-inf"))
        bias = bias.expand(r * heads, t, length)
        for li, layer in enumerate(dec.layers):
            a = layer.self_attn
            ln = layer.self_attn_layer_norm
            h = F.layer_norm(x, (c.hidden_size,), ln.weight, ln.bias, ln.eps)
            q = (F.linear(h, a.q_proj.weight) * d ** -0.5).view(r, t, heads, d).transpose(1, 2)
            kc, vc = state.k[li], state.v[li]
            kc.index_copy_(2, positions, F.linear(h, a.k_proj.weight).view(r, t, heads, d).transpose(1, 2))
            vc.index_copy_(2, positions, F.linear(h, a.v_proj.weight).view(r, t, heads, d).transpose(1, 2))
            scores = torch.baddbmm(bias, q.reshape(r * heads, t, d), kc.view(r * heads, length, d).transpose(1, 2))
            o = torch.bmm(torch.softmax(scores, dim=-1), vc.view(r * heads, length, d))
            x = _residual_linear(x, o.view(r, heads, t, d).transpose(1, 2), a.out_proj.weight)

            e, ln = layer.encoder_attn, layer.encoder_attn_layer_norm
            x = fused_ln_cross_attention_kv(x, state.cross_k[li], state.cross_v[li], ln.weight, ln.bias, e.q_proj.weight,
                      e.out_proj.weight, state.zero_bias, heads, bias=state.cross_bias, eps=ln.eps)

            ln = layer.final_layer_norm
            h = F.gelu(F.linear(F.layer_norm(x, (c.hidden_size,), ln.weight, ln.bias, ln.eps), layer.fc1.weight))
            x = _residual_linear(x, h, layer.fc2.weight)
        ln = dec.layer_norm
        h = F.layer_norm(x, (c.hidden_size,), ln.weight, ln.bias, ln.eps)
        logits = torch.stack([F.linear(h, head.weight) for head in self.lm_heads], dim=1)
        state.pos.add_(t)
        return logits

