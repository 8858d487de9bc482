"""Text conditioning of the reference: CLAP's text tower (RoBERTa, pooler,
projection, L2 norm), the T5 encoder, AudioLDM2's projection model and the
GPT-2 that generates 8 hidden states. Parameter names follow the
transformers / diffusers checkpoints."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from h100_bench.reference.common import RMSNorm, attention, gelu_tanh, padding_bias


def _dense(i, o):
    return nn.ModuleDict({"dense": nn.Linear(i, o)})


class BertLayer(nn.Module):
    def __init__(self, c):
        super().__init__()
        d = c.hidden_size
        self.heads = c.num_heads
        self.attention = nn.ModuleDict({
            "self": nn.ModuleDict({n: nn.Linear(d, d) for n in ("query", "key", "value")}),
            "output": nn.ModuleDict({"dense": nn.Linear(d, d), "LayerNorm": nn.LayerNorm(d, eps=c.layer_norm_eps)}),
        })
        self.intermediate = _dense(d, c.intermediate_size)
        self.output = nn.ModuleDict({"dense": nn.Linear(c.intermediate_size, d),
                                     "LayerNorm": nn.LayerNorm(d, eps=c.layer_norm_eps)})

    def forward(self, x, bias):
        b, n, d = x.shape
        sa = self.attention["self"]
        q, k, v = (sa[m](x).reshape(b, n, self.heads, d // self.heads) for m in ("query", "key", "value"))
        ao = self.attention["output"]
        x = ao["LayerNorm"](x + ao["dense"](attention(q, k, v, bias).reshape(b, n, d)))
        return self.output["LayerNorm"](x + self.output["dense"](F.gelu(self.intermediate["dense"](x))))


class ClapText(nn.Module):
    """ids [B, S], mask -> L2-normalised text embedding [B, projection_dim]."""

    def __init__(self, c):
        super().__init__()
        self.c = c
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
        self.text_projection = nn.ModuleDict({"linear1": nn.Linear(d, c.projection_dim),
                                              "linear2": nn.Linear(c.projection_dim, c.projection_dim)})

    def forward(self, ids, mask):
        pad = self.c.pad_token_id
        keep = (ids != pad).long()
        pos = torch.cumsum(keep, dim=1) * keep + pad           # RoBERTa positions
        emb = self.text_model["embeddings"]
        x = emb["word_embeddings"](ids) + emb["token_type_embeddings"](torch.zeros_like(ids)) \
            + emb["position_embeddings"](pos)
        x = emb["LayerNorm"](x)
        bias = padding_bias(mask)
        for layer in self.text_model["encoder"]["layer"]:
            x = layer(x, bias)
        pooled = torch.tanh(self.text_model["pooler"]["dense"](x[:, 0]))
        p = self.text_projection
        y = p["linear2"](F.relu(p["linear1"](pooled)))
        return y / y.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def t5_buckets(n: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """Bidirectional relative-position buckets [n, n] (transformers' T5)."""

    rel = np.arange(n)[None, :] - np.arange(n)[:, None]
    num_buckets //= 2
    out = (rel > 0).astype(np.int64) * num_buckets
    rp = np.abs(rel)
    exact = num_buckets // 2
    large = exact + (np.log(np.maximum(rp, 1) / exact) / np.log(max_distance / exact)
                     * (num_buckets - exact)).astype(np.int64)
    return out + np.where(rp < exact, rp, np.minimum(large, num_buckets - 1))


class T5Attention(nn.Module):
    def __init__(self, c, relative: bool):
        super().__init__()
        self.c = c
        inner = c.num_heads * c.d_kv
        self.q, self.k, self.v = (nn.Linear(c.d_model, inner, bias=False) for _ in range(3))
        self.o = nn.Linear(inner, c.d_model, bias=False)
        self.relative_attention_bias = nn.Embedding(c.relative_attention_num_buckets, c.num_heads) if relative else None

    def forward(self, x, bias):
        c = self.c
        b, n, _ = x.shape
        q, k, v = (m(x).reshape(b, n, c.num_heads, c.d_kv) for m in (self.q, self.k, self.v))
        return self.o(attention(q, k, v, bias, scale=1.0).reshape(b, n, -1))


class T5Block(nn.Module):
    def __init__(self, c, relative: bool):
        super().__init__()
        self.layer = nn.ModuleList([
            nn.ModuleDict({"layer_norm": RMSNorm(c.d_model, c.layer_norm_eps),
                           "SelfAttention": T5Attention(c, relative)}),
            nn.ModuleDict({"layer_norm": RMSNorm(c.d_model, c.layer_norm_eps),
                           "DenseReluDense": nn.ModuleDict({"wi_0": nn.Linear(c.d_model, c.d_ff, bias=False),
                                                            "wi_1": nn.Linear(c.d_model, c.d_ff, bias=False),
                                                            "wo": nn.Linear(c.d_ff, c.d_model, bias=False)})}),
        ])

    def forward(self, x, bias):
        a, f = self.layer
        x = x + a["SelfAttention"](a["layer_norm"](x), bias)
        ff, y = f["DenseReluDense"], f["layer_norm"](x)
        return x + ff["wo"](gelu_tanh(ff["wi_0"](y)) * ff["wi_1"](y))


class T5(nn.Module):
    """Gated-GELU T5 encoder; block 0 holds the relative-position table that
    every block adds to its unscaled scores."""

    def __init__(self, c):
        super().__init__()
        self.c = c
        self.shared = nn.Embedding(c.vocab_size, c.d_model)
        self.encoder = nn.ModuleDict({
            "block": nn.ModuleList([T5Block(c, i == 0) for i in range(c.num_layers)]),
            "final_layer_norm": RMSNorm(c.d_model, c.layer_norm_eps)})

    def forward(self, ids, mask):
        c = self.c
        n = ids.shape[1]
        buckets = torch.as_tensor(t5_buckets(n, c.relative_attention_num_buckets, c.relative_attention_max_distance),
                                  device=ids.device)
        table = self.encoder["block"][0].layer[0]["SelfAttention"].relative_attention_bias
        bias = table(buckets).permute(2, 0, 1)[None] + padding_bias(mask)
        x = self.shared(ids)
        for blk in self.encoder["block"]:
            x = blk(x, bias)
        return self.encoder["final_layer_norm"](x)


class Projection(nn.Module):
    """AudioLDM2ProjectionModel: both encoders into GPT-2's width, each
    between its own learned SOS and EOS rows."""

    def __init__(self, c):
        super().__init__()
        d = c.language_model_dim
        self.projection = nn.Linear(c.text_encoder_dim, d)
        self.projection_1 = nn.Linear(c.text_encoder_1_dim, d)
        self.sos_embed, self.eos_embed = nn.Parameter(torch.ones(d)), nn.Parameter(torch.ones(d))
        self.sos_embed_1, self.eos_embed_1 = nn.Parameter(torch.ones(d)), nn.Parameter(torch.ones(d))

    def forward(self, clap, t5, t5_mask):
        b = clap.shape[0]

        def wrap(h, sos, eos):
            return torch.cat([sos.expand(b, 1, -1), h, eos.expand(b, 1, -1)], dim=1)

        h = torch.cat([wrap(self.projection(clap), self.sos_embed, self.eos_embed),
                       wrap(self.projection_1(t5), self.sos_embed_1, self.eos_embed_1)], dim=1)
        one = torch.ones(b, 1, dtype=t5_mask.dtype, device=t5_mask.device)
        return h, torch.cat([one, one, one, one, t5_mask, one], dim=1)


class Conv1D(nn.Module):
    """transformers' GPT-2 Conv1D: weight stored [in, out]."""

    def __init__(self, nin, nout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(nin, nout))
        self.bias = nn.Parameter(torch.zeros(nout))

    def forward(self, x):
        return x @ self.weight + self.bias


class GPT2Block(nn.Module):
    def __init__(self, c):
        super().__init__()
        d = c.n_embd
        self.heads = c.n_head
        self.ln_1 = nn.LayerNorm(d, eps=c.layer_norm_eps)
        self.attn = nn.ModuleDict({"c_attn": Conv1D(d, 3 * d), "c_proj": Conv1D(d, d)})
        self.ln_2 = nn.LayerNorm(d, eps=c.layer_norm_eps)
        self.mlp = nn.ModuleDict({"c_fc": Conv1D(d, 4 * d), "c_proj": Conv1D(4 * d, d)})

    def forward(self, x, bias):
        b, s, d = x.shape
        q, k, v = (t.reshape(b, s, self.heads, d // self.heads) for t in self.attn["c_attn"](self.ln_1(x)).split(d, -1))
        x = x + self.attn["c_proj"](attention(q, k, v, bias).reshape(b, s, d))
        return x + self.mlp["c_proj"](gelu_tanh(self.mlp["c_fc"](self.ln_2(x))))


class GPT2(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.c = c
        self.wpe = nn.Embedding(c.n_positions, c.n_embd)
        self.h = nn.ModuleList([GPT2Block(c) for _ in range(c.n_layer)])
        self.ln_f = nn.LayerNorm(c.n_embd, eps=c.layer_norm_eps)

    def forward(self, embeds, mask):
        s = embeds.shape[1]
        dev = embeds.device
        x = embeds + self.wpe(torch.arange(s, device=dev))[None]
        allowed = (torch.arange(s, device=dev)[None, :] <= torch.arange(s, device=dev)[:, None])[None, None] \
            & mask.bool()[:, None, None, :]
        bias = torch.zeros(allowed.shape, device=dev).masked_fill(~allowed, float("-inf"))
        for blk in self.h:
            x = blk(x, bias)
        return self.ln_f(x)

    def generate(self, embeds, mask, steps: int):
        """``steps`` hidden states, each the last position's output fed back as
        the next input; the whole sequence is run again at every step (no
        cache)."""

        outs = []
        for _ in range(steps):
            last = self(embeds, mask)[:, -1:]
            outs.append(last)
            embeds = torch.cat([embeds, last], dim=1)
            mask = torch.cat([mask, torch.ones_like(mask[:, :1])], dim=1)
        return torch.cat(outs, dim=1)
