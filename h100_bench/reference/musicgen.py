"""The float32 reference of MusicGen text-to-music: T5, ``enc_to_dec_proj``,
the decoder as one full causal forward (no cache, no batching tricks) and
EnCodec's decoder, in plain PyTorch under transformers' key names, written
from transformers 4.57's ``models/musicgen/modeling_musicgen.py``,
``models/encodec/modeling_encodec.py`` and ``models/t5/modeling_t5.py``.
It imports nothing but torch and numpy; the benchmark's check and the
port's CPU tests (``tests/test_torch_musicgen*.py``) both import it.

Departures from transformers' code, none of which moves a number:
* padding masks add -10000 (transformers adds the dtype's least value): a
  masked key's weight is 0 in float32 either way, and a row whose keys are
  all masked (the CFG null rows) attends to values that are exactly 0;
* weight norm is computed in the forward from ``original0`` (g) and
  ``original1`` (v) as g v / ||v||, the norm over every dimension but the
  first, as ``torch.nn.utils.parametrizations.weight_norm`` does;
* the codebooks' ``embed`` is a parameter (a buffer there), and the
  quantizer's other buffers and EnCodec's encoder are left out;
* T5's tied ``encoder.embed_tokens`` copy of ``shared`` is left out.

A configuration is a dict of groups ``t5``, ``decoder`` and ``encodec``
whose keys are ``ap_adapter_torch.configs``' field names.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

NAMES = ("t5", "enc_to_dec_proj", "decoder", "encodec")


def full_precision() -> None:
    """Float32 matrix products and convolutions without TF32."""

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def attention(q, k, v, bias=None, scale=None):
    """softmax(q k^T * scale + bias) v over q [B, Sq, H, D], k/v [B, Sk, H, D]."""

    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if bias is not None:
        logits = logits + bias
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)


def padding_bias(mask):
    """[B, Sk] {0, 1} -> [B, 1, 1, Sk], -10000 at padding."""

    return ((1.0 - mask.float()) * -10000.0)[:, None, None, :]


# -- T5 encoder -----------------------------------------------------------------


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        return self.weight * x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps)


def t5_buckets(n: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """Bidirectional relative-position buckets [n, n]."""

    rel = np.arange(n)[None, :] - np.arange(n)[:, None]
    num_buckets //= 2
    out = (rel > 0).astype(np.int64) * num_buckets
    rp = np.abs(rel)
    exact = num_buckets // 2
    large = exact + (np.log(np.maximum(rp, 1) / exact) / np.log(max_distance / exact)
                     * (num_buckets - exact)).astype(np.int64)
    return out + np.where(rp < exact, rp, np.minimum(large, num_buckets - 1))


class T5Block(nn.Module):
    def __init__(self, c: dict, relative: bool):
        super().__init__()
        inner = c["num_heads"] * c["d_kv"]
        attn = nn.ModuleDict({n: nn.Linear(c["d_model"], inner, bias=False) for n in ("q", "k", "v")})
        attn["o"] = nn.Linear(inner, c["d_model"], bias=False)
        if relative:
            attn["relative_attention_bias"] = nn.Embedding(c["relative_attention_num_buckets"], c["num_heads"])
        if c["feed_forward_proj"] == "gated-gelu":
            ff = {n: nn.Linear(c["d_model"], c["d_ff"], bias=False) for n in ("wi_0", "wi_1")}
        else:
            ff = {"wi": nn.Linear(c["d_model"], c["d_ff"], bias=False)}
        ff["wo"] = nn.Linear(c["d_ff"], c["d_model"], bias=False)
        eps = c["layer_norm_eps"]
        self.layer = nn.ModuleList([nn.ModuleDict({"layer_norm": RMSNorm(c["d_model"], eps), "SelfAttention": attn}),
                                    nn.ModuleDict({"layer_norm": RMSNorm(c["d_model"], eps),
                                                   "DenseReluDense": nn.ModuleDict(ff)})])

    def forward(self, x, bias, heads: int):
        a, f = self.layer
        y, sa = a["layer_norm"](x), a["SelfAttention"]
        b, n, _ = x.shape
        q, k, v = (sa[m](y).reshape(b, n, heads, -1) for m in ("q", "k", "v"))
        x = x + sa["o"](attention(q, k, v, bias, scale=1.0).reshape(b, n, -1))          # T5 scores are unscaled
        ff, y = f["DenseReluDense"], f["layer_norm"](x)
        h = F.gelu(ff["wi_0"](y), approximate="tanh") * ff["wi_1"](y) if "wi_0" in ff else F.relu(ff["wi"](y))
        return x + ff["wo"](h)


class T5(nn.Module):
    """ids, mask [B, S] -> last hidden states [B, S, d_model]; block 0 holds
    the relative-position table every block adds to its scores."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        self.shared = nn.Embedding(c["vocab_size"], c["d_model"])
        self.encoder = nn.ModuleDict({
            "block": nn.ModuleList([T5Block(c, i == 0) for i in range(c["num_layers"])]),
            "final_layer_norm": RMSNorm(c["d_model"], c["layer_norm_eps"])})

    def forward(self, ids, mask):
        c = self.c
        n = ids.shape[1]
        buckets = torch.as_tensor(t5_buckets(n, c["relative_attention_num_buckets"],
                                             c["relative_attention_max_distance"]), device=ids.device)
        table = self.encoder["block"][0].layer[0]["SelfAttention"]["relative_attention_bias"]
        bias = table(buckets).permute(2, 0, 1)[None] + padding_bias(mask)
        x = self.shared(ids)
        for blk in self.encoder["block"]:
            x = blk(x, bias, c["num_heads"])
        return self.encoder["final_layer_norm"](x)


# -- the decoder ----------------------------------------------------------------


def sinusoids(n: int, dim: int) -> torch.Tensor:
    """[n, dim] float32, cos half first (computed on the CPU)."""

    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.int64).float() * -(math.log(10000) / (half - 1)))
    ang = torch.arange(n, dtype=torch.int64).float()[:, None] * freq[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=1)


def _attn_projections(dim: int) -> nn.ModuleDict:
    return nn.ModuleDict({n: nn.Linear(dim, dim, bias=False) for n in ("k_proj", "v_proj", "q_proj", "out_proj")})


class DecoderLayer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        dim, eps = c["hidden_size"], c["layer_norm_eps"]
        self.self_attn = _attn_projections(dim)
        self.self_attn_layer_norm = nn.LayerNorm(dim, eps=eps)
        self.encoder_attn = _attn_projections(dim)
        self.encoder_attn_layer_norm = nn.LayerNorm(dim, eps=eps)
        self.fc1 = nn.Linear(dim, c["ffn_dim"], bias=False)
        self.fc2 = nn.Linear(c["ffn_dim"], dim, bias=False)
        self.final_layer_norm = nn.LayerNorm(dim, eps=eps)

    @staticmethod
    def attend(p: nn.ModuleDict, x, ctx, bias, heads: int):
        b, n, _ = x.shape
        q = p["q_proj"](x).reshape(b, n, heads, -1)
        k, v = (p[m](ctx).reshape(b, ctx.shape[1], heads, -1) for m in ("k_proj", "v_proj"))
        return p["out_proj"](attention(q, k, v, bias).reshape(b, n, -1))

    def forward(self, x, causal, states, cross_bias, heads: int):
        h = self.self_attn_layer_norm(x)
        x = x + self.attend(self.self_attn, h, h, causal, heads)
        x = x + self.attend(self.encoder_attn, self.encoder_attn_layer_norm(x), states, cross_bias, heads)
        return x + self.fc2(F.gelu(self.fc1(self.final_layer_norm(x))))


class Decoder(nn.Module):
    """``MusicgenForCausalLM``: ids [R, K, T] (positions 0 .. T-1), the
    projected text states [R, S, C] and their mask [R, S] -> logits
    [R, K, T, V], one full causal forward."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        dim = c["hidden_size"]
        self.model = nn.ModuleDict({"decoder": nn.ModuleDict({
            "embed_tokens": nn.ModuleList([nn.Embedding(c["vocab_size"] + 1, dim) for _ in range(c["num_codebooks"])]),
            "layers": nn.ModuleList([DecoderLayer(c) for _ in range(c["num_hidden_layers"])]),
            "layer_norm": nn.LayerNorm(dim, eps=c["layer_norm_eps"])})})
        self.lm_heads = nn.ModuleList([nn.Linear(dim, c["vocab_size"], bias=False) for _ in range(c["num_codebooks"])])

    def forward(self, ids, states, mask):
        dec = self.model["decoder"]
        n = ids.shape[-1]
        x = sum(emb(ids[:, k]) for k, emb in enumerate(dec["embed_tokens"]))
        x = x + sinusoids(n, self.c["hidden_size"]).to(x.device)[None]
        causal = torch.full((n, n), float("-inf"), device=x.device).triu(1)
        for layer in dec["layers"]:
            x = layer(x, causal, states, padding_bias(mask), self.c["num_attention_heads"])
        h = dec["layer_norm"](x)
        return torch.stack([head(h) for head in self.lm_heads], dim=1)


# -- EnCodec's decoder ----------------------------------------------------------


class _WeightNorm(nn.Module):
    def __init__(self, shape: Tuple[int, ...]):
        super().__init__()
        self.original0 = nn.Parameter(torch.ones(shape[0], *([1] * (len(shape) - 1))))
        self.original1 = nn.Parameter(torch.zeros(shape))


class WNConv(nn.Module):
    """A weight-normed convolution (``transposed``: a transposed one of
    stride ``stride``), under the keys ``parametrizations.weight.original0``
    / ``original1`` and ``bias``."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, dilation: int = 1, transposed=False):
        super().__init__()
        self.parametrizations = nn.ModuleDict({"weight": _WeightNorm((cin, cout, kernel) if transposed
                                                                      else (cout, cin, kernel))})
        self.bias = nn.Parameter(torch.zeros(cout))
        self.kernel, self.stride, self.dilation, self.transposed = kernel, stride, dilation, transposed

    def weight(self):
        p = self.parametrizations["weight"]
        return p.original0 * p.original1 / p.original1.norm(dim=(1, 2), keepdim=True)

    def forward(self, x):
        if self.transposed:
            return F.conv_transpose1d(x, self.weight(), self.bias, stride=self.stride)
        return F.conv1d(x, self.weight(), self.bias, dilation=self.dilation)


def reflect_pad(x, left: int, right: int):
    extra = max(0, max(left, right) - x.shape[-1] + 1)
    x = F.pad(x, (0, extra)) if extra else x
    out = F.pad(x, (left, right), mode="reflect")
    return out[..., : out.shape[-1] - extra]


class Conv(nn.Module):
    """Stride-1 convolution padded to keep the length (right gets the smaller half)."""

    def __init__(self, cin: int, cout: int, kernel: int, dilation: int = 1):
        super().__init__()
        self.conv = WNConv(cin, cout, kernel, dilation=dilation)
        self.total = (kernel - 1) * dilation

    def forward(self, x):
        return self.conv(reflect_pad(x, self.total - self.total // 2, self.total // 2))


class ConvT(nn.Module):
    def __init__(self, cin: int, cout: int, ratio: int):
        super().__init__()
        self.conv = WNConv(cin, cout, 2 * ratio, stride=ratio, transposed=True)
        self.total = ratio

    def forward(self, x):
        y = self.conv(x)
        right = self.total // 2
        return y[..., self.total - right: y.shape[-1] - right]


class LSTM(nn.Module):
    def __init__(self, dim: int, layers: int):
        super().__init__()
        self.lstm = nn.LSTM(dim, dim, layers)

    def forward(self, x):
        h = x.permute(2, 0, 1)
        return (self.lstm(h)[0] + h).permute(1, 2, 0)


class ResBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, kernel: int, dilation: int):
        super().__init__()
        self.block = nn.ModuleList([nn.ELU(), Conv(dim, hidden, kernel, dilation), nn.ELU(), Conv(hidden, dim, 1)])

    def forward(self, x):
        h = x
        for layer in self.block:
            h = layer(h)
        return x + h


class Encodec(nn.Module):
    """codes [B, K, frames] -> waveforms [B, samples]: the codebooks' sum,
    then the SEANet decoder."""

    def __init__(self, c: dict):
        super().__init__()
        self.quantizer = nn.ModuleDict({"layers": nn.ModuleList([
            nn.ModuleDict({"codebook": nn.ParameterDict({"embed": nn.Parameter(
                torch.zeros(c["codebook_size"], c["hidden_size"]), requires_grad=False)})})
            for _ in range(c["num_quantizers"])])})
        scale = 2 ** len(c["upsampling_ratios"])
        layers = [Conv(c["hidden_size"], scale * c["num_filters"], c["kernel_size"]),
                  LSTM(scale * c["num_filters"], c["num_lstm_layers"])]
        for ratio in c["upsampling_ratios"]:
            dim = scale * c["num_filters"]
            layers += [nn.ELU(), ConvT(dim, dim // 2, ratio)]
            layers += [ResBlock(dim // 2, dim // 2 // c["compress"], c["residual_kernel_size"],
                                c["dilation_growth_rate"] ** j) for j in range(c["num_residual_layers"])]
            scale //= 2
        layers += [nn.ELU(), Conv(c["num_filters"], c["audio_channels"], c["last_kernel_size"])]
        self.decoder = nn.ModuleDict({"layers": nn.ModuleList(layers)})

    def forward(self, codes):
        x = sum(F.embedding(codes[:, k], q["codebook"]["embed"]) for k, q in enumerate(self.quantizer["layers"]))
        x = x.transpose(1, 2)
        for layer in self.decoder["layers"]:
            x = layer(x)
        return x[:, 0]


# -- the pieces of a call -------------------------------------------------------


def build(config: dict, device) -> Dict[str, nn.Module]:
    """The submodels ``NAMES`` with uninitialised float32 weights on
    ``device`` (load them after). Products then run in float32, TF32 off."""

    full_precision()
    with torch.device("meta"):
        mods = {"t5": T5(config["t5"]),
                "enc_to_dec_proj": nn.Linear(config["t5"]["d_model"], config["decoder"]["hidden_size"]),
                "decoder": Decoder(config["decoder"]), "encodec": Encodec(config["encodec"])}
    return {n: m.to_empty(device=device).float().eval() for n, m in mods.items()}


@torch.no_grad()
def conditioning(models: dict, ids, mask):
    """(states [2B, S, C], mask [2B, S]): the projected T5 states times the
    mask, then the CFG null rows (zero states, zero mask)."""

    states = models["enc_to_dec_proj"](models["t5"](ids, mask)) * mask[..., None].float()
    return torch.cat([states, torch.zeros_like(states)]), torch.cat([mask, torch.zeros_like(mask)])


@torch.no_grad()
def cross_kv(decoder: Decoder, states, layer: int):
    """(k, v) [R, S, C] of one layer's cross-attention over ``states``."""

    p = decoder.model["decoder"]["layers"][layer].encoder_attn
    return p["k_proj"](states), p["v_proj"](states)


def delay_pattern(codes, pad: int):
    """codes [B, K, frames] -> [B, K, frames + K]: codebook k's codes at
    positions k + 1 .. k + frames, ``pad`` elsewhere."""

    b, k, n = codes.shape
    seq = codes.new_full((b, k, n + k), pad)
    for i in range(k):
        seq[:, i, i + 1: i + 1 + n] = codes[:, i]
    return seq


def cfg_scores(logits, guidance: float):
    """logits [2B, ...] (cond rows, then null rows) -> uncond + g (cond - uncond)."""

    cond, uncond = logits.chunk(2)
    return uncond + guidance * (cond - uncond)
