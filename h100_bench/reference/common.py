"""Shared pieces of the reference: the configuration view, attention, norms
and embeddings."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


class Cfg:
    """Read-only attribute view of one group of a configuration file (JSON
    lists become tuples)."""

    def __init__(self, d: dict):
        for k, v in d.items():
            if isinstance(v, dict):
                v = Cfg(v)
            elif isinstance(v, list):
                v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
            object.__setattr__(self, k, v)

    def __setattr__(self, k, v):
        raise AttributeError("Cfg is read-only")


def full_precision() -> None:
    """Float32 matrix products and convolutions without TF32."""

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def attention(q, k, v, bias: Optional[torch.Tensor] = None, scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v over q [B, Sq, H, D], k/v [B, Sk, H, D];
    ``bias`` broadcasts to [B, H, Sq, Sk]."""

    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if bias is not None:
        logits = logits + bias
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)


def padding_bias(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """[B, Sk] {0, 1} -> [B, 1, 1, Sk] additive bias, -10000 at padding."""

    if mask is None:
        return None
    return ((1.0 - mask.float()) * -10000.0)[:, None, None, :]


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True, shift: float = 0.0) -> torch.Tensor:
    """diffusers ``Timesteps``: [B] -> [B, dim]."""

    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / (half - shift))
    emb = t.float()[:, None] * freqs[None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class RMSNorm(nn.Module):
    """T5 layer norm: no mean subtraction, no bias."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        return self.weight * x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps)


def sincos_2d(dim: int, gh: int, gw: int) -> np.ndarray:
    """MAE's fixed 2-D sin-cos table [1 + gh*gw, dim] with a zero CLS row, as
    the AudioMAE code builds it: a (gh, gw) grid flattened row-major, the
    first half of the channels encoding the column index. AudioMAE calls it
    with (gh, gw) = (freq patches, time patches) while its tokens run
    time-major, and that order is kept here."""

    def one(d, pos):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    cols, rows = np.meshgrid(np.arange(gw, dtype=np.float32), np.arange(gh, dtype=np.float32))
    emb = np.concatenate([one(dim // 2, cols), one(dim // 2, rows)], axis=1)
    return np.concatenate([np.zeros([1, dim]), emb], axis=0).astype(np.float32)


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")
