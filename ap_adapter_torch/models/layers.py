"""Shared model building blocks: positional and timestep embeddings, and the
normalization helpers the ported models share."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


@functools.lru_cache(maxsize=8)
def audiomae_pos_embed(embed_dim: int, grid_hw: tuple[int, int], cls_token: bool = True) -> np.ndarray:
    """Fixed 2-D sin-cos AudioMAE positional table, with the reference's
    meshgrid quirk (``grid_hw`` is (W/16, H/16); the first channel half
    encodes the w values). Read-only: callers copy it into a tensor."""

    gh, gw = grid_hw
    grid_h = np.arange(gh, dtype=np.float32)
    grid_w = np.arange(gw, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)
    grid = np.stack(grid, axis=0).reshape([2, 1, gh, gw])
    emb = np.concatenate([_sincos_1d(embed_dim // 2, grid[0]),
                          _sincos_1d(embed_dim // 2, grid[1])], axis=1)
    if cls_token:
        emb = np.concatenate([np.zeros([1, embed_dim]), emb], axis=0)
    emb = emb.astype(np.float32)
    emb.setflags(write=False)
    return emb


def get_timestep_embedding(
    timesteps: torch.Tensor,
    embedding_dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers ``Timesteps``): [B] -> [B, dim], fp32."""

    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(half_dim, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if embedding_dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


def layer_norm_f32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """LayerNorm with fp32 statistics and affine, returned in x's dtype."""

    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
    return y.to(x.dtype)


class RMSNorm(nn.Module):
    """T5 RMS layer norm (fp32 statistics, no mean subtraction, no bias)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (self.weight.float() * xf).to(x.dtype)


NORM_TYPES = (nn.LayerNorm, nn.GroupNorm, RMSNorm, nn.BatchNorm2d)
