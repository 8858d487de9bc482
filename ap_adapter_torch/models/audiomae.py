"""AudioMAE ViT-B/16 encoder and the pooled AudioMAE conditioner.

Counterpart of ``ap_adapter_tpu/models/audiomae.py`` (``AudioMAEEncoder``
with its masked-pretraining and contextual-average paths,
``AudioMAECondition``). Parameter names follow the timm/MAE checkpoint
(``patch_embed.proj``, ``blocks.{i}.attn.qkv``, ``blocks.{i}.mlp.fc1`` ...);
the conditioner holds the encoder as ``model``. The pretraining decoder and
the finetuning classifier are in ``models/mae_pretrain.py``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ap_adapter_torch.configs import AudioMAEConfig
from ap_adapter_torch.models.layers import audiomae_pos_embed
from ap_adapter_torch.ops.attention import sdpa
from ap_adapter_torch.ops.pooling import avg_max_pool_tokens


class ViTAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, d // self.heads)
        out = sdpa(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return self.proj(out.reshape(b, n, d))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    """Pre-LN block: x + attn(ln(x)); x + mlp(ln(x))."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float, eps: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = ViTAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, in_chans: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, dim, patch, stride=patch)


class AudioMAEEncoder(nn.Module):
    """fbank [B, T, F] -> tokens [B, 1 + T/16*F/16, D]: patchify, + fixed
    sin-cos positions, CLS, all blocks, final LayerNorm (the reference's
    ``forward_encoder_no_random_mask_no_average``)."""

    def __init__(self, config: AudioMAEConfig = AudioMAEConfig()):
        super().__init__()
        c = self.config = config
        self.patch_embed = PatchEmbed(c.patch_size, c.in_chans, c.embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.embed_dim))
        self.blocks = nn.ModuleList([ViTBlock(c.embed_dim, c.num_heads, c.mlp_ratio, c.layer_norm_eps)
                                     for _ in range(c.depth)])
        self.norm = nn.LayerNorm(c.embed_dim, eps=c.layer_norm_eps)

    def patch_tokens(self, fbank: torch.Tensor) -> tuple:
        """(patch tokens + their positions [B, N, D], the CLS row [B, 1, D])
        in the compute dtype; tokens row-major over (time, freq)."""

        c = self.config
        dtype = self.patch_embed.proj.weight.dtype
        x = self.patch_embed.proj(fbank[:, None].to(dtype))   # [B, D, T', F']
        x = x.flatten(2).transpose(1, 2)
        t, f = c.grid_size
        pos = torch.from_numpy(audiomae_pos_embed(c.embed_dim, (f, t)).copy()).to(x.device)
        cls = (self.cls_token + pos[None, :1]).to(dtype).expand(x.shape[0], -1, -1)
        return x + pos[None, 1:].to(dtype), cls

    def forward(self, fbank: torch.Tensor) -> torch.Tensor:
        x, cls = self.patch_tokens(fbank)
        x = torch.cat([cls, x], dim=1)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)

    def masked(self, fbank: torch.Tensor, ids_keep: torch.Tensor) -> torch.Tensor:
        """The masked-pretraining encode (the reference's ``forward_encoder``):
        only the ``ids_keep`` [B, len_keep] tokens (a plan of
        ``mae_pretrain.random_masking``) go through, behind CLS; final norm.
        Returns [B, 1 + len_keep, D]."""

        x, cls = self.patch_tokens(fbank)
        x = torch.gather(x, 1, ids_keep[..., None].expand(-1, -1, x.shape[-1]))
        x = torch.cat([cls, x], dim=1)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)

    def contextual(self, fbank: torch.Tensor) -> torch.Tensor:
        """The contextual-average path (the reference's
        ``forward_encoder_no_mask``): the mean of the normed activations after
        every block whose index exceeds ``contextual_depth``."""

        x, cls = self.patch_tokens(fbank)
        x = torch.cat([cls, x], dim=1)
        acc, count = torch.zeros_like(x), 0
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i > self.config.contextual_depth:
                acc = acc + self.norm(x)
                count += 1
        return acc / max(count, 1)


class AudioMAECondition(nn.Module):
    """Encode the fbank, drop CLS, and pool the (T/16, F/16) token grid with
    kernel == stride == (time_pool, freq_pool) as (avg + max) / 2."""

    def __init__(self, config: AudioMAEConfig = AudioMAEConfig()):
        super().__init__()
        self.config = config
        self.model = AudioMAEEncoder(config)

    def forward(self, fbank: torch.Tensor, time_pool: int, freq_pool: int) -> torch.Tensor:
        tokens = self.model(fbank)[:, 1:]
        return avg_max_pool_tokens(tokens, self.config.grid_size, time_pool, freq_pool)
