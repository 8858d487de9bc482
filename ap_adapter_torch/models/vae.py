"""KL autoencoder over mel spectrograms: the decode half (diffusers AutoencoderKL names).

Counterpart of ``ap_adapter_tpu/models/vae.py``; the encoder (SDEdit,
training) is not ported yet. Public layout NHWC: latents [B, T/4, F/4, 8]
-> mel [B, T, F, 1].
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ap_adapter_torch.configs import VAEConfig
from ap_adapter_torch.models.unet_blocks import ResnetBlock2D, Upsample2D
from ap_adapter_torch.ops.attention import sdpa


class VAEAttention(nn.Module):
    """Single-head spatial self-attention of the mid block (biased projections, residual)."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, 1, c)
        out = sdpa(self.to_q(y), self.to_k(y), self.to_v(y)).reshape(b, h * w, c)
        out = self.to_out[0](out).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return out + x


class Decoder(nn.Module):
    def __init__(self, c: VAEConfig):
        super().__init__()
        ch = list(reversed(c.block_out_channels))
        g = c.norm_num_groups
        self.conv_in = nn.Conv2d(c.latent_channels, ch[0], 3, padding=1)
        mid = {"resnets": nn.ModuleList([ResnetBlock2D(ch[0], ch[0], g, 1e-6) for _ in range(2)])}
        if c.mid_block_attention:
            mid["attentions"] = nn.ModuleList([VAEAttention(ch[0], g)])
        self.mid_block = nn.ModuleDict(mid)
        self.up_blocks = nn.ModuleList()
        x_ch = ch[0]
        for bi, out_ch in enumerate(ch):
            blk = {"resnets": nn.ModuleList()}
            for _ in range(c.layers_per_block + 1):
                blk["resnets"].append(ResnetBlock2D(x_ch, out_ch, g, 1e-6))
                x_ch = out_ch
            if bi < len(ch) - 1:
                blk["upsamplers"] = nn.ModuleList([Upsample2D(out_ch)])
            self.up_blocks.append(nn.ModuleDict(blk))
        self.conv_norm_out = nn.GroupNorm(g, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], c.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:  # NCHW
        x = self.conv_in(z)
        mid = self.mid_block
        x = mid["resnets"][0](x)
        if "attentions" in mid:
            x = mid["attentions"][0](x)
        x = mid["resnets"][1](x)
        for blk in self.up_blocks:
            for res in blk["resnets"]:
                x = res(x)
            if "upsamplers" in blk:
                x = blk["upsamplers"][0](x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """Decode-only KL autoencoder: ``decode(z)`` takes latents already divided
    by ``scaling_factor``."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.decoder = Decoder(config)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, T, F, C] -> mel [B, 4T, 4F, 1] (NHWC)."""

        x = z.permute(0, 3, 1, 2).to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(x)).permute(0, 2, 3, 1)
