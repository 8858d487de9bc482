"""KL autoencoder over mel spectrograms (diffusers AutoencoderKL names).

Counterpart of ``ap_adapter_tpu/models/vae.py``: the decoder serves
generation, the encoder training (and SDEdit). Public layout NHWC: mel
[B, T, F, 1] <-> latents [B, T/4, F/4, 8].
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ap_adapter_torch.configs import VAEConfig
from ap_adapter_torch.models.unet_blocks import ResnetBlock2D, Upsample2D
from ap_adapter_torch.ops.attention import self_attention


class VAEAttention(nn.Module):
    """Single-head spatial self-attention of the mid block (biased projections,
    residual), through ``self_attention`` as the JAX module does (vae.py:36):
    at S >= 512 positions the K5/K6 kernel."""

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
        out = self_attention(self.to_q(y), self.to_k(y), self.to_v(y)).reshape(b, h * w, c)
        out = self.to_out[0](out).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return out + x


class DownsampleVAE(nn.Module):
    """Stride-2 3x3 conv after diffusers' asymmetric (0, 1) input padding."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Encoder(nn.Module):
    def __init__(self, c: VAEConfig):
        super().__init__()
        ch = c.block_out_channels
        g = c.norm_num_groups
        self.conv_in = nn.Conv2d(c.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        x_ch = ch[0]
        for bi, out_ch in enumerate(ch):
            blk = {"resnets": nn.ModuleList()}
            for _ in range(c.layers_per_block):
                blk["resnets"].append(ResnetBlock2D(x_ch, out_ch, g, 1e-6))
                x_ch = out_ch
            if bi < len(ch) - 1:
                blk["downsamplers"] = nn.ModuleList([DownsampleVAE(out_ch)])
            self.down_blocks.append(nn.ModuleDict(blk))
        mid = {"resnets": nn.ModuleList([ResnetBlock2D(ch[-1], ch[-1], g, 1e-6) for _ in range(2)])}
        if c.mid_block_attention:
            mid["attentions"] = nn.ModuleList([VAEAttention(ch[-1], g)])
        self.mid_block = nn.ModuleDict(mid)
        self.conv_norm_out = nn.GroupNorm(g, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * c.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        x = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk["resnets"]:
                x = res(x)
            if "downsamplers" in blk:
                x = blk["downsamplers"][0](x)
        mid = self.mid_block
        x = mid["resnets"][0](x)
        if "attentions" in mid:
            x = mid["attentions"][0](x)
        x = mid["resnets"][1](x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


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
    """KL autoencoder: ``encode(x, noise)`` gives scaled latents,
    ``decode(z)`` takes latents already divided by ``scaling_factor``."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    def moments(self, x: torch.Tensor):
        """mel [B, T, F, 1] -> (mean, logvar) of the latent distribution, each
        [B, T/4, F/4, C] (NHWC), logvar clipped to [-30, 20]."""

        h = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2).to(self.quant_conv.weight.dtype)))
        mean, logvar = h.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """z = (mean + std * noise) * scaling_factor, with ``noise`` shaped like
        the mean (the caller draws it, so that a test can hand both sides the
        same numbers)."""

        mean, logvar = self.moments(x)
        return (mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)) * self.config.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, T, F, C] -> mel [B, 4T, 4F, 1] (NHWC)."""

        x = z.permute(0, 3, 1, 2).to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(x)).permute(0, 2, 3, 1)
