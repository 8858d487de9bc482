"""AudioLDM2 dual-stream conditional UNet (diffusers state-dict names).

Counterpart of ``ap_adapter_tpu/models/unet.py``. The public layout is NHWC
(``[B, T, F, C]`` latents, e.g. ``[B, 250, 16, 8]`` for a 10 s clip); the
convolutions run on NCHW inside. Every attention "layer" is a group of
``len(cross_attention_dims)`` Transformer2DModels over two conditioning
streams, and the decoupled audio-KV adapter lives at the sites whose
cross-attention dim is ``adapter_cross_attention_dim``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ap_adapter_torch.configs import UNetConfig
from ap_adapter_torch.models.layers import get_timestep_embedding
from ap_adapter_torch.models.unet_blocks import (
    Downsample2D,
    ResnetBlock2D,
    Transformer2DModel,
    Upsample2D,
    attention_group,
)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class UNetBlock(nn.Module):
    """One down/mid/up block: resnets, a flat list of Transformer2DModels
    (``attentions.{layer * len(cross_attention_dims) + idx}``) and an
    optional down- or upsampler."""

    def __init__(self, resnets, attentions=(), downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])

    def group(self, layer: int, n: int) -> List[Transformer2DModel]:
        return list(self.attentions[layer * n:(layer + 1) * n])


class AudioLDM2UNet(nn.Module):
    def __init__(self, config: UNetConfig = UNetConfig()):
        super().__init__()
        c = self.config = config
        if c.cn_text_only or c.class_embed_dim is not None:
            raise NotImplementedError("ControlNet-branch and class-embedding UNets are not ported")
        ch = c.block_out_channels
        groups, eps, ted = c.norm_num_groups, c.norm_eps, c.time_embed_dim
        n_dims = len(c.cross_attention_dims)

        def t2d_group(channels):
            return [Transformer2DModel(
                channels, c.num_attention_heads, c.transformer_layers_per_block, dim,
                use_adapter=dim is not None and dim == c.adapter_cross_attention_dim,
                num_ip_tokens=c.adapter_num_tokens, groups=groups)
                for dim in c.cross_attention_dims]

        self.conv_in = nn.Conv2d(c.in_channels, ch[0], c.conv_in_kernel,
                                 padding=(c.conv_in_kernel - 1) // 2)
        self.time_embedding = TimestepEmbedding(ch[0], ted)

        skip_ch, x_ch = [ch[0]], ch[0]
        self.down_blocks = nn.ModuleList()
        for bi, out_ch in enumerate(ch):
            resnets, attns = [], []
            for _ in range(c.layers_per_block):
                resnets.append(ResnetBlock2D(x_ch, out_ch, groups, eps, ted))
                if c.down_block_has_attn[bi]:
                    attns += t2d_group(out_ch)
                x_ch = out_ch
                skip_ch.append(x_ch)
            down = None
            if bi < len(ch) - 1:
                down = Downsample2D(out_ch, c.downsample_padding)
                skip_ch.append(x_ch)
            self.down_blocks.append(UNetBlock(resnets, attns, downsample=down))

        self.mid_block = UNetBlock(
            [ResnetBlock2D(ch[-1], ch[-1], groups, eps, ted) for _ in range(2)], t2d_group(ch[-1]))

        self.up_blocks = nn.ModuleList()
        for bi, out_ch in enumerate(reversed(ch)):
            resnets, attns = [], []
            for _ in range(c.layers_per_block + 1):
                resnets.append(ResnetBlock2D(x_ch + skip_ch.pop(), out_ch, groups, eps, ted))
                if c.up_block_has_attn[bi]:
                    attns += t2d_group(out_ch)
                x_ch = out_ch
            up = Upsample2D(out_ch) if bi < len(ch) - 1 else None
            self.up_blocks.append(UNetBlock(resnets, attns, upsample=up))

        self.conv_norm_out = nn.GroupNorm(groups, ch[0], eps=eps)
        self.conv_out = nn.Conv2d(ch[0], c.out_channels, c.conv_out_kernel,
                                  padding=(c.conv_out_kernel - 1) // 2)
        self._n_dims = n_dims

    # -- site names (the JAX module names, shared with models/hoist.py) ----

    def attention_groups(self) -> Iterator[Tuple[str, List[Transformer2DModel]]]:
        n, c = self._n_dims, self.config
        for bi, blk in enumerate(self.down_blocks):
            if c.down_block_has_attn[bi]:
                for li in range(c.layers_per_block):
                    yield f"down_{bi}_attn_{li}", blk.group(li, n)
        yield "mid_attn_0", self.mid_block.group(0, n)
        for bi, blk in enumerate(self.up_blocks):
            if c.up_block_has_attn[bi]:
                for li in range(c.layers_per_block + 1):
                    yield f"up_{bi}_attn_{li}", blk.group(li, n)

    def resnet_blocks(self) -> Iterator[Tuple[str, ResnetBlock2D]]:
        for bi, blk in enumerate(self.down_blocks):
            for li, r in enumerate(blk.resnets):
                yield f"down_{bi}_resnet_{li}", r
        for li, r in enumerate(self.mid_block.resnets):
            yield f"mid_resnet_{li}", r
        for bi, blk in enumerate(self.up_blocks):
            for li, r in enumerate(blk.resnets):
                yield f"up_{bi}_resnet_{li}", r

    def forward(
        self,
        sample: torch.Tensor,                  # [B, H, W, C_in] NHWC
        timesteps: torch.Tensor,               # [B] or scalar
        encoder_hidden_states: torch.Tensor,   # [B, S0, D0] GPT-2 (+ AudioMAE)
        encoder_hidden_states_1: torch.Tensor,  # [B, S1, D1] T5
        encoder_attention_mask_1: Optional[torch.Tensor] = None,  # [B, S1] {0,1}
        ip_scale: float = 0.0,
        ctx_kv: Optional[Dict] = None,         # hoisted cross K/V (models/hoist.py)
        temb_rows: Optional[Dict[str, torch.Tensor]] = None,  # {resnet: [C]} this step's rows
    ) -> torch.Tensor:
        c = self.config
        dtype = self.conv_in.weight.dtype
        n = self._n_dims

        # the T5 stream's padding bias [B, S1]; the GPT-2+AudioMAE stream is never masked
        if ctx_kv is not None:
            bias1 = ctx_kv["__bias1__"]
        elif encoder_attention_mask_1 is not None:
            bias1 = (1.0 - encoder_attention_mask_1.float()) * -10000.0
        else:
            bias1 = None

        temb = None
        if temb_rows is None:
            ts = torch.as_tensor(timesteps, device=sample.device).reshape(-1)
            ts = ts.expand(sample.shape[0]) if ts.numel() == 1 else ts
            t_emb = get_timestep_embedding(ts, c.block_out_channels[0], c.flip_sin_to_cos,
                                           c.freq_shift).to(dtype)
            temb = self.time_embedding(t_emb)

        ehs0 = encoder_hidden_states.to(dtype)
        ehs1 = encoder_hidden_states_1.to(dtype)

        def trow(name):
            return temb_rows.get(name) if temb_rows is not None else None

        def group(blk, li, name, x):
            kv = ctx_kv.get(name) if ctx_kv is not None else None
            return attention_group(blk.group(li, n), c.cross_attention_dims, x, ehs0, ehs1,
                                   bias1, ip_scale, kv)

        x = self.conv_in(sample.permute(0, 3, 1, 2).to(dtype))
        skips = [x]
        for bi, blk in enumerate(self.down_blocks):
            for li, res in enumerate(blk.resnets):
                x = res(x, temb, trow(f"down_{bi}_resnet_{li}"))
                if len(blk.attentions):
                    x = group(blk, li, f"down_{bi}_attn_{li}", x)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                skips.append(x)

        mid = self.mid_block
        x = mid.resnets[0](x, temb, trow("mid_resnet_0"))
        x = group(mid, 0, "mid_attn_0", x)
        x = mid.resnets[1](x, temb, trow("mid_resnet_1"))

        for bi, blk in enumerate(self.up_blocks):
            for li, res in enumerate(blk.resnets):
                x = torch.cat([x, skips.pop()], dim=1)
                x = res(x, temb, trow(f"up_{bi}_resnet_{li}"))
                if len(blk.attentions):
                    x = group(blk, li, f"up_{bi}_attn_{li}", x)
            if hasattr(blk, "upsamplers"):
                # to the next skip's spatial size (odd latent sizes)
                x = blk.upsamplers[0](x, skips[-1].shape[2:])

        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.permute(0, 2, 3, 1)
