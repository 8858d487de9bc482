"""The reference UNet: AudioLDM2's dual-stream conditional UNet with the
AP-adapter's decoupled audio K/V at the 768-wide cross sites (diffusers'
``AudioLDM2UNet2DConditionModel`` and the adapter's attention processor),
or, with a class embedding and one double-self-attention transformer a
group, AudioLDM v1's UNet. Latents are NHWC [B, T, F, C] at the interface;
every timestep embedding and cross-attention K/V is computed in the step."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from h100_bench.reference.audio import Resnet, Upsample
from h100_bench.reference.common import attention, timestep_embedding


class Attention(nn.Module):
    """diffusers ``Attention``; with ``adapter`` the context splits after its
    first ``num_ip_tokens`` rows into text and audio, and the audio branch
    (unmasked) adds ``ip_scale`` times its own attention."""

    def __init__(self, dim, heads, kv_dim=None, adapter=False, num_ip_tokens=8):
        super().__init__()
        kv_dim = kv_dim or dim
        self.heads, self.num_ip_tokens = heads, num_ip_tokens
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(kv_dim, dim, bias=False)
        self.to_v = nn.Linear(kv_dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])
        if adapter:
            self.processor = nn.Module()
            self.processor.to_k_ip = nn.Linear(kv_dim, dim, bias=False)
            self.processor.to_v_ip = nn.Linear(kv_dim, dim, bias=False)
        else:
            self.processor = None

    def forward(self, x, context=None, bias=None, ip_scale=0.0):
        b, s, c = x.shape
        split = lambda t: t.reshape(b, t.shape[1], self.heads, c // self.heads)
        ctx = x if context is None else context
        ip = None
        if self.processor is not None and ctx.shape[1] > self.num_ip_tokens:
            ctx, ip = ctx[:, : self.num_ip_tokens], ctx[:, self.num_ip_tokens:]
        q = split(self.to_q(x))
        out = attention(q, split(self.to_k(ctx)), split(self.to_v(ctx)), bias)
        if ip is not None:
            out = out + ip_scale * attention(q, split(self.processor.to_k_ip(ip)), split(self.processor.to_v_ip(ip)))
        return self.to_out[0](out.reshape(b, s, c))


class GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(), nn.Linear(4 * dim, dim)])

    def forward(self, x):
        a, gate = self.net[0].proj(x).chunk(2, dim=-1)
        return self.net[2](a * F.gelu(gate))


class TransformerBlock(nn.Module):
    def __init__(self, dim, heads, cross_dim, adapter, num_ip_tokens):
        super().__init__()
        self.norm1, self.norm2, self.norm3 = nn.LayerNorm(dim), nn.LayerNorm(dim), nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads)
        self.attn2 = Attention(dim, heads, cross_dim, adapter, num_ip_tokens)
        self.ff = FeedForward(dim)
        self.cross = cross_dim is not None

    def forward(self, x, context, bias, ip_scale):
        x = x + self.attn1(self.norm1(x))
        if self.cross:
            x = x + self.attn2(self.norm2(x), context, bias, ip_scale)
        else:
            x = x + self.attn2(self.norm2(x))
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, ch, heads, layers, cross_dim, adapter, num_ip_tokens, groups):
        super().__init__()
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.proj_in = nn.Conv2d(ch, ch, 1)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(ch, heads, cross_dim, adapter, num_ip_tokens)
                                                 for _ in range(layers)])
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x, context=None, bias=None, ip_scale=0.0):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for blk in self.transformer_blocks:
            y = blk(y, context, bias, ip_scale)
        return self.proj_out(y.reshape(b, h, w, c).permute(0, 3, 1, 2)) + x


class Block(nn.Module):
    def __init__(self, resnets, attentions, down=None, up=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if down is not None:
            self.downsamplers = nn.ModuleList([down])
        if up is not None:
            self.upsamplers = nn.ModuleList([up])


class UNet(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.c = c
        ch, g, eps = c.block_out_channels, c.norm_num_groups, c.norm_eps
        ted = 4 * ch[0]
        temb_ch = 2 * ted if c.class_embed_dim is not None and c.class_embeddings_concat else ted
        dims = c.cross_attention_dims
        self.n = len(dims)

        def group(width):
            return [Transformer2D(width, c.num_attention_heads, c.transformer_layers_per_block, d,
                                  d is not None and d == c.adapter_cross_attention_dim, c.adapter_num_tokens, g)
                    for d in dims]

        self.conv_in = nn.Conv2d(c.in_channels, ch[0], 3, padding=1)
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1, self.time_embedding.linear_2 = nn.Linear(ch[0], ted), nn.Linear(ted, ted)
        if c.class_embed_dim is not None:
            self.class_embedding = nn.Linear(c.class_embed_dim, ted)
        skips, x_ch = [ch[0]], ch[0]
        self.down_blocks = nn.ModuleList()
        for bi, out in enumerate(ch):
            res, att = [], []
            for _ in range(c.layers_per_block):
                res.append(Resnet(x_ch, out, g, eps, temb_ch))
                att += group(out) if c.down_block_has_attn[bi] else []
                x_ch = out
                skips.append(x_ch)
            down = None
            if bi < len(ch) - 1:
                down = nn.Module()
                down.conv = nn.Conv2d(out, out, 3, stride=2, padding=c.downsample_padding)
                skips.append(x_ch)
            self.down_blocks.append(Block(res, att, down=down))
        self.mid_block = Block([Resnet(ch[-1], ch[-1], g, eps, temb_ch) for _ in range(2)], group(ch[-1]))
        self.up_blocks = nn.ModuleList()
        for bi, out in enumerate(reversed(ch)):
            res, att = [], []
            for _ in range(c.layers_per_block + 1):
                res.append(Resnet(x_ch + skips.pop(), out, g, eps, temb_ch))
                att += group(out) if c.up_block_has_attn[bi] else []
                x_ch = out
            self.up_blocks.append(Block(res, att, up=Upsample(out) if bi < len(ch) - 1 else None))
        self.conv_norm_out = nn.GroupNorm(g, ch[0], eps=eps)
        self.conv_out = nn.Conv2d(ch[0], c.out_channels, 3, padding=1)

    def _group(self, blk, li, x, ehs0, ehs1, bias1, ip_scale):
        for idx, t2d in enumerate(blk.attentions[li * self.n:(li + 1) * self.n]):
            if self.c.cross_attention_dims[idx] is None:
                x = t2d(x)
            elif idx <= 1:
                x = t2d(x, ehs0, None, ip_scale)
            else:
                x = t2d(x, ehs1, bias1, ip_scale)
        return x

    def forward(self, sample, t, ehs0=None, ehs1=None, mask1=None, ip_scale=0.0, class_labels=None):
        """sample [B, T, F, C_in], t [B] -> noise prediction [B, T, F, C_out]."""

        c = self.c
        te = self.time_embedding
        temb = te.linear_2(F.silu(te.linear_1(timestep_embedding(t, c.block_out_channels[0]))))
        if class_labels is not None:
            cemb = self.class_embedding(class_labels)
            temb = torch.cat([temb, cemb], dim=-1) if c.class_embeddings_concat else temb + cemb
        bias1 = None if mask1 is None else ((1.0 - mask1.float()) * -10000.0)[:, None, None, :]
        x = self.conv_in(sample.permute(0, 3, 1, 2))
        skips = [x]
        for blk in self.down_blocks:
            for li, r in enumerate(blk.resnets):
                x = r(x, temb)
                if len(blk.attentions):
                    x = self._group(blk, li, x, ehs0, ehs1, bias1, ip_scale)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0].conv(x)
                skips.append(x)
        m = self.mid_block
        x = m.resnets[1](self._group(m, 0, m.resnets[0](x, temb), ehs0, ehs1, bias1, ip_scale), temb)
        for blk in self.up_blocks:
            for li, r in enumerate(blk.resnets):
                x = r(torch.cat([x, skips.pop()], dim=1), temb)
                if len(blk.attentions):
                    x = self._group(blk, li, x, ehs0, ehs1, bias1, ip_scale)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x, tuple(skips[-1].shape[2:]))
        return self.conv_out(F.silu(self.conv_norm_out(x))).permute(0, 2, 3, 1)
