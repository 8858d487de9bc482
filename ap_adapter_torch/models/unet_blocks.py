"""Building blocks of the AudioLDM2 UNet (diffusers semantics and state-dict names).

Counterpart of ``ap_adapter_tpu/models/unet_blocks.py``. Convolutional blocks
work on NCHW tensors; the transformer blocks on ``[B, S, C]`` tokens. Every
transformer block routes its three pre-LN sub-layers to the fused ops:
self-attention (attn1, and attn2 of double-self-attention groups) to K1,
cross-attention to K2 over K/V that are either hoisted (``models/hoist.py``)
or projected here, and the GEGLU feed-forward to K3.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ap_adapter_torch.ops.fused_block import fused_ln_self_attention
from ap_adapter_torch.ops.fused_cross import fused_ln_cross_attention_kv
from ap_adapter_torch.ops.fused_ff import fused_ln_geglu_ff

# (k, v, k_ip, v_ip) for one cross-attention site; k_ip/v_ip are None where
# the site has no adapter tokens
KV = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


class ResnetBlock2D(nn.Module):
    """GN -> silu -> conv -> (+temb) -> GN -> silu -> conv (+shortcut), NCHW."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 32,
                 eps: float = 1e-5, temb_channels: Optional[int] = None):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels) if temb_channels else None
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None,
                temb_row: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None and temb_row is not None:
            # one row of the hoisted [T, C] table, the same for the whole batch
            h = h + temb_row.to(h.dtype)[None, :, None, None]
        elif self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    def __init__(self, channels: int, padding: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest resize (2x, or to the next skip's size for odd shapes:
    floor(i * in / out), ``mode="nearest"``) followed by a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor, size: Optional[Sequence[int]] = None) -> torch.Tensor:
        size = tuple(size) if size is not None else (2 * x.shape[2], 2 * x.shape[3])
        return self.conv(F.interpolate(x, size=size, mode="nearest"))


class AdapterKV(nn.Module):
    """The adapter's decoupled audio K/V projections (diffusers keys
    ``attn2.processor.to_k_ip`` / ``to_v_ip``)."""

    def __init__(self, kv_dim: int, inner: int):
        super().__init__()
        self.to_k_ip = nn.Linear(kv_dim, inner, bias=False)
        self.to_v_ip = nn.Linear(kv_dim, inner, bias=False)


class CrossAttention(nn.Module):
    """diffusers ``Attention`` with an optional decoupled audio-KV branch,
    always called with its preceding LayerNorm (``x + attn(LN(x))``).

    With the adapter, the context splits at ``num_ip_tokens``: the first
    tokens (GPT-2) give the text K/V, the rest (AudioMAE) the adapter K/V, and
    the outputs combine as text + ip_scale * audio with the audio branch
    unmasked."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None, use_adapter: bool = False,
                 num_ip_tokens: int = 8):
        super().__init__()
        inner = heads * dim_head
        kv_dim = cross_attention_dim or query_dim
        self.heads = heads
        self.is_cross = cross_attention_dim is not None
        self.num_ip_tokens = num_ip_tokens
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(kv_dim, inner, bias=False)
        self.to_v = nn.Linear(kv_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])
        self.processor = AdapterKV(kv_dim, inner) if use_adapter else None

    def project_kv(self, context: torch.Tensor) -> KV:
        """Cross-attention K/V of ``context`` in [B, Sk, inner] layout."""

        ctx, ip = context, None
        if self.processor is not None and context.shape[1] > self.num_ip_tokens:
            ctx, ip = context[:, : self.num_ip_tokens], context[:, self.num_ip_tokens:]
        k = F.linear(ctx, self.to_k.weight)
        v = F.linear(ctx, self.to_v.weight)
        if ip is None:
            return k, v, None, None
        return (k, v, F.linear(ip, self.processor.to_k_ip.weight),
                F.linear(ip, self.processor.to_v_ip.weight))

    def forward(self, x: torch.Tensor, norm: nn.LayerNorm,
                context: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                ip_scale: float = 0.0, kv: Optional[KV] = None) -> torch.Tensor:
        out = self.to_out[0]
        if not self.is_cross:
            return fused_ln_self_attention(
                x, norm.weight, norm.bias, self.to_q.weight, self.to_k.weight,
                self.to_v.weight, out.weight, out.bias, self.heads, norm.eps)
        k, v, ki, vi = kv if kv is not None else self.project_kv(context)
        return fused_ln_cross_attention_kv(
            x, k, v, norm.weight, norm.bias, self.to_q.weight, out.weight, out.bias,
            self.heads, ki=ki, vi=vi, ip_scale=ip_scale, bias=bias, eps=norm.eps)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)


class FeedForward(nn.Module):
    """GEGLU feed-forward (diffusers keys ``ff.net.0.proj`` and ``ff.net.2``),
    called with its preceding LayerNorm (``x + ff(LN(x))``)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
        proj, out = self.net[0].proj, self.net[2]
        return fused_ln_geglu_ff(x, norm.weight, norm.bias, proj.weight, proj.bias,
                                 out.weight, out.bias, norm.eps)


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn, LN -> cross-attn (or a second self-attn), LN -> GEGLU FF."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None, use_adapter: bool = False,
                 num_ip_tokens: int = 8):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = CrossAttention(dim, heads, dim_head, cross_attention_dim,
                                    use_adapter, num_ip_tokens)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context=None, bias=None, ip_scale: float = 0.0,
                kv: Optional[KV] = None) -> torch.Tensor:
        x = self.attn1(x, self.norm1)
        if self.attn2.is_cross:
            x = self.attn2(x, self.norm2, context, bias, ip_scale, kv)
        else:
            x = self.attn2(x, self.norm2)
        return self.ff(x, self.norm3)


class Transformer2DModel(nn.Module):
    """GN -> 1x1 proj_in -> L transformer blocks over the HW tokens ->
    1x1 proj_out + residual, on NCHW input."""

    def __init__(self, channels: int, heads: int, num_layers: int,
                 cross_attention_dim: Optional[int] = None, use_adapter: bool = False,
                 num_ip_tokens: int = 8, groups: int = 32):
        super().__init__()
        dim_head = channels // heads
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, heads, dim_head, cross_attention_dim,
                                  use_adapter, num_ip_tokens)
            for _ in range(num_layers)])
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x, context=None, bias=None, ip_scale: float = 0.0, kv=None) -> torch.Tensor:
        """``kv``: this site's hoisted (k, v, ki, vi), each [L, B, Sk, C] or None."""

        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x))
        y = y.permute(0, 2, 3, 1).reshape(b, h * w, c).contiguous()   # the kernels' [B, S, C] layout
        for l, blk in enumerate(self.transformer_blocks):
            kv_l = None if kv is None else tuple(None if t is None else t[l] for t in kv)
            y = blk(y, context, bias, ip_scale, kv_l)
        y = y.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(y) + x


def attention_group(t2ds: Sequence[Transformer2DModel], cross_attention_dims, x, ehs0, ehs1,
                    bias1=None, ip_scale: float = 0.0, kv: Optional[dict] = None) -> torch.Tensor:
    """One attention "layer" of the UNet (the JAX ``AttentionGroup``): one
    Transformer2DModel per ``cross_attention_dims`` entry, routed idx <= 1 ->
    stream 0 (GPT-2 + AudioMAE, never masked), idx > 1 -> stream 1 (T5, with
    its padding bias ``bias1`` [B, S1]); ``None`` entries are
    double-self-attention. ``kv``: the group's hoisted K/V by
    ``attentions_{idx}``."""

    for idx, (t2d, dim) in enumerate(zip(t2ds, cross_attention_dims)):
        if dim is None:
            x = t2d(x)
            continue
        context, bias = (ehs0, None) if idx <= 1 else (ehs1, bias1)
        site_kv = kv[f"attentions_{idx}"] if kv is not None else None
        x = t2d(x, context, bias, ip_scale, site_kv)
    return x
