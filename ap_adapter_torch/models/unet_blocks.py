"""Building blocks of the AudioLDM2 UNet (diffusers semantics and state-dict names).

Counterpart of ``ap_adapter_tpu/models/unet_blocks.py``. Convolutional blocks
work on NCHW tensors; the transformer blocks on ``[B, S, C]`` tokens. Every
transformer block routes its three pre-LN sub-layers to the fused ops:
self-attention (attn1, and attn2 of double-self-attention groups) to K1,
cross-attention to K2 over hoisted K/V (``models/hoist.py``, inference) or
to K4, which projects them from the context (training, unhoisted calls),
and the GEGLU feed-forward to K3. K1, K3 and K4 go through their autograd
Functions, whose backwards are K7, K9 and K8.

With ``UNetConfig.use_int8`` (serving only) every site routes to its int8
kernel instead, as the JAX routes at unet_blocks.py:367-389, 458-497 and
603-624 do: self-attention to K11b, cross-attention to K11c (K/V projected
from the raw context, the T5 bias, the adapter split at ``num_ip_tokens``;
never hoisted K/V) and the feed-forward to K11a. Their int8 weights are
buffers that ``models/unet.py::quantize_unet_int8_`` registers once; a site
without them raises rather than falling back to the bf16 kernels.

With ``UNetConfig.use_pallas_attention`` (serving only) every cross site
that has audio tokens takes the JAX package's unfused route
(unet_blocks.py:519-585): ``h = LN(x)``, ``q = h·Wqᵀ`` (a plain product, as
the JAX package leaves it to XLA), K/V from the hoisted ``kv`` or projected
from the context, K10 (``ops/dual_kv_attention.py``, the JAX call at
:562-565), then ``x + out·Woᵀ + bo``. Here that route comes BEFORE K2/K4 at
those sites: on a TPU the fused routes (:403-441 hoisted K2, :443-521 K4 and
K11c) come first and leave K10 only the sites they refuse (``n <
_SMALL_ATTN_MIN_N``, :29) and the CPU, so at full width the JAX switch
reaches K10 nowhere. The T5 sites (with their bias), the self-attention
sites, a site without audio tokens (text-only conditioning) and every site
under ``use_int8`` (whose int8 route also comes first in JAX) keep their
routes.

With ``UNetConfig.force_xla_core`` every transformer site takes the JAX
package's route outside any kernel (unet_blocks.py:519-580, 636-645), which
its TP serving forces: ``h = LN(x)``, the projections as plain products,
``ops/attention.py::sdpa`` (self-attention too, never K5/K6) or
``dual_kv_attention`` (never K10), the out projection without its bias;
the feed-forward's GEGLU likewise. It comes before every other route.
Under tensor parallelism (``parallel/tp.py``) each site holds its own heads
and feed-forward columns, and one ``all_reduce`` over ``tp_group`` sums the
partial outputs before the bias and the residual are added, once.

The resnets route to K12 (``use_pallas_groupnorm``) or K13
(``use_pallas_resnet``), as ``ResnetBlock2D`` describes.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ap_adapter_torch.models.layers import layer_norm_f32
from ap_adapter_torch.ops.attention import dual_kv_attention, sdpa, self_attention
from ap_adapter_torch.ops.dual_kv_attention import fused_dual_kv_attention
from ap_adapter_torch.ops.fused_block import fused_ln_self_attention_vjp
from ap_adapter_torch.ops.fused_cross import fused_ln_cross_attention_kv, fused_ln_cross_attention_vjp
from ap_adapter_torch.ops.fused_ff import fused_ln_geglu_ff_vjp
from ap_adapter_torch.ops.groupnorm import group_norm_silu_vjp
from ap_adapter_torch.ops.int8 import (
    fused_ln_cross_attention_int8, fused_ln_geglu_ff_int8, fused_ln_self_attention_int8, quantize_weight)
from ap_adapter_torch.ops.resnet import fused_resnet_block_vjp

# (k, v, k_ip, v_ip) for one cross-attention site; k_ip/v_ip are None where
# the site has no adapter tokens
KV = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


def _bias_residual(x: torch.Tensor, partial: torch.Tensor, bias: torch.Tensor, tp_group) -> torch.Tensor:
    """``x + (sum of the ranks' partial out projections) + bias``: the
    partials summed in fp32 by one ``all_reduce`` over ``tp_group`` (none
    without one), then the bias and the residual, once."""

    y = partial.float()
    if tp_group is not None:
        dist.all_reduce(y, group=tp_group)
    return x + (y + bias.float()).to(x.dtype)


class ResnetBlock2D(nn.Module):
    """GN -> silu -> conv -> (+temb) -> GN -> silu -> conv (+shortcut), NCHW.

    The UNet's switches route it as the JAX does (unet_blocks.py:93-136):
    ``use_resnet_kernel`` sends the whole block to K13 (``ops/resnet.py``),
    else ``use_groupnorm_kernel`` sends norm1/norm2 + SiLU to K12
    (``ops/groupnorm.py``); with both on, K13 runs and K12 does not. The
    VAE's resnets take neither. Both kernels read the activations as the
    UNet keeps them, channels-last in memory. K13 takes HWIO conv weights,
    which ``prepare_kernel_weights_`` copies once from the torch weights into
    non-persistent buffers (the state-dict keys do not change)."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 32,
                 eps: float = 1e-5, temb_channels: Optional[int] = None,
                 use_groupnorm_kernel: bool = False, use_resnet_kernel: bool = False):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels) if temb_channels else None
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)
        self.use_groupnorm_kernel = use_groupnorm_kernel
        self.use_resnet_kernel = use_resnet_kernel

    @torch.no_grad()
    def prepare_kernel_weights_(self) -> None:
        """HWIO copies of the conv weights for K13, as non-persistent buffers
        ``conv1_hwio``, ``conv2_hwio`` and ``conv_shortcut_hwio``."""

        convs = {"conv1": self.conv1, "conv2": self.conv2, "conv_shortcut": self.conv_shortcut}
        for name, conv in convs.items():
            hwio = None if conv is None else conv.weight.permute(2, 3, 1, 0).contiguous()
            self.register_buffer(f"{name}_hwio", hwio, persistent=False)

    def _norm_silu(self, h: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
        if self.use_groupnorm_kernel:
            return group_norm_silu_vjp(h.contiguous(memory_format=torch.channels_last), norm.weight, norm.bias,
                                       norm.num_groups, norm.eps, act=True)
        return F.silu(norm(h))

    def _temb(self, x, temb, temb_row) -> Optional[torch.Tensor]:
        """This block's time embedding: one row of the hoisted [T, C] table
        (the same for the whole batch, [C]), or the projection of ``temb``
        ([B, C]); None without either."""

        if self.time_emb_proj is None:
            return None
        if temb_row is not None:
            return temb_row.to(x.dtype)
        return None if temb is None else self.time_emb_proj(F.silu(temb))

    def _forward_kernel(self, x, t) -> torch.Tensor:
        if not hasattr(self, "conv1_hwio"):
            raise RuntimeError("ResnetBlock2D: a use_pallas_resnet site without its HWIO weights; prepare the "
                               "UNet once with models.unet.prepare_resnet_kernel_weights_")
        sc = self.conv_shortcut
        y = fused_resnet_block_vjp(
            x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1), t,
            self.norm1.weight, self.norm1.bias, self.conv1_hwio, self.conv1.bias,
            self.norm2.weight, self.norm2.bias, self.conv2_hwio, self.conv2.bias,
            self.conv_shortcut_hwio, None if sc is None else sc.bias, self.norm1.num_groups, self.norm1.eps)
        return y.permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None,
                temb_row: Optional[torch.Tensor] = None) -> torch.Tensor:
        t = self._temb(x, temb, temb_row)
        if self.use_resnet_kernel:
            return self._forward_kernel(x, t)
        h = self.conv1(self._norm_silu(x, self.norm1))
        if t is not None:
            h = h + t.reshape(-1, h.shape[1], 1, 1)
        h = self.conv2(self._norm_silu(h, self.norm2))
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


def _int8_buffers(module: nn.Module, names) -> list:
    """The int8 weights and scales ``quantize_int8_`` registered on ``module``."""

    found = [getattr(module, n, None) for n in names]
    if any(t is None for t in found):
        raise RuntimeError(f"{type(module).__name__}: a use_int8 site without its int8 weights; quantize "
                           "the UNet once with models.unet.quantize_unet_int8_")
    return found


def _register_quantized(module: nn.Module, **weights: nn.Linear) -> None:
    """Non-persistent int8 copy and fp32 scales of each Linear weight (a
    checkpoint's keys do not change): ``<name>_int8`` and ``<name>_scale``."""

    for name, linear in weights.items():
        w8, scale = quantize_weight(linear.weight)
        module.register_buffer(f"{name}_int8", w8, persistent=False)
        module.register_buffer(f"{name}_scale", scale, persistent=False)


class AdapterKV(nn.Module):
    """The adapter's decoupled audio K/V projections (diffusers keys
    ``attn2.processor.to_k_ip`` / ``to_v_ip``)."""

    def __init__(self, kv_dim: int, inner: int):
        super().__init__()
        self.to_k_ip = nn.Linear(kv_dim, inner, bias=False)
        self.to_v_ip = nn.Linear(kv_dim, inner, bias=False)


class CrossAttention(nn.Module):
    """diffusers ``Attention`` with an optional decoupled audio-KV branch.
    The UNet calls it with its preceding LayerNorm (``x + attn(LN(x))``);
    called with ``norm=None`` it is the bare ``attn(x)``, as the JAX module
    is without ``pre_ln``.

    With the adapter, the context splits at ``num_ip_tokens``: the first
    tokens (GPT-2) give the text K/V, the rest (AudioMAE) the adapter K/V, and
    the outputs combine as text + ip_scale * audio with the audio branch
    unmasked. ``use_dual_kv`` sends a site with audio tokens to K10, and
    ``force_xla`` every site to the route outside the kernels, as the module
    docstring describes; ``heads`` is the site's local head count under
    tensor parallelism, whose partial outputs ``tp_group`` sums."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None, use_adapter: bool = False,
                 num_ip_tokens: int = 8, use_int8: bool = False, use_dual_kv: bool = False,
                 force_xla: bool = False):
        super().__init__()
        inner = heads * dim_head
        kv_dim = cross_attention_dim or query_dim
        self.heads = heads
        self.is_cross = cross_attention_dim is not None
        self.num_ip_tokens = num_ip_tokens
        self.use_int8 = use_int8
        self.use_dual_kv = use_dual_kv
        self.force_xla = force_xla
        self.tp_group = None
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
        # the adapter weights may be fp32 trainable copies in a bf16 UNet
        return (k, v, F.linear(ip, self.processor.to_k_ip.weight.to(ip.dtype)),
                F.linear(ip, self.processor.to_v_ip.weight.to(ip.dtype)))

    def quantize_int8_(self) -> None:
        _register_quantized(self, wq=self.to_q, wo=self.to_out[0])

    def _forward_int8(self, x, norm, context, bias, ip_scale) -> torch.Tensor:
        wq8, sq, wo8, so = _int8_buffers(self, ("wq_int8", "wq_scale", "wo_int8", "wo_scale"))
        w = (norm.weight, norm.bias, wq8, sq, self.to_k.weight, self.to_v.weight, wo8, so, self.to_out[0].bias)
        if not self.is_cross:
            return fused_ln_self_attention_int8(x, *w, self.heads, norm.eps)
        ip = self.processor if self.processor is not None and context.shape[1] > self.num_ip_tokens else None
        return fused_ln_cross_attention_int8(
            x, context, *w, self.heads, wk_ip=None if ip is None else ip.to_k_ip.weight.to(x.dtype),
            wv_ip=None if ip is None else ip.to_v_ip.weight.to(x.dtype), ip_scale=ip_scale,
            num_ip_tokens=self.num_ip_tokens, bias=bias, eps=norm.eps)

    def _forward_dual_kv(self, x, norm, context, bias, ip_scale, kv) -> torch.Tensor:
        """The unfused route: LN, q projection, K10 over the text and audio
        K/V (hoisted, or projected here), out projection and residual."""

        b, s, c = x.shape
        d = c // self.heads
        q = F.linear(layer_norm_f32(x, norm.weight, norm.bias, norm.eps), self.to_q.weight)
        k, v, ki, vi = kv if kv is not None else self.project_kv(context)
        k, v, ki, vi = (t.reshape(b, -1, self.heads, d) for t in (k, v, ki, vi))
        out = fused_dual_kv_attention(q.reshape(b, s, self.heads, d), k, v, ki, vi, ip_scale, bias=bias)
        return x + F.linear(out.reshape(b, s, c), self.to_out[0].weight, self.to_out[0].bias)

    def _attend(self, x, context, bias, ip_scale, kv, self_attn) -> torch.Tensor:
        """The JAX route's attention outside any kernel (unet_blocks.py:
        521-580): q/k/v projections of ``x`` (K/V of the context, or the
        hoisted ``kv``), ``self_attn`` without a context, ``sdpa`` with the
        additive mask, both K/V sets through ``dual_kv_attention`` where
        the adapter's are there; [B, S, heads * d] before the out
        projection. The head width is the weights' inner width over
        ``heads``. ``bias``: [B, Sk], or a mask that broadcasts to [B,
        heads, Sq, Sk]."""

        b, s, _ = x.shape
        inner = self.to_q.weight.shape[0]
        split = lambda t: t.reshape(b, -1, self.heads, inner // self.heads)
        q = split(F.linear(x, self.to_q.weight))
        if not self.is_cross:
            out = self_attn(q, split(F.linear(x, self.to_k.weight)), split(F.linear(x, self.to_v.weight)))
        else:
            k, v, ki, vi = (None if t is None else split(t) for t in (kv if kv is not None else
                                                                      self.project_kv(context)))
            mask = bias[:, None, None, :] if bias is not None and bias.dim() == 2 else bias
            out = sdpa(q, k, v, mask) if ki is None else dual_kv_attention(q, k, v, ki, vi, ip_scale, mask)
        return out.reshape(b, s, inner)

    def _forward_bare(self, x, context, bias, ip_scale) -> torch.Tensor:
        """The JAX route without ``pre_ln`` (unet_blocks.py:521-582):
        ``_attend`` (``self_attention`` without a context) and the out
        projection with its bias; no residual."""

        return F.linear(self._attend(x, context, bias, ip_scale, None, self_attention),
                        self.to_out[0].weight, self.to_out[0].bias)

    def _forward_xla(self, x, norm, context, bias, ip_scale, kv) -> torch.Tensor:
        """The JAX ``force_xla`` route with ``pre_ln``: LN, ``_attend`` with
        ``sdpa`` everywhere, the out projection without its bias, then the
        ranks' sum, the bias and the residual."""

        h = layer_norm_f32(x, norm.weight, norm.bias, norm.eps)
        partial = F.linear(self._attend(h, context, bias, ip_scale, kv, sdpa), self.to_out[0].weight)
        return _bias_residual(x, partial, self.to_out[0].bias, self.tp_group)

    def forward(self, x: torch.Tensor, norm: Optional[nn.LayerNorm],
                context: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                ip_scale: float = 0.0, kv: Optional[KV] = None) -> torch.Tensor:
        out = self.to_out[0]
        if norm is None:
            return self._forward_bare(x, context, bias, ip_scale)
        if self.force_xla:
            return self._forward_xla(x, norm, context, bias, ip_scale, kv)
        if self.use_int8:      # the UNet refuses hoisted K/V under use_int8
            return self._forward_int8(x, norm, context, bias, ip_scale)
        if not self.is_cross:
            return fused_ln_self_attention_vjp(
                x, norm.weight, norm.bias, self.to_q.weight, self.to_k.weight,
                self.to_v.weight, out.weight, out.bias, self.heads, norm.eps)
        has_audio = (kv[2] is not None if kv is not None
                     else self.processor is not None and context.shape[1] > self.num_ip_tokens)
        if self.use_dual_kv and has_audio:
            return self._forward_dual_kv(x, norm, context, bias, ip_scale, kv)
        if kv is not None:
            k, v, ki, vi = kv
            return fused_ln_cross_attention_kv(
                x, k, v, norm.weight, norm.bias, self.to_q.weight, out.weight, out.bias,
                self.heads, ki=ki, vi=vi, ip_scale=ip_scale, bias=bias, eps=norm.eps)
        ip = self.processor if self.processor is not None and context.shape[1] > self.num_ip_tokens else None
        return fused_ln_cross_attention_vjp(
            x, context, norm.weight, norm.bias, self.to_q.weight, self.to_k.weight, self.to_v.weight,
            out.weight, out.bias, self.heads, wk_ip=None if ip is None else ip.to_k_ip.weight,
            wv_ip=None if ip is None else ip.to_v_ip.weight, ip_scale=ip_scale,
            num_ip_tokens=self.num_ip_tokens, bias=bias, eps=norm.eps)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)


class FeedForward(nn.Module):
    """GEGLU feed-forward (diffusers keys ``ff.net.0.proj`` and ``ff.net.2``),
    called with its preceding LayerNorm (``x + ff(LN(x))``). ``force_xla``
    takes the JAX route outside the kernels (unet_blocks.py:636-645); under
    tensor parallelism the site holds its own columns of both GEGLU halves
    and ``tp_group`` sums the partial outputs."""

    def __init__(self, dim: int, mult: int = 4, use_int8: bool = False, force_xla: bool = False):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)])
        self.use_int8 = use_int8
        self.force_xla = force_xla
        self.tp_group = None

    def quantize_int8_(self) -> None:
        _register_quantized(self, w1=self.net[0].proj, w2=self.net[2])

    def forward(self, x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
        proj, out = self.net[0].proj, self.net[2]
        if self.force_xla:
            y, gate = F.linear(layer_norm_f32(x, norm.weight, norm.bias, norm.eps), proj.weight,
                               proj.bias).chunk(2, dim=-1)
            return _bias_residual(x, F.linear(y * F.gelu(gate), out.weight), out.bias, self.tp_group)
        if self.use_int8:
            w1q, s1, w2q, s2 = _int8_buffers(self, ("w1_int8", "w1_scale", "w2_int8", "w2_scale"))
            return fused_ln_geglu_ff_int8(x, norm.weight, norm.bias, w1q, s1, proj.bias, w2q, s2, out.bias,
                                          norm.eps)
        return fused_ln_geglu_ff_vjp(x, norm.weight, norm.bias, proj.weight, proj.bias,
                                     out.weight, out.bias, norm.eps)


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn, LN -> cross-attn (or a second self-attn), LN -> GEGLU FF."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None, use_adapter: bool = False,
                 num_ip_tokens: int = 8, use_int8: bool = False, use_dual_kv: bool = False,
                 force_xla: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = CrossAttention(dim, heads, dim_head, use_int8=use_int8, force_xla=force_xla)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = CrossAttention(dim, heads, dim_head, cross_attention_dim,
                                    use_adapter, num_ip_tokens, use_int8, use_dual_kv, force_xla)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim, use_int8=use_int8, force_xla=force_xla)

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
                 num_ip_tokens: int = 8, groups: int = 32, use_int8: bool = False,
                 use_dual_kv: bool = False, force_xla: bool = False):
        super().__init__()
        dim_head = channels // heads
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, heads, dim_head, cross_attention_dim,
                                  use_adapter, num_ip_tokens, use_int8, use_dual_kv, force_xla)
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
