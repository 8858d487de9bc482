"""AudioLDM2 dual-stream conditional UNet (diffusers state-dict names).

Counterpart of ``ap_adapter_tpu/models/unet.py``. The public layout is NHWC
(``[B, T, F, C]`` latents, e.g. ``[B, 250, 16, 8]`` for a 10 s clip); the
convolutions run on NCHW inside. Every attention "layer" is a group of
``len(cross_attention_dims)`` Transformer2DModels over two conditioning
streams, and the decoupled audio-KV adapter lives at the sites whose
cross-attention dim is ``adapter_cross_attention_dim``. Two variants of the
JAX module (its unet.py:67-99,118) are kept: a class-embedding UNet
(``class_embed_dim``, AudioLDM v1: ``class_labels`` through a "simple
projection" concatenated onto the time embedding or added to it) and the
ControlNet branch (``cn_text_only``: the GPT-2+AudioMAE stream cut to its
first ``adapter_num_tokens`` text tokens before any site sees it, and no
adapter weights). The config's switches route the sites as
``models/unet_blocks.py`` describes; under
``use_pallas_attention`` the adapter sites take K10 BEFORE K2/K4, unlike the
JAX routing (its unet_blocks.py:403-585), where the fused routes come first.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ap_adapter_torch.configs import UNetConfig
from ap_adapter_torch.models.layers import get_timestep_embedding
from ap_adapter_torch.models.unet_blocks import (
    CrossAttention,
    Downsample2D,
    FeedForward,
    ResnetBlock2D,
    Transformer2DModel,
    Upsample2D,
    attention_group,
)
from ap_adapter_torch.models.graphs import GraphedModule
from ap_adapter_torch.ops.cuda_kernels import UNET_FORWARDS
from ap_adapter_torch.utils import trace


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


class AudioLDM2UNet(GraphedModule):
    def __init__(self, config: UNetConfig = UNetConfig()):
        super().__init__()
        c = self.config = config
        ch = c.block_out_channels
        groups, eps, ted = c.norm_num_groups, c.norm_eps, c.time_embed_dim
        n_dims = len(c.cross_attention_dims)
        # every resnet's time_emb_proj reads [temb | class embedding] under the concat
        temb_channels = 2 * ted if c.class_embed_dim is not None and c.class_embeddings_concat else ted

        def resnet(cin, cout):
            return ResnetBlock2D(cin, cout, groups, eps, temb_channels, use_groupnorm_kernel=c.use_pallas_groupnorm,
                                 use_resnet_kernel=c.use_pallas_resnet)

        def t2d_group(channels):
            return [Transformer2DModel(
                channels, c.num_attention_heads, c.transformer_layers_per_block, dim,
                use_adapter=dim is not None and dim == c.adapter_cross_attention_dim and not c.cn_text_only,
                num_ip_tokens=c.adapter_num_tokens, groups=groups, use_int8=c.use_int8,
                use_dual_kv=c.use_pallas_attention, force_xla=c.force_xla_core)
                for dim in c.cross_attention_dims]

        self.conv_in = nn.Conv2d(c.in_channels, ch[0], c.conv_in_kernel,
                                 padding=(c.conv_in_kernel - 1) // 2)
        self.time_embedding = TimestepEmbedding(ch[0], ted)
        if c.class_embed_dim is not None:
            self.class_embedding = nn.Linear(c.class_embed_dim, ted)     # diffusers "simple_projection"

        skip_ch, x_ch = [ch[0]], ch[0]
        self.down_blocks = nn.ModuleList()
        for bi, out_ch in enumerate(ch):
            resnets, attns = [], []
            for _ in range(c.layers_per_block):
                resnets.append(resnet(x_ch, out_ch))
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
            [resnet(ch[-1], ch[-1]) for _ in range(2)], t2d_group(ch[-1]))

        self.up_blocks = nn.ModuleList()
        for bi, out_ch in enumerate(reversed(ch)):
            resnets, attns = [], []
            for _ in range(c.layers_per_block + 1):
                resnets.append(resnet(x_ch + skip_ch.pop(), out_ch))
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
        encoder_hidden_states: Optional[torch.Tensor] = None,   # [B, S0, D0] GPT-2 (+ AudioMAE)
        encoder_hidden_states_1: Optional[torch.Tensor] = None,  # [B, S1, D1] T5
        encoder_attention_mask_1: Optional[torch.Tensor] = None,  # [B, S1] {0,1}
        ip_scale: float = 0.0,
        class_labels: Optional[torch.Tensor] = None,  # [B, class_embed_dim]
        ctx_kv: Optional[Dict] = None,         # hoisted cross K/V (models/hoist.py)
        temb_rows: Optional[Dict[str, torch.Tensor]] = None,  # {resnet: [C]} this step's rows
    ) -> torch.Tensor:
        """The noise prediction [B, H, W, C_out], NHWC.

        A CUDA forward under ``no_grad`` replays a captured CUDA graph of
        itself: the first forward of an input signature (``graph_signature``)
        runs eager and warms the kernels' plans, the second captures the graph
        and replays it, and every later one copies its inputs into the graph's
        static buffers, replays it and returns a fresh copy of its output
        (``models/graphs.py``). The graphs are dropped whenever a parameter or
        buffer is replaced (``drop_graphs``). CPU, grad-mode and
        tensor-parallel forwards run eager; the last carry collectives."""

        with trace.span("ap.unet"):
            inputs = (sample, timesteps, encoder_hidden_states, encoder_hidden_states_1, encoder_attention_mask_1,
                      class_labels, ctx_kv, temb_rows)
            # tp_shard_unet_ sets tp_split: its forwards all-reduce across ranks, so they stay eager
            capturable = sample.is_cuda and not torch.is_grad_enabled() and not hasattr(self, "tp_split")
            return self.graphed(inputs, ip_scale, sample.device, capturable,
                                lambda *a: self._forward(*a, ip_scale), UNET_FORWARDS, "ap.unet.replay")

    def _forward(self, sample, timesteps, encoder_hidden_states, encoder_hidden_states_1, encoder_attention_mask_1,
                 class_labels, ctx_kv, temb_rows, ip_scale) -> torch.Tensor:
        c = self.config
        dtype = self.conv_in.weight.dtype
        n = self._n_dims

        if c.use_int8 and ctx_kv is not None:
            # the int8 sites project K/V in the step; a hoisted bias would
            # drop the T5 mask there (the JAX pipeline.py:272-277)
            raise ValueError("a use_int8 UNet takes no hoisted K/V (ctx_kv)")
        if c.cn_text_only and ctx_kv is not None:
            # the rows would hold the audio tokens that this UNet strips (the JAX hoist.py:150-153)
            raise ValueError("K/V hoisting is not supported for cn_text_only (ControlNet-branch) UNets; "
                             "pass ctx_kv=None")
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

        if c.class_embed_dim is not None and class_labels is not None:
            if temb is None:
                raise ValueError(
                    "class_labels conditioning is incompatible with hoisted temb_rows: the precomputed rows do "
                    "not include the class embedding. Pass temb_rows=None for class-conditioned runs.")
            cemb = self.class_embedding(class_labels.to(dtype))
            temb = torch.cat([temb, cemb], dim=-1) if c.class_embeddings_concat else temb + cemb

        ehs0 = None if encoder_hidden_states is None else encoder_hidden_states.to(dtype)
        ehs1 = None if encoder_hidden_states_1 is None else encoder_hidden_states_1.to(dtype)
        if c.cn_text_only and ehs0 is not None and ehs0.shape[1] > c.adapter_num_tokens:
            # the ControlNet branch attends the leading text tokens only (the reference's
            # CNAttnProcessor2_0, attention_processor.py:585-586)
            ehs0 = ehs0[:, : c.adapter_num_tokens].contiguous()

        def trow(name):
            return temb_rows.get(name) if temb_rows is not None else None

        # under remat each resnet and attention group is one checkpointed
        # segment (the JAX nn.remat units); the non-reentrant form keeps the
        # gradients of the adapter weights inside a segment whose tensor
        # inputs need none (the first adapter site's group)
        remat = c.remat and torch.is_grad_enabled()

        def segment(fn, *args):
            if remat:
                return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
            return fn(*args)

        def resnet(res, x, name):
            with trace.span("ap.unet.resnet"):
                return segment(res, x, temb, trow(name))

        def group(blk, li, name, x):
            kv = ctx_kv.get(name) if ctx_kv is not None else None
            with trace.span("ap.unet.attn"):
                return segment(attention_group, blk.group(li, n), c.cross_attention_dims, x, ehs0, ehs1,
                               bias1, ip_scale, kv)

        x = self.conv_in(sample.permute(0, 3, 1, 2).to(dtype))
        skips = [x]
        for bi, blk in enumerate(self.down_blocks):
            for li, res in enumerate(blk.resnets):
                x = resnet(res, x, f"down_{bi}_resnet_{li}")
                if len(blk.attentions):
                    x = group(blk, li, f"down_{bi}_attn_{li}", x)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                skips.append(x)

        mid = self.mid_block
        x = resnet(mid.resnets[0], x, "mid_resnet_0")
        x = group(mid, 0, "mid_attn_0", x)
        x = resnet(mid.resnets[1], x, "mid_resnet_1")

        for bi, blk in enumerate(self.up_blocks):
            for li, res in enumerate(blk.resnets):
                x = torch.cat([x, skips.pop()], dim=1)
                x = resnet(res, x, f"up_{bi}_resnet_{li}")
                if len(blk.attentions):
                    x = group(blk, li, f"up_{bi}_attn_{li}", x)
            if hasattr(blk, "upsamplers"):
                # to the next skip's spatial size (odd latent sizes)
                x = blk.upsamplers[0](x, skips[-1].shape[2:])

        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.permute(0, 2, 3, 1)


def prepare_resnet_kernel_weights_(unet: AudioLDM2UNet) -> AudioLDM2UNet:
    """Copy every resnet's conv weights once, in place, into the HWIO layout
    that K13 reads (non-persistent buffers: a checkpoint's keys do not
    change), for ``use_pallas_resnet``. ``AudioLDM2Pipeline`` calls it; re-run
    it after changing the float conv weights."""

    if not unet.config.use_pallas_resnet:
        raise ValueError("prepare_resnet_kernel_weights_: the UNet's config has use_pallas_resnet off")
    for _, res in unet.resnet_blocks():
        res.prepare_kernel_weights_()
    unet.drop_graphs()
    return unet


@torch.no_grad()
def quantize_unet_int8_(unet: AudioLDM2UNet) -> AudioLDM2UNet:
    """Quantize the int8 serving weights of every transformer site once, in
    place: per-output-channel int8 copies of the q/out projections and of
    both feed-forward weights, with their fp32 scales, as non-persistent
    buffers (a checkpoint's keys do not change). The counterpart of the JAX
    pipeline's "quant" collection (pipeline.py:374-445): the denoise step
    never quantizes a weight. Re-run it after changing the float weights."""

    if not unet.config.use_int8:
        raise ValueError("quantize_unet_int8_: the UNet's config has use_int8 off")
    for module in unet.modules():
        if isinstance(module, (CrossAttention, FeedForward)):
            module.quantize_int8_()
    unet.drop_graphs()
    return unet
