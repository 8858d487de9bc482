"""JAX/Flax param trees -> the port's HF/diffusers state dicts (numpy).

The exact inverse of ``ap_adapter_tpu/convert/torch_import.py``: each
``*_state_dict(tree)`` here, fed back through the matching
``torch_import.*_params``, gives the tree back unchanged. Takes nested dicts
of numpy arrays (``ap_adapter_tpu`` ``PipelineModules.init_params`` output
after ``np.asarray``); this module imports neither jax nor the JAX package.

Conventions (Flax -> torch):
  * Dense ``kernel`` [in, out]                 -> Linear ``weight`` [out, in]
  * Conv ``kernel`` [kh, kw, in, out]          -> Conv2d ``weight`` [out, in, kh, kw]
  * Conv ``kernel`` [w, in, out]               -> Conv1d ``weight`` [out, in, w]
  * ConvTranspose ``kernel`` [w, in, out]      -> ConvTranspose1d ``weight`` [in, out, w]
    (no flip: the JAX module flips inside its forward)
  * norm ``scale``                             -> ``weight``
  * stacked Transformer2D leaves [L, ...]      -> ``transformer_blocks.{t}``
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

Tree = Mapping[str, object]
StateDict = Dict[str, np.ndarray]


def _a(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x))


def _linear(sd: StateDict, prefix: str, p: Tree) -> None:
    sd[f"{prefix}.weight"] = _a(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _a(p["bias"])


def _conv2d(sd: StateDict, prefix: str, p: Tree) -> None:
    sd[f"{prefix}.weight"] = _a(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _a(p["bias"])


def _conv1d(sd: StateDict, prefix: str, p: Tree) -> None:
    sd[f"{prefix}.weight"] = _a(np.asarray(p["kernel"]).transpose(2, 1, 0))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _a(p["bias"])


def _conv_transpose1d(sd: StateDict, prefix: str, p: Tree) -> None:
    sd[f"{prefix}.weight"] = _a(np.asarray(p["kernel"]).transpose(1, 2, 0))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _a(p["bias"])


def _conv1x1_dense(sd: StateDict, prefix: str, p: Tree) -> None:
    """Dense kernel [in, out] -> 1x1 Conv2d weight [out, in, 1, 1]."""

    sd[f"{prefix}.weight"] = _a(np.asarray(p["kernel"]).T[:, :, None, None])
    if "bias" in p:
        sd[f"{prefix}.bias"] = _a(p["bias"])


def _norm(sd: StateDict, prefix: str, p: Tree) -> None:
    sd[f"{prefix}.weight"] = _a(p["scale"])
    sd[f"{prefix}.bias"] = _a(p["bias"])


def _index(tree, t: int):
    """Leaf-wise ``[t]`` of a stacked tree."""

    if isinstance(tree, Mapping):
        return {k: _index(v, t) for k, v in tree.items()}
    return np.asarray(tree)[t]


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------


def _attention(sd: StateDict, prefix: str, p: Tree, has_adapter: bool) -> None:
    for n in ("to_q", "to_k", "to_v"):
        _linear(sd, f"{prefix}.{n}", p[n])
    _linear(sd, f"{prefix}.to_out.0", p["to_out"])
    if has_adapter:
        _linear(sd, f"{prefix}.processor.to_k_ip", p["to_k_ip"])
        _linear(sd, f"{prefix}.processor.to_v_ip", p["to_v_ip"])


def _transformer2d(sd: StateDict, prefix: str, p: Tree, num_layers: int, has_adapter: bool) -> None:
    _norm(sd, f"{prefix}.norm", p["norm"])
    _conv1x1_dense(sd, f"{prefix}.proj_in", p["proj_in"])
    _conv1x1_dense(sd, f"{prefix}.proj_out", p["proj_out"])
    for t in range(num_layers):
        b = _index(p["transformer_blocks"], t)
        tp = f"{prefix}.transformer_blocks.{t}"
        _norm(sd, f"{tp}.norm1", b["norm1"])
        _attention(sd, f"{tp}.attn1", b["attn1"], False)
        _norm(sd, f"{tp}.norm2", b["norm2"])
        _attention(sd, f"{tp}.attn2", b["attn2"], has_adapter)
        _norm(sd, f"{tp}.norm3", b["norm3"])
        _linear(sd, f"{tp}.ff.net.0.proj", b["ff"]["geglu_proj"])
        _linear(sd, f"{tp}.ff.net.2", b["ff"]["out_proj"])


def _resnet(sd: StateDict, prefix: str, p: Tree) -> None:
    _norm(sd, f"{prefix}.norm1", p["norm1"])
    _conv2d(sd, f"{prefix}.conv1", p["conv1"])
    _norm(sd, f"{prefix}.norm2", p["norm2"])
    _conv2d(sd, f"{prefix}.conv2", p["conv2"])
    if "time_emb_proj" in p:
        _linear(sd, f"{prefix}.time_emb_proj", p["time_emb_proj"])
    if "conv_shortcut" in p:
        _conv2d(sd, f"{prefix}.conv_shortcut", p["conv_shortcut"])


def unet_state_dict(tree: Tree, config) -> StateDict:
    """``config``: the UNetConfig (topology)."""

    sd: StateDict = {}
    dims = config.cross_attention_dims
    n_blocks = len(config.block_out_channels)
    _conv2d(sd, "conv_in", tree["conv_in"])
    _linear(sd, "time_embedding.linear_1", tree["time_embedding_linear_1"])
    _linear(sd, "time_embedding.linear_2", tree["time_embedding_linear_2"])
    _norm(sd, "conv_norm_out", tree["conv_norm_out"])
    _conv2d(sd, "conv_out", tree["conv_out"])

    def attn_group(tprefix: str, name: str, layer: int) -> None:
        for idx, dim in enumerate(dims):
            _transformer2d(sd, f"{tprefix}.attentions.{layer * len(dims) + idx}",
                           tree[name][f"attentions_{idx}"], config.transformer_layers_per_block,
                           dim is not None and dim == config.adapter_cross_attention_dim)

    for b in range(n_blocks):
        for l in range(config.layers_per_block):
            _resnet(sd, f"down_blocks.{b}.resnets.{l}", tree[f"down_{b}_resnet_{l}"])
            if config.down_block_has_attn[b]:
                attn_group(f"down_blocks.{b}", f"down_{b}_attn_{l}", l)
        if b < n_blocks - 1:
            _conv2d(sd, f"down_blocks.{b}.downsamplers.0.conv", tree[f"down_{b}_downsample"]["conv"])
    _resnet(sd, "mid_block.resnets.0", tree["mid_resnet_0"])
    _resnet(sd, "mid_block.resnets.1", tree["mid_resnet_1"])
    attn_group("mid_block", "mid_attn_0", 0)
    for b in range(n_blocks):
        for l in range(config.layers_per_block + 1):
            _resnet(sd, f"up_blocks.{b}.resnets.{l}", tree[f"up_{b}_resnet_{l}"])
            if config.up_block_has_attn[b]:
                attn_group(f"up_blocks.{b}", f"up_{b}_attn_{l}", l)
        if b < n_blocks - 1:
            _conv2d(sd, f"up_blocks.{b}.upsamplers.0.conv", tree[f"up_{b}_upsample"]["conv"])
    return sd


# ---------------------------------------------------------------------------
# VAE and vocoder
# ---------------------------------------------------------------------------


def _vae_mid(sd: StateDict, prefix: str, p: Tree) -> None:
    _resnet(sd, f"{prefix}.mid_block.resnets.0", p["mid_resnet_0"])
    _resnet(sd, f"{prefix}.mid_block.resnets.1", p["mid_resnet_1"])
    if "mid_attn" in p:
        ap, a = f"{prefix}.mid_block.attentions.0", p["mid_attn"]
        _norm(sd, f"{ap}.group_norm", a["group_norm"])
        for n in ("to_q", "to_k", "to_v"):
            _linear(sd, f"{ap}.{n}", a[n])
        _linear(sd, f"{ap}.to_out.0", a["to_out"])


def vae_state_dict(tree: Tree, config) -> StateDict:
    """Encoder and decoder (the port's decode-only VAE loads the decoder half)."""

    sd: StateDict = {}
    n = len(config.block_out_channels)
    enc, dec = tree["encoder"], tree["decoder"]
    for part, p in (("encoder", enc), ("decoder", dec)):
        _conv2d(sd, f"{part}.conv_in", p["conv_in"])
        _norm(sd, f"{part}.conv_norm_out", p["conv_norm_out"])
        _conv2d(sd, f"{part}.conv_out", p["conv_out"])
        _vae_mid(sd, part, p)
    for b in range(n):
        for l in range(config.layers_per_block):
            _resnet(sd, f"encoder.down_blocks.{b}.resnets.{l}", enc[f"down_{b}_resnet_{l}"])
        if b < n - 1:
            _conv2d(sd, f"encoder.down_blocks.{b}.downsamplers.0.conv", enc[f"down_{b}_downsample"]["conv"])
        for l in range(config.layers_per_block + 1):
            _resnet(sd, f"decoder.up_blocks.{b}.resnets.{l}", dec[f"up_{b}_resnet_{l}"])
        if b < n - 1:
            _conv2d(sd, f"decoder.up_blocks.{b}.upsamplers.0.conv", dec[f"up_{b}_upsample"]["conv"])
    _conv1x1_dense(sd, "quant_conv", tree["quant_conv"])
    _conv1x1_dense(sd, "post_quant_conv", tree["post_quant_conv"])
    return sd


def vocoder_state_dict(tree: Tree, config) -> StateDict:
    sd: StateDict = {}
    _conv1d(sd, "conv_pre", tree["conv_pre"])
    _conv1d(sd, "conv_post", tree["conv_post"])
    for n in ("mean", "scale"):
        if n in tree:
            sd[n] = _a(tree[n])
    nk = len(config.resblock_kernel_sizes)
    for i in range(len(config.upsample_rates)):
        _conv_transpose1d(sd, f"upsampler.{i}", tree[f"upsampler_{i}"])
        for j in range(nk):
            rb = tree[f"resblock_{i}_{j}"]
            for m in range(len(config.resblock_dilation_sizes[j])):
                _conv1d(sd, f"resblocks.{i * nk + j}.convs1.{m}", rb[f"convs1_{m}"])
                _conv1d(sd, f"resblocks.{i * nk + j}.convs2.{m}", rb[f"convs2_{m}"])
    return sd


# ---------------------------------------------------------------------------
# Conditioning encoders
# ---------------------------------------------------------------------------


def audiomae_condition_state_dict(tree: Tree, depth: int) -> StateDict:
    """AudioMAECondition tree ({"audiomae": encoder}) -> ``model.*`` keys."""

    p = tree["audiomae"]
    sd: StateDict = {"model.cls_token": _a(p["cls_token"])}
    _conv2d(sd, "model.patch_embed.proj", p["patch_embed"])
    _norm(sd, "model.norm", p["norm"])
    for i in range(depth):
        b, pre = p[f"block_{i}"], f"model.blocks.{i}"
        _norm(sd, f"{pre}.norm1", b["norm1"])
        _linear(sd, f"{pre}.attn.qkv", b["attn"]["qkv"])
        _linear(sd, f"{pre}.attn.proj", b["attn"]["proj"])
        _norm(sd, f"{pre}.norm2", b["norm2"])
        _linear(sd, f"{pre}.mlp.fc1", b["fc1"])
        _linear(sd, f"{pre}.mlp.fc2", b["fc2"])
    return sd


def clap_text_state_dict(tree: Tree, num_layers: int) -> StateDict:
    pre = "text_model."
    sd: StateDict = {}
    for n in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"{pre}embeddings.{n}.weight"] = _a(tree[n]["embedding"])
    _norm(sd, f"{pre}embeddings.LayerNorm", tree["embeddings_norm"])
    _linear(sd, f"{pre}pooler.dense", tree["pooler"])
    _linear(sd, "text_projection.linear1", tree["projection_1"])
    _linear(sd, "text_projection.linear2", tree["projection_2"])
    for i in range(num_layers):
        lp, p = f"{pre}encoder.layer.{i}", tree[f"layer_{i}"]
        for n in ("query", "key", "value"):
            _linear(sd, f"{lp}.attention.self.{n}", p["self"][n])
        _linear(sd, f"{lp}.attention.output.dense", p["attn_out"])
        _norm(sd, f"{lp}.attention.output.LayerNorm", p["attn_norm"])
        _linear(sd, f"{lp}.intermediate.dense", p["intermediate"])
        _linear(sd, f"{lp}.output.dense", p["output"])
        _norm(sd, f"{lp}.output.LayerNorm", p["out_norm"])
    return sd


def t5_encoder_state_dict(tree: Tree, num_layers: int) -> StateDict:
    sd: StateDict = {"shared.weight": _a(tree["shared"]["embedding"]),
                     "encoder.final_layer_norm.weight": _a(tree["final_norm"]["scale"])}
    for i in range(num_layers):
        p, bp = tree[f"block_{i}"], f"encoder.block.{i}"
        sd[f"{bp}.layer.0.layer_norm.weight"] = _a(p["attn_norm"]["scale"])
        for n in ("q", "k", "v", "o"):
            _linear(sd, f"{bp}.layer.0.SelfAttention.{n}", p["attention"][n])
        if "relative_attention_bias" in p["attention"]:
            sd[f"{bp}.layer.0.SelfAttention.relative_attention_bias.weight"] = _a(
                p["attention"]["relative_attention_bias"])
        sd[f"{bp}.layer.1.layer_norm.weight"] = _a(p["ff_norm"]["scale"])
        for n in ("wi_0", "wi_1", "wi", "wo"):
            if n in p:
                _linear(sd, f"{bp}.layer.1.DenseReluDense.{n}", p[n])
    return sd


def gpt2_state_dict(tree: Tree, num_layers: int) -> StateDict:
    """HF GPT-2 Conv1D weights are [in, out], like the Dense kernels: no transpose."""

    sd: StateDict = {"wpe.weight": _a(tree["wpe"]["embedding"])}
    _norm(sd, "ln_f", tree["ln_f"])

    def conv1d(prefix, p):
        sd[f"{prefix}.weight"] = _a(p["kernel"])
        sd[f"{prefix}.bias"] = _a(p["bias"])

    for i in range(num_layers):
        p, hp = tree[f"h_{i}"], f"h.{i}"
        _norm(sd, f"{hp}.ln_1", p["ln_1"])
        conv1d(f"{hp}.attn.c_attn", p["attn"]["c_attn"])
        conv1d(f"{hp}.attn.c_proj", p["attn"]["c_proj"])
        _norm(sd, f"{hp}.ln_2", p["ln_2"])
        conv1d(f"{hp}.mlp.c_fc", p["c_fc"])
        conv1d(f"{hp}.mlp.c_proj", p["c_proj"])
    return sd


def projection_state_dict(tree: Tree) -> StateDict:
    sd: StateDict = {}
    _linear(sd, "projection", tree["projection"])
    _linear(sd, "projection_1", tree["projection_1"])
    for n in ("sos_embed", "eos_embed", "sos_embed_1", "eos_embed_1"):
        sd[n] = _a(tree[n])
    return sd


def pipeline_state_dicts(params: Tree, config) -> Dict[str, StateDict]:
    """Every submodel of a JAX ``PipelineModules.init_params`` tree, keyed
    like the port's ``PipelineModules`` attributes; ``config`` is the port's
    (or the JAX package's) PipelineConfig."""

    c = config
    return {
        "clap": clap_text_state_dict(params["clap"], c.clap.num_layers),
        "t5": t5_encoder_state_dict(params["t5"], c.t5.num_layers),
        "gpt2": gpt2_state_dict(params["gpt2"], c.gpt2.n_layer),
        "projection": projection_state_dict(params["projection"]),
        "audiomae": audiomae_condition_state_dict(params["audiomae"], c.audiomae.depth),
        "unet": unet_state_dict(params["unet"], c.unet),
        "vae": vae_state_dict(params["vae"], c.vae),
        "vocoder": vocoder_state_dict(params["vocoder"], c.vocoder),
    }
