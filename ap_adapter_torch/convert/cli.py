"""Checkpoint conversion CLI: the public AudioLDM2 diffusers directory ->
the port's ``--checkpoint-dir``.

Counterpart of ``ap_adapter_tpu/convert/cli.py``. Converts a locally
downloaded ``cvssp/audioldm2-large`` pipeline directory, the AudioMAE
``pretrained.pth`` and the reference adapter ``pytorch_model.bin`` into one
fp32 ``<submodel>.npz`` per ``PipelineModules`` attribute, in the port's keys,
and ``config.json``::

    python -m ap_adapter_torch.convert.cli \\
        --audioldm2-dir /path/to/audioldm2-large \\
        --audiomae-ckpt /path/to/pretrained.pth \\
        --adapter-ckpt /path/to/pytorch_model.bin \\
        --out /path/to/converted

The port's modules carry the HF/diffusers names, so each submodel's mapping
is mostly the identity. It renames what differs, drops the keys the port has
no use for by an explicit list (checking a tied copy or a fixed table by
value first), and raises on any other key, naming it. Each submodel is read,
mapped, written and freed in turn. ``.safetensors`` files go through the
small reader here, not the ``safetensors`` package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import struct
from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from ap_adapter_torch import configs
from ap_adapter_torch.adapter.params import NAMES as ADAPTER_NAMES, adapter_sites
from ap_adapter_torch.models.layers import audiomae_pos_embed
from ap_adapter_torch.pipeline.pipeline import PipelineModules

StateDict = Dict[str, np.ndarray]

WEIGHT_NAMES = ("diffusion_pytorch_model.bin", "diffusion_pytorch_model.safetensors",
                "pytorch_model.bin", "model.safetensors")

# ---------------------------------------------------------------------------
# Reading torch checkpoints
# ---------------------------------------------------------------------------

# the weights' types, and I64 for the position/token-type buffers transformers writes
SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16, "I64": torch.int64}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file's tensors: a little-endian u64 header length,
    a JSON header of ``{name: {dtype, shape, data_offsets}}`` (and
    ``__metadata__``), then the raw little-endian bytes. The tensors are
    views of one buffer read whole."""

    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size - 8 - n
        buf = bytearray(size)
        if f.readinto(buf) != size:
            raise ValueError(f"{path}: truncated")
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which the reader does not take")
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        count = (end - start) // torch.empty((), dtype=dtype).element_size()
        flat = torch.frombuffer(buf, dtype=dtype, count=count, offset=start) if count else torch.empty(0, dtype=dtype)
        out[name] = flat.reshape(info["shape"])
    return out


def load_torch_weights(path_or_dir: str, *names: str) -> StateDict:
    """The fp32 numpy state dict of a file, or of the first of ``names``
    that exists in a directory: ``.safetensors`` through ``read_safetensors``,
    anything else through ``torch.load(weights_only=True)``, unwrapping a
    ``"state_dict"`` nesting and a ``"model"`` nesting of tensors."""

    candidates = [os.path.join(path_or_dir, n) for n in names] if os.path.isdir(path_or_dir) else [path_or_dir]
    for c in candidates:
        if not os.path.exists(c):
            continue
        if c.endswith(".safetensors"):
            sd = read_safetensors(c)
        else:
            sd = torch.load(c, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        if isinstance(sd, dict) and isinstance(sd.get("model"), dict) and all(
                torch.is_tensor(v) for v in sd["model"].values()):
            sd = sd["model"]
        return {k: sd.pop(k).float().numpy() for k in list(sd)}
    raise FileNotFoundError(f"no weights found under {path_or_dir} ({names})")


# ---------------------------------------------------------------------------
# PipelineConfig from the per-submodel config.json files
# ---------------------------------------------------------------------------


def _json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def build_config(audioldm2_dir: str) -> configs.PipelineConfig:
    """PipelineConfig from the diffusers pipeline's per-model config.json,
    field for field as the JAX package reads them."""

    cfg = configs.PipelineConfig()

    ucfg = _json(os.path.join(audioldm2_dir, "unet", "config.json"))
    down = ucfg["down_block_types"]
    up = ucfg["up_block_types"]
    cross = tuple(ucfg["cross_attention_dim"]) if isinstance(
        ucfg["cross_attention_dim"], (list, tuple)) else (ucfg["cross_attention_dim"],)
    unet = configs.UNetConfig(
        in_channels=ucfg["in_channels"],
        out_channels=ucfg["out_channels"],
        block_out_channels=tuple(ucfg["block_out_channels"]),
        down_block_has_attn=tuple(t == "CrossAttnDownBlock2D" for t in down),
        up_block_has_attn=tuple(t == "CrossAttnUpBlock2D" for t in up),
        layers_per_block=ucfg["layers_per_block"],
        transformer_layers_per_block=ucfg.get("transformer_layers_per_block", 1),
        cross_attention_dims=cross,
        num_attention_heads=ucfg.get("num_attention_heads") or ucfg.get("attention_head_dim", 8),
        norm_num_groups=ucfg.get("norm_num_groups", 32),
        norm_eps=ucfg.get("norm_eps", 1e-5),
        flip_sin_to_cos=ucfg.get("flip_sin_to_cos", True),
        freq_shift=ucfg.get("freq_shift", 0),
        # the adapter targets the GPT-2/AudioMAE stream, cross dim 1 (768 on
        # every published AudioLDM2 variant)
        adapter_cross_attention_dim=cross[1] if len(cross) > 1 and cross[1] else 768,
    )

    vcfg = _json(os.path.join(audioldm2_dir, "vae", "config.json"))
    vae = configs.VAEConfig(
        in_channels=vcfg["in_channels"],
        out_channels=vcfg["out_channels"],
        latent_channels=vcfg["latent_channels"],
        block_out_channels=tuple(vcfg["block_out_channels"]),
        layers_per_block=vcfg["layers_per_block"],
        norm_num_groups=vcfg.get("norm_num_groups", 32),
        scaling_factor=vcfg.get("scaling_factor", 0.18215),
        mid_block_attention=vcfg.get("mid_block_add_attention", True),
    )

    ocfg = _json(os.path.join(audioldm2_dir, "vocoder", "config.json"))
    voc = configs.VocoderConfig(
        model_in_dim=ocfg["model_in_dim"],
        sampling_rate=ocfg["sampling_rate"],
        upsample_initial_channel=ocfg["upsample_initial_channel"],
        upsample_rates=tuple(ocfg["upsample_rates"]),
        upsample_kernel_sizes=tuple(ocfg["upsample_kernel_sizes"]),
        resblock_kernel_sizes=tuple(ocfg["resblock_kernel_sizes"]),
        resblock_dilation_sizes=tuple(tuple(d) for d in ocfg["resblock_dilation_sizes"]),
        leaky_relu_slope=ocfg.get("leaky_relu_slope", 0.1),
        normalize_before=ocfg.get("normalize_before", False),
    )

    scfg = _json(os.path.join(audioldm2_dir, "scheduler", "scheduler_config.json"))
    sched = configs.SchedulerConfig(
        num_train_timesteps=scfg["num_train_timesteps"],
        beta_start=scfg["beta_start"],
        beta_end=scfg["beta_end"],
        beta_schedule=scfg["beta_schedule"],
        clip_sample=scfg.get("clip_sample", False),
        prediction_type=scfg.get("prediction_type", "epsilon"),
        set_alpha_to_one=scfg.get("set_alpha_to_one", False),
        steps_offset=scfg.get("steps_offset", 1),
        timestep_spacing=scfg.get("timestep_spacing", "leading"),
    )

    tcfg = _json(os.path.join(audioldm2_dir, "text_encoder", "config.json"))
    text_cfg = tcfg.get("text_config", tcfg)
    clap = configs.ClapTextConfig(
        vocab_size=text_cfg["vocab_size"],
        hidden_size=text_cfg["hidden_size"],
        num_layers=text_cfg["num_hidden_layers"],
        num_heads=text_cfg["num_attention_heads"],
        intermediate_size=text_cfg["intermediate_size"],
        max_position_embeddings=text_cfg["max_position_embeddings"],
        projection_dim=tcfg.get("projection_dim", text_cfg.get("projection_dim", 512)),
        pad_token_id=text_cfg.get("pad_token_id", 1),
    )

    t5cfg = _json(os.path.join(audioldm2_dir, "text_encoder_2", "config.json"))
    gated = t5cfg.get("is_gated_act") or "gated" in t5cfg.get("feed_forward_proj", "")
    t5 = configs.T5Config(
        vocab_size=t5cfg["vocab_size"],
        d_model=t5cfg["d_model"],
        d_kv=t5cfg["d_kv"],
        d_ff=t5cfg["d_ff"],
        num_layers=t5cfg["num_layers"],
        num_heads=t5cfg["num_heads"],
        relative_attention_num_buckets=t5cfg["relative_attention_num_buckets"],
        relative_attention_max_distance=t5cfg.get("relative_attention_max_distance", 128),
        feed_forward_proj="gated-gelu" if gated else "relu",
    )

    gcfg = _json(os.path.join(audioldm2_dir, "language_model", "config.json"))
    gpt2 = configs.GPT2Config(
        vocab_size=gcfg["vocab_size"],
        n_embd=gcfg["n_embd"],
        n_layer=gcfg["n_layer"],
        n_head=gcfg["n_head"],
        n_positions=gcfg["n_positions"],
        max_new_tokens=gcfg.get("max_new_tokens", 8),
    )

    pcfg = _json(os.path.join(audioldm2_dir, "projection_model", "config.json"))
    proj = configs.ProjectionConfig(
        text_encoder_dim=pcfg["text_encoder_dim"],
        text_encoder_1_dim=pcfg["text_encoder_1_dim"],
        language_model_dim=pcfg["langauge_model_dim"],  # [sic] diffusers typo
    )

    return cfg.replace(unet=unet, vae=vae, vocoder=voc, scheduler=sched, clap=clap, t5=t5, gpt2=gpt2,
                       projection=proj)


# ---------------------------------------------------------------------------
# Public state dicts -> the port's keys, one mapping per submodel
# ---------------------------------------------------------------------------


def _dropping(sd: Mapping[str, np.ndarray], drop: Callable[[str], bool]) -> StateDict:
    return {k: v for k, v in sd.items() if not drop(k)}


CLAP_DROPPED = ("text_model.embeddings.position_ids", "text_model.embeddings.token_type_ids",   # buffers
                "logit_scale_a", "logit_scale_t")
CLAP_DROPPED_PREFIXES = ("audio_model.", "audio_projection.")   # ClapModel's audio branch


def clap_state_dict(sd: Mapping[str, np.ndarray], config: configs.PipelineConfig) -> StateDict:
    """A ``ClapModel``, ``ClapTextModelWithProjection`` or bare
    ``ClapTextModel`` (no ``text_model.`` prefix) state dict -> the text
    branch; the buffers, the audio branch and the logit scales dropped."""

    if not any(k.startswith("text_model.") for k in sd):
        sd = {k if k.startswith("text_projection.") else "text_model." + k: v for k, v in sd.items()}
    return _dropping(sd, lambda k: k in CLAP_DROPPED or k.startswith(CLAP_DROPPED_PREFIXES))


def t5_state_dict(sd: Mapping[str, np.ndarray], config: configs.PipelineConfig) -> StateDict:
    """``T5EncoderModel``: ``encoder.embed_tokens.weight``, the tied copy of
    ``shared.weight``, dropped once it is found equal by value (a
    ``torch.save`` file may or may not share their storage)."""

    tied = "encoder.embed_tokens.weight"
    if tied in sd and not np.array_equal(sd[tied], sd["shared.weight"]):
        raise ValueError(f"t5: {tied} differs from shared.weight; the port ties them")
    return _dropping(sd, lambda k: k == tied)


GPT2_BUFFER = re.compile(r"h\.\d+\.attn\.(bias|masked_bias)")


def gpt2_state_dict(sd: Mapping[str, np.ndarray], config: configs.PipelineConfig) -> StateDict:
    """``GPT2Model``: ``wte.weight`` dropped (AudioLDM2 feeds
    ``inputs_embeds``), and the causal-mask buffers where a file has them."""

    return _dropping(sd, lambda k: k == "wte.weight" or GPT2_BUFFER.fullmatch(k) is not None)


def vocoder_state_dict(sd: Mapping[str, np.ndarray], config: configs.PipelineConfig) -> StateDict:
    """``SpeechT5HifiGan``: ``mean``/``scale`` dropped unless the config
    normalizes the mel before the first conv."""

    if config.vocoder.normalize_before:
        return dict(sd)
    return _dropping(sd, lambda k: k in ("mean", "scale"))


def identity_state_dict(sd: Mapping[str, np.ndarray], config: configs.PipelineConfig) -> StateDict:
    """The projection model and the VAE carry the port's keys as they are."""

    return dict(sd)


ADAPTER_KEY = re.compile(r"(?P<site>.+?)(?:\.processor)?\.(?P<name>to_[kv]_ip)\.weight")


def unet_state_dict(sd: Mapping[str, np.ndarray], config: configs.PipelineConfig,
                    adapter: Optional[Mapping[str, np.ndarray]] = None) -> StateDict:
    """``AudioLDM2UNet2DConditionModel``, with the flat ``adapter`` merged by
    name (``<site>.processor.to_k_ip.weight``, or the name without
    ``.processor``; any other key raises). A site with no adapter weights
    from either takes copies of its own ``to_k``/``to_v`` (the zero-delta
    init the published UNet, which has none, starts from)."""

    out = dict(sd)
    sites = adapter_sites(config.unet)
    site_set = set(sites)
    for k, v in (adapter or {}).items():
        m = ADAPTER_KEY.fullmatch(k)
        if m is None or m["site"] not in site_set:
            raise KeyError(f"adapter: unexpected key {k!r}")
        out[f"{m['site']}.processor.{m['name']}.weight"] = v
    for site in sites:
        for name in ADAPTER_NAMES:
            key = f"{site}.processor.{name}.weight"
            if key not in out:
                out[key] = out[f"{site}.{name[:-3]}.weight"].copy()
    return out


AUDIOMAE_PREFIXES = ("audiomae.model.", "model.", "")


def audiomae_state_dict(sd: Mapping[str, np.ndarray], config: configs.PipelineConfig) -> StateDict:
    """An AudioMAE checkpoint (bare timm names, the reference's
    ``audiomae.model.`` prefix, or ``model.``) -> the conditioner's
    ``model.*`` keys. The MAE decoder (``decoder_*``, ``mask_token``) is
    dropped, and ``pos_embed`` too once it is found to be the fixed sin-cos
    table of the config's token grid (within 1e-6: the reference computes it
    in float64 and stores it in fp32)."""

    prefix = next((p for p in AUDIOMAE_PREFIXES if p + "cls_token" in sd), None)
    if prefix is None:
        raise KeyError("audiomae: no cls_token under any of the prefixes " + repr(AUDIOMAE_PREFIXES))
    out = {}
    for k, v in sd.items():
        if not k.startswith(prefix):
            raise KeyError(f"audiomae: unexpected key {k!r} (the weights are under {prefix!r})")
        name = k[len(prefix):]
        if name == "pos_embed":
            t, f = config.audiomae.grid_size
            want = audiomae_pos_embed(v.shape[-1], (f, t))
            if v.size != want.size or not np.allclose(v.reshape(want.shape), want, rtol=0.0, atol=1e-6):
                raise ValueError(f"audiomae: {k} is not the fixed sin-cos table of the {t} x {f} token grid")
        elif not (name.startswith("decoder_") or name == "mask_token"):
            out["model." + name] = v
    return out


# (port submodel, diffusers subdirectory or None, mapping)
SUBMODELS = (
    ("clap", "text_encoder", clap_state_dict),
    ("t5", "text_encoder_2", t5_state_dict),
    ("gpt2", "language_model", gpt2_state_dict),
    ("projection", "projection_model", identity_state_dict),
    ("unet", "unet", unet_state_dict),
    ("vae", "vae", identity_state_dict),
    ("vocoder", "vocoder", vocoder_state_dict),
    ("audiomae", None, audiomae_state_dict),
)


def expected_keys(config: configs.PipelineConfig) -> Dict[str, set]:
    """The state-dict keys of every ``PipelineModules`` submodel (built on
    the meta device: no memory)."""

    modules = PipelineModules(config)
    return {name: set(getattr(modules, name).state_dict()) for name in PipelineModules.NAMES}


def check_keys(name: str, sd: Mapping[str, np.ndarray], want: Iterable[str]) -> None:
    """Raise on any key the mapping left that the port does not hold, and on
    any the port holds that the mapping did not give."""

    want = set(want)
    extra, missing = sorted(set(sd) - want), sorted(want - set(sd))
    if extra:
        raise KeyError(f"{name}: unexpected keys {extra[:8]}")
    if missing:
        raise KeyError(f"{name}: missing keys {missing[:8]}")


def convert(
    audioldm2_dir: str,
    out_dir: str,
    audiomae_ckpt: Optional[str] = None,
    adapter_ckpt: Optional[str] = None,
) -> configs.PipelineConfig:
    """Write ``<out_dir>/<submodel>.npz`` (fp32, the port's keys) for every
    submodel, ``audiomae.npz`` only with ``audiomae_ckpt``, and
    ``config.json``; returns the config."""

    cfg = build_config(audioldm2_dir)
    want = expected_keys(cfg)
    os.makedirs(out_dir, exist_ok=True)
    for name, sub, mapping in SUBMODELS:
        if sub is None and not audiomae_ckpt:
            continue
        sd = load_torch_weights(os.path.join(audioldm2_dir, sub), *WEIGHT_NAMES) if sub else \
            load_torch_weights(audiomae_ckpt)
        if name == "unet" and adapter_ckpt:
            sd = mapping(sd, cfg, load_torch_weights(adapter_ckpt))
        else:
            sd = mapping(sd, cfg)
        check_keys(name, sd, want[name])
        np.savez(os.path.join(out_dir, f"{name}.npz"), **sd)
        del sd
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg.replace(dtype=None)), f, indent=2, default=str)
    return cfg


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="convert AudioLDM2 torch checkpoints into the port's --checkpoint-dir")
    p.add_argument("--audioldm2-dir", required=True, help="the diffusers cvssp/audioldm2-large directory")
    p.add_argument("--audiomae-ckpt", default=None, help="AudioMAE pretrained.pth (audiomae.npz is written only "
                   "with it; the port's entry points need it)")
    p.add_argument("--adapter-ckpt", default=None, help="the reference adapter pytorch_model.bin, merged into the UNet")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    convert(args.audioldm2_dir, args.out, args.audiomae_ckpt, args.adapter_ckpt)
    print(f"converted -> {args.out}")


if __name__ == "__main__":
    main()
