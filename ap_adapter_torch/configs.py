"""Configuration tree for ap_adapter_torch (a jax-free copy of
``ap_adapter_tpu.configs``).

One dataclass config tree replaces the reference's three config tiers
(task dicts in ``config.py``, trainer argparse in ``train_apadapter_v2.py``,
shell env vars in ``train.sh``; SURVEY.md §5).

Defaults reproduce the ``cvssp/audioldm2-large`` stack the reference targets
(reference: inference.py:13). Structural facts are derived from the shipped
adapter weights in ``copied_cross_attention/`` (hidden sizes 256/384/640) and
``pipeline/modeling_audioldm2.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch


# ---------------------------------------------------------------------------
# Audio front-ends
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FbankConfig:
    """Kaldi-compatible log-mel filterbank for AudioMAE.

    Matches ``torchaudio.compliance.kaldi.fbank(htk_compat=True,
    sample_frequency=16000, use_energy=False, window_type='hanning',
    num_mel_bins=128, dither=0.0, frame_shift=10)`` as called at
    reference audio_encoder/AudioMAE.py:368-377.
    """

    sample_rate: int = 16_000
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    num_mel_bins: int = 128
    low_freq: float = 20.0
    high_freq: float = 0.0  # <=0 means nyquist + high_freq
    preemphasis: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "hanning"
    use_power: bool = True
    round_to_power_of_two: bool = True
    snip_edges: bool = True
    target_frames: int = 1024  # pad/cut (reference AudioMAE.py:379-390)
    # AudioSet normalization stats (reference AudioMAE.py:357-358)
    norm_mean: float = -4.2677393
    norm_std: float = 4.5689974

    @property
    def frame_length(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000.0)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000.0)

    @property
    def padded_window_size(self) -> int:
        n = self.frame_length
        if self.round_to_power_of_two:
            p = 1
            while p < n:
                p *= 2
            return p
        return n


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """Tacotron-style STFT mel front-end for the VAE.

    Matches the ``audioldm`` package's ``TacotronSTFT`` defaults as used at
    reference train_apadapter_v2.py:308-336: filter 1024 / hop 160 / win 1024,
    64 slaney-scale mel bins over 0-8 kHz, log-clamp at 1e-5.
    """

    sample_rate: int = 16_000
    n_fft: int = 1024
    hop_length: int = 160
    win_length: int = 1024
    num_mel_bins: int = 64
    mel_fmin: float = 0.0
    mel_fmax: float = 8_000.0
    log_clamp: float = 1e-5
    frames_per_second: float = 102.4  # target_length = duration * 102.4


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AudioMAEConfig:
    """ViT-B/16 AudioMAE encoder (reference audio_encoder/models_mae.py:689)."""

    img_size: Tuple[int, int] = (1024, 128)
    patch_size: int = 16
    in_chans: int = 1
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-6
    contextual_depth: int = 8  # used by the contextual-average path
    # MAE pretraining decoder (reference models_mae.py mae_vit_base_patch16 =
    # *_dec512d8b: 512-dim, 8 plain ViT blocks, 16 heads, decoder_mode=0).
    # Inference never touches these; models/mae_pretrain.py does.
    decoder_embed_dim: int = 512
    decoder_depth: int = 8
    decoder_num_heads: int = 16
    mask_ratio: float = 0.8       # models_mae.py forward() default
    mask_t_prob: float = 0.6      # models_mae.py:182 default
    mask_f_prob: float = 0.5      # models_mae.py:183 default

    @property
    def grid_size(self) -> Tuple[int, int]:
        # (time, freq) token grid: 64 x 8 for (1024, 128) inputs
        return (self.img_size[0] // self.patch_size, self.img_size[1] // self.patch_size)

    @property
    def num_patches(self) -> int:
        t, f = self.grid_size
        return t * f


@dataclasses.dataclass(frozen=True)
class ClapTextConfig:
    """CLAP text branch (RoBERTa encoder + 2-layer MLP projection).

    Mirrors transformers ``ClapTextModelWithProjection`` used through
    ``ClapModel.get_text_features`` (reference pipeline_audioldm2.py:404-412).
    """

    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 1
    projection_dim: int = 512
    max_length: int = 512  # tokenizer model_max_length padding target


@dataclasses.dataclass(frozen=True)
class ClapAudioConfig:
    """CLAP audio tower (HTSAT Swin transformer) — used for CLAP-similarity
    scoring/re-ranking (reference pipeline_audioldm2.py:592-614)."""

    spec_size: int = 256
    patch_size: int = 4
    patch_stride: Tuple[int, int] = (4, 4)
    patch_embeds_hidden_size: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    num_mel_bins: int = 64
    layer_norm_eps: float = 1e-5
    projection_dim: int = 512
    # feature extractor (transformers ClapFeatureExtractor defaults)
    sampling_rate: int = 48_000
    n_fft: int = 1024
    hop_length: int = 480
    frequency_min: float = 50.0
    frequency_max: float = 14_000.0
    max_length_s: int = 10

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.num_mel_bins

    @property
    def hidden_size(self) -> int:
        return self.patch_embeds_hidden_size * 2 ** (len(self.depths) - 1)


@dataclasses.dataclass(frozen=True)
class T5Config:
    """T5 encoder (flan-t5-large) — reference pipeline_audioldm2.py:413-418."""

    vocab_size: int = 32128
    d_model: int = 1024
    d_kv: int = 64
    d_ff: int = 2816
    num_layers: int = 24
    num_heads: int = 16
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    feed_forward_proj: str = "gated-gelu"


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    """GPT-2 hidden-state language model (reference pipeline_audioldm2.py:231)."""

    vocab_size: int = 50257
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_positions: int = 1024
    layer_norm_eps: float = 1e-5
    max_new_tokens: int = 8


@dataclasses.dataclass(frozen=True)
class ProjectionConfig:
    """AudioLDM2ProjectionModel (reference modeling_audioldm2.py:82-145)."""

    text_encoder_dim: int = 512  # CLAP projection_dim
    text_encoder_1_dim: int = 1024  # T5 d_model
    language_model_dim: int = 768  # GPT-2 n_embd


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Dual-stream AudioLDM2 UNet (reference modeling_audioldm2.py:148-873).

    Per attention "layer": one Transformer2DModel per entry of
    ``cross_attention_dims`` — ``None`` entries are double-self-attention;
    stream routing is idx<=1 -> (GPT2+AudioMAE, 768) and idx>1 -> (T5, 1024)
    (reference modeling_audioldm2.py:1140-1156).
    """

    in_channels: int = 8
    out_channels: int = 8
    block_out_channels: Tuple[int, ...] = (128, 256, 384, 640)
    # True where the block carries cross-attention transformer groups.
    # Derived from shipped adapter sites: down_blocks.{1,2,3}, up_blocks.{0,1,2}.
    down_block_has_attn: Tuple[bool, ...] = (False, True, True, True)
    up_block_has_attn: Tuple[bool, ...] = (True, True, True, False)
    layers_per_block: int = 2
    transformer_layers_per_block: int = 2  # transformer_blocks.{0,1} in ckpt names
    cross_attention_dims: Tuple[Optional[int], ...] = (None, 768, 1024, None)
    num_attention_heads: int = 8
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    act_fn: str = "silu"
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    conv_in_kernel: int = 3
    conv_out_kernel: int = 3
    downsample_padding: int = 1
    # adapter (decoupled audio KV) settings — reference attention_processor.py:297-470
    adapter_cross_attention_dim: int = 768  # only 768-dim sites get the adapter
    adapter_num_tokens: int = 8  # first 8 tokens = GPT-2, rest = AudioMAE
    # ControlNet-branch attention semantics (reference CNAttnProcessor2_0,
    # attention_processor.py:538-623): drop the trailing AudioMAE tokens from
    # the 768-dim stream and attend TEXT-ONLY with no adapter K/V. Used when
    # this UNet is instantiated as a ControlNet copy; adapter params are not
    # created in this mode.
    cn_text_only: bool = False
    # class embedding (AudioLDM v1: CLAP embedding as "simple_projection"
    # class label concatenated with the time embedding)
    class_embed_dim: Optional[int] = None
    class_embeddings_concat: bool = False
    # fused dual-KV attention kernel (the JAX package's TPU-only switch).
    # Here it routes every cross site with audio tokens to the unfused route
    # (LN, q projection, K10 ops/dual_kv_attention.py, out projection) in
    # place of K2/K4; the T5 and text-only sites keep theirs, and use_int8
    # comes first. Inference only: K10 has no backward, so the trainer
    # refuses this.
    use_pallas_attention: bool = False
    # fused GroupNorm+SiLU kernel at the resnet norm sites — opt-in
    # (the JAX package measured it at parity-or-slower vs XLA's fused GN at
    # UNet shapes on the TPU, docs/PERF.md negative results). Here it routes
    # norm1/norm2 + SiLU of every UNet resnet to K12 (ops/groupnorm.py).
    use_pallas_groupnorm: bool = False
    # fully-fused resnet block kernel: both GN+SiLU passes + both 3x3 convs +
    # temb + shortcut. Here it routes every UNet resnet to K13
    # (ops/resnet.py); with both switches on, K13 runs and K12 does not.
    use_pallas_resnet: bool = False
    # int8 W8A8 serving (ops/int8.py): every transformer site runs its int8
    # kernel (K11a-c) on weights quantized once (models/unet.py
    # quantize_unet_int8_). Inference only: the int8 kernels have no
    # backward, so the trainer refuses this.
    use_int8: bool = False
    # recompute each resnet and attention group in the backward pass
    # (torch.utils.checkpoint, the JAX package's nn.remat over the same
    # units): activation memory shrinks, and the forward kernels of every
    # group from the first adapter site on launch again. No effect where no
    # gradient is recorded (serving, validation).
    remat: bool = False
    # the JAX package's GSPMD-partitionable core, which its TP serving
    # forces. Here it routes every transformer site outside the kernels:
    # LN, plain projections, ops/attention.py's sdpa (never K5/K6, K10) and
    # the GEGLU, with the out projection's bias added after the sum over
    # the tensor-parallel ranks (parallel/tp.py). It comes before use_int8
    # and use_pallas_attention.
    force_xla_core: bool = False

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """KL autoencoder over mel spectrograms (8-ch latent, 4x scale).

    ``vae_scale_factor = 2 ** (len(block_out_channels) - 1) = 4``
    (reference pipeline_audioldm2.py:176).
    """

    in_channels: int = 1
    out_channels: int = 1
    latent_channels: int = 8
    block_out_channels: Tuple[int, ...] = (128, 256, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.9227914214134216  # from cvssp/audioldm2 vae config
    mid_block_attention: bool = True

    @property
    def scale_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    """SpeechT5 HiFi-GAN vocoder (reference pipeline_audioldm2.py:583-590)."""

    model_in_dim: int = 64
    sampling_rate: int = 16_000
    upsample_initial_channel: int = 1024
    upsample_rates: Tuple[int, ...] = (5, 4, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 8, 4, 4)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    leaky_relu_slope: float = 0.1
    normalize_before: bool = False

    @property
    def upsample_factor(self) -> int:
        f = 1
        for r in self.upsample_rates:
            f *= r
        return f


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """DDIM scheduler (cvssp/audioldm2 scheduler config defaults)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.0015
    beta_end: float = 0.0195
    beta_schedule: str = "scaled_linear"
    clip_sample: bool = False
    prediction_type: str = "epsilon"  # or "v_prediction"
    set_alpha_to_one: bool = False
    steps_offset: int = 1
    timestep_spacing: str = "leading"


# ---------------------------------------------------------------------------
# Composite pipeline + task templates
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    fbank: FbankConfig = dataclasses.field(default_factory=FbankConfig)
    mel: MelConfig = dataclasses.field(default_factory=MelConfig)
    audiomae: AudioMAEConfig = dataclasses.field(default_factory=AudioMAEConfig)
    clap: ClapTextConfig = dataclasses.field(default_factory=ClapTextConfig)
    t5: T5Config = dataclasses.field(default_factory=T5Config)
    gpt2: GPT2Config = dataclasses.field(default_factory=GPT2Config)
    projection: ProjectionConfig = dataclasses.field(default_factory=ProjectionConfig)
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    vocoder: VocoderConfig = dataclasses.field(default_factory=VocoderConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    dtype: Any = torch.bfloat16  # compute dtype
    # hoist step-invariant work out of the denoise scan (models/hoist.py):
    # cross-attention K/V + T5 bias + the timestep-embedding tables are
    # precomputed once per generate call instead of once per DDIM step
    hoist_step_invariants: bool = True

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def tiny_pipeline_config(dtype: Any = torch.float32) -> PipelineConfig:
    """A miniature config for tests / CPU dry runs (same topology, tiny dims)."""

    return PipelineConfig(
        audiomae=AudioMAEConfig(img_size=(64, 32), patch_size=16, embed_dim=32, depth=2, num_heads=2),
        # fbank geometry MATCHES audiomae.img_size so prepare_fbank feeds the
        # tiny AudioMAE directly (full config: 1024x128)
        fbank=FbankConfig(target_frames=64, num_mel_bins=32),
        clap=ClapTextConfig(
            vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=64, projection_dim=16,
            max_length=16,
        ),
        t5=T5Config(vocab_size=128, d_model=48, d_kv=12, d_ff=96, num_layers=2, num_heads=4),
        gpt2=GPT2Config(vocab_size=128, n_embd=32, n_layer=2, n_head=2, n_positions=128),
        projection=ProjectionConfig(text_encoder_dim=16, text_encoder_1_dim=48, language_model_dim=32),
        unet=UNetConfig(
            block_out_channels=(32, 32, 32, 32),
            cross_attention_dims=(None, 32, 48, None),
            num_attention_heads=2,
            norm_num_groups=8,
            adapter_cross_attention_dim=32,
            transformer_layers_per_block=1,
        ),
        vae=VAEConfig(block_out_channels=(16, 16, 16), latent_channels=8, norm_num_groups=4),
        vocoder=VocoderConfig(
            model_in_dim=64, upsample_initial_channel=32,
            upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
        ),
        dtype=dtype,
    )


def audioldm_v1_unet_config(base: UNetConfig = UNetConfig(), clap_dim: int = 512) -> UNetConfig:
    """An AudioLDM v1 UNet (the JAX ``pipeline/audioldm_v1.py:26-39``): one
    double-self-attention transformer group per layer, the CLAP text
    embedding as a class label concatenated onto the time embedding."""

    return dataclasses.replace(base, in_channels=8, out_channels=8, cross_attention_dims=(None,),
                               class_embed_dim=clap_dim, class_embeddings_concat=True)


# ---------------------------------------------------------------------------
# Task templates — parity with reference config.py:1-83
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    task: str
    output_dir: str
    audio_prompt_file: str
    adapter_ckpt: str
    ap_scale: float
    time_pooling: int
    freq_pooling: int
    guidance_scale: float
    num_inference_steps: int = 50
    audio_length_in_s: float = 10.0
    num_files: int = 2
    positive_text_prompts: Sequence[str] = ()
    negative_text_prompts: Sequence[str] = ()


# prompt lists and knobs mirror the reference's shipped templates exactly
# (pinned to ``ap_adapter_tpu.configs`` by tests/test_torch_models.py)
_TASKS = {
    # reference config.py:1-23
    "timbre_transfer": dict(
        ap_scale=0.5, time_pooling=2, freq_pooling=2, guidance_scale=7.5,
        num_files=1,
        positive_text_prompts=(
            "a recording of a violin solo",
            "a recording of an acoustic guitar solo",
            "a recording of a harp solo",
        ),
        negative_text_prompts=("a recording of a piano solo",),
    ),
    # reference config.py:24-43
    "style_transfer": dict(
        ap_scale=0.55, time_pooling=4, freq_pooling=4, guidance_scale=9.5,
        num_files=1,
        positive_text_prompts=(
            "Jazz style music",
            "Rock style music",
            "Pop style music",
        ),
        negative_text_prompts=("Low quality",),
    ),
    # reference config.py:44-65
    "accompaniment_generation": dict(
        ap_scale=0.5, time_pooling=2, freq_pooling=2, guidance_scale=7.5,
        num_files=1,
        positive_text_prompts=(
            "Duet, Played with violin accompaniment",
            "Duet, Played with cello accompaniment",
            "Duet, Played with flute accompaniment",
        ),
        negative_text_prompts=("solo",),
    ),
    # reference config.py:66-83
    "test": dict(
        ap_scale=0.5, time_pooling=2, freq_pooling=2, guidance_scale=7.5,
        num_files=1,
        positive_text_prompts=("",),
        negative_text_prompts=("",),
    ),
}


def get_task_config(
    task: str,
    output_dir: str = "output",
    audio_prompt_file: str = "",
    adapter_ckpt: str = "",
    **overrides,
) -> TaskConfig:
    """Task templates mirroring reference config.py ``get_config(task)``."""

    if task not in _TASKS:
        raise ValueError(f"unknown task {task!r}; choose from {sorted(_TASKS)}")
    kw = dict(_TASKS[task])
    kw.update(overrides)
    return TaskConfig(
        task=task,
        output_dir=output_dir,
        audio_prompt_file=audio_prompt_file,
        adapter_ckpt=adapter_ckpt,
        **kw,
    )
