"""AudioLDM v1 pipeline: CLAP-only text-to-audio generation.

Counterpart of ``ap_adapter_tpu/pipeline/audioldm_v1.py`` (the reference's
``pipeline/pipeline_audioldm.py``): the normalized CLAP text embedding
conditions the UNet as a "simple_projection" class label concatenated onto
the time embedding (reference pipeline_audioldm.py:563-564:
``encoder_hidden_states=None, class_labels=prompt_embeds``), and the
transformer blocks run double self-attention, so every site takes K1 and K3
on the card. Shares the DDIM loop, the VAE decode (K5/K6 in its mid block)
and the vocoder with the AudioLDM2 pipeline; nothing is hoisted.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ap_adapter_torch.configs import PipelineConfig, UNetConfig, audioldm_v1_unet_config
from ap_adapter_torch.diffusion.sampling import ddim_sample_loop
from ap_adapter_torch.models.clap import ClapTextEncoder
from ap_adapter_torch.models.unet import AudioLDM2UNet
from ap_adapter_torch.models.vae import AutoencoderKL
from ap_adapter_torch.models.vocoder import HiFiGAN
from ap_adapter_torch.pipeline.pipeline import Submodels, TextBatch
from ap_adapter_torch.utils import trace


def v1_unet_config(config: PipelineConfig) -> UNetConfig:
    """The v1 UNet at ``config.unet``'s widths, as the JAX ``from_random``
    builds it: its channels, attention blocks, heads and groups, one
    transformer layer a group, the CLAP projection width as the class
    label's."""

    u = config.unet
    return audioldm_v1_unet_config(
        UNetConfig(block_out_channels=u.block_out_channels, down_block_has_attn=u.down_block_has_attn,
                   up_block_has_attn=u.up_block_has_attn, layers_per_block=u.layers_per_block,
                   transformer_layers_per_block=1, num_attention_heads=u.num_attention_heads,
                   norm_num_groups=u.norm_num_groups),
        clap_dim=config.clap.projection_dim)


class AudioLDMv1Modules(Submodels):
    """The v1 pipeline's submodels: the CLAP text tower, the class-embedding
    UNet, the VAE and the vocoder."""

    NAMES = ("clap", "unet", "vae", "vocoder")

    def __init__(self, config: PipelineConfig, unet_config: UNetConfig):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.clap = ClapTextEncoder(config.clap)
            self.unet = AudioLDM2UNet(unet_config)
            self.vae = AutoencoderKL(config.vae)
            self.vocoder = HiFiGAN(config.vocoder)


class AudioLDMv1Pipeline:
    """Text -> waveform with CLAP-only conditioning (AudioLDM v1 semantics)."""

    def __init__(self, config: PipelineConfig, modules: AudioLDMv1Modules):
        self.config = config
        self.modules = modules
        self.unet_config = modules.unet.config

    @classmethod
    def init_random(cls, config: PipelineConfig, seed: int = 0, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> "AudioLDMv1Pipeline":
        """Random weights from ``seed`` (``Submodels.init_random``) at the UNet
        widths ``v1_unet_config`` takes from ``config``."""

        return cls(config, AudioLDMv1Modules(config, v1_unet_config(config)).init_random(seed, device, dtype))

    @classmethod
    def load_state_dicts(cls, config: PipelineConfig, state_dicts: Mapping[str, Mapping[str, object]],
                         device="cuda", dtype: Optional[torch.dtype] = None) -> "AudioLDMv1Pipeline":
        """``{"clap", "unet", "vae", "vocoder": HF/diffusers state dict}``, loaded strictly."""

        mods = AudioLDMv1Modules(config, v1_unet_config(config))
        return cls(config, mods.load_state_dicts(state_dicts, device, dtype))

    @torch.no_grad()
    def generate(
        self,
        text_pos: TextBatch,
        text_neg: TextBatch,
        *,
        audio_length_in_s: float = 10.0,
        num_inference_steps: int = 50,
        guidance_scale: float = 2.5,
        seed: int = 0,
        latents: Optional[torch.Tensor] = None,
    ) -> np.ndarray:
        """Waveforms [B, samples] as numpy: the CLAP embeddings of [negative;
        positive] as class labels, the CFG DDIM loop (no temb rows, no
        hoisted K/V) from ``latents`` [B, T, F, C] (default: drawn from a
        ``torch.Generator`` seeded with ``seed`` on the pipeline's device),
        the VAE decode and the vocoder."""

        b = text_pos.clap_ids.shape[0]
        with trace.span("ap.generate", rows=b, steps=num_inference_steps):
            c, m = self.config, self.modules
            dev, dtype = m.device, m.dtype
            frame_s = c.vocoder.upsample_factor / c.vocoder.sampling_rate
            scale = c.vae.scale_factor
            latent_time = (int(audio_length_in_s / frame_s) + scale - 1) // scale
            if latents is None:
                gen = torch.Generator(device=dev).manual_seed(seed)
                latents = torch.randn(b, latent_time, c.vocoder.model_in_dim // scale, self.unet_config.in_channels,
                                      generator=gen, device=dev, dtype=torch.float32)
            else:
                latents = torch.as_tensor(latents, dtype=torch.float32, device=dev)

            text = TextBatch.cat(text_neg.to(dev), text_pos.to(dev))        # CFG order: uncond (negative) first
            with trace.span("ap.text"):
                class_labels = m.clap(text.clap_ids, text.clap_mask)

            def unet_fn(model_in, t, i):
                t_batch = torch.full((model_in.shape[0],), float(t), device=dev)
                return m.unet(model_in.to(dtype), t_batch, class_labels=class_labels)

            latents = ddim_sample_loop(unet_fn, latents, c.scheduler, num_inference_steps, guidance_scale)
            with trace.span("ap.vae_decode"):
                mel = m.vae.decode((latents / c.vae.scaling_factor).to(dtype))   # [B, T, F, 1]
            with trace.span("ap.vocoder"):
                wav = m.vocoder(mel[..., 0].float()).float()
            with trace.span("ap.to_host"):
                return wav[:, : int(audio_length_in_s * c.vocoder.sampling_rate)].cpu().numpy()
