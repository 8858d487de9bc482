"""AudioLDM2 + audio-prompt-adapter generation in PyTorch.

Counterpart of ``ap_adapter_tpu/pipeline/pipeline.py``: text conditioning
(CLAP + T5 -> projection -> GPT-2), AudioMAE conditioning with time/freq
pooling and a zeros-fbank unconditional branch, the step-invariant precompute
(``models/hoist.py``), the classifier-free-guidance DDIM loop over the
dual-stream UNet with the adapter live, VAE decode and HiFi-GAN vocoding.
Token ids come from the host (``pipeline/tokenize.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from ap_adapter_torch.configs import PipelineConfig
from ap_adapter_torch.diffusion.ddim import inference_timesteps
from ap_adapter_torch.diffusion.sampling import ddim_sample_loop
from ap_adapter_torch.models.audiomae import AudioMAECondition
from ap_adapter_torch.models.clap import ClapTextEncoder
from ap_adapter_torch.models.gpt2 import GPT2Model, generate_hidden_states
from ap_adapter_torch.models.hoist import precompute_cross_kv, precompute_temb_rows
from ap_adapter_torch.models.layers import NORM_TYPES
from ap_adapter_torch.models.projection import ProjectionModel
from ap_adapter_torch.models.t5 import T5Encoder
from ap_adapter_torch.models.unet import AudioLDM2UNet
from ap_adapter_torch.models.vae import AutoencoderKL
from ap_adapter_torch.models.vocoder import HiFiGAN

_ONES = ("scale", "sos_embed", "eos_embed", "sos_embed_1", "eos_embed_1")


@dataclasses.dataclass(frozen=True)
class TextBatch:
    """Tokenized prompts, padded to fixed lengths: numpy arrays or tensors [B, S]."""

    clap_ids: object
    clap_mask: object
    t5_ids: object
    t5_mask: object

    def to(self, device) -> "TextBatch":
        return TextBatch(*(torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                                           dtype=torch.long, device=device)
                           for a in dataclasses.astuple(self)))

    @staticmethod
    def cat(first: "TextBatch", second: "TextBatch") -> "TextBatch":
        return TextBatch(*(torch.cat([a, b]) for a, b in zip(dataclasses.astuple(first),
                                                            dataclasses.astuple(second))))


class PipelineModules(nn.Module):
    """Every submodel of one PipelineConfig.

    Built on the meta device (no memory): ``init_random`` or
    ``load_state_dicts`` materializes the weights on a device.
    """

    NAMES = ("clap", "t5", "gpt2", "projection", "audiomae", "unet", "vae", "vocoder")

    def __init__(self, config: PipelineConfig):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.clap = ClapTextEncoder(config.clap)
            self.t5 = T5Encoder(config.t5)
            self.gpt2 = GPT2Model(config.gpt2)
            self.projection = ProjectionModel(config.projection)
            self.audiomae = AudioMAECondition(config.audiomae)
            self.unet = AudioLDM2UNet(config.unet)
            self.vae = AutoencoderKL(config.vae)
            self.vocoder = HiFiGAN(config.vocoder)

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.unet.conv_in.weight.dtype

    @torch.no_grad()
    def init_random(self, seed: int = 0, device="cpu", dtype: Optional[torch.dtype] = None
                    ) -> "PipelineModules":
        """Random weights, drawn on ``device`` from a seeded ``torch.Generator``:
        ones for norm scales and the sos/eos embeddings, zeros for biases,
        N(0, 0.02) for everything else (the JAX package's fast_init rules)."""

        dtype = dtype or self.config.dtype
        self.to_empty(device=device)
        self.to(dtype)
        gen = torch.Generator(device=device).manual_seed(seed)
        for module in self.modules():
            for name, p in module.named_parameters(recurse=False):
                if name == "bias":
                    p.zero_()
                elif isinstance(module, NORM_TYPES) or name in _ONES:
                    p.fill_(1.0)
                else:
                    p.normal_(0.0, 0.02, generator=gen)
        return self

    def load_state_dicts(self, state_dicts: Mapping[str, Mapping[str, object]], device="cpu",
                         dtype: Optional[torch.dtype] = None) -> "PipelineModules":
        """Load ``{submodel name: HF/diffusers state dict}`` (numpy arrays or
        tensors) strictly; the VAE encoder's weights, which the decode-only VAE
        does not hold, are skipped."""

        dtype = dtype or self.config.dtype
        for name in self.NAMES:
            module = getattr(self, name)
            own = set(module.state_dict())
            sd = {k: torch.as_tensor(np.asarray(v)) for k, v in state_dicts[name].items()}
            extra = [k for k in sd if k not in own]
            if name == "vae":
                extra = [k for k in extra if not k.startswith(("encoder.", "quant_conv."))]
                sd = {k: v for k, v in sd.items() if k in own}
            if extra:
                raise KeyError(f"{name}: unexpected keys {extra[:5]}")
            module.load_state_dict(sd, strict=True, assign=True)
        return self.to(device=device, dtype=dtype)

    # -- conditioning --------------------------------------------------------

    def encode_prompt(self, text: TextBatch):
        """(t5_hidden [B, St, D1], t5_mask [B, St], gpt2_tokens [B, 8, D0])."""

        clap_feat = self.clap(text.clap_ids, text.clap_mask)[:, None, :]
        clap_mask = torch.ones(clap_feat.shape[0], 1, dtype=text.t5_mask.dtype, device=clap_feat.device)
        t5_hidden = self.t5(text.t5_ids, text.t5_mask)
        proj, proj_mask = self.projection(clap_feat, t5_hidden, clap_mask, text.t5_mask)
        gpt2_tokens = generate_hidden_states(self.gpt2, proj, proj_mask, self.config.gpt2.max_new_tokens)
        return t5_hidden, text.t5_mask, gpt2_tokens

    def encode_audio(self, fbank: torch.Tensor, time_pool: int, freq_pool: int) -> torch.Tensor:
        """Pooled AudioMAE tokens of [zeros; fbank]: the zeros fbank is the
        unconditional branch of classifier-free guidance."""

        return self.audiomae(torch.cat([torch.zeros_like(fbank), fbank]), time_pool, freq_pool)

    # -- generation ----------------------------------------------------------

    @torch.no_grad()
    def generate_waveform(
        self,
        fbank: torch.Tensor,
        text_pos: TextBatch,
        text_neg: TextBatch,
        *,
        num_inference_steps: int,
        guidance_scale: float,
        ap_scale: float,
        time_pool: int,
        freq_pool: int,
        latent_time: int,
        init_latents: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Text + audio (fbank [B, T, F]) -> waveforms
        [B, latent_time * vae_scale * vocoder_upsample], fp32."""

        c = self.config
        dev, dtype = self.device, self.dtype
        text_pos, text_neg = text_pos.to(dev), text_neg.to(dev)
        b = text_pos.clap_ids.shape[0]
        # CFG order: uncond (negative) first
        t5_hidden, t5_mask, gpt2_tokens = self.encode_prompt(TextBatch.cat(text_neg, text_pos))
        audio = self.encode_audio(torch.as_tensor(fbank, device=dev), time_pool, freq_pool)
        ehs0 = torch.cat([gpt2_tokens, audio.to(gpt2_tokens.dtype)], dim=1)

        latent_freq = c.vocoder.model_in_dim // c.vae.scale_factor
        if init_latents is None:
            latents = torch.randn(b, latent_time, latent_freq, c.unet.in_channels,
                                  generator=generator, device=dev, dtype=torch.float32)
        else:
            latents = torch.as_tensor(init_latents, dtype=torch.float32, device=dev)

        ctx_kv = temb = None
        if c.hoist_step_invariants:
            ctx_kv = precompute_cross_kv(self.unet, ehs0, t5_hidden, t5_mask)
            temb = precompute_temb_rows(self.unet, inference_timesteps(c.scheduler, num_inference_steps))

        def unet_fn(model_in, t, i):
            ts = torch.full((model_in.shape[0],), float(t), device=dev)
            rows = {k: v[i] for k, v in temb.items()} if temb is not None else None
            return self.unet(model_in.to(dtype), ts, ehs0, t5_hidden, t5_mask, ip_scale=ap_scale,
                             ctx_kv=ctx_kv, temb_rows=rows)

        latents = ddim_sample_loop(unet_fn, latents, c.scheduler, num_inference_steps, guidance_scale)
        mel = self.vae.decode((latents / c.vae.scaling_factor).to(dtype))   # [B, T, F, 1]
        return self.vocoder(mel[..., 0].float()).float()


class AudioLDM2Pipeline:
    """User-facing pipeline: owns the modules on one device."""

    def __init__(self, config: PipelineConfig, modules: PipelineModules):
        self.config = config
        self.modules = modules

    @classmethod
    def from_random(cls, config: PipelineConfig, seed: int = 0, device="cpu",
                    dtype: Optional[torch.dtype] = None) -> "AudioLDM2Pipeline":
        return cls(config, PipelineModules(config).init_random(seed, device, dtype))

    def latent_time_for_seconds(self, seconds: float) -> int:
        """mel frames = seconds / (upsample_factor / sr), rounded up to the VAE
        scale; latent frames = frames / vae_scale."""

        c = self.config
        frame_s = c.vocoder.upsample_factor / c.vocoder.sampling_rate
        height = int(seconds / frame_s)
        scale = c.vae.scale_factor
        if height % scale != 0:
            height = ((height // scale) + 1) * scale
        return height // scale

    def generate(
        self,
        text_pos: TextBatch,
        text_neg: TextBatch,
        fbank,
        *,
        audio_length_in_s: float = 10.0,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        ap_scale: float = 0.5,
        time_pool: int = 2,
        freq_pool: int = 2,
        seed: int = 0,
    ) -> np.ndarray:
        """Waveforms [B, samples] trimmed to ``audio_length_in_s``, as numpy."""

        dev = self.modules.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        wav = self.modules.generate_waveform(
            fbank, text_pos, text_neg, num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, ap_scale=ap_scale, time_pool=time_pool,
            freq_pool=freq_pool, latent_time=self.latent_time_for_seconds(audio_length_in_s),
            generator=gen)
        samples = int(audio_length_in_s * self.config.vocoder.sampling_rate)
        return wav[:, :samples].cpu().numpy()
