"""SDEdit-style audio-to-audio editing (the style_transfer task's ``--sdedit``
route).

Counterpart of ``ap_adapter_tpu/pipeline/style_transfer.py`` (reference
``style_transfer_pipeline.py``:905-981): the source clip's VAE latent is
noised to a mid-schedule timestep and denoised over the truncated tail of the
DDIM schedule, which drops the first ``steps // 4 * 2`` (high-noise) steps:
26 of 50 run. The VAE encode and decode each reach the K5/K6 self-attention
kernel at the mid block; the denoise loop is the edit path's (hoisted K/V
and time-embedding rows, K1-K3 at every transformer site).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ap_adapter_torch.audio.dsp import resample
from ap_adapter_torch.audio.mel import wav_to_vae_mel
from ap_adapter_torch.diffusion.ddim import add_noise, inference_timesteps, make_tables
from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline, PipelineModules, TextBatch


def sdedit_timesteps(num_inference_steps: int, scheduler_config) -> np.ndarray:
    """The truncated schedule: the full one without its first
    ``num_inference_steps // 4 * 2`` steps."""

    return inference_timesteps(scheduler_config, num_inference_steps)[num_inference_steps // 4 * 2:]


@torch.no_grad()
def sdedit_generate_waveform(
    modules: PipelineModules,
    source_waveform: torch.Tensor,          # [B, N] at the mel sample rate, the full clip
    fbank: Optional[torch.Tensor],          # [B, T, F] or None (text only)
    text_pos: TextBatch,
    text_neg: TextBatch,
    *,
    num_inference_steps: int,
    guidance_scale: float,
    ap_scale: float,
    time_pool: int,
    freq_pool: int,
    mel_frames: int,
    generator: Optional[torch.Generator] = None,
    vae_noise: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Source audio + prompts -> edited waveforms [B, mel_frames * vocoder
    upsample], fp32. The two random draws (the VAE posterior sample and the
    forward-process noise) come from ``generator`` unless given as tensors,
    so that a test can hand in the JAX package's draws."""

    c = modules.config
    dev, dtype = modules.device, modules.dtype
    src = torch.as_tensor(source_waveform, dtype=torch.float32, device=dev)
    mel = wav_to_vae_mel(src, mel_frames, c.mel)[..., None]            # [B, T, F, 1]
    sf = c.vae.scale_factor
    lat_shape = (src.shape[0], mel_frames // sf, c.mel.num_mel_bins // sf, c.vae.latent_channels)
    if vae_noise is None:
        vae_noise = torch.randn(lat_shape, generator=generator, device=dev)
    latents = modules.vae.encode(mel.to(dtype), vae_noise.to(dev)).float()

    ts = sdedit_timesteps(num_inference_steps, c.scheduler)
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, device=dev)
    latents = add_noise(make_tables(c.scheduler), latents, noise.to(dev),
                        torch.tensor([int(ts[0])], device=dev))
    return modules.denoise_to_waveform(latents, fbank, text_pos, text_neg,
                                       num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
                                       ap_scale=ap_scale, time_pool=time_pool, freq_pool=freq_pool, timesteps=ts)


def generate_style_transfer(
    pipe: AudioLDM2Pipeline,
    source_waveform: np.ndarray,
    sample_rate: int,
    text_pos: TextBatch,
    text_neg: TextBatch,
    *,
    audio_length_in_s: float = 10.0,
    num_inference_steps: int = 50,
    guidance_scale: float = 9.5,
    ap_scale: float = 0.55,
    time_pool: int = 4,
    freq_pool: int = 4,
    seed: int = 0,
) -> np.ndarray:
    """Host-facing SDEdit entry point (task template: style_transfer):
    waveforms [B, samples] trimmed to ``audio_length_in_s``, as numpy. The
    source is mixed to mono and resampled on the host, and is also the audio
    prompt."""

    c = pipe.config
    sr = c.mel.sample_rate
    wav = torch.as_tensor(np.atleast_2d(source_waveform).mean(axis=0), dtype=torch.float32)
    if sample_rate != sr:
        wav = resample(wav, sample_rate, sr)
    b = text_pos.clap_ids.shape[0]
    # the generate path's length math: mel frames from the vocoder's upsample
    # factor, rounded up to a whole latent
    mel_frames = pipe.latent_time_for_seconds(audio_length_in_s) * c.vae.scale_factor
    fb = pipe.prepare_fbank(wav.numpy(), sr)
    fbank = fb.expand(b, *fb.shape[1:]).contiguous()
    dev = pipe.modules.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    wavs = sdedit_generate_waveform(
        pipe.modules, wav[None].expand(b, -1), fbank, text_pos, text_neg,
        num_inference_steps=num_inference_steps, guidance_scale=guidance_scale, ap_scale=ap_scale,
        time_pool=time_pool, freq_pool=freq_pool, mel_frames=mel_frames, generator=gen)
    samples = int(audio_length_in_s * c.vocoder.sampling_rate)
    return wavs[:, :samples].cpu().numpy()
