"""The reference's two requests, end to end in float32: an AudioLDM2 edit
with the AP-adapter (text and audio prompt -> waveform) and an AudioLDM v1
text-to-audio request, each over 50 classifier-free-guided DDIM steps."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from h100_bench.reference.audio import VAE, AudioMAE, HiFiGAN, kaldi_fbank
from h100_bench.reference.common import Cfg, full_precision
from h100_bench.reference.text import T5, GPT2, ClapText, Projection
from h100_bench.reference.unet import UNet

PIPELINE_NAMES = {"audioldm2": ("clap", "t5", "gpt2", "projection", "audiomae", "unet", "vae", "vocoder"),
                  "audioldm_v1": ("clap", "unet", "vae", "vocoder")}
SUBMODELS = {"clap": ("clap", ClapText), "t5": ("t5", T5), "gpt2": ("gpt2", GPT2),
             "projection": ("projection", Projection), "audiomae": ("audiomae", AudioMAE),
             "unet": ("unet", UNet), "vae": ("vae", VAE), "vocoder": ("vocoder", HiFiGAN)}


def build(config: dict, names, device) -> Dict[str, nn.Module]:
    """The submodels ``names`` of a configuration file's groups, with
    uninitialised float32 weights on ``device`` (load them after). Matrix
    products and convolutions then run in float32, TF32 off."""

    full_precision()
    with torch.device("meta"):
        mods = {n: SUBMODELS[n][1](Cfg(config[SUBMODELS[n][0]])) for n in names}
    return {n: m.to_empty(device=device).float().eval() for n, m in mods.items()}


def timesteps(s, steps: int) -> np.ndarray:
    """'leading' spacing plus ``steps_offset``, descending."""

    ratio = s.num_train_timesteps // steps
    return (np.arange(steps) * ratio).round()[::-1].astype(np.int64) + s.steps_offset


def alphas_cumprod(s) -> np.ndarray:
    betas = np.linspace(s.beta_start ** 0.5, s.beta_end ** 0.5, s.num_train_timesteps, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def ddim_update(latents, out, t: int, s, steps: int, guidance: float, lowp=None):
    """One CFG DDIM step (eta 0, epsilon prediction) from ``latents``
    [B, T, F, C] at timestep ``t`` and the model's output ``out`` on
    [uncond; cond]: the outputs mix as uncond + g (cond - uncond).
    ``lowp``, where given, rounds the operands and the new latents (the
    control, whose denoise state is then kept in that precision)."""

    ac = alphas_cumprod(s)
    ratio = s.num_train_timesteps // steps
    uncond, cond = out.float().chunk(2)
    latents = latents.float()
    if lowp is not None:
        latents, uncond, cond = lowp(latents), lowp(uncond), lowp(cond)
    eps = uncond + guidance * (cond - uncond)
    a_t = float(ac[t])
    a_prev = float(ac[t - ratio]) if t - ratio >= 0 else float(ac[0])
    x0 = (latents - (1.0 - a_t) ** 0.5 * eps) / a_t ** 0.5
    new = a_prev ** 0.5 * x0 + (1.0 - a_prev) ** 0.5 * eps
    return new if lowp is None else lowp(new)


def denoise(unet_fn, latents, s, steps: int, guidance: float, taps: Optional[dict] = None, lowp=None):
    """CFG DDIM over ``steps`` from ``latents`` [B, T, F, C]; the model sees
    [uncond; cond]. ``taps``, where given, receives the first step's output
    and every step's (latents, output)."""

    for k, t in enumerate(timesteps(s, steps)):
        out = unet_fn(torch.cat([latents, latents]), int(t))
        if taps is not None:
            if k == 0:
                taps["unet_out0"] = out
            taps.setdefault("steps", []).append((latents, out))
        latents = ddim_update(latents, out, int(t), s, steps, guidance, lowp)
    return latents


def _t(a, device):
    return torch.as_tensor(np.asarray(a), dtype=torch.long, device=device)


@torch.no_grad()
def edit(m: Dict[str, nn.Module], config: dict, pos: dict, neg: dict, wavs: np.ndarray, latents: torch.Tensor, *,
         ap_scale: float, time_pool: int, freq_pool: int, guidance: float, steps: int, samples: int,
         taps: Optional[dict] = None, lowp=None) -> torch.Tensor:
    """AudioLDM2 + AP-adapter. ``pos``/``neg``: token ids and masks
    (``clap_ids``, ``clap_mask``, ``t5_ids``, ``t5_mask``) [B, S];
    ``wavs`` [B, N] 16 kHz audio prompts; ``latents`` the initial noise.
    Returns waveforms [B, samples]; ``taps``, where given, receives the
    conditioning and the stages on the way; ``lowp`` rounds the operands
    and the result of each DDIM update (``ddim_update``)."""

    dev = latents.device
    c = Cfg(config)
    text = {k: torch.cat([_t(neg[k], dev), _t(pos[k], dev)]) for k in pos}      # CFG order: negative first
    clap = m["clap"](text["clap_ids"], text["clap_mask"])[:, None]
    t5 = m["t5"](text["t5_ids"], text["t5_mask"])
    h, mask = m["projection"](clap, t5, text["t5_mask"])
    gpt2 = m["gpt2"].generate(h, mask, c.gpt2.max_new_tokens)
    fb = torch.stack([kaldi_fbank(torch.as_tensor(w, device=dev), c.fbank) for w in wavs])
    audio = m["audiomae"](torch.cat([torch.zeros_like(fb), fb]), time_pool, freq_pool)
    ehs0 = torch.cat([gpt2, audio], dim=1)

    def unet_fn(x, t):
        return m["unet"](x, torch.full((x.shape[0],), float(t), device=dev), ehs0, t5, text["t5_mask"], ap_scale)

    lat = denoise(unet_fn, latents.float(), c.scheduler, steps, guidance, taps, lowp)
    mel = m["vae"].decode(lat)
    if taps is not None:
        taps.update(t5=t5, t5_mask=text["t5_mask"], gpt2=gpt2, audio=audio, latents=lat, mel=mel)
    return m["vocoder"](mel)[:, :samples]


@torch.no_grad()
def text_to_audio(m: Dict[str, nn.Module], config: dict, pos: dict, neg: dict, latents: torch.Tensor, *,
                  guidance: float, steps: int, samples: int, taps: Optional[dict] = None,
                  lowp=None) -> torch.Tensor:
    """AudioLDM v1: the CLAP text embeddings of [negative; positive] as the
    UNet's class labels."""

    dev = latents.device
    c = Cfg(config)
    labels = m["clap"](torch.cat([_t(neg["clap_ids"], dev), _t(pos["clap_ids"], dev)]),
                       torch.cat([_t(neg["clap_mask"], dev), _t(pos["clap_mask"], dev)]))

    def unet_fn(x, t):
        return m["unet"](x, torch.full((x.shape[0],), float(t), device=dev), class_labels=labels)

    lat = denoise(unet_fn, latents.float(), c.scheduler, steps, guidance, taps, lowp)
    if taps is not None:
        taps.update(class_labels=labels, latents=lat)
    return m["vocoder"](m["vae"].decode(lat))[:, :samples]
