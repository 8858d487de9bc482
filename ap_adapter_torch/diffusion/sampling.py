"""The denoising loop: classifier-free guidance + DDIM as a Python loop."""

from __future__ import annotations

from typing import Callable

import torch

from ap_adapter_torch.configs import SchedulerConfig
from ap_adapter_torch.diffusion.ddim import ddim_step, inference_timesteps, make_tables


def ddim_sample_loop(
    unet_fn: Callable[..., torch.Tensor],
    latents: torch.Tensor,
    scheduler_config: SchedulerConfig,
    num_inference_steps: int,
    guidance_scale: float,
) -> torch.Tensor:
    """Run the DDIM denoise. ``unet_fn(model_in, t, step_index)`` returns the
    noise prediction; the model input is [uncond; cond] (negative first) and
    the outputs combine as uncond + g * (cond - uncond)."""

    tables = make_tables(scheduler_config)
    ts = inference_timesteps(scheduler_config, num_inference_steps)
    step_ratio = scheduler_config.num_train_timesteps // num_inference_steps
    for i, t in enumerate(int(t) for t in ts):
        uncond, cond = unet_fn(torch.cat([latents, latents]), t, i).chunk(2)
        noise_pred = uncond + torch.as_tensor(guidance_scale, dtype=uncond.dtype) * (cond - uncond)
        latents = ddim_step(tables, noise_pred, t, t - step_ratio, latents).to(latents.dtype)
    return latents
