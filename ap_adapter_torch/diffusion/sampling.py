"""The denoising loop: classifier-free guidance + DDIM as a Python loop."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ap_adapter_torch.configs import SchedulerConfig
from ap_adapter_torch.diffusion.ddim import ddim_step, inference_timesteps, make_tables
from ap_adapter_torch.utils import trace


def ddim_sample_loop(
    unet_fn: Callable[..., torch.Tensor],
    latents: torch.Tensor,
    scheduler_config: SchedulerConfig,
    num_inference_steps: int,
    guidance_scale: float,
    timesteps: Optional[np.ndarray] = None,
) -> torch.Tensor:
    """Run the DDIM denoise. ``unet_fn(model_in, t, step_index)`` returns the
    noise prediction; the model input is [uncond; cond] (negative first) and
    the outputs combine as uncond + g * (cond - uncond). ``timesteps``
    overrides the schedule (the truncated SDEdit tail); the step spacing
    still follows ``num_inference_steps``."""

    tables = make_tables(scheduler_config)
    ts = inference_timesteps(scheduler_config, num_inference_steps) if timesteps is None else timesteps
    step_ratio = scheduler_config.num_train_timesteps // num_inference_steps
    with trace.span("ap.denoise"):
        for i, t in enumerate(int(t) for t in ts):
            with trace.span("ap.step"):
                uncond, cond = unet_fn(torch.cat([latents, latents]), t, i).chunk(2)
                noise_pred = uncond + torch.as_tensor(guidance_scale, dtype=uncond.dtype) * (cond - uncond)
                latents = ddim_step(tables, noise_pred, t, t - step_ratio, latents).to(latents.dtype)
    return latents
