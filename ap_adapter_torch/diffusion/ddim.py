"""DDIM scheduler (eta = 0) as functions over precomputed alpha tables.

Counterpart of ``ap_adapter_tpu/diffusion/ddim.py``: diffusers
``DDIMScheduler`` with the cvssp/audioldm2 config. Tables are numpy; the
step runs in fp32 torch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ap_adapter_torch.configs import SchedulerConfig


@dataclasses.dataclass(frozen=True)
class DDIMTables:
    alphas_cumprod: np.ndarray  # [num_train_timesteps] float32
    final_alpha_cumprod: np.float32
    num_train_timesteps: int
    prediction_type: str
    clip_sample: bool


def make_tables(config: SchedulerConfig = SchedulerConfig()) -> DDIMTables:
    if config.beta_schedule == "scaled_linear":
        betas = np.linspace(config.beta_start ** 0.5, config.beta_end ** 0.5,
                            config.num_train_timesteps, dtype=np.float64) ** 2
    elif config.beta_schedule == "linear":
        betas = np.linspace(config.beta_start, config.beta_end, config.num_train_timesteps,
                            dtype=np.float64)
    else:
        raise ValueError(f"unsupported beta schedule {config.beta_schedule}")
    alphas_cumprod = np.cumprod(1.0 - betas).astype(np.float32)
    final = np.float32(1.0) if config.set_alpha_to_one else alphas_cumprod[0]
    return DDIMTables(alphas_cumprod, final, config.num_train_timesteps,
                      config.prediction_type, config.clip_sample)


def inference_timesteps(config: SchedulerConfig, num_inference_steps: int) -> np.ndarray:
    """Descending timesteps ('leading' spacing + steps_offset, or 'trailing')."""

    if config.timestep_spacing == "leading":
        step_ratio = config.num_train_timesteps // num_inference_steps
        ts = (np.arange(num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
        ts = ts + config.steps_offset
    elif config.timestep_spacing == "trailing":
        step_ratio = config.num_train_timesteps / num_inference_steps
        ts = np.round(np.arange(config.num_train_timesteps, 0, -step_ratio)).astype(np.int64) - 1
    else:
        raise ValueError(f"unsupported timestep spacing {config.timestep_spacing}")
    return ts


def _alpha(tables: DDIMTables, t: int) -> torch.Tensor:
    """alphas_cumprod[t] (fp32 scalar tensor), or final_alpha_cumprod for t < 0."""

    a = tables.final_alpha_cumprod if t < 0 else tables.alphas_cumprod[min(t, tables.num_train_timesteps - 1)]
    return torch.tensor(a, dtype=torch.float32)


def ddim_step(tables: DDIMTables, model_output: torch.Tensor, t: int, prev_t: int,
              sample: torch.Tensor) -> torch.Tensor:
    """One deterministic DDIM update x_t -> x_{prev_t}, in fp32."""

    sample = sample.float()
    model_output = model_output.float()
    # 0-dim CPU tensors: combined with device tensors as scalars, no copy
    a_t = _alpha(tables, t)
    a_prev = _alpha(tables, prev_t)
    b_t = 1.0 - a_t

    if tables.prediction_type == "epsilon":
        x0 = (sample - torch.sqrt(b_t) * model_output) / torch.sqrt(a_t)
        eps = model_output
    elif tables.prediction_type == "v_prediction":
        x0 = torch.sqrt(a_t) * sample - torch.sqrt(b_t) * model_output
        eps = torch.sqrt(a_t) * model_output + torch.sqrt(b_t) * sample
    elif tables.prediction_type == "sample":
        x0 = model_output
        eps = (sample - torch.sqrt(a_t) * x0) / torch.sqrt(b_t)
    else:
        raise ValueError(tables.prediction_type)
    if tables.clip_sample:
        x0 = x0.clamp(-1.0, 1.0)
    return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
