"""Adapter finetuning: the loss, the adapter-only gradient and the AdamW step.

Counterpart of ``ap_adapter_tpu/train/trainer.py`` (the reference trainer,
train_apadapter_v2.py:546-1044): VAE-encode the mel, add DDPM noise at
random timesteps, run the UNet with adapter scale 1.0, take the MSE to the
epsilon (or v) target, and step AdamW on the 64 adapter matrices only, after
a clip of the global gradient norm at 1.0.

Every UNet weight is frozen (``requires_grad`` False, the compute dtype)
except the ``to_k_ip``/``to_v_ip`` matrices, which are fp32 like the Flax
params and are cast to the compute dtype where the kernels use them; their
AdamW moments are fp32 too, or with ``use_8bit_adam`` a bf16 first moment
(``BF16MomentAdamW``, the JAX package's ``mu_dtype=bfloat16``). The backward runs through the fused ops'
autograd Functions, whose backwards are the K7/K8/K9 kernels on the card.

Data-parallel (``train_step(..., mesh=)``, the counterpart of JAX's
GSPMD step, trainer.py:239-371): each rank holds its rows of the global
micro-batch, draws the loss's noise and timesteps for the global batch and
keeps its rows, and one ``all_reduce`` over ``data`` averages the adapter
gradients before the clip, so the clip sees the global norm; the reported
loss is averaged too. Two ranks at B then equal one process at 2B, up to
the order of the fp32 sums.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from ap_adapter_torch.adapter.params import adapter_parameters
from ap_adapter_torch.diffusion.ddim import add_noise, make_tables, velocity_target
from ap_adapter_torch.parallel.mesh import all_reduce_mean_


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference's train.sh / argparse defaults: lr 1e-4 constant,
    AdamW(0.9, 0.999, wd 1e-2, eps 1e-8), grad clip 1.0, effective batch 32
    (8 x accumulation 4; the micro-batch size is the loader's)."""

    learning_rate: float = 1e-4
    # HF get_scheduler semantics; warmup counts optimizer steps
    lr_scheduler: str = "constant"  # constant|constant_with_warmup|linear|cosine
    lr_warmup_steps: int = 500
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    # the reference's bitsandbytes --use_8bit_adam: here, as in the JAX
    # package, AdamW with its first moment stored in bf16 (BF16MomentAdamW)
    use_8bit_adam: bool = False
    gradient_accumulation_steps: int = 4
    max_train_steps: int = 35_000
    checkpointing_steps: int = 3000
    validation_steps: int = 3000
    seed: int = 42
    snr_gamma: Optional[float] = None  # min-SNR weighting (off by default)


def make_lr_schedule(tc: TrainConfig) -> Callable[[int], float]:
    """lr as a function of the optimizer steps taken so far (optax's count):
    the four HF schedules, with a linear warmup from 0 over ``lr_warmup_steps``
    (except plain constant), then constant, linear to 0 at
    ``max_train_steps``, or a half cosine to 0."""

    lr, w, total = tc.learning_rate, tc.lr_warmup_steps, tc.max_train_steps
    if tc.lr_scheduler == "constant":
        return lambda count: lr
    if tc.lr_scheduler not in ("constant_with_warmup", "linear", "cosine"):
        raise ValueError(f"unknown lr_scheduler: {tc.lr_scheduler!r}")
    span = max(total - w, 1)

    def schedule(count: int) -> float:
        if count < w:
            return lr * min(count, max(w, 1)) / max(w, 1)
        t = min(count - w, span) / span
        if tc.lr_scheduler == "linear":
            return lr * (1.0 - t)
        if tc.lr_scheduler == "cosine":
            return lr * 0.5 * (1.0 + math.cos(math.pi * t))
        return lr

    return schedule


def split_unet_params(unet) -> Dict[str, torch.nn.Parameter]:
    """Freeze every UNet weight and make the adapter matrices trainable fp32
    parameters (in place). Returns {flat adapter key: parameter}."""

    unet.requires_grad_(False)
    adapter = adapter_parameters(unet)
    for p in adapter.values():
        p.data = p.data.float()
        p.requires_grad_(True)
    unet.drop_graphs()
    return adapter


class BF16MomentAdamW(torch.optim.Optimizer):
    """AdamW whose first moment is stored in bf16 and second in fp32, in the
    order of optax's ``scale_by_adam(mu_dtype=bfloat16)`` under ``jax.jit``:
    the new moment is ``(1 - b1) g + bf16(b1) mu`` in fp32 from the stored
    bf16 moment and the fp32 gradient, its bias-corrected fp32 value makes
    this step's update, and only then is it rounded to bf16 for the state.
    The weight decay is decoupled, as in ``torch.optim.AdamW``. State per
    parameter: ``step``, ``exp_avg`` (bf16), ``exp_avg_sq`` (fp32)."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("BF16MomentAdamW takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            lr, (b1, b2), eps, wd = group["lr"], group["betas"], group["eps"], group["weight_decay"]
            states = []
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16)
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
                st["step"] += 1
                states.append(st)
            grads = [p.grad.float() for p in params]
            # optax decays the bf16 moment by b1 in the moment's dtype: bf16(0.9) = 0.8984375
            b1_bf16 = torch.tensor(b1, dtype=torch.bfloat16).item()
            mu = torch._foreach_mul(grads, float(np.float32(1.0 - b1)))
            torch._foreach_add_(mu, [st["exp_avg"] for st in states], alpha=b1_bf16)
            nu = [st["exp_avg_sq"] for st in states]
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
            # optax's bias corrections, 1 - b**count, in fp32, per parameter
            counts = [np.float32(st["step"].item()) for st in states]
            bc1, bc2 = ([float(np.float32(1) - np.float32(b) ** n) for n in counts] for b in (b1, b2))
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            update = torch._foreach_div(mu, bc1)
            torch._foreach_div_(update, denom)
            torch._foreach_mul_(params, 1.0 - lr * wd)
            torch._foreach_add_(params, update, alpha=-lr)
            torch._foreach_copy_([st["exp_avg"] for st in states], mu)
        return None

    def load_state_dict(self, state_dict) -> None:
        # torch casts every restored state tensor but ``step`` to its
        # parameter's dtype; the first moment goes back to bf16 (exactly)
        super().load_state_dict(state_dict)
        for st in self.state.values():
            if "exp_avg" in st:
                st["exp_avg"] = st["exp_avg"].to(torch.bfloat16)


def make_optimizer(tc: TrainConfig, params) -> torch.optim.Optimizer:
    """AdamW over the adapter (``BF16MomentAdamW`` under ``use_8bit_adam``);
    ``optimizer_step`` sets the lr of each step."""

    cls = BF16MomentAdamW if tc.use_8bit_adam else torch.optim.AdamW
    return cls(list(params), lr=tc.learning_rate, betas=(tc.adam_beta1, tc.adam_beta2), eps=tc.adam_epsilon,
               weight_decay=tc.adam_weight_decay)


def sample_noise(modules, batch: Mapping[str, torch.Tensor], generator: torch.Generator,
                 rows: Optional[tuple] = None) -> Dict:
    """The loss's random inputs for one micro-batch, drawn from ``generator``
    on the batch's device: the VAE posterior noise, the DDPM noise (both
    latent-shaped, fp32) and the timesteps in [0, num_train_timesteps).
    ``rows`` (first row, global batch): the batch is those rows of a global
    micro-batch; the draws are made for the global batch and sliced."""

    cfg = modules.config
    mel = batch["mel"]
    b = mel.shape[0]
    first, total = (0, b) if rows is None else rows
    sf = cfg.vae.scale_factor
    shape = (total, mel.shape[1] // sf, mel.shape[2] // sf, cfg.vae.latent_channels)
    kw = dict(generator=generator, device=mel.device)
    draws = {"vae_noise": torch.randn(shape, **kw), "noise": torch.randn(shape, **kw),
             "timesteps": torch.randint(0, cfg.scheduler.num_train_timesteps, (total,), **kw)}
    return {k: v[first: first + b] for k, v in draws.items()}


def compute_loss(modules, tc: TrainConfig, batch: Mapping[str, torch.Tensor], *, vae_noise: torch.Tensor,
                 noise: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
    """The reference objective for one micro-batch (fp32 scalar).

    ``batch``: mel [B, T, F, 1], generated_prompt_embeds [B, 8 + n_audio, D0]
    (GPT-2 ‖ pooled AudioMAE), prompt_embeds [B, S1, D1] (T5), attention_mask
    [B, S1]."""

    cfg = modules.config
    if cfg.unet.use_int8:
        raise ValueError("use_int8 is a serving configuration: the int8 kernels have no backward")
    if cfg.unet.use_pallas_attention:
        raise ValueError("use_pallas_attention is a serving configuration: K10 (the dual-KV attention "
                         "kernel) has no backward")
    tables = make_tables(cfg.scheduler)
    dtype = modules.dtype
    with torch.no_grad():
        latents = modules.vae.encode(batch["mel"].to(dtype), vae_noise).float()
    noisy = add_noise(tables, latents, noise, timesteps)
    pred = modules.unet(noisy.to(dtype), timesteps.float(), batch["generated_prompt_embeds"],
                        batch["prompt_embeds"], batch.get("attention_mask"), ip_scale=1.0).float()
    if cfg.scheduler.prediction_type == "epsilon":
        target = noise.float()
    elif cfg.scheduler.prediction_type == "v_prediction":
        target = velocity_target(tables, latents, noise, timesteps)
    else:
        raise ValueError(cfg.scheduler.prediction_type)
    err = (pred - target).square()
    if tc.snr_gamma is not None:
        a = torch.as_tensor(tables.alphas_cumprod, device=timesteps.device)[timesteps.long()]
        snr = a / (1.0 - a)
        err = err * (torch.clamp(snr, max=tc.snr_gamma) / snr)[:, None, None, None]
    return err.mean()


@torch.no_grad()
def optimizer_step(tc: TrainConfig, adapter: Mapping[str, torch.nn.Parameter], optimizer: torch.optim.Optimizer,
                   count: int) -> Dict[str, torch.Tensor]:
    """Clip the adapter's gradients (``.grad``) to global norm
    ``max_grad_norm`` as optax does (scaled by max/‖g‖ only when ‖g‖ exceeds
    it), then one AdamW step at the schedule's lr for ``count`` optimizer
    steps taken so far. Returns the norm before the clip and the lr."""

    grads = [p.grad for p in adapter.values()]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    torch._foreach_mul_(grads, torch.clamp(tc.max_grad_norm / norm, max=1.0))
    lr = make_lr_schedule(tc)(count)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    return {"grad_norm": norm, "lr": lr}


def train_step(modules, tc: TrainConfig, adapter: Mapping[str, torch.nn.Parameter],
               optimizer: torch.optim.Optimizer, count: int, micro_batches: Sequence[Mapping],
               generator: torch.Generator, mesh=None) -> Dict:
    """One optimizer step over K micro-batches: the gradient is the mean of
    the K micro-batch gradients, the reported loss the mean of their losses.
    The random inputs come from ``generator`` (``compute_loss`` also takes
    them as tensors, as the tests pass them). With ``mesh``
    (``parallel/mesh.py``) the micro-batches are this rank's rows, and the
    gradients and the loss are averaged over its ``data`` axis, as the
    module docstring describes."""

    for p in adapter.values():
        p.grad = None
    losses = []
    for mb in micro_batches:
        rows = {} if mesh is None else {"rows": mesh.rows(mb["mel"].shape[0])}
        loss = compute_loss(modules, tc, mb, **sample_noise(modules, mb, generator, **rows))
        loss.backward()
        losses.append(loss.detach())
    k = len(micro_batches)
    for key, p in adapter.items():
        if p.grad is None:
            raise RuntimeError(f"adapter weight {key} got no gradient: the backward did not reach its site")
        if k > 1:
            p.grad.div_(k)
    loss = torch.stack(losses).mean()
    if mesh is not None:
        all_reduce_mean_(mesh, [p.grad for p in adapter.values()] + [loss])
    metrics = optimizer_step(tc, adapter, optimizer, count)
    metrics["loss"] = loss
    return metrics
