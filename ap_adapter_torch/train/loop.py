"""Training loop: optimizer steps, rotating checkpoints, resume, the flat
adapter export, validation rounds, and metrics (JSONL, and tensorboard or
wandb where asked for).

Counterpart of ``ap_adapter_tpu/train/loop.py``. ``step`` counts optimizer
steps (the reference's global_step); each takes
``gradient_accumulation_steps`` batches from the loader. Data-parallel
(``mesh=``): every rank steps on its own rows (``train_step``'s
all-reduce), and rank 0 alone writes the checkpoints, the flat adapter and
the metrics and runs the validation rounds (JAX loop.py:151-167), each
followed by a barrier, so a rank never reads a half-written checkpoint;
every rank restores the same newest checkpoint on resume.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Iterable, Optional

import torch

from ap_adapter_torch.adapter.params import export_flat_adapter
from ap_adapter_torch.parallel.distributed import process_index
from ap_adapter_torch.parallel.mesh import barrier
from ap_adapter_torch.train.trainer import TrainConfig, make_optimizer, split_unet_params, train_step
from ap_adapter_torch.utils.checkpoint import TrainCheckpointer, save_flat_adapter
from ap_adapter_torch.utils.logging import MetricsLogger


@dataclasses.dataclass
class TrainState:
    step: int                                    # optimizer steps taken
    adapter: Dict[str, torch.nn.Parameter]       # flat key -> trainable fp32 parameter
    optimizer: torch.optim.Optimizer
    history: list                                # the metrics of this run's steps


def step_generator(tc: TrainConfig, step: int, device) -> torch.Generator:
    """The noise stream of one optimizer step, from (seed, step) alone, so a
    resumed run draws what an uninterrupted one would."""

    return torch.Generator(device=device).manual_seed(tc.seed * 1_000_003 + step)


def train(modules, batches: Iterable, tc: TrainConfig, output_dir: str, max_steps: Optional[int] = None,
          log_every: int = 50, validation_fn: Optional[Callable[[int], object]] = None,
          report_to: str = "jsonl", mesh=None) -> TrainState:
    """Finetune the adapter of ``modules`` on ``batches`` (collated batches on
    the modules' device). Writes ``checkpoints/step_*.pt`` (rotating) and
    the flat adapter ``pytorch_model.npz`` every ``checkpointing_steps`` and
    at the last step, and ``metrics.jsonl`` (with ``report_to``
    "tensorboard" also ``tb/``, with "wandb" a wandb run, each where its
    package imports). ``validation_fn(step)`` runs after every optimizer
    step that ``validation_steps`` divides (``train/validation.py``). A run
    restarted in the same ``output_dir`` restores the newest checkpoint
    (adapter, optimizer, step) and continues; the data order restarts, as
    the reference's does. With ``mesh`` (``parallel/mesh.py``) the batches
    are this rank's rows, and rank 0 alone writes and validates, as the
    module docstring describes."""

    writer = process_index() == 0
    if writer:
        os.makedirs(output_dir, exist_ok=True)
    if mesh is not None:
        barrier(mesh)
    max_steps = max_steps or tc.max_train_steps
    adapter = split_unet_params(modules.unet)
    optimizer = make_optimizer(tc, adapter.values())
    ckpt = TrainCheckpointer(os.path.join(output_dir, "checkpoints"))
    step = 0
    if ckpt.latest_step() is not None:
        saved = ckpt.restore()
        with torch.no_grad():
            for k, p in adapter.items():
                p.copy_(saved["adapter"][k])
        optimizer.load_state_dict(saved["optimizer"])
        step = saved["step"]

    dev = modules.device
    cuda = dev.type == "cuda"
    logger = None
    if writer:
        logger = MetricsLogger(os.path.join(output_dir, "metrics.jsonl"),
                               tensorboard_dir=os.path.join(output_dir, "tb") if report_to == "tensorboard" else None,
                               wandb_project="ap_adapter_torch" if report_to == "wandb" else None,
                               wandb_config={"max_steps": max_steps, **dataclasses.asdict(tc)})
    history = []
    it = iter(batches)
    start = step
    while step < max_steps:
        micro = [next(it) for _ in range(tc.gradient_accumulation_steps)]
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        metrics = train_step(modules, tc, adapter, optimizer, step, micro, step_generator(tc, step + 1, dev), mesh)
        step += 1
        m = {"step": step, "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
             "lr": metrics["lr"], "seconds": time.perf_counter() - t0}
        if cuda:
            m["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        history.append(m)
        if writer and (step % log_every == 0 or step == start + 1 or step == max_steps):
            logger.log(m)
        if step % tc.checkpointing_steps == 0 or step == max_steps:
            if writer:
                ckpt.save(step, {"step": step, "adapter": {k: p.detach().cpu() for k, p in adapter.items()},
                                 "optimizer": optimizer.state_dict()})
                save_flat_adapter(os.path.join(output_dir, "pytorch_model.npz"), export_flat_adapter(modules.unet))
            if mesh is not None:
                barrier(mesh)
        if step % tc.validation_steps == 0:
            if writer and validation_fn is not None:
                if cuda:
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                validation_fn(step)
                if cuda:
                    torch.cuda.synchronize(dev)
                m["validation_seconds"] = time.perf_counter() - t0
            if mesh is not None:            # the other ranks hold no validation_fn
                barrier(mesh)
    if logger is not None:
        logger.close()
    return TrainState(step, adapter, optimizer, history)
