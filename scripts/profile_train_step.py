#!/usr/bin/env python3
"""Where the time of one adapter-training step goes on one NVIDIA GPU.

    python3 scripts/profile_train_step.py [--steps 3] [--pool 2] [--variants plain,remat,8bit] [--rounds 2]

Full-width ``PipelineConfig()`` in bf16 with random weights (seed 0), the
adapter started from the text K/V, one optimizer step = 2 micro-batches of
8 ten-second clips (latent 256 x 16), the conditioning drawn at random on
the device (GPT-2 8 tokens + 512 / pool^2 AudioMAE tokens, 64 T5 tokens),
so the step alone is measured, without the data pipeline. Prints:

* the wall time of ``--steps`` synchronised steps after a warm-up step, and
  the peak memory;
* one step under ``torch.profiler`` (CPU and CUDA activities): device
  kernel time by kernel name and the device's idle share (1 - kernel time
  / wall time, of the profiled step and of the median unprofiled one: the
  profiler's host cost inflates the first); annotated device ranges (the
  optimizer step's) span kernels, so they are listed apart, not counted;
* the card's ``nvidia-smi --query-gpu=name,power.limit`` line, and a JSON
  summary as the last line.

``--variants`` names the training configurations to measure on the same
weights and batches, in turns (reversed every other of ``--rounds``):
``plain`` (the default), ``remat`` (``UNetConfig.remat``: each resnet and
attention group recomputed in the backward), ``8bit`` (AdamW with a bf16
first moment) and ``remat+8bit``. Each variant gets its own optimizer, a
warm-up step, its timed steps and its peak memory, and one profiled step.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--pool", type=int, default=2, choices=(1, 2, 4, 8))
    ap.add_argument("--variants", default="plain", help="comma list of plain, remat, 8bit, remat+8bit")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    variants = args.variants.split(",")
    if not set(variants) <= {"plain", "remat", "8bit", "remat+8bit"}:
        ap.error(f"unknown variant in {args.variants!r}")
    import torch

    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from ap_adapter_torch.adapter.params import init_adapter_from_text_kv
    from ap_adapter_torch.configs import PipelineConfig
    from ap_adapter_torch.pipeline.pipeline import PipelineModules
    from ap_adapter_torch.train.trainer import TrainConfig, make_optimizer, split_unet_params

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    cfg = PipelineConfig()
    mods = PipelineModules(cfg).init_random(0, device=dev)
    init_adapter_from_text_kv(mods.unet)
    adapter = split_unet_params(mods.unet)
    gen = torch.Generator(device=dev).manual_seed(0)
    b, n_ip = 8, 512 // args.pool ** 2

    def batch():
        mask = torch.ones(b, 64, dtype=torch.long, device=dev)
        mask[::2, 20:] = 0
        return {"mel": torch.randn(b, 1024, cfg.mel.num_mel_bins, 1, generator=gen, device=dev) - 4.0,
                "generated_prompt_embeds": torch.randn(b, 8 + n_ip, 768, generator=gen, device=dev,
                                                       dtype=mods.dtype),
                "prompt_embeds": torch.randn(b, 64, cfg.t5.d_model, generator=gen, device=dev, dtype=mods.dtype),
                "attention_mask": mask}

    micro = [batch() for _ in range(2)]
    base_unet = mods.unet.config
    results = []
    for r in range(args.rounds):
        for variant in (variants if r % 2 == 0 else variants[::-1]):
            mods.unet.config = dataclasses.replace(base_unet, remat="remat" in variant)
            tc = TrainConfig(gradient_accumulation_steps=2, use_8bit_adam="8bit" in variant)
            # a fresh optimizer each time: only this variant's moments count in its peak
            res = measure(mods, tc, adapter, make_optimizer(tc, adapter.values()), micro, gen, args.steps)
            res.update(variant=variant, round=r)
            results.append(res)
            print(f"[{variant}, round {r}] steps {[round(w, 4) for w in res['step_seconds']]} s, "
                  f"max_memory_allocated {res['max_memory_allocated'] / 2**30:.3f} GiB, profiled step: wall "
                  f"{res['profiled_wall_s']:.4f} s, device kernel time {res['kernel_ms']:.1f} ms, idle share "
                  f"{res['idle_share']:.3f} (against the median unprofiled step: "
                  f"{res['idle_share_vs_median_step']:.3f}); annotated ranges (not counted) "
                  f"{ {n: round(ms, 2) for n, ms in res['annotations_ms'].items()} }", flush=True)
            for row in res["top"][:12]:
                print(f"  {row['ms']:10.2f} ms {row['count']:7d}  {row['name'][:110]}", flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "pool": args.pool, "results": results}), flush=True)
    return 0


def measure(mods, tc, adapter, opt, micro, gen, steps: int) -> dict:
    """A warm-up step, ``steps`` timed steps with the peak memory, then one
    step under ``torch.profiler``: device kernel time by kernel name and the
    device's idle share."""

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ap_adapter_torch.train.trainer import train_step

    def step(i):
        return train_step(mods, tc, adapter, opt, i, micro, gen)

    step(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for i in range(steps):
        t0 = time.perf_counter()
        m = step(i + 1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(steps + 1)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    by_name, annotations = {}, {}
    for e in prof.events():      # device events: kernels, memcpy, memset, and annotated ranges
        if e.device_type == DeviceType.CUDA:
            # a user annotation (the optimizer's step range) spans kernels; it is no kernel itself
            annotated = getattr(e, "is_user_annotation", False) or e.name.startswith(("Optimizer.", "ProfilerStep"))
            r = (annotations if annotated else by_name).setdefault(e.name, [0.0, 0])
            r[0] += e.time_range.elapsed_us() / 1e3
            r[1] += 1
    rows = sorted(((name, ms, n) for name, (ms, n) in by_name.items()), key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    plain_wall = sorted(walls)[len(walls) // 2]
    return {"step_seconds": walls, "loss": float(m["loss"]), "max_memory_allocated": peak,
            "profiled_wall_s": prof_wall, "kernel_ms": total, "idle_share": 1 - total / 1e3 / prof_wall,
            "idle_share_vs_median_step": 1 - total / 1e3 / plain_wall,
            "top": [{"name": n, "ms": ms, "count": c} for n, ms, c in rows[:25]],
            "annotations_ms": {n: ms for n, (ms, _) in annotations.items()}}


if __name__ == "__main__":
    sys.exit(main())
