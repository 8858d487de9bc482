#!/usr/bin/env python3
"""Where the time of one adapter-training step goes on one NVIDIA GPU.

    python3 scripts/profile_train_step.py [--steps 3] [--pool 2]

Full-width ``PipelineConfig()`` in bf16 with random weights (seed 0), the
adapter started from the text K/V, one optimizer step = 2 micro-batches of
8 ten-second clips (latent 256 x 16), the conditioning drawn at random on
the device (GPT-2 8 tokens + 512 / pool^2 AudioMAE tokens, 64 T5 tokens),
so the step alone is measured, without the data pipeline. Prints:

* the wall time of ``--steps`` synchronised steps after a warm-up step, and
  the peak memory;
* one step under ``torch.profiler`` (CPU and CUDA activities): device
  kernel time by kernel name, its share, and the device's idle share
  (1 - kernel time / wall time, of the profiled step and of the median
  unprofiled one: the profiler's host cost inflates the first);
* the card's ``nvidia-smi --query-gpu=name,power.limit`` line, and a JSON
  summary as the last line.
"""

from __future__ import annotations

import argparse
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
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from ap_adapter_torch.adapter.params import init_adapter_from_text_kv
    from ap_adapter_torch.configs import PipelineConfig
    from ap_adapter_torch.pipeline.pipeline import PipelineModules
    from ap_adapter_torch.train.trainer import TrainConfig, make_optimizer, split_unet_params, train_step

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    cfg = PipelineConfig()
    mods = PipelineModules(cfg).init_random(0, device=dev)
    init_adapter_from_text_kv(mods.unet)
    tc = TrainConfig(gradient_accumulation_steps=2)
    adapter = split_unet_params(mods.unet)
    opt = make_optimizer(tc, adapter.values())
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

    micro = [batch() for _ in range(tc.gradient_accumulation_steps)]

    def step(i):
        return train_step(mods, tc, adapter, opt, i, micro, gen)

    step(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for i in range(args.steps):
        t0 = time.perf_counter()
        m = step(i + 1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        print(f"step {i + 1}: {walls[-1]:.4f} s, loss {float(m['loss']):.6g}, grad_norm {float(m['grad_norm']):.6g}",
              flush=True)
    peak = torch.cuda.max_memory_allocated()

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(args.steps + 1)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():      # device events only: kernels, memcpy, memset
        if e.device_type == DeviceType.CUDA:
            r = by_name.setdefault(e.name, [0.0, 0])
            r[0] += e.time_range.elapsed_us() / 1e3
            r[1] += 1
    rows = [(name, ms, n) for name, (ms, n) in by_name.items()]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    plain_wall = sorted(walls)[len(walls) // 2]
    print(f"profiled step: wall {prof_wall:.4f} s, device kernel time {total:.1f} ms, idle share "
          f"{1 - total / 1e3 / prof_wall:.3f} (against the median unprofiled step {plain_wall:.4f} s: "
          f"{1 - total / 1e3 / plain_wall:.3f})", flush=True)
    for name, ms, n in rows[:25]:
        print(f"  {ms:10.2f} ms {100 * ms / total:5.1f}% {n:7d}  {name[:110]}", flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "pool": args.pool, "step_seconds": walls, "max_memory_allocated": peak,
                      "profiled_wall_s": prof_wall, "kernel_ms": total,
                      "idle_share": 1 - total / 1e3 / prof_wall,
                      "idle_share_vs_median_step": 1 - total / 1e3 / plain_wall,
                      "top": [{"name": n, "ms": ms, "count": c} for n, ms, c in rows[:25]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
