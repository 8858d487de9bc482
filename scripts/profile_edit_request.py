#!/usr/bin/env python3
"""Where the time of one edit request goes on one NVIDIA GPU, bf16 against
the int8 W8A8 serving configuration (``UNetConfig.use_int8``) and the
fused-resnet one (``UNetConfig.use_pallas_resnet``, K13 at every resnet).

    python3 scripts/profile_edit_request.py [--batches 1,4] [--pairs 3] [--configs bf16,int8,resnet] [--root DIR]

Full-width ``PipelineConfig()`` in bf16 with random weights (seed 0); the
int8 and resnet pipelines serve the same weights (shared tensors), the
int8 one quantized once, the resnet one with its HWIO conv weights
prepared once. ``--configs bf16`` serves bf16 alone; ``--root`` imports ``ap_adapter_torch``
from another tree (an unpacked ``git archive`` of another commit), so that
runs of two commits can alternate within one call.
Requests are ``AudioLDM2Pipeline.generate`` with the ``timbre_transfer``
settings (10 s, 50 DDIM steps, guidance 7.5, ap_scale 0.5, pool 2/2) at each
batch of ``--batches`` clips. For each batch it prints:

* after one warm-up request of each configuration, ``--pairs`` pairs of
  synchronised request times in turns (bf16, int8, then int8, bf16, ...), so
  that both see the same card and host, and each configuration's peak
  memory;
* one request of each under ``torch.profiler`` (CPU and CUDA activities):
  device kernel time by kernel name and share, and the device's idle share
  (1 - kernel time / wall, of the profiled request and of the median
  unprofiled one: the profiler's host cost inflates the first);
* the card's ``nvidia-smi --query-gpu=name,power.limit`` line, and a JSON
  summary as the last line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel_table(prof):
    """[(kernel name, device ms, count)] by device time, and their sum."""

    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():      # device events only: kernels, memcpy, memset
        if e.device_type == DeviceType.CUDA:
            r = by_name.setdefault(e.name, [0.0, 0])
            r[0] += e.time_range.elapsed_us() / 1e3
            r[1] += 1
    rows = sorted(((n, ms, c) for n, (ms, c) in by_name.items()), key=lambda r: -r[1])
    return rows, sum(r[1] for r in rows)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="1,4", help="comma-separated clips per request")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--configs", default="bf16,int8", help="comma-separated: bf16, int8, resnet")
    ap.add_argument("--root", default=ROOT, help="the tree whose ap_adapter_torch serves the requests")
    args = ap.parse_args()
    configs = args.configs.split(",")
    switches = {"int8": "use_int8", "resnet": "use_pallas_resnet"}
    if not configs or set(configs) - {"bf16", *switches}:
        ap.error("--configs takes bf16, int8 and resnet")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_edit_request: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from torch.profiler import ProfilerActivity, profile

    from ap_adapter_torch.configs import PipelineConfig, get_task_config
    from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline, PipelineModules
    from ap_adapter_torch.pipeline.tokenize import make_text_batch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    config = PipelineConfig()
    pipes = {"bf16": AudioLDM2Pipeline.from_random(config, seed=0, device=dev, dtype=torch.bfloat16)}
    for name, switch in switches.items():
        if name in configs:
            cfg = config.replace(unet=dataclasses.replace(config.unet, **{switch: True}))
            mods = PipelineModules(cfg)
            mods.load_state_dict(pipes["bf16"].modules.state_dict(), strict=True, assign=True)
            pipes[name] = AudioLDM2Pipeline(cfg, mods)        # quantizes / prepares its weights once
    if "bf16" not in configs:
        del pipes["bf16"]
    task = get_task_config("timbre_transfer")
    summary = {"card": card, "root": os.path.abspath(args.root), "batches": {}}

    for b in (int(v) for v in args.batches.split(",")):
        pos = make_text_batch(config, [task.positive_text_prompts[0]] * b)
        neg = make_text_batch(config, [task.negative_text_prompts[0]] * b)
        fbank = np.random.default_rng(0).standard_normal((b, *config.audiomae.img_size)).astype(np.float32)

        def request(name):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipes[name].generate(pos, neg, fbank, audio_length_in_s=task.audio_length_in_s,
                                 num_inference_steps=task.num_inference_steps,
                                 guidance_scale=task.guidance_scale, ap_scale=task.ap_scale,
                                 time_pool=task.time_pooling, freq_pool=task.freq_pooling, seed=0)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        walls = {name: [] for name in configs}
        peaks = {}
        for name in walls:
            request(name)                                  # warm-up
        for i in range(args.pairs):
            for name in (configs if i % 2 == 0 else configs[::-1]):
                torch.cuda.reset_peak_memory_stats()
                walls[name].append(request(name))
                peaks[name] = torch.cuda.max_memory_allocated()
                print(f"batch {b} {name}: {walls[name][-1]:.4f} s", flush=True)
        out = {}
        for name in walls:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                prof_wall = request(name)
            rows, total = kernel_table(prof)
            median = statistics.median(walls[name])
            print(f"batch {b} {name}: requests {[round(w, 4) for w in walls[name]]} s (median {median:.4f}), "
                  f"max_memory_allocated {peaks[name] / 2**30:.3f} GiB; profiled request wall {prof_wall:.4f} s, "
                  f"device kernel time {total:.1f} ms, idle share {1 - total / 1e3 / prof_wall:.3f} "
                  f"(against the median request: {1 - total / 1e3 / median:.3f})", flush=True)
            for kname, ms, n in rows[:15]:
                print(f"  {ms:10.2f} ms {100 * ms / total:5.1f}% {n:7d}  {kname[:110]}", flush=True)
            out[name] = {"seconds": walls[name], "median_s": median, "max_memory_allocated": peaks[name],
                         "profiled_wall_s": prof_wall, "kernel_ms": total,
                         "idle_share_vs_median": 1 - total / 1e3 / median,
                         "top": [{"name": n, "ms": ms, "count": c} for n, ms, c in rows[:15]]}
        summary["batches"][b] = out
    print(card, flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
