#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which fails the run:

1. the card: prints ``nvidia-smi --query-gpu=name,power.limit`` (exits
   non-zero without a CUDA device);
2. build: compiles the hand-written kernels (``ap_adapter_torch/csrc``) with
   nvcc into ``build/`` and prints the build time and the compiler's
   register / spill report;
3. kernels: K1, K2 (adapter on; T5 with its bias) and K3 at each main-path
   shape, B=2, bf16 inputs from a seeded generator: max abs and relative
   error against the plain PyTorch version (limit 2e-2 of max|plain|) and
   both times (CUDA events, median of 20 after warm-up);
4. reference: one full-width UNet forward (hoisted K/V, a short latent) with
   the kernels in bf16 against the plain path in fp32 on the CPU, same weights;
5. slice: the full-width ``PipelineConfig()`` in bf16 with random weights
   (seed 0) serves 2 requests through ``AudioLDM2Pipeline.generate`` at batch
   1 with the timbre_transfer settings (ap_scale 0.5, pool 2/2, guidance 7.5,
   10 s, 50 DDIM steps); checks each waveform ([1, 160000], finite, not
   constant) and that the kernel launch counts moved by exactly one per
   routed site per UNet forward; prints seconds and peak memory per request.

Two lines before the last is a JSON object with one entry per kernel
(``launches``: the count over the slice's requests; ``ms``/``plain_ms``: the
sum over the main-path shapes and variants, each one listed under
``cases``), then the card's ``nvidia-smi`` line; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = 2e-2          # kernel vs plain, fraction of max|plain| (bf16 rounding points differ)
UNET_TOL = 5e-2     # full UNet, bf16 kernels vs fp32 plain, fraction of max|ref|
SHAPES = [(1000, 256), (252, 384), (64, 640)]   # (S, C) of the three UNet levels, 8 heads
HEADS = 8
KERNELS = {
    "fused_ln_self_attention": ("ap_adapter_torch/csrc/fused_blocks.cu",
                                "ap_adapter_tpu/ops/pallas_fused_block.py:508"),
    "fused_ln_cross_attention_kv": ("ap_adapter_torch/csrc/fused_blocks.cu",
                                    "ap_adapter_tpu/ops/pallas_fused_cross.py:288"),
    "fused_ln_geglu_ff": ("ap_adapter_torch/csrc/fused_blocks.cu",
                          "ap_adapter_tpu/ops/pallas_fused_ff.py:70"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build_phase() -> None:
    from ap_adapter_torch.ops import cuda_kernels

    t0 = time.perf_counter()
    path = cuda_kernels.build()
    cuda_kernels.library()
    log(f"build: {path.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    report = (cuda_kernels.BUILD_DIR / "nvcc.log")
    if report.exists():
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")


def kernel_phase(device) -> dict:
    """K1/K2/K3 against their plain versions at the main-path shapes."""

    import torch

    from ap_adapter_torch.ops.fused_block import fused_ln_self_attention, fused_ln_self_attention_plain
    from ap_adapter_torch.ops.fused_cross import (
        fused_ln_cross_attention_kv, fused_ln_cross_attention_kv_plain)
    from ap_adapter_torch.ops.fused_ff import fused_ln_geglu_ff, fused_ln_geglu_ff_plain

    gen = torch.Generator(device=device).manual_seed(0)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    results = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "cases": []} for name in KERNELS}
    for s, c in SHAPES:
        x = r(2, s, c)
        ln_w, ln_b = 1 + r(c, scale=0.1), r(c, scale=0.1)
        wq, wk, wv, wo = (r(c, c, scale=c ** -0.5) for _ in range(4))
        bo = r(c, scale=0.1)
        t5_bias = torch.zeros(2, 64, device=device)
        t5_bias[0, 12:] = -10000.0            # padded T5 positions
        t5_bias[1, 30:] = -10000.0
        w1, b1 = r(8 * c, c, scale=c ** -0.5), r(8 * c, scale=0.1)
        w2, b2 = r(c, 4 * c, scale=(4 * c) ** -0.5), r(c, scale=0.1)
        k_txt, v_txt, k_ip, v_ip = r(2, 8, c), r(2, 8, c), r(2, 128, c), r(2, 128, c)
        k_t5, v_t5 = r(2, 64, c), r(2, 64, c)
        cases = [
            ("fused_ln_self_attention", "self",
             lambda: fused_ln_self_attention(x, ln_w, ln_b, wq, wk, wv, wo, bo, HEADS),
             lambda: fused_ln_self_attention_plain(x, ln_w, ln_b, wq, wk, wv, wo, bo, HEADS)),
            ("fused_ln_cross_attention_kv", "adapter",
             lambda: fused_ln_cross_attention_kv(x, k_txt, v_txt, ln_w, ln_b, wq, wo, bo, HEADS,
                                                 ki=k_ip, vi=v_ip, ip_scale=0.5),
             lambda: fused_ln_cross_attention_kv_plain(x, k_txt, v_txt, ln_w, ln_b, wq, wo, bo, HEADS,
                                                       ki=k_ip, vi=v_ip, ip_scale=0.5)),
            ("fused_ln_cross_attention_kv", "t5+bias",
             lambda: fused_ln_cross_attention_kv(x, k_t5, v_t5, ln_w, ln_b, wq, wo, bo, HEADS, bias=t5_bias),
             lambda: fused_ln_cross_attention_kv_plain(x, k_t5, v_t5, ln_w, ln_b, wq, wo, bo, HEADS,
                                                       bias=t5_bias)),
            ("fused_ln_geglu_ff", "geglu",
             lambda: fused_ln_geglu_ff(x, ln_w, ln_b, w1, b1, w2, b2),
             lambda: fused_ln_geglu_ff_plain(x, ln_w, ln_b, w1, b1, w2, b2)),
        ]
        for name, variant, kernel, plain in cases:
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise RuntimeError(f"{name}/{variant} S={s} C={c}: bad output {tuple(got.shape)}")
            err = (got.float() - want.float()).abs().max().item()
            peak = want.float().abs().max().item()
            ms, plain_ms = time_ms(kernel), time_ms(plain)
            log(f"kernel {name:28s} {variant:8s} S={s:4d} C={c} d={c // HEADS}: max_abs_err={err:.4g} "
                f"rel={err / peak:.4g} (limit {TOL}) ms={ms:.4f} plain_ms={plain_ms:.4f}")
            if not err <= TOL * peak:
                raise RuntimeError(f"{name}/{variant} S={s} C={c}: error {err} > {TOL} * {peak}")
            res = results[name]
            res["max_abs_err"] = max(res["max_abs_err"], err)
            res["ms"] += ms
            res["plain_ms"] += plain_ms
            res["cases"].append({"variant": variant, "S": s, "C": c, "max_abs_err": err,
                                 "rel_err": err / peak, "ms": ms, "plain_ms": plain_ms})
    return results


def expected_launches(unet_config) -> dict:
    """Kernel calls per UNet forward: every transformer block runs K1 at attn1,
    K1 or K2 at attn2 (double-self or cross) and K3 at its feed-forward."""

    c = unet_config
    groups = (sum(c.down_block_has_attn) * c.layers_per_block + 1
              + sum(c.up_block_has_attn) * (c.layers_per_block + 1))
    blocks = c.transformer_layers_per_block
    n_cross = sum(d is not None for d in c.cross_attention_dims)
    n_self = len(c.cross_attention_dims) - n_cross
    return {"fused_ln_self_attention": groups * blocks * (len(c.cross_attention_dims) + n_self),
            "fused_ln_cross_attention_kv": groups * blocks * n_cross,
            "fused_ln_geglu_ff": groups * blocks * len(c.cross_attention_dims)}


def reference_phase(modules, device) -> float:
    """One full-width UNet forward on a short latent: bf16 kernels on the card
    against the plain path in fp32 on the CPU, with the same weights."""

    import copy

    import torch

    from ap_adapter_torch.models.hoist import precompute_cross_kv, precompute_temb_rows

    c = modules.config
    g = torch.Generator().manual_seed(1)
    lat = torch.randn(2, 16, 16, c.unet.in_channels, generator=g)
    ehs0 = torch.randn(2, 8 + 128, c.unet.adapter_cross_attention_dim, generator=g)
    ehs1 = torch.randn(2, 64, c.t5.d_model, generator=g)
    mask = torch.ones(2, 64, dtype=torch.long)
    mask[0, 12:] = 0
    ts = torch.full((2,), 501.0)

    def run(unet, dev):
        args = [a.to(dev) for a in (lat, ts, ehs0, ehs1, mask)]
        kv = precompute_cross_kv(unet, args[2], args[3], args[4])
        rows = {k: v[0] for k, v in precompute_temb_rows(unet, [501]).items()}
        with torch.no_grad():
            return unet(*args, ip_scale=0.5, ctx_kv=kv, temb_rows=rows).float().cpu()

    got = run(modules.unet, device)
    ref_unet = copy.deepcopy(modules.unet).to("cpu", torch.float32)
    want = run(ref_unet, "cpu")
    del ref_unet
    err = (got - want).abs().max().item()
    peak = want.abs().max().item()
    log(f"reference: full-width UNet, bf16 kernels on {device} vs fp32 plain on cpu: "
        f"max_abs_err={err:.4g} rel={err / peak:.4g} (limit {UNET_TOL})")
    if not (torch.isfinite(got).all() and err <= UNET_TOL * peak):
        raise RuntimeError(f"UNet reference check failed: {err} > {UNET_TOL} * {peak}")
    return err / peak


def slice_phase(pipe, device, requests: int = 2) -> list:
    import numpy as np
    import torch

    from ap_adapter_torch.configs import get_task_config
    from ap_adapter_torch.ops import cuda_kernels
    from ap_adapter_torch.pipeline.tokenize import make_text_batch

    c = pipe.config
    task = get_task_config("timbre_transfer")
    pos = make_text_batch(c, [task.positive_text_prompts[0]])
    neg = make_text_batch(c, [task.negative_text_prompts[0]])
    fbank = np.random.default_rng(0).standard_normal((1, *c.audiomae.img_size)).astype(np.float32)
    per_forward = expected_launches(c.unet)
    want = {k: v * task.num_inference_steps for k, v in per_forward.items()}
    samples = int(task.audio_length_in_s * c.vocoder.sampling_rate)

    cuda_kernels.reset_launch_counts()
    runs, before = [], dict(cuda_kernels.LAUNCHES)
    for i in range(requests):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav = pipe.generate(pos, neg, fbank, audio_length_in_s=task.audio_length_in_s,
                            num_inference_steps=task.num_inference_steps,
                            guidance_scale=task.guidance_scale, ap_scale=task.ap_scale,
                            time_pool=task.time_pooling, freq_pool=task.freq_pooling, seed=i)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        now = dict(cuda_kernels.LAUNCHES)
        moved = {k: now[k] - before[k] for k in now}
        before = now
        mem = torch.cuda.max_memory_allocated()
        log(f"request {i}: {seconds:.3f} s, max_memory_allocated={mem / 2**30:.3f} GiB, "
            f"wav {wav.shape} std={wav.std():.4g} max|wav|={np.abs(wav).max():.4g}, launches {moved}")
        if wav.shape != (1, samples) or not np.all(np.isfinite(wav)) or not wav.std() > 0:
            raise RuntimeError(f"request {i}: bad waveform {wav.shape}")
        if np.abs(wav).max() > 1.0:
            raise RuntimeError(f"request {i}: waveform outside the tanh range")
        if moved != want:
            raise RuntimeError(f"request {i}: launch counts {moved} != expected {want}")
        runs.append({"seconds": seconds, "max_memory_allocated": mem, "launches": moved})
    return runs


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "ap_adapter_torch")):
        print("chip_smoke: no ap_adapter_torch/ beside this script; run it from a checkout", file=sys.stderr)
        return 1
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from ap_adapter_torch.configs import PipelineConfig
    from ap_adapter_torch.ops import cuda_kernels
    from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline

    # stated, not inherited: fp32 products in the plain versions and the references
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    build_phase()
    kernels = kernel_phase(device)

    config = PipelineConfig()
    if expected_launches(config.unet) != {"fused_ln_self_attention": 192,
                                          "fused_ln_cross_attention_kv": 64, "fused_ln_geglu_ff": 128}:
        raise RuntimeError("unexpected UNet routing at full width")
    t0 = time.perf_counter()
    pipe = AudioLDM2Pipeline.from_random(config, seed=0, device=device, dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in pipe.modules.parameters())
    log(f"random weights: {n_params / 1e6:.1f}M params in {time.perf_counter() - t0:.1f} s")
    reference_phase(pipe.modules, device)
    runs = slice_phase(pipe, device)

    total = {k: sum(r["launches"][k] for r in runs) for k in KERNELS}
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu, "launches": total[name],
         "max_abs_err": kernels[name]["max_abs_err"], "ms": kernels[name]["ms"],
         "plain_ms": kernels[name]["plain_ms"], "cases": kernels[name]["cases"]}
        for name, (src, tpu) in KERNELS.items()],
        "requests": [{"seconds": r["seconds"], "max_memory_allocated": r["max_memory_allocated"]}
                     for r in runs]}
    if min(total.values()) <= 0 or set(cuda_kernels.LAUNCHES) != set(KERNELS):
        raise RuntimeError(f"a kernel of the path was not launched: {total}")
    print(json.dumps(report), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
