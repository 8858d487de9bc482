#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which fails the run and
prints its seconds:

1. the card: prints ``nvidia-smi --query-gpu=name,power.limit`` (exits
   non-zero without a CUDA device);
2. build: compiles the hand-written kernels (``ap_adapter_torch/csrc``) with
   nvcc into ``build/``, one process per source, and prints the build time
   and the compiler's register / spill report;
3. kernels: K1, K2 (adapter on; T5 with its bias) and K3 at each edit-path
   shape, B=2, bf16 inputs from a seeded generator: max abs and relative
   error against the plain PyTorch version (limit 2e-2 of max|plain|) and
   both times (CUDA events, median of 20 after warm-up); every case also
   lists its device kernels with each one's device ms a call
   (torch.profiler), and K1's times ``F.scaled_dot_product_attention`` on
   q/k/v of its shape [2, S, 8, C/8] as information (K1 computes more than
   attention, so it is not K1's library call); then K2 at MusicGen-large's
   decode step (16 rows of one position, C 2048, 32 heads of 64, 64 T5
   keys, keys past 20 masked on the cond rows and every key on the null
   rows, whose K/V are zero and whose output must equal their input);
4. training kernels: K4 (forward; adapter context 8 + 512 tokens, T5 with
   its bias), K7, K8 (dx, dk_ip/dv_ip and the adapter weight gradients) and
   K9 (dx) at the three training levels, B=8, against the plain version and
   autograd over it (limits 2e-2 of max|plain| forward, 5e-2 gradients);
   then K4 at the three edit levels, B=2, with no adapter set: 8 text keys
   at 768 wide, and 64 T5 keys at 1024 wide with the padding bias (the
   ControlNet-branch request's cross sites); their cases list their device
   kernels with each one's device ms;
5. reference: one full-width UNet forward (hoisted K/V, a short latent) with
   the kernels in bf16 against the plain path in fp32 on the CPU, same weights;
6. edit slice: the full-width ``PipelineConfig()`` in bf16 with random weights
   (seed 0) serves 2 requests through ``AudioLDM2Pipeline.generate`` at batch
   1 with the timbre_transfer settings (ap_scale 0.5, pool 2/2, guidance 7.5,
   10 s, 50 DDIM steps); checks each waveform ([1, 160000], finite, not
   constant) and that the kernel launch counts moved by exactly one per
   routed site per UNet forward; prints seconds and peak memory per request;
7. training reference: the training loss and its adapter gradient at full
   width on a 16x16 latent, B=2, no hoisting, with the bf16 kernels on the
   card against the plain path in fp32 on the CPU (same weights, noise and
   timesteps): loss within 5e-2 relative, gradient cosine >= 0.99 and norm
   ratio in [0.95, 1.05];
8. training slice: ``ap_adapter_torch.train.cli`` on 16 seeded synthetic
   10 s wavs at full width, batch 8, accumulation 2, 3 optimizer steps:
   finite losses and gradient norms, every adapter matrix moved and every
   frozen weight bit-identical, the exported flat adapter reloads to the
   trained tensors, and the launch counts are exactly (forward + backward)
   per micro-step; prints each step's seconds and peak memory;
9. int8 kernels: K11a, K11b and K11c (adapter on; T5 with its bias) at each
   edit-path shape, B=2, int8 weights from ``quantize_weight``, against the
   plain versions (exact integer products in float64; limit 2e-2 of
   max|plain|), with both times; their cases list their device kernels,
   and K11a's and K11c's time their int8 products as ``torch._int_mm``
   calls (cuBLASLt) beside them as information;
10. int8 edit slice: the same weights as phase 6 under ``use_int8``
   (quantized once by the pipeline) serve the same 2 requests; the same
   waveform checks, launch counts of exactly one K11b/K11c/K11a per routed
   site per UNet forward and none of K1-K3; seconds and peak memory beside
   the bf16 requests'. Then the int8 request 0 against the bf16 request 0
   (same seed and inputs) in log-mel (``audio/mel.py``): cosine > 0.99 and
   mean abs difference < 0.1, with the waveform's relative error;
11. resnet kernels: the K5/K6 self-attention at [1, 4000, 1, 512] (an edit's
   VAE decode), [8, 4096, 1, 512] (a training batch's VAE encode), both on
   the one-pass wgmma kernel (the first with its keys split over a 2-CTA
   cluster), and [2, 1000, 8, 32] and [2, 1000, 8, 80] on the streamed
   routine (each case logs its route); K12 at every resnet GroupNorm
   shape of the edit (B=2), SiLU on and off, then two calls at the largest
   shape, which must be bit-equal; K13 at every distinct resnet
   shape of the edit, with a per-sample temb and without; each against its
   plain version (limit 2e-2 of max|plain|), with both times, the bound and
   ``library_ms`` (``F.scaled_dot_product_attention`` for the attention,
   ``F.group_norm`` for K12 without SiLU, none for K13); K13's cases list
   their device kernels, and time its two convs as channels-last bf16
   ``F.conv2d`` calls (cuDNN) beside it as information;
12. resnet-kernel edit slices: the same weights as phase 6 under
   ``use_pallas_groupnorm``, then under ``use_pallas_resnet`` (HWIO weights
   prepared once by the pipeline), one request each: the same waveform
   checks, exactly 2 K12 per resnet per UNet forward (none of K13), then
   exactly 1 K13 per resnet (none of K12), K1-K3 as phase 6, one
   self-attention launch (the VAE decode); log-mel against the bf16
   request 0 as phase 10;
13. task CLI: ``pipeline/tasks.py::main`` in process on the card,
   ``--task style_transfer --sdedit --random-weights`` on a seeded
   synthetic 10 s wav, one prompt, one file: the reference file name,
   160,000 samples, finite, not constant, and exactly 2 self-attention
   launches (encode, decode) and 26 steps of K1-K3; then ``run_task`` at
   the timbre_transfer template (one prompt) with the phase-6 pipeline.

14. dual-KV kernel: K10 at B=2, the three UNet levels, 8 text keys and
   each of 32, 128 and 512 audio keys, ip_scale 0.55, against its plain
   version (limit 2e-2 of max|plain|), with both times, the bound and its
   device kernel's device ms; two ``F.scaled_dot_product_attention`` calls
   plus the add are timed beside it as information (no single PyTorch call
   computes K10);
15. K10 edit slice: the same weights as phase 6 under
   ``use_pallas_attention``, one request: exactly one K10 per adapter site
   and one K2 per T5 site per UNet forward (1600 each), K1/K3 as phase 6,
   one self-attention launch; log-mel against the bf16 request 0;
16. re-ranking: ``generate_ranked`` under use_pallas_attention, 1 prompt x 2
   candidates, scored by a ``ClapScorer`` at the published widths (the
   pipeline's CLAP text tower, an HTSAT-base audio tower with random fp32
   weights): exactly one request's launches, and the candidates come back
   in the order of argsort of the scorer's similarities, computed apart;
17. eval runner: ``run_batched_eval`` on the phase-6 pipeline over 16
   seeded synthetic 10 s clips at batch 8, once in the CLAP space and once
   in the VGGish space (random full-width VGGish): clips/s, the source-vs-
   edit FAD, exact launch counts (two requests' worth); then
   ``run_eval_protocol`` with the clips split into two domains;
18. v1 edit slice: the AudioLDM v1 pipeline (``pipeline/audioldm_v1.py``,
   CLAP class labels, double self-attention) at ``PipelineConfig()``'s widths
   in bf16 with random weights (seed 0): its UNet step in bf16 against fp32
   on the CPU (limit 5e-2 of max|ref|), one warm-up request, then 2 requests
   of 10 s at 50 CFG DDIM steps, batch 1: the waveform checks of phase 6,
   seconds, peak memory and exact launch counts derived from its config
   (1600 K1, 800 K3, one self-attention);
19. ControlNet-branch edit slice: the phase-6 weights without the adapter's
   under ``cn_text_only`` with hoisting off: a generate with hoisting on
   must refuse; one request with exact counts (9600 K1, 6400 K3, 3200 K4,
   no K2), then the same seed with a different audio prompt, whose waveform
   must be bit-equal;
20. training slice II: the training CLI on phase 8's data and seed with
   ``--remat --use-8bit-adam --report-to tensorboard --validation-steps 2
   --num-validation-audio-files 2``, 3 steps: launch counts exactly the
   forward, the remat recompute (every attention group from the one holding
   the first adapter site on, derived from the config) and the backward per
   micro-step, plus one validation round (one 50-step edit request's
   launches); step 1's loss and gradient norm within 1e-3 relative of phase
   8's; every first moment bf16; the validation files, each generated wav
   [160000], finite and not constant; a ``tb/`` events file where
   tensorboard imports; each step's seconds and peak memory beside phase
   8's, and the validation round's seconds;
21. batched wav loader: a fresh build of ``native/wavio.cpp`` into
   ``build/``, then ``load_wav_batch`` over the 16 wavs bit-equal, file by
   file, to ``load_wav``; files/s of both;
22. MAE pretraining: ``MAEPretrain`` at ``AudioMAEConfig()`` (ViT-B/16, a
   512-wide 8-block decoder, 1024 x 128 fbanks of the training wavs, 512
   patches, mask 0.8), random weights (seed 0): one forward in bf16 on the
   card against fp32 on the CPU (loss within 1e-2 relative), then 3
   ``make_mae_pretrain_step`` steps at batch 8 in fp32 on the card (finite
   losses, every weight moved), with seconds and peak memory a step;
23. distributed (``ap_adapter_torch/parallel/``): (a) one full-width
   data-parallel ``train_step`` (2 micro-batches of 4) in a world of one
   NCCL rank, bit-equal (loss, gradient norm, updated adapter) to the same
   step without a process group; (b) two ranks sharing the one card over
   gloo (this script, ``--dist-rank r <dir>``; ``PipelineConfig()`` in bf16,
   random weights from the same seeds): 2 data-parallel optimizer steps
   through ``train(..., mesh=)`` at 4 rows a rank (accumulation 2; each
   rank's launches exactly ``expected_train_launches`` per micro-step, one
   self-attention each; rank 0 alone writes ``metrics.jsonl``), a
   data-parallel 10 s edit request (rank r's clip is row r of a batch of
   2), a ``--tensor-parallel 2`` request through ``tasks.load_pipeline`` (4
   heads a rank on the ``force_xla_core`` route: no K1-K4 or K10, one
   self-attention) and 2 data-parallel MAE steps in fp32; then, in this
   process, one process at the global batch: the training (loss and
   gradient norm within 1e-2 relative), the batch-2 request (each rank's
   clip within the log-mel limits of phase 10 of its row), one request on
   the ``force_xla_core`` route (the TP clips within the same limits; phase
   6's request 0 on the kernels beside it as information) and the MAE steps
   (loss within 1e-4 relative); seconds and peak memory of every run.
24. checkpoint conversion (``ap_adapter_torch/convert/cli.py``): phase 6's
   weights written in the public layout under ``build/convert_smoke/``, in
   bf16: a diffusers ``cvssp/audioldm2-large`` directory (each submodel's
   config.json, from which ``build_config`` must give back
   ``PipelineConfig()``; the ``ClapModel`` buffers, an HTSAT audio branch
   and logit scales; T5's tied embedding; GPT-2's ``wte``; the vocoder's
   ``mean``/``scale``; the UNet without adapter keys as a BF16
   ``.safetensors``), the adapter as the reference's ``.bin`` and AudioMAE's
   ``pretrained.pth`` with a random MAE decoder; ``python -m
   ap_adapter_torch.convert.cli`` in a subprocess (``unet.npz`` must hold the
   adapter); then the task CLI (``--checkpoint-dir``, ``--adapter-ckpt``)
   serves phase 13's timbre_transfer request: its wav bit-equal to phase
   13's ``run_task`` wav on the phase-6 pipeline, launches exactly one
   request's; the seconds and bytes of each step; the directory is deleted.

Phases 6, 8, 10, 12, 15-20, 24 also count one self-attention launch per
request and per training micro-step (the VAE mid block at 4000 and 4096
positions). Phases run in the order 1-4, 9, 11, 14, 5, 6, 10, 12, 15, 18,
19, 16, 17, 13, 24, 7, 8, 20-23. Two lines before the last is a JSON object with one entry per
kernel (``launches``: the count over its path's run, the edit requests for
K1-K3 and the self-attention, the int8 requests for K11a-c, the training
steps for K4 and K7-K9, the resnet-kernel requests for K12 and K13, the
use_pallas_attention request for K10; ``ms``/``plain_ms``/
``bound_ms``: the sum over the path's shapes and variants, each one listed
under ``cases``; ``library_ms``: the sum over the cases that have a library
call, beside ``library_cases_ms``, the kernel's time on those cases;
``bound_ms`` counts bf16 operations at the bf16 peak and int8 operations at
the int8 peak), then the card's ``nvidia-smi`` line; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = 2e-2          # kernel vs plain, fraction of max|plain| (bf16 rounding points differ)
GRAD_TOL = 5e-2     # backward kernels vs autograd over the plain version, fraction of max|plain|
UNET_TOL = 5e-2     # full UNet, bf16 kernels vs fp32 plain, fraction of max|ref|
LOSS_TOL = 5e-2     # training loss, bf16 kernels vs fp32 plain, relative
SHAPES = [(1000, 256), (252, 384), (64, 640)]   # (S, C) of the three UNet levels at the edit path's B=2
TRAIN_SHAPES = [(1024, 256), (256, 384), (64, 640)]   # the same levels of a 10 s training clip, B=8
TRAIN_B = 8
HEADS = 8
MG_ROWS, MG_WIDTH, MG_TEXT, MG_HEADS = 16, 2048, 64, 32   # MusicGen-large's decode step: 8 clips x CFG
PEAK_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_INT8 = 1979e12     # H100 SXM dense int8 tensor-core peak (operations/s)
LOGMEL_COS = 0.99       # int8 vs bf16 request, log-mel cosine (PARITY.md end-to-end row)
LOGMEL_MAD = 0.1        # int8 vs bf16 request, mean abs log-mel difference
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s
KERNELS = {
    "fused_ln_self_attention": ("ap_adapter_torch/csrc/fused_hopper.cu",
                                "ap_adapter_tpu/ops/pallas_fused_block.py:508"),
    "fused_ln_cross_attention_kv": ("ap_adapter_torch/csrc/fused_hopper.cu",
                                    "ap_adapter_tpu/ops/pallas_fused_cross.py:288"),
    "fused_ln_geglu_ff": ("ap_adapter_torch/csrc/fused_hopper.cu",
                          "ap_adapter_tpu/ops/pallas_fused_ff.py:70"),
    "fused_ln_cross_attention": ("ap_adapter_torch/csrc/fused_hopper.cu",
                                 "ap_adapter_tpu/ops/pallas_fused_cross.py:150"),
    "fused_ln_self_attention_bwd_dx": ("ap_adapter_torch/csrc/train_blocks.cu",
                                       "ap_adapter_tpu/ops/pallas_fused_block.py:740"),
    "fused_ln_cross_attention_bwd": ("ap_adapter_torch/csrc/train_blocks.cu",
                                     "ap_adapter_tpu/ops/pallas_fused_cross.py:517"),
    "fused_ln_geglu_ff_bwd_dx": ("ap_adapter_torch/csrc/train_blocks.cu",
                                 "ap_adapter_tpu/ops/pallas_fused_ff.py:175"),
    "fused_ln_geglu_ff_int8": ("ap_adapter_torch/csrc/int8_blocks.cu",
                               "ap_adapter_tpu/ops/pallas_int8.py:118"),
    "fused_ln_self_attention_int8": ("ap_adapter_torch/csrc/int8_blocks.cu",
                                     "ap_adapter_tpu/ops/pallas_int8.py:259"),
    "fused_ln_cross_attention_int8": ("ap_adapter_torch/csrc/int8_blocks.cu",
                                      "ap_adapter_tpu/ops/pallas_int8.py:410"),
    "self_attention": ("ap_adapter_torch/csrc/self_attention.cu",
                       "ap_adapter_tpu/ops/pallas_self_attention.py:50; "
                       "ap_adapter_tpu/ops/pallas_packed_attention.py:83"),
    "group_norm_silu": ("ap_adapter_torch/csrc/resnet.cu", "ap_adapter_tpu/ops/pallas_groupnorm.py:120"),
    "fused_resnet_block": ("ap_adapter_torch/csrc/resnet.cu", "ap_adapter_tpu/ops/pallas_resnet.py:196"),
    "dual_kv_attention": ("ap_adapter_torch/csrc/fused_hopper.cu", "ap_adapter_tpu/ops/pallas_attention.py:57"),
}
EDIT_KERNELS = ("fused_ln_self_attention", "fused_ln_cross_attention_kv", "fused_ln_geglu_ff")
# redesigned for Hopper (hopper_gemm.cuh, reg_attention.cuh, attn_bwd.cuh, the int8 wgmma GEMM, the TMA
# convs): their cases list device kernels
REDESIGNED = ("fused_ln_self_attention", "fused_ln_cross_attention_kv", "fused_ln_geglu_ff", "dual_kv_attention",
              "fused_ln_self_attention_int8", "fused_ln_geglu_ff_int8", "fused_ln_cross_attention_int8",
              "fused_resnet_block", "fused_ln_self_attention_bwd_dx", "fused_ln_geglu_ff_bwd_dx",
              "fused_ln_cross_attention", "fused_ln_cross_attention_bwd")
TRAIN_KERNELS = ("fused_ln_cross_attention", "fused_ln_self_attention_bwd_dx", "fused_ln_cross_attention_bwd",
                 "fused_ln_geglu_ff_bwd_dx")
INT8_KERNELS = ("fused_ln_self_attention_int8", "fused_ln_cross_attention_int8", "fused_ln_geglu_ff_int8")
RESNET_KERNELS = ("self_attention", "group_norm_silu", "fused_resnet_block")
ATTN_SHAPES = [(1, 4000, 1, 512), (8, 4096, 1, 512), (2, 1000, 8, 32), (2, 1000, 8, 80)]
DUAL_KV_LEVELS = [(1000, 32), (252, 48), (64, 80)]   # (S, d) of the UNet levels, 8 heads
DUAL_KV_AUDIO_KEYS = (32, 128, 512)                   # pooled AudioMAE tokens at pool 4/4, 2/2, 1/1
EDIT_LATENT = (250, 16)   # the UNet latent of a 10 s clip (H x W)
DIST_B = 4                # phase 23: each of two ranks' training rows; one process trains on 2 x DIST_B
DIST_ACCUM = 2            # phase 23: micro-batches an optimizer step
DIST_STEPS = 2            # phase 23: optimizer steps of each training run and MAE steps
DIST_TIMEOUT = 600        # phase 23: seconds the two ranks may take together


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


def device_split(fn, iters: int = 10) -> dict:
    """Device ms per call of ``fn`` by device kernel name (torch.profiler,
    10 calls after 3 warm-up); empty where the tracer recorded no device
    event."""

    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            split[e.name] = split.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / iters / 1e3
    return split


def ops_ms(flops: float, int8_ops: float = 0.0) -> float:
    """The operations' least time: bf16 ones at the bf16 peak, int8 ones at the int8 peak."""

    return (flops / PEAK_FLOPS + int8_ops / PEAK_INT8) * 1e3


def bound(flops: float, nbytes: float, int8_ops: float = 0.0) -> dict:
    """The least time the card could take: the larger of the operations'
    least time (``ops_ms``) and the bytes (each input read once, each output
    written once) over the HBM rate."""

    t_ops, t_bytes = ops_ms(flops, int8_ops), nbytes / PEAK_BYTES * 1e3
    return {"flops": flops, "int8_ops": int8_ops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def work(name: str, b: int, s: int, c: int, sk: int = 0, sk_ip: int = 0, dc: int = 0) -> dict:
    """Operations and bytes of one call of kernel ``name`` on [b, s, c]
    activations (sk/sk_ip text and adapter keys, dc the context width), as
    the function needs them: K7-K9 count the forward recompute that their
    TPU counterparts do too."""

    m, mc = b * s, b * s * c
    attn = 2 * b * s * c            # one [S, d] x [d, Sk] product per key, all heads
    if name == "fused_ln_self_attention":          # QKV, QK^T + PV, out
        return bound(8 * mc * c + 2 * attn * s, 2 * (2 * mc + 4 * c * c + 3 * c))
    if name == "fused_ln_cross_attention_kv":      # Q, two key sets, out
        return bound(4 * mc * c + 2 * attn * (sk + sk_ip),
                     2 * (2 * mc + 2 * c * c + 2 * c + 2 * b * (sk + sk_ip) * c) + 4 * b * sk)
    if name == "fused_ln_geglu_ff":                # W1 [C, 8C], W2 [4C, C]
        return bound(24 * mc * c, 2 * (2 * mc + 12 * c * c + 11 * c))
    proj = 2 * b * (sk + sk_ip) * dc * 2 * c       # the context K/V projections
    ctx_bytes = 2 * (b * (sk + sk_ip) * dc + (4 if sk_ip else 2) * c * dc) + 4 * b * sk
    if name == "fused_ln_cross_attention":
        return bound(proj + 4 * mc * c + 2 * attn * (sk + sk_ip), ctx_bytes + 2 * (2 * mc + 2 * c * c + 3 * c))
    if name == "fused_ln_self_attention_bwd_dx":   # QKV, gattn, 5 attention products, gxn
        return bound(14 * mc * c + 5 * attn * s, 2 * (3 * mc + 4 * c * c + 2 * c))
    if name == "fused_ln_cross_attention_bwd":     # proj, Q, gattn, text 3 and adapter 5 products, gxn
        return bound(proj + 6 * mc * c + attn * (3 * sk + 5 * sk_ip),
                     ctx_bytes + 2 * (3 * mc + 2 * c * c + 2 * c) + 2 * 4 * b * sk_ip * c)
    if name == "fused_ln_geglu_ff_bwd_dx":         # gh, recomputed h, gxn
        return bound(40 * mc * c, 2 * (3 * mc + 12 * c * c + 10 * c))
    # int8: one-byte weights, fp32 scales, bf16 activations, LN and biases
    if name == "fused_ln_geglu_ff_int8":           # W1 [C, 8C], W2 [4C, C] in int8
        return bound(0, 2 * 2 * mc + 12 * c * c + 4 * 9 * c + 2 * 11 * c, int8_ops=24 * mc * c)
    if name == "fused_ln_self_attention_int8":     # int8 q, out; bf16 K/V, QK^T + PV
        return bound(4 * mc * c + 2 * attn * s, 2 * 2 * mc + 2 * c * c + 2 * 2 * c * c + 4 * 2 * c + 2 * 3 * c,
                     int8_ops=4 * mc * c)
    if name == "fused_ln_cross_attention_int8":    # context K/V bf16, int8 q and out, two key sets
        return bound(proj + 2 * attn * (sk + sk_ip),
                     ctx_bytes + 2 * 2 * mc + 2 * c * c + 4 * 2 * c + 2 * 3 * c, int8_ops=4 * mc * c)
    raise KeyError(name)


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
    import torch.nn.functional as F

    from ap_adapter_torch.ops.fused_block import fused_ln_self_attention, fused_ln_self_attention_plain
    from ap_adapter_torch.ops.fused_cross import (
        fused_ln_cross_attention_kv, fused_ln_cross_attention_kv_plain)
    from ap_adapter_torch.ops.fused_ff import fused_ln_geglu_ff, fused_ln_geglu_ff_plain

    gen = torch.Generator(device=device).manual_seed(0)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    info_gen = torch.Generator(device=device).manual_seed(8)
    results = new_results(EDIT_KERNELS)
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
        qh, kh, vh = (torch.randn(2, HEADS, s, c // HEADS, generator=info_gen, device=device, dtype=torch.bfloat16)
                      for _ in range(3))      # K1's attention shape, heads-major, for the sdpa information
        cases = [
            ("fused_ln_self_attention", "self", {},
             lambda: fused_ln_self_attention(x, ln_w, ln_b, wq, wk, wv, wo, bo, HEADS),
             lambda: fused_ln_self_attention_plain(x, ln_w, ln_b, wq, wk, wv, wo, bo, HEADS)),
            ("fused_ln_cross_attention_kv", "adapter", dict(sk=8, sk_ip=128),
             lambda: fused_ln_cross_attention_kv(x, k_txt, v_txt, ln_w, ln_b, wq, wo, bo, HEADS,
                                                 ki=k_ip, vi=v_ip, ip_scale=0.5),
             lambda: fused_ln_cross_attention_kv_plain(x, k_txt, v_txt, ln_w, ln_b, wq, wo, bo, HEADS,
                                                       ki=k_ip, vi=v_ip, ip_scale=0.5)),
            ("fused_ln_cross_attention_kv", "t5+bias", dict(sk=64),
             lambda: fused_ln_cross_attention_kv(x, k_t5, v_t5, ln_w, ln_b, wq, wo, bo, HEADS, bias=t5_bias),
             lambda: fused_ln_cross_attention_kv_plain(x, k_t5, v_t5, ln_w, ln_b, wq, wo, bo, HEADS,
                                                       bias=t5_bias)),
            ("fused_ln_geglu_ff", "geglu", {},
             lambda: fused_ln_geglu_ff(x, ln_w, ln_b, w1, b1, w2, b2),
             lambda: fused_ln_geglu_ff_plain(x, ln_w, ln_b, w1, b1, w2, b2)),
        ]
        for name, variant, keys, kernel, plain in cases:
            info = {"sdpa": lambda: F.scaled_dot_product_attention(qh, kh, vh)} if name == EDIT_KERNELS[0] else None
            run_case(results, name, variant, (2, s, c), keys, kernel, plain, TOL, split=name in REDESIGNED, info=info)
    musicgen_k2_case(results, r, device)
    return results


def musicgen_k2_case(results, r, device) -> None:
    """K2 at MusicGen-large's decode step: 8 clips under CFG (16 rows of one
    position), C 2048, 32 heads of 64, 64 padded T5 keys, no output bias.
    The cond rows' keys past 20 are padding; the null rows (8-15) have every
    key masked and K/V of exactly zero, as the pipeline hoists them, so K2
    must return their input unchanged."""

    import torch

    from ap_adapter_torch.ops.fused_cross import fused_ln_cross_attention_kv, fused_ln_cross_attention_kv_plain

    b, c, sk, heads = MG_ROWS, MG_WIDTH, MG_TEXT, MG_HEADS
    x = r(b, 1, c)
    ln_w, ln_b = 1 + r(c, scale=0.1), r(c, scale=0.1)
    wq, wo = r(c, c, scale=c ** -0.5), r(c, c, scale=c ** -0.5)
    bo = torch.zeros(c, device=device, dtype=torch.bfloat16)
    k, v = r(b, sk, c), r(b, sk, c)
    k[b // 2:], v[b // 2:] = 0, 0
    bias = torch.zeros(b, sk, device=device)
    bias[: b // 2, 20:] = -10000.0
    bias[b // 2:] = -10000.0
    kernel = lambda: fused_ln_cross_attention_kv(x, k, v, ln_w, ln_b, wq, wo, bo, heads, bias=bias)
    got = kernel()
    torch.cuda.synchronize()
    if not torch.equal(got[b // 2:], x[b // 2:]):
        raise RuntimeError("fused_ln_cross_attention_kv/musicgen: the null rows did not return their input")
    run_case(results, "fused_ln_cross_attention_kv", "musicgen", (b, 1, c), dict(sk=sk), kernel,
             lambda: fused_ln_cross_attention_kv_plain(x, k, v, ln_w, ln_b, wq, wo, bo, heads, bias=bias), TOL,
             split=True)


def int8_kernel_phase(device) -> dict:
    """K11a/K11b/K11c against their plain versions at the main-path shapes,
    on int8 weights from quantize_weight."""

    import torch

    from ap_adapter_torch.ops.int8 import (
        fused_ln_cross_attention_int8, fused_ln_cross_attention_int8_plain, fused_ln_geglu_ff_int8,
        fused_ln_geglu_ff_int8_plain, fused_ln_self_attention_int8, fused_ln_self_attention_int8_plain,
        quantize_weight)

    gen = torch.Generator(device=device).manual_seed(5)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    info_gen = torch.Generator(device=device).manual_seed(9)      # apart, so the cases' inputs stay as they were
    results = new_results(INT8_KERNELS)
    for s, c in SHAPES:
        x = r(2, s, c)
        ln_w, ln_b = 1 + r(c, scale=0.1), r(c, scale=0.1)
        wq8, sq = quantize_weight(r(c, c, scale=c ** -0.5))
        wo8, so = quantize_weight(r(c, c, scale=c ** -0.5))
        wk, wv, bo = r(c, c, scale=c ** -0.5), r(c, c, scale=c ** -0.5), r(c, scale=0.1)
        w1q, s1 = quantize_weight(r(8 * c, c, scale=c ** -0.5))
        w2q, s2 = quantize_weight(r(c, 4 * c, scale=(4 * c) ** -0.5))
        b1, b2 = r(8 * c, scale=0.1), r(c, scale=0.1)
        ctx = r(2, 8 + 128, 768)                 # GPT-2 + pooled AudioMAE tokens (pool 2/2)
        wkc, wvc, wki, wvi = (r(c, 768, scale=768 ** -0.5) for _ in range(4))
        t5 = r(2, 64, 1024)
        wk5, wv5 = (r(c, 1024, scale=1024 ** -0.5) for _ in range(2))
        t5_bias = torch.zeros(2, 64, device=device)
        t5_bias[0, 12:] = -10000.0
        t5_bias[1, 30:] = -10000.0
        ff = (x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2)
        m = 2 * s
        ff_mm = int_mm_products(info_gen, [(m, c, w1q), (m, 4 * c, w2q)])   # [M, C] x W1q^T, [M, 4C] x W2q^T
        ca_mm = int_mm_products(info_gen, [(m, c, wq8), (m, c, wo8)])       # the q and out products
        sa = (x, ln_w, ln_b, wq8, sq, wk, wv, wo8, so, bo, HEADS)
        ca = (x, ctx, ln_w, ln_b, wq8, sq, wkc, wvc, wo8, so, bo, HEADS)
        ad = dict(wk_ip=wki, wv_ip=wvi, ip_scale=0.5)
        ct = (x, t5, ln_w, ln_b, wq8, sq, wk5, wv5, wo8, so, bo, HEADS)
        cases = [
            ("fused_ln_self_attention_int8", "self", {},
             lambda: fused_ln_self_attention_int8(*sa), lambda: fused_ln_self_attention_int8_plain(*sa)),
            ("fused_ln_cross_attention_int8", "adapter", dict(sk=8, sk_ip=128, dc=768),
             lambda: fused_ln_cross_attention_int8(*ca, **ad),
             lambda: fused_ln_cross_attention_int8_plain(*ca, **ad)),
            ("fused_ln_cross_attention_int8", "t5+bias", dict(sk=64, dc=1024),
             lambda: fused_ln_cross_attention_int8(*ct, bias=t5_bias),
             lambda: fused_ln_cross_attention_int8_plain(*ct, bias=t5_bias)),
            ("fused_ln_geglu_ff_int8", "geglu", {},
             lambda: fused_ln_geglu_ff_int8(*ff), lambda: fused_ln_geglu_ff_int8_plain(*ff)),
        ]
        info = {"fused_ln_geglu_ff_int8": {"int_mm": ff_mm}, "fused_ln_cross_attention_int8": {"int_mm": ca_mm}}
        for name, variant, keys, kernel, plain in cases:
            run_case(results, name, variant, (2, s, c), keys, kernel, plain, TOL, split=name in REDESIGNED,
                     info=info.get(name))
    return results


def int_mm_products(gen, shapes):
    """A K11 case's int8 products as ``torch._int_mm`` calls (cuBLASLt, int32
    sums) on random int8 rows [m, k] against its int8 weights [n, k]: timed
    beside the kernel as information, never called by the port."""

    import torch

    pairs = [(torch.randint(-127, 128, (m, k), generator=gen, device=w8.device, dtype=torch.int8), w8.t())
             for m, k, w8 in shapes]
    return lambda: tuple(torch._int_mm(a, wt) for a, wt in pairs)


def resnet_shapes(unet_config, h: int, w: int) -> list:
    """(H, W, C_in, C_out) of every UNet resnet in forward order, for an
    [h, w] latent: the channel bookkeeping of ``AudioLDM2UNet.__init__``
    (skip connections included), each level half the size of the one above,
    rounded up."""

    ch = unet_config.block_out_channels
    sizes = [(h, w)]
    for _ in ch[1:]:
        sizes.append((-(-sizes[-1][0] // 2), -(-sizes[-1][1] // 2)))
    out, skip, x_ch = [], [ch[0]], ch[0]
    for level, out_ch in enumerate(ch):
        for _ in range(unet_config.layers_per_block):
            out.append((*sizes[level], x_ch, out_ch))
            x_ch = out_ch
            skip.append(x_ch)
        if level < len(ch) - 1:
            skip.append(x_ch)
    out += [(*sizes[-1], ch[-1], ch[-1])] * 2
    for bi, out_ch in enumerate(reversed(ch)):
        for _ in range(unet_config.layers_per_block + 1):
            out.append((*sizes[len(ch) - 1 - bi], x_ch + skip.pop(), out_ch))
            x_ch = out_ch
    return out


def resnet_kernel_phase(device, unet_config) -> dict:
    """The self-attention kernel (K5/K6) at its four shapes, K12 at every
    resnet GroupNorm shape of the edit (SiLU on and off) and K13 at every
    distinct resnet shape of the edit (with and without temb), against the
    plain versions, with the library call where there is one."""

    import torch
    import torch.nn.functional as F

    from ap_adapter_torch.ops.groupnorm import group_norm_silu, group_norm_silu_plain
    from ap_adapter_torch.ops.resnet import fused_resnet_block, fused_resnet_block_plain
    from ap_adapter_torch.ops.self_attention import attention_plan, self_attention_kernel, self_attention_plain

    gen = torch.Generator(device=device).manual_seed(6)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    results = new_results(RESNET_KERNELS)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for b, s, h, d in ATTN_SHAPES:
        q, k, v = r(b, s, h, d), r(b, s, h, d), r(b, s, h, d)
        bd = bound(4 * b * h * s * s * d, 4 * 2 * b * s * h * d)
        route, cluster = attention_plan(b, s, h, d, sms)
        run_case(results, "self_attention", "self", (b, s, h, d), {"route": route, "cluster": cluster},
                 lambda: self_attention_kernel(q, k, v),
                 lambda: self_attention_plain(q, k, v), TOL, bd=bd,
                 library=lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                                v.transpose(1, 2)))
    shapes = resnet_shapes(unet_config, *EDIT_LATENT)
    groups, eps, b = unet_config.norm_num_groups, unet_config.norm_eps, 2
    gn_shapes = sorted({(hh, ww, c) for hh, ww, cin, cout in shapes for c in (cin, cout)})
    for hh, ww, c in gn_shapes:
        x = (r(b, hh, ww, c) + 1.0).permute(0, 3, 1, 2)      # channels-last, as the UNet keeps it
        gamma, beta = 1 + r(c, scale=0.1), r(c, scale=0.1)
        bd = bound(0, 2 * 2 * b * hh * ww * c + 2 * 2 * c)
        for act in (False, True):
            run_case(results, "group_norm_silu", "silu" if act else "gn", (b, hh, ww, c), {},
                     lambda: group_norm_silu(x, gamma, beta, groups, eps, act),
                     lambda: group_norm_silu_plain(x, gamma, beta, groups, eps, act), TOL, bd=bd,
                     library=None if act else lambda: F.group_norm(x, groups, gamma, beta, eps))
    # K12's combine has a fixed order and no atomics: two calls, the same bits
    hh, ww, c = max(gn_shapes, key=lambda t: t[0] * t[1] * t[2])
    x = (r(b, hh, ww, c) + 1.0).permute(0, 3, 1, 2)
    gamma, beta = 1 + r(c, scale=0.1), r(c, scale=0.1)
    first, second = (group_norm_silu(x, gamma, beta, groups, eps, True) for _ in range(2))
    torch.cuda.synchronize()
    if not torch.equal(first, second):
        raise RuntimeError(f"group_norm_silu {(b, hh, ww, c)}: two calls differ")
    log(f"kernel group_norm_silu deterministic at B={b} H={hh} W={ww} C={c}: two calls bit-equal")
    for hh, ww, cin, cout in sorted(set(shapes)):
        sc = cin != cout
        x = r(b, hh, ww, cin)
        wts = (1 + r(cin, scale=0.1), r(cin, scale=0.1), r(3, 3, cin, cout, scale=(9 * cin) ** -0.5),
               r(cout, scale=0.1), 1 + r(cout, scale=0.1), r(cout, scale=0.1),
               r(3, 3, cout, cout, scale=(9 * cout) ** -0.5), r(cout, scale=0.1),
               r(1, 1, cin, cout, scale=cin ** -0.5) if sc else None, r(cout, scale=0.1) if sc else None)
        m = b * hh * ww
        flops = 2 * m * cout * (9 * cin + 9 * cout + (cin if sc else 0))
        wbytes = 2 * (9 * cin * cout + 9 * cout * cout + (cin * cout if sc else 0) + 2 * cin + 4 * cout)
        convs = cudnn_convs(x, wts, groups, eps)
        for temb in (r(b, cout), None):
            bd = bound(flops, 2 * m * (cin + cout) + wbytes + (2 * b * cout if temb is not None else 0))
            run_case(results, "fused_resnet_block", "temb" if temb is not None else "no temb", (b, hh, ww, cin),
                     {"C_out": cout}, lambda: fused_resnet_block(x, temb, *wts, groups, eps),
                     lambda: fused_resnet_block_plain(x, temb, *wts, groups, eps), TOL, bd=bd,
                     split="fused_resnet_block" in REDESIGNED, info={"conv2d": convs})
    return results


def cudnn_convs(x, wts, groups: int, eps: float):
    """K13's two convs (with the 1x1 shortcut, where there is one) as
    ``F.conv2d`` calls on channels-last bf16 inputs and weights (cuDNN), on
    the activated inputs of the plain version: a call timed beside K13 as
    information, never used by the port."""

    import torch
    import torch.nn.functional as F

    from ap_adapter_torch.ops.groupnorm import group_norm_silu_plain

    cl = torch.channels_last
    gn1_w, gn1_b, w1, b1, gn2_w, gn2_b, w2, b2, wsc, bsc = wts
    xc = x.permute(0, 3, 1, 2)
    a1 = group_norm_silu_plain(xc, gn1_w, gn1_b, groups, eps, act=True).contiguous(memory_format=cl)
    k1, k2 = (w.permute(3, 2, 0, 1).contiguous(memory_format=cl) for w in (w1, w2))
    a2 = group_norm_silu_plain(F.conv2d(a1, k1, b1, padding=1), gn2_w, gn2_b, groups, eps,
                               act=True).contiguous(memory_format=cl)
    ksc = wsc.permute(3, 2, 0, 1).contiguous(memory_format=cl) if wsc is not None else None

    def run():
        h = F.conv2d(a1, k1, b1, padding=1)
        out = F.conv2d(a2, k2, b2, padding=1)
        return (h, out, F.conv2d(xc, ksc, bsc)) if ksc is not None else (h, out)

    return run


def dual_kv_kernel_phase(device) -> dict:
    """K10 against its plain version at B=2, the three UNet levels, 8 text
    keys and each adapter key count, ip_scale 0.55; as information, two
    ``F.scaled_dot_product_attention`` calls plus the add on the same inputs
    (no single PyTorch call computes K10, so ``library_ms`` stays null)."""

    import torch
    import torch.nn.functional as F

    from ap_adapter_torch.ops.dual_kv_attention import _plain, fused_dual_kv_attention

    gen = torch.Generator(device=device).manual_seed(7)

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(torch.bfloat16)

    results = new_results(("dual_kv_attention",))
    results["dual_kv_attention"]["two_sdpa_ms"] = 0.0
    b, st, s2 = 2, 8, 0.55
    for s, d in DUAL_KV_LEVELS:
        for si in DUAL_KV_AUDIO_KEYS:
            q, kt, vt, ki, vi = r(b, s, HEADS, d), r(b, st, HEADS, d), r(b, st, HEADS, d), r(b, si, HEADS, d), \
                r(b, si, HEADS, d)
            c = HEADS * d
            bd = bound(4 * b * s * c * (st + si), 2 * (2 * b * s * c + 2 * b * (st + si) * c))
            qt, ktt, vtt, kit, vit = (t.transpose(1, 2) for t in (q, kt, vt, ki, vi))
            two_sdpa = lambda: (F.scaled_dot_product_attention(qt, ktt, vtt)
                                + s2 * F.scaled_dot_product_attention(qt, kit, vit))
            run_case(results, "dual_kv_attention", "dual", (b, s, HEADS, d), {"St": st, "Si": si},
                     lambda: fused_dual_kv_attention(q, kt, vt, ki, vi, s2), lambda: _plain(q, kt, vt, ki, vi, s2),
                     TOL, bd=bd, split="dual_kv_attention" in REDESIGNED, info={"two_sdpa": two_sdpa})
            two = results["dual_kv_attention"]["cases"][-1].get("info_ms", {}).get("two_sdpa")
            if two is not None:     # profile_kernels.py's run_case records device times instead
                results["dual_kv_attention"]["cases"][-1]["two_sdpa_ms"] = two
                results["dual_kv_attention"]["two_sdpa_ms"] += two
    return results


def new_results(names) -> dict:
    return {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": None,
                   "library_cases_ms": 0.0, "cases": []} for name in names}


def run_case(results, name, variant, shape, keys, kernel, plain, tol, bd=None, library=None, split=False,
             info=None) -> None:
    """Compare ``kernel()`` with ``plain()`` (a tensor or a tuple of them,
    each within ``tol`` of its own max|plain|), time both (and ``library``,
    one PyTorch call computing the same function, where there is one), add
    the bound (``bd``, else ``work(name, *shape, **keys)``). ``split``: also
    list the kernel's device kernels with their device ms a call; ``info``:
    name -> a call timed beside the kernel as information only."""

    import torch

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = []
    for a, w in zip(got, want):
        if a.shape != w.shape or not torch.isfinite(a).all():
            raise RuntimeError(f"{name}/{variant} {shape}: bad output {tuple(a.shape)}")
        err = (a.float() - w.float()).abs().max().item()
        errs.append((err, err / w.float().abs().max().item()))
    err, rel = max(e for e, _ in errs), max(r for _, r in errs)
    ms, plain_ms = time_ms(kernel), time_ms(plain)
    library_ms = time_ms(library) if library is not None else None
    bd = bd or work(name, *shape, **keys)
    dims = " ".join(f"{k}={v}" for k, v in zip("BSC", shape)) if len(shape) == 3 else f"shape={tuple(shape)}"
    dims += "".join(f" {k}={v}" for k, v in keys.items())
    log(f"kernel {name:30s} {variant:8s} {dims}: max_abs_err={err:.4g} rel={rel:.4g} (limit {tol}) ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bd['bound_ms']:.4f} ({bd['bound_by']})"
        + (f" library_ms={library_ms:.4f}" if library_ms is not None else ""))
    if not rel <= tol:
        raise RuntimeError(f"{name}/{variant} {shape}: error {errs} over {tol} of max|plain|")
    extra = {}
    if split:
        extra["device_split_ms"] = device_split(kernel)
        log("  device kernels: " + (", ".join(f"{n} {t:.4f} ms" for n, t in extra["device_split_ms"].items())
                                    or "none recorded by the profiler"))
    if info:
        extra["info_ms"] = {k: time_ms(fn) for k, fn in info.items()}
        log("  information, not a library call: " + ", ".join(f"{k} {t:.4f} ms" for k, t in extra["info_ms"].items()))
    res = results[name]
    res["max_abs_err"] = max(res["max_abs_err"], err)
    res["ms"] += ms
    res["plain_ms"] += plain_ms
    res["bound_ms"] += bd["bound_ms"]
    if library_ms is not None:
        res["library_ms"] = (res["library_ms"] or 0.0) + library_ms
        res["library_cases_ms"] += ms
    res["cases"].append({"variant": variant, "shape": list(shape), **keys, "max_abs_err": err, "rel_err": rel,
                         "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **bd, **extra})


def train_kernel_phase(device) -> dict:
    """K4 forward and K7/K8/K9 (dx; K8 also dk_ip/dv_ip and the adapter
    weight gradients) at the training levels, B=8, against the plain
    versions and autograd over them."""

    import torch

    from ap_adapter_torch.ops.fused_block import (
        fused_ln_self_attention_bwd_dx, fused_ln_self_attention_bwd_dx_plain)
    from ap_adapter_torch.ops.fused_cross import (
        adapter_weight_grads, fused_ln_cross_attention, fused_ln_cross_attention_bwd, fused_ln_cross_attention_bwd_plain,
        fused_ln_cross_attention_plain)
    from ap_adapter_torch.ops.fused_ff import fused_ln_geglu_ff_bwd_dx, fused_ln_geglu_ff_bwd_dx_plain

    gen = torch.Generator(device=device).manual_seed(3)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    b, sk_ip = TRAIN_B, 512            # pool 1: the most adapter keys
    results = new_results(TRAIN_KERNELS)
    for s, c in TRAIN_SHAPES:
        x, gy = r(b, s, c), r(b, s, c)
        ln_w, ln_b = 1 + r(c, scale=0.1), r(c, scale=0.1)
        wq, wk, wv, wo = (r(c, c, scale=c ** -0.5) for _ in range(4))
        bo = r(c, scale=0.1)
        w1, b1 = r(8 * c, c, scale=c ** -0.5), r(8 * c, scale=0.1)
        w2 = r(c, 4 * c, scale=(4 * c) ** -0.5)
        ctx = r(b, 8 + sk_ip, 768)
        wkc, wvc, wki, wvi = (r(c, 768, scale=768 ** -0.5) for _ in range(4))
        t5 = r(b, 64, 1024)
        wk5, wv5 = (r(c, 1024, scale=1024 ** -0.5) for _ in range(2))
        bias = torch.zeros(b, 64, device=device)
        bias[::2, 20:] = -10000.0
        ad = dict(wk_ip=wki, wv_ip=wvi, ip_scale=1.0)
        ip = ctx[:, 8:]

        def with_dw(fn):
            def run():
                dx, dki, dvi = fn()
                return dx, dki, dvi, *adapter_weight_grads(dki, dvi, ip)
            return run

        cases = [
            ("fused_ln_cross_attention", "adapter", dict(sk=8, sk_ip=sk_ip, dc=768), TOL,
             lambda: fused_ln_cross_attention(x, ctx, ln_w, ln_b, wq, wkc, wvc, wo, bo, HEADS, **ad),
             lambda: fused_ln_cross_attention_plain(x, ctx, ln_w, ln_b, wq, wkc, wvc, wo, bo, HEADS, **ad)),
            ("fused_ln_cross_attention", "t5+bias", dict(sk=64, dc=1024), TOL,
             lambda: fused_ln_cross_attention(x, t5, ln_w, ln_b, wq, wk5, wv5, wo, bo, HEADS, bias=bias),
             lambda: fused_ln_cross_attention_plain(x, t5, ln_w, ln_b, wq, wk5, wv5, wo, bo, HEADS, bias=bias)),
            ("fused_ln_self_attention_bwd_dx", "dx", {}, GRAD_TOL,
             lambda: fused_ln_self_attention_bwd_dx(x, gy, ln_w, ln_b, wq, wk, wv, wo, HEADS),
             lambda: fused_ln_self_attention_bwd_dx_plain(x, gy, ln_w, ln_b, wq, wk, wv, wo, HEADS)),
            ("fused_ln_cross_attention_bwd", "adapter", dict(sk=8, sk_ip=sk_ip, dc=768), GRAD_TOL,
             with_dw(lambda: fused_ln_cross_attention_bwd(x, gy, ctx, ln_w, ln_b, wq, wkc, wvc, wo, HEADS, **ad)),
             with_dw(lambda: fused_ln_cross_attention_bwd_plain(x, gy, ctx, ln_w, ln_b, wq, wkc, wvc, wo,
                                                                HEADS, **ad))),
            ("fused_ln_cross_attention_bwd", "t5+bias", dict(sk=64, dc=1024), GRAD_TOL,
             lambda: fused_ln_cross_attention_bwd(x, gy, t5, ln_w, ln_b, wq, wk5, wv5, wo, HEADS, bias=bias)[0],
             lambda: fused_ln_cross_attention_bwd_plain(x, gy, t5, ln_w, ln_b, wq, wk5, wv5, wo, HEADS,
                                                        bias=bias)[0]),
            ("fused_ln_geglu_ff_bwd_dx", "dx", {}, GRAD_TOL,
             lambda: fused_ln_geglu_ff_bwd_dx(x, gy, ln_w, ln_b, w1, b1, w2),
             lambda: fused_ln_geglu_ff_bwd_dx_plain(x, gy, ln_w, ln_b, w1, b1, w2)),
        ]
        for name, variant, keys, tol, kernel, plain in cases:
            run_case(results, name, variant, (b, s, c), keys, kernel, plain, tol, split=name in REDESIGNED)

    # K4 at the edit shapes with no adapter set: the ControlNet-branch request's cross sites (the GPT-2 stream
    # stripped to its 8 text tokens at 768 wide; the T5 stream, 64 keys at 1024 wide, with its padding bias)
    for s, c in SHAPES:
        x = r(2, s, c)
        ln_w, ln_b = 1 + r(c, scale=0.1), r(c, scale=0.1)
        wq, wo = (r(c, c, scale=c ** -0.5) for _ in range(2))
        bo = r(c, scale=0.1)
        for variant, sk, dc in (("edit-text", 8, 768), ("edit-t5", 64, 1024)):
            ctx = r(2, sk, dc)
            wkc, wvc = (r(c, dc, scale=dc ** -0.5) for _ in range(2))
            kw = {}
            if variant == "edit-t5":
                kw["bias"] = torch.zeros(2, sk, device=device)
                kw["bias"][1, 12:] = -10000.0
            run_case(results, "fused_ln_cross_attention", variant, (2, s, c), dict(sk=sk, dc=dc),
                     lambda: fused_ln_cross_attention(x, ctx, ln_w, ln_b, wq, wkc, wvc, wo, bo, HEADS, **kw),
                     lambda: fused_ln_cross_attention_plain(x, ctx, ln_w, ln_b, wq, wkc, wvc, wo, bo, HEADS, **kw),
                     TOL, split=True)
    return results


def expected_launches(unet_config, hoisted: bool = True) -> dict:
    """Kernel calls per UNet forward: every transformer block runs K1 at attn1,
    K1 or K2 at attn2 (double-self or cross; K4 where the K/V are not
    ``hoisted``) and K3 at its feed-forward; under use_pallas_attention the
    adapter sites (the audio-token stream) run K10 in place of K2; under
    force_xla_core no transformer site runs a kernel."""

    c = unet_config
    if c.force_xla_core:          # every transformer site outside the kernels (tensor-parallel serving)
        return {}
    groups = (sum(c.down_block_has_attn) * c.layers_per_block + 1
              + sum(c.up_block_has_attn) * (c.layers_per_block + 1))
    blocks = c.transformer_layers_per_block
    n_cross = sum(d is not None for d in c.cross_attention_dims)
    n_self = len(c.cross_attention_dims) - n_cross
    n_k10 = sum(d == c.adapter_cross_attention_dim for d in c.cross_attention_dims) if c.use_pallas_attention else 0
    cross = "fused_ln_cross_attention_kv" if hoisted else "fused_ln_cross_attention"
    out = {"fused_ln_self_attention": groups * blocks * (len(c.cross_attention_dims) + n_self),
           cross: groups * blocks * (n_cross - n_k10),
           "fused_ln_geglu_ff": groups * blocks * len(c.cross_attention_dims)}
    if n_k10:
        out["dual_kv_attention"] = groups * blocks * n_k10
    return out


def expected_int8_launches(unet_config) -> dict:
    """Kernel calls per UNet forward under use_int8: K11b where K1 runs, K11c
    where K2 runs, K11a where K3 runs."""

    per = expected_launches(unet_config)
    return {"fused_ln_self_attention_int8": per["fused_ln_self_attention"],
            "fused_ln_cross_attention_int8": per["fused_ln_cross_attention_kv"],
            "fused_ln_geglu_ff_int8": per["fused_ln_geglu_ff"]}


def expected_train_launches(unet_config) -> dict:
    """Kernel calls per training micro-step (one UNet forward and backward,
    no hoisting): the forward routes cross sites to K4 instead of K2; the
    backward reaches every sub-layer from the first adapter site on (the
    frozen layers before it get no gradient), and runs K7, K8 or K9 there.
    Under ``remat`` the backward first runs the forward again of every
    checkpointed segment whose output needs a gradient: whole attention
    groups, from the one holding the first adapter site on (the resnets run
    no kernel)."""

    c = unet_config
    groups = (sum(c.down_block_has_attn) * c.layers_per_block + 1
              + sum(c.up_block_has_attn) * (c.layers_per_block + 1))
    group = []
    for dim in c.cross_attention_dims:
        kind = "self" if dim is None else "adapter" if dim == c.adapter_cross_attention_dim else "cross"
        group += ["self", kind, "ff"] * c.transformer_layers_per_block
    order = group * groups
    reached = order[order.index("adapter"):]
    fwd = {"fused_ln_self_attention": order.count("self"),
           "fused_ln_cross_attention": len(order) - order.count("self") - order.count("ff"),
           "fused_ln_geglu_ff": order.count("ff")}
    bwd = {"fused_ln_self_attention_bwd_dx": reached.count("self"),
           "fused_ln_cross_attention_bwd": len(reached) - reached.count("self") - reached.count("ff"),
           "fused_ln_geglu_ff_bwd_dx": reached.count("ff")}
    if c.remat:
        again = order[order.index("adapter") // len(group) * len(group):]
        fwd = {"fused_ln_self_attention": fwd["fused_ln_self_attention"] + again.count("self"),
               "fused_ln_cross_attention": fwd["fused_ln_cross_attention"] + len(again) - again.count("self")
               - again.count("ff"),
               "fused_ln_geglu_ff": fwd["fused_ln_geglu_ff"] + again.count("ff")}
    return {**fwd, **bwd}


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


def expected_request_launches(unet_config, steps: int, hoisted: bool = True) -> dict:
    """Kernel calls per edit request of ``steps`` UNet forwards for the
    configuration: the transformer sites (bf16 or int8; K4 at the cross
    sites where the K/V are not ``hoisted``), the resnet kernels where their
    switch is on (K13 over K12), and one self-attention launch (the VAE
    decode's mid block, at 4000 positions)."""

    per_forward = dict(expected_int8_launches(unet_config) if unet_config.use_int8 else
                       expected_launches(unet_config, hoisted))
    n_resnets = len(resnet_shapes(unet_config, *EDIT_LATENT))
    if unet_config.use_pallas_resnet:
        per_forward["fused_resnet_block"] = n_resnets
    elif unet_config.use_pallas_groupnorm:
        per_forward["group_norm_silu"] = 2 * n_resnets
    return {**{k: v * steps for k, v in per_forward.items()}, "self_attention": 1}


def serve(name: str, generate, requests: int, want: dict, samples: int) -> list:
    """Run ``generate(i)`` (one request, a waveform [1, samples] as numpy)
    for i < ``requests`` with the launch counts set to 0 first: each
    request's seconds and peak memory, the waveform checks, and launch
    counts exactly ``want``; each run keeps its waveform."""

    import numpy as np
    import torch

    from ap_adapter_torch.ops import cuda_kernels

    cuda_kernels.reset_launch_counts()
    runs, before = [], dict(cuda_kernels.LAUNCHES)
    for i in range(requests):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav = generate(i)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        now = dict(cuda_kernels.LAUNCHES)
        moved = {k: now[k] - before[k] for k in now}
        before = now
        mem = torch.cuda.max_memory_allocated()
        log(f"request {i} ({name}): {seconds:.3f} s, max_memory_allocated={mem / 2**30:.3f} GiB, "
            f"wav {wav.shape} std={wav.std():.4g} max|wav|={np.abs(wav).max():.4g}, launches {moved}")
        check_waveform(f"request {i} ({name})", wav, samples)
        if moved != want:
            raise RuntimeError(f"request {i} ({name}): launch counts {moved} != expected {want}")
        runs.append({"seconds": seconds, "max_memory_allocated": mem, "launches": moved, "wav": wav})
    return runs


def slice_phase(pipe, device, requests: int = 2, seeds=None, audio_seeds=None) -> list:
    """Serve ``requests`` edit requests (latent seeds ``seeds``, default 0, 1,
    ...; the audio prompt's fbank drawn from ``audio_seeds``, default 0 for
    all) with exact launch counts for the pipeline's configuration."""

    import numpy as np

    from ap_adapter_torch.configs import get_task_config
    from ap_adapter_torch.ops import cuda_kernels
    from ap_adapter_torch.pipeline.tokenize import make_text_batch

    c = pipe.config
    task = get_task_config("timbre_transfer")
    pos = make_text_batch(c, [task.positive_text_prompts[0]])
    neg = make_text_batch(c, [task.negative_text_prompts[0]])
    seeds = range(requests) if seeds is None else seeds
    audio_seeds = [0] * requests if audio_seeds is None else audio_seeds
    per_request = expected_request_launches(c.unet, task.num_inference_steps, c.hoist_step_invariants)

    def generate(i):
        fbank = np.random.default_rng(audio_seeds[i]).standard_normal((1, *c.audiomae.img_size)).astype(np.float32)
        return pipe.generate(pos, neg, fbank, audio_length_in_s=task.audio_length_in_s,
                             num_inference_steps=task.num_inference_steps, guidance_scale=task.guidance_scale,
                             ap_scale=task.ap_scale, time_pool=task.time_pooling, freq_pool=task.freq_pooling,
                             seed=seeds[i])

    return serve(config_name(c.unet), generate, requests, {k: per_request.get(k, 0) for k in cuda_kernels.LAUNCHES},
                 int(task.audio_length_in_s * c.vocoder.sampling_rate))


def config_name(unet_config) -> str:
    return ("xla" if unet_config.force_xla_core else "int8" if unet_config.use_int8
            else "K13" if unet_config.use_pallas_resnet
            else "K12" if unet_config.use_pallas_groupnorm else "K10" if unet_config.use_pallas_attention
            else "cn" if unet_config.cn_text_only else "bf16")


def int8_slice_phase(modules, bf16_runs, device) -> tuple:
    """The bf16 slice's weights (shared, not copied) under use_int8: serve
    the same requests, then hold int8 request 0 against bf16 request 0 in
    log-mel space, as scripts/compare_int8.py does for the JAX package."""

    import dataclasses

    import torch

    from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline, PipelineModules

    base = modules.config
    config = base.replace(unet=dataclasses.replace(base.unet, use_int8=True))
    mods = PipelineModules(config)
    mods.load_state_dict(modules.state_dict(), strict=True, assign=True)
    t0 = time.perf_counter()
    pipe = AudioLDM2Pipeline(config, mods)          # quantizes the UNet once
    torch.cuda.synchronize()
    log(f"int8 weights quantized in {time.perf_counter() - t0:.2f} s")
    runs = slice_phase(pipe, device, requests=len(bf16_runs))
    for i, (r8, r16) in enumerate(zip(runs, bf16_runs)):
        log(f"request {i}: int8 {r8['seconds']:.3f} s, {r8['max_memory_allocated'] / 2**30:.3f} GiB; "
            f"bf16 {r16['seconds']:.3f} s, {r16['max_memory_allocated'] / 2**30:.3f} GiB")
    quality = check_quality("int8 request 0 vs bf16 request 0", runs[0]["wav"], bf16_runs[0]["wav"],
                            config.mel)
    del pipe, mods
    torch.cuda.empty_cache()
    return runs, quality


def quality_figures(got, want, mel_config) -> dict:
    """Log-mel (``audio/mel.py``) cosine and mean abs difference of two
    waveforms, and the waveform's relative error."""

    import numpy as np
    import torch

    from ap_adapter_torch.audio.mel import tacotron_mel

    a, b = (tacotron_mel(torch.from_numpy(w), mel_config).double().flatten() for w in (got, want))
    return {"logmel_cosine": (a @ b / (a.norm() * b.norm())).item(),
            "logmel_mean_abs_diff": (a - b).abs().mean().item(),
            "wav_rel_err": float(np.linalg.norm(got - want) / np.linalg.norm(want))}


def check_quality(name, got, want, mel_config) -> dict:
    """The waveform ``got`` against ``want`` (a request against the bf16
    request 0, or a rank's clip against one process's) in log-mel:
    cosine > LOGMEL_COS and mean abs difference < LOGMEL_MAD, with the
    waveform's relative error (``quality_figures``)."""

    import numpy as np

    q = quality_figures(got, want, mel_config)
    log(f"{name} quality: log-mel cosine {q['logmel_cosine']:.6f} (limit > "
        f"{LOGMEL_COS}), mean abs diff {q['logmel_mean_abs_diff']:.6g} (limit < {LOGMEL_MAD}); waveform "
        f"relative error {q['wav_rel_err']:.6g} (max|wav| {np.abs(want).max():.4g}: random weights give a "
        f"near-silent clip)")
    if not (q["logmel_cosine"] > LOGMEL_COS and q["logmel_mean_abs_diff"] < LOGMEL_MAD):
        raise RuntimeError(f"{name} quality check failed")
    return q


def switch_slice_phase(modules, bf16_runs, device) -> dict:
    """The bf16 slice's weights (shared, not copied) under
    ``use_pallas_groupnorm``, then under ``use_pallas_resnet``: one request
    each, exact launch counts, log-mel against the bf16 request 0."""

    import dataclasses

    import torch

    from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline, PipelineModules

    base = modules.config
    out = {}
    for switch in ("use_pallas_groupnorm", "use_pallas_resnet"):
        config = base.replace(unet=dataclasses.replace(base.unet, **{switch: True}))
        mods = PipelineModules(config)
        mods.load_state_dict(modules.state_dict(), strict=True, assign=True)
        pipe = AudioLDM2Pipeline(config, mods)          # prepares K13's HWIO weights once
        run = slice_phase(pipe, device, requests=1)[0]
        name = config_name(config.unet)
        log(f"request 0: {name} {run['seconds']:.3f} s, {run['max_memory_allocated'] / 2**30:.3f} GiB; bf16 "
            f"{bf16_runs[0]['seconds']:.3f} s, {bf16_runs[0]['max_memory_allocated'] / 2**30:.3f} GiB")
        out[switch] = {**run, **check_quality(f"{name} request vs bf16 request 0", run["wav"], bf16_runs[0]["wav"],
                                              config.mel)}
        del pipe, mods
        torch.cuda.empty_cache()
    return out


def k10_slice_phase(modules, bf16_runs, device):
    """The bf16 slice's weights (shared, not copied) under
    ``use_pallas_attention``: one request with exact launch counts (K10 at
    the adapter sites, K2 at the T5 sites only) and log-mel against the bf16
    request 0. Returns the pipeline, for the re-ranking phase."""

    import dataclasses

    from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline, PipelineModules

    base = modules.config
    config = base.replace(unet=dataclasses.replace(base.unet, use_pallas_attention=True))
    mods = PipelineModules(config)
    mods.load_state_dict(modules.state_dict(), strict=True, assign=True)
    pipe = AudioLDM2Pipeline(config, mods)
    run = slice_phase(pipe, device, requests=1)[0]
    log(f"request 0: K10 {run['seconds']:.3f} s, {run['max_memory_allocated'] / 2**30:.3f} GiB; bf16 "
        f"{bf16_runs[0]['seconds']:.3f} s, {bf16_runs[0]['max_memory_allocated'] / 2**30:.3f} GiB")
    return pipe, {**run, **check_quality("K10 request vs bf16 request 0", run["wav"], bf16_runs[0]["wav"],
                                          config.mel)}


def check_waveform(name, wav, samples) -> None:
    import numpy as np

    if wav.shape != (1, samples) or not np.all(np.isfinite(wav)) or not wav.std() > 0:
        raise RuntimeError(f"{name}: bad waveform {wav.shape}")
    if np.abs(wav).max() > 1.0:
        raise RuntimeError(f"{name}: waveform outside the tanh range")


def v1_reference(unet, device) -> float:
    """One step of the full-width v1 UNet on a short latent: bf16 kernels on
    the card against the plain path in fp32 on the CPU, with the same
    weights, as ``reference_phase`` holds the AudioLDM2 UNet."""

    import copy

    import torch

    g = torch.Generator().manual_seed(2)
    lat = torch.randn(2, 16, 16, unet.config.in_channels, generator=g)
    labels = torch.nn.functional.normalize(torch.randn(2, unet.config.class_embed_dim, generator=g), dim=-1)
    ts = torch.full((2,), 501.0)

    def run(u, dev):
        with torch.no_grad():
            return u(lat.to(dev), ts.to(dev), class_labels=labels.to(dev)).float().cpu()

    got = run(unet, device)
    ref = copy.deepcopy(unet).to("cpu", torch.float32)
    want = run(ref, "cpu")
    del ref
    err, peak = (got - want).abs().max().item(), want.abs().max().item()
    log(f"v1 reference: full-width v1 UNet, bf16 kernels on {device} vs fp32 plain on cpu: "
        f"max_abs_err={err:.4g} rel={err / peak:.4g} (limit {UNET_TOL})")
    if not (torch.isfinite(got).all() and err <= UNET_TOL * peak):
        raise RuntimeError(f"v1 UNet reference check failed: {err} > {UNET_TOL} * {peak}")
    return err / peak


def v1_slice_phase(device, requests: int = 2) -> dict:
    """The AudioLDM v1 pipeline (``pipeline/audioldm_v1.py``) at
    ``PipelineConfig()``'s widths in bf16 with random weights (seed 0): its
    UNet step against fp32 on the CPU, one warm-up request, then
    ``requests`` 10 s requests at 50 CFG DDIM steps, batch 1, guidance 2.5,
    with exact launch counts derived from the v1 UNet's config (K1 at both
    self-attention sites of every block, K3 at every feed-forward, one
    self-attention launch in the VAE decode)."""

    import torch

    from ap_adapter_torch.configs import PipelineConfig
    from ap_adapter_torch.ops import cuda_kernels
    from ap_adapter_torch.pipeline.audioldm_v1 import AudioLDMv1Pipeline
    from ap_adapter_torch.pipeline.tokenize import make_text_batch

    config = PipelineConfig()
    held = torch.cuda.memory_allocated()        # the other phases' pipelines, still alive
    t0 = time.perf_counter()
    pipe = AudioLDMv1Pipeline.init_random(config, seed=0, device=device, dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in pipe.modules.parameters())
    log(f"v1 random weights: {n_params / 1e6:.1f}M params in {time.perf_counter() - t0:.1f} s")
    rel = v1_reference(pipe.modules.unet, device)

    steps, seconds = 50, 10.0
    samples = int(seconds * config.vocoder.sampling_rate)
    per_request = expected_request_launches(pipe.unet_config, steps, hoisted=False)
    want = {k: per_request.get(k, 0) for k in cuda_kernels.LAUNCHES}
    if {k: v for k, v in want.items() if v} != {"fused_ln_self_attention": 1600, "fused_ln_geglu_ff": 800,
                                                "self_attention": 1}:
        raise RuntimeError(f"unexpected v1 routing at full width: {want}")
    pos = make_text_batch(config, ["a recording of a violin solo"])
    neg = make_text_batch(config, ["low quality"])
    pipe.generate(pos, neg, audio_length_in_s=seconds, num_inference_steps=steps, seed=99)     # warm-up
    runs = serve("v1", lambda i: pipe.generate(pos, neg, audio_length_in_s=seconds, num_inference_steps=steps,
                                               seed=i), requests, want, samples)
    for i, run in enumerate(runs):
        run["v1_memory"] = run["max_memory_allocated"] - held
        log(f"v1 request {i}: {run['v1_memory'] / 2**30:.3f} GiB above the {held / 2**30:.3f} GiB that other "
            f"pipelines held before this one was built")
    del pipe
    torch.cuda.empty_cache()
    return {"reference_rel_err": rel, "requests": runs}


def cn_slice_phase(modules, device) -> dict:
    """The bf16 slice's weights (shared, not copied; the adapter's dropped)
    under ``cn_text_only`` with hoisting off: a generate with hoisting on
    must refuse; then one request with exact launch counts (K4 at every
    cross site, none of K2) and a second with the same seed and a different
    audio prompt, whose waveform must be bit-equal (the UNet strips the
    AudioMAE tokens, and K1, K3 and K4 are deterministic)."""

    import dataclasses

    import numpy as np
    import torch

    from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline, PipelineModules
    from ap_adapter_torch.pipeline.tokenize import make_text_batch

    sd = {k: v for k, v in modules.state_dict().items() if ".processor." not in k}

    def pipeline(config):
        mods = PipelineModules(config)
        mods.load_state_dict(sd, strict=True, assign=True)
        return AudioLDM2Pipeline(config, mods)

    hoisted = modules.config.replace(unet=dataclasses.replace(modules.config.unet, cn_text_only=True))
    text = make_text_batch(hoisted, ["a violin"])
    try:
        pipeline(hoisted).generate(text, text, np.zeros((1, *hoisted.audiomae.img_size), np.float32),
                                   audio_length_in_s=1.0, num_inference_steps=1)
    except ValueError as e:
        if "cn_text_only" not in str(e):
            raise
        log(f"cn with hoisting on refuses: {e}")
    else:
        raise RuntimeError("a cn_text_only generate with hoisting on did not refuse")
    pipe = pipeline(hoisted.replace(hoist_step_invariants=False))
    runs = slice_phase(pipe, device, requests=2, seeds=(0, 0), audio_seeds=(0, 1))
    if runs[0]["launches"]["fused_ln_cross_attention_kv"] != 0 or runs[0]["launches"]["fused_ln_cross_attention"] != 3200:
        raise RuntimeError(f"cn request: {runs[0]['launches']}")
    equal = bool(np.array_equal(runs[0]["wav"], runs[1]["wav"]))
    log(f"cn requests 0 and 1 (same seed, audio prompts from seeds 0 and 1): waveforms bit-equal: {equal}")
    if not equal:
        raise RuntimeError("cn_text_only: the waveform changed with the audio prompt")
    del pipe
    torch.cuda.empty_cache()
    return {"requests": runs, "bit_equal_under_a_changed_audio_prompt": equal}


def clap_scorer(pipe, device):
    """A ClapScorer at the published widths: the pipeline's CLAP text tower
    and an HTSAT-base audio tower (``ClapAudioConfig()``: spec 256, depths
    2-2-6-2, 512-d projection) with random fp32 weights from seed 11."""

    from ap_adapter_torch.configs import ClapAudioConfig
    from ap_adapter_torch.eval.clap_scoring import ClapScorer
    from ap_adapter_torch.models.clap_audio import ClapAudioTower
    from ap_adapter_torch.pipeline.pipeline import fill_random_

    return ClapScorer(pipe.modules.clap, fill_random_(ClapAudioTower(ClapAudioConfig()).to(device), 11),
                      device=device)


def ranked_phase(pipe, scorer, device) -> dict:
    """``generate_ranked``, 1 prompt x 2 candidates (4 UNet rows with CFG)
    under use_pallas_attention: one generate call, so exactly one request's
    launches (the VAE decodes both candidates in one call: one
    self-attention launch); the returned group is the candidates reordered by
    argsort of the scorer's similarities, computed separately."""

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
    seen = {}

    class Recorder:      # what generate_ranked handed the scorer, and the order it got back
        def rank(self, ids, mask, group, sr):
            seen["group"], seen["order"] = np.stack(group), scorer.rank(ids, mask, group, sr)
            return seen["order"]

    want = expected_request_launches(c.unet, task.num_inference_steps)
    cuda_kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wavs = pipe.generate_ranked(pos, neg, fbank, num_waveforms_per_prompt=2, scorer=Recorder(),
                                audio_length_in_s=task.audio_length_in_s,
                                num_inference_steps=task.num_inference_steps, guidance_scale=task.guidance_scale,
                                ap_scale=task.ap_scale, time_pool=task.time_pooling, freq_pool=task.freq_pooling)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    moved = dict(cuda_kernels.LAUNCHES)
    want = {k: want.get(k, 0) for k in moved}
    sims = scorer.similarities(pos.clap_ids, pos.clap_mask, list(seen["group"]), c.vocoder.sampling_rate)
    order = np.argsort(sims)[::-1]
    log(f"generate_ranked (1 prompt x 2, K10): {seconds:.3f} s (scoring included), similarities "
        f"{sims.tolist()}, order {order.tolist()}, launches {moved}")
    if wavs.shape != (2, int(task.audio_length_in_s * c.vocoder.sampling_rate)) or not np.all(np.isfinite(wavs)):
        raise RuntimeError(f"generate_ranked: bad output {wavs.shape}")
    if order.tolist() != seen["order"].tolist() or not np.array_equal(wavs, seen["group"][order]):
        raise RuntimeError("generate_ranked did not return the candidates in the scorer's order")
    if moved != want:
        raise RuntimeError(f"generate_ranked: launch counts {moved} != expected {want}")
    return {"seconds": seconds, "launches": moved, "similarities": sims.tolist(), "order": order.tolist()}


def eval_phase(pipe, scorer, device) -> dict:
    """The eval runner at full width on the bf16 pipeline: 16 synthetic 10 s
    clips at batch 8 (two batches, exact launch counts), FAD source against
    edit in the CLAP space and in the VGGish space (random full-width VGGish,
    seed 12); then ``run_eval_protocol`` with the clips split into two
    domains."""

    import shutil

    import numpy as np

    from ap_adapter_torch.configs import get_task_config
    from ap_adapter_torch.eval.runner import eval_clips, run_batched_eval, run_eval_protocol
    from ap_adapter_torch.eval.vggish import VGGish, VggishEmbedder
    from ap_adapter_torch.ops import cuda_kernels
    from ap_adapter_torch.pipeline.pipeline import fill_random_

    work_dir = os.path.join(ROOT, "build", "eval_smoke")
    shutil.rmtree(work_dir, ignore_errors=True)
    write_wavs(os.path.join(work_dir, "clips"), n=16)
    clips = eval_clips([os.path.join(work_dir, "clips")])
    task = get_task_config("timbre_transfer")
    vggish = VggishEmbedder(fill_random_(VGGish().to(device), 12), device=device)
    per_request = expected_request_launches(pipe.config.unet, task.num_inference_steps)
    out = {}
    for name, embedder in (("clap", scorer), ("vggish", vggish)):
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_batched_eval(pipe, clips, task, batch_size=8, scorer=embedder,
                               output_dir=os.path.join(work_dir, f"edits_{name}"))
        seconds = time.perf_counter() - t0
        moved = dict(cuda_kernels.LAUNCHES)
        want = {k: 2 * per_request.get(k, 0) for k in moved}
        log(f"eval sweep ({name} space): {res}, {seconds:.3f} s with FAD and wav writing, launches {moved}")
        if res["n"] != 16 or not np.isfinite(res["clips_per_s"]) or not np.isfinite(res[f"fad_{name}"]):
            raise RuntimeError(f"eval sweep ({name}): bad result {res}")
        if moved != want:
            raise RuntimeError(f"eval sweep ({name}): launch counts {moved} != expected {want}")
        if len(os.listdir(os.path.join(work_dir, f"edits_{name}"))) != 16:
            raise RuntimeError(f"eval sweep ({name}): edits not written")
        out[name] = {**res, "seconds": seconds}
    domains = {}
    for dom, part in (("in_domain", clips[:8]), ("out_of_domain", clips[8:])):
        d = os.path.join(work_dir, dom)
        os.makedirs(d)
        for p in part:
            shutil.copy(p, d)
        domains[dom] = {"source": [d], "reference": [os.path.join(work_dir, "in_domain")]}
    t0 = time.perf_counter()
    proto = run_eval_protocol(pipe, domains, task, batch_size=8, scorer=scorer)
    log(f"eval protocol (clap space, 2 x 8 clips): {proto}, {time.perf_counter() - t0:.3f} s")
    keys = {"fad_in_domain", "fad_out_of_domain", "fad_faithfulness_in_domain", "fad_faithfulness_out_of_domain"}
    if not keys <= set(proto) or not all(np.isfinite(proto[k]) for k in keys) or proto["n_total"] != 16:
        raise RuntimeError(f"eval protocol: bad result {proto}")
    out["protocol"] = proto
    return out


def tasks_phase(pipe, device) -> dict:
    """The task CLI in process: the SDEdit route at full width with random
    weights (one prompt, one file), then ``run_task`` at the timbre_transfer
    template (one prompt) with the phase-6 pipeline; file names, waveforms
    and exact launch counts."""

    import shutil

    import numpy as np
    import torch

    from ap_adapter_torch.audio.io import load_wav
    from ap_adapter_torch.configs import get_task_config
    from ap_adapter_torch.ops import cuda_kernels
    from ap_adapter_torch.pipeline import tasks
    from ap_adapter_torch.pipeline.style_transfer import sdedit_timesteps

    work_dir = os.path.join(ROOT, "build", "tasks_smoke")
    shutil.rmtree(work_dir, ignore_errors=True)
    write_wavs(os.path.join(work_dir, "data"), n=1)
    wav = os.path.join(work_dir, "data", "clip_00.wav")
    out_dir = os.path.join(work_dir, "out")
    c = pipe.config
    samples = int(10.0 * c.vocoder.sampling_rate)
    steps = len(sdedit_timesteps(50, c.scheduler))      # 26 of the template's 50
    per_forward = expected_launches(c.unet)
    result = {}
    for route in ("sdedit", "timbre_transfer"):
        cuda_kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if route == "sdedit":
            paths = tasks.main(["--task", "style_transfer", "--sdedit", "--random-weights", "--audio-prompt", wav,
                                "--prompt", "Jazz style music", "--output-dir", out_dir])
            names = ["J_0_ip0.55_t4_f4_sdedit.wav"]
            want = {**{k: v * steps for k, v in per_forward.items()}, "self_attention": 2}
        else:
            task = get_task_config("timbre_transfer", output_dir=out_dir, audio_prompt_file=wav,
                                   positive_text_prompts=("a recording of a violin solo",))
            paths = tasks.run_task(task, pipe)
            names = ["a_0_ip0.5_t2_f2.wav"]
            want = expected_request_launches(c.unet, task.num_inference_steps)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        moved = dict(cuda_kernels.LAUNCHES)
        want = {k: want.get(k, 0) for k in moved}
        mem = torch.cuda.max_memory_allocated()
        log(f"task CLI {route}: {seconds:.3f} s{' (its model build included)' if route == 'sdedit' else ''}, "
            f"max_memory_allocated={mem / 2**30:.3f} GiB, wrote {[os.path.basename(p) for p in paths]}, "
            f"launches {moved}")
        if [os.path.basename(p) for p in paths] != names:
            raise RuntimeError(f"task CLI {route}: wrote {paths}, expected {names}")
        for p in paths:
            data, sr = load_wav(p)
            if sr != c.vocoder.sampling_rate or data.shape != (samples,) or not np.all(np.isfinite(data)) \
                    or not data.std() > 0:
                raise RuntimeError(f"task CLI {route}: bad wav {p}: {sr} Hz, {data.shape}")
        if moved != want:
            raise RuntimeError(f"task CLI {route}: launch counts {moved} != expected {want}")
        result[route] = {"seconds": seconds, "max_memory_allocated": mem, "launches": moved}
    torch.cuda.empty_cache()
    return result


def write_safetensors(path: str, tensors: dict) -> None:
    """A ``.safetensors`` file of bf16 tensors (u64 header length, JSON
    header, raw bytes), as the ``safetensors`` package writes it."""

    import struct

    import torch

    header, offset = {}, 0
    for name, t in tensors.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {t.dtype}, not bf16")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": "BF16", "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw)
        for t in tensors.values():
            f.write(t.contiguous().reshape(-1).view(torch.uint8).numpy().data)


def audioldm2_configs(c) -> dict:
    """``{(subdirectory, file): json}`` of a diffusers AudioLDM2 directory for
    the PipelineConfig ``c``: the inverse of ``convert/cli.py::build_config``."""

    u, v, o, cl, t5, g, p = c.unet, c.vae, c.vocoder, c.clap, c.t5, c.gpt2, c.projection
    return {
        ("unet", "config.json"): {
            "in_channels": u.in_channels, "out_channels": u.out_channels,
            "block_out_channels": list(u.block_out_channels),
            "down_block_types": ["CrossAttnDownBlock2D" if a else "DownBlock2D" for a in u.down_block_has_attn],
            "up_block_types": ["CrossAttnUpBlock2D" if a else "UpBlock2D" for a in u.up_block_has_attn],
            "layers_per_block": u.layers_per_block, "transformer_layers_per_block": u.transformer_layers_per_block,
            "cross_attention_dim": list(u.cross_attention_dims), "num_attention_heads": u.num_attention_heads,
            "norm_num_groups": u.norm_num_groups, "norm_eps": u.norm_eps, "flip_sin_to_cos": u.flip_sin_to_cos,
            "freq_shift": u.freq_shift},
        ("vae", "config.json"): {
            "in_channels": v.in_channels, "out_channels": v.out_channels, "latent_channels": v.latent_channels,
            "block_out_channels": list(v.block_out_channels), "layers_per_block": v.layers_per_block,
            "norm_num_groups": v.norm_num_groups, "scaling_factor": v.scaling_factor,
            "mid_block_add_attention": v.mid_block_attention},
        ("vocoder", "config.json"): {
            "model_in_dim": o.model_in_dim, "sampling_rate": o.sampling_rate,
            "upsample_initial_channel": o.upsample_initial_channel, "upsample_rates": list(o.upsample_rates),
            "upsample_kernel_sizes": list(o.upsample_kernel_sizes),
            "resblock_kernel_sizes": list(o.resblock_kernel_sizes),
            "resblock_dilation_sizes": [list(d) for d in o.resblock_dilation_sizes],
            "leaky_relu_slope": o.leaky_relu_slope, "normalize_before": o.normalize_before},
        ("scheduler", "scheduler_config.json"): dataclasses.asdict(c.scheduler),
        ("text_encoder", "config.json"): {
            "projection_dim": cl.projection_dim,
            "text_config": {"vocab_size": cl.vocab_size, "hidden_size": cl.hidden_size,
                            "num_hidden_layers": cl.num_layers, "num_attention_heads": cl.num_heads,
                            "intermediate_size": cl.intermediate_size,
                            "max_position_embeddings": cl.max_position_embeddings, "pad_token_id": cl.pad_token_id}},
        ("text_encoder_2", "config.json"): {
            "vocab_size": t5.vocab_size, "d_model": t5.d_model, "d_kv": t5.d_kv, "d_ff": t5.d_ff,
            "num_layers": t5.num_layers, "num_heads": t5.num_heads,
            "relative_attention_num_buckets": t5.relative_attention_num_buckets,
            "relative_attention_max_distance": t5.relative_attention_max_distance,
            "feed_forward_proj": t5.feed_forward_proj, "is_gated_act": t5.feed_forward_proj.startswith("gated")},
        ("language_model", "config.json"): {
            "vocab_size": g.vocab_size, "n_embd": g.n_embd, "n_layer": g.n_layer, "n_head": g.n_head,
            "n_positions": g.n_positions, "max_new_tokens": g.max_new_tokens},
        ("projection_model", "config.json"): {
            "text_encoder_dim": p.text_encoder_dim, "text_encoder_1_dim": p.text_encoder_1_dim,
            "langauge_model_dim": p.language_model_dim},     # [sic], as diffusers writes it
    }


def write_audioldm2_dir(root: str, modules, seed: int = 12) -> dict:
    """The public layout around ``modules``' weights, every tensor in bf16
    (exact for bf16 weights): a diffusers ``cvssp/audioldm2-large`` directory
    (per-submodel config.json; ``ClapModel`` with its position/token-type
    buffers, an HTSAT audio branch and the logit scales; T5 with its tied
    ``encoder.embed_tokens``; GPT-2 with ``wte``; the vocoder's
    ``mean``/``scale``; the UNet without adapter keys as a BF16
    ``.safetensors``), the adapter as the reference's flat ``.bin``, and
    AudioMAE's ``pretrained.pth`` (``{'model': ...}``, bare names, a random
    MAE decoder, ``pos_embed``/``decoder_pos_embed`` as the fp32 sin-cos
    tables the reference stores). Returns the paths."""

    import numpy as np
    import torch

    from ap_adapter_torch.adapter.params import export_flat_adapter
    from ap_adapter_torch.configs import ClapAudioConfig
    from ap_adapter_torch.models.clap_audio import ClapAudioTower
    from ap_adapter_torch.models.layers import audiomae_pos_embed
    from ap_adapter_torch.models.mae_pretrain import MAEDecoder
    from ap_adapter_torch.pipeline.pipeline import fill_random_

    c = modules.config
    for (sub, name), obj in audioldm2_configs(c).items():
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        with open(os.path.join(root, sub, name), "w") as f:
            json.dump(obj, f)
    gen = torch.Generator().manual_seed(seed)

    def weights(module):
        return {k: v.detach().to("cpu", torch.bfloat16) for k, v in module.state_dict().items()}

    def random(*shape):
        return (torch.randn(*shape, generator=gen) * 0.02).to(torch.bfloat16)

    def save(sd, sub, name):
        torch.save(sd, os.path.join(root, sub, name))

    clap = weights(modules.clap)
    n_pos = c.clap.max_position_embeddings
    clap["text_model.embeddings.position_ids"] = torch.arange(n_pos)[None]
    clap["text_model.embeddings.token_type_ids"] = torch.zeros(1, n_pos, dtype=torch.int64)
    clap.update(weights(fill_random_(ClapAudioTower(ClapAudioConfig()), seed)))
    clap["logit_scale_a"] = clap["logit_scale_t"] = torch.tensor(np.log(1 / 0.07), dtype=torch.bfloat16)
    save(clap, "text_encoder", "pytorch_model.bin")
    t5 = weights(modules.t5)
    t5["encoder.embed_tokens.weight"] = t5["shared.weight"].clone()
    save(t5, "text_encoder_2", "pytorch_model.bin")
    save({**weights(modules.gpt2), "wte.weight": random(c.gpt2.vocab_size, c.gpt2.n_embd)},
         "language_model", "pytorch_model.bin")
    save(weights(modules.projection), "projection_model", "diffusion_pytorch_model.bin")
    save(weights(modules.vae), "vae", "diffusion_pytorch_model.bin")
    save({**weights(modules.vocoder), "mean": torch.zeros(c.vocoder.model_in_dim, dtype=torch.bfloat16),
          "scale": torch.ones(c.vocoder.model_in_dim, dtype=torch.bfloat16)}, "vocoder", "pytorch_model.bin")
    write_safetensors(os.path.join(root, "unet", "diffusion_pytorch_model.safetensors"),
                      {k: v for k, v in weights(modules.unet).items() if ".processor." not in k})

    adapter = os.path.join(root, "ap_adapter", "pytorch_model.bin")
    os.makedirs(os.path.dirname(adapter))
    torch.save({k: torch.from_numpy(v) for k, v in export_flat_adapter(modules.unet).items()}, adapter)
    mae = {k[len("model."):]: v for k, v in weights(modules.audiomae).items()}
    mae.update(weights(fill_random_(MAEDecoder(c.audiomae), seed)))
    t, f = c.audiomae.grid_size
    mae["pos_embed"] = torch.from_numpy(audiomae_pos_embed(c.audiomae.embed_dim, (f, t))[None].copy())
    mae["decoder_pos_embed"] = torch.from_numpy(audiomae_pos_embed(c.audiomae.decoder_embed_dim, (f, t))[None].copy())
    audiomae = os.path.join(root, "audiomae", "pretrained.pth")
    os.makedirs(os.path.dirname(audiomae))
    torch.save({"model": mae}, audiomae)
    return {"audioldm2_dir": os.path.join(root), "adapter": adapter, "audiomae": audiomae}


def dir_bytes(directory: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(directory) for f in fs)


def convert_phase(pipe, device) -> dict:
    """Phase 24: the phase-6 weights written in the public layout
    (``write_audioldm2_dir``), converted by ``python -m
    ap_adapter_torch.convert.cli`` in a subprocess, then the task CLI's
    timbre_transfer request served from the converted directory with the
    reference adapter ``.bin``: the wav bit-equal to the task CLI phase's
    ``run_task`` on the phase-6 pipeline (same weights, seed and inputs) and
    exact launch counts. Prints the seconds and bytes; deletes the
    directory."""

    import shutil

    import numpy as np
    import torch

    from ap_adapter_torch.adapter.params import export_flat_adapter
    from ap_adapter_torch.audio.io import load_wav
    from ap_adapter_torch.convert.cli import build_config
    from ap_adapter_torch.ops import cuda_kernels
    from ap_adapter_torch.pipeline import tasks
    from ap_adapter_torch.pipeline.pipeline import PipelineModules

    work = os.path.join(ROOT, "build", "convert_smoke")
    shutil.rmtree(work, ignore_errors=True)
    c = pipe.config
    t0 = time.perf_counter()
    paths = write_audioldm2_dir(os.path.join(work, "audioldm2-large"), pipe.modules)
    write_seconds = time.perf_counter() - t0
    if build_config(paths["audioldm2_dir"]) != c:
        raise RuntimeError("convert: build_config of the written directory differs from PipelineConfig()")
    source_bytes = dir_bytes(work)
    out = os.path.join(work, "converted")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ap_adapter_torch.convert.cli", "--audioldm2-dir",
                           paths["audioldm2_dir"], "--audiomae-ckpt", paths["audiomae"], "--adapter-ckpt",
                           paths["adapter"], "--out", out], cwd=ROOT, capture_output=True, text=True, timeout=600)
    convert_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"convert: the CLI exited {proc.returncode}: {proc.stderr[-4000:]}")
    written = sorted(os.listdir(out))
    written_bytes = dir_bytes(out)
    log(f"convert: wrote the public layout in {write_seconds:.3f} s ({source_bytes} bytes, bf16), converted in "
        f"{convert_seconds:.3f} s (its process start included): {written}, {written_bytes} bytes (fp32)")
    if written != sorted([f"{n}.npz" for n in PipelineModules.NAMES] + ["config.json"]):
        raise RuntimeError(f"convert: wrote {written}")
    adapter = export_flat_adapter(pipe.modules.unet)
    with np.load(os.path.join(out, "unet.npz")) as f:      # the merge, before the task CLI imports it again
        merged = all(np.array_equal(f[k], v) for k, v in adapter.items())
    if not merged:
        raise RuntimeError("convert: unet.npz does not hold the adapter .bin's to_k_ip/to_v_ip")

    data_dir = os.path.join(ROOT, "build", "tasks_smoke")
    wav = os.path.join(data_dir, "data", "clip_00.wav")
    want_path = os.path.join(data_dir, "out", "a_0_ip0.5_t2_f2.wav")
    cuda_kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got_paths = tasks.main(["--task", "timbre_transfer", "--audio-prompt", wav, "--prompt",
                            "a recording of a violin solo", "--checkpoint-dir", out, "--adapter-ckpt",
                            paths["adapter"], "--output-dir", os.path.join(work, "out")])
    torch.cuda.synchronize()
    request_seconds = time.perf_counter() - t0
    moved = dict(cuda_kernels.LAUNCHES)
    want = expected_request_launches(c.unet, 50)
    want = {k: want.get(k, 0) for k in moved}
    mem = torch.cuda.max_memory_allocated()
    got, sr = load_wav(got_paths[0])
    ref, _ = load_wav(want_path)
    equal = got.dtype == ref.dtype and got.shape == ref.shape and np.array_equal(got, ref)
    log(f"convert: served {[os.path.basename(p) for p in got_paths]} from the converted directory in "
        f"{request_seconds:.3f} s (the model load included), max_memory_allocated={mem / 2**30:.3f} GiB, "
        f"launches {moved}; bit-equal to the task CLI phase's run_task: {equal}")
    if [os.path.basename(p) for p in got_paths] != [os.path.basename(want_path)]:
        raise RuntimeError(f"convert: the task CLI wrote {got_paths}")
    if moved != want:
        raise RuntimeError(f"convert: launch counts {moved} != expected {want}")
    if not equal:
        raise RuntimeError(f"convert: the wav differs from the phase-6 pipeline's (max abs diff "
                           f"{np.abs(got.astype(np.float64) - ref).max()})")
    shutil.rmtree(work)
    torch.cuda.empty_cache()
    return {"write_seconds": write_seconds, "source_bytes": source_bytes, "convert_seconds": convert_seconds,
            "written_bytes": written_bytes, "request_seconds": request_seconds, "max_memory_allocated": mem,
            "launches": {k: n for k, n in moved.items() if n}, "bit_equal": equal, "adapter_merged": merged}


def train_reference_phase(modules, device) -> dict:
    """The training loss and its adapter gradient at full width (16x16
    latent, B=2, ip_scale 1.0, no hoisting): bf16 kernels on the card against
    the plain path in fp32 on the CPU, with the same weights, noise and
    timesteps."""

    import copy
    import types

    import torch

    from ap_adapter_torch.train.trainer import TrainConfig, compute_loss, split_unet_params

    c = modules.config
    g = torch.Generator().manual_seed(4)
    mask = torch.ones(2, 64, dtype=torch.long)
    mask[0, 12:] = 0
    batch = {"mel": torch.randn(2, 64, c.mel.num_mel_bins, 1, generator=g) - 4.0,
             "generated_prompt_embeds": torch.randn(2, 8 + 128, c.unet.adapter_cross_attention_dim, generator=g),
             "prompt_embeds": torch.randn(2, 64, c.t5.d_model, generator=g), "attention_mask": mask}
    lat = (2, 16, c.mel.num_mel_bins // c.vae.scale_factor, c.vae.latent_channels)
    noise = {"vae_noise": torch.randn(lat, generator=g), "noise": torch.randn(lat, generator=g),
             "timesteps": torch.tensor([120, 730])}
    tc = TrainConfig()

    def run(mods, dev):
        adapter = split_unet_params(mods.unet)
        loss = compute_loss(mods, tc, {k: v.to(dev) for k, v in batch.items()},
                            **{k: v.to(dev) for k, v in noise.items()})
        grads = torch.autograd.grad(loss, list(adapter.values()))
        return loss.item(), torch.cat([gr.float().flatten().cpu() for gr in grads])

    got_loss, got = run(modules, device)
    torch.cuda.synchronize()
    ref = types.SimpleNamespace(config=c, dtype=torch.float32,
                                unet=copy.deepcopy(modules.unet).to("cpu", torch.float32),
                                vae=copy.deepcopy(modules.vae).to("cpu", torch.float32))
    want_loss, want = run(ref, "cpu")
    del ref
    rel = abs(got_loss - want_loss) / abs(want_loss)
    cos = torch.nn.functional.cosine_similarity(got.double(), want.double(), dim=0).item()
    ratio = (got.norm() / want.norm()).item()
    log(f"training reference: loss {got_loss:.6g} (card, bf16 kernels) vs {want_loss:.6g} (cpu fp32 plain), "
        f"rel {rel:.4g} (limit {LOSS_TOL}); adapter gradient ({got.numel()} values) cosine {cos:.6f} "
        f"(limit 0.99), norm ratio {ratio:.6f} (limit [0.95, 1.05]), |g| {want.norm().item():.4g}")
    if not (rel <= LOSS_TOL and cos >= 0.99 and 0.95 <= ratio <= 1.05):
        raise RuntimeError("training reference check failed")
    return {"loss": got_loss, "ref_loss": want_loss, "loss_rel_err": rel, "grad_cosine": cos,
            "grad_norm_ratio": ratio}


def write_wavs(directory: str, n: int = 16, seconds: float = 10.0, sr: int = 16_000) -> str:
    """n seeded synthetic clips (a few partials with vibrato and noise) and
    their AudioSet-style manifest; returns the manifest's path."""

    import numpy as np

    from ap_adapter_torch.audio.io import save_wav

    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(5)
    t = np.arange(int(seconds * sr)) / sr
    labels = ["violin", "piano", "acoustic guitar", "flute", "drum kit", "cello", "trumpet", "organ"]
    items = []
    for i in range(n):
        f0 = rng.uniform(110, 880)
        wav = sum(rng.uniform(0.1, 0.4) / k * np.sin(2 * np.pi * k * f0 * t + 0.3 * np.sin(2 * np.pi * 5 * t))
                  for k in range(1, 5)) + 0.01 * rng.standard_normal(t.size)
        path = os.path.join(directory, f"clip_{i:02d}.wav")
        save_wav(path, wav.astype(np.float32), sr)
        items.append({"wav": path, "labels": labels[i % len(labels)]})
    manifest = os.path.join(directory, "manifest.json")
    with open(manifest, "w") as f:
        json.dump({"data": items}, f)
    return manifest


def train_slice_phase(device, steps: int = 3, accum: int = 2) -> dict:
    """Adapter training through the CLI at full width; checks what moved."""

    import shutil

    import numpy as np
    import torch

    from ap_adapter_torch.adapter.params import adapter_parameters, import_flat_adapter, init_adapter_from_text_kv
    from ap_adapter_torch.configs import PipelineConfig
    from ap_adapter_torch.ops import cuda_kernels
    from ap_adapter_torch.pipeline.pipeline import PipelineModules
    from ap_adapter_torch.train import cli
    from ap_adapter_torch.train.trainer import split_unet_params
    from ap_adapter_torch.utils.checkpoint import load_flat_adapter

    work_dir = os.path.join(ROOT, "build", "train_smoke")
    shutil.rmtree(work_dir, ignore_errors=True)
    manifest = write_wavs(os.path.join(work_dir, "data"))
    out = os.path.join(work_dir, "out")
    config = PipelineConfig()
    per_micro = {**expected_train_launches(config.unet), "self_attention": 1}   # + the VAE encode's mid block
    want = {k: 0 for k in cuda_kernels.LAUNCHES}
    want.update({k: v * steps * accum for k, v in per_micro.items()})

    cuda_kernels.reset_launch_counts()
    state, trained = cli.main(["--train-manifest", manifest, "--random-weights", "--no-validation",
                               "--train-batch-size", str(TRAIN_B), "--gradient-accumulation-steps", str(accum),
                               "--max-train-steps", str(steps), "--output-dir", out])
    torch.cuda.synchronize()
    moved = dict(cuda_kernels.LAUNCHES)
    for m in state.history:
        log(f"train step {m['step']}: {m['seconds']:.3f} s, max_memory_allocated="
            f"{m.get('max_memory_allocated', 0) / 2**30:.3f} GiB, loss {m['loss']:.6g}, grad_norm {m['grad_norm']:.6g}")
    log(f"training launches over {steps} steps x {accum} micro-steps: {moved} (per micro-step {per_micro})")
    if state.step != steps or len(state.history) != steps:
        raise RuntimeError(f"training stopped at step {state.step}")
    if not all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0
               for m in state.history):
        raise RuntimeError(f"non-finite or zero training metrics: {state.history}")
    if moved != want:
        raise RuntimeError(f"training launch counts {moved} != expected {want}")
    # weight decay moves every adapter matrix, so a moved weight does not show
    # that its site got a gradient; the last step's (clipped) gradient does
    grad_norms = {k: torch.linalg.vector_norm(p.grad).item() for k, p in state.adapter.items()}
    if not all(np.isfinite(n) and n > 0 for n in grad_norms.values()):
        raise RuntimeError(f"adapter matrices without a gradient: {grad_norms}")

    # the same initial weights, drawn again: only the adapter may have moved
    fresh = PipelineModules(config).init_random(42, device=device)
    init_adapter_from_text_kv(fresh.unet)
    keys = set(adapter_parameters(trained.unet))
    before = dict(fresh.named_parameters())
    n_frozen = 0
    for name, p in trained.named_parameters():
        key = name[len("unet."):] if name.startswith("unet.") else None
        if key in keys:
            if torch.equal(p.float(), before[name].float()):
                raise RuntimeError(f"adapter weight {key} did not change")
        else:
            if p.dtype != before[name].dtype or not torch.equal(p, before[name]):
                raise RuntimeError(f"frozen weight {name} changed")
            n_frozen += 1
    flat = load_flat_adapter(os.path.join(out, "pytorch_model.npz"))
    split_unet_params(fresh.unet)            # fp32 adapter matrices, as the trainer holds them
    import_flat_adapter(fresh.unet, flat)
    for key, p in adapter_parameters(fresh.unet).items():
        if set(flat) != keys or not torch.equal(p.float(), state.adapter[key].detach().float()):
            raise RuntimeError(f"exported adapter {key} does not reload to the trained tensor")
    log(f"training slice: {len(keys)} adapter matrices moved, each with a gradient (last step's norms "
        f"{min(grad_norms.values()):.4g} to {max(grad_norms.values()):.4g}), {n_frozen} frozen tensors "
        f"bit-identical, the flat adapter reloads exactly")
    history = state.history
    del fresh, trained, state
    torch.cuda.empty_cache()
    return {"launches": moved, "per_micro_step": per_micro, "steps": history}


def train_slice_ii_phase(device, first: dict, steps: int = 3, accum: int = 2) -> dict:
    """The training CLI again on phase 8's data and seed, with ``--remat
    --use-8bit-adam --report-to tensorboard`` and one validation round of 2
    clips after step 2: exact launch counts (forward, recompute and backward
    per micro-step, plus one request's worth for the round), step 1 equal
    to phase 8's, bf16 first moments, the validation wavs, the tensorboard
    events where tensorboard imports."""

    import dataclasses
    import glob
    import shutil

    import numpy as np
    import torch

    from ap_adapter_torch.audio.io import load_wav
    from ap_adapter_torch.configs import PipelineConfig
    from ap_adapter_torch.ops import cuda_kernels
    from ap_adapter_torch.train import cli

    work_dir = os.path.join(ROOT, "build", "train_smoke_ii")
    shutil.rmtree(work_dir, ignore_errors=True)
    manifest = write_wavs(os.path.join(work_dir, "data"))
    out = os.path.join(work_dir, "out")
    config = PipelineConfig()
    per_micro = {**expected_train_launches(dataclasses.replace(config.unet, remat=True)), "self_attention": 1}
    validation = expected_request_launches(config.unet, 50)
    want = {k: 0 for k in cuda_kernels.LAUNCHES}
    for k, v in per_micro.items():
        want[k] += v * steps * accum
    for k, v in validation.items():
        want[k] += v

    cuda_kernels.reset_launch_counts()
    state, trained = cli.main(["--train-manifest", manifest, "--random-weights", "--remat", "--use-8bit-adam",
                               "--report-to", "tensorboard", "--validation-steps", "2",
                               "--num-validation-audio-files", "2", "--train-batch-size", str(TRAIN_B),
                               "--gradient-accumulation-steps", str(accum), "--max-train-steps", str(steps),
                               "--output-dir", out])
    torch.cuda.synchronize()
    moved = dict(cuda_kernels.LAUNCHES)
    for m, m8 in zip(state.history, first["steps"]):
        log(f"train II step {m['step']}: {m['seconds']:.3f} s (phase 8: {m8['seconds']:.3f}), "
            f"max_memory_allocated={m.get('max_memory_allocated', 0) / 2**30:.3f} GiB "
            f"(phase 8: {m8.get('max_memory_allocated', 0) / 2**30:.3f}), loss {m['loss']:.6g} "
            f"(phase 8: {m8['loss']:.6g}), grad_norm {m['grad_norm']:.6g} (phase 8: {m8['grad_norm']:.6g})"
            + (f", validation round {m['validation_seconds']:.3f} s" if "validation_seconds" in m else ""))
    log(f"training II launches over {steps} steps x {accum} micro-steps and one validation round: {moved} "
        f"(per micro-step {per_micro}; the round {validation})")
    if state.step != steps or not all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in state.history):
        raise RuntimeError(f"training II: {state.history}")
    if moved != want:
        raise RuntimeError(f"training II launch counts {moved} != expected {want}")
    rel = {k: abs(state.history[0][k] - first["steps"][0][k]) / abs(first["steps"][0][k])
           for k in ("loss", "grad_norm")}
    log(f"training II step 1 against phase 8's: relative differences {rel} (limit 1e-3)")
    if max(rel.values()) > 1e-3:
        raise RuntimeError(f"training II step 1 differs from phase 8's: {rel}")
    moments = {str(v["exp_avg"].dtype) for v in state.optimizer.state.values()}
    if moments != {"torch.bfloat16"} or len(state.optimizer.state) != len(state.adapter):
        raise RuntimeError(f"first moments not all bf16: {moments}")
    val_dir = os.path.join(out, "validation")
    generated = sorted(glob.glob(os.path.join(val_dir, "step2_pool*.wav")))
    originals = sorted(glob.glob(os.path.join(val_dir, "step2_original*.wav")))
    if len(generated) != 2 or len(originals) != 2 or not os.path.exists(os.path.join(val_dir, "step2_caption.txt")):
        raise RuntimeError(f"validation files: {sorted(os.listdir(val_dir))}")
    for path in generated:
        check_waveform(os.path.basename(path), load_wav(path)[0][None], 160_000)
    try:
        import torch.utils.tensorboard  # noqa: F401
        events = glob.glob(os.path.join(out, "tb", "events.out.tfevents.*"))
        if not events:
            raise RuntimeError("tensorboard imports, but no events file under tb/")
        log(f"tensorboard: {[os.path.basename(e) for e in events]}")
    except ImportError as e:
        events = None
        log(f"tensorboard does not import here ({e}); the JSONL metrics only")
    history = state.history
    del trained, state
    torch.cuda.empty_cache()
    return {"launches": moved, "per_micro_step": per_micro, "validation_round": validation, "steps": history,
            "step1_rel_diff": rel, "validation_files": [os.path.basename(p) for p in generated + originals],
            "tensorboard_events": None if events is None else len(events), "data": os.path.join(work_dir, "data")}


def wav_batch_phase(data_dir: str, reps: int = 5) -> dict:
    """The batched wav decoder over the 16 training wavs: a fresh build of
    the C++ library, then every row bit-equal to ``load_wav``'s waveform;
    files/s of ``load_wav_batch`` at the loader's capacity (10 s x 48 kHz)
    beside ``load_wav`` one file at a time."""

    import glob

    import numpy as np

    from ap_adapter_torch.audio import io

    io.wavio_library_path().unlink(missing_ok=True)
    t0 = time.perf_counter()
    io.build_wavio()
    build_s = time.perf_counter() - t0
    paths = sorted(glob.glob(os.path.join(data_dir, "clip_*.wav")))
    cap = 10 * 48_000
    times, scipy_times = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        wavs, frames, srs = io.load_wav_batch(paths, cap)
        times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        ref = [io.load_wav(p) for p in paths]
        scipy_times.append(time.perf_counter() - t0)
    for i, (wav, sr) in enumerate(ref):
        m = min(wav.shape[0], cap)
        if frames[i] != m or srs[i] != sr or not np.array_equal(wavs[i, :m], wav[:m]) or wavs[i, m:].any():
            raise RuntimeError(f"load_wav_batch differs from load_wav at {paths[i]}")
    rate, scipy_rate = len(paths) / statistics.median(times), len(paths) / statistics.median(scipy_times)
    log(f"batched wav loader: build {build_s:.2f} s (g++ -O3), {len(paths)} files bit-equal to load_wav; "
        f"{rate:.1f} files/s (median of {reps}) against load_wav's {scipy_rate:.1f}")
    return {"build_seconds": build_s, "files": len(paths), "files_per_s": rate, "load_wav_files_per_s": scipy_rate}


def mae_phase(device, data_dir: str, steps: int = 3, batch: int = 8) -> dict:
    """AudioMAE pretraining at ``AudioMAEConfig()`` (ViT-B/16 encoder, 512
    wide 8-block decoder, 1024 x 128 fbank, 512 patches, mask 0.8), random
    weights (seed 0): one forward in bf16 on the card against fp32 on the
    CPU (loss within 1e-2 relative), then ``steps`` pretraining steps at
    ``batch`` in fp32 on the card (finite losses, weights moved)."""

    import copy
    import glob

    import numpy as np
    import torch

    from ap_adapter_torch.audio.fbank import audiomae_fbank
    from ap_adapter_torch.audio.io import load_wav
    from ap_adapter_torch.configs import AudioMAEConfig, FbankConfig
    from ap_adapter_torch.models.mae_pretrain import (MAEPretrain, make_mae_pretrain_step, random_masking,
                                                      reconstruction_loss)

    cfg = AudioMAEConfig()
    paths = sorted(glob.glob(os.path.join(data_dir, "clip_*.wav")))[:batch]
    fbank = audiomae_fbank(torch.as_tensor(np.stack([load_wav(p)[0] for p in paths])), FbankConfig())
    torch.manual_seed(0)
    model = MAEPretrain(cfg)
    ids_keep, mask, ids_restore = random_masking(torch.Generator().manual_seed(3), 2, cfg.num_patches,
                                                 cfg.mask_ratio)

    def loss_of(m, dev):
        args = [a.to(dev) for a in (fbank[:2], ids_keep, ids_restore)]
        with torch.no_grad():
            pred = m(*args)
        return reconstruction_loss(args[0], pred, mask.to(dev), cfg.patch_size).item(), pred

    want, _ = loss_of(model, "cpu")
    got, pred = loss_of(copy.deepcopy(model).to(device, torch.bfloat16), device)
    rel = abs(got - want) / abs(want)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"MAE pretrain: {n_params / 1e6:.1f}M parameters, {ids_keep.shape[1]} of {cfg.num_patches} patches kept; "
        f"loss {got:.6g} (card, bf16) vs {want:.6g} (cpu, fp32), rel {rel:.4g} (limit 1e-2); pred {tuple(pred.shape)}")
    if not (np.isfinite(got) and rel <= 1e-2):
        raise RuntimeError("MAE forward check failed")

    model = model.to(device)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    step = make_mae_pretrain_step(model, torch.optim.AdamW(model.parameters(), lr=1e-4))
    gen = torch.Generator(device=device).manual_seed(0)
    x = fbank.to(device)
    runs = []
    for i in range(steps):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(x, gen).item()
        torch.cuda.synchronize()
        runs.append({"loss": loss, "seconds": time.perf_counter() - t0,
                     "max_memory_allocated": torch.cuda.max_memory_allocated()})
        log(f"MAE pretrain step {i + 1} (batch {x.shape[0]}, fp32): {runs[-1]['seconds']:.3f} s, "
            f"max_memory_allocated={runs[-1]['max_memory_allocated'] / 2**30:.3f} GiB, loss {loss:.6g}")
    unmoved = [k for k, v in model.state_dict().items() if torch.equal(v, before[k])]
    if not all(np.isfinite(r["loss"]) for r in runs) or unmoved:
        raise RuntimeError(f"MAE pretraining: losses {[r['loss'] for r in runs]}, unmoved {unmoved}")
    del model, before
    torch.cuda.empty_cache()
    return {"forward_rel_err": rel, "loss_card": got, "loss_cpu": want, "steps": runs}


def dist_train_batches(config, accum: int, steps: int, b: int) -> list:
    """Seeded synthetic global micro-batches at the 10 s training shapes (B =
    ``b``, 8 + 128 adapter tokens, 64 T5 tokens with padding), on the CPU."""

    import torch

    g = torch.Generator().manual_seed(9)
    mask = torch.ones(b, 64, dtype=torch.long)
    mask[0, 12:] = 0
    frames = int(10.0 * config.mel.frames_per_second)
    return [{"mel": torch.randn(b, frames, config.mel.num_mel_bins, 1, generator=g) - 4.0,
             "generated_prompt_embeds": torch.randn(b, 8 + 128, config.unet.adapter_cross_attention_dim, generator=g),
             "prompt_embeds": torch.randn(b, 64, config.t5.d_model, generator=g), "attention_mask": mask}
            for _ in range(accum * steps)]


def dist_train_config():
    from ap_adapter_torch.train.trainer import TrainConfig

    return TrainConfig(gradient_accumulation_steps=DIST_ACCUM, max_train_steps=DIST_STEPS,
                       checkpointing_steps=DIST_STEPS)


def mae_fbanks():
    """Seeded synthetic fbank batches [2 x DIST_B, 1024, 128], one a step, on the CPU."""

    import torch

    from ap_adapter_torch.configs import AudioMAEConfig

    return torch.randn(DIST_STEPS, 2 * DIST_B, *AudioMAEConfig().img_size,
                       generator=torch.Generator().manual_seed(12))


def mae_run(device, fbanks, mesh=None) -> list:
    """fp32 MAE pretraining steps at ``AudioMAEConfig()`` from seed 0 (AdamW,
    lr 1e-4): each step's loss, seconds and peak memory."""

    import torch

    from ap_adapter_torch.configs import AudioMAEConfig
    from ap_adapter_torch.models.mae_pretrain import MAEPretrain, make_mae_pretrain_step
    from ap_adapter_torch.parallel.mesh import shard_batch

    torch.manual_seed(0)
    model = MAEPretrain(AudioMAEConfig()).to(device)
    step = make_mae_pretrain_step(model, torch.optim.AdamW(model.parameters(), lr=1e-4), mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(0)
    runs = []
    for fb in fbanks:
        x = fb.to(device) if mesh is None else shard_batch(mesh, fb)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(x, gen).item()
        torch.cuda.synchronize()
        runs.append({"loss": loss, "seconds": time.perf_counter() - t0,
                     "max_memory_allocated": torch.cuda.max_memory_allocated()})
    del model
    torch.cuda.empty_cache()
    return runs


def dist_worker(rank: int, dist_dir: str) -> int:
    """One of the two ranks of phase 23, both on ``cuda:0`` over gloo (one
    card): data-parallel training through ``train(..., mesh=)`` at B =
    DIST_B a rank with exact launch counts, a data-parallel edit request (its
    row of a batch of 2), a ``--tensor-parallel 2`` request through
    ``tasks.load_pipeline`` (no transformer kernel launched), and two
    data-parallel MAE steps; writes ``rank<r>.json`` and ``rank<r>.npz``
    (the waveforms) under ``dist_dir``."""

    import numpy as np
    import torch
    import torch.distributed as dist

    from ap_adapter_torch.adapter.params import init_adapter_from_text_kv
    from ap_adapter_torch.configs import PipelineConfig
    from ap_adapter_torch.ops import cuda_kernels
    from ap_adapter_torch.parallel.distributed import maybe_initialize
    from ap_adapter_torch.parallel.mesh import create_mesh, shard_batch
    from ap_adapter_torch.parallel.tp import count_sharded_leaves
    from ap_adapter_torch.pipeline import tasks
    from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline, PipelineModules
    from ap_adapter_torch.train.loop import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(APX_NUM_PROCESSES="2", APX_PROCESS_ID=str(rank))
    device = torch.device("cuda", 0)
    if not maybe_initialize(device, backend="gloo", init_method=f"file://{os.path.join(dist_dir, 'rendezvous')}"):
        raise RuntimeError("rank without a process group")
    if dist.get_backend() != "gloo" or dist.get_world_size() != 2:
        raise RuntimeError(f"process group {dist.get_backend()} x {dist.get_world_size()}, not gloo x 2")
    mesh = create_mesh(device=device)
    config = PipelineConfig()
    out = {"rank": rank, "mesh": mesh.shape}

    # data-parallel training: this rank's DIST_B rows of each global micro-batch
    modules = PipelineModules(config).init_random(42, device=device)
    init_adapter_from_text_kv(modules.unet)
    local = [shard_batch(mesh, mb) for mb in dist_train_batches(config, DIST_ACCUM, DIST_STEPS, 2 * DIST_B)]
    per_micro = {**expected_train_launches(config.unet), "self_attention": 1}
    want = {k: per_micro.get(k, 0) * DIST_ACCUM * DIST_STEPS for k in cuda_kernels.LAUNCHES}
    cuda_kernels.reset_launch_counts()
    state = train(modules, iter(local), dist_train_config(), os.path.join(dist_dir, "train"), log_every=1, mesh=mesh)
    torch.cuda.synchronize()
    moved = dict(cuda_kernels.LAUNCHES)
    if moved != want:
        raise RuntimeError(f"rank {rank} training launches {moved} != expected {want}")
    out["train"] = {"steps": state.history, "launches": moved, "per_micro_step": per_micro}
    for m in state.history:
        log(f"rank {rank} training step {m['step']}: {m['seconds']:.3f} s, max_memory_allocated="
            f"{m['max_memory_allocated'] / 2**30:.3f} GiB, loss {m['loss']:.8g}, grad_norm {m['grad_norm']:.8g}")
    log(f"rank {rank} training launches over {DIST_STEPS} steps x {DIST_ACCUM} micro-steps, exactly as expected: "
        f"{ {k: n for k, n in moved.items() if n} }")
    del modules, state, local
    torch.cuda.empty_cache()

    # data-parallel serving: rank r edits with the audio prompt of seed r, its row of a batch of 2
    pipe = AudioLDM2Pipeline(config, PipelineModules(config).init_random(0, device=device), mesh=mesh)
    serve_run = slice_phase(pipe, device, requests=1, seeds=(0,), audio_seeds=(rank,))[0]
    del pipe
    torch.cuda.empty_cache()

    # tensor-parallel serving over a (1, 2) mesh through the task CLI's loader, phase 6's request 0
    pipe = tasks.load_pipeline(config, seed=0, tensor_parallel=2, device=device)
    sharded = count_sharded_leaves(pipe.modules.unet)
    tp_run = slice_phase(pipe, device, requests=1)[0]
    del pipe
    torch.cuda.empty_cache()
    log(f"rank {rank}: {sharded} UNet parameters split over 'model'")

    out["serve"] = {k: serve_run[k] for k in ("seconds", "max_memory_allocated", "launches")}
    out["tp"] = {**{k: tp_run[k] for k in ("seconds", "max_memory_allocated", "launches")}, "sharded": sharded}
    out["mae"] = mae_run(device, mae_fbanks(), mesh)
    for i, m in enumerate(out["mae"]):
        log(f"rank {rank} MAE step {i + 1} (B={DIST_B}, fp32): {m['seconds']:.3f} s, max_memory_allocated="
            f"{m['max_memory_allocated'] / 2**30:.3f} GiB, loss {m['loss']:.8g}")
    np.savez(os.path.join(dist_dir, f"rank{rank}.npz"), serve=serve_run["wav"], tp=tp_run["wav"])
    with open(os.path.join(dist_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def nccl_one_rank(device) -> dict:
    """(a) of phase 23: one full-width data-parallel ``train_step`` (2
    micro-batches of DIST_B) in a world of one NCCL rank against the same
    step without a process group, from the same weights, optimizer state
    and noise: loss, gradient norm and updated adapter weights bit-equal (a
    one-rank all_reduce is the identity)."""

    import tempfile

    import torch
    import torch.distributed as dist

    from ap_adapter_torch.adapter.params import init_adapter_from_text_kv
    from ap_adapter_torch.configs import PipelineConfig
    from ap_adapter_torch.parallel.mesh import create_mesh
    from ap_adapter_torch.pipeline.pipeline import PipelineModules
    from ap_adapter_torch.train.loop import step_generator
    from ap_adapter_torch.train.trainer import make_optimizer, split_unet_params, train_step

    config = PipelineConfig()
    tc = dist_train_config()
    modules = PipelineModules(config).init_random(42, device=device)
    init_adapter_from_text_kv(modules.unet)
    adapter = split_unet_params(modules.unet)
    start = {k: p.detach().clone() for k, p in adapter.items()}
    micro = [{k: v.to(device) for k, v in mb.items()} for mb in dist_train_batches(config, DIST_ACCUM, 1, DIST_B)]

    def step(mesh):
        with torch.no_grad():
            for k, p in adapter.items():
                p.copy_(start[k])
        m = train_step(modules, tc, adapter, make_optimizer(tc, adapter.values()), 0, micro,
                       step_generator(tc, 1, device), mesh)
        return m, {k: p.detach().clone() for k, p in adapter.items()}

    plain, plain_w = step(None)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'rendezvous')}", world_size=1,
                                rank=0)
        try:
            mesh = create_mesh(device=device)
            backend = dist.get_backend(mesh.groups["data"])
            ranked, ranked_w = step(mesh)
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    equal = (torch.equal(plain["loss"], ranked["loss"]) and torch.equal(plain["grad_norm"], ranked["grad_norm"])
             and all(torch.equal(plain_w[k], ranked_w[k]) for k in plain_w))
    log(f"NCCL one rank ({backend} group over {mesh.shape}): loss {ranked['loss'].item():.8g} vs "
        f"{plain['loss'].item():.8g} without a process group, grad_norm {ranked['grad_norm'].item():.8g} vs "
        f"{plain['grad_norm'].item():.8g}; {len(plain_w)} adapter matrices; bit-equal: {equal}")
    if backend != "nccl" or not equal:
        raise RuntimeError("the one-rank NCCL step differs from the step without a process group")
    del modules, adapter, start, micro
    torch.cuda.empty_cache()
    return {"backend": backend, "loss": ranked["loss"].item(), "grad_norm": ranked["grad_norm"].item(),
            "bit_equal": equal}


def distributed_phase(device, bf16_runs) -> dict:
    """Phase 23: (a) ``nccl_one_rank``; (b) two ranks on the one card over
    gloo (``dist_worker``, this script with ``--dist-rank``), then the
    one-process references here: the training at B = 2 x DIST_B (loss and
    gradient norm within 1e-2 relative), the batch-2 edit request whose row
    r each rank's clip must meet by ``check_quality``, one request on the
    ``force_xla_core`` route (the same limits for the tensor-parallel clip;
    against phase 6's request 0 on the kernels as information), and the MAE
    steps at B = 2 x DIST_B (loss within 1e-4 relative)."""

    import shutil

    import numpy as np
    import torch

    from ap_adapter_torch.adapter.params import init_adapter_from_text_kv
    from ap_adapter_torch.configs import PipelineConfig, get_task_config
    from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline, PipelineModules
    from ap_adapter_torch.pipeline.tokenize import make_text_batch
    from ap_adapter_torch.train.loop import train

    one_rank = nccl_one_rank(device)

    dist_dir = os.path.join(ROOT, "build", "dist_smoke")
    shutil.rmtree(dist_dir, ignore_errors=True)
    os.makedirs(dist_dir)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist-rank", str(r), dist_dir],
                              stdout=open(os.path.join(dist_dir, f"rank{r}.log"), "w"), stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        codes = [p.wait(timeout=DIST_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r in range(2):
        for line in open(os.path.join(dist_dir, f"rank{r}.log")).read().splitlines()[-40:]:
            log(f"  rank {r}: {line[:400]}")
    if codes != [0, 0]:
        raise RuntimeError(f"phase 23 ranks exited {codes}")
    ranks = [json.load(open(os.path.join(dist_dir, f"rank{r}.json"))) for r in range(2)]
    wavs = [np.load(os.path.join(dist_dir, f"rank{r}.npz")) for r in range(2)]
    metrics = [json.loads(line) for line in open(os.path.join(dist_dir, "train", "metrics.jsonl"))]
    if [m["step"] for m in metrics] != list(range(1, DIST_STEPS + 1)):
        raise RuntimeError(f"rank 0's metrics.jsonl holds steps {[m['step'] for m in metrics]}")

    config = PipelineConfig()
    result = {"nccl_one_rank": one_rank, "ranks": ranks}

    # one process at the global batch: training
    modules = PipelineModules(config).init_random(42, device=device)
    init_adapter_from_text_kv(modules.unet)
    batches = [{k: v.to(device) for k, v in mb.items()}
               for mb in dist_train_batches(config, DIST_ACCUM, DIST_STEPS, 2 * DIST_B)]
    state = train(modules, iter(batches), dist_train_config(), os.path.join(dist_dir, "train_one"), log_every=1)
    del modules, batches
    torch.cuda.empty_cache()
    rel = []
    for i, m in enumerate(state.history):
        for r in ranks:
            got = r["train"]["steps"][i]
            rel += [abs(got[k] - m[k]) / abs(m[k]) for k in ("loss", "grad_norm")]
        log(f"DP training step {i + 1}: ranks {[r['train']['steps'][i]['seconds'] for r in ranks]} s, peak "
            f"{[r['train']['steps'][i]['max_memory_allocated'] / 2**30 for r in ranks]} GiB, loss "
            f"{ranks[0]['train']['steps'][i]['loss']:.8g}, grad_norm {ranks[0]['train']['steps'][i]['grad_norm']:.8g}; "
            f"one process at B={2 * DIST_B}: {m['seconds']:.3f} s, {m['max_memory_allocated'] / 2**30:.3f} GiB, "
            f"loss {m['loss']:.8g}, grad_norm {m['grad_norm']:.8g}")
    log(f"DP training against one process: largest relative difference {max(rel):.4g} (limit 1e-2)")
    if max(rel) > 1e-2:
        raise RuntimeError("data-parallel training differs from one process at the global batch")
    result["train_one_process"] = state.history
    result["train_max_rel_diff"] = max(rel)

    # one process: the batch-2 edit request of the ranks' rows
    task = get_task_config("timbre_transfer")
    pipe = AudioLDM2Pipeline(config, PipelineModules(config).init_random(0, device=device))
    fbank = np.concatenate([np.random.default_rng(r).standard_normal((1, *config.audiomae.img_size))
                            for r in range(2)]).astype(np.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref = pipe.generate(make_text_batch(config, [task.positive_text_prompts[0]] * 2),
                        make_text_batch(config, [task.negative_text_prompts[0]] * 2), fbank,
                        audio_length_in_s=task.audio_length_in_s, num_inference_steps=task.num_inference_steps,
                        guidance_scale=task.guidance_scale, ap_scale=task.ap_scale, time_pool=task.time_pooling,
                        freq_pool=task.freq_pooling, seed=0)
    result["serve_one_process"] = {"seconds": time.perf_counter() - t0,
                                   "max_memory_allocated": torch.cuda.max_memory_allocated()}
    del pipe
    torch.cuda.empty_cache()
    result["serve_quality"] = [check_quality(f"DP rank {r}'s clip vs row {r} of one process's batch of 2",
                                             wavs[r]["serve"], ref[r: r + 1], config.mel) for r in range(2)]

    # one process on the route the tensor-parallel ranks take
    xla = config.replace(unet=dataclasses.replace(config.unet, force_xla_core=True))
    pipe = AudioLDM2Pipeline(xla, PipelineModules(xla).init_random(0, device=device))
    xla_run = slice_phase(pipe, device, requests=1)[0]
    del pipe
    torch.cuda.empty_cache()
    result["tp_one_process"] = {k: xla_run[k] for k in ("seconds", "max_memory_allocated")}
    result["tp_quality"] = [check_quality(f"TP rank {r}'s clip vs one process on force_xla_core", wavs[r]["tp"],
                                          xla_run["wav"], config.mel) for r in range(2)]
    result["tp_vs_kernel_route"] = quality_figures(wavs[0]["tp"], bf16_runs[0]["wav"], config.mel)
    log(f"TP request: ranks {[r['tp']['seconds'] for r in ranks]} s, peak "
        f"{[r['tp']['max_memory_allocated'] / 2**30 for r in ranks]} GiB, {ranks[0]['tp']['sharded']} parameters "
        f"split; one process on the same route {xla_run['seconds']:.3f} s, "
        f"{xla_run['max_memory_allocated'] / 2**30:.3f} GiB; against phase 6's request 0 on the kernels "
        f"(information): {result['tp_vs_kernel_route']}")

    # one process: MAE pretraining at the global batch
    mae_one = mae_run(device, mae_fbanks())
    mae_rel = max(abs(r["mae"][i]["loss"] - m["loss"]) / abs(m["loss"]) for r in ranks for i, m in enumerate(mae_one))
    log(f"MAE DP: losses {[m['loss'] for m in ranks[0]['mae']]} (ranks) vs {[m['loss'] for m in mae_one]} (one "
        f"process at B={2 * DIST_B}), largest relative difference {mae_rel:.4g} (limit 1e-4); steps "
        f"{[m['seconds'] for m in ranks[0]['mae']]} s vs {[m['seconds'] for m in mae_one]} s")
    if mae_rel > 1e-4:
        raise RuntimeError("data-parallel MAE pretraining differs from one process")
    result["mae_one_process"] = mae_one
    result["mae_max_rel_diff"] = mae_rel
    return result


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--dist-rank":      # a rank of phase 23, started by the phase
        sys.path.insert(0, ROOT)
        return dist_worker(int(sys.argv[2]), sys.argv[3])
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

    phases = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        phases[name] = time.perf_counter() - t0
        log(f"phase {name}: {phases[name]:.1f} s")
        return out

    config = PipelineConfig()
    phase("build", build_phase)
    kernels = phase("kernels", kernel_phase, device)
    kernels.update(phase("training kernels", train_kernel_phase, device))
    kernels.update(phase("int8 kernels", int8_kernel_phase, device))
    kernels.update(phase("resnet kernels", resnet_kernel_phase, device, config.unet))
    kernels.update(phase("dual-KV kernel", dual_kv_kernel_phase, device))

    if expected_launches(config.unet) != {"fused_ln_self_attention": 192,
                                          "fused_ln_cross_attention_kv": 64, "fused_ln_geglu_ff": 128}:
        raise RuntimeError("unexpected UNet routing at full width")
    t0 = time.perf_counter()
    pipe = AudioLDM2Pipeline.from_random(config, seed=0, device=device, dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in pipe.modules.parameters())
    log(f"random weights: {n_params / 1e6:.1f}M params in {time.perf_counter() - t0:.1f} s")
    phase("reference", reference_phase, pipe.modules, device)
    runs = phase("edit slice", slice_phase, pipe, device)
    int8_runs, int8_quality = phase("int8 edit slice", int8_slice_phase, pipe.modules, runs, device)
    switch_runs = phase("resnet-kernel edit slices", switch_slice_phase, pipe.modules, runs, device)
    k10_pipe, k10_run = phase("K10 edit slice", k10_slice_phase, pipe.modules, runs, device)
    v1 = phase("v1 edit slice", v1_slice_phase, device)
    cn = phase("ControlNet-branch edit slice", cn_slice_phase, pipe.modules, device)
    scorer = clap_scorer(pipe, device)
    ranked = phase("re-ranking", ranked_phase, k10_pipe, scorer, device)
    del k10_pipe
    evaluation = phase("eval runner", eval_phase, pipe, scorer, device)
    del scorer
    task_runs = phase("task CLI", tasks_phase, pipe, device)
    converted = phase("checkpoint conversion", convert_phase, pipe, device)
    train_ref = phase("training reference", train_reference_phase, pipe.modules, device)
    del pipe
    torch.cuda.empty_cache()
    training = phase("training slice", train_slice_phase, device)
    training_ii = phase("training slice II", train_slice_ii_phase, device, training)
    wav_batch = phase("batched wav loader", wav_batch_phase, training_ii["data"])
    mae = phase("MAE pretraining", mae_phase, device, training_ii["data"])
    distributed = phase("distributed", distributed_phase, device, runs)

    total = {k: sum(r["launches"][k] for r in runs) for k in EDIT_KERNELS + ("self_attention",)}
    total.update({k: training["launches"][k] for k in TRAIN_KERNELS})
    total.update({k: sum(r["launches"][k] for r in int8_runs) for k in INT8_KERNELS})
    total["group_norm_silu"] = switch_runs["use_pallas_groupnorm"]["launches"]["group_norm_silu"]
    total["fused_resnet_block"] = switch_runs["use_pallas_resnet"]["launches"]["fused_resnet_block"]
    total["dual_kv_attention"] = k10_run["launches"]["dual_kv_attention"]

    def brief(run):
        return {k: run[k] for k in ("seconds", "max_memory_allocated") + tuple(
            q for q in ("logmel_cosine", "logmel_mean_abs_diff", "wav_rel_err") if q in run)}

    report = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu, "launches": total[name],
         "max_abs_err": kernels[name]["max_abs_err"], "ms": kernels[name]["ms"],
         "plain_ms": kernels[name]["plain_ms"], "bound_ms": kernels[name]["bound_ms"],
         "bound_by": ("operations" if sum(ops_ms(cs["flops"], cs["int8_ops"]) for cs in kernels[name]["cases"])
                      >= sum(cs["bytes"] for cs in kernels[name]["cases"]) / PEAK_BYTES * 1e3 else "bytes"),
         "library_ms": kernels[name]["library_ms"], "library_cases_ms": kernels[name]["library_cases_ms"],
         **{k: kernels[name][k] for k in ("two_sdpa_ms",) if k in kernels[name]}, "cases": kernels[name]["cases"]}
        for name, (src, tpu) in KERNELS.items()],
        "requests": [brief(r) for r in runs],
        "int8_requests": [brief(r) for r in int8_runs], "int8_quality": int8_quality,
        "resnet_kernel_requests": {k: brief(r) for k, r in switch_runs.items()},
        "task_cli": {k: brief(r) for k, r in task_runs.items()}, "convert": converted,
        "k10_request": brief(k10_run), "v1_reference_rel_err": v1["reference_rel_err"],
        "v1_requests": [{**brief(r), "v1_memory": r["v1_memory"],
                         "launches": {k: n for k, n in r["launches"].items() if n}} for r in v1["requests"]],
        "cn_requests": [{**brief(r), "launches": {k: n for k, n in r["launches"].items() if n}}
                        for r in cn["requests"]],
        "cn_bit_equal": cn["bit_equal_under_a_changed_audio_prompt"], "generate_ranked": ranked, "eval": evaluation,
        "training_launches": {k: training["launches"][k] for k in KERNELS},
        "training_steps": training["steps"], "training_reference": train_ref,
        "training_ii": {k: training_ii[k] for k in ("launches", "per_micro_step", "validation_round", "steps",
                                                     "step1_rel_diff", "validation_files", "tensorboard_events")},
        "wav_batch": wav_batch, "mae_pretrain": mae, "distributed": distributed, "phase_seconds": phases}
    if min(total.values()) <= 0 or set(cuda_kernels.LAUNCHES) != set(KERNELS):
        raise RuntimeError(f"a kernel of the path was not launched: {total}")
    print(json.dumps(report), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
