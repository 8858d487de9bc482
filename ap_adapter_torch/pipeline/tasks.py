"""Task-level API and CLI: timbre transfer, style transfer (also by SDEdit),
accompaniment.

Counterpart of ``ap_adapter_tpu/pipeline/tasks.py`` (the reference
``python inference.py --task <task>``): builds the pipeline, loads the flat
adapter checkpoint, loops the template's prompts and writes 16 kHz wavs
under the reference's file names. Runs on the card (``--device``, default
``cuda``)::

    python -m ap_adapter_torch.pipeline.tasks --task timbre_transfer \\
        --audio-prompt clip.wav --random-weights --output-dir out
    python -m ap_adapter_torch.pipeline.tasks --task style_transfer --sdedit \\
        --audio-prompt clip.wav --random-weights --output-dir out

``--checkpoint-dir`` names a directory of ``<submodel>.npz`` HF/diffusers
state dicts, as ``train/cli.py`` reads them; where it holds ``tokenizer/``
and ``tokenizer_2/``, prompts go through those transformers tokenizers
(``pipeline/tokenize.py::HFTokenizers``), else through the hash tokenizer.
``--tensor-parallel N`` serves each request on N ranks, the UNet's
transformer stacks split by heads over them (``parallel/tp.py``); start one
process per rank, e.g. ``torchrun --nproc-per-node N -m
ap_adapter_torch.pipeline.tasks --tensor-parallel N ...``. Rank 0 alone
writes the wavs.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ap_adapter_torch.adapter.params import import_flat_adapter
from ap_adapter_torch.audio.io import load_wav, save_wav
from ap_adapter_torch.configs import PipelineConfig, TaskConfig, get_task_config, tiny_pipeline_config
from ap_adapter_torch.parallel.distributed import maybe_initialize, process_count, process_index
from ap_adapter_torch.parallel.mesh import create_mesh
from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline, PipelineModules
from ap_adapter_torch.pipeline.tokenize import HFTokenizers, make_text_batch


def load_pipeline(
    config: PipelineConfig,
    checkpoint_dir: Optional[str] = None,
    adapter_ckpt: Optional[str] = None,
    seed: int = 0,
    tensor_parallel: int = 1,
    device="cuda",
) -> AudioLDM2Pipeline:
    """The pipeline from a directory of ``<submodel>.npz`` state dicts, or
    with random weights from ``seed`` when none is given. The flat adapter
    (``.npz`` or the reference ``.bin``) is copied into the UNet's own
    tensors, so it lands on the UNet's device and dtype.

    ``tensor_parallel`` N > 1 joins the N ranks' process group
    (``parallel/distributed.py::maybe_initialize``), whose world must be N,
    and serves each request over a (1, N) mesh (JAX tasks.py:20-76); the
    weights and the adapter are loaded whole, then sharded."""

    mesh = None
    if tensor_parallel > 1:
        maybe_initialize(device)
        if process_count() != tensor_parallel:
            raise ValueError(f"--tensor-parallel {tensor_parallel} needs a world of {tensor_parallel} ranks, "
                             f"this one has {process_count()}")
        mesh = create_mesh(data=1, model=tensor_parallel, device=device)
        device = mesh.device
    modules = PipelineModules(config)
    if checkpoint_dir:
        sds = {}
        for name in PipelineModules.NAMES:
            with np.load(os.path.join(checkpoint_dir, f"{name}.npz")) as f:
                sds[name] = {k: f[k] for k in f.files}
        modules.load_state_dicts(sds, device=device)
    else:
        modules.init_random(seed, device=device)
    if adapter_ckpt:
        import_flat_adapter(modules.unet, _load_flat_adapter(adapter_ckpt))
    return AudioLDM2Pipeline(config, modules, mesh=mesh, tensor_parallel=mesh is not None)


def _load_flat_adapter(path: str) -> Dict[str, np.ndarray]:
    """Flat adapter dict from ``.npz`` (ours) or a torch ``.bin`` (the reference format)."""

    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float().numpy() for k, v in sd.items()}


def _output_name(task: TaskConfig, prompt: str, j: int, suffix: str = "") -> str:
    # the reference names files by the prompt's first character (inference.py:67-81)
    return f"{prompt[0]}_{j}_ip{task.ap_scale}_t{task.time_pooling}_f{task.freq_pooling}{suffix}.wav"


def _text_batches(task: TaskConfig, cfg: PipelineConfig, prompt: str, tokenizers):
    neg_prompt = task.negative_text_prompts[0] if task.negative_text_prompts else ""
    return (make_text_batch(cfg, [prompt] * task.num_files, tokenizers),
            make_text_batch(cfg, [neg_prompt] * task.num_files, tokenizers))


def _writer() -> bool:
    """Whether this process writes the outputs: rank 0, or the only process."""

    return process_index() == 0


def run_task(task: TaskConfig, pipe: AudioLDM2Pipeline, tokenizers: Optional[HFTokenizers] = None) -> List[str]:
    """Execute one task template; returns the wav paths (the reference's
    file naming), which rank 0 alone writes. ``tokenizers``: a
    checkpoint's, else the hash tokenizer."""

    write = _writer()
    if write:
        os.makedirs(task.output_dir, exist_ok=True)
    cfg = pipe.config
    fbank = None
    if task.audio_prompt_file:
        wav, sr = load_wav(task.audio_prompt_file)
        fb = pipe.prepare_fbank(wav, sr)
        fbank = fb.expand(task.num_files, *fb.shape[1:]).contiguous()
    written = []
    for prompt in task.positive_text_prompts:
        pos, neg = _text_batches(task, cfg, prompt, tokenizers)
        wavs = pipe.generate(pos, neg, fbank, audio_length_in_s=task.audio_length_in_s,
                             num_inference_steps=task.num_inference_steps, guidance_scale=task.guidance_scale,
                             ap_scale=task.ap_scale, time_pool=task.time_pooling, freq_pool=task.freq_pooling)
        for j in range(task.num_files):
            path = os.path.join(task.output_dir, _output_name(task, prompt, j))
            if write:
                save_wav(path, wavs[j], cfg.vocoder.sampling_rate)
            written.append(path)
    return written


def run_sdedit_task(task: TaskConfig, pipe: AudioLDM2Pipeline,
                    tokenizers: Optional[HFTokenizers] = None) -> List[str]:
    """The SDEdit route of style transfer (``pipeline/style_transfer.py``):
    the source clip's latent noised to mid-schedule, the truncated DDIM tail,
    wavs named as ``run_task`` names them, with ``_sdedit``."""

    from ap_adapter_torch.pipeline.style_transfer import generate_style_transfer

    if not task.audio_prompt_file:
        raise ValueError("--sdedit requires --audio-prompt (the source clip whose latent seeds the "
                         "truncated schedule)")
    write = _writer()
    if write:
        os.makedirs(task.output_dir, exist_ok=True)
    cfg = pipe.config
    wav, sr = load_wav(task.audio_prompt_file)
    written = []
    for prompt in task.positive_text_prompts:
        pos, neg = _text_batches(task, cfg, prompt, tokenizers)
        wavs = generate_style_transfer(
            pipe, wav, sr, pos, neg, audio_length_in_s=task.audio_length_in_s,
            num_inference_steps=task.num_inference_steps, guidance_scale=task.guidance_scale,
            ap_scale=task.ap_scale, time_pool=task.time_pooling, freq_pool=task.freq_pooling)
        for j in range(task.num_files):
            path = os.path.join(task.output_dir, _output_name(task, prompt, j, "_sdedit"))
            if write:
                save_wav(path, wavs[j], cfg.vocoder.sampling_rate)
            written.append(path)
    return written


def main(argv=None) -> List[str]:
    """Parse the JAX CLI's flags (and ``--device``), run the task, print and
    return the written paths."""

    import argparse

    parser = argparse.ArgumentParser(description="AP-adapter inference (PyTorch)")
    parser.add_argument("--task", default="timbre_transfer",
                        choices=["timbre_transfer", "style_transfer", "accompaniment_generation", "test"])
    parser.add_argument("--audio-prompt", default="", help="reference wav file")
    parser.add_argument("--checkpoint-dir", default="", help="directory of <submodel>.npz state dicts")
    parser.add_argument("--adapter-ckpt", default="", help="flat adapter ckpt (.npz or .bin)")
    parser.add_argument("--output-dir", default="output")
    parser.add_argument("--num-files", type=int, default=1)
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--random-weights", action="store_true", help="run with random weights (smoke/benchmark)")
    parser.add_argument("--sdedit", action="store_true",
                        help="style_transfer only: edit via the SDEdit truncated-schedule path (source latent "
                        "noised to mid-schedule) instead of full text-to-audio generation; requires "
                        "--audio-prompt")
    parser.add_argument("--tiny", action="store_true",
                        help="tiny smoke config instead of the full model (CPU smoke runs)")
    parser.add_argument("--audio-length", type=float, default=None,
                        help="output length in seconds (default: task template)")
    parser.add_argument("--prompt", default="",
                        help="override the task template's prompt list with this single positive prompt")
    parser.add_argument("--time-pool", type=int, default=None, help="override the task template's time pooling")
    parser.add_argument("--freq-pool", type=int, default=None, help="override the task template's freq pooling")
    parser.add_argument("--tensor-parallel", type=int, default=1,
                        help="serve each request on N ranks, the UNet split by heads over them (one process a "
                        "rank; N must divide the heads and equal the world size)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    if args.sdedit and args.task != "style_transfer":
        parser.error("--sdedit is only valid with --task style_transfer")
    tokenizers = None
    if args.checkpoint_dir and os.path.isdir(os.path.join(args.checkpoint_dir, "tokenizer")):
        tokenizers = HFTokenizers(args.checkpoint_dir)

    overrides = {}
    if args.audio_length is not None:
        overrides["audio_length_in_s"] = args.audio_length
    if args.prompt:
        overrides["positive_text_prompts"] = (args.prompt,)
    if args.time_pool is not None:
        overrides["time_pooling"] = args.time_pool
    if args.freq_pool is not None:
        overrides["freq_pooling"] = args.freq_pool
    task = get_task_config(args.task, output_dir=args.output_dir, audio_prompt_file=args.audio_prompt,
                           adapter_ckpt=args.adapter_ckpt, num_files=args.num_files,
                           num_inference_steps=args.steps, **overrides)
    config = tiny_pipeline_config() if args.tiny else PipelineConfig()
    pipe = load_pipeline(config, checkpoint_dir=args.checkpoint_dir or None,
                         adapter_ckpt=args.adapter_ckpt or None, tensor_parallel=args.tensor_parallel,
                         device=args.device)
    paths = (run_sdedit_task if args.sdedit else run_task)(task, pipe, tokenizers)
    for p in paths:
        print(p)
    return paths


if __name__ == "__main__":
    main()
