"""Batched evaluation runner: a sweep of clips through a task template, its
throughput, and FAD.

Counterpart of ``ap_adapter_tpu/eval/runner.py``. Two FAD numbers come out of
``run_eval_protocol`` (the paper's protocol, reference README.md:5-10 and the
frechet-audio-distance tooling):

- ``fad_<domain>``: the generated set against that domain's REFERENCE set,
  the paper-comparable quality number;
- ``fad_faithfulness_<domain>``: the generated set against its own SOURCE
  clips (how far the edit strayed; not in the paper).

The embedding space is the CLAP audio tower (a ``ClapScorer``), VGGish (a
``VggishEmbedder``) or, without either, the pipeline's AudioMAE. Runs on the
card unless asked (``--device``)::

    python -m ap_adapter_torch.eval.runner --clip-dirs clips/ --batch-size 8
    python -m ap_adapter_torch.eval.runner --in-domain-dirs eval_audio_in_domain \\
        --out-of-domain-dirs eval_audio_out_of_domain --vggish-ckpt vggish.pt

The functions take a checkpoint's ``HFTokenizers`` (``tokenizers=``), as
JAX's do; without them, and from the CLI (JAX's builds none either),
prompts go through the hash tokenizer.
"""

from __future__ import annotations

import glob
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ap_adapter_torch.audio.io import load_wav, save_wav
from ap_adapter_torch.configs import TaskConfig
from ap_adapter_torch.eval.metrics import audiomae_clip_embedding, clap_audio_embeddings, fad
from ap_adapter_torch.pipeline.tokenize import make_text_batch


def eval_clips(dirs: List[str]) -> List[str]:
    paths: List[str] = []
    for d in dirs:
        paths.extend(sorted(glob.glob(os.path.join(d, "*.wav"))))
    return paths


def _embed_wavs(pipe, scorer, wavs_with_sr) -> np.ndarray:
    """[(wav, sr), ...] -> [N, D], each clip embedded at its own sample rate.
    ``scorer``: a ClapScorer, anything with ``.embed(wavs, sr)`` (a
    VggishEmbedder), or None (AudioMAE)."""

    if scorer is None:
        return np.stack([audiomae_clip_embedding(pipe, w, sr) for w, sr in wavs_with_sr])
    embed = scorer.embed if hasattr(scorer, "embed") else (
        lambda wavs, sr: clap_audio_embeddings(scorer, wavs, sr))
    out, i = [], 0
    while i < len(wavs_with_sr):          # runs of consecutive clips at one rate
        sr, j = wavs_with_sr[i][1], i
        while j < len(wavs_with_sr) and wavs_with_sr[j][1] == sr:
            j += 1
        out.append(embed([w for w, _ in wavs_with_sr[i:j]], sr))
        i = j
    return np.concatenate(out)


def _space_name(scorer) -> str:
    """Suffix of the fad_* result keys."""

    if scorer is None:
        return "audiomae"
    return "vggish" if hasattr(scorer, "embed") else "clap"


def run_batched_eval(pipe, clip_paths: List[str], task: TaskConfig, batch_size: int = 8,
                     compute_fad: bool = True, output_dir: Optional[str] = None, scorer=None,
                     return_embeddings: bool = False, tokenizers=None):
    """Edit every clip (prompt: the task's first positive prompt) in batches
    of ``batch_size`` (a trailing partial batch is left out, as in JAX);
    returns {n, clips_per_s, fad_<space>} and optionally writes the edits as
    ``<name>_edit.wav``.

    The FAD here is source against edit. Throughput is the sustained rate:
    each batch is dispatched without waiting for its waveforms
    (``generate(materialize=False)``), and batch i-1 is read back, which
    synchronises with the card, after batch i was dispatched, so the next
    batch's host work (fbank DSP, tokens, launches) overlaps the device. The
    clock spans the dispatch of batch 2 (batch 1 pays the warm-up) to the
    readback of the last batch; FAD embedding and wav writing are outside
    it. ``return_embeddings`` also returns (source, edit) embeddings."""

    cfg = pipe.config
    prompt = task.positive_text_prompts[0]
    neg = task.negative_text_prompts[0] if task.negative_text_prompts else ""
    pos_b = make_text_batch(cfg, [prompt] * batch_size, tokenizers)
    neg_b = make_text_batch(cfg, [neg] * batch_size, tokenizers)
    gen_kwargs = dict(audio_length_in_s=task.audio_length_in_s, num_inference_steps=task.num_inference_steps,
                      guidance_scale=task.guidance_scale, ap_scale=task.ap_scale, time_pool=task.time_pooling,
                      freq_pool=task.freq_pooling, materialize=False)

    src_wavs, edits, names = [], [], []
    t0, in_flight, n_done, wall = None, None, 0, 0.0
    for i in range(0, len(clip_paths) - batch_size + 1, batch_size):
        batch_paths = clip_paths[i:i + batch_size]
        fbanks = []
        for p in batch_paths:
            wav, sr = load_wav(p)
            fbanks.append(pipe.prepare_fbank(wav, sr)[0])
            if compute_fad:
                src_wavs.append((wav, sr))
        wavs = pipe.generate(pos_b, neg_b, torch.stack(fbanks), seed=i, **gen_kwargs)
        if n_done == 0:      # the warm-up batch: read back now, untimed
            edits.append(wavs.cpu().numpy())
            t0 = time.perf_counter()
        else:
            if in_flight is not None:
                edits.append(in_flight.cpu().numpy())
            in_flight = wavs
        names.extend(os.path.basename(p) for p in batch_paths)
        n_done += batch_size
    if in_flight is not None:
        edits.append(in_flight.cpu().numpy())
        wall = time.perf_counter() - t0
    edits = [w for batch in edits for w in batch]

    sr_out = cfg.vocoder.sampling_rate
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        for name, w in zip(names, edits):
            save_wav(os.path.join(output_dir, name.replace(".wav", "_edit.wav")), w, sr_out)

    result = {"n": n_done, "clips_per_s": (n_done - batch_size) / wall if wall > 0 else float("nan")}
    src_e = gen_e = None
    if compute_fad and n_done > 1:
        src_e = _embed_wavs(pipe, scorer, src_wavs)
        gen_e = _embed_wavs(pipe, scorer, [(w, sr_out) for w in edits])
        result[f"fad_{_space_name(scorer)}"] = fad(src_e, gen_e)
    if return_embeddings:
        return result, src_e, gen_e
    return result


def run_eval_protocol(pipe, domains: dict, task: TaskConfig, batch_size: int = 8,
                      output_dir: Optional[str] = None, scorer=None, tokenizers=None) -> dict:
    """The paper's FAD protocol. ``domains``: {name: {"source": [dirs],
    "reference": [dirs]}}; every SOURCE clip is edited with the task
    template, then ``fad_<name>`` (REFERENCE-set embeddings against the
    edits'), ``fad_faithfulness_<name>`` (source against edits), ``n_<name>``,
    ``n_total`` and the mean ``clips_per_s`` of the domains that timed one."""

    space = _space_name(scorer)
    out = {"embedding_space": {"clap": "clap_audio"}.get(space, space),
           "task": getattr(task, "name", None) or "custom"}
    total, rates = 0, []
    for name, spec in domains.items():
        clips = eval_clips(spec["source"])
        if not clips:
            continue
        res, src_e, gen_e = run_batched_eval(
            pipe, clips, task, batch_size=batch_size, compute_fad=True,
            output_dir=os.path.join(output_dir, name) if output_dir else None, scorer=scorer,
            return_embeddings=True, tokenizers=tokenizers)
        if gen_e is not None:
            ref_paths = eval_clips(spec.get("reference", spec["source"]))
            ref_e = src_e if ref_paths == clips else _embed_wavs(pipe, scorer, [load_wav(p) for p in ref_paths])
            out[f"fad_{name}"] = fad(ref_e, gen_e)
            out[f"fad_faithfulness_{name}"] = res.get(f"fad_{space}")
        out[f"n_{name}"] = res["n"]
        total += res["n"]
        if np.isfinite(res["clips_per_s"]):
            rates.append(res["clips_per_s"])
    out["n_total"] = total
    if rates:
        out["clips_per_s"] = float(np.mean(rates))
    return out


def build_parser():
    """The JAX runner's flags plus ``--device``."""

    import argparse

    p = argparse.ArgumentParser(description="batched eval sweep (PyTorch)")
    p.add_argument("--clip-dirs", nargs="+", default=None,
                   help="flat sweep over these dirs (throughput + faithfulness FAD only)")
    p.add_argument("--in-domain-dirs", nargs="+", default=None,
                   help="protocol mode: in-domain source+reference set (e.g. eval_audio_in_domain)")
    p.add_argument("--out-of-domain-dirs", nargs="+", default=None,
                   help="protocol mode: out-of-domain source set; its reference set is --in-domain-dirs")
    p.add_argument("--task", default="timbre_transfer")
    p.add_argument("--checkpoint-dir", default="", help="directory of <submodel>.npz state dicts")
    p.add_argument("--adapter-ckpt", default="")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--output-dir", default="")
    p.add_argument("--no-fad", action="store_true")
    p.add_argument("--vggish-ckpt", default="", help="torchvggish .pt state dict: FAD in the paper's VGGish "
                   "space instead of the CLAP audio tower (eval/vggish.py)")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> dict:
    """CLI: runs the sweep or the protocol and prints the result as JSON."""

    import json

    from ap_adapter_torch.configs import PipelineConfig, get_task_config
    from ap_adapter_torch.pipeline.tasks import load_pipeline

    p = build_parser()
    args = p.parse_args(argv)
    if not args.in_domain_dirs and not args.clip_dirs:
        p.error("pass --in-domain-dirs (protocol) or --clip-dirs (sweep)")

    config = PipelineConfig()
    pipe = load_pipeline(config, checkpoint_dir=args.checkpoint_dir or None,
                         adapter_ckpt=args.adapter_ckpt or None, device=args.device)
    task = get_task_config(args.task, num_inference_steps=args.steps)

    scorer = None
    clap_audio = os.path.join(args.checkpoint_dir, "clap_audio.npz") if args.checkpoint_dir else ""
    if args.vggish_ckpt:
        from ap_adapter_torch.eval.vggish import VggishEmbedder

        scorer = VggishEmbedder.from_torch_checkpoint(args.vggish_ckpt, device=args.device)
    elif clap_audio and os.path.exists(clap_audio):
        from ap_adapter_torch.configs import ClapAudioConfig
        from ap_adapter_torch.eval.clap_scoring import ClapScorer
        from ap_adapter_torch.models.clap_audio import ClapAudioTower

        tower = ClapAudioTower(ClapAudioConfig())
        with np.load(clap_audio) as f:
            tower.load_state_dict({k: torch.as_tensor(f[k]) for k in f.files})
        scorer = ClapScorer(pipe.modules.clap, tower, device=args.device)

    if args.in_domain_dirs:
        domains = {"in_domain": {"source": args.in_domain_dirs, "reference": args.in_domain_dirs}}
        if args.out_of_domain_dirs:
            domains["out_of_domain"] = {"source": args.out_of_domain_dirs, "reference": args.in_domain_dirs}
        result = run_eval_protocol(pipe, domains, task, batch_size=args.batch_size,
                                   output_dir=args.output_dir or None, scorer=scorer)
    else:
        result = run_batched_eval(pipe, eval_clips(args.clip_dirs), task, batch_size=args.batch_size,
                                  compute_fad=not args.no_fad, output_dir=args.output_dir or None, scorer=scorer)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
