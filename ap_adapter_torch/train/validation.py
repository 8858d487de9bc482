"""Validation sampling during training.

Counterpart of ``ap_adapter_tpu/train/validation.py`` (the reference's
``log_validation``, train_apadapter_v2.py:483-528): every
``validation_steps`` pick random training clips and a pooling rate, run the
whole edit pipeline with the current adapter, and write the generated wavs,
the conditioning originals and the captions under
``<output_dir>/validation/`` for listening.

The trainer holds the adapter matrices as fp32 parameters inside a bf16
UNet; every path of the UNet casts them to the compute dtype where it uses
them (``CrossAttention.project_kv`` for the hoisted K/V), so a round
generates with the bf16 values of the current adapter, as the JAX package
does with ``cast_params_to``, and leaves the fp32 weights, their gradients
and the optimizer state as they were. A round draws only from its own
``random.Random(seed)`` and a generator seeded from it, never from the
training noise stream.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

from ap_adapter_torch.audio.fbank import audiomae_fbank
from ap_adapter_torch.audio.io import save_wav
from ap_adapter_torch.pipeline.tokenize import make_text_batch
from ap_adapter_torch.train.data import POOL_CHOICES


def make_validation_fn(modules, dataset, output_dir: str, tokenizers=None, num_inference_steps: int = 50,
                       guidance_scale: float = 7.5, ap_scale: float = 0.5, audio_length_in_s: float = 10.0,
                       seed: int = 0, negative_prompt: str = "low quality, average quality", num_files: int = 1):
    """A ``validation_fn(step) -> path`` for ``train.loop.train``.

    ``dataset`` is any indexable of (caption, 16 kHz waveform) pairs (e.g.
    ``train.data.AudioSetDataset``). Each round draws, in the JAX package's
    order from one ``random.Random(seed)``: ``num_files`` (at most
    ``len(dataset)``) clip indices, the pooling rate among the
    ``POOL_CHOICES`` that divide the AudioMAE grid, and the generate's seed;
    then it generates the clips in one batched ``generate``. Returns the
    path of the first generated wav."""

    from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline

    cfg = modules.config
    val_dir = os.path.join(output_dir, "validation")
    os.makedirs(val_dir, exist_ok=True)
    rng = random.Random(seed)
    pipe = AudioLDM2Pipeline(cfg, modules)

    @torch.no_grad()
    def validation_fn(step: int) -> str:
        n = max(1, min(num_files, len(dataset)))
        picks = [dataset[rng.randrange(len(dataset))] for _ in range(n)]
        captions = [c for c, _ in picks]
        gt, gf = cfg.audiomae.grid_size
        pool = rng.choice([p for p in POOL_CHOICES if gt % p == 0 and gf % p == 0])

        waves = torch.as_tensor(np.stack([np.asarray(w, np.float32) for _, w in picks]), device=modules.device)
        fbank = audiomae_fbank(waves, cfg.fbank)
        # crop or pad to the encoder's grid (a no-op at full width, where the
        # fbank target is the encoder's (1024, 128))
        t, f = cfg.audiomae.img_size
        fbank = fbank[:, :t, :f]
        fbank = torch.nn.functional.pad(fbank, (0, f - fbank.shape[2], 0, t - fbank.shape[1]))
        text_pos = make_text_batch(cfg, captions, tokenizers)
        text_neg = make_text_batch(cfg, [negative_prompt] * n, tokenizers)
        out = pipe.generate(text_pos, text_neg, fbank, audio_length_in_s=audio_length_in_s,
                            num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
                            ap_scale=ap_scale, time_pool=pool, freq_pool=pool, seed=rng.randrange(2**31))
        sr = cfg.vocoder.sampling_rate
        for i in range(n):
            suffix = "" if i == 0 else f"_{i}"
            save_wav(os.path.join(val_dir, f"step{step}_pool{pool}{suffix}.wav"), out[i], sr)
            save_wav(os.path.join(val_dir, f"step{step}_original{suffix}.wav"), np.asarray(picks[i][1]), sr)
        with open(os.path.join(val_dir, f"step{step}_caption.txt"), "w") as fh:
            fh.write("\n".join(captions) + f"\n(pool={pool})\n")
        return os.path.join(val_dir, f"step{step}_pool{pool}.wav")

    return validation_fn
