"""Training data: the AudioSet manifest dataset and the on-device collate.

Counterpart of ``ap_adapter_tpu/train/data.py``. The host decodes wavs (a
batch in one call of the C++ thread pool, ``audio/io.py::load_wav_batch``)
and resamples them; the device computes the VAE mel, the AudioMAE fbank,
the frozen text encoders and the pooled AudioMAE tokens, with the
reference's CFG dropout and random pooling rate.

Data-parallel: rank r of ``world`` takes rows ``[r * B, (r + 1) * B)`` of
each global batch of ``B * world`` items in the shared shuffled order, and
the caption, dropout and pooling draws are made for the whole global batch
and kept for the rank's rows, so the ranks together see exactly what one
process at the global batch sees. (The JAX loader, data.py:192-204, has no
rank: every host feeds the same batch.)
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ap_adapter_torch.audio.dsp import resample
from ap_adapter_torch.audio.fbank import audiomae_fbank
from ap_adapter_torch.audio.io import load_wav, load_wav_batch
from ap_adapter_torch.audio.mel import wav_to_vae_mel
from ap_adapter_torch.pipeline.tokenize import make_text_batch

# the reference's caption templates (train_apadapter_v2.py:404-419)
AUDIOSET_TEMPLATES_SMALL = [
    "a recording of a {}",
    "a {} recording",
    "a synthesized {} audio",
    "a cropped recording of the {}",
    "the recording of a {}",
    "my {} recording",
    "the {} recording",
    "a rendition of the {}",
    "a synthesized {} rendition",
    "the sound of a {}",
    "the sound of {}",
    "the voice of {}",
    "the voice of a {}",
    "a voice of the {}",
    "a synthesized {} voice",
]

POOL_CHOICES = (1, 2, 4, 8)


class AudioSetDataset:
    """(caption, waveform) pairs from an AudioSet-style JSON manifest
    ({"data": [{"wav": path, "labels": "a, b"}, ...]}); a caption is a
    random template over the comma-joined labels."""

    def __init__(self, manifest_path: str, data_root: str = "", duration_s: float = 10.0,
                 sample_rate: int = 16_000, seed: int = 0):
        with open(manifest_path) as f:
            manifest = json.load(f)
        self.items = manifest["data"] if isinstance(manifest, dict) else manifest
        self.data_root = data_root
        self.duration_s = duration_s
        self.sample_rate = sample_rate
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> Tuple[str, np.ndarray]:
        item = self.items[idx]
        wav, sr = load_wav(os.path.join(self.data_root, item["wav"]))
        return self._caption(item), self._fit(wav, sr)

    def get_batch(self, idxs: Sequence[int], keep: slice = slice(None)) -> list:
        """``[self[i] for i in idxs[keep]]`` with the wavs decoded in one call
        of the C++ thread pool, each capped at ``duration_s`` x 48 kHz frames
        (enough material for the clip from any rate up to 48 kHz), then
        resampled and padded or cut one by one. A caption is drawn for every
        item of ``idxs`` in order, those outside ``keep`` dropped (a data
        rank's share of a global batch)."""

        captions = [self._caption(self.items[i]) for i in idxs][keep]
        items = [self.items[i] for i in idxs][keep]
        wavs, frames, srs = load_wav_batch([os.path.join(self.data_root, it["wav"]) for it in items],
                                           int(self.duration_s * 48_000))
        return [(captions[i], self._fit(wavs[i, : frames[i]], int(srs[i]))) for i in range(len(items))]

    def _fit(self, wav: np.ndarray, sr: int) -> np.ndarray:
        """Resample to ``sample_rate`` and pad or cut to ``duration_s``."""

        if sr != self.sample_rate and sr > 0:
            wav = resample(torch.from_numpy(np.ascontiguousarray(wav)), sr, self.sample_rate).numpy()
        target = int(self.duration_s * self.sample_rate)
        wav = np.pad(wav, (0, target - wav.shape[-1])) if wav.shape[-1] < target else wav[:target]
        return wav.astype(np.float32)

    def _caption(self, item) -> str:
        labels = item.get("labels") or item.get("caption") or ""
        if isinstance(labels, (list, tuple)):
            labels = ", ".join(str(x) for x in labels)
        return self.rng.choice(AUDIOSET_TEMPLATES_SMALL).format(labels)


class DeviceCollate:
    """Builds train batches on the modules' device: one pooling rate per
    batch from ``pool_choices``, and per sample 5% text dropped, 5% audio
    (fbank zeroed), 5% both; then the frozen text encoders (no CFG) and the
    pooled AudioMAE tokens, concatenated as [GPT-2 ‖ AudioMAE]. The draws
    come from a ``random.Random`` seeded with ``seed``; with ``world`` > 1
    the per-sample draws are made for the global batch of ``world`` x the
    examples and rank ``rank`` keeps its rows."""

    def __init__(self, modules, duration_s: float = 10.0, seed: int = 0,
                 pool_choices: Tuple[int, ...] = POOL_CHOICES, rank: int = 0, world: int = 1):
        self.modules = modules
        self.config = modules.config
        self.target_frames = int(duration_s * self.config.mel.frames_per_second)
        self.rng = random.Random(seed)
        self.pool_choices = pool_choices
        self.rank, self.world = rank, world

    @torch.no_grad()
    def __call__(self, examples: Sequence[Tuple[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
        texts = [t for t, _ in examples]
        pool = self.rng.choice(self.pool_choices)
        audio_drop = np.zeros(len(examples), dtype=bool)
        draws = [self.rng.random() for _ in range(len(texts) * self.world)]
        for i in range(len(texts)):
            r = draws[self.rank * len(texts) + i]
            if r < 0.05:
                texts[i] = ""
            elif r < 0.10:
                audio_drop[i] = True
            elif r < 0.15:
                texts[i] = ""
                audio_drop[i] = True

        cfg, mods = self.config, self.modules
        dev, dtype = mods.device, mods.dtype
        waves = torch.as_tensor(np.stack([w for _, w in examples]), device=dev)
        mel = wav_to_vae_mel(waves, self.target_frames, cfg.mel)[..., None]
        fbank = audiomae_fbank(waves, cfg.fbank)
        fbank = torch.where(torch.as_tensor(audio_drop, device=dev)[:, None, None], 0.0, fbank)
        t5_hidden, t5_mask, gpt2_tokens = mods.encode_prompt(make_text_batch(cfg, texts).to(dev))
        loa = mods.audiomae(fbank.to(dtype), pool, pool)
        return {
            "mel": mel,
            "prompt_embeds": t5_hidden,
            "attention_mask": t5_mask,
            "generated_prompt_embeds": torch.cat([gpt2_tokens, loa.to(gpt2_tokens.dtype)], dim=1),
        }


def data_loader(dataset: AudioSetDataset, batch_size: int, collate: DeviceCollate, seed: int = 0,
                rank: int = 0, world: int = 1):
    """Endless shuffled epochs of collated batches (incomplete last global
    batches dropped), each batch decoded by ``dataset.get_batch``: rank
    ``rank``'s ``batch_size`` rows of each global batch of ``batch_size *
    world`` items, in an order shuffled from ``seed`` alike on every rank."""

    order_rng = random.Random(seed)
    step = batch_size * world
    keep = slice(rank * batch_size, (rank + 1) * batch_size)
    while True:
        idxs = list(range(len(dataset)))
        order_rng.shuffle(idxs)
        for i in range(0, len(idxs) - step + 1, step):
            yield collate(dataset.get_batch(idxs[i: i + step], keep))


def prefetch(batches, depth: int = 2):
    """Runs the loader in a background thread with a bounded queue, so host
    decoding overlaps the train step; errors reach the consumer. Closing the
    returned generator (or dropping it) stops the thread after the batch in
    hand, so the batches it holds, and the modules that the loader's collate
    holds, are released."""

    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()

    def run():
        try:
            for b in batches:
                if stop.is_set():
                    return
                q.put(b)
            q.put(done)
        except BaseException as e:  # propagate into the consumer
            q.put(e)

    thread = threading.Thread(target=run, daemon=True, name="ap-data-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while thread.is_alive():     # unblock its put; it stops before the next batch
            try:
                q.get(timeout=0.05)
            except queue.Empty:
                pass
