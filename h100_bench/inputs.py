"""Inputs the benchmark makes from ``--seed`` and hands to the program and
to the reference alike: token ids, audio prompts, latent seeds and
weights."""

from __future__ import annotations

import hashlib
from typing import Dict, Sequence

import numpy as np
import torch


def sub_seed(seed: int, *parts) -> int:
    """A 63-bit seed from ``seed`` and any labels (numbers or strings)."""

    h = hashlib.sha256(repr((int(seed),) + parts).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def word_ids(texts: Sequence[str], vocab_size: int, pad_id: int, length: int):
    """A word-hash tokenizer with bos 0 and eos 2 (the ids of the port's
    ``HashTokenizer``, which stands in for the checkpoints' tokenizers):
    (ids, mask), int32 [len(texts), length]."""

    ids = np.full((len(texts), length), pad_id, dtype=np.int32)
    mask = np.zeros((len(texts), length), dtype=np.int32)
    for i, t in enumerate(texts):
        toks = [0] + [3 + int(hashlib.md5(w.encode()).hexdigest(), 16) % (vocab_size - 3) for w in t.lower().split()]
        toks = (toks + [2])[:length]
        ids[i, : len(toks)] = toks
        mask[i, : len(toks)] = 1
    return ids, mask


def text_batch(config: dict, prompts: Sequence[str], t5_length: int = 0) -> Dict[str, np.ndarray]:
    """CLAP ids padded to the tokenizer's maximum and, with ``t5_length``, T5
    ids padded to that length (the task CLI pads T5 to 64)."""

    c = config["clap"]
    out = dict(zip(("clap_ids", "clap_mask"), word_ids(prompts, c["vocab_size"], c["pad_token_id"], c["max_length"])))
    if t5_length:
        out.update(zip(("t5_ids", "t5_mask"), word_ids(prompts, config["t5"]["vocab_size"], 0, t5_length)))
    return out


def audio_prompt(seed: int, seconds: float, rate: int) -> np.ndarray:
    """A seeded music-like clip [seconds * rate], float32 in [-0.5, 0.5]:
    three voices of harmonic notes (110-880 Hz, a new note every 0.25-1 s,
    decaying envelopes) over faint noise."""

    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    out = 0.01 * rng.standard_normal(n)
    for _ in range(3):
        edges = np.cumsum(rng.uniform(0.25, 1.0, size=int(4 * seconds) + 2))
        edges = edges[edges < seconds]
        note = np.searchsorted(edges, t)
        f0 = 110.0 * 2 ** (rng.integers(0, 37, size=len(edges) + 1) / 12.0)
        since = t - np.concatenate([[0.0], edges])[note]
        env = np.exp(-since * rng.uniform(1.0, 4.0))
        phase = 2 * np.pi * np.cumsum(f0[note]) / rate
        out += sum(np.sin(h * phase) / h for h in (1, 2, 3)) * env * rng.uniform(0.05, 0.15)
    return (0.5 * out / np.abs(out).max()).astype(np.float32)


def tuples(v):
    """JSON lists as tuples, nested lists too."""

    if isinstance(v, list):
        return tuple(tuples(x) for x in v)
    return v


def is_norm_scale(name: str, shape) -> bool:
    return len(shape) == 1 and name.endswith("weight")


@torch.no_grad()
def fill_weights_(module: torch.nn.Module, seed: int, draw_dtype: torch.dtype) -> torch.nn.Module:
    """The benchmark's weights, in place: 1 for norm scales (1-D ``weight``),
    0 for biases, N(0, 0.02) for everything else, drawn in ``draw_dtype`` on
    the module's device by one call over all of them in name order, so two
    modules with the same names and shapes get the same values whatever
    their own dtypes."""

    params = sorted(module.named_parameters(), key=lambda kv: kv[0])
    drawn = [(n, p) for n, p in params if not is_norm_scale(n, p.shape) and not n.endswith("bias")]
    dev = params[0][1].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.empty(sum(p.numel() for _, p in drawn), dtype=draw_dtype, device=dev).normal_(0.0, 0.02, generator=gen)
    off = 0
    for name, p in params:
        if is_norm_scale(name, p.shape):
            p.fill_(1.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.copy_(flat[off: off + p.numel()].view(p.shape))
            off += p.numel()
    return module


def weight_spec(module: torch.nn.Module) -> list:
    """(name, shape) of every parameter, in name order."""

    return sorted((n, tuple(p.shape)) for n, p in module.named_parameters())

