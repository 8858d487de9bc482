"""Host-side prompt tokenization (numpy).

Counterpart of ``ap_adapter_tpu/pipeline/tokenize.py``: a checkpoint's
transformers tokenizers (``HFTokenizers``: CLAP padded to its maximum, T5
bucketed; reference pipeline_audioldm2.py:380-399), the deterministic hash
tokenizer that drives the pipeline without vocab files, and the fixed-shape
batch assembly.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence, Tuple

import numpy as np

from ap_adapter_torch.configs import PipelineConfig
from ap_adapter_torch.pipeline.pipeline import TextBatch


class HashTokenizer:
    """Deterministic word-hash tokenizer: bos=0, eos=2, pad=``pad_token_id``.

    Not a linguistic tokenizer; it gives smoke tests and benchmarks stable ids
    (the same ids as the JAX package's ``HashTokenizer``)."""

    def __init__(self, vocab_size: int, pad_token_id: int = 1):
        self.vocab_size = vocab_size
        self.pad_token_id = pad_token_id

    def __call__(self, texts: Sequence[str], max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.full((len(texts), max_length), self.pad_token_id, dtype=np.int32)
        mask = np.zeros((len(texts), max_length), dtype=np.int32)
        for i, t in enumerate(texts):
            toks = [0]
            for w in t.lower().split():
                h = int(hashlib.md5(w.encode()).hexdigest(), 16)
                toks.append(3 + h % (self.vocab_size - 3))
            toks.append(2)
            toks = toks[:max_length]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return ids, mask


class HFTokenizers:
    """transformers tokenizers loaded from a local checkpoint directory:
    ``tokenizer/`` (CLAP) and ``tokenizer_2/`` (T5). transformers is imported
    here, not with the module, so the port imports where it is not
    installed."""

    def __init__(self, checkpoint_dir: str):
        from transformers import AutoTokenizer

        self.clap = AutoTokenizer.from_pretrained(f"{checkpoint_dir}/tokenizer")
        self.t5 = AutoTokenizer.from_pretrained(f"{checkpoint_dir}/tokenizer_2")

    def __call__(self, texts: Sequence[str], clap_max_length: int, t5_max_length: Optional[int] = None):
        """(clap ids, clap mask, t5 ids, t5 mask): CLAP padded to
        ``clap_max_length``, T5 to ``t5_max_length`` (None: the longest)."""

        clap = self.clap(list(texts), padding="max_length", max_length=clap_max_length, truncation=True,
                         return_tensors="np")
        t5 = self.t5(list(texts), padding="max_length" if t5_max_length else True, max_length=t5_max_length,
                     truncation=True, return_tensors="np")
        return clap.input_ids, clap.attention_mask, t5.input_ids, t5.attention_mask

    def t5_length(self, texts: Sequence[str]) -> int:
        """Longest T5 token length over ``texts`` (no padding)."""

        return max(len(ids) for ids in self.t5(list(texts)).input_ids)


T5_BUCKETS = (16, 32, 64, 128, 256, 512)


def pick_t5_bucket(longest: int, buckets: Sequence[int] = T5_BUCKETS) -> int:
    """Smallest bucket >= the longest tokenized prompt (the last bucket past
    them all). The reference pads T5 to the longest prompt of a batch;
    buckets keep a few shapes while padding stays masked."""

    return next((b for b in buckets if longest <= b), buckets[-1])


def make_text_batch(
    config: PipelineConfig,
    prompts: Sequence[str],
    tokenizers: Optional[HFTokenizers] = None,
    clap_len: Optional[int] = None,
    t5_len: Optional[int] = 64,
) -> TextBatch:
    """Tokenize prompts into a fixed-shape TextBatch of int32 numpy arrays:
    CLAP padded to ``clap_len`` (default the tokenizer maximum), T5 to
    ``t5_len``, or with ``t5_len=None`` to the smallest of ``T5_BUCKETS``
    that covers the longest prompt. ``tokenizers``: a checkpoint's
    ``HFTokenizers``, else the hash tokenizer."""

    clap_len = clap_len or config.clap.max_length
    if t5_len is None:
        longest = (tokenizers.t5_length(prompts) if tokenizers is not None
                   else max(len(t.split()) + 2 for t in prompts))
        t5_len = pick_t5_bucket(longest)
    if tokenizers is not None:
        ci, cm, ti, tm = tokenizers(prompts, clap_len, t5_len)
    else:
        ci, cm = HashTokenizer(config.clap.vocab_size, config.clap.pad_token_id)(prompts, clap_len)
        ti, tm = HashTokenizer(config.t5.vocab_size, pad_token_id=0)(prompts, t5_len)
    return TextBatch(*(np.asarray(a, dtype=np.int32) for a in (ci, cm, ti, tm)))
