"""Host-side prompt tokenization (numpy).

Counterpart of ``ap_adapter_tpu/pipeline/tokenize.py``: the deterministic
hash tokenizer that drives the pipeline without vocab files, and the
fixed-shape batch assembly. HF tokenizers are not part of this port yet.
"""

from __future__ import annotations

import hashlib
from typing import Sequence, Tuple

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


def make_text_batch(
    config: PipelineConfig,
    prompts: Sequence[str],
    clap_len: int | None = None,
    t5_len: int = 64,
) -> TextBatch:
    """Tokenize prompts into a fixed-shape TextBatch of int32 numpy arrays:
    CLAP padded to ``clap_len`` (default the tokenizer maximum), T5 to
    ``t5_len``."""

    clap_len = clap_len or config.clap.max_length
    ci, cm = HashTokenizer(config.clap.vocab_size, config.clap.pad_token_id)(prompts, clap_len)
    ti, tm = HashTokenizer(config.t5.vocab_size, pad_token_id=0)(prompts, t5_len)
    return TextBatch(clap_ids=ci, clap_mask=cm, t5_ids=ti, t5_mask=tm)
