"""Evaluation metrics: Fréchet Audio Distance and embedding similarity.

Counterpart of ``ap_adapter_tpu/eval/metrics.py``. The FAD statistics are
float64 numpy on the host and the covariance square root is scipy's, as in
the JAX package: a few [D, D] matrices per evaluation, not a device path.
Embedders: the CLAP audio tower (``clap_audio_embeddings``, through a
``ClapScorer``), VGGish (``eval/vggish.py``), or, without either, the
pipeline's own AudioMAE tokens (``audiomae_clip_embedding``, self-contained
but not comparable outside this repository).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray) -> float:
    """|mu1 - mu2|^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)) in float64."""

    from scipy import linalg

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)      # scipy >= 1.16 has no ``disp``; the default returns the matrix
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * np.trace(covmean))


def embedding_stats(embeddings: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[N, D] -> (mu [D], sigma [D, D]) in float64."""

    e = np.asarray(embeddings, dtype=np.float64)
    return e.mean(axis=0), np.cov(e, rowvar=False)


def fad(reference_embeddings: np.ndarray, generated_embeddings: np.ndarray) -> float:
    return frechet_distance(*embedding_stats(reference_embeddings), *embedding_stats(generated_embeddings))


@torch.no_grad()
def audiomae_clip_embedding(pipe, waveform: np.ndarray, sample_rate: int) -> np.ndarray:
    """Mean-pooled AudioMAE tokens of one clip [D] (eval pooling 8 x 8 at
    full scale), on the pipeline's device."""

    mods = pipe.modules
    fbank = pipe.prepare_fbank(waveform, sample_rate).to(mods.device)
    t, f = pipe.config.audiomae.grid_size
    tokens = mods.audiomae(fbank, min(8, t), min(8, f))
    return tokens[0].float().mean(dim=0).cpu().numpy()


def clap_audio_embeddings(scorer, waveforms, sample_rate: int) -> np.ndarray:
    """CLAP audio-tower embeddings [B, proj_dim] of a list of 1-D wavs (any
    lengths) or one [B, N] array."""

    if isinstance(waveforms, np.ndarray) and waveforms.ndim == 2:
        return scorer.audio_features(waveforms, sample_rate)
    return np.concatenate([scorer.audio_features(np.asarray(w), sample_rate) for w in waveforms], axis=0)


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def score_waveforms(pipe, text_embedding: np.ndarray, waveforms: Sequence[np.ndarray], sample_rate: int,
                    embed_fn: Callable = audiomae_clip_embedding) -> np.ndarray:
    """Indices of ``waveforms`` sorted by cosine similarity of ``embed_fn``'s
    embedding to ``text_embedding``, best first (the reference's
    ``score_waveforms`` hook, pipeline_audioldm2.py:592-614)."""

    sims = [cosine_similarity(text_embedding, embed_fn(pipe, w, sample_rate)) for w in waveforms]
    return np.argsort(sims)[::-1]
