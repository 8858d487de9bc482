"""Avg+max token pooling for AudioMAE embeddings (plain PyTorch)."""

from __future__ import annotations

import torch


def avg_max_pool_tokens(
    tokens: torch.Tensor,
    grid: tuple[int, int],
    time_pool: int,
    freq_pool: int,
) -> torch.Tensor:
    """tokens [B, T*F, D] on a (T, F) row-major grid -> [B, (T/tp)*(F/fp), D],
    each cell pooled as (mean + max) / 2 (kernel == stride == (tp, fp))."""

    t, f = grid
    b, n, d = tokens.shape
    if n != t * f:
        raise ValueError(f"token count {n} != grid {t}x{f}")
    if t % time_pool or f % freq_pool:
        raise ValueError(f"grid {grid} not divisible by pooling ({time_pool}, {freq_pool})")
    x = tokens.reshape(b, t // time_pool, time_pool, f // freq_pool, freq_pool, d)
    avg = x.mean(dim=(2, 4))
    mx = x.amax(dim=(2, 4))
    return ((avg + mx) * 0.5).reshape(b, (t // time_pool) * (f // freq_pool), d)
