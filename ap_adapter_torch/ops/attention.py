"""Attention primitives in plain PyTorch (not kernels).

Counterpart of ``ap_adapter_tpu/ops/attention.py``. Convention: q/k/v are
``[batch, seq, heads, head_dim]``; the softmax runs in fp32 whatever the
input dtype.
"""

from __future__ import annotations

from typing import Optional

import torch


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Scaled dot-product attention, q [B, Sq, H, D], k/v [B, Sk, H, D].

    ``mask`` broadcasts to [B, H, Sq, Sk]: boolean (True = attend) or an
    additive bias. Logits and softmax are fp32; the result has q's dtype."""

    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def dual_kv_attention(
    q: torch.Tensor,
    k_text: torch.Tensor,
    v_text: torch.Tensor,
    k_ip: torch.Tensor,
    v_ip: torch.Tensor,
    ip_scale: float,
    mask_text: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decoupled dual-KV cross-attention: attn(q, text) + s * attn(q, ip).
    The audio (ip) branch is unmasked."""

    out_text = sdpa(q, k_text, v_text, mask_text)
    out_ip = sdpa(q, k_ip, v_ip)
    return out_text + torch.as_tensor(ip_scale, dtype=out_ip.dtype) * out_ip


def mask_to_bias(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """[B, Sk] {0,1} padding mask -> [B, 1, 1, Sk] additive fp32 bias with
    the reference's -10000 convention."""

    if mask is None:
        return None
    bias = (1.0 - mask.float()) * -10000.0
    return bias[:, None, None, :]
