"""K5/K6: unmasked self-attention over long sequences, ``softmax(q·kᵀ·d^-½)·v``.

One Hopper kernel replaces both TPU kernels of this function:
``ap_adapter_tpu/ops/pallas_packed_attention.py::packed_self_attention``
(K5, heads packed into the 128 lanes when d divides 128) and
``ap_adapter_tpu/ops/pallas_self_attention.py::pallas_self_attention`` (K6,
any d, the whole K/V of a head resident in VMEM). The packing and the
residency answer the TPU's lane width and VMEM. ``ops/attention.py::self_attention``
routes sequences of 512 tokens or more here, as the JAX routine does; the
caller on the default paths is the VAE mid-block attention (one head,
d = 512, S = 4000 in an edit's decode, 4096 in a training batch's encode).

Kernel (``csrc/self_attention.cu``, ``apk_self_attention``), one launch a
call, routed by head dim (``attention_plan``): d % 16 == 0 and d <= 128 to
the streamed online-softmax routine the fused blocks use; d % 64 == 0 with
128 < d <= 512 to a one-pass Hopper kernel: 64 query rows per block, Q
resident, K/V tiles of 32 keys in flight by TMA a tile ahead, QKᵀ
and PV on ``wgmma`` in two consumer warpgroups, an online max-subtracted
fp32 softmax with P rounded to bf16 before PV. Where the query tiles do not
fill the card a 2-CTA cluster splits the keys and combines in fp32. It is
bound by operations (4·B·H·S²·d against 8·B·S·H·d bytes); the source note
says what the design does about it.

``self_attention_vjp`` is an autograd Function: forward the kernel,
backward autograd over the plain version, as the JAX custom VJPs run XLA
backwards (pallas_packed_attention.py:143-158, pallas_self_attention.py:
103-123).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from ap_adapter_torch.ops import cuda_kernels as ck
from ap_adapter_torch.ops.attention import sdpa

MAX_HEAD_DIM = 512
STREAM_MAX_D = 128      # the streamed routine's widest head
Q_TILE = 64             # query rows per block of the wgmma kernel
KEY_TILE = 32           # keys per pipelined tile of the wgmma kernel
CLUSTER_MODES = {"alone": 0, "split_keys": 1}   # csrc/self_attention.cu::WaMode
H100_SMS = 132


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def attention_plan(b: int, s: int, h: int, d: int, sms: int = H100_SMS) -> Tuple[str, str]:
    """(route, cluster) of the kernel for q/k/v [b, s, h, d]: ("stream",
    "alone") for d % 16 == 0 and d <= 128. For d % 64 == 0 with
    128 < d <= 512 the wgmma kernel: "split_keys" (a 2-CTA cluster per query
    tile) where the b·h·⌈s/64⌉ query tiles are fewer than the card's ``sms``
    and there are two key tiles to split, else "alone". Any other d
    raises."""

    if d % 16 == 0 and 0 < d <= STREAM_MAX_D:
        return "stream", "alone"
    if d % 64 == 0 and STREAM_MAX_D < d <= MAX_HEAD_DIM:
        if b * h * _cdiv(s, Q_TILE) < sms and _cdiv(s, KEY_TILE) >= 2:
            return "wgmma", "split_keys"
        return "wgmma", "alone"
    raise ValueError(f"self_attention: kernel needs head dim % 16 == 0 and <= {STREAM_MAX_D}, or % 64 == 0 and "
                     f"<= {MAX_HEAD_DIM} (D={d})")


def self_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: q/k/v [B, S, H, D]; fp32 max-subtracted softmax,
    probabilities in q's dtype before the product."""

    return sdpa(q, k, v)


def self_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel on a CUDA tensor (bf16; D as ``attention_plan`` takes it),
    the plain version on a CPU tensor. Records no autograd graph: differentiable
    callers use ``self_attention_vjp``."""

    op = "self_attention"
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{op}: q, k, v must be [B, S, H, D] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    ck.check_contiguous(op, q=q, k=k, v=v)
    ck.check_no_grad(op, q=q, k=k, v=v)
    if q.device.type == "cpu":
        return self_attention_plain(q, k, v)
    b, s, h, d = q.shape
    _, cluster = attention_plan(b, s, h, d, ck.sm_count(q.device))
    ck.check_operands(op, q, q=q, k=k, v=v)
    out = torch.empty_like(q)
    ck.launch(op, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d, CLUSTER_MODES[cluster])
    return out


class _SelfAttention(torch.autograd.Function):
    """Forward the kernel, backward autograd over the plain version, recomputed."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return self_attention_kernel(q, k, v)

    @staticmethod
    def backward(ctx, g):
        return tuple(ck.plain_vjp(self_attention_plain, ctx.saved_tensors, ctx.needs_input_grad[:3],
                                  g.contiguous()))


def self_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel as a differentiable op (the JAX ``*_self_attention_vjp``)."""

    if not torch.is_grad_enabled():   # inference: the raw op, no autograd node
        return self_attention_kernel(q, k, v)
    return _SelfAttention.apply(q, k, v)
