"""K5/K6: unmasked self-attention over long sequences, ``softmax(q·kᵀ·d^-½)·v``.

One Hopper kernel replaces both TPU kernels of this function:
``ap_adapter_tpu/ops/pallas_packed_attention.py::packed_self_attention``
(K5, heads packed into the 128 lanes when d divides 128) and
``ap_adapter_tpu/ops/pallas_self_attention.py::pallas_self_attention`` (K6,
any d, the whole K/V of a head resident in VMEM). The packing and the
residency answer the TPU's lane width and VMEM; the Hopper kernel takes any
d that is a multiple of 16 up to 512. ``ops/attention.py::self_attention``
routes sequences of 512 tokens or more here, as the JAX routine does; the
caller on the default paths is the VAE mid-block attention (one head,
d = 512, S = 4000 in an edit's decode, 4096 in a training batch's encode).

Kernel (``csrc/self_attention.cu``, ``apk_self_attention``): a stats pass
(row max and sum of exp in fp32, max-subtracted) and then a PV pass inside
one block of 32 queries, with P normalised and rounded to bf16 before the
product, as the plain version rounds it; O stays in WMMA accumulator
registers. It is bound by operations (4·B·H·S²·d against 8·B·S·H·d bytes);
the design runs QKᵀ twice, and the source note says why.

``self_attention_vjp`` is an autograd Function: forward the kernel,
backward autograd over the plain version, as the JAX custom VJPs run XLA
backwards (pallas_packed_attention.py:143-158, pallas_self_attention.py:
103-123).
"""

from __future__ import annotations

import torch

from ap_adapter_torch.ops import cuda_kernels as ck
from ap_adapter_torch.ops.attention import sdpa

MAX_HEAD_DIM = 512


def self_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: q/k/v [B, S, H, D]; fp32 max-subtracted softmax,
    probabilities in q's dtype before the product."""

    return sdpa(q, k, v)


def self_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel on a CUDA tensor (bf16, D % 16 == 0, D <= 512), the plain
    version on a CPU tensor. Records no autograd graph: differentiable
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
    if d % 16 or d > MAX_HEAD_DIM:
        raise ValueError(f"{op}: kernel needs head dim % 16 == 0 and <= {MAX_HEAD_DIM} (D={d})")
    ck.check_operands(op, q, q=q, k=k, v=v)
    out = torch.empty_like(q)
    ck.launch(op, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d)
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
