"""K1: fused pre-LN self-attention block, ``x + Wo·MHA(LN(x)Wq, LN(x)Wk, LN(x)Wv) + bo``.

Replaces ``ap_adapter_tpu/ops/pallas_fused_block.py::fused_ln_self_attention``
(the TPU kernel and its ``_kernel_pipe``/``_kernel_t``/``_kernel_kt``
reorderings compute this one function). It runs at every UNet
self-attention site: attn1 of every transformer block and attn2 of the
double-self-attention groups.

Kernel (``csrc/fused_blocks.cu``, ``apk_fused_ln_self_attention``): one
LN+QKV GEMM launch (LayerNorm statistics in fp32 inside the GEMM block, the
normalised rows rounded to bf16 on their way into shared memory, the three
weight matrices as three grid slices), a streamed online-softmax attention
(one block per 64 queries x head x batch, K/V tiles of 64 keys), and an out
GEMM with bias and residual in its epilogue. What bounds it on an H100: at
S <= 1000 and C <= 640 it is latency- and shared-memory-bound, not HBM- or
tensor-core-bound; q/k/v and the attention output make one round trip
through device memory (the TPU kernel kept them in VMEM), which later work
can remove by fusing the projections into the attention block.

The softmax is max-subtracted (the TPU kernel's is clamp-50 and max-free;
the two agree to fp32 rounding for logits in (-86, 50)). The plain version
follows the JAX ``_xla_reference``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ap_adapter_torch.models.layers import layer_norm_f32
from ap_adapter_torch.ops import cuda_kernels as ck
from ap_adapter_torch.ops.attention import sdpa


def fused_ln_self_attention_plain(x, ln_w, ln_b, wq, wk, wv, wo, bo, heads: int,
                                  eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version: x [B, S, C]; weights in Linear layout [out, in]."""

    b, s, c = x.shape
    d = c // heads
    xn = layer_norm_f32(x, ln_w, ln_b, eps)
    q = F.linear(xn, wq).reshape(b, s, heads, d)
    k = F.linear(xn, wk).reshape(b, s, heads, d)
    v = F.linear(xn, wv).reshape(b, s, heads, d)
    attn = sdpa(q, k, v).reshape(b, s, c)
    return x + F.linear(attn, wo, bo).to(x.dtype)


def fused_ln_self_attention(x, ln_w, ln_b, wq, wk, wv, wo, bo, heads: int,
                            eps: float = 1e-5) -> torch.Tensor:
    """K1 on a CUDA tensor (bf16), the plain version on a CPU tensor."""

    op = "fused_ln_self_attention"
    b, s, c = x.shape
    for name, w in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)):
        if w.shape != (c, c):
            raise ValueError(f"{op}: {name} must be [{c}, {c}], got {tuple(w.shape)}")
    operands = dict(x=x, ln_w=ln_w, ln_b=ln_b, wq=wq, wk=wk, wv=wv, wo=wo, bo=bo)
    ck.check_contiguous(op, **operands)
    if x.device.type == "cpu":
        return fused_ln_self_attention_plain(x, ln_w, ln_b, wq, wk, wv, wo, bo, heads, eps)
    ck.check_heads(op, c, heads)
    ck.check_operands(op, x, **operands)
    q, k, v, attn, out = (torch.empty_like(x) for _ in range(5))
    ck.launch(op, x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), wq.data_ptr(), wk.data_ptr(),
              wv.data_ptr(), wo.data_ptr(), bo.data_ptr(), q.data_ptr(), k.data_ptr(),
              v.data_ptr(), attn.data_ptr(), out.data_ptr(), b, s, c, heads, eps)
    return out
