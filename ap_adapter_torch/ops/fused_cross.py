"""K2: fused pre-LN cross-attention over precomputed K/V,
``x + Wo·[softmax(q·kᵀ + bias)·v + s·softmax(q·k_ipᵀ)·v_ip] + bo``, ``q = LN(x)Wq``.

Replaces ``ap_adapter_tpu/ops/pallas_fused_cross.py::fused_ln_cross_attention_kv``
(``_kernel_kv``). It runs at every UNet cross-attention site: the GPT-2 +
AudioMAE stream with the adapter's second K/V set, and the T5 stream with
its padding bias. The conditioning K/V are projected once per generate
(``models/hoist.py``) and arrive in the natural ``[B, Sk, heads*d]`` layout.

Kernel (``csrc/fused_blocks.cu``, ``apk_fused_ln_cross_attention_kv``): an
LN+Q GEMM, the streamed online-softmax attention run over the text K/V (with
the fp32 key bias) and then over the adapter K/V, combined as
``out + s·out_ip`` in fp32 before one bf16 rounding, and an out GEMM with
bias and residual in its epilogue. Contexts are short (8 + 128 or 64 keys),
so on an H100 the cost is the two [S, C]x[C, C] projections and the launch
latency; the attention itself is one key tile per set.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ap_adapter_torch.models.layers import layer_norm_f32
from ap_adapter_torch.ops import cuda_kernels as ck
from ap_adapter_torch.ops.attention import sdpa


def fused_ln_cross_attention_kv_plain(
    x, k, v, ln_w, ln_b, wq, wo, bo, heads: int, *,
    ki: Optional[torch.Tensor] = None, vi: Optional[torch.Tensor] = None,
    ip_scale: float = 0.0, bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
) -> torch.Tensor:
    """Plain PyTorch version. x [B, S, C]; k/v [B, Sk, C]; ki/vi [B, Sk_ip, C];
    bias [B, Sk] fp32 additive (text keys only); weights [out, in]."""

    b, s, c = x.shape
    d = c // heads
    xn = layer_norm_f32(x, ln_w, ln_b, eps)
    q = F.linear(xn, wq).reshape(b, s, heads, d)

    def attn(kk, vv, mask):
        return sdpa(q, kk.reshape(b, -1, heads, d), vv.reshape(b, -1, heads, d), mask)

    out = attn(k, v, None if bias is None else bias[:, None, None, :])
    if ki is not None:
        out = out + torch.as_tensor(ip_scale, dtype=out.dtype) * attn(ki, vi, None)
    return x + F.linear(out.reshape(b, s, c), wo, bo).to(x.dtype)


def fused_ln_cross_attention_kv(
    x, k, v, ln_w, ln_b, wq, wo, bo, heads: int, *,
    ki: Optional[torch.Tensor] = None, vi: Optional[torch.Tensor] = None,
    ip_scale: float = 0.0, bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
) -> torch.Tensor:
    """K2 on a CUDA tensor (bf16; ``bias`` fp32), the plain version on a CPU tensor."""

    op = "fused_ln_cross_attention_kv"
    b, s, c = x.shape
    if (ki is None) != (vi is None):
        raise ValueError(f"{op}: ki and vi go together")
    sk = k.shape[1]
    sk_ip = 0 if ki is None else ki.shape[1]
    if k.shape != (b, sk, c) or v.shape != k.shape or sk == 0:
        raise ValueError(f"{op}: k/v must be [{b}, Sk>0, {c}], got {tuple(k.shape)}, {tuple(v.shape)}")
    if ki is not None and (ki.shape != (b, sk_ip, c) or vi.shape != ki.shape or sk_ip == 0):
        raise ValueError(f"{op}: ki/vi must be [{b}, Sk_ip>0, {c}]")
    if bias is not None and bias.shape != (b, sk):
        raise ValueError(f"{op}: bias must be [{b}, {sk}], got {tuple(bias.shape)}")
    if wq.shape != (c, c) or wo.shape != (c, c):
        raise ValueError(f"{op}: wq/wo must be [{c}, {c}]")
    operands = dict(x=x, k=k, v=v, ln_w=ln_w, ln_b=ln_b, wq=wq, wo=wo, bo=bo, ki=ki, vi=vi, bias=bias)
    ck.check_contiguous(op, **operands)
    if x.device.type == "cpu":
        return fused_ln_cross_attention_kv_plain(
            x, k, v, ln_w, ln_b, wq, wo, bo, heads, ki=ki, vi=vi, ip_scale=ip_scale,
            bias=bias, eps=eps)
    ck.check_heads(op, c, heads)
    ck.check_operands(op, x, **operands)
    q, attn, out = (torch.empty_like(x) for _ in range(3))
    ck.launch(op, x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), wq.data_ptr(), wo.data_ptr(),
              bo.data_ptr(), k.data_ptr(), v.data_ptr(), sk, ck.ptr(bias), ck.ptr(ki), ck.ptr(vi),
              sk_ip, float(ip_scale), q.data_ptr(), attn.data_ptr(), out.data_ptr(), b, s, c, heads,
              eps)
    return out
