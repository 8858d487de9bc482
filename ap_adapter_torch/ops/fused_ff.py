"""K3: fused pre-LN GEGLU feed-forward, ``x + W2·(a ⊙ gelu_erf(g)) + b2`` with
``[a‖g] = LN(x)W1 + b1``.

Replaces ``ap_adapter_tpu/ops/pallas_fused_ff.py::fused_ln_geglu_ff``. It runs
at the norm3 + feed-forward of every UNet transformer block.

Kernel (``csrc/fused_blocks.cu``, ``apk_fused_ln_geglu_ff``): an LN+W1 GEMM
whose blocks accumulate the value and the gate halves of one output tile
side by side and apply bias and exact-erf GELU (``erff``) in the epilogue,
writing only the [S, 4C] product; then a W2 GEMM with bias and residual in
its epilogue. This is the largest matmul work of the block (W1 [C, 8C],
W2 [4C, C]); on an H100 the simple WMMA tiles without a load pipeline keep
it well below the tensor-core peak, which is the first thing later work on
this kernel should change. The [S, 4C] product makes one round trip through
device memory.

The TPU kernel used an Abramowitz-Stegun erf (error <= 1.5e-7); the CUDA
kernel uses ``erff`` and the plain version the exact GELU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ap_adapter_torch.models.layers import layer_norm_f32
from ap_adapter_torch.ops import cuda_kernels as ck


def fused_ln_geglu_ff_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version: x [B, S, C]; w1 [2*inner, C], w2 [C, inner]."""

    xn = layer_norm_f32(x, ln_w, ln_b, eps)
    a, g = F.linear(xn, w1, b1).chunk(2, dim=-1)
    y = a * F.gelu(g, approximate="none")
    return x + F.linear(y, w2, b2).to(x.dtype)


def fused_ln_geglu_ff(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-5) -> torch.Tensor:
    """K3 on a CUDA tensor (bf16), the plain version on a CPU tensor."""

    op = "fused_ln_geglu_ff"
    b, s, c = x.shape
    inner = w2.shape[1]
    if w1.shape != (2 * inner, c) or w2.shape != (c, inner):
        raise ValueError(f"{op}: w1 must be [2*inner, C], w2 [C, inner] "
                         f"(got x {tuple(x.shape)}, w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)})")
    operands = dict(x=x, ln_w=ln_w, ln_b=ln_b, w1=w1, b1=b1, w2=w2, b2=b2)
    ck.check_contiguous(op, **operands)
    if x.device.type == "cpu":
        return fused_ln_geglu_ff_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps)
    if c % 64 or inner % 64:
        raise ValueError(f"{op}: kernel needs C % 64 == 0 and inner % 64 == 0 (C={c}, inner={inner})")
    ck.check_operands(op, x, **operands)
    y = x.new_empty(b, s, inner)
    out = torch.empty_like(x)
    ck.launch(op, x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
              w2.data_ptr(), b2.data_ptr(), y.data_ptr(), out.data_ptr(), b, s, c, inner, eps)
    return out
