"""K12: GroupNorm(+SiLU) with fp32 statistics, on the port's NCHW layout.

Replaces ``ap_adapter_tpu/ops/pallas_groupnorm.py::fused_group_norm`` (its
whole-slab and two-phase tiled kernels compute one function on ``[B, N, C]``;
the port keeps the UNet's NCHW, so one (batch, group) is one contiguous
span). ``UNetConfig.use_pallas_groupnorm`` routes the resnet norm sites here
(``models/unet_blocks.py::ResnetBlock2D``), as the JAX routes them at
unet_blocks.py:93-100; Transformer2D's and the VAE's GroupNorms stay as
they are.

Kernel (``csrc/resnet.cu``, ``apk_group_norm_silu``): the UNet's NCHW
tensors are channels-last in memory (``[B, H·W, C]`` rows), and the kernel
reads them so, with no transpose; ``x`` must be channels-last contiguous
(``x.is_contiguous(memory_format=torch.channels_last)``), on the CPU too, so
that a layout fault shows in the CPU tests. A block takes a chunk of
positions of one sample (about 4,096 values), reduces each channel by
Welford and combines each group's channels by Chan's rule in a fixed order;
a finalize pass combines a group's chunks into each channel's fp32 scale
and shift, and an apply pass writes ``x * scale + shift`` (SiLU in fp32, one
rounding). No atomics, and no ``E[x²] − E[x]²`` (the TPU kernel's form,
which cancels when |mean| ≫ std). What bounds it on an H100: bytes, one read
and one write of x (the statistics read x once more).

The plain version computes GroupNorm and SiLU in fp32 and rounds once, as
the TPU kernel does; the port's default resnet path (``F.silu(norm(x))`` in
the model's dtype) rounds the GroupNorm output before the SiLU, a difference
of one bf16 rounding. ``group_norm_silu_vjp`` is an autograd Function whose
backward is autograd over the plain version (pallas_groupnorm.py:189-207).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ap_adapter_torch.ops import cuda_kernels as ck

GN_CHUNK = 4096     # values of a sample per statistics block
GN_MAX_SPLIT = 256
GN_MAX_C = 2048     # channels a statistics block holds


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gn_split(hw: int, c: int) -> Tuple[int, int]:
    """(statistics blocks per sample, positions per block) for a [hw, c] sample."""

    nsplit = max(1, min(GN_MAX_SPLIT, _cdiv(hw * c, GN_CHUNK)))
    pchunk = _cdiv(hw, nsplit)
    return _cdiv(hw, pchunk), pchunk


def group_norm_silu_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int,
                          eps: float = 1e-5, act: bool = False) -> torch.Tensor:
    """Plain PyTorch version: x [B, C, H, W]; GroupNorm (and SiLU) in fp32,
    rounded once to x's dtype."""

    y = F.group_norm(x.float(), groups, gamma.float(), beta.float(), eps)
    return (F.silu(y) if act else y).to(x.dtype)


def group_norm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int,
                    eps: float = 1e-5, act: bool = False) -> torch.Tensor:
    """K12 on a CUDA tensor (bf16 x, gamma, beta; x [B, C, H, W] channels-last
    in memory, C % 8 == 0), the plain version on a CPU tensor. The result is
    channels-last too. Records no autograd graph: differentiable callers use
    ``group_norm_silu_vjp``."""

    op = "group_norm_silu"
    if x.ndim != 4 or x.shape[1] % groups or gamma.shape != (x.shape[1],) or beta.shape != (x.shape[1],):
        raise ValueError(f"{op}: x must be [B, C, H, W] with C % groups == 0 and gamma/beta [C], got "
                         f"{tuple(x.shape)}, {tuple(gamma.shape)}, {tuple(beta.shape)}, groups={groups}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{op}: x must be channels-last contiguous, got strides {x.stride()}")
    ck.check_contiguous(op, gamma=gamma, beta=beta)
    ck.check_no_grad(op, x=x, gamma=gamma, beta=beta)
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, gamma, beta, groups, eps, act)
    b, c, h, w = x.shape
    if c % 8 or c > GN_MAX_C:
        raise ValueError(f"{op}: kernel needs C % 8 == 0 and C <= {GN_MAX_C} (C={c})")
    ck.check_operands(op, x, x=x, gamma=gamma, beta=beta)
    nsplit, pchunk = gn_split(h * w, c)
    part = x.new_empty(b * groups * nsplit, 2, dtype=torch.float32)
    ss = x.new_empty(b, c, 2, dtype=torch.float32)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    ck.launch(op, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), part.data_ptr(), nsplit, pchunk,
              ss.data_ptr(), y.data_ptr(), b, c, h * w, groups, eps, int(act))
    return y


class _GroupNormSilu(torch.autograd.Function):
    """Forward K12, backward autograd over the plain version, recomputed."""

    @staticmethod
    def forward(ctx, x, gamma, beta, groups, eps, act):
        ctx.save_for_backward(x, gamma, beta)
        ctx.args = (groups, eps, act)
        return group_norm_silu(x, gamma, beta, groups, eps, act)

    @staticmethod
    def backward(ctx, g):
        grads = ck.plain_vjp(lambda *a: group_norm_silu_plain(*a, *ctx.args), ctx.saved_tensors,
                             ctx.needs_input_grad[:3], g.contiguous())
        return (*grads, None, None, None)


def group_norm_silu_vjp(x, gamma, beta, groups: int, eps: float = 1e-5, act: bool = False) -> torch.Tensor:
    """K12 as a differentiable op (the JAX ``group_norm_silu``)."""

    if not torch.is_grad_enabled():   # inference: the raw op, no autograd node
        return group_norm_silu(x, gamma, beta, groups, eps, act)
    return _GroupNormSilu.apply(x, gamma, beta, groups, eps, act)
