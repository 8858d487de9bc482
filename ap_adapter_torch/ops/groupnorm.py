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
that a layout fault shows in the CPU tests. One launch a call and no
scratch: the ``n`` CTAs of a sample form a thread-block cluster
(``gn_cluster_plan``); each takes a contiguous chunk of positions (held in
shared memory where it fits), computes its per-group sum, mean and centred
sum of squares, and after a cluster barrier every CTA combines all the
chunks' (count, mean, M2) through distributed shared memory by Chan's rule
in rank order, then writes ``x * scale + shift`` (SiLU in fp32, one
rounding). No atomics, and no ``E[x²] − E[x]²`` (the TPU kernel's form,
which cancels when |mean| ≫ std). What bounds it on an H100: bytes, one read
and one write of x.

The plain version computes GroupNorm and SiLU in fp32 and rounds once, as
the TPU kernel does; the port's default resnet path (``F.silu(norm(x))`` in
the model's dtype) rounds the GroupNorm output before the SiLU, a difference
of one bf16 rounding. ``group_norm_silu_vjp`` is an autograd Function whose
backward is autograd over the plain version (pallas_groupnorm.py:189-207).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ap_adapter_torch.ops import cuda_kernels as ck

GN_MAX_C = 2048             # channels a block holds (8 per thread)
GN_MAX_CLUSTER = 16         # CTAs of a sample (a non-portable cluster size)
GN_MAX_THREADS = 512
GN_CTA_BYTES = 16 * 1024    # the bytes of a sample a CTA aims at
SMEM_LIMIT = 232_448        # shared memory a block can use on an H100


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class GnPlan(NamedTuple):
    n: int          # CTAs of a sample: the cluster
    pchunk: int     # positions a CTA takes: [j * pchunk, (j + 1) * pchunk) of the sample
    threads: int    # threads a CTA, 8 channels each, (c // 8) * rows of them used
    hold: bool      # the chunk stays in shared memory between the passes
    smem: int       # shared memory bytes a CTA (csrc/resnet.cu::gn_layout)


@functools.lru_cache(maxsize=None)
def gn_cluster_plan(hw: int, c: int, groups: int) -> GnPlan:
    """The launch of K12 (and of K13's two GroupNorms) on a [hw, c] sample:
    the fewest CTAs, a power of two up to 16, that keep each near
    ``GN_CTA_BYTES`` of the sample, the chunk held when it fits."""

    vc = c // 8
    rows = max(1, GN_MAX_THREADS // vc)
    threads = _cdiv(vc * rows, 32) * 32
    n = 1
    while n < GN_MAX_CLUSTER and n < hw and n * GN_CTA_BYTES < hw * c * 2:
        n *= 2
    pchunk = _cdiv(hw, n)
    fixed = -(-(rows * c * 4 + c * 8 + groups * 5 * 4 + n * groups * 3 * 4) // 16) * 16
    hold = fixed + pchunk * c * 2 <= SMEM_LIMIT
    return GnPlan(n, pchunk, threads, hold, fixed + (pchunk * c * 2 if hold else 0))


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
    plan = gn_cluster_plan(h * w, c, groups)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    ck.launch(op, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), b, c, h * w, groups, plan.n,
              plan.pchunk, plan.threads, int(plan.hold), eps, int(act))
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
