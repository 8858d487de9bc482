"""K3: fused pre-LN GEGLU feed-forward, ``x + W2·(a ⊙ gelu_erf(g)) + b2`` with
``[a‖g] = LN(x)W1 + b1``, and K9, its input gradient.

K3 replaces ``ap_adapter_tpu/ops/pallas_fused_ff.py::fused_ln_geglu_ff``. It
runs at the norm3 + feed-forward of every UNet transformer block.

Kernel (``csrc/fused_hopper.cu``, ``apk_fused_ln_geglu_ff``), three launches
a call, on the Hopper GEMM of ``csrc/hopper_gemm.cuh`` (TMA into a ring of
stages, ``wgmma``, epilogues from the accumulator registers): the
LayerNorm row pass (fp32 statistics once per row, rounded to bf16 before
the product); the W1 GEMM, whose 64-wide tiles accumulate the value and the
gate columns side by side and apply bias and exact-erf GELU (``erff``) in
the epilogue, writing only the [S, 4C] product; then the W2 GEMM with bias
and residual in its epilogue, its k-blocks (K = 4C) split over a
thread-block cluster where the output tiles do not fill the SMs
(``k3_plan``: M = 128 at the edit's 640 level). What bounds it on an H100:
operations (W1 [C, 8C], W2 [4C, C]). LN(x) and the [S, 4C] product make one
round trip through device memory, in one scratch allocation a call.

K9 replaces ``pallas_fused_ff.py::fused_ln_geglu_ff_bwd_dx``
(``csrc/train_blocks.cu``, ``apk_fused_ln_geglu_ff_bwd_dx``), row-local like
the forward, four launches a call on the same Hopper GEMM: the LayerNorm
row pass; one GEMM for the three products of a 64 x 64 tile of gy1
(``a`` and ``gate`` from W1's value and gate rows, K-major as K3 loads
them, and ``gh = g·W2`` from W2 read as it lies, MN-major: two A operands,
three W boxes a stage, three accumulators), whose epilogue applies the
GEGLU backward (exact-erf derivative ``Phi(g) + g·phi(g)``) and writes
``[gh·gelu(g) ‖ gh·a·gelu'(g)]`` in bf16, gh staying fp32 in registers;
``gxn = gy1·W1`` (W1 read MN-major, K = 8C) in fp32, its k-blocks split
over a cluster where the plan says (``k9_plan``); and the LayerNorm
backward with the residual per row. The TPU ran its kernel only where the
weights fit VMEM (not at C = 640); this one runs at every width. What
bounds it on an H100: operations (the three products, then gxn).

The TPU kernels used an Abramowitz-Stegun erf (error <= 1.5e-7); the CUDA
kernels use ``erff`` and the plain versions the exact GELU.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ap_adapter_torch.models.layers import layer_norm_f32
from ap_adapter_torch.ops import cuda_kernels as ck
from ap_adapter_torch.ops.hopper_gemm import H100_SMS, GemmPlan, check_ln_width, gemm_plan


def fused_ln_geglu_ff_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version: x [B, S, C]; w1 [2*inner, C], w2 [C, inner]."""

    xn = layer_norm_f32(x, ln_w, ln_b, eps)
    a, g = F.linear(xn, w1, b1).chunk(2, dim=-1)
    y = a * F.gelu(g, approximate="none")
    return x + F.linear(y, w2, b2).to(x.dtype)


def _check_shapes(op: str, x, w1, w2) -> int:
    c = x.shape[-1]
    inner = w2.shape[1]
    if w1.shape != (2 * inner, c) or w2.shape != (c, inner):
        raise ValueError(f"{op}: w1 must be [2*inner, C], w2 [C, inner] "
                         f"(got x {tuple(x.shape)}, w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)})")
    return inner


def _check_widths(op: str, c: int, inner: int) -> None:
    if c % 64 or inner % 64:
        raise ValueError(f"{op}: kernel needs C % 64 == 0 and inner % 64 == 0 (C={c}, inner={inner})")


class K3Plan(NamedTuple):
    w1: GemmPlan        # LN(x) [M, C] x W1 [2·inner, C], GEGLU epilogue
    w2: GemmPlan        # GEGLU product [M, inner] x W2 [C, inner], bias + residual


@functools.lru_cache(maxsize=None)
def k3_plan(b: int, s: int, c: int, inner: int, sms: int = H100_SMS) -> K3Plan:
    """The launches of K3 on x [b, s, c]: both GEMMs by ``gemm_plan``.
    Raises on a width the kernels do not take."""

    _check_widths("fused_ln_geglu_ff", c, inner)
    check_ln_width("fused_ln_geglu_ff", c)
    m = b * s
    return K3Plan(gemm_plan(m, inner, c, geglu=True, sms=sms), gemm_plan(m, c, inner, sms=sms))


class K9Plan(NamedTuple):
    gy1: GemmPlan       # LN(x), g [M, C] x W1's value/gate rows and W2's columns, the GEGLU backward epilogue
    gxn: GemmPlan       # gy1 [M, 2·inner] x W1 read as [K, N], fp32 store


@functools.lru_cache(maxsize=None)
def k9_plan(b: int, s: int, c: int, inner: int, sms: int = H100_SMS) -> K9Plan:
    """The launches of K9 on x [b, s, c]: both GEMMs by ``gemm_plan``.
    Raises on a width the kernels do not take."""

    _check_widths("fused_ln_geglu_ff_bwd_dx", c, inner)
    check_ln_width("fused_ln_geglu_ff_bwd_dx", c)
    m = b * s
    return K9Plan(gemm_plan(m, inner, c, geglu_bwd=True, sms=sms), gemm_plan(m, c, 2 * inner, sms=sms))


def fused_ln_geglu_ff(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-5) -> torch.Tensor:
    """K3 on a CUDA tensor (bf16), the plain version on a CPU tensor. Records
    no autograd graph: differentiable callers use ``fused_ln_geglu_ff_vjp``."""

    op = "fused_ln_geglu_ff"
    b, s, c = x.shape
    inner = _check_shapes(op, x, w1, w2)
    operands = dict(x=x, ln_w=ln_w, ln_b=ln_b, w1=w1, b1=b1, w2=w2, b2=b2)
    ck.check_contiguous(op, **operands)
    ck.check_no_grad(op, **operands)
    if x.device.type == "cpu":
        return fused_ln_geglu_ff_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps)
    plan = k3_plan(b, s, c, inner, ck.sm_count(x.device))
    ck.check_operands(op, x, **operands)
    scratch = x.new_empty(b * s * (c + inner))     # LN(x) [M, C], then the GEGLU product [M, inner]
    out = torch.empty_like(x)
    ck.launch(op, x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
              w2.data_ptr(), b2.data_ptr(), scratch.data_ptr(), out.data_ptr(), b, s, c, inner, eps,
              *plan.w1.launch_args[1:], *plan.w2.launch_args)
    return out


def fused_ln_geglu_ff_bwd_dx_plain(x, g, ln_w, ln_b, w1, b1, w2, eps: float = 1e-5) -> torch.Tensor:
    """Plain version of K9: dx of K3's plain version for the output gradient g."""

    b2 = w2.new_zeros(w2.shape[0])
    return ck.plain_vjp(lambda *a: fused_ln_geglu_ff_plain(*a, eps),
                        (x, ln_w, ln_b, w1, b1, w2, b2), (True,) + (False,) * 6, g)[0]


def fused_ln_geglu_ff_bwd_dx(x, g, ln_w, ln_b, w1, b1, w2, eps: float = 1e-5) -> torch.Tensor:
    """K9 on a CUDA tensor (bf16 x and g), the plain version on a CPU tensor."""

    op = "fused_ln_geglu_ff_bwd_dx"
    b, s, c = x.shape
    inner = _check_shapes(op, x, w1, w2)
    if g.shape != x.shape:
        raise ValueError(f"{op}: g must be {tuple(x.shape)}, got {tuple(g.shape)}")
    operands = dict(x=x, g=g, ln_w=ln_w, ln_b=ln_b, w1=w1, b1=b1, w2=w2)
    ck.check_contiguous(op, **operands)
    ck.check_no_grad(op, **operands)
    if x.device.type == "cpu":
        return fused_ln_geglu_ff_bwd_dx_plain(x, g, ln_w, ln_b, w1, b1, w2, eps)
    plan = k9_plan(b, s, c, inner, ck.sm_count(x.device))
    ck.check_operands(op, x, **operands)
    scratch = x.new_empty(b * s * (c + 2 * inner))     # LN(x) [M, C], then gy1 [M, 2·inner]
    gxn = x.new_empty(b, s, c, dtype=torch.float32)
    dx = torch.empty_like(x)
    ck.launch(op, x.data_ptr(), g.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(),
              b1.data_ptr(), w2.data_ptr(), scratch.data_ptr(), gxn.data_ptr(), dx.data_ptr(), b, s, c, inner,
              eps, *plan.gy1.launch_args[1:], *plan.gxn.launch_args)
    return dx


class _FusedLnGegluFF(torch.autograd.Function):
    """Forward K3, backward K9 for dx; any other input that needs a gradient
    gets it from autograd over the plain version, recomputed."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, eps):
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2, b2)
        ctx.eps = eps
        return fused_ln_geglu_ff(x, ln_w, ln_b, w1, b1, w2, b2, eps)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:7]
        g = g.contiguous()
        grads = [None] * 7
        if needs[0]:
            grads[0] = fused_ln_geglu_ff_bwd_dx(saved[0], g, *saved[1:6], ctx.eps)
        if any(needs[1:]):
            rest = ck.plain_vjp(lambda *a: fused_ln_geglu_ff_plain(*a, ctx.eps), saved,
                                (False,) + tuple(needs[1:]), g)
            grads[1:] = rest[1:]
        return (*grads, None)


def fused_ln_geglu_ff_vjp(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-5) -> torch.Tensor:
    """K3 as a differentiable op (the JAX ``fused_ln_geglu_ff_vjp``)."""

    if not torch.is_grad_enabled():   # inference: the raw op, no autograd node
        return fused_ln_geglu_ff(x, ln_w, ln_b, w1, b1, w2, b2, eps)
    return _FusedLnGegluFF.apply(x, ln_w, ln_b, w1, b1, w2, b2, eps)
