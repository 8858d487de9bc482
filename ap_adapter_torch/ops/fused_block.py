"""K1: fused pre-LN self-attention block, ``x + Wo·MHA(LN(x)Wq, LN(x)Wk, LN(x)Wv) + bo``,
and K7, its input gradient.

K1 replaces ``ap_adapter_tpu/ops/pallas_fused_block.py::fused_ln_self_attention``
(the TPU kernel and its ``_kernel_pipe``/``_kernel_t``/``_kernel_kt``
reorderings compute this one function). It runs at every UNet
self-attention site: attn1 of every transformer block and attn2 of the
double-self-attention groups.

Kernel (``csrc/fused_hopper.cu``, ``apk_fused_ln_self_attention``), four
launches a call: the LayerNorm row pass (fp32 statistics once per row, the
normalised rows rounded to bf16, as the TPU kernel rounds before its
product); the QKV GEMM, three weight sets in one launch, on the Hopper GEMM
of ``csrc/hopper_gemm.cuh`` (TMA into a ring of stages, ``wgmma``, the bf16
store from registers); the register-resident attention (one warp 16 query
rows, ``mma.sync`` with ``ldmatrix``, logits, probabilities and output in
registers, K/V tiles of 64 keys double-buffered by ``cp.async``); and the
out GEMM with bias and residual in its epilogue, its k-blocks split over a
thread-block cluster where the output tiles do not fill the SMs
(``k1_plan``). What bounds it on an H100 at the edit's shapes: operations
(QKV, QKᵀ, PV, out); q/k/v and the attention output make one round trip
through device memory, in one scratch allocation a call.

K7 replaces ``pallas_fused_block.py::fused_ln_self_attention_bwd_dx``
(``csrc/train_blocks.cu``, ``apk_fused_ln_self_attention_bwd_dx``), seven
launches a call on the same Hopper routines: K1's LayerNorm row pass and
QKV GEMM recompute q/k/v; ``gattn = g·Wo`` on the GEMM reading Wo [out, in]
as it lies (MN-major, bf16 store); the register-resident attention backward
of ``csrc/attn_bwd.cuh``: a dq kernel per 64 query rows that sweeps the
keys twice (the forward's statistics and D = rowsum(dO·O), then dq, with S,
P, dP and dS in registers) and a dk/dv kernel per 64 keys that holds K/V in
registers and loops over the query tiles; ``gxn = [dq‖dk‖dv]·[Wq; Wk; Wv]``
as one MN-major GEMM with K = 3C and an fp32 store; and the LayerNorm
backward with the residual per row (``k7_plan``). What bounds it on an
H100: operations (QKV, gattn, five attention products, gxn).

The softmax is max-subtracted (the TPU kernel's is clamp-50 and max-free;
the two agree to fp32 rounding for logits in (-86, 50)); K7 recomputes the
probabilities as exp2(s·scale·log2e - lse2) of the same logits. The plain
versions follow the JAX ``_xla_reference`` and autograd over it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ap_adapter_torch.models.layers import layer_norm_f32
from ap_adapter_torch.ops import cuda_kernels as ck
from ap_adapter_torch.ops.attention import sdpa
from ap_adapter_torch.ops.hopper_gemm import H100_SMS, GemmPlan, check_ln_width, gemm_plan



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


class K1Plan(NamedTuple):
    qkv: GemmPlan       # LN(x) [M, C] x three [C, C] weights, bf16 store
    out: GemmPlan       # attention [M, C] x Wo, bias + residual


@functools.lru_cache(maxsize=None)
def k1_plan(b: int, s: int, c: int, heads: int, sms: int = H100_SMS) -> K1Plan:
    """The launches of K1's GEMMs on x [b, s, c], by ``gemm_plan`` (the
    attention's grid is fixed: 64 query rows a CTA). Raises on a width the
    kernels do not take (``ck.check_heads``)."""

    ck.check_heads("fused_ln_self_attention", c, heads)
    check_ln_width("fused_ln_self_attention", c)
    m = b * s
    return K1Plan(gemm_plan(m, c, c, sets=3, sms=sms), gemm_plan(m, c, c, sms=sms))


class K7Plan(NamedTuple):
    qkv: GemmPlan       # LN(x) [M, C] x three [C, C] weights, bf16 store (K1's)
    gattn: GemmPlan     # g [M, C] x Wo read as [K, N], bf16 store
    gxn: GemmPlan       # [dq | dk | dv] [M, 3C] x [Wq; Wk; Wv] read as [K, N], fp32 store


@functools.lru_cache(maxsize=None)
def k7_plan(b: int, s: int, c: int, heads: int, sms: int = H100_SMS) -> K7Plan:
    """The launches of K7's GEMMs on x [b, s, c], by ``gemm_plan`` (the
    attention backward's grids are fixed: 64 query rows, or 64 keys, a
    CTA). Raises on a width the kernels do not take (``ck.check_heads``)."""

    ck.check_heads("fused_ln_self_attention_bwd_dx", c, heads)
    check_ln_width("fused_ln_self_attention_bwd_dx", c)
    m = b * s
    return K7Plan(gemm_plan(m, c, c, sets=3, sms=sms), gemm_plan(m, c, c, sms=sms), gemm_plan(m, c, 3 * c, sms=sms))


def _check_weights(op: str, c: int, **weights) -> None:
    for name, w in weights.items():
        if w.shape != (c, c):
            raise ValueError(f"{op}: {name} must be [{c}, {c}], got {tuple(w.shape)}")


def fused_ln_self_attention(x, ln_w, ln_b, wq, wk, wv, wo, bo, heads: int,
                            eps: float = 1e-5) -> torch.Tensor:
    """K1 on a CUDA tensor (bf16), the plain version on a CPU tensor. Records
    no autograd graph: differentiable callers use ``fused_ln_self_attention_vjp``."""

    op = "fused_ln_self_attention"
    b, s, c = x.shape
    _check_weights(op, c, wq=wq, wk=wk, wv=wv, wo=wo)
    operands = dict(x=x, ln_w=ln_w, ln_b=ln_b, wq=wq, wk=wk, wv=wv, wo=wo, bo=bo)
    ck.check_contiguous(op, **operands)
    ck.check_no_grad(op, **operands)
    if x.device.type == "cpu":
        return fused_ln_self_attention_plain(x, ln_w, ln_b, wq, wk, wv, wo, bo, heads, eps)
    plan = k1_plan(b, s, c, heads, ck.sm_count(x.device))
    ck.check_operands(op, x, **operands)
    scratch = x.new_empty(5, b * s, c)       # LN(x), q, k, v, attention output
    out = torch.empty_like(x)
    ck.launch(op, x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), wq.data_ptr(), wk.data_ptr(),
              wv.data_ptr(), wo.data_ptr(), bo.data_ptr(), scratch.data_ptr(), out.data_ptr(), b, s, c, heads,
              eps, *plan.qkv.launch_args, *plan.out.launch_args)
    return out


def fused_ln_self_attention_bwd_dx_plain(x, g, ln_w, ln_b, wq, wk, wv, wo, heads: int,
                                         eps: float = 1e-5) -> torch.Tensor:
    """Plain version of K7: dx of K1's plain version for the output gradient g."""

    bo = wo.new_zeros(wo.shape[0])
    return ck.plain_vjp(lambda *a: fused_ln_self_attention_plain(*a, heads, eps),
                        (x, ln_w, ln_b, wq, wk, wv, wo, bo), (True,) + (False,) * 7, g)[0]


def fused_ln_self_attention_bwd_dx(x, g, ln_w, ln_b, wq, wk, wv, wo, heads: int,
                                   eps: float = 1e-5) -> torch.Tensor:
    """K7 on a CUDA tensor (bf16 x and g), the plain version on a CPU tensor."""

    op = "fused_ln_self_attention_bwd_dx"
    b, s, c = x.shape
    if g.shape != x.shape:
        raise ValueError(f"{op}: g must be {tuple(x.shape)}, got {tuple(g.shape)}")
    _check_weights(op, c, wq=wq, wk=wk, wv=wv, wo=wo)
    operands = dict(x=x, g=g, ln_w=ln_w, ln_b=ln_b, wq=wq, wk=wk, wv=wv, wo=wo)
    ck.check_contiguous(op, **operands)
    ck.check_no_grad(op, **operands)
    if x.device.type == "cpu":
        return fused_ln_self_attention_bwd_dx_plain(x, g, ln_w, ln_b, wq, wk, wv, wo, heads, eps)
    plan = k7_plan(b, s, c, heads, ck.sm_count(x.device))
    ck.check_operands(op, x, **operands)
    scratch = x.new_empty(8, b * s, c)      # LN(x), q, k, v, gattn, then [dq | dk | dv] as [M, 3C]
    stats = x.new_empty(2 * b * heads * s + b * s * c, dtype=torch.float32)   # lse2, D; gxn
    dx = torch.empty_like(x)
    ck.launch(op, x.data_ptr(), g.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), wq.data_ptr(),
              wk.data_ptr(), wv.data_ptr(), wo.data_ptr(), scratch.data_ptr(), stats.data_ptr(), dx.data_ptr(),
              b, s, c, heads, eps, *plan.qkv.launch_args, *plan.gattn.launch_args, *plan.gxn.launch_args)
    return dx


class _FusedLnSelfAttention(torch.autograd.Function):
    """Forward K1, backward K7 for dx; any other input that needs a gradient
    gets it from autograd over the plain version, recomputed (in adapter
    training every weight here is frozen, so only K7 runs)."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, wq, wk, wv, wo, bo, heads, eps):
        ctx.save_for_backward(x, ln_w, ln_b, wq, wk, wv, wo, bo)
        ctx.heads, ctx.eps = heads, eps
        return fused_ln_self_attention(x, ln_w, ln_b, wq, wk, wv, wo, bo, heads, eps)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:8]
        g = g.contiguous()
        grads = [None] * 8
        if needs[0]:
            grads[0] = fused_ln_self_attention_bwd_dx(saved[0], g, *saved[1:7], ctx.heads, ctx.eps)
        if any(needs[1:]):
            rest = ck.plain_vjp(lambda *a: fused_ln_self_attention_plain(*a, ctx.heads, ctx.eps),
                                saved, (False,) + tuple(needs[1:]), g)
            grads[1:] = rest[1:]
        return (*grads, None, None)


def fused_ln_self_attention_vjp(x, ln_w, ln_b, wq, wk, wv, wo, bo, heads: int,
                                eps: float = 1e-5) -> torch.Tensor:
    """K1 as a differentiable op (the JAX ``fused_ln_self_attention_vjp``)."""

    if not torch.is_grad_enabled():   # inference: the raw op, no autograd node
        return fused_ln_self_attention(x, ln_w, ln_b, wq, wk, wv, wo, bo, heads, eps)
    return _FusedLnSelfAttention.apply(x, ln_w, ln_b, wq, wk, wv, wo, bo, heads, eps)
