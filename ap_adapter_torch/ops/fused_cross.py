"""Fused pre-LN cross-attention,
``x + Wo·[softmax(q·kᵀ + bias)·v + s·softmax(q·k_ipᵀ)·v_ip] + bo``, ``q = LN(x)Wq``:
K2 over precomputed K/V, K4 projecting them from the context, and K8, K4's
backward.

K2 replaces ``ap_adapter_tpu/ops/pallas_fused_cross.py::fused_ln_cross_attention_kv``
(``_kernel_kv``). It runs at every UNet cross-attention site of the edit
path: the GPT-2 + AudioMAE stream with the adapter's second K/V set, and the
T5 stream with its padding bias. The conditioning K/V are projected once per
generate (``models/hoist.py``) and arrive in the natural ``[B, Sk, heads*d]``
layout.

Kernel (``csrc/fused_hopper.cu``, ``apk_fused_ln_cross_attention_kv``),
four launches a call, on the Hopper routines K1 runs on: the LayerNorm row
pass; the Q GEMM (``csrc/hopper_gemm.cuh``: TMA into a ring of stages,
``wgmma``, split-K clusters where the output tiles do not fill the SMs); the
register-resident two-key-set attention (``mma.sync``, logits, probabilities
and output in registers), which runs the text K/V (with the fp32 key bias,
if any) and then the adapter K/V through one double buffer, each set with
its own online softmax, and stores ``out + s·out_ip``, combined in fp32, with
one bf16 rounding; and the out GEMM with bias and residual in its epilogue.
``k2_plan`` plans the GEMMs, ``key_tile`` each set's key tile (16, 32 or 64
keys: at d = 32 a tile's time is its exponentials, so GPT-2's 8 keys take a
16-key tile). LN(x), q and the attention output make one round trip through
device memory, in one scratch allocation a call. Contexts are short (8 + 128
or 64 keys), so on an H100 the cost is the two [S, C]x[C, C] projections and
the launches' own latency.

K4 replaces ``pallas_fused_cross.py::fused_ln_cross_attention`` (``_kernel``):
the cross site when K/V are not hoisted, as in training. The kernel
(``csrc/fused_hopper.cu``, ``apk_fused_ln_cross_attention``), five launches
a call: the context K/V GEMM (``csrc/hopper_gemm.cuh::launch_ctx_kv``, as
K11c's: the text K/V from the first ``num_ip_tokens`` context rows and the
adapter K/V from the rest, 2 or 4 weight sets in one launch, the rows read
in place from the strided context through 3-D tensor maps), then K2's four
launches over the K/V it projected. The projections are [B·Sk, Dc]x[Dc, C]
with Dc = 768 or 1024 and Sk up to 520; at pool 1 they are as large as the
query projection. ``k4_plan`` plans it, with one scratch allocation a call.

K8 replaces ``pallas_fused_cross.py::fused_ln_cross_attention_bwd``
(``csrc/train_blocks.cu``, ``apk_fused_ln_cross_attention_bwd``), eight
launches at an adapter site and seven elsewhere: the context K/V GEMM, the
LayerNorm rows and the Q GEMM recomputed as K4 runs them; ``gattn = g·Wo``
(the GEMM reading Wo [K, N] MN-major, as K7's); the two-set dq kernel
(``csrc/attn_bwd.cuh``: sweep 1 over the text keys with their T5 bias and
then the adapter keys, each set's row statistics, sweep 2 over both sets
into one dq, the adapter's output gradient ``bf16(s·gattn)`` as JAX rounds
it); the dkv kernel over the adapter keys alone, which gives the
per-position ``dk_ip``/``dv_ip`` in fp32 (the text branch needs only dq,
never dk/dv); ``gxn = dq·Wq`` in fp32 and the LayerNorm backward.
``k8_plan`` plans it. The adapter weight gradients ``dW = dk_ipᵀ·ctx_ip``
are one library product outside the kernel (``adapter_weight_grads``), as
the JAX package leaves them to XLA.
"""

from __future__ import annotations

import functools
from typing import Iterator, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ap_adapter_torch.models.layers import layer_norm_f32
from ap_adapter_torch.ops import cuda_kernels as ck
from ap_adapter_torch.ops.attention import sdpa
from ap_adapter_torch.ops.hopper_gemm import (
    H100_SMS, GemmPlan, check_ln_width, ctx_kv_plan, gemm_plan, scratch_layout)

KEY_TILES = (16, 32, 64)    # keys a tile of the register-resident attention (a stage holds 64)


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


def key_tile(n: int) -> int:
    """Keys a tile of the register-resident attention (``fused_hopper.cu``)
    for a key set of n keys: the narrowest of ``KEY_TILES`` that holds the
    set, else the widest (``scripts/sweep_block_plans.py``)."""

    return next((tk for tk in KEY_TILES if n <= tk), KEY_TILES[-1])


def key_tiles(n: int, n_ip: int) -> Iterator[Tuple[int, int, int, bool]]:
    """The attention's key tiles in the order it runs them, by the kernel's
    formulas: the first set's ``ceil(n / tk)`` tiles, then the second's, as
    (set, first key, keys, masks) with masks = first key + keys > the set's
    count."""

    for kset, count in enumerate((n, n_ip)):
        tk = key_tile(count)
        for it in range(-(-count // tk)):
            yield kset, it * tk, tk, it * tk + tk > count


def _check_block(op: str, c: int, heads: int) -> None:
    ck.check_heads(op, c, heads)
    check_ln_width(op, c)


class K2Plan(NamedTuple):
    q: GemmPlan         # LN(x) [M, C] x Wq, bf16 store
    out: GemmPlan       # attention [M, C] x Wo, bias + residual


@functools.lru_cache(maxsize=None)
def k2_plan(b: int, s: int, c: int, heads: int, sms: int = H100_SMS) -> K2Plan:
    """The launches of K2's GEMMs on x [b, s, c], by ``gemm_plan`` (the
    attention's grid is fixed: 64 query rows a CTA). Raises on a width the
    kernels do not take (``ck.check_heads``)."""

    _check_block("fused_ln_cross_attention_kv", c, heads)
    plan = gemm_plan(b * s, c, c, sms=sms)      # both [M, C] x [C, C]
    return K2Plan(plan, plan)


def _check_wq_wo(op: str, c: int, wq, wo) -> None:
    if wq.shape != (c, c) or wo.shape != (c, c):
        raise ValueError(f"{op}: wq/wo must be [{c}, {c}]")


def fused_ln_cross_attention_kv(
    x, k, v, ln_w, ln_b, wq, wo, bo, heads: int, *,
    ki: Optional[torch.Tensor] = None, vi: Optional[torch.Tensor] = None,
    ip_scale: float = 0.0, bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
) -> torch.Tensor:
    """K2 on a CUDA tensor (bf16; ``bias`` fp32), the plain version on a CPU
    tensor. Inference only: it records no autograd graph and has no backward
    (the JAX package's K2 has none either)."""

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
    _check_wq_wo(op, c, wq, wo)
    operands = dict(x=x, k=k, v=v, ln_w=ln_w, ln_b=ln_b, wq=wq, wo=wo, bo=bo, ki=ki, vi=vi, bias=bias)
    ck.check_contiguous(op, **operands)
    ck.check_no_grad(op, **operands)
    if x.device.type == "cpu":
        return fused_ln_cross_attention_kv_plain(
            x, k, v, ln_w, ln_b, wq, wo, bo, heads, ki=ki, vi=vi, ip_scale=ip_scale,
            bias=bias, eps=eps)
    plan = k2_plan(b, s, c, heads, ck.sm_count(x.device))
    ck.check_operands(op, x, **operands)
    scratch = x.new_empty(3, b * s, c)       # LN(x), q, attention output
    out = torch.empty_like(x)
    ck.launch(op, x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), wq.data_ptr(), wo.data_ptr(),
              bo.data_ptr(), k.data_ptr(), v.data_ptr(), sk, ck.ptr(bias), ck.ptr(ki), ck.ptr(vi),
              sk_ip, float(ip_scale), scratch.data_ptr(), out.data_ptr(), b, s, c, heads, eps,
              key_tile(sk), key_tile(sk_ip), *plan.q.launch_args, *plan.out.launch_args)
    return out


# -- K4 and K8: the context-projecting form and its backward -------------------


def _split_context(context, wk_ip, num_ip_tokens: int):
    """(text rows, adapter rows or None) of ``context``."""

    if wk_ip is None:
        return context, None
    return context[:, :num_ip_tokens], context[:, num_ip_tokens:]


def fused_ln_cross_attention_plain(
    x, context, ln_w, ln_b, wq, wk, wv, wo, bo, heads: int, *,
    wk_ip=None, wv_ip=None, ip_scale: float = 0.0, num_ip_tokens: int = 8,
    bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
) -> torch.Tensor:
    """Plain PyTorch version of K4 (the JAX ``_xla_reference``): context
    [B, Sk, Dc]; the adapter K/V (wk_ip/wv_ip [C, Dc], cast to the context's
    dtype) come from the rows past ``num_ip_tokens``; bias [B, Sk_text]."""

    text, ip = _split_context(context, wk_ip, num_ip_tokens)
    k, v = F.linear(text, wk), F.linear(text, wv)
    ki = vi = None
    if ip is not None:
        ki, vi = F.linear(ip, wk_ip.to(ip.dtype)), F.linear(ip, wv_ip.to(ip.dtype))
    return fused_ln_cross_attention_kv_plain(x, k, v, ln_w, ln_b, wq, wo, bo, heads, ki=ki, vi=vi,
                                             ip_scale=ip_scale, bias=bias, eps=eps)


def _check_cross(op: str, x, context, wk, wv, wq, wo, wk_ip, wv_ip, num_ip_tokens: int, bias):
    """-> (sk_text, sk_ip) after the shape checks K4 and K8 share."""

    b, s, c = x.shape
    if context.dim() != 3 or context.shape[0] != b:
        raise ValueError(f"{op}: context must be [{b}, Sk, Dc], got {tuple(context.shape)}")
    sk, dc = context.shape[1], context.shape[2]
    if (wk_ip is None) != (wv_ip is None):
        raise ValueError(f"{op}: wk_ip and wv_ip go together")
    for name, w in (("wk", wk), ("wv", wv), ("wk_ip", wk_ip), ("wv_ip", wv_ip)):
        if w is not None and w.shape != (c, dc):
            raise ValueError(f"{op}: {name} must be [{c}, {dc}], got {tuple(w.shape)}")
    _check_wq_wo(op, c, wq, wo)
    sk_text, sk_ip = (sk, 0) if wk_ip is None else (num_ip_tokens, sk - num_ip_tokens)
    if sk_text <= 0 or (wk_ip is not None and sk_ip <= 0):
        raise ValueError(f"{op}: context of {sk} rows leaves no text or adapter keys "
                         f"(num_ip_tokens={num_ip_tokens})")
    if bias is not None and bias.shape != (b, sk_text):
        raise ValueError(f"{op}: bias must be [{b}, {sk_text}], got {tuple(bias.shape)}")
    return sk_text, sk_ip


class K4Plan(NamedTuple):
    kv: GemmPlan        # context rows x Wk, Wv (, Wk_ip, Wv_ip), bf16 store: B x ctx_tiles row tiles, 2 or 4 sets
    q: GemmPlan         # LN(x) [M, C] x Wq, bf16 store (K2's)
    out: GemmPlan       # attention [M, C] x Wo, bias + residual (K2's)
    tk: int             # keys a tile of the text set
    tk_ip: int          # keys a tile of the adapter set
    offsets: Tuple[int, ...]   # kv (k, v, ki, vi), then K2's LN(x), q, attention output in the scratch
    nbytes: int


@functools.lru_cache(maxsize=None)
def k4_plan(b: int, s: int, c: int, heads: int, sk_text: int, sk_ip: int, dc: int,
            sms: int = H100_SMS) -> K4Plan:
    """The launches of K4 on x [b, s, c] against a context of ``sk_text``
    text and ``sk_ip`` adapter rows (0: no adapter set) of width ``dc``: the
    context K/V GEMM (``ctx_kv_plan``), K2's Q and out GEMMs by
    ``gemm_plan``, each key set's tile (``key_tile``) and the scratch.
    Raises on a width the kernels do not take."""

    op = "fused_ln_cross_attention"
    _check_block(op, c, heads)
    kv = ctx_kv_plan(op, b, c, sk_text, sk_ip, dc, sms)
    plan = gemm_plan(b * s, c, c, sms=sms)      # both [M, C] x [C, C]
    offsets, nbytes = scratch_layout(2 * 2 * b * (sk_text + sk_ip) * c, 3 * 2 * b * s * c)
    return K4Plan(kv, plan, plan, key_tile(sk_text), key_tile(sk_ip), offsets, nbytes)


class K8Plan(NamedTuple):
    kv: GemmPlan        # K4's context K/V GEMM
    q: GemmPlan         # LN(x) [M, C] x Wq, bf16 store
    gattn: GemmPlan     # g [M, C] x Wo read as [K, N], bf16 store
    gxn: GemmPlan       # dq [M, C] x Wq read as [K, N], fp32 store
    offsets: Tuple[int, ...]   # kv (k, v, ki, vi); LN(x), q, gattn, bf16(s·gattn), dq; lse2, D, gxn in the scratch
    nbytes: int


@functools.lru_cache(maxsize=None)
def k8_plan(b: int, s: int, c: int, heads: int, sk_text: int, sk_ip: int, dc: int,
            sms: int = H100_SMS) -> K8Plan:
    """The launches of K8 on x [b, s, c] against K4's context: K4's context
    K/V and Q GEMMs, ``g·Wo`` and ``gxn = dq·Wq`` by ``gemm_plan`` (the
    attention backward's grids are fixed: 64 query rows, or 64 adapter keys,
    a CTA, and 64-key tiles of both sets), and the scratch: the K/V (bf16),
    five [M, C] bf16 buffers, and fp32 lse2 and D of both sets [2, b, heads,
    s] each and gxn [M, C]. Raises on a width the kernels do not take."""

    op = "fused_ln_cross_attention_bwd"
    _check_block(op, c, heads)
    kv = ctx_kv_plan(op, b, c, sk_text, sk_ip, dc, sms)
    m = b * s
    plan = gemm_plan(m, c, c, sms=sms)          # Q, g·Wo and dq·Wq: [M, C] x [C, C]
    offsets, nbytes = scratch_layout(2 * 2 * b * (sk_text + sk_ip) * c, 5 * 2 * m * c,
                                     4 * (2 * 2 * b * heads * s + m * c))
    return K8Plan(kv, plan, plan, plan, offsets, nbytes)


def fused_ln_cross_attention(
    x, context, ln_w, ln_b, wq, wk, wv, wo, bo, heads: int, *,
    wk_ip=None, wv_ip=None, ip_scale: float = 0.0, num_ip_tokens: int = 8,
    bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
) -> torch.Tensor:
    """K4 on a CUDA tensor (bf16 operands, ``bias`` fp32), the plain version
    on a CPU tensor. Records no autograd graph: differentiable callers use
    ``fused_ln_cross_attention_vjp``."""

    op = "fused_ln_cross_attention"
    b, s, c = x.shape
    sk_text, sk_ip = _check_cross(op, x, context, wk, wv, wq, wo, wk_ip, wv_ip, num_ip_tokens, bias)
    operands = dict(x=x, context=context, ln_w=ln_w, ln_b=ln_b, wq=wq, wk=wk, wv=wv, wo=wo, bo=bo,
                    wk_ip=wk_ip, wv_ip=wv_ip, bias=bias)
    ck.check_contiguous(op, **operands)
    ck.check_no_grad(op, **operands)
    if x.device.type == "cpu":
        return fused_ln_cross_attention_plain(
            x, context, ln_w, ln_b, wq, wk, wv, wo, bo, heads, wk_ip=wk_ip, wv_ip=wv_ip,
            ip_scale=ip_scale, num_ip_tokens=num_ip_tokens, bias=bias, eps=eps)
    ck.check_operands(op, x, **operands)
    plan = k4_plan(b, s, c, heads, sk_text, sk_ip, context.shape[2], ck.sm_count(x.device))
    scratch = x.new_empty(plan.nbytes, dtype=torch.uint8)
    out = torch.empty_like(x)
    kv, act = (scratch.data_ptr() + o for o in plan.offsets)
    ck.launch(op, x.data_ptr(), context.data_ptr(), context.shape[1], context.shape[2], sk_text,
              ln_w.data_ptr(), ln_b.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
              ck.ptr(wk_ip), ck.ptr(wv_ip), wo.data_ptr(), bo.data_ptr(), float(ip_scale), ck.ptr(bias),
              kv, act, out.data_ptr(), b, s, c, heads, eps, plan.tk, plan.tk_ip,
              *plan.kv.launch_args, *plan.q.launch_args, *plan.out.launch_args)
    return out


def fused_ln_cross_attention_bwd_plain(
    x, g, context, ln_w, ln_b, wq, wk, wv, wo, heads: int, *,
    wk_ip=None, wv_ip=None, ip_scale: float = 0.0, num_ip_tokens: int = 8,
    bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
):
    """Plain version of K8: (dx, dki, dvi) of K4's plain version for the
    output gradient g; dki/dvi [B, Sk_ip, C] fp32 are the gradients of the
    adapter's projected K/V (None without an adapter branch)."""

    text, ip = _split_context(context, wk_ip, num_ip_tokens)
    k, v = F.linear(text, wk), F.linear(text, wv)
    bo = wo.new_zeros(wo.shape[0])
    if ip is None:
        fn = lambda x_: fused_ln_cross_attention_kv_plain(x_, k, v, ln_w, ln_b, wq, wo, bo, heads,
                                                          bias=bias, eps=eps)
        return ck.plain_vjp(fn, (x,), (True,), g)[0], None, None
    ki, vi = F.linear(ip, wk_ip.to(ip.dtype)), F.linear(ip, wv_ip.to(ip.dtype))
    fn = lambda x_, ki_, vi_: fused_ln_cross_attention_kv_plain(
        x_, k, v, ln_w, ln_b, wq, wo, bo, heads, ki=ki_, vi=vi_, ip_scale=ip_scale, bias=bias, eps=eps)
    dx, dki, dvi = ck.plain_vjp(fn, (x, ki, vi), (True, True, True), g)
    return dx, dki.float(), dvi.float()


def fused_ln_cross_attention_bwd(
    x, g, context, ln_w, ln_b, wq, wk, wv, wo, heads: int, *,
    wk_ip=None, wv_ip=None, ip_scale: float = 0.0, num_ip_tokens: int = 8,
    bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
):
    """K8 on a CUDA tensor (bf16 operands, ``bias`` fp32), the plain version
    on a CPU tensor: (dx, dki, dvi)."""

    op = "fused_ln_cross_attention_bwd"
    b, s, c = x.shape
    sk_text, sk_ip = _check_cross(op, x, context, wk, wv, wq, wo, wk_ip, wv_ip, num_ip_tokens, bias)
    if g.shape != x.shape:
        raise ValueError(f"{op}: g must be {tuple(x.shape)}, got {tuple(g.shape)}")
    operands = dict(x=x, g=g, context=context, ln_w=ln_w, ln_b=ln_b, wq=wq, wk=wk, wv=wv, wo=wo,
                    wk_ip=wk_ip, wv_ip=wv_ip, bias=bias)
    ck.check_contiguous(op, **operands)
    ck.check_no_grad(op, **operands)
    if x.device.type == "cpu":
        return fused_ln_cross_attention_bwd_plain(
            x, g, context, ln_w, ln_b, wq, wk, wv, wo, heads, wk_ip=wk_ip, wv_ip=wv_ip,
            ip_scale=ip_scale, num_ip_tokens=num_ip_tokens, bias=bias, eps=eps)
    ck.check_operands(op, x, **operands)
    plan = k8_plan(b, s, c, heads, sk_text, sk_ip, context.shape[2], ck.sm_count(x.device))
    scratch = x.new_empty(plan.nbytes, dtype=torch.uint8)
    dx = torch.empty_like(x)
    dki = dvi = None
    if sk_ip:
        dki, dvi = x.new_empty(2, b, sk_ip, c, dtype=torch.float32).unbind(0)
    kv, act, stats = (scratch.data_ptr() + o for o in plan.offsets)
    ck.launch(op, x.data_ptr(), g.data_ptr(), context.data_ptr(), context.shape[1], context.shape[2],
              sk_text, ln_w.data_ptr(), ln_b.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
              ck.ptr(wk_ip), ck.ptr(wv_ip), wo.data_ptr(), float(ip_scale), ck.ptr(bias), kv, act, stats,
              dx.data_ptr(), ck.ptr(dki), ck.ptr(dvi), b, s, c, heads, eps, *plan.kv.launch_args,
              *plan.q.launch_args, *plan.gattn.launch_args, *plan.gxn.launch_args)
    return dx, dki, dvi


def adapter_weight_grads(dk: torch.Tensor, dv: torch.Tensor, ip: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The adapter projections' weight gradients ``dW = Σ_b dᵀ·ip`` [C, Dc]
    in fp32, for d = dk and dv [B, Sk_ip, C] (K8's per-position gradients,
    fp32) and the adapter's context rows ip [B, Sk_ip, Dc], with JAX's
    roundings (``pallas_fused_cross.py:710-713``): the gradients in the
    context's dtype, fp32 accumulation, an fp32 result. On the card with a
    bf16 context, both in one tensor-core product with an fp32 result
    (``torch.mm(..., out_dtype=torch.float32)`` over ``[dk | dv]``);
    elsewhere the same in fp32 arithmetic (in fp32 the cast rounds
    nothing)."""

    if dk.is_cuda and ip.dtype == torch.bfloat16:
        c = dk.shape[-1]
        d = torch.cat((dk, dv), -1).to(ip.dtype).reshape(-1, 2 * c)
        w = torch.mm(d.t(), ip.reshape(-1, ip.shape[-1]), out_dtype=torch.float32)
        return w[:c], w[c:]
    return tuple(torch.einsum("bkc,bkd->cd", t.to(ip.dtype).float(), ip.float()) for t in (dk, dv))


class _FusedLnCrossAttention(torch.autograd.Function):
    """Forward K4, backward K8: dx, and the adapter weight gradients
    ``dW_k_ip = dk_ipᵀ·ctx_ip`` / ``dW_v_ip`` in fp32 (``adapter_weight_grads``;
    returned in the adapter weights' own dtype, fp32 in training). Any other
    input that needs a gradient gets it from autograd over the plain
    version, recomputed; the context is frozen input and gets none unless
    asked."""

    @staticmethod
    def forward(ctx, x, context, ln_w, ln_b, wq, wk, wv, wo, bo, wk_ip, wv_ip, bias,
                heads, ip_scale, num_ip_tokens, eps):
        ctx.save_for_backward(x, context, ln_w, ln_b, wq, wk, wv, wo, bo, wk_ip, wv_ip, bias)
        ctx.args = (heads, ip_scale, num_ip_tokens, eps)
        wki = None if wk_ip is None else wk_ip.to(x.dtype)
        wvi = None if wv_ip is None else wv_ip.to(x.dtype)
        return fused_ln_cross_attention(x, context, ln_w, ln_b, wq, wk, wv, wo, bo, heads, wk_ip=wki,
                                        wv_ip=wvi, ip_scale=ip_scale, num_ip_tokens=num_ip_tokens,
                                        bias=bias, eps=eps)

    @staticmethod
    def backward(ctx, g):
        x, context, ln_w, ln_b, wq, wk, wv, wo, bo, wk_ip, wv_ip, bias = saved = ctx.saved_tensors
        heads, ip_scale, num_ip_tokens, eps = ctx.args
        needs = ctx.needs_input_grad[:12]
        g = g.contiguous()
        grads = [None] * 12
        if needs[0] or needs[9] or needs[10]:
            wki = None if wk_ip is None else wk_ip.to(x.dtype)
            wvi = None if wv_ip is None else wv_ip.to(x.dtype)
            dx, dki, dvi = fused_ln_cross_attention_bwd(
                x, g, context, ln_w, ln_b, wq, wk, wv, wo, heads, wk_ip=wki, wv_ip=wvi,
                ip_scale=ip_scale, num_ip_tokens=num_ip_tokens, bias=bias, eps=eps)
            grads[0] = dx if needs[0] else None
            if wk_ip is not None and (needs[9] or needs[10]):
                dwk, dwv = adapter_weight_grads(dki, dvi, context[:, num_ip_tokens:])
                grads[9] = dwk.to(wk_ip.dtype) if needs[9] else None
                grads[10] = dwv.to(wv_ip.dtype) if needs[10] else None
        rest = [n if i not in (0, 9, 10) else False for i, n in enumerate(needs)]
        if any(rest):
            fn = lambda x_, c_, lw, lb, q_, k_, v_, o_, bo_, ki_, vi_, bias_: fused_ln_cross_attention_plain(
                x_, c_, lw, lb, q_, k_, v_, o_, bo_, heads, wk_ip=ki_, wv_ip=vi_, ip_scale=ip_scale,
                num_ip_tokens=num_ip_tokens, bias=bias_, eps=eps)
            for i, gr in enumerate(ck.plain_vjp(fn, saved, rest, g)):
                if rest[i]:
                    grads[i] = gr
        return (*grads, None, None, None, None)


def fused_ln_cross_attention_vjp(
    x, context, ln_w, ln_b, wq, wk, wv, wo, bo, heads: int, *,
    wk_ip=None, wv_ip=None, ip_scale: float = 0.0, num_ip_tokens: int = 8,
    bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
) -> torch.Tensor:
    """K4 as a differentiable op (the JAX ``fused_ln_cross_attention_vjp``)."""

    if not torch.is_grad_enabled():   # inference: the raw op (adapter weights in x's dtype), no autograd node
        return fused_ln_cross_attention(
            x, context, ln_w, ln_b, wq, wk, wv, wo, bo, heads,
            wk_ip=None if wk_ip is None else wk_ip.to(x.dtype), wv_ip=None if wv_ip is None else wv_ip.to(x.dtype),
            ip_scale=ip_scale, num_ip_tokens=num_ip_tokens, bias=bias, eps=eps)
    return _FusedLnCrossAttention.apply(x, context, ln_w, ln_b, wq, wk, wv, wo, bo, wk_ip, wv_ip, bias,
                                        heads, float(ip_scale), num_ip_tokens, eps)
