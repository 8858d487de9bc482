"""int8 (W8A8) serving variants of the fused transformer-block ops: K11a-c.

K11a replaces ``ap_adapter_tpu/ops/pallas_int8.py::fused_ln_geglu_ff_int8``
(:118), K11b ``fused_ln_self_attention_int8`` (:259) and K11c
``fused_ln_cross_attention_int8`` (:410). They run at every UNet transformer
site when ``UNetConfig.use_int8`` is set, on weights quantized once by
``models/unet.py::quantize_unet_int8_``. Serving only: the TPU kernels
define no VJP, and there is no autograd Function here either.

Quantization is the TPU package's, operation for operation:

* weights symmetric per output channel (``quantize_weight``, JAX :63):
  ``scale = max(amax, 1e-8) / 127`` (a multiplication by fp32 ``1/127``, as
  XLA compiles it) and ``w8 = round(w / scale)``;
* activations per row, dynamically (``quant_rows``, JAX :80):
  ``scale = max(amax, 1e-8) * (1/127)`` and ``q = round(x * (1/scale))``;
* rounding half to even: ``torch.round`` here, ``__float2int_rn`` in the
  kernels, as ``jnp.round`` does;
* every quantized activation comes from fp32: the LayerNorm row (the TPU
  kernels' ``_ln`` formula, ``ln_f32``), the fp32 attention output and the
  fp32 GEGLU product. A bf16 round trip first would move values across int8
  rounding boundaries.

What is int8: the q and out projections of both attention ops and both
GEGLU products. What stays in the activation dtype: the K/V projections and
the QK/PV products (the TPU package measured those shapes losing under int8,
and softmax probabilities do not fit an int8 grid). The integer products
are exact in the plain versions: int32 on the CPU, float64 on the card
(PyTorch has no int32 matmul there; ``|sum| <= 2560 * 127**2 < 2**53``).

Unlike the TPU package, nothing pads heads: ``quantize_attention_weights``
quantizes the Linear weights as they are (head dims 48 and 80 included).
The TPU's padded columns and rows are zeros, so they change no scale and no
int8 value of a real channel.

Kernels (``csrc/int8_blocks.cu``), all three on the Hopper routines: a
LayerNorm + quantize row pass (one warp a row, fp32 two-pass statistics),
an int8 ``wgmma``/TMA GEMM (exact int32 sums, split-K clusters where the
output tiles are few; its epilogue dequantizes by row and column scale),
the quantization of fp32 rows, K1's bf16 Hopper GEMM and the
register-resident attention with an fp32 store.

* K11a, four device kernels (``k11a_plan``): the row pass (int8 rows
  only); the W1 product on the int8 GEMM with a GEGLU epilogue (value and
  gate columns side by side in two int32 accumulators, the fp32 GEGLU
  product stored in fp32); the quantization of those rows; the W2 product
  with bias and residual.
* K11b, six (``k11b_plan``): the row pass, which also writes the bf16 rows
  of the K/V GEMM; the int8 q GEMM (q scaled by 1/sqrt(d)); the K/V GEMM;
  the attention over one key set; the quantization of its rows; the int8
  out GEMM with bias and residual.
* K11c, six (``k11c_plan``): the text and adapter K/V projected from the
  context on the bf16 GEMM in one launch (each key set's rows read through
  a 3-D tensor map over the strided context, no copy); then K11b's chain
  with the row pass's int8 rows only and K2's two-key-set attention (the
  fp32 T5 bias on the text set). It projects the context on every call, as
  the TPU kernel does: under ``use_int8`` the UNet hoists no K/V.

Each wrapper takes one scratch allocation a call. On an H100 the kernels
are bound by launches and activation round trips through device memory,
not by the int8 tensor-core rate; times and bounds are in ``PERF.md``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ap_adapter_torch.ops import cuda_kernels as ck
from ap_adapter_torch.ops.fused_block import _check_weights
from ap_adapter_torch.ops.fused_cross import _check_cross, _split_context, key_tile
from ap_adapter_torch.ops.fused_ff import _check_widths
from ap_adapter_torch.ops.hopper_gemm import (
    H100_SMS, GemmPlan, check_ln_width, ctx_kv_plan, gemm_plan, scratch_layout)

_INV127 = 1.0 / 127.0


def quantize_weight(w: torch.Tensor):
    """Linear weight [out, in] -> (int8 [out, in], fp32 scale [out]),
    symmetric per output channel."""

    wf = w.detach().float()
    # max(amax, 1e-8) / 127 as XLA compiles the JAX division by a constant:
    # a multiplication by the fp32 reciprocal (so does PyTorch's division by
    # a Python scalar; written out so that it does not depend on that)
    scale = torch.clamp(wf.abs().amax(dim=1, keepdim=True), min=1e-8) * _INV127
    return torch.round(wf / scale).to(torch.int8), scale[:, 0].contiguous()


def quant_rows(x32: torch.Tensor):
    """fp32 [..., c] -> (int8 [..., c], fp32 per-row scale [...])."""

    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) * _INV127
    return torch.round(x32 * (1.0 / scale)).to(torch.int8), scale[..., 0]


def quantize_attention_weights(wq, wk, wv, wo):
    """-> (wq8, sq, wk, wv, wo8, so): the weight arguments of K11b/K11c, from
    the Linear weights [out, in], with no head padding."""

    wq8, sq = quantize_weight(wq)
    wo8, so = quantize_weight(wo)
    return wq8, sq, wk, wv, wo8, so


def ln_f32(x, w, b, eps: float) -> torch.Tensor:
    """The TPU kernels' LayerNorm in fp32: (x - mean) * rsqrt(var + eps) * w + b."""

    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * w.float() + b.float()


def _int_mm(a8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Exact ``a8 [..., K] @ w8 [N, K]^T`` as fp32: int32 on the CPU, float64
    on the card, either rounded once to fp32."""

    a2 = a8.reshape(-1, a8.shape[-1])
    if a8.device.type == "cpu":
        out = torch.matmul(a2.int(), w8.int().t())
    else:
        out = torch.matmul(a2.double(), w8.double().t())
    return out.float().reshape(*a8.shape[:-1], w8.shape[0])


def _dequant(a8, sa, w8, sw) -> torch.Tensor:
    return _int_mm(a8, w8) * sa[..., None] * sw


def _q_proj(xn, wq8, sq, heads: int, dtype) -> torch.Tensor:
    """The int8 q projection of the fp32 LayerNorm rows, pre-scaled by 1/sqrt(d)."""

    x8, sx = quant_rows(xn)
    return (_dequant(x8, sx, wq8, sq) * (float(wq8.shape[0] // heads) ** -0.5)).to(dtype)


def _out_proj(x, attn, wo8, so, bo) -> torch.Tensor:
    """x + the int8 out projection of the fp32 attention output, + bo."""

    a8, sa = quant_rows(attn)
    return (x.float() + (_dequant(a8, sa, wo8, so) + bo.float())).to(x.dtype)


def _attend(q, k, v, heads: int, bias=None) -> torch.Tensor:
    """fp32 [B, S, C] = softmax(q k^T + bias) v per head for pre-scaled q
    (the TPU kernels' staircase attention): fp32 logits, max-subtracted
    softmax, the probabilities in v's dtype for the PV product, normalised
    after it."""

    b, s, c = q.shape
    d = c // heads
    logits = torch.einsum("bqhd,bkhd->bhqk", q.reshape(b, s, heads, d).float(),
                          k.reshape(b, -1, heads, d).float())
    if bias is not None:
        logits = logits + bias[:, None, None, :].float()
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.reshape(b, -1, heads, d).float())
    return (o / p.sum(-1).transpose(1, 2)[..., None]).reshape(b, s, c)


# -- plain versions ----------------------------------------------------------


def fused_ln_geglu_ff_int8_plain(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, eps: float = 1e-5) -> torch.Tensor:
    """Plain version of K11a: x [B, S, C]; w1q int8 [2*inner, C] with s1 [2*inner],
    w2q int8 [C, inner] with s2 [C]."""

    x8, sx = quant_rows(ln_f32(x, ln_w, ln_b, eps))
    a, g = (_dequant(x8, sx, w1q, s1) + b1.float()).chunk(2, dim=-1)
    y8, sy = quant_rows(a * g * 0.5 * (1.0 + torch.erf(g * 2 ** -0.5)))
    return (x.float() + (_dequant(y8, sy, w2q, s2) + b2.float())).to(x.dtype)


def fused_ln_self_attention_int8_plain(x, ln_w, ln_b, wq8, sq, wk, wv, wo8, so, bo, heads: int,
                                       eps: float = 1e-5) -> torch.Tensor:
    """Plain version of K11b: int8 q/out projections (wq8/wo8 [C, C] with
    sq/so [C]), bf16-path K/V (wk/wv [C, C] Linear weights)."""

    xn = ln_f32(x, ln_w, ln_b, eps)
    q = _q_proj(xn, wq8, sq, heads, x.dtype)
    xf = xn.to(x.dtype)
    return _out_proj(x, _attend(q, F.linear(xf, wk), F.linear(xf, wv), heads), wo8, so, bo)


def fused_ln_cross_attention_int8_plain(
    x, context, ln_w, ln_b, wq8, sq, wk, wv, wo8, so, bo, heads: int, *,
    wk_ip=None, wv_ip=None, ip_scale: float = 0.0, num_ip_tokens: int = 8,
    bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
) -> torch.Tensor:
    """Plain version of K11c: context [B, Sk, Dc]; text K/V from the first
    ``num_ip_tokens`` rows (all rows without an adapter), adapter K/V
    (wk_ip/wv_ip [C, Dc]) from the rest; bias [B, Sk_text] fp32 additive."""

    text, ip = _split_context(context, wk_ip, num_ip_tokens)
    q = _q_proj(ln_f32(x, ln_w, ln_b, eps), wq8, sq, heads, x.dtype)
    out = _attend(q, F.linear(text, wk), F.linear(text, wv), heads, bias)
    if ip is not None:
        out = out + ip_scale * _attend(q, F.linear(ip, wk_ip), F.linear(ip, wv_ip), heads)
    return _out_proj(x, out, wo8, so, bo)


# -- wrappers: the kernel on a CUDA tensor, the plain version on a CPU tensor --


def _check_quantized(op: str, **pairs) -> None:
    """Each value is (int8 weight, fp32 scale, expected weight shape)."""

    for name, (w8, scale, shape) in pairs.items():
        if w8.dtype != torch.int8 or tuple(w8.shape) != shape:
            raise ValueError(f"{op}: {name} must be int8 {list(shape)}, got {w8.dtype} {list(w8.shape)}")
        if scale.dtype != torch.float32 or tuple(scale.shape) != shape[:1]:
            raise ValueError(f"{op}: the scale of {name} must be fp32 [{shape[0]}], "
                             f"got {scale.dtype} {list(scale.shape)}")


def _quant_dtypes(w8: str, scale: str, w8b: str, scale_b: str) -> dict:
    """check_operands types: int8 for two quantized weights, fp32 for their scales."""

    return {w8: torch.int8, w8b: torch.int8, scale: torch.float32, scale_b: torch.float32}


class K11aPlan(NamedTuple):
    w1: GemmPlan        # int8 LN(x) rows [M, C] x W1q [2·inner, C], GEGLU epilogue, fp32 store
    w2: GemmPlan        # int8 GEGLU rows [M, inner] x W2q [C, inner], bias + residual
    offsets: Tuple[int, ...]   # x8, sx, y, y8, sy in the scratch
    nbytes: int


@functools.lru_cache(maxsize=None)
def k11a_plan(b: int, s: int, c: int, inner: int, sms: int = H100_SMS) -> K11aPlan:
    """The launches of K11a on x [b, s, c]: both int8 GEMMs by ``gemm_plan``
    (the W1 GEMM's 64-wide tiles carry the value and the gate columns), and
    its scratch. Raises on a width the kernels do not take."""

    op = "fused_ln_geglu_ff_int8"
    _check_widths(op, c, inner)
    check_ln_width(op, c)
    m = b * s
    offsets, nbytes = scratch_layout(m * c, 4 * m, 4 * m * inner, m * inner, 4 * m)
    return K11aPlan(gemm_plan(m, inner, c, geglu=True, sms=sms, int8=True), gemm_plan(m, c, inner, sms=sms, int8=True),
                    offsets, nbytes)


def fused_ln_geglu_ff_int8(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, eps: float = 1e-5) -> torch.Tensor:
    """K11a on a CUDA tensor (bf16 activations, LN and biases; int8 weights,
    fp32 scales), the plain version on a CPU tensor."""

    op = "fused_ln_geglu_ff_int8"
    b, s, c = x.shape
    inner = w2q.shape[1]
    _check_quantized(op, w1q=(w1q, s1, (2 * inner, c)), w2q=(w2q, s2, (c, inner)))
    operands = dict(x=x, ln_w=ln_w, ln_b=ln_b, w1q=w1q, s1=s1, b1=b1, w2q=w2q, s2=s2, b2=b2)
    ck.check_contiguous(op, **operands)
    ck.check_no_grad(op, **operands)
    if x.device.type == "cpu":
        return fused_ln_geglu_ff_int8_plain(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, eps)
    plan = k11a_plan(b, s, c, inner, ck.sm_count(x.device))
    ck.check_operands(op, x, _quant_dtypes("w1q", "s1", "w2q", "s2"), **operands)
    scratch = x.new_empty(plan.nbytes, dtype=torch.uint8)
    out = torch.empty_like(x)
    x8, sx, y, y8, sy = (scratch.data_ptr() + o for o in plan.offsets)
    ck.launch(op, x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1q.data_ptr(), s1.data_ptr(), b1.data_ptr(),
              w2q.data_ptr(), s2.data_ptr(), b2.data_ptr(), x8, sx, y, y8, sy, out.data_ptr(), b, s, c, inner, eps,
              *plan.w1.launch_args[1:], *plan.w2.launch_args)
    return out


class K11bPlan(NamedTuple):
    q: GemmPlan         # int8 LN(x) rows [M, C] x Wq8, bf16 store scaled by 1/sqrt(d)
    kv: GemmPlan        # bf16 LN(x) rows [M, C] x Wk, Wv, bf16 store
    out: GemmPlan       # int8 attention rows [M, C] x Wo8, bias + residual


@functools.lru_cache(maxsize=None)
def k11b_plan(b: int, s: int, c: int, heads: int, sms: int = H100_SMS) -> K11bPlan:
    """The launches of K11b's GEMMs on x [b, s, c]: the int8 q and out GEMMs
    and the bf16 K/V GEMM, by ``gemm_plan`` (the attention's grid is fixed:
    64 query rows a CTA). Raises on a width the kernels do not take."""

    op = "fused_ln_self_attention_int8"
    ck.check_heads(op, c, heads)
    check_ln_width(op, c)
    m = b * s
    i8 = gemm_plan(m, c, c, sms=sms, int8=True)
    return K11bPlan(i8, gemm_plan(m, c, c, sets=2, sms=sms), i8)


def fused_ln_self_attention_int8(x, ln_w, ln_b, wq8, sq, wk, wv, wo8, so, bo, heads: int,
                                 eps: float = 1e-5) -> torch.Tensor:
    """K11b on a CUDA tensor (bf16 activations, LN, wk/wv and bo; int8
    wq8/wo8, fp32 sq/so), the plain version on a CPU tensor."""

    op = "fused_ln_self_attention_int8"
    b, s, c = x.shape
    _check_quantized(op, wq8=(wq8, sq, (c, c)), wo8=(wo8, so, (c, c)))
    _check_weights(op, c, wk=wk, wv=wv)
    operands = dict(x=x, ln_w=ln_w, ln_b=ln_b, wq8=wq8, sq=sq, wk=wk, wv=wv, wo8=wo8, so=so, bo=bo)
    ck.check_contiguous(op, **operands)
    ck.check_no_grad(op, **operands)
    if x.device.type == "cpu":
        return fused_ln_self_attention_int8_plain(x, ln_w, ln_b, wq8, sq, wk, wv, wo8, so, bo, heads, eps)
    plan = k11b_plan(b, s, c, heads, ck.sm_count(x.device))
    ck.check_operands(op, x, _quant_dtypes("wq8", "sq", "wo8", "so"), **operands)
    x8 = x.new_empty(b * s, c, dtype=torch.int8)
    sx = x.new_empty(b * s, dtype=torch.float32)
    scratch = x.new_empty(4, b * s, c)       # LN(x), q, k, v
    attn = x.new_empty(b, s, c, dtype=torch.float32)
    out = torch.empty_like(x)
    ck.launch(op, x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), wq8.data_ptr(), sq.data_ptr(), wk.data_ptr(),
              wv.data_ptr(), wo8.data_ptr(), so.data_ptr(), bo.data_ptr(), x8.data_ptr(), sx.data_ptr(),
              scratch.data_ptr(), attn.data_ptr(), out.data_ptr(), b, s, c, heads, eps, float(c // heads) ** -0.5,
              *plan.q.launch_args, *plan.kv.launch_args, *plan.out.launch_args)
    return out


class K11cPlan(NamedTuple):
    kv: GemmPlan        # context rows x Wk, Wv (, Wk_ip, Wv_ip), bf16 store: B x ctx_tiles row tiles, 2 or 4 sets
    q: GemmPlan         # int8 LN(x) rows [M, C] x Wq8, bf16 store scaled by 1/sqrt(d)
    out: GemmPlan       # int8 attention rows [M, C] x Wo8, bias + residual
    tk: int             # keys a tile of the text set
    tk_ip: int          # keys a tile of the adapter set
    offsets: Tuple[int, ...]   # x8, sx, q, kv (k, v, ki, vi), attn in the scratch
    nbytes: int


@functools.lru_cache(maxsize=None)
def k11c_plan(b: int, s: int, c: int, heads: int, sk_text: int, sk_ip: int, dc: int,
              sms: int = H100_SMS) -> K11cPlan:
    """The launches of K11c on x [b, s, c] against a context of ``sk_text``
    text and ``sk_ip`` adapter rows (0: no adapter set) of width ``dc``: the
    context K/V GEMM (2 or 4 weight sets over ``b * ctx_tiles`` row tiles),
    the int8 q and out GEMMs by ``gemm_plan``, each key set's tile
    (``key_tile``) and the scratch. Raises on a width the kernels do not
    take."""

    op = "fused_ln_cross_attention_int8"
    ck.check_heads(op, c, heads)
    check_ln_width(op, c)
    kv = ctx_kv_plan(op, b, c, sk_text, sk_ip, dc, sms)
    m = b * s
    i8 = gemm_plan(m, c, c, sms=sms, int8=True)
    offsets, nbytes = scratch_layout(m * c, 4 * m, 2 * m * c, 2 * 2 * b * (sk_text + sk_ip) * c, 4 * m * c)
    return K11cPlan(kv, i8, i8, key_tile(sk_text), key_tile(sk_ip), offsets, nbytes)


def fused_ln_cross_attention_int8(
    x, context, ln_w, ln_b, wq8, sq, wk, wv, wo8, so, bo, heads: int, *,
    wk_ip=None, wv_ip=None, ip_scale: float = 0.0, num_ip_tokens: int = 8,
    bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
) -> torch.Tensor:
    """K11c on a CUDA tensor (bf16 activations, context, LN, K/V weights and
    bo; int8 wq8/wo8, fp32 sq/so, fp32 ``bias``), the plain version on a CPU
    tensor."""

    op = "fused_ln_cross_attention_int8"
    b, s, c = x.shape
    sk_text, sk_ip = _check_cross(op, x, context, wk, wv, wq8, wo8, wk_ip, wv_ip, num_ip_tokens, bias)
    _check_quantized(op, wq8=(wq8, sq, (c, c)), wo8=(wo8, so, (c, c)))
    operands = dict(x=x, context=context, ln_w=ln_w, ln_b=ln_b, wq8=wq8, sq=sq, wk=wk, wv=wv, wo8=wo8,
                    so=so, bo=bo, wk_ip=wk_ip, wv_ip=wv_ip, bias=bias)
    ck.check_contiguous(op, **operands)
    ck.check_no_grad(op, **operands)
    if x.device.type == "cpu":
        return fused_ln_cross_attention_int8_plain(
            x, context, ln_w, ln_b, wq8, sq, wk, wv, wo8, so, bo, heads, wk_ip=wk_ip, wv_ip=wv_ip,
            ip_scale=ip_scale, num_ip_tokens=num_ip_tokens, bias=bias, eps=eps)
    ck.check_operands(op, x, _quant_dtypes("wq8", "sq", "wo8", "so"), **operands)
    plan = k11c_plan(b, s, c, heads, sk_text, sk_ip, context.shape[2], ck.sm_count(x.device))
    scratch = x.new_empty(plan.nbytes, dtype=torch.uint8)
    out = torch.empty_like(x)
    x8, sx, q, kv, attn = (scratch.data_ptr() + o for o in plan.offsets)
    ck.launch(op, x.data_ptr(), context.data_ptr(), context.shape[1], context.shape[2], sk_text, ln_w.data_ptr(),
              ln_b.data_ptr(), wq8.data_ptr(), sq.data_ptr(), wk.data_ptr(), wv.data_ptr(), ck.ptr(wk_ip), ck.ptr(wv_ip),
              wo8.data_ptr(), so.data_ptr(), bo.data_ptr(), float(ip_scale), ck.ptr(bias), x8, sx, q, kv, attn,
              out.data_ptr(), b, s, c, heads, eps, float(c // heads) ** -0.5, plan.tk, plan.tk_ip,
              *plan.kv.launch_args, *plan.q.launch_args, *plan.out.launch_args)
    return out
