"""K10: the bare decoupled dual-KV attention,
``softmax(q·K_tᵀ·d^-½)·V_t + s·softmax(q·K_aᵀ·d^-½)·V_a``.

Replaces ``ap_adapter_tpu/ops/pallas_attention.py::fused_dual_kv_attention``
(``_kernel``): both branches of the adapter in one pass over a query tile,
with q, K and V already projected (no LayerNorm, no projections, no
residual). The JAX package reaches it only on the unfused cross-attention
route under ``UNetConfig.use_pallas_attention``; the port routes every
adapter site there under that switch (``models/unet_blocks.py``).

Semantics of the Pallas body (:31-54), kept by ``_plain``: each branch in
fp32 with a max-subtracted softmax and no mask, the text branch plus
``ip_scale`` times the audio branch in fp32, and one cast to q's dtype at
the end. That is not ``ops/attention.py::dual_kv_attention``, which rounds
each branch to q's dtype before the sum (the XLA route's counterpart).

Kernel (``csrc/fused_hopper.cu``, ``apk_dual_kv_attention``): one launch
of the register-resident two-key-set attention that K2 runs (64 queries
and one head a CTA, one warp 16 query rows, ``mma.sync`` with logits,
probabilities and output in registers): the text tiles, then the audio
tiles, through one double buffer, each set with its own online softmax and
normalised in fp32, combined before one bf16 store. Each set's key tile
(16, 32 or 64 keys) follows its count (``fused_cross.key_tile``). The TPU
wrapper pads D to 128 lanes and the key sets to 128 rows; the Hopper kernel
takes any D % 16 == 0 up to 128 and masks the last key tile of each set
itself, so nothing is padded. At the UNet's shapes (S = 1000/252/64
queries, d = 32/48/80, 8 text and 32-512 audio keys) it is bound by bytes,
q and out dominating, and runs at its launch's latency and its
exponentials; at S = 64 its grid is only 16 CTAs on 132 SMs. The JAX package
has no backward for K10, so there is no autograd Function: the wrapper
refuses operands that require grad under grad mode.
"""

from __future__ import annotations

from typing import Optional

import torch

from ap_adapter_torch.ops import cuda_kernels as ck
from ap_adapter_torch.ops.fused_cross import key_tile

MAX_HEAD_DIM = 128


def _plain(q: torch.Tensor, k_text: torch.Tensor, v_text: torch.Tensor, k_ip: torch.Tensor,
           v_ip: torch.Tensor, ip_scale: float) -> torch.Tensor:
    """Plain PyTorch version: both branches in fp32, summed in fp32, one cast
    to q's dtype."""

    qf = q.float()
    sm_scale = q.shape[-1] ** -0.5

    def branch(k, v):
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, k.float()) * sm_scale
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v.float())

    return (branch(k_text, v_text) + float(ip_scale) * branch(k_ip, v_ip)).to(q.dtype)


def fused_dual_kv_attention(q: torch.Tensor, k_text: torch.Tensor, v_text: torch.Tensor, k_ip: torch.Tensor,
                            v_ip: torch.Tensor, ip_scale: float, *,
                            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K10 on CUDA tensors (bf16, contiguous, D % 16 == 0, D <= 128), the
    plain version on CPU tensors. q [B, Sq, H, D]; k_text/v_text
    [B, St, H, D]; k_ip/v_ip [B, Si, H, D]; ``ip_scale`` a host float (read
    once: a 0-d CUDA tensor would synchronise here on every call).

    Raises where K10 is undefined: an empty key set, a text mask or bias
    (the Pallas kernel has no mask input and would drop one), a strided
    operand, and, on the card, a non-bf16 operand or an unsupported head
    dim; under grad mode, an operand that requires grad (K10 has no
    backward)."""

    op = "dual_kv_attention"
    if bias is not None:
        raise ValueError(f"{op}: K10 is unmasked; a text mask or bias needs the K2/K4 route")
    if q.ndim != 4:
        raise ValueError(f"{op}: q must be [B, Sq, H, D], got {tuple(q.shape)}")
    b, sq, h, d = q.shape
    st, si = k_text.shape[1], k_ip.shape[1]
    for name, t, s in (("k_text", k_text, st), ("v_text", v_text, st), ("k_ip", k_ip, si), ("v_ip", v_ip, si)):
        if t.shape != (b, s, h, d):
            raise ValueError(f"{op}: {name} must be [{b}, S, {h}, {d}], got {tuple(t.shape)}")
    if v_text.shape != k_text.shape or v_ip.shape != k_ip.shape:
        raise ValueError(f"{op}: each V must have its K's shape")
    if st == 0 or si == 0:
        raise ValueError(f"{op}: empty key set (St={st}, Si={si}); K10 needs both")
    operands = dict(q=q, k_text=k_text, v_text=v_text, k_ip=k_ip, v_ip=v_ip)
    ck.check_contiguous(op, **operands)
    ck.check_no_grad(op, **operands)
    if q.device.type == "cpu":
        return _plain(q, k_text, v_text, k_ip, v_ip, ip_scale)
    if d % 16 or d > MAX_HEAD_DIM:
        raise ValueError(f"{op}: kernel needs head dim % 16 == 0 and <= {MAX_HEAD_DIM} (D={d})")
    ck.check_operands(op, q, **operands)
    out = torch.empty_like(q)
    ck.launch(op, q.data_ptr(), k_text.data_ptr(), v_text.data_ptr(), st, k_ip.data_ptr(), v_ip.data_ptr(), si,
              float(ip_scale), out.data_ptr(), b, sq, h, d, key_tile(st), key_tile(si))
    return out
