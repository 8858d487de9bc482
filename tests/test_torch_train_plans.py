"""PyTorch port: the launch plans and the tile walks of K7 and K9, the
training path's input-gradient kernels, checked on the CPU.

``k7_plan`` and ``k9_plan`` (``ops/fused_block.py``, ``ops/fused_ff.py``)
plan their GEMMs on the Hopper GEMM of ``csrc/hopper_gemm.cuh``: K7's QKV
GEMM, ``g·Wo`` and ``gxn = [dq‖dk‖dv]·[Wq; Wk; Wv]`` (the last two read
their weights [K, N] as they lie, MN-major, the last one across three
weights with K = 3C); K9's three products of a tile of gy1 and
``gxn = gy1·W1``. Here: the plans at the training shapes and at ragged S
(every k-block of every tile run once, every 8-column group stored once,
splits in powers of two up to 8), a torch emulation of the register-resident
attention backward's tile walk (``csrc/attn_bwd.cuh``) against autograd over
``ops/attention.py::sdpa``, and numpy emulations of the MN-major box walk
and of K9's three-accumulator tile, chained into K7 and K9 and held against
their plain versions in fp32. The kernels themselves are held against their
plain versions in ``test_torch_cuda.py`` (on the card only).
"""

import math

import numpy as np
import pytest
import torch

from ap_adapter_torch.ops.attention import sdpa
from ap_adapter_torch.ops.fused_block import fused_ln_self_attention_bwd_dx_plain, k7_plan
from ap_adapter_torch.ops.fused_ff import fused_ln_geglu_ff_bwd_dx_plain, k9_plan
from ap_adapter_torch.ops.hopper_gemm import BK, BM, gemm_blocks
from chip_smoke import HEADS, TRAIN_B, TRAIN_SHAPES
from tests.test_torch_kernel_plans import _assert_gemm_covers_fits_and_fills

# (B, S, C) of K7 and K9 calls: the three training levels, and ragged S (a
# part-filled last row tile, a sequence shorter than one tile)
TRAIN_BLOCK_SHAPES = [(TRAIN_B, s, c) for s, c in TRAIN_SHAPES] + [(2, 81, 256), (3, 145, 384), (1, 17, 640)]
LOG2E = 1.4426950408889634
T = 64                  # the attention backward's tiles: 64 query rows a dq CTA, 64 keys a dkv CTA


@pytest.mark.parametrize("b,s,c", TRAIN_BLOCK_SHAPES)
def test_k7_k9_gemm_plans_cover_fit_and_fill(b, s, c):
    """K7's three GEMMs and K9's two: each k-block of each output tile run by
    exactly one CTA and each 8-column group stored by exactly one, clusters
    of at most 8 CTAs in powers of two, shared memory within 227 KB, and at
    least 132 CTAs wherever the tiles reach that or the k-blocks are split
    (the checks of K1's and K3's GEMMs). K9's three-product GEMM takes 64-
    wide tiles: two A boxes and three W boxes a stage."""

    m, inner = b * s, 4 * c
    p7, p9 = k7_plan(b, s, c, HEADS), k9_plan(b, s, c, inner)
    gemms = [("qkv", p7.qkv, m, c, c, 3, False, False), ("gattn", p7.gattn, m, c, c, 1, False, False),
             ("gxn7", p7.gxn, m, c, 3 * c, 1, False, False), ("gy1", p9.gy1, m, inner, c, 1, False, True),
             ("gxn9", p9.gxn, m, c, 2 * inner, 1, False, False)]
    for name, plan, mm, n, k, sets, geglu, geglu_bwd in gemms:
        _assert_gemm_covers_fits_and_fills(name, plan, mm, n, k, sets, geglu, geglu_bwd=geglu_bwd)
        assert plan.ksplit & (plan.ksplit - 1) == 0, (name, plan)
    assert p9.gy1.bn == 64


def _round(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).float() if bf16 else x


def emulate_attn_bwd(q, k, v, do, bf16: bool):
    """dq, dk, dv of one head (q/do [S, d], k/v [n, d], fp32) by the walk of
    csrc/attn_bwd.cuh: padded to whole 64-row tiles with zeros as cp.async
    fills them; the dq kernel per query tile (sweep 1: the forward's online
    max and sum in the exp2 domain, P rounded before P V, then lse2 = m +
    log2(l) and D = rowsum(dO * O) / l; sweep 2: P = exp2(S scale log2e -
    lse2), masked past n, dS = P (dP - D), dq += dS K), then the dkv kernel
    per key tile looping over the query tiles (P^T from lse2, dV += P^T dO,
    dS^T = P^T (dP^T - D), dK += dS^T Q), rows past S carrying zeros. bf16:
    the kernels' bf16 roundings (P, dS, the stored dq/dk/dv)."""

    s_len, d = q.shape
    n = k.shape[0]
    sp, np_ = T * math.ceil(s_len / T), T * math.ceil(n / T)
    pad = lambda x, rows: torch.cat([x, x.new_zeros(rows - x.shape[0], d)])
    q, do, k, v = pad(q, sp), pad(do, sp), pad(k, np_), pad(v, np_)
    scale = d ** -0.5
    sl2 = scale * LOG2E
    key_ok = lambda k0: (torch.arange(k0, k0 + T) < n)[None, :]
    dq, lse2, dsum = torch.zeros(sp, d), torch.zeros(sp), torch.zeros(sp)
    for q0 in range(0, s_len, T):
        qt, dt = q[q0:q0 + T], do[q0:q0 + T]
        m, l, o = torch.full((T,), -math.inf), torch.zeros(T), torch.zeros(T, d)
        for k0 in range(0, n, T):                       # sweep 1
            st = torch.where(key_ok(k0), qt @ k[k0:k0 + T].T, -math.inf)
            mn = torch.maximum(m, st.max(1).values * sl2)
            c, p = torch.exp2(m - mn), torch.exp2(st * sl2 - mn[:, None])
            l, o, m = l * c + p.sum(1), o * c[:, None] + _round(p, bf16) @ v[k0:k0 + T], mn
        lse2[q0:q0 + T] = m + torch.log2(l)
        dsum[q0:q0 + T] = (dt * o).sum(1) / l
        acc = torch.zeros(T, d)
        for k0 in range(0, n, T):                       # sweep 2
            kt, vt = k[k0:k0 + T], v[k0:k0 + T]
            p = torch.where(key_ok(k0), _round(torch.exp2((qt @ kt.T) * sl2 - lse2[q0:q0 + T, None]), bf16), 0.0)
            acc += _round(p * (dt @ vt.T - dsum[q0:q0 + T, None]), bf16) @ kt
        dq[q0:q0 + T] = acc * scale
    lse2[s_len:], dsum[s_len:] = 0.0, 0.0                # the dkv kernel's zero-filled rows past S
    dk, dv = torch.zeros(np_, d), torch.zeros(np_, d)
    for k0 in range(0, n, T):
        kt, vt = k[k0:k0 + T], v[k0:k0 + T]
        for q0 in range(0, sp, T):
            qt, dt = q[q0:q0 + T], do[q0:q0 + T]
            pt = _round(torch.exp2((kt @ qt.T) * sl2 - lse2[None, q0:q0 + T]), bf16)
            dv[k0:k0 + T] += pt @ dt
            dk[k0:k0 + T] += _round(pt * (vt @ dt.T - dsum[None, q0:q0 + T]), bf16) @ qt
    dk *= scale
    return tuple(_round(t, bf16) for t in (dq[:s_len], dk[:n], dv[:n]))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("s", [64, 145])
@pytest.mark.parametrize("d", [32, 48, 80])
def test_attention_backward_walk_matches_autograd(d, s, bf16):
    """The attention backward's tile walk against autograd over ``sdpa`` in
    fp32, at K7's head dims and at S = 64 (one tile) and 2 x 64 + 17 (a
    part-filled last query and key tile): within 1e-5 of max|autograd| in
    fp32 (the identity D = rowsum(dO * O) = rowsum(P * dP), the lse2 of the
    online softmax, the masks and the padded rows adding nothing), within
    2e-2 with the kernels' bf16 roundings of P and dS."""

    rng = np.random.default_rng(d * 1000 + s)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((s, d)).astype(np.float32)) for _ in range(4))
    q, k, v, do = (_round(t, True) for t in (q, k, v, do))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = sdpa(*(t[None, :, None, :] for t in leaves))[0, :, 0, :]
    want = torch.autograd.grad(out, leaves, do)
    got = emulate_attn_bwd(q, k, v, do, bf16)
    tol = 2e-2 if bf16 else 1e-5
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        err = (a - w).abs().max().item()
        assert err <= tol * w.abs().max().item(), (name, err, w.abs().max().item())


def kn_gemm(a: np.ndarray, ws, plan) -> np.ndarray:
    """C = A @ [W_0; W_1; ...] (each W_i [kw, N] as it lies) by the MN-major
    GEMM's walk: each CTA of the plan (``gemm_blocks``) runs its k-blocks,
    the producer taking W map kc // kw at row kc % kw in boxes of 64 k-rows x
    64 columns (bn / 64 of them a stage), TMA's zero fill past row M of A;
    the split-K partials of a tile are summed in rank order by the rank that
    stores each 8-column group."""

    m, _ = a.shape
    kw, n = ws[0].shape
    ap = np.concatenate([a, np.zeros((-m % BM, a.shape[1]), a.dtype)])
    partials = {}
    for m0, n0, _, kb0, kb1, _ in gemm_blocks(plan):
        acc = np.zeros((BM, plan.bn), np.float32)
        for kb in range(kb0, kb1):
            kc = kb * BK
            wi = kc // kw
            box = np.concatenate([ws[wi][kc - wi * kw:kc - wi * kw + BK, n0 + 64 * j:n0 + 64 * j + 64]
                                  for j in range(plan.bn // 64)], axis=1)
            acc += ap[m0:m0 + BM, kc:kc + BK] @ box
        partials.setdefault((m0, n0), []).append(acc)
    out = np.full((ap.shape[0], n), np.nan, np.float32)
    for m0, n0, _, _, _, groups in gemm_blocks(plan):
        total = sum(partials[(m0, n0)][1:], partials[(m0, n0)][0].copy())
        for g in groups:
            out[m0:m0 + BM, n0 + 8 * g:n0 + 8 * g + 8] = total[:, 8 * g:8 * g + 8]
    return out[:m]


def geglu_bwd_gemm(xn, g, w1, b1, w2, plan) -> np.ndarray:
    """K9's three-product GEMM: for each 64 x 64 tile, a = xn . W1[n0:]^T
    and gate = xn . W1[inner + n0:]^T (K-major boxes), gh = g . W2[:, n0:]
    (MN-major boxes), each CTA over its k-blocks, the split-K partials of the
    three accumulators summed in rank order, then the epilogue
    gy1 = [gh gelu(gate + b1g) | gh (a + b1a) gelu'(gate + b1g)]."""

    m, _ = xn.shape
    inner = w2.shape[1]
    pad = lambda a: np.concatenate([a, np.zeros((-m % BM, a.shape[1]), a.dtype)])
    xp, gp = pad(xn), pad(g)
    partials = {}
    for m0, n0, _, kb0, kb1, _ in gemm_blocks(plan):
        acc = np.zeros((3, BM, 64), np.float32)
        for kb in range(kb0, kb1):
            kc = slice(kb * BK, kb * BK + BK)
            acc[0] += xp[m0:m0 + BM, kc] @ w1[n0:n0 + 64, kc].T
            acc[1] += xp[m0:m0 + BM, kc] @ w1[inner + n0:inner + n0 + 64, kc].T
            acc[2] += gp[m0:m0 + BM, kc] @ w2[kc, n0:n0 + 64]
        partials.setdefault((m0, n0), []).append(acc)
    erf = np.vectorize(math.erf, otypes=[np.float32])
    gy1 = np.full((xp.shape[0], 2 * inner), np.nan, np.float32)
    for (m0, n0), parts in partials.items():
        acc = sum(parts[1:], parts[0].copy())
        a, gate, gh = acc[0] + b1[n0:n0 + 64], acc[1] + b1[inner + n0:inner + n0 + 64], acc[2]
        cdf = 0.5 * (1.0 + erf(gate * np.float32(0.70710678118654752)))
        pdf = np.exp(-0.5 * gate * gate) * np.float32(0.3989422804014327)
        gy1[m0:m0 + BM, n0:n0 + 64] = gh * gate * cdf
        gy1[m0:m0 + BM, inner + n0:inner + n0 + 64] = gh * a * (cdf + gate * pdf)
    return gy1[:m]


def ln_rows(x, w, b, eps=1e-5):
    mean = x.mean(-1, keepdims=True)
    rstd = 1.0 / np.sqrt(((x - mean) ** 2).mean(-1, keepdims=True) + eps)
    return (x - mean) * rstd * w + b, (x - mean) * rstd, rstd


def ln_bwd(nhat, rstd, gxn, ln_w, g):
    gn = gxn * ln_w
    return rstd * (gn - gn.mean(-1, keepdims=True) - nhat * (gn * nhat).mean(-1, keepdims=True)) + g


def _operands(rng, b, s, c, *shapes):
    r = lambda *shape, scale=1.0: (rng.standard_normal(shape) * scale).astype(np.float32)
    return r(b * s, c), r(b * s, c), 1 + r(c, scale=0.1), r(c, scale=0.1), [r(*sh, scale=sh[-1] ** -0.5)
                                                                           for sh in shapes]


@pytest.mark.parametrize("b,s,c,heads", [(2, 81, 128, 4), (1, 70, 192, 4), (1, 64, 320, 4)])
def test_k7_walk_matches_plain(b, s, c, heads):
    """K7's chain as the kernels walk it, in fp32: the LayerNorm rows, q/k/v,
    gattn = g . Wo on the MN-major walk, the attention backward's tile walk
    per (batch, head) into the column blocks of one [M, 3C] buffer, gxn =
    [dq | dk | dv] . [Wq; Wk; Wv] on the MN-major walk with K = 3C across
    the three weights (the plan's split-K), the LayerNorm backward: within
    1e-4 of max|plain| of ``fused_ln_self_attention_bwd_dx_plain``."""

    rng = np.random.default_rng(7 + s)
    x, g, ln_w, ln_b, (wq, wk, wv, wo) = _operands(rng, b, s, c, *[(c, c)] * 4)
    plan, m, d = k7_plan(b, s, c, heads), b * s, c // heads
    xn, nhat, rstd = ln_rows(x, ln_w, ln_b)
    q, k, v = xn @ wq.T, xn @ wk.T, xn @ wv.T
    gattn = kn_gemm(g, [wo], plan.gattn)
    dqkv = np.zeros((m, 3 * c), np.float32)
    t = torch.from_numpy
    for bi in range(b):
        rows = slice(bi * s, bi * s + s)
        for h in range(heads):
            cols = slice(h * d, h * d + d)
            grads = emulate_attn_bwd(t(q[rows, cols]), t(k[rows, cols]), t(v[rows, cols]), t(gattn[rows, cols]),
                                     False)
            for i, gr in enumerate(grads):
                dqkv[rows, i * c + h * d:i * c + h * d + d] = gr.numpy()
    gxn = kn_gemm(dqkv, [wq, wk, wv], plan.gxn)
    got = ln_bwd(nhat, rstd, gxn, ln_w, g)
    want = fused_ln_self_attention_bwd_dx_plain(*(t(a) for a in (x.reshape(b, s, c), g.reshape(b, s, c), ln_w, ln_b,
                                                                 wq, wk, wv, wo)), heads).reshape(m, c).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("b,s,c", [(2, 81, 128), (1, 70, 192)])
def test_k9_walk_matches_plain(b, s, c):
    """K9's chain as the kernels walk it, in fp32: the LayerNorm rows, the
    three-product tile (value and gate accumulators from W1's K-major rows,
    gh from W2's MN-major columns) with the GEGLU backward epilogue, gxn =
    gy1 . W1 on the MN-major walk (K = 8C, the plan's split-K), the
    LayerNorm backward: within 1e-4 of max|plain| of
    ``fused_ln_geglu_ff_bwd_dx_plain``."""

    rng = np.random.default_rng(9 + s)
    inner = 4 * c
    x, g, ln_w, ln_b, (w1, w2) = _operands(rng, b, s, c, (2 * inner, c), (c, inner))
    b1 = (rng.standard_normal(2 * inner) * 0.1).astype(np.float32)
    plan = k9_plan(b, s, c, inner)
    xn, nhat, rstd = ln_rows(x, ln_w, ln_b)
    gy1 = geglu_bwd_gemm(xn, g, w1, b1, w2, plan.gy1)
    gxn = kn_gemm(gy1, [w1], plan.gxn)
    got = ln_bwd(nhat, rstd, gxn, ln_w, g)
    t = torch.from_numpy
    want = fused_ln_geglu_ff_bwd_dx_plain(*(t(a) for a in (x.reshape(b, s, c), g.reshape(b, s, c), ln_w, ln_b, w1,
                                                           b1, w2))).reshape(b * s, c).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
