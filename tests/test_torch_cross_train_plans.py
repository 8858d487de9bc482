"""PyTorch port: the launch plans and the tile walk of K4 and K8, the
training path's context-projecting cross-attention and its backward,
checked on the CPU.

``k4_plan`` and ``k8_plan`` (``ops/fused_cross.py``) plan their GEMMs on the
Hopper GEMM of ``csrc/hopper_gemm.cuh``: the context K/V GEMM (2 or 4 weight
sets over ``b x ctx_tiles`` row tiles, the rows read in place through 3-D
tensor maps), K2's Q and out GEMMs, and K8's ``g·Wo`` and ``gxn = dq·Wq``
(both reading their weight [K, N] as it lies, MN-major). Here: the plans at
the training shapes and at ragged sizes (every k-block of every tile run
once, every 8-column group and every context row stored once, the scratch
laid out without overlaps), and a torch emulation of K8's two-set attention
backward (``csrc/attn_bwd.cuh``, ``reg_attn_bwd_dq_kernel<D, true>`` and
the dkv kernel over the adapter keys), chained with the MN-major GEMM walks
into K8 and held against autograd over
``fused_ln_cross_attention_kv_plain``. The kernels themselves are held
against their plain versions in ``test_torch_cuda.py`` (on the card only).
"""

import math

import numpy as np
import pytest
import torch

from ap_adapter_torch.ops.fused_cross import fused_ln_cross_attention_kv_plain, k2_plan, k4_plan, k8_plan, key_tile
from ap_adapter_torch.ops.hopper_gemm import BM, ctx_boxes, ctx_tiles
from chip_smoke import HEADS, SHAPES, TRAIN_B, TRAIN_SHAPES
from tests.test_torch_kernel_plans import _assert_gemm_covers_fits_and_fills
from tests.test_torch_train_plans import LOG2E, T, _round, kn_gemm, ln_bwd, ln_rows

# (B, S, C) of K4 and K8 calls: the three training levels, the three edit levels (K4 in the ControlNet-branch
# request), and ragged S
CROSS_SHAPES = ([(TRAIN_B, s, c) for s, c in TRAIN_SHAPES] + [(2, s, c) for s, c in SHAPES]
                + [(2, 81, 256), (3, 145, 384), (1, 17, 640)])
# (text keys, adapter keys, context width): GPT-2 + AudioMAE at pool 1, T5 with no adapter set, ragged adapter
# sets, and GPT-2's 8 text keys alone (the ControlNet branch strips the AudioMAE tokens)
CROSS_KEYS = [(8, 512, 768), (64, 0, 1024), (8, 20, 768), (8, 128, 768), (70, 0, 1024), (8, 0, 768)]


@pytest.mark.parametrize("keys", CROSS_KEYS)
@pytest.mark.parametrize("b,s,c", CROSS_SHAPES)
def test_k4_k8_plans_cover_fit_and_fill(b, s, c, keys):
    """K4's and K8's GEMMs: each k-block of each output tile run by exactly
    one CTA and each 8-column group stored by exactly one, clusters of at
    most 8 in powers of two, shared memory within 227 KB, at least 132 CTAs
    wherever the tiles reach that or the k-blocks are split (the checks of
    K1's and K3's GEMMs); the context K/V GEMM stores each row of each key
    set once (``ctx_boxes``); K4's Q and out GEMMs and key tiles are K2's;
    the scratch buffers lie 256-byte aligned, in order, without overlap."""

    sk, sk_ip, dc = keys
    m, p4, p8 = b * s, k4_plan(b, s, c, HEADS, sk, sk_ip, dc), k8_plan(b, s, c, HEADS, sk, sk_ip, dc)
    sets = 4 if sk_ip else 2
    assert p4.kv == p8.kv
    _assert_gemm_covers_fits_and_fills("kv", p4.kv, b * ctx_tiles(sk, sk_ip) * BM, c, dc, sets, False)
    for name, plan in (("q", p4.q), ("out", p4.out), ("gattn", p8.gattn), ("gxn", p8.gxn)):
        _assert_gemm_covers_fits_and_fills(name, plan, m, c, c, 1, False)
        assert plan.ksplit & (plan.ksplit - 1) == 0, (name, plan)
    assert (p4.q, p4.out) == tuple(k2_plan(b, s, c, HEADS)) and p8.q == p4.q
    assert (p4.tk, p4.tk_ip) == (key_tile(sk), key_tile(sk_ip))
    stored = {pair: np.zeros(b * n, int) for pair, n in enumerate((sk, sk_ip))}
    for pair, _, _, rows, row0 in ctx_boxes(b, sk, sk_ip):
        stored[pair][row0:row0 + rows] += 1
    assert all((n == 1).all() for n in stored.values())
    kv_bytes = 2 * 2 * b * (sk + sk_ip) * c
    for plan, sizes in ((p4, (kv_bytes, 3 * 2 * m * c)),
                        (p8, (kv_bytes, 5 * 2 * m * c, 4 * (2 * 2 * b * HEADS * s + m * c)))):
        ends = [o + n for o, n in zip(plan.offsets, sizes)]
        assert len(plan.offsets) == len(sizes) and plan.offsets[0] == 0
        assert all(o % 256 == 0 for o in plan.offsets) and ends[-1] <= plan.nbytes
        assert all(e <= o for e, o in zip(ends, plan.offsets[1:]))


def _pad(x: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.cat([x, x.new_zeros(rows - x.shape[0], *x.shape[1:])])


def emulate_cross_attn_bwd(q, do, k, v, bias, ki, vi, ip_scale: float, bf16: bool):
    """dq, dk_ip, dv_ip of one head of ``softmax(q kᵀ s + bias) v + ip_scale ·
    softmax(q kiᵀ s) vi`` (q/do [S, d]; k/v [n, d], bias [n] or None; ki/vi
    [n_ip, d] or None; fp32) by the walk of csrc/attn_bwd.cuh's two-set dq
    kernel and its dkv kernel: everything padded to whole 64-row tiles with
    zeros as cp.async fills them; per query tile, sweep 1 over the text
    keys and then over the adapter keys (each the forward's online max and
    sum in the exp2 domain, the bias times log2(e) added before the
    maximum, keys past a set at -inf, P rounded before P V, then the set's
    lse2 = m + log2(l) and D = rowsum(dO_set O_set) / l), then sweep 2 over
    both sets into one dq (P = exp2(S s log2e + bias log2e - lse2), dS =
    P (dP - D), dq += dS K); the adapter set's dO is bf16(ip_scale dO).
    Then the dkv kernel over the adapter keys alone, looping over the query
    tiles (rows past S carrying zeros), dk/dv kept in fp32. bf16: the
    kernels' roundings (P, dS, the adapter's dO, the stored dq)."""

    s_len, d = q.shape
    sp = T * math.ceil(s_len / T)
    q, do = _pad(q, sp), _pad(do, sp)
    sl2, scale = d ** -0.5 * LOG2E, d ** -0.5
    sets = []
    for kk, vv, bb, dos in ((k, v, bias, do), (ki, vi, None, _round(do * ip_scale, bf16))):
        if kk is None:
            continue
        n = kk.shape[0]
        np_ = T * math.ceil(n / T)
        bl = torch.full((np_,), -math.inf)
        bl[:n] = 0.0 if bb is None else bb * LOG2E
        sets.append((_pad(kk, np_), _pad(vv, np_), n, bl, dos))
    dq = torch.zeros(sp, d)
    lse2, dsum = torch.zeros(len(sets), sp), torch.zeros(len(sets), sp)
    for q0 in range(0, s_len, T):
        qt, rows = q[q0:q0 + T], slice(q0, q0 + T)
        for i, (kk, vv, n, bl, dos) in enumerate(sets):             # sweep 1, a set at a time
            m, l, o = torch.full((T,), -math.inf), torch.zeros(T), torch.zeros(T, d)
            for k0 in range(0, n, T):
                x = (qt @ kk[k0:k0 + T].T) * sl2 + bl[None, k0:k0 + T]
                mn = torch.maximum(m, x.max(1).values)
                c, p = torch.exp2(m - mn), torch.exp2(x - mn[:, None])
                l, o, m = l * c + p.sum(1), o * c[:, None] + _round(p, bf16) @ vv[k0:k0 + T], mn
            lse2[i, rows] = m + torch.log2(l)
            dsum[i, rows] = (dos[rows] * o).sum(1) / l
        acc = torch.zeros(T, d)
        for i, (kk, vv, n, bl, dos) in enumerate(sets):             # sweep 2, a set at a time
            for k0 in range(0, n, T):
                kt, vt = kk[k0:k0 + T], vv[k0:k0 + T]
                p = _round(torch.exp2((qt @ kt.T) * sl2 + bl[None, k0:k0 + T] - lse2[i, rows, None]), bf16)
                acc += _round(p * (dos[rows] @ vt.T - dsum[i, rows, None]), bf16) @ kt
        dq[rows] = acc * scale
    if ki is None:
        return _round(dq[:s_len], bf16), None, None
    kk, vv, n, _, dos = sets[1]
    lse2[1, s_len:], dsum[1, s_len:] = 0.0, 0.0                       # the dkv kernel's zero-filled rows past S
    dk, dv = torch.zeros(kk.shape[0], d), torch.zeros(kk.shape[0], d)
    for k0 in range(0, n, T):
        kt, vt = kk[k0:k0 + T], vv[k0:k0 + T]
        for q0 in range(0, sp, T):
            qt, dt, rows = q[q0:q0 + T], dos[q0:q0 + T], slice(q0, q0 + T)
            pt = _round(torch.exp2((kt @ qt.T) * sl2 - lse2[1, None, rows]), bf16)
            dv[k0:k0 + T] += pt @ dt
            dk[k0:k0 + T] += _round(pt * (vt @ dt.T - dsum[1, None, rows]), bf16) @ qt
    return _round(dq[:s_len], bf16), dk[:n] * scale, dv[:n]


# (b, s, c, heads, text keys, adapter keys, context width, T5 bias): the GPT-2 + adapter site with a ragged
# two-tile adapter set; a T5 site (two ragged key tiles, a padding bias, no adapter); both sets with a bias at d = 16
WALK_CASES = [(2, 81, 128, 4, 8, 80, 128, False), (2, 145, 192, 4, 70, 0, 64, True),
              (1, 64, 128, 8, 20, 20, 64, True)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", WALK_CASES)
def test_k8_walk_matches_autograd(case, bf16):
    """K8's chain as the kernels walk it: the LayerNorm rows, q, gattn = g ·
    Wo on the MN-major walk, the two-set attention backward per (batch,
    head) (``emulate_cross_attn_bwd``), gxn = dq · Wq on the MN-major walk,
    the LayerNorm backward; against autograd over
    ``fused_ln_cross_attention_kv_plain`` in fp32 for (x, k_ip, v_ip) on the
    same bf16-valued inputs: dx, dk_ip and dv_ip within 1e-5 of max|autograd|
    in fp32, within 2e-2 with the kernels' bf16 roundings (LN(x), q, the
    projected K/V, gattn, P, dS, the adapter's dO, dq)."""

    b, s, c, heads, sk, sk_ip, dc, has_bias = case
    rng = np.random.default_rng(s + sk_ip)
    r = lambda *shape, scale=1.0: _round(torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)),
                                         True)
    x, g = r(b, s, c), r(b, s, c)
    ln_w, ln_b = 1 + r(c, scale=0.1), r(c, scale=0.1)
    wq, wo = r(c, c, scale=c ** -0.5), r(c, c, scale=c ** -0.5)
    ctx = r(b, sk + sk_ip, dc)
    wk, wv, wki, wvi = (r(c, dc, scale=dc ** -0.5) for _ in range(4))
    bias = None
    if has_bias:
        bias = torch.zeros(b, sk)
        bias[0, sk // 3:] = -10000.0
    ip_scale = 0.7
    k, v = ctx[:, :sk] @ wk.T, ctx[:, :sk] @ wv.T
    ki = vi = None
    if sk_ip:
        ki, vi = ctx[:, sk:] @ wki.T, ctx[:, sk:] @ wvi.T

    leaves = [t.clone().requires_grad_() for t in (x, ki, vi) if t is not None]
    out = fused_ln_cross_attention_kv_plain(leaves[0], k, v, ln_w, ln_b, wq, wo, torch.zeros(c), heads,
                                            ki=leaves[1] if sk_ip else None, vi=leaves[2] if sk_ip else None,
                                            ip_scale=ip_scale, bias=bias)
    want = torch.autograd.grad(out, leaves, g)

    plan, m, d = k8_plan(b, s, c, heads, sk, sk_ip, dc), b * s, c // heads
    rb = lambda t: _round(t, bf16)
    k, v = rb(k), rb(v)
    if sk_ip:
        ki, vi = rb(ki), rb(vi)
    xn, nhat, rstd = ln_rows(x.reshape(m, c).numpy(), ln_w.numpy(), ln_b.numpy())
    q = rb(rb(torch.from_numpy(xn)) @ wq.T).reshape(b, s, c)
    gattn = rb(torch.from_numpy(kn_gemm(g.reshape(m, c).numpy(), [wo.numpy()], plan.gattn))).reshape(b, s, c)
    dq = torch.zeros(b, s, c)
    dki, dvi = torch.zeros(b, sk_ip, c), torch.zeros(b, sk_ip, c)
    for bi in range(b):
        for h in range(heads):
            cols = slice(h * d, h * d + d)
            got = emulate_cross_attn_bwd(q[bi, :, cols], gattn[bi, :, cols], k[bi, :, cols], v[bi, :, cols],
                                         None if bias is None else bias[bi], None if ki is None else ki[bi, :, cols],
                                         None if vi is None else vi[bi, :, cols], ip_scale, bf16)
            dq[bi, :, cols] = got[0]
            if sk_ip:
                dki[bi, :, cols], dvi[bi, :, cols] = got[1], got[2]
    gxn = kn_gemm(dq.reshape(m, c).numpy(), [wq.numpy()], plan.gxn)
    dx = torch.from_numpy(ln_bwd(nhat, rstd, gxn, ln_w.numpy(), g.reshape(m, c).numpy())).reshape(b, s, c)

    tol = 2e-2 if bf16 else 1e-5
    for name, a, w in zip(("dx", "dk_ip", "dv_ip"), (dx, dki, dvi), want):
        err = (a - w).abs().max().item()
        assert err <= tol * w.abs().max().item(), (name, err, w.abs().max().item())
