#!/usr/bin/env python3
"""Device time of K1's, K2's, K3's, K10's, K11a's, K11b's, K11c's and K13's
kernels under other launch plans than the wrappers' own, at the edit path's
shapes, and of K4's, K7's, K8's and K9's at the training shapes, on one
NVIDIA GPU.

    python3 scripts/sweep_block_plans.py [--kernels K1,K2,K3,K10,K11a,K11b,K11c,K13,K4,K7,K8,K9]

For K1 (``fused_ln_self_attention``), K2 (``fused_ln_cross_attention_kv``,
8 text + 128 adapter keys and 64 T5 keys with their bias) and K3
(``fused_ln_geglu_ff``) at B=2 and each (S, C) of ``chip_smoke.SHAPES``, and
for K10 (``fused_dual_kv_attention``) at B=2 and each (S, d) of
``chip_smoke.DUAL_KV_LEVELS`` with 8 text keys and each audio key count,
for K11a, K11b and K11c (``fused_ln_geglu_ff_int8``,
``fused_ln_self_attention_int8``, ``fused_ln_cross_attention_int8`` with
K2's two context cases, int8 weights from ``quantize_weight``) at each
(S, C), and for K13 (``fused_resnet_block``, with a per-sample temb) at
every distinct resnet shape of the edit, and for K4
(``fused_ln_cross_attention``) and K8 (``fused_ln_cross_attention_bwd``,
both with 8 text + 512 adapter context rows of 768 and 64 T5 rows of 1024
with their bias), K7 (``fused_ln_self_attention_bwd_dx``) and K9
(``fused_ln_geglu_ff_bwd_dx``) at B=8 and each (S, C) of
``chip_smoke.TRAIN_SHAPES``, bf16 inputs: the C entry point is called with
the wrapper's plan (``k1_plan``, ``k2_plan``, ``k3_plan``, ``key_tile``,
``k11a_plan``, ``k11b_plan``, ``k11c_plan``, ``conv_plan``, ``k4_plan``,
``k7_plan``, ``k8_plan``, ``k9_plan``), then with one choice
changed at a time (each GEMM's tile width and split-K, then its ring's
stage count; each key set's tile width), and ``chip_smoke.device_split``
gives each device kernel's device ms a call (torch.profiler, 10 calls after
3 warm-up). Every variant is checked against the plain version
(``chip_smoke.TOL`` of max|plain|; K7, K8 (dx) and K9 against autograd over
theirs, ``chip_smoke.GRAD_TOL``). Prints one line per variant, the
wrapper's plan marked, then the card's ``nvidia-smi`` line. Fails without a
CUDA device.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", default="K1,K2,K3,K10,K11a,K11b,K11c,K13,K4,K7,K8,K9")
    which = set(parser.parse_args(argv).kernels.split(","))

    import torch

    if not torch.cuda.is_available():
        print("sweep_block_plans: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from ap_adapter_torch.ops import cuda_kernels as ck
    from ap_adapter_torch.ops.dual_kv_attention import _plain as dual_kv_plain
    from ap_adapter_torch.ops.fused_block import fused_ln_self_attention_plain, k1_plan
    from ap_adapter_torch.ops.fused_cross import KEY_TILES, fused_ln_cross_attention_kv_plain, k2_plan, key_tile
    from ap_adapter_torch.ops.fused_ff import fused_ln_geglu_ff_plain, k3_plan
    from ap_adapter_torch.ops.int8 import (
        fused_ln_cross_attention_int8_plain, fused_ln_geglu_ff_int8_plain, fused_ln_self_attention_int8_plain,
        k11a_plan, k11b_plan, k11c_plan, quantize_weight)

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(0)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    ck.library()
    heads, eps = chip_smoke.HEADS, 1e-5
    for s, c in chip_smoke.SHAPES:
        b, m = 2, 2 * s
        x, ln_w, ln_b = r(b, s, c), 1 + r(c, scale=0.1), r(c, scale=0.1)
        wq, wk, wv, wo = (r(c, c, scale=c ** -0.5) for _ in range(4))
        bo = r(c, scale=0.1)
        w1, b1 = r(8 * c, c, scale=c ** -0.5), r(8 * c, scale=0.1)
        w2, b2 = r(c, 4 * c, scale=(4 * c) ** -0.5), r(c, scale=0.1)
        scratch = x.new_empty(5 * m * c)
        out = torch.empty_like(x)

        def k1(qkv, o):
            ck.launch("fused_ln_self_attention", x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), wq.data_ptr(),
                      wk.data_ptr(), wv.data_ptr(), wo.data_ptr(), bo.data_ptr(), scratch.data_ptr(),
                      out.data_ptr(), b, s, c, heads, eps, *qkv, *o)
            return out

        def k3(w1p, w2p):
            ck.launch("fused_ln_geglu_ff", x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(),
                      b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), scratch.data_ptr(), out.data_ptr(), b, s, c,
                      4 * c, eps, *w1p[1:], *w2p)
            return out

        def k2(keys, tiles, qp, op):
            k, v, ki, vi, bias = keys
            ck.launch("fused_ln_cross_attention_kv", x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), wq.data_ptr(),
                      wo.data_ptr(), bo.data_ptr(), k.data_ptr(), v.data_ptr(), k.shape[1], ck.ptr(bias),
                      ck.ptr(ki), ck.ptr(vi), 0 if ki is None else ki.shape[1], 0.5, scratch.data_ptr(),
                      out.data_ptr(), b, s, c, heads, eps, *tiles, *qp, *op)
            return out

        p1, p2, p3 = k1_plan(b, s, c, heads), k2_plan(b, s, c, heads), k3_plan(b, s, c, 4 * c)
        if "K1" in which:
            base1 = (p1.qkv.launch_args, p1.out.launch_args)
            variants = [base1] + [(v, base1[1]) for v in gemm_variants(p1.qkv, False)]
            variants += [(base1[0], v) for v in gemm_variants(p1.out, False)]
            want = fused_ln_self_attention_plain(x, ln_w, ln_b, wq, wk, wv, wo, bo, heads).float()
            for v in dict.fromkeys(variants):
                run(chip_smoke, "K1", (s, c), v, v == base1, lambda: k1(*v), want)
        if "K2" in which:
            t5_bias = torch.zeros(b, 64, device=device)
            t5_bias[0, 12:] = -10000.0
            t5_bias[1, 30:] = -10000.0
            for label, keys in (("adapter", (r(b, 8, c), r(b, 8, c), r(b, 128, c), r(b, 128, c), None)),
                                ("t5+bias", (r(b, 64, c), r(b, 64, c), None, None, t5_bias))):
                k, v, ki, vi, bias = keys
                counts = (k.shape[1], 0 if ki is None else ki.shape[1])
                base2 = (tuple(key_tile(n) for n in counts), p2.q.launch_args, p2.out.launch_args)
                variants = [base2] + [(t, *base2[1:]) for t in tile_variants(base2[0], counts, KEY_TILES)]
                variants += [(base2[0], v, base2[2]) for v in gemm_variants(p2.q, False)]
                variants += [(*base2[:2], v) for v in gemm_variants(p2.out, False)]
                ad = {} if ki is None else dict(ki=ki, vi=vi, ip_scale=0.5)
                want = fused_ln_cross_attention_kv_plain(x, k, v, ln_w, ln_b, wq, wo, bo, heads, bias=bias,
                                                         **ad).float()
                for var in dict.fromkeys(variants):
                    run(chip_smoke, f"K2 {label}", (s, c), var, var == base2, lambda: k2(keys, *var), want)
        if "K3" in which:
            base3 = (p3.w1.launch_args, p3.w2.launch_args)
            variants = [base3] + [(v, base3[1]) for v in gemm_variants(p3.w1, True)]
            variants += [(base3[0], v) for v in gemm_variants(p3.w2, False)]
            want = fused_ln_geglu_ff_plain(x, ln_w, ln_b, w1, b1, w2, b2).float()
            for v in dict.fromkeys(variants):
                run(chip_smoke, "K3", (s, c), v, v == base3, lambda: k3(*v), want)
        if "K11b" in which:
            wq8, sq = quantize_weight(wq)
            wo8, so = quantize_weight(wo)
            x8, sx = x.new_empty(m, c, dtype=torch.int8), x.new_empty(m, dtype=torch.float32)
            attn = x.new_empty(m, c, dtype=torch.float32)

            def k11b(qp, kvp, op):
                ck.launch("fused_ln_self_attention_int8", x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
                          wq8.data_ptr(), sq.data_ptr(), wk.data_ptr(), wv.data_ptr(), wo8.data_ptr(),
                          so.data_ptr(), bo.data_ptr(), x8.data_ptr(), sx.data_ptr(), scratch.data_ptr(),
                          attn.data_ptr(), out.data_ptr(), b, s, c, heads, eps, float(c // heads) ** -0.5, *qp,
                          *kvp, *op)
                return out

            p11 = k11b_plan(b, s, c, heads)
            base = (p11.q.launch_args, p11.kv.launch_args, p11.out.launch_args)
            variants = [base] + [(v, *base[1:]) for v in gemm_variants(p11.q, False)]
            variants += [(base[0], v, base[2]) for v in gemm_variants(p11.kv, False)]
            variants += [(*base[:2], v) for v in gemm_variants(p11.out, False)]
            want = fused_ln_self_attention_int8_plain(x, ln_w, ln_b, wq8, sq, wk, wv, wo8, so, bo, heads).float()
            for v in dict.fromkeys(variants):
                run(chip_smoke, "K11b", (s, c), v, v == base, lambda: k11b(*v), want)
        if "K11a" in which:
            w1q, s1 = quantize_weight(w1)
            w2q, s2 = quantize_weight(w2)
            pa = k11a_plan(b, s, c, 4 * c)
            scr = torch.empty(pa.nbytes, dtype=torch.uint8, device=device)

            def k11a(w1p, w2p):
                ck.launch("fused_ln_geglu_ff_int8", x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1q.data_ptr(),
                          s1.data_ptr(), b1.data_ptr(), w2q.data_ptr(), s2.data_ptr(), b2.data_ptr(),
                          *(scr.data_ptr() + o for o in pa.offsets), out.data_ptr(), b, s, c, 4 * c, eps, *w1p[1:],
                          *w2p)
                return out

            base = (pa.w1.launch_args, pa.w2.launch_args)
            variants = [base] + [(v, base[1]) for v in gemm_variants(pa.w1, True)]
            variants += [(base[0], v) for v in gemm_variants(pa.w2, False)]
            want = fused_ln_geglu_ff_int8_plain(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2).float()
            for v in dict.fromkeys(variants):
                run(chip_smoke, "K11a", (s, c), v, v == base, lambda: k11a(*v), want)
        if "K11c" in which:
            sweep_k11c(chip_smoke, ck, r, device, x, ln_w, ln_b, wq, wo, bo, s, c, heads, eps, k11c_plan,
                       quantize_weight, fused_ln_cross_attention_int8_plain, KEY_TILES)
    if "K13" in which:
        sweep_resnet(chip_smoke, ck, r, device)
    if which & {"K7", "K9"}:
        sweep_backward(chip_smoke, ck, r, which)
    if which & {"K4", "K8"}:
        sweep_cross(chip_smoke, ck, r, device, which)
    if "K10" in which:
        for s, d in chip_smoke.DUAL_KV_LEVELS:
            for si in chip_smoke.DUAL_KV_AUDIO_KEYS:
                q, kt, vt, ki, vi = (r(2, n, heads, d) for n in (s, 8, 8, si, si))
                out = torch.empty_like(q)

                def k10(tiles):
                    ck.launch("dual_kv_attention", q.data_ptr(), kt.data_ptr(), vt.data_ptr(), 8, ki.data_ptr(),
                              vi.data_ptr(), si, 0.55, out.data_ptr(), 2, s, heads, d, *tiles)
                    return out

                base = (key_tile(8), key_tile(si))
                want = dual_kv_plain(q, kt, vt, ki, vi, 0.55).float()
                for t in dict.fromkeys([base] + tile_variants(base, (8, si), KEY_TILES)):
                    run(chip_smoke, f"K10 Si={si}", (s, heads * d), t, t == base, lambda: k10(t), want)
    print(card, flush=True)
    return 0


def sweep_k11c(chip_smoke, ck, r, device, x, ln_w, ln_b, wq, wo, bo, s, c, heads, eps, k11c_plan, quantize_weight,
               plain, key_tiles) -> None:
    """K11c at one (S, C) with K2's two context cases (8 text + 128 adapter
    rows of 768; 64 T5 rows of 1024 with their bias): the plan, then each
    key set's tile width, the context K/V GEMM's, the q GEMM's and the out
    GEMM's plan changed one at a time."""

    import torch

    b = x.shape[0]
    wq8, sq = quantize_weight(wq)
    wo8, so = quantize_weight(wo)
    t5_bias = torch.zeros(b, 64, device=device)
    t5_bias[0, 12:] = -10000.0
    t5_bias[1, 30:] = -10000.0
    out = torch.empty_like(x)
    for label, sk, sk_ip, dc, bias in (("adapter", 8, 128, 768, None), ("t5+bias", 64, 0, 1024, t5_bias)):
        ctx = r(b, sk + sk_ip, dc)
        wk, wv, wki, wvi = (r(c, dc, scale=dc ** -0.5) if i < 2 or sk_ip else None for i in range(4))
        p = k11c_plan(b, s, c, heads, sk, sk_ip, dc)
        scr = torch.empty(p.nbytes, dtype=torch.uint8, device=device)

        def k11c(tiles, kvp, qp, op):
            ck.launch("fused_ln_cross_attention_int8", x.data_ptr(), ctx.data_ptr(), sk + sk_ip, dc, sk,
                      ln_w.data_ptr(), ln_b.data_ptr(), wq8.data_ptr(), sq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
                      ck.ptr(wki), ck.ptr(wvi), wo8.data_ptr(), so.data_ptr(), bo.data_ptr(), 0.5, ck.ptr(bias),
                      *(scr.data_ptr() + o for o in p.offsets), out.data_ptr(), b, s, c, heads, eps,
                      float(c // heads) ** -0.5, *tiles, *kvp, *qp, *op)
            return out

        base = ((p.tk, p.tk_ip), p.kv.launch_args, p.q.launch_args, p.out.launch_args)
        variants = [base] + [(t, *base[1:]) for t in tile_variants(base[0], (sk, sk_ip), key_tiles)]
        variants += [(base[0], v, *base[2:]) for v in gemm_variants(p.kv, False)]
        variants += [(*base[:2], v, base[3]) for v in gemm_variants(p.q, False)]
        variants += [(*base[:3], v) for v in gemm_variants(p.out, False)]
        kw = dict(wk_ip=wki, wv_ip=wvi, ip_scale=0.5, num_ip_tokens=sk) if sk_ip else {}
        want = plain(x, ctx, ln_w, ln_b, wq8, sq, wk, wv, wo8, so, bo, heads, bias=bias, **kw).float()
        for v in dict.fromkeys(variants):
            run(chip_smoke, f"K11c {label}", (s, c), v, v == base, lambda: k11c(*v), want)


def sweep_backward(chip_smoke, ck, r, which) -> None:
    """K7 and K9 at the training shapes (B = 8): each GEMM's plan, then one
    choice changed at a time, against autograd over the plain versions."""

    import torch

    from ap_adapter_torch.ops.fused_block import fused_ln_self_attention_bwd_dx_plain, k7_plan
    from ap_adapter_torch.ops.fused_ff import fused_ln_geglu_ff_bwd_dx_plain, k9_plan

    heads, eps, b = chip_smoke.HEADS, 1e-5, chip_smoke.TRAIN_B
    for s, c in chip_smoke.TRAIN_SHAPES:
        m = b * s
        x, g, ln_w, ln_b = r(b, s, c), r(b, s, c), 1 + r(c, scale=0.1), r(c, scale=0.1)
        dx = torch.empty_like(x)
        if "K7" in which:
            wq, wk, wv, wo = (r(c, c, scale=c ** -0.5) for _ in range(4))
            scratch = x.new_empty(8 * m * c)
            stats = x.new_empty(2 * b * heads * s + m * c, dtype=torch.float32)

            def k7(qkv, go, gx):
                ck.launch("fused_ln_self_attention_bwd_dx", x.data_ptr(), g.data_ptr(), ln_w.data_ptr(),
                          ln_b.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), wo.data_ptr(),
                          scratch.data_ptr(), stats.data_ptr(), dx.data_ptr(), b, s, c, heads, eps, *qkv, *go, *gx)
                return dx

            p = k7_plan(b, s, c, heads)
            base = (p.qkv.launch_args, p.gattn.launch_args, p.gxn.launch_args)
            variants = [base] + [(v, *base[1:]) for v in gemm_variants(p.qkv, False)]
            variants += [(base[0], v, base[2]) for v in gemm_variants(p.gattn, False)]
            variants += [(*base[:2], v) for v in gemm_variants(p.gxn, False)]
            want = fused_ln_self_attention_bwd_dx_plain(x, g, ln_w, ln_b, wq, wk, wv, wo, heads).float()
            for v in dict.fromkeys(variants):
                run(chip_smoke, "K7", (s, c), v, v == base, lambda: k7(*v), want, chip_smoke.GRAD_TOL)
        if "K9" in which:
            w1, b1, w2 = r(8 * c, c, scale=c ** -0.5), r(8 * c, scale=0.1), r(c, 4 * c, scale=(4 * c) ** -0.5)
            scratch = x.new_empty(m * 9 * c)
            gxn = x.new_empty(m * c, dtype=torch.float32)

            def k9(gy, gx):
                ck.launch("fused_ln_geglu_ff_bwd_dx", x.data_ptr(), g.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
                          w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), scratch.data_ptr(), gxn.data_ptr(),
                          dx.data_ptr(), b, s, c, 4 * c, eps, *gy[1:], *gx)
                return dx

            p = k9_plan(b, s, c, 4 * c)
            base = (p.gy1.launch_args, p.gxn.launch_args)
            variants = [base] + [(v, base[1]) for v in gemm_variants(p.gy1, True)]
            variants += [(base[0], v) for v in gemm_variants(p.gxn, False)]
            want = fused_ln_geglu_ff_bwd_dx_plain(x, g, ln_w, ln_b, w1, b1, w2).float()
            for v in dict.fromkeys(variants):
                run(chip_smoke, "K9", (s, c), v, v == base, lambda: k9(*v), want, chip_smoke.GRAD_TOL)
        torch.cuda.synchronize()


def sweep_cross(chip_smoke, ck, r, device, which) -> None:
    """K4 and K8 at the training shapes (B = 8) with two contexts (8 text +
    512 adapter rows of 768; 64 T5 rows of 1024 with their bias): the plan,
    then K4's key tiles and each GEMM's plan changed one at a time; K8's dx
    against autograd over its plain version."""

    import torch

    from ap_adapter_torch.ops.fused_cross import (
        KEY_TILES, fused_ln_cross_attention_bwd_plain, fused_ln_cross_attention_plain, k4_plan, k8_plan)

    heads, eps, b = chip_smoke.HEADS, 1e-5, chip_smoke.TRAIN_B
    t5_bias = torch.zeros(b, 64, device=device)
    t5_bias[::2, 20:] = -10000.0
    for s, c in chip_smoke.TRAIN_SHAPES:
        x, g, ln_w, ln_b = r(b, s, c), r(b, s, c), 1 + r(c, scale=0.1), r(c, scale=0.1)
        wq, wo, bo = r(c, c, scale=c ** -0.5), r(c, c, scale=c ** -0.5), r(c, scale=0.1)
        out, dx = torch.empty_like(x), torch.empty_like(x)
        for label, sk, sk_ip, dc, bias in (("adapter", 8, 512, 768, None), ("t5+bias", 64, 0, 1024, t5_bias)):
            ctx = r(b, sk + sk_ip, dc)
            wk, wv, wki, wvi = (r(c, dc, scale=dc ** -0.5) if i < 2 or sk_ip else None for i in range(4))
            kw = dict(wk_ip=wki, wv_ip=wvi, ip_scale=0.5, num_ip_tokens=sk) if sk_ip else {}
            head = (x.data_ptr(), ctx.data_ptr(), sk + sk_ip, dc, sk)
            if "K4" in which:
                p = k4_plan(b, s, c, heads, sk, sk_ip, dc)
                scr = torch.empty(p.nbytes, dtype=torch.uint8, device=device)

                def k4(tiles, kvp, qp, op):
                    ck.launch("fused_ln_cross_attention", *head, ln_w.data_ptr(), ln_b.data_ptr(), wq.data_ptr(),
                              wk.data_ptr(), wv.data_ptr(), ck.ptr(wki), ck.ptr(wvi), wo.data_ptr(), bo.data_ptr(),
                              0.5, ck.ptr(bias), *(scr.data_ptr() + o for o in p.offsets), out.data_ptr(), b, s, c,
                              heads, eps, *tiles, *kvp, *qp, *op)
                    return out

                base = ((p.tk, p.tk_ip), p.kv.launch_args, p.q.launch_args, p.out.launch_args)
                variants = [base] + [(t, *base[1:]) for t in tile_variants(base[0], (sk, sk_ip), KEY_TILES)]
                variants += [(base[0], v, *base[2:]) for v in gemm_variants(p.kv, False)]
                variants += [(*base[:2], v, base[3]) for v in gemm_variants(p.q, False)]
                variants += [(*base[:3], v) for v in gemm_variants(p.out, False)]
                want = fused_ln_cross_attention_plain(x, ctx, ln_w, ln_b, wq, wk, wv, wo, bo, heads, bias=bias,
                                                      **kw).float()
                for v in dict.fromkeys(variants):
                    run(chip_smoke, f"K4 {label}", (s, c), v, v == base, lambda: k4(*v), want)
            if "K8" in which:
                p = k8_plan(b, s, c, heads, sk, sk_ip, dc)
                scr = torch.empty(p.nbytes, dtype=torch.uint8, device=device)
                dk = x.new_empty(2, b, max(sk_ip, 1), c, dtype=torch.float32)

                def k8(kvp, qp, gop, gxp):
                    ck.launch("fused_ln_cross_attention_bwd", x.data_ptr(), g.data_ptr(), *head[1:],
                              ln_w.data_ptr(), ln_b.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
                              ck.ptr(wki), ck.ptr(wvi), wo.data_ptr(), 0.5, ck.ptr(bias),
                              *(scr.data_ptr() + o for o in p.offsets), dx.data_ptr(), dk[0].data_ptr(),
                              dk[1].data_ptr(), b, s, c, heads, eps, *kvp, *qp, *gop, *gxp)
                    return dx

                base = (p.kv.launch_args, p.q.launch_args, p.gattn.launch_args, p.gxn.launch_args)
                variants = [base] + [(v, *base[1:]) for v in gemm_variants(p.kv, False)]
                variants += [(base[0], v, *base[2:]) for v in gemm_variants(p.q, False)]
                variants += [(*base[:2], v, base[3]) for v in gemm_variants(p.gattn, False)]
                variants += [(*base[:3], v) for v in gemm_variants(p.gxn, False)]
                want = fused_ln_cross_attention_bwd_plain(x, g, ctx, ln_w, ln_b, wq, wk, wv, wo, heads, bias=bias,
                                                          **kw)[0].float()
                for v in dict.fromkeys(variants):
                    run(chip_smoke, f"K8 {label}", (s, c), v, v == base, lambda: k8(*v), want, chip_smoke.GRAD_TOL)
        torch.cuda.synchronize()


def tile_variants(base, counts, widths) -> list:
    """``base`` (a key tile width per set) with one set's width changed to
    each of ``widths``; a set of no keys keeps its width."""

    return [tuple(w if j == i else base[j] for j in range(len(base))) for i, n in enumerate(counts) if n
            for w in widths]


def sweep_resnet(chip_smoke, ck, r, device) -> None:
    """K13 at every distinct resnet shape of the edit (B = 2, a per-sample
    temb): each conv's plan, then one choice changed at a time."""

    import torch

    from ap_adapter_torch.configs import PipelineConfig
    from ap_adapter_torch.ops.groupnorm import gn_cluster_plan
    from ap_adapter_torch.ops.resnet import conv_plan, fused_resnet_block_plain

    unet = PipelineConfig().unet
    groups, eps, b = unet.norm_num_groups, unet.norm_eps, 2
    for hh, ww, cin, cout in sorted(set(chip_smoke.resnet_shapes(unet, *chip_smoke.EDIT_LATENT))):
        sc = cin != cout
        x, temb = r(b, hh, ww, cin), r(b, cout)
        wts = (1 + r(cin, scale=0.1), r(cin, scale=0.1), r(3, 3, cin, cout, scale=(9 * cin) ** -0.5),
               r(cout, scale=0.1), 1 + r(cout, scale=0.1), r(cout, scale=0.1),
               r(3, 3, cout, cout, scale=(9 * cout) ** -0.5), r(cout, scale=0.1),
               r(1, 1, cin, cout, scale=cin ** -0.5) if sc else None, r(cout, scale=0.1) if sc else None)
        g1, g2 = gn_cluster_plan(hh * ww, cin, groups), gn_cluster_plan(hh * ww, cout, groups)
        a1 = x.new_empty(b, hh, ww, cin)
        h, a2, out = (x.new_empty(b, hh, ww, cout) for _ in range(3))

        def k13(p1, p2):
            ck.launch("fused_resnet_block", x.data_ptr(), temb.data_ptr(), cout, *(ck.ptr(t) for t in wts),
                      g1.n, g1.pchunk, g1.threads, int(g1.hold), a1.data_ptr(), h.data_ptr(), g2.n, g2.pchunk,
                      g2.threads, int(g2.hold), a2.data_ptr(), out.data_ptr(), b, cin, cout, hh, ww, groups, eps,
                      *p1, *p2)
            return out

        c1, c2 = conv_plan(b, hh, ww, cin, cout), conv_plan(b, hh, ww, cout, cout, cin if sc else 0)
        base = (c1.launch_args, c2.launch_args)
        variants = [base] + [(v, base[1]) for v in gemm_variants(c1, False)]
        variants += [(base[0], v) for v in gemm_variants(c2, False)]
        want = fused_resnet_block_plain(x, temb, *wts, groups, eps).float()
        for v in dict.fromkeys(variants):
            run(chip_smoke, f"K13 {cin}->{cout}", (hh * ww, cin), v, v == base, lambda: k13(*v), want)
        torch.cuda.synchronize()


def gemm_variants(plan, geglu: bool) -> list:
    """(bn, ksplit, stages) around ``plan`` (its k-blocks ``plan.nkb``): each
    width and split the kernel takes (with the plan's stage rule; the int8
    GEMM and the conv take 64 and 128), then the plan's width and split
    with each stage count."""

    from ap_adapter_torch.ops.hopper_gemm import MAX_STAGES, MIN_STAGES, hg_stages

    nkb = plan.nkb
    out = [(bn, ks, hg_stages(nkb, ks)) for bn in ((64,) if geglu else (64, 128))
           for ks in (1, 2, 3, 4, 6, 8) if ks <= min(nkb, bn // 8)]
    return out + [(plan.bn, plan.ksplit, st) for st in range(MIN_STAGES, MAX_STAGES + 1)]


def short(name: str) -> str:
    """``hgemm_kernel<64, 1, false>`` of ``void (anonymous namespace)::hgemm_kernel<64, 1, false>(...)``."""

    found = re.search(r"::(\w+(?:<[^>]*>)?)\(", name)
    return found.group(1) if found else name[:40]


def run(chip_smoke, name, shape, variant, planned, fn, want, tol=None) -> None:
    import torch

    got = fn().float()
    torch.cuda.synchronize()
    rel = (got - want).abs().max().item() / want.abs().max().item()
    if not rel <= (chip_smoke.TOL if tol is None else tol):
        raise RuntimeError(f"{name} {shape} {variant}: error {rel} of max|plain|")
    split = chip_smoke.device_split(fn)
    kernels = ", ".join(f"{short(n)} {t:.4f}" for n, t in split.items())
    print(f"sweep {name} S={shape[0]} C={shape[1]} {variant}{' (plan)' if planned else ''}: "
          f"device {sum(split.values()):.4f} ms [{kernels}]", flush=True)


if __name__ == "__main__":
    sys.exit(main())
