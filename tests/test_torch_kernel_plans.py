"""PyTorch port: the launch plans of the redesigned kernel wrappers, pure
functions that the CPU can check. ``attention_plan`` routes the
self-attention (K5/K6) by head dim and picks the wgmma kernel's 2-CTA
cluster; ``gn_cluster_plan`` cuts a GroupNorm sample (K12) into a
thread-block cluster's chunks; ``gemm_plan`` picks the Hopper GEMM's tile
width and split-K cluster for K1's and K3's projections (``k1_plan``,
``k3_plan``) and for K2's (``k2_plan``); ``key_tile`` picks each key set's
tile in the two-key-set attention of K1, K2 and K10, whose tile order a
numpy emulation holds against the plain versions. The kernels themselves
are held against their plain versions in ``test_torch_cuda.py`` (on the
card only).
"""

from collections import Counter

import numpy as np
import pytest
import torch

from ap_adapter_torch.configs import PipelineConfig
from ap_adapter_torch.ops import hopper_gemm
from ap_adapter_torch.ops.attention import sdpa
from ap_adapter_torch.ops.dual_kv_attention import _plain as dual_kv_plain
from ap_adapter_torch.ops.fused_block import k1_plan, k7_plan
from ap_adapter_torch.ops.fused_cross import KEY_TILES, k2_plan, k4_plan, k8_plan, key_tile, key_tiles
from ap_adapter_torch.ops.fused_ff import k3_plan, k9_plan
from ap_adapter_torch.ops.groupnorm import SMEM_LIMIT, gn_cluster_plan
from ap_adapter_torch.ops.hopper_gemm import gemm_blocks, gemm_plan
from ap_adapter_torch.ops.self_attention import attention_plan
from chip_smoke import ATTN_SHAPES, EDIT_LATENT, HEADS, SHAPES, TRAIN_B, TRAIN_SHAPES, resnet_shapes

SMS = 132
# (B, S, C) of every K1 and K3 call on the edit path (B = 2) and in training (B = 8)
BLOCK_SHAPES = [(2, s, c) for s, c in SHAPES] + [(TRAIN_B, s, c) for s, c in TRAIN_SHAPES]


def _k1_k3_gemms(b, s, c):
    """(name, plan, M, N, K, sets, geglu) of the four GEMMs of K1 and K3 on x [b, s, c]."""

    m, p1, p3 = b * s, k1_plan(b, s, c, HEADS), k3_plan(b, s, c, 4 * c)
    return [("qkv", p1.qkv, m, c, c, 3, False), ("out", p1.out, m, c, c, 1, False),
            ("w1", p3.w1, m, 4 * c, c, 1, True), ("w2", p3.w2, m, c, 4 * c, 1, False)]


@pytest.mark.parametrize("shape,route,cluster", [
    ((1, 4000, 1, 512), "wgmma", "split_keys"),   # an edit's VAE decode: 63 query tiles for 132 SMs
    ((8, 4096, 1, 512), "wgmma", "alone"),        # a training batch's VAE encode: 512 query tiles
    ((2, 1000, 8, 32), "stream", "alone"),
    ((2, 1000, 8, 80), "stream", "alone"),
    ((1, 40, 1, 256), "wgmma", "split_keys"),     # two key tiles of 32
    ((1, 20, 1, 256), "wgmma", "alone"),          # one key tile, one query tile
    ((3, 2816, 1, 192), "wgmma", "alone"),        # 3 x 44 = 132 query tiles fill the card
    ((1, 64, 1, 128), "stream", "alone"),
])
def test_attention_plan_routes_and_clusters(shape, route, cluster):
    assert attention_plan(*shape) == (route, cluster)


def test_attention_plan_covers_the_smoke_shapes():
    assert [attention_plan(*s)[0] for s in ATTN_SHAPES] == ["wgmma", "wgmma", "stream", "stream"]


@pytest.mark.parametrize("d", [24, 136, 144, 200, 576, 1024])
def test_attention_plan_refuses_other_head_dims(d):
    with pytest.raises(ValueError):
        attention_plan(1, 4000, 1, d)


def test_gn_cluster_plan_at_every_edit_shape():
    """The 17 GroupNorm sample shapes of the edit's resnets (the smoke's K12
    cases): each position in exactly one CTA's chunk, a cluster of at most
    16, shared memory within the 227 KB a block can use, and every chunk of
    these samples (at most 3.07 MB) held in shared memory."""

    cfg = PipelineConfig().unet
    shapes = sorted({(h, w, c) for h, w, cin, cout in resnet_shapes(cfg, *EDIT_LATENT) for c in (cin, cout)})
    assert len(shapes) == 17
    for h, w, c in shapes:
        hw = h * w
        plan = gn_cluster_plan(hw, c, cfg.norm_num_groups)
        covered = [p for j in range(plan.n) for p in range(j * plan.pchunk, min((j + 1) * plan.pchunk, hw))]
        assert covered == list(range(hw)), (h, w, c)
        assert 1 <= plan.n <= 16 and plan.n & (plan.n - 1) == 0, (h, w, c)
        assert plan.smem <= SMEM_LIMIT and plan.hold, (h, w, c, plan)
        assert plan.threads % 32 == 0 and c // 8 <= plan.threads <= 512


def _k2_gemms(b, s, c):
    """(name, plan, M, N, K, sets, geglu) of K2's two GEMMs on x [b, s, c]."""

    m, plan = b * s, k2_plan(b, s, c, HEADS)
    return [("q", plan.q, m, c, c, 1, False), ("out", plan.out, m, c, c, 1, False)]


@pytest.mark.parametrize("b,s,c", BLOCK_SHAPES)
def test_k1_k3_gemm_plans_cover_fit_and_fill(b, s, c):
    """Every GEMM of K1 and K3 at the edit and training shapes: each k-block
    of each output tile is run by exactly one CTA and each 8-column group of
    each tile stored by exactly one (under split-K, the rank that combines
    it); a cluster of at most 8 (portable); shared memory within the 227 KB
    a block can use; at least 132 CTAs wherever the output tiles alone
    (M·N) reach that, and wherever the k-blocks are split; no split only
    where the 64-wide tiles fill half the SMs with a short k-loop."""

    for gemm in _k1_k3_gemms(b, s, c):
        _assert_gemm_covers_fits_and_fills(*gemm)


@pytest.mark.parametrize("b,s,c", BLOCK_SHAPES)
def test_k2_gemm_plans_cover_fit_and_fill(b, s, c):
    """K2's Q and out GEMMs at the edit and training shapes, by the checks
    of K1's and K3's."""

    for gemm in _k2_gemms(b, s, c):
        _assert_gemm_covers_fits_and_fills(*gemm)


def _assert_gemm_covers_fits_and_fills(name, plan, m, n, k, sets, geglu, int8=False, geglu_bwd=False):
    """One GEMM's plan: each k-block of each output tile run by exactly one CTA
    and each 8-column group of each tile stored by exactly one, within the
    cluster, shared memory and fill limits of the kernel (int8: the int8
    GEMM's 128-deep k-blocks; geglu_bwd: K9's three-product GEMM)."""

    assert plan == gemm_plan(m, n, k, sets, geglu, int8=int8, geglu_bwd=geglu_bwd), name
    nkb = -(-k // (hopper_gemm.BK8 if int8 else hopper_gemm.BK))
    assert plan.nkb == nkb, (name, plan)
    kblocks, stored = Counter(), Counter()
    for m0, n0, z, kb0, kb1, groups in gemm_blocks(plan):
        assert kb1 > kb0, (name, m0, n0, z)
        kblocks.update((m0, n0, z, kb) for kb in range(kb0, kb1))
        stored.update((m0, n0 + 8 * g, z) for g in groups)
    tiles = [(m0, n0, z) for z in range(sets) for m0 in range(0, m, 64) for n0 in range(0, n, plan.bn)]
    assert kblocks == Counter((*t, kb) for t in tiles for kb in range(nkb)), name
    assert stored == Counter((m0, n0 + 8 * g, z) for m0, n0, z in tiles for g in range(plan.bn // 8)), name
    assert 1 <= plan.ksplit <= min(hopper_gemm.MAX_SPLIT, nkb, plan.bn // 8), (name, plan)
    assert plan.bn in ((64,) if geglu or geglu_bwd else (64, 128)) and n % plan.bn == 0, (name, plan)
    assert 2 <= plan.stages <= min(4, max(2, -(-nkb // plan.ksplit))) and plan.smem <= SMEM_LIMIT, (name, plan)
    tiles = -(-m // 64) * (n // 64) * sets
    if tiles >= SMS or plan.ksplit > 1:
        assert plan.ctas >= SMS or plan.ksplit == min(hopper_gemm.MAX_SPLIT, nkb), (name, plan)
    elif tiles * min(hopper_gemm.MAX_SPLIT, nkb) >= SMS:
        assert 2 * tiles >= SMS and nkb < hopper_gemm.LONG_K_BLOCKS, (name, plan)




def test_k1_k3_plans_at_the_edit_shapes():
    """The edit path's plans, (tile width, split-K, stages, CTAs): split-K
    clusters where the output tiles fill less than half the SMs (K1's out
    GEMM and K3's W2 GEMM at the 252 and 640 levels, the QKV GEMM at 640)
    or the k-loop is long (K3's W2 at 1000, K = 1024); two stages where four
    would need two waves (K3's W1 at 1000)."""

    got = {(s, c): {name: (*plan.launch_args, plan.ctas) for name, plan, *_ in _k1_k3_gemms(2, s, c)}
           for s, c in SHAPES}
    assert got == {
        (1000, 256): {"qkv": (128, 1, 4, 192), "out": (64, 1, 4, 128), "w1": (64, 1, 2, 512),
                      "w2": (64, 2, 4, 256)},
        (252, 384): {"qkv": (64, 1, 4, 144), "out": (64, 4, 2, 192), "w1": (64, 1, 4, 192), "w2": (64, 4, 4, 192)},
        (64, 640): {"qkv": (64, 4, 3, 240), "out": (64, 8, 2, 160), "w1": (64, 1, 4, 80), "w2": (64, 8, 4, 160)},
    }


def test_k2_plans_at_the_edit_shapes():
    """K2's Q and out GEMMs have K1's out GEMM's shape and take its plan:
    unsplit 64-wide tiles at S = 1000, split-K clusters of 4 and 8 at the
    252 and 640 levels."""

    got = {(s, c): {name: (*plan.launch_args, plan.ctas) for name, plan, *_ in _k2_gemms(2, s, c)}
           for s, c in SHAPES}
    assert got == {(1000, 256): dict.fromkeys(("q", "out"), (64, 1, 4, 128)),
                   (252, 384): dict.fromkeys(("q", "out"), (64, 4, 2, 192)),
                   (64, 640): dict.fromkeys(("q", "out"), (64, 8, 2, 160))}
    assert all(k2_plan(2, s, c, HEADS).out == k1_plan(2, s, c, HEADS).out for s, c in SHAPES)


@pytest.mark.parametrize("n,want", [(1, 16), (8, 16), (16, 16), (17, 32), (32, 32), (33, 64), (64, 64), (65, 64),
                                    (128, 64), (512, 64)])
def test_key_tile_follows_the_set(n, want):
    """The narrowest tile that holds a short set (GPT-2's 8 keys: 16, so
    that a tile's exponentials are not spent on masked keys), 64 keys (a
    whole stage) for longer sets."""

    assert key_tile(n) == want


KEY_COUNTS = (1, 8, 64, 65, 128, 512)


@pytest.mark.parametrize("n", KEY_COUNTS)
def test_key_tiles_cover_each_key_once(n):
    """The attention's tiles by the kernel's formulas, for a first set of n
    keys against second sets of 0 (absent) and each count, and the other way
    round: the first set's tiles, then the second's; every key of each set
    in exactly one tile, every tile within a stage (64 keys), and only a
    set's last tile masks, where its keys overrun the set."""

    for n1, n2 in [(n, m) for m in (0,) + KEY_COUNTS] + [(m, n) for m in KEY_COUNTS]:
        tiles = list(key_tiles(n1, n2))
        assert [t[0] for t in tiles] == sorted(t[0] for t in tiles), (n1, n2)
        for kset, count in enumerate((n1, n2)):
            mine = [t for t in tiles if t[0] == kset]
            keys = Counter(k for _, k0, tk, _ in mine for k in range(k0, min(k0 + tk, count)))
            assert keys == Counter(range(count)), (n1, n2, kset)
            assert all(tk == key_tile(count) and tk in KEY_TILES and tk <= 64 for _, _, tk, _ in mine)
            assert [masks for *_, masks in mine] == [i == len(mine) - 1 and count % mine[-1][2] != 0
                                                      for i in range(len(mine))], (n1, n2, kset)


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(torch.bfloat16).float().numpy()


def _emulate_two_key_sets(q, sets, ip_scale):
    """The attention kernel's arithmetic in numpy, tile by tile in the
    kernel's order (``key_tiles``): per set an online softmax in the exp2
    domain (the scale folded into the exponent, or, with a bias, the scaled
    logits plus bias·log2(e) taken before the maximum), the unnormalised P
    rounded to bf16 before PV, O / l at the set's end, then one fp32
    combine O_1 / l_1 + s·O_2 / l_2. q [H, S, d]; sets: (k, v [H, n, d],
    bias [n] or None) for the first set, then the second (n may be 0)."""

    h, s, d = q.shape
    scale_log2 = np.float32(np.log2(np.e) / np.sqrt(d))
    (k1, _, _), (k2, _, _) = sets
    outs = []
    tiles = list(key_tiles(k1.shape[1], k2.shape[1]))
    for kset, (k, v, bias) in enumerate(sets):
        n = k.shape[1]
        if n == 0:
            continue
        m = np.full((h, s, 1), -np.inf, np.float32)
        l = np.zeros((h, s, 1), np.float32)
        o = np.zeros((h, s, d), np.float32)
        for _, k0, tk, masks in (t for t in tiles if t[0] == kset):
            kt = np.zeros((h, tk, d), np.float32)
            vt = np.zeros((h, tk, d), np.float32)
            kt[:, :min(tk, n - k0)] = k[:, k0:k0 + tk]
            vt[:, :min(tk, n - k0)] = v[:, k0:k0 + tk]
            logits = np.einsum("hsd,hkd->hsk", q, kt).astype(np.float32)
            valid = np.arange(k0, k0 + tk) < n
            assert masks == (not valid.all())
            if bias is not None:
                bl = np.where(valid, np.pad(bias, (0, tk))[k0:k0 + tk] * np.float32(np.log2(np.e)), -np.inf)
                t = logits * scale_log2 + bl.astype(np.float32)
                mn = np.maximum(m, t.max(-1, keepdims=True))
                p = np.exp2(t - mn)
            else:
                logits = np.where(valid, logits, -np.inf)
                mn = np.maximum(m, logits.max(-1, keepdims=True) * scale_log2)
                p = np.exp2(logits * scale_log2 - mn)
            c = np.exp2(m - mn)
            m = mn
            l = l * c + p.sum(-1, keepdims=True)
            o = o * c + np.einsum("hsk,hkd->hsd", _bf16(p), vt)
        outs.append(o / l)
    return _bf16(outs[0] + (np.float32(ip_scale) * outs[1] if len(outs) > 1 else 0))


@pytest.mark.parametrize("d,n1,n2,biased", [(32, 8, 130, False), (80, 8, 130, False), (32, 77, 0, True),
                                            (80, 64, 130, True)])
def test_tile_order_emulation_matches_the_plain_versions(d, n1, n2, biased):
    """The kernel's tile order and online softmax, emulated in numpy, against
    the plain versions on the same bf16 inputs: K10's plain version (both
    sets in fp32, one rounding) without a bias, and K2's plain attention
    (``sdpa`` per set with the text bias, each set rounded to bf16, then
    the sum) with one. Limit 1e-2 of max|plain|: the two round P to bf16 at
    different points (unnormalised in the kernel, normalised in ``sdpa``)
    and K2's plain version rounds each set's output before the sum, each
    worth about 4e-3 of an output."""

    rng = np.random.default_rng(d + n1 + n2)
    h, s, ip_scale = 2, 20, 0.55
    q, k1, v1, k2, v2 = (_bf16(rng.standard_normal((1, n, h, d)) * 2) for n in (s, n1, n1, n2, n2))
    bias = None
    if biased:
        bias = np.zeros(n1, np.float32)
        bias[n1 // 3:] = -10000.0
    heads_first = lambda a: a[0].transpose(1, 0, 2)
    got = _emulate_two_key_sets(heads_first(q), [(heads_first(k1), heads_first(v1), bias),
                                                 (heads_first(k2), heads_first(v2), None)], ip_scale)
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    if biased:
        want = sdpa(t(q), t(k1), t(v1), torch.from_numpy(bias)[None, None, None, :])
        if n2:
            want = want + torch.as_tensor(ip_scale, dtype=want.dtype) * sdpa(t(q), t(k2), t(v2))
    else:
        want = dual_kv_plain(t(q), t(k1), t(v1), t(k2), t(v2), ip_scale)
    want = heads_first(want.float().numpy())
    err = np.abs(got - want).max()
    assert err <= 1e-2 * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("m,n,k,sets", [(128, 96, 256, 1), (128, 256, 96, 1), (0, 256, 256, 1), (128, 256, 256, 5),
                                        (128, 32, 256, 1)])
def test_gemm_plan_refuses_what_the_kernel_cannot_take(m, n, k, sets):
    with pytest.raises(ValueError):
        gemm_plan(m, n, k, sets)


@pytest.mark.parametrize("plan,args", [(k1_plan, (2, 64, 96, 8)), (k1_plan, (2, 64, 256, 5)),
                                       (k1_plan, (2, 64, 2112, 33)), (k3_plan, (2, 64, 256, 100)),
                                       (k3_plan, (2, 64, 2112, 8448)), (k7_plan, (2, 64, 96, 8)),
                                       (k7_plan, (2, 64, 256, 5)), (k7_plan, (2, 64, 384, 16)),
                                       (k7_plan, (2, 64, 2112, 33)), (k9_plan, (2, 64, 256, 100)),
                                       (k9_plan, (2, 64, 96, 384)), (k9_plan, (2, 64, 2112, 8448)),
                                       (k4_plan, (2, 64, 256, 8, 8, 128, 96)), (k4_plan, (2, 64, 256, 5, 8, 0, 768)),
                                       (k4_plan, (2, 64, 256, 8, 0, 0, 768)), (k4_plan, (2, 64, 2112, 33, 8, 0, 768)),
                                       (k8_plan, (2, 64, 256, 8, 8, 128, 96)), (k8_plan, (2, 64, 256, 5, 8, 0, 768)),
                                       (k8_plan, (2, 64, 256, 8, 64, 0, 1000)), (k8_plan, (2, 64, 384, 16, 8, 0, 768))])
def test_block_plans_refuse_other_widths(plan, args):
    """C % 64, head dims off 16-128 in steps of 16, inner % 64, rows wider
    than the LayerNorm row pass takes (2048), and (K4, K8) a context width
    off 64 or no text keys."""

    with pytest.raises(ValueError):
        plan(*args)
