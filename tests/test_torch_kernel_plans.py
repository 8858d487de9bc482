"""PyTorch port: the launch plans of the redesigned kernel wrappers, pure
functions that the CPU can check. ``attention_plan`` routes the
self-attention (K5/K6) by head dim and picks the wgmma kernel's 2-CTA
cluster; ``gn_cluster_plan`` cuts a GroupNorm sample (K12) into a
thread-block cluster's chunks; ``gemm_plan`` picks the Hopper GEMM's tile
width and split-K cluster for K1's and K3's projections (``k1_plan``,
``k3_plan``). The kernels themselves are held against their plain versions
in ``test_torch_cuda.py`` (on the card only).
"""

from collections import Counter

import pytest

from ap_adapter_torch.configs import PipelineConfig
from ap_adapter_torch.ops import hopper_gemm
from ap_adapter_torch.ops.fused_block import k1_plan
from ap_adapter_torch.ops.fused_ff import k3_plan
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


@pytest.mark.parametrize("b,s,c", BLOCK_SHAPES)
def test_k1_k3_gemm_plans_cover_fit_and_fill(b, s, c):
    """Every GEMM of K1 and K3 at the edit and training shapes: each k-block
    of each output tile is run by exactly one CTA and each 8-column group of
    each tile stored by exactly one (under split-K, the rank that combines
    it); a cluster of at most 8 (portable); shared memory within the 227 KB
    a block can use; at least 132 CTAs wherever the output tiles alone
    (M·N) reach that, and wherever the k-blocks are split; no split only
    where the 64-wide tiles fill half the SMs with a short k-loop."""

    for name, plan, m, n, k, sets, geglu in _k1_k3_gemms(b, s, c):
        assert plan == gemm_plan(m, n, k, sets, geglu), name
        nkb = k // hopper_gemm.BK
        kblocks, stored = Counter(), Counter()
        for m0, n0, z, kb0, kb1, groups in gemm_blocks(plan, m, n, k):
            assert kb1 > kb0, (name, m0, n0, z)
            kblocks.update((m0, n0, z, kb) for kb in range(kb0, kb1))
            stored.update((m0, n0 + 8 * g, z) for g in groups)
        tiles = [(m0, n0, z) for z in range(sets) for m0 in range(0, m, 64) for n0 in range(0, n, plan.bn)]
        assert kblocks == Counter((*t, kb) for t in tiles for kb in range(nkb)), name
        assert stored == Counter((m0, n0 + 8 * g, z) for m0, n0, z in tiles for g in range(plan.bn // 8)), name
        assert 1 <= plan.ksplit <= min(hopper_gemm.MAX_SPLIT, nkb, plan.bn // 8), (name, plan)
        assert plan.bn in ((64,) if geglu else (64, 128)) and n % plan.bn == 0, (name, plan)
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


@pytest.mark.parametrize("m,n,k,sets", [(128, 96, 256, 1), (128, 256, 96, 1), (0, 256, 256, 1), (128, 256, 256, 4),
                                        (128, 32, 256, 1)])
def test_gemm_plan_refuses_what_the_kernel_cannot_take(m, n, k, sets):
    with pytest.raises(ValueError):
        gemm_plan(m, n, k, sets)


@pytest.mark.parametrize("plan,args", [(k1_plan, (2, 64, 96, 8)), (k1_plan, (2, 64, 256, 5)),
                                       (k1_plan, (2, 64, 2112, 33)), (k3_plan, (2, 64, 256, 100)),
                                       (k3_plan, (2, 64, 2112, 8448))])
def test_block_plans_refuse_other_widths(plan, args):
    """C % 64, head dims off 16-128 in steps of 16, inner % 64, and rows
    wider than the LayerNorm row pass takes (2048)."""

    with pytest.raises(ValueError):
        plan(*args)
