"""PyTorch port: the launch plans of K11a, K11b and K11c (``ops/int8.py::
k11a_plan``, ``k11b_plan``, ``k11c_plan``), pure functions the CPU can check.
Their int8 products run on the int8 Hopper GEMM
(``csrc/int8_blocks.cu::i8gemm_kernel``: 128-deep k-blocks of int8, a last
half block zero-filled by TMA; K11a's W1 product with a GEGLU epilogue over
value and gate columns), K11b's K/V projection on K1's bf16 GEMM with two
weight sets, and K11c's context K/V projections on the same GEMM over rows
of the strided context read through 3-D tensor maps (``ctx_boxes``);
``gemm_plan`` picks each GEMM's tile width, split-K cluster and ring
stages. The kernels themselves are held against their plain versions in
``test_torch_cuda.py`` (on the card only).
"""

import numpy as np
import pytest

from ap_adapter_torch.ops import hopper_gemm
from ap_adapter_torch.ops.hopper_gemm import BM, SMEM_LIMIT, ctx_boxes, ctx_tiles, gemm_plan, hg_smem_bytes
from ap_adapter_torch.ops.int8 import k11a_plan, k11b_plan, k11c_plan
from chip_smoke import HEADS, SHAPES
from tests.test_torch_kernel_plans import _assert_gemm_covers_fits_and_fills

# (B, S, C) of K11b calls: the edit path at 1, 2 and 4 clips, and ragged M
K11B_SHAPES = [(b, s, c) for b in (1, 2, 4) for s, c in SHAPES] + [(1, 37, 128), (3, 17, 384)]


@pytest.mark.parametrize("b,s,c", K11B_SHAPES)
def test_k11b_gemm_plans_cover_fit_and_fill(b, s, c):
    """K11b's int8 q and out GEMMs and its K/V GEMM: each k-block of each
    output tile run by exactly one CTA and each 8-column group stored by
    exactly one, clusters of at most 8, shared memory within 227 KB, at
    least 132 CTAs wherever the tiles reach that or the k-blocks are split
    (the checks of K1's and K3's GEMMs)."""

    m, plan = b * s, k11b_plan(b, s, c, HEADS)
    _assert_gemm_covers_fits_and_fills("q", plan.q, m, c, c, 1, False, int8=True)
    _assert_gemm_covers_fits_and_fills("kv", plan.kv, m, c, c, 2, False)
    _assert_gemm_covers_fits_and_fills("out", plan.out, m, c, c, 1, False, int8=True)


def test_k11b_plans_at_the_edit_shapes():
    """The edit path's plans (tile width, split-K, stages, CTAs): the int8
    GEMMs have 2, 3 and 5 k-blocks of 128 at C = 256, 384 and 640, so they
    split 3 and 5 ways at the 252 and 640 levels (the most the k-blocks
    allow) and not at all at S = 1000; the K/V GEMM splits 4 ways at 640."""

    got = {(s, c): {name: (*p.launch_args, p.ctas) for name, p in k11b_plan(2, s, c, HEADS)._asdict().items()}
           for s, c in SHAPES}
    assert got == {
        (1000, 256): {"q": (64, 1, 2, 128), "kv": (64, 1, 4, 256), "out": (64, 1, 2, 128)},
        (252, 384): {"q": (64, 3, 2, 144), "kv": (64, 1, 4, 96), "out": (64, 3, 2, 144)},
        (64, 640): {"q": (64, 5, 2, 100), "kv": (64, 4, 3, 160), "out": (64, 5, 2, 100)},
    }


@pytest.mark.parametrize("k,nkb", [(64, 1), (128, 1), (192, 2), (320, 3), (640, 5), (2560, 20)])
def test_int8_gemm_k_blocks_are_128_deep(k, nkb):
    """An int8 k-block is one 128-byte swizzle row, 128 values; a K that is
    a multiple of 64 but not of 128 ends in a half block (zero-filled by
    TMA in both operands, so it adds nothing)."""

    plan = gemm_plan(256, 256, k, int8=True)
    assert plan.nkb == nkb and -(-k // hopper_gemm.BK8) == nkb
    _assert_gemm_covers_fits_and_fills("int8", plan, 256, 256, k, 1, False, int8=True)


@pytest.mark.parametrize("args,kw", [((128, 256, 96), {}), ((128, 256, 256, 2), {}), ((128, 256, 256, 2, True), {}),
                                     ((0, 256, 256), {})])
def test_int8_gemm_plan_refuses_what_the_kernel_cannot_take(args, kw):
    """K % 64, two weight sets (the int8 kernel has one, also with the GEGLU
    epilogue) and an empty M raise."""

    with pytest.raises(ValueError):
        gemm_plan(*args, int8=True, **kw)


@pytest.mark.parametrize("args", [(2, 64, 96, 8), (2, 64, 256, 5), (2, 64, 2112, 33)])
def test_k11b_plan_refuses_other_widths(args):
    """C % 64, head dims off 16-128 in steps of 16, rows wider than the
    LayerNorm row pass takes (2048)."""

    with pytest.raises(ValueError):
        k11b_plan(*args)


# K11c's key sets on the edit path: GPT-2's 8 text tokens + 128 pooled
# AudioMAE tokens of 768 (pool 2/2), and a T5 site's 64 keys of 1024
K11C_KEYS = [(8, 128, 768), (64, 0, 1024)]


@pytest.mark.parametrize("b,s,c", K11B_SHAPES)
def test_k11a_gemm_plans_cover_fit_and_fill(b, s, c):
    """K11a's int8 W1 GEMM (GEGLU epilogue: 64-wide tiles of value and gate
    columns, two int32 accumulators) and W2 GEMM, by the checks of K11b's;
    the scratch holds x8, sx, y (fp32), y8 and sy, each 256-byte aligned."""

    m, inner = b * s, 4 * c
    plan = k11a_plan(b, s, c, inner, sms=hopper_gemm.H100_SMS)
    _assert_gemm_covers_fits_and_fills("w1", plan.w1, m, inner, c, 1, True, int8=True)
    _assert_gemm_covers_fits_and_fills("w2", plan.w2, m, c, inner, 1, False, int8=True)
    sizes = (m * c, 4 * m, 4 * m * inner, m * inner, 4 * m)
    ends = [o + n for o, n in zip(plan.offsets, sizes)]
    assert all(o % 256 == 0 for o in plan.offsets) and plan.offsets[0] == 0
    assert all(e <= o for e, o in zip(ends, plan.offsets[1:])) and ends[-1] <= plan.nbytes


@pytest.mark.parametrize("keys", K11C_KEYS)
@pytest.mark.parametrize("b,s,c", K11B_SHAPES)
def test_k11c_gemm_plans_cover_fit_and_fill(b, s, c, keys):
    """K11c's context K/V GEMM (4 weight sets with the adapter, 2 without,
    over b x ctx_tiles row tiles of 64) and its int8 q and out GEMMs (K11b's
    plans), by the same checks; each key set's tile is ``key_tile``'s."""

    sk, sk_ip, dc = keys
    m, plan = b * s, k11c_plan(b, s, c, HEADS, sk, sk_ip, dc)
    _assert_gemm_covers_fits_and_fills("kv", plan.kv, b * ctx_tiles(sk, sk_ip) * BM, c, dc, 4 if sk_ip else 2, False)
    _assert_gemm_covers_fits_and_fills("q", plan.q, m, c, c, 1, False, int8=True)
    _assert_gemm_covers_fits_and_fills("out", plan.out, m, c, c, 1, False, int8=True)
    assert plan.q == plan.out == k11b_plan(b, s, c, HEADS).q
    assert (plan.tk, plan.tk_ip) == ((16, 64) if sk_ip else (64, 16))
    assert all(o % 256 == 0 for o in plan.offsets) and plan.nbytes >= plan.offsets[-1] + 4 * m * c


def test_k11a_k11c_plans_at_the_edit_shapes():
    """The edit path's plans (tile width, split-K, stages, CTAs): K11a's W1
    GEMM fills the SMs unsplit at the 1000 and 252 levels and takes 80 CTAs
    at 640 (its 5-deep k-loop over more than half the SMs stays unsplit);
    the W2 GEMM (K = 4C) splits 4 and 8 ways at 252 and 640; the context K/V
    GEMM splits its 12 and 16 k-blocks where the key sets' tiles are few."""

    got = {(s, c): {"w1": (*k11a_plan(2, s, c, 4 * c).w1.launch_args, k11a_plan(2, s, c, 4 * c).w1.ctas),
                    "w2": (*k11a_plan(2, s, c, 4 * c).w2.launch_args, k11a_plan(2, s, c, 4 * c).w2.ctas),
                    **{f"kv{sk}": (*k11c_plan(2, s, c, HEADS, sk, ip, dc).kv.launch_args,
                                   k11c_plan(2, s, c, HEADS, sk, ip, dc).kv.ctas) for sk, ip, dc in K11C_KEYS}}
           for s, c in SHAPES}
    assert got == {
        (1000, 256): {"w1": (64, 1, 2, 512), "w2": (64, 1, 4, 128), "kv8": (64, 4, 3, 256), "kv64": (64, 8, 2, 128)},
        (252, 384): {"w1": (64, 1, 3, 192), "w2": (64, 4, 3, 192), "kv8": (64, 1, 4, 96), "kv64": (64, 8, 2, 192)},
        (64, 640): {"w1": (64, 1, 4, 80), "w2": (64, 8, 3, 160), "kv8": (64, 1, 4, 160), "kv64": (64, 4, 4, 160)},
    }


@pytest.mark.parametrize("m,k,ksplit", [(128, 640, 1), (128, 2560, 8), (2000, 256, 1)])
def test_int8_geglu_gemm_plan_is_accepted(m, k, ksplit):
    """gemm_plan takes int8 with the GEGLU epilogue: 64-wide tiles, each
    stage holding the A block and both the value and the gate block, and a
    split-K buffer for two int32 accumulators ([32 x 2] x 128 words), both
    within the shared memory a block may use."""

    plan = gemm_plan(m, 4 * k if k < 2560 else 1024, k, geglu=True, int8=True)
    assert plan.bn == 64 and plan.ksplit == ksplit and plan.nkb == -(-k // hopper_gemm.BK8)
    ring = plan.stages * (BM * 128 + 2 * 64 * 128)
    assert plan.smem == hg_smem_bytes(64, True, plan.stages, plan.ksplit) <= SMEM_LIMIT
    assert plan.smem - 2 * hopper_gemm.MAX_STAGES * 8 - 1024 == max(ring, 32 * 2 * 128 * 4 if ksplit > 1 else 0)


@pytest.mark.parametrize("b,sk,sk_ip,dc", [(2, 8, 128, 768), (2, 64, 0, 1024), (3, 70, 33, 128), (1, 8, 512, 64)])
def test_ctx_kv_box_walk_matches_the_projection(b, sk, sk_ip, dc):
    """A numpy emulation of K11c's context K/V GEMM over the flat context
    [b, sk + sk_ip, dc] as its 3-D tensor maps address it: pair p's box at
    (k0, m0, entry) reads element base_p + k + r * dc + entry * Sk_total * dc
    (base_0 = 0, base_1 = sk * dc) for rows r < n_p, zeros past them (never
    the other set's rows), 64 columns a k-block; the output rows each box
    stores (``ctx_boxes``) land once each, and equal ctx[:, rows] @ w.T."""

    rng = np.random.default_rng(0)
    total, c = sk + sk_ip, 64
    flat = rng.standard_normal(b * total * dc).astype(np.float32)
    ws = rng.standard_normal((4, c, dc)).astype(np.float32)
    outs = [np.full((b * n, c), np.nan, np.float32) for n in (sk, sk, sk_ip, sk_ip)]
    stored = [np.zeros(b * n, int) for n in (sk, sk, sk_ip, sk_ip)]
    for pair, entry, m0, rows, row0 in ctx_boxes(b, sk, sk_ip):
        n, base = (sk, 0) if pair == 0 else (sk_ip, sk * dc)
        box = np.zeros((BM, dc), np.float32)
        r = np.arange(BM)[m0 + np.arange(BM) < n]         # dims {dc, n_p, b}: rows past n_p arrive as zeros
        for k0 in range(0, dc, 64):                       # one TMA box a k-block
            at = base + k0 + (m0 + r) * dc + entry * total * dc
            box[r, k0:k0 + 64] = flat[at[:, None] + np.arange(64)]
        for s in (2 * pair, 2 * pair + 1):
            outs[s][row0:row0 + rows] = (box @ ws[s].T)[:rows]
            stored[s][row0:row0 + rows] += 1
    ctx = flat.reshape(b, total, dc)
    for s, (lo, hi) in enumerate([(0, sk), (0, sk), (sk, total), (sk, total)]):
        assert (stored[s] == 1).all(), s
        want = (ctx[:, lo:hi] @ ws[s].T).reshape(-1, c)
        np.testing.assert_allclose(outs[s], want, rtol=1e-5, atol=1e-4 * np.abs(want).max(initial=1.0))


@pytest.mark.parametrize("args", [(2, 64, 256, 8, 8, 128, 96), (2, 64, 256, 8, 0, 0, 768), (2, 64, 256, 5, 8, 0, 768),
                                  (2, 64, 2112, 33, 8, 0, 768)])
def test_k11c_plan_refuses_other_widths(args):
    """A context width off 64, no text keys, head dims off 16-128 in steps of
    16 and rows wider than the LayerNorm row pass takes."""

    with pytest.raises(ValueError):
        k11c_plan(*args)
