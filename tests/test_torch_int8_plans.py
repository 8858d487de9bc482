"""PyTorch port: the launch plans of K11b (``ops/int8.py::k11b_plan``), pure
functions the CPU can check. K11b's q and out projections run on the int8
Hopper GEMM (``csrc/int8_blocks.cu::i8gemm_kernel``: 128-deep k-blocks of
int8, a last half block zero-filled by TMA), its K/V projection on K1's
bf16 GEMM with two weight sets; ``gemm_plan`` picks each GEMM's tile width,
split-K cluster and ring stages. The kernel itself is held against its
plain version in ``test_torch_cuda.py`` (on the card only).
"""

import pytest

from ap_adapter_torch.ops import hopper_gemm
from ap_adapter_torch.ops.hopper_gemm import gemm_plan
from ap_adapter_torch.ops.int8 import k11b_plan
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


@pytest.mark.parametrize("args,kw", [((128, 256, 96), {}), ((128, 256, 256, 2), {}), ((128, 256, 256, 1, True), {}),
                                     ((0, 256, 256), {})])
def test_int8_gemm_plan_refuses_what_the_kernel_cannot_take(args, kw):
    """K % 64, two weight sets, the GEGLU epilogue (none of them exists in
    the int8 kernel) and an empty M raise."""

    with pytest.raises(ValueError):
        gemm_plan(*args, int8=True, **kw)


@pytest.mark.parametrize("args", [(2, 64, 96, 8), (2, 64, 256, 5), (2, 64, 2112, 33)])
def test_k11b_plan_refuses_other_widths(args):
    """C % 64, head dims off 16-128 in steps of 16, rows wider than the
    LayerNorm row pass takes (2048)."""

    with pytest.raises(ValueError):
        k11b_plan(*args)
