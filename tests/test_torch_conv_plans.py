"""PyTorch port: the launch plans of K13's convs (``ops/resnet.py::
conv_plan``) and the addressing of their TMA boxes, pure functions the CPU
can check.

A conv is an implicit GEMM over position tiles of R = 64 // W whole rows of
one sample: for tap (dh, dw) the kernel loads the box of 64 channels x W x
R rows at (ci0, dw, h0 + dh, b) of the activated input, and TMA fills every
element outside the tensor with zero, which is the SAME padding. A numpy
emulation of that box walk, tile by tile and k-block by k-block, is held
against ``F.conv2d`` with ``padding=1``. The kernel itself is held against
its plain version in ``test_torch_cuda.py`` (on the card only).
"""

from collections import Counter

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ap_adapter_torch.configs import PipelineConfig
from ap_adapter_torch.ops import hopper_gemm
from ap_adapter_torch.ops.groupnorm import SMEM_LIMIT
from ap_adapter_torch.ops.hopper_gemm import gemm_blocks
from ap_adapter_torch.ops.resnet import conv_plan, conv_rows, conv_tile_positions
from chip_smoke import EDIT_LATENT, resnet_shapes

SMS = 132
# (H, W, C_in, C_out) of every distinct UNet resnet of the edit path
RESNET_SHAPES = sorted(set(resnet_shapes(PipelineConfig().unet, *EDIT_LATENT)))


def _conv_launches(b, h, w, cin, cout):
    """(name, plan, C_x, shortcut C_in) of K13's two convs."""

    sc = cin if cin != cout else 0
    return [("conv1", conv_plan(b, h, w, cin, cout), cin, 0), ("conv2", conv_plan(b, h, w, cout, cout, sc), cout, sc)]


def test_the_edit_path_has_17_resnet_shapes():
    assert len(RESNET_SHAPES) == 17
    assert {(h, w) for h, w, _, _ in RESNET_SHAPES} == {(250, 16), (125, 8), (63, 4), (32, 2)}


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("h,w,cin,cout", RESNET_SHAPES)
def test_conv_plans_store_every_position_once_and_run_every_k_block_once(b, h, w, cin, cout):
    """Both convs of every resnet shape, at 1 and 2 clips: every output
    (position, 8-channel group) stored by exactly one CTA, the ragged H (125,
    63) and the rows past H of a last tile included; every k-block of every
    output tile (9 taps x C_x / 64, then the 1x1 shortcut's C_in / 64) run
    by exactly one CTA; clusters of at most 8; shared memory within 227 KB;
    at least 132 CTAs wherever the tiles reach that or the k-blocks are
    split."""

    for name, plan, cx, sc in _conv_launches(b, h, w, cin, cout):
        nkb = 9 * cx // 64 + sc // 64
        assert plan.nkb == nkb, name
        kblocks, stored = Counter(), Counter()
        for m0, n0, z, kb0, kb1, groups in gemm_blocks(plan):
            y = m0 // hopper_gemm.BM
            assert z == 0 and kb1 > kb0, (name, y, n0)
            kblocks.update((y, n0, kb) for kb in range(kb0, kb1))
            for pos in conv_tile_positions(y, b, h, w):
                if pos is not None:
                    stored.update((pos, n0 + 8 * g) for g in groups)
        tiles = [(y, n0) for y in range(plan.grid[1]) for n0 in range(0, cout, plan.bn)]
        assert kblocks == Counter((*t, kb) for t in tiles for kb in range(nkb)), name
        want = Counter(((bi, hh, ww), g) for bi in range(b) for hh in range(h) for ww in range(w)
                       for g in range(0, cout, 8))
        assert stored == want, name
        assert 1 <= plan.ksplit <= min(hopper_gemm.MAX_SPLIT, nkb, plan.bn // 8), (name, plan)
        assert 2 <= plan.stages <= 4 and plan.smem <= SMEM_LIMIT, (name, plan)
        if plan.grid[1] * (cout // 64) >= SMS or plan.ksplit > 1:
            assert plan.ctas >= SMS or plan.ksplit == min(hopper_gemm.MAX_SPLIT, nkb), (name, plan)


def test_conv_plans_at_the_levels():
    """Position tiles a sample (R rows of W) and the plans of the first
    resnet of each level at B = 2: 63, 16, 4 and 1 tiles a sample; level 0
    unsplit on 252 CTAs, the deeper levels split 2, 4 and 8 ways."""

    got = {}
    for h, w, cin, cout in [(250, 16, 128, 128), (125, 8, 128, 256), (63, 4, 256, 384), (32, 2, 384, 640)]:
        p = conv_plan(2, h, w, cin, cout)
        got[(h, w)] = (conv_rows(w), -(-h // conv_rows(w)), *p.launch_args, p.ctas)
    assert got == {(250, 16): (4, 63, 64, 1, 4, 252), (125, 8): (8, 16, 64, 2, 4, 256),
                   (63, 4): (16, 4, 64, 4, 4, 192), (32, 2): (32, 1, 64, 8, 4, 160)}


@pytest.mark.parametrize("args", [(2, 8, 4, 96, 128), (2, 8, 4, 128, 96), (2, 8, 4, 128, 128, 32),
                                  (2, 8, 65, 128, 128), (0, 8, 4, 128, 128)])
def test_conv_plan_refuses_what_the_kernel_cannot_take(args):
    """Channels off multiples of 64 (input, output, shortcut), W past 64, no
    samples."""

    with pytest.raises(ValueError):
        conv_plan(*args)


def _emulate_conv(a, wt, xs, wsc, plan, b, h, w):
    """The conv kernel's box walk in float64: per position tile y and
    k-block kb, the A box of 64 channels x W x R rows at (ci0, dw, h0 + dh)
    of ``a`` [b, h, w, cx] (zero outside the tensor; the 1x1 shortcut's
    boxes at (ci0, 0, h0) of ``xs``) against the B box of the weight rows
    [64 kb, 64 kb + 64) of ``wt`` [9 cx, cout] (``wsc`` [cin, cout]), summed
    over the k-blocks of each rank; stored by ``conv_tile_positions``."""

    cx, cout = a.shape[3], wt.shape[1]
    rows, cxb, kb_taps = conv_rows(w), cx // 64, 9 * (cx // 64)
    out = np.full((b, h, w, cout), np.nan)

    def box(src, ci0, dw, hs, bi):
        tile = np.zeros((64, 64))
        for rh in range(rows):
            for j in range(w):
                hh, ww = hs + rh, j + dw
                if 0 <= hh < h and 0 <= ww < w:
                    tile[rh * w + j] = src[bi, hh, ww, ci0:ci0 + 64]
        return tile

    partials, stores = {}, {}
    for m0, n0, _, kb0, kb1, groups in gemm_blocks(plan):
        y = m0 // 64
        bi, h0 = y // -(-h // rows), (y % -(-h // rows)) * rows
        acc = partials.setdefault((y, n0), np.zeros((64, plan.bn)))    # ranks in order: the cluster's combine
        stores.setdefault((y, n0), []).extend(groups)
        for kb in range(kb0, kb1):
            if kb < kb_taps:
                tap = kb // cxb
                A = box(a, (kb % cxb) * 64, tap % 3 - 1, h0 + tap // 3 - 1, bi)
                B = wt[kb * 64:(kb + 1) * 64, n0:n0 + plan.bn]
            else:
                kc = (kb - kb_taps) * 64
                A, B = box(xs, kc, 0, h0, bi), wsc[kc:kc + 64, n0:n0 + plan.bn]
            acc += A @ B
    for (y, n0), groups in stores.items():
        for r, pos in enumerate(conv_tile_positions(y, b, h, w)):
            if pos is not None:
                for g in groups:
                    out[pos][n0 + 8 * g:n0 + 8 * g + 8] = partials[y, n0][r, 8 * g:8 * g + 8]
    return out


@pytest.mark.parametrize("b,h,w,cx,cout,cin_sc,ksplit", [(2, 7, 2, 128, 64, 0, 1), (2, 7, 2, 128, 128, 64, 4),
                                                         (1, 5, 16, 64, 128, 0, 1), (2, 9, 3, 128, 64, 0, 2)])
def test_box_walk_emulation_matches_conv2d(b, h, w, cx, cout, cin_sc, ksplit):
    """The kernel's addressing in numpy against ``F.conv2d(padding=1)`` in
    fp32 (plus the 1x1 shortcut's conv where there is one), within 1e-5 of
    max|ref|: a level-3-like W = 2 at odd H (one 32-row tile, 7 rows valid),
    W = 16, and W = 3 (21 rows of 3, 63 of the 64 tile rows), unsplit and
    split over a cluster (the rank partials summed, as the cluster
    combine does)."""

    rng = np.random.default_rng(0)
    a = rng.standard_normal((b, h, w, cx)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cx, cout)) * (9 * cx) ** -0.5).astype(np.float32)
    xs = rng.standard_normal((b, h, w, max(cin_sc, 1))).astype(np.float32)
    wsc = (rng.standard_normal((max(cin_sc, 1), cout)) * 0.1).astype(np.float32)
    plan = conv_plan(b, h, w, cx, cout, cin_sc)._replace(ksplit=ksplit)
    plan = plan._replace(grid=((cout // plan.bn) * ksplit, plan.grid[1], 1))
    got = _emulate_conv(a.astype(np.float64), wt.reshape(9 * cx, cout).astype(np.float64), xs.astype(np.float64),
                        wsc.astype(np.float64), plan, b, h, w)
    ref = F.conv2d(torch.from_numpy(a).permute(0, 3, 1, 2), torch.from_numpy(wt).permute(3, 2, 0, 1), padding=1)
    if cin_sc:
        ref = ref + F.conv2d(torch.from_numpy(xs).permute(0, 3, 1, 2), torch.from_numpy(wsc).t()[:, :, None, None])
    ref = ref.permute(0, 2, 3, 1).numpy()
    assert not np.isnan(got).any()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
