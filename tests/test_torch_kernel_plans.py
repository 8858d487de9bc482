"""PyTorch port: the launch plans of the redesigned K5/K6 and K12 wrappers,
pure functions that the CPU can check. ``attention_plan`` routes the
self-attention by head dim and picks the wgmma kernel's 2-CTA cluster; ``gn_cluster_plan``
cuts a GroupNorm sample into a thread-block cluster's chunks. The kernels
themselves are held against their plain versions in ``test_torch_cuda.py``
(on the card only)."""

import pytest

from ap_adapter_torch.configs import PipelineConfig
from ap_adapter_torch.ops.groupnorm import SMEM_LIMIT, gn_cluster_plan
from ap_adapter_torch.ops.self_attention import attention_plan
from chip_smoke import ATTN_SHAPES, EDIT_LATENT, resnet_shapes


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
