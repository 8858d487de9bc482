"""PyTorch port: the resnet kernel modules, K12 GroupNorm(+SiLU)
(``ops/groupnorm.py``) and K13 the fused ResnetBlock2D (``ops/resnet.py``),
held against the JAX package's Pallas kernels run with ``interpret=True`` on
the same numpy inputs (fp32, CPU). K13 keeps the JAX interface (NHWC, HWIO
weights); K12 takes the UNet's NCHW tensors, channels-last in memory, which
is the NHWC array seen through a permute. Tolerance 2e-4, as the
JAX package's own kernel tests use. The CUDA kernels are held against the
plain versions in ``test_torch_cuda.py`` (on the card only); the tiny UNet
under each switch is in ``test_torch_unet.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ap_adapter_tpu.ops.pallas_groupnorm as pg
from ap_adapter_tpu.ops import pallas_resnet as prn
from ap_adapter_torch.ops import cuda_kernels
from ap_adapter_torch.ops.groupnorm import (
    SMEM_LIMIT, gn_cluster_plan, group_norm_silu, group_norm_silu_plain, group_norm_silu_vjp)
from ap_adapter_torch.ops.resnet import fused_resnet_block, fused_resnet_block_plain, fused_resnet_block_vjp
from tests.torch_port_common import close, one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 2e-4


def _mk(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _nchw(a):
    """[B, H, W, C] numpy -> the NCHW tensor over the same (channels-last) memory."""

    return torch.from_numpy(a).permute(0, 3, 1, 2)


# -- K12 --------------------------------------------------------------------


@pytest.mark.parametrize("route", ["whole", "tiled"])
@pytest.mark.parametrize("act", [False, True])
def test_group_norm_matches_jax(rng, monkeypatch, route, act):
    """Whole-slab route ([2, 6x5, 64], 8 groups: N pads to 32) and the
    two-phase tiled route forced as test_pallas_groupnorm.py forces it
    ([2, 20x15, 64]: 300 rows in tiles of 128, the last one ragged)."""

    b, h, w, c, groups = (2, 6, 5, 64, 8) if route == "whole" else (2, 20, 15, 64, 8)
    if route == "tiled":
        monkeypatch.setattr(pg, "_WHOLE_SLAB_BYTES", 1)
        monkeypatch.setattr(pg, "_GN_TILE", 128)
    x = _mk(rng, b, h, w, c) + 3.0                     # a mean well away from 0
    gamma, beta = 1.0 + _mk(rng, c, scale=0.1), _mk(rng, c, scale=0.1)
    want = pg.fused_group_norm(jnp.asarray(x.reshape(b, h * w, c)), jnp.asarray(gamma), jnp.asarray(beta), groups,
                               eps=1e-5, act=act, interpret=True)
    want = np.asarray(want).reshape(b, h, w, c).transpose(0, 3, 1, 2)
    cuda_kernels.reset_launch_counts()
    args = (_nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta), groups, 1e-5, act)
    close(group_norm_silu_plain(*args), want, atol=TOL)
    close(group_norm_silu(*args), want, atol=TOL)
    assert cuda_kernels.LAUNCHES["group_norm_silu"] == 0      # a CPU tensor: the plain version only


@pytest.mark.parametrize("hw,c", [(1, 8), (64, 640), (252, 384), (4000, 128), (4000, 384), (300_000, 64)])
def test_gn_split_covers_every_position(hw, c):
    """K12's cluster plan for a sample: every position in exactly one CTA's
    chunk, at most 16 CTAs (a power of two), threads for all channels, and
    the shared memory of a block; a chunk too large to hold is read again."""

    plan = gn_cluster_plan(hw, c, 32 if c % 32 == 0 else 8)
    chunks = [range(j * plan.pchunk, min((j + 1) * plan.pchunk, hw)) for j in range(plan.n)]
    assert sorted(p for ch in chunks for p in ch) == list(range(hw))
    assert 1 <= plan.n <= 16 and plan.n & (plan.n - 1) == 0 and plan.n <= hw
    assert plan.threads % 32 == 0 and c // 8 <= plan.threads <= 512
    assert plan.smem <= SMEM_LIMIT and plan.hold == (plan.smem >= plan.pchunk * c * 2)


# -- K13 --------------------------------------------------------------------


def _resnet_args(rng, b, h, w, c_in, c_out, with_temb=True):
    """The operands of test_pallas_resnet.py: x NHWC, conv weights HWIO."""

    sc = c_in != c_out
    return (_mk(rng, b, h, w, c_in), _mk(rng, b, c_out) if with_temb else None,
            _mk(rng, c_in), _mk(rng, c_in, scale=0.1), _mk(rng, 3, 3, c_in, c_out, scale=(9 * c_in) ** -0.5),
            _mk(rng, c_out, scale=0.1), _mk(rng, c_out), _mk(rng, c_out, scale=0.1),
            _mk(rng, 3, 3, c_out, c_out, scale=(9 * c_out) ** -0.5), _mk(rng, c_out, scale=0.1),
            _mk(rng, 1, 1, c_in, c_out, scale=c_in ** -0.5) if sc else None,
            _mk(rng, c_out, scale=0.1) if sc else None)


@pytest.mark.parametrize("b,h,w,c_in,c_out,groups,with_temb", [
    (2, 10, 8, 128, 128, 32, True),    # identity shortcut
    (1, 9, 4, 256, 128, 32, True),     # 1x1 shortcut, odd H
    (1, 6, 2, 128, 256, 32, True),     # channel growth, W = 2: most taps on a border
    (1, 8, 4, 128, 128, 32, False),    # no time embedding (the VAE-style block)
])
def test_fused_resnet_matches_jax(rng, b, h, w, c_in, c_out, groups, with_temb):
    """The cases of test_pallas_resnet.py, against the JAX kernel in interpret mode."""

    args = _resnet_args(rng, b, h, w, c_in, c_out, with_temb)
    want = prn.fused_resnet_block(*(None if a is None else jnp.asarray(a) for a in args[:10]),
                                  sc_w=None if args[10] is None else jnp.asarray(args[10]),
                                  sc_b=None if args[11] is None else jnp.asarray(args[11]),
                                  groups=groups, eps=1e-5, interpret=True)
    port = [None if a is None else torch.from_numpy(a) for a in args]
    cuda_kernels.reset_launch_counts()
    close(fused_resnet_block_plain(*port, groups, 1e-5), np.asarray(want), atol=TOL)
    close(fused_resnet_block(*port, groups, 1e-5), np.asarray(want), atol=TOL)
    assert cuda_kernels.LAUNCHES["fused_resnet_block"] == 0
    if with_temb:   # the hoisted form: one [C_out] row for the whole batch
        row = port[1][:1].clone()
        close(fused_resnet_block_plain(port[0], row[0], *port[2:], groups, 1e-5),
              fused_resnet_block_plain(port[0], row.expand(b, -1), *port[2:], groups, 1e-5), atol=0)


def test_autograd_functions_give_plain_gradients(rng):
    """K12's and K13's autograd Functions (forward the module's wrapper,
    backward autograd over the plain version) against autograd through the
    plain versions: dx and the weight gradients."""

    x = _nchw(_mk(rng, 2, 4, 3, 32)).requires_grad_()
    gamma, beta = (torch.from_numpy(_mk(rng, 32)).requires_grad_() for _ in range(2))
    g = _nchw(_mk(rng, 2, 4, 3, 32))
    for act in (False, True):
        got = torch.autograd.grad(group_norm_silu_vjp(x, gamma, beta, 8, 1e-5, act), (x, gamma, beta), g)
        want = torch.autograd.grad(group_norm_silu_plain(x, gamma, beta, 8, 1e-5, act), (x, gamma, beta), g)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, rtol=0, atol=1e-6)

    port = [None if a is None else torch.from_numpy(a).requires_grad_() for a in _resnet_args(rng, 1, 5, 3, 32, 64)]
    live = [a for a in port if a is not None]
    g = torch.from_numpy(_mk(rng, 1, 5, 3, 64))
    got = torch.autograd.grad(fused_resnet_block_vjp(*port, 8, 1e-5), live, g)
    want = torch.autograd.grad(fused_resnet_block_plain(*port, 8, 1e-5), live, g)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-5)
    with pytest.raises(RuntimeError, match="fused_resnet_block_vjp"):   # the raw op records no graph
        fused_resnet_block(*port, 8, 1e-5)
