"""PyTorch port on the card: the hand-written CUDA kernels (K1-K13) against
their plain PyTorch versions and autograd over them, and the K10 route's
launches on a full-width UNet forward.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither jax nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py
"""

import re

import pytest
import torch

from ap_adapter_torch.ops import cuda_kernels
from ap_adapter_torch.ops.dual_kv_attention import _plain as dual_kv_attention_plain
from ap_adapter_torch.ops.dual_kv_attention import fused_dual_kv_attention
from ap_adapter_torch.ops.fused_block import (
    fused_ln_self_attention, fused_ln_self_attention_bwd_dx, fused_ln_self_attention_bwd_dx_plain,
    fused_ln_self_attention_plain, fused_ln_self_attention_vjp, k7_plan)
from ap_adapter_torch.ops.fused_cross import (
    adapter_weight_grads, fused_ln_cross_attention, fused_ln_cross_attention_bwd, fused_ln_cross_attention_bwd_plain,
    fused_ln_cross_attention_kv, fused_ln_cross_attention_kv_plain, fused_ln_cross_attention_plain,
    fused_ln_cross_attention_vjp, k4_plan, k8_plan)
from ap_adapter_torch.ops.fused_ff import (
    fused_ln_geglu_ff, fused_ln_geglu_ff_bwd_dx, fused_ln_geglu_ff_bwd_dx_plain, fused_ln_geglu_ff_plain, k9_plan)
from ap_adapter_torch.ops.groupnorm import group_norm_silu, group_norm_silu_plain
from ap_adapter_torch.ops.int8 import (
    fused_ln_cross_attention_int8, fused_ln_cross_attention_int8_plain, fused_ln_geglu_ff_int8,
    fused_ln_geglu_ff_int8_plain, fused_ln_self_attention_int8, fused_ln_self_attention_int8_plain,
    quantize_weight)
from ap_adapter_torch.ops.resnet import fused_resnet_block, fused_resnet_block_plain, fused_resnet_block_vjp
from ap_adapter_torch.ops.self_attention import self_attention_kernel, self_attention_plain, self_attention_vjp

# bf16 kernels vs their plain versions: bf16 rounds q, k, v and the
# probabilities at different points in the two, so the limit is a fraction
# of max|plain|; gradients pass through more bf16 roundings (P, dS, dq/dk/dv)
TOL = 2e-2
GRAD_TOL = 5e-2


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _check(got, want, tol=TOL):
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


@pytest.mark.gpu
@pytest.mark.parametrize("s,c", [(1000, 256), (252, 384), (64, 640), (37, 128)])
def test_kernels_match_plain(cuda_device, s, c):
    """At the three UNet levels (8 heads: d = 32, 48, 80) and one ragged size."""

    heads = 8
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=cuda_device) * scale).to(torch.bfloat16)

    x = r(2, s, c)
    ln_w, ln_b = 1 + r(c, scale=0.1), r(c, scale=0.1)
    wq, wk, wv, wo = (r(c, c, scale=c ** -0.5) for _ in range(4))
    bo = r(c, scale=0.1)
    before = dict(cuda_kernels.LAUNCHES)

    _check(fused_ln_self_attention(x, ln_w, ln_b, wq, wk, wv, wo, bo, heads),
           fused_ln_self_attention_plain(x, ln_w, ln_b, wq, wk, wv, wo, bo, heads))

    k, v, ki, vi = r(2, 8, c), r(2, 8, c), r(2, 128, c), r(2, 128, c)
    _check(fused_ln_cross_attention_kv(x, k, v, ln_w, ln_b, wq, wo, bo, heads, ki=ki, vi=vi, ip_scale=0.5),
           fused_ln_cross_attention_kv_plain(x, k, v, ln_w, ln_b, wq, wo, bo, heads, ki=ki, vi=vi,
                                             ip_scale=0.5))
    k, v = r(2, 70, c), r(2, 70, c)           # more keys than one 64-key tile
    bias = torch.zeros(2, 70, device=cuda_device)
    bias[0, 20:] = -10000.0
    _check(fused_ln_cross_attention_kv(x, k, v, ln_w, ln_b, wq, wo, bo, heads, bias=bias),
           fused_ln_cross_attention_kv_plain(x, k, v, ln_w, ln_b, wq, wo, bo, heads, bias=bias))

    w1, b1 = r(8 * c, c, scale=c ** -0.5), r(8 * c, scale=0.1)
    w2, b2 = r(c, 4 * c, scale=(4 * c) ** -0.5), r(c, scale=0.1)
    _check(fused_ln_geglu_ff(x, ln_w, ln_b, w1, b1, w2, b2),
           fused_ln_geglu_ff_plain(x, ln_w, ln_b, w1, b1, w2, b2))

    moved = {k: cuda_kernels.LAUNCHES[k] - before[k] for k in before}
    assert moved == {**dict.fromkeys(before, 0), "fused_ln_self_attention": 1, "fused_ln_cross_attention_kv": 2,
                     "fused_ln_geglu_ff": 1}


def _block_operands(device, b, s, c, seed):
    g = torch.Generator(device=device).manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=device) * scale).to(torch.bfloat16)

    x = r(b, s, c)
    ln_w, ln_b = 1 + r(c, scale=0.1), r(c, scale=0.1)
    sa = (ln_w, ln_b, *(r(c, c, scale=c ** -0.5) for _ in range(4)), r(c, scale=0.1))
    ff = (ln_w, ln_b, r(8 * c, c, scale=c ** -0.5), r(8 * c, scale=0.1), r(c, 4 * c, scale=(4 * c) ** -0.5),
          r(c, scale=0.1))
    return x, sa, ff


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,c", [(1, 1000, 256), (1, 252, 384), (2, 63, 640), (1, 63, 384), (3, 17, 256),
                                   (1, 65, 640), (8, 256, 384), (8, 64, 640), (8, 1024, 256)])
def test_redesigned_k1_k3_match_plain(cuda_device, b, s, c):
    """K1 and K3 on the Hopper GEMM (split-K where the plan splits) and K1's
    register-resident attention: ragged M (S = 1000 and 252 at B = 1, S = 63
    and 17, S = 65 whose second key tile holds one key), d = 48 and 80 (the
    head's columns end inside a 128-byte swizzle row), and the training
    shapes (B = 8); one launch each."""

    x, sa, ff = _block_operands(cuda_device, b, s, c, 3)
    before = dict(cuda_kernels.LAUNCHES)
    _check(fused_ln_self_attention(x, *sa, 8), fused_ln_self_attention_plain(x, *sa, 8))
    _check(fused_ln_geglu_ff(x, *ff), fused_ln_geglu_ff_plain(x, *ff))
    moved = {k: cuda_kernels.LAUNCHES[k] - before[k] for k in before}
    assert moved == {**dict.fromkeys(before, 0), "fused_ln_self_attention": 1, "fused_ln_geglu_ff": 1}


@pytest.mark.gpu
def test_redesigned_k1_k3_are_deterministic(cuda_device):
    """The split-K clusters combine in rank order, with no atomics: two calls
    at the 640 level (K1's out GEMM and K3's W2 GEMM split 8 ways) give the
    same bits."""

    x, sa, ff = _block_operands(cuda_device, 2, 64, 640, 4)
    for fn, args in ((fused_ln_self_attention, (*sa, 8)), (fused_ln_geglu_ff, ff)):
        first, second = fn(x, *args), fn(x, *args)
        torch.cuda.synchronize()
        assert torch.equal(first, second), fn.__name__


@pytest.mark.gpu
def test_kernels_refuse_what_they_cannot_take(cuda_device):
    """A CUDA tensor never falls back to the plain path: unsupported widths,
    dtypes and layouts raise."""

    x = torch.zeros(1, 8, 32, device=cuda_device, dtype=torch.bfloat16)
    w = torch.zeros(32, 32, device=cuda_device, dtype=torch.bfloat16)
    b = torch.zeros(32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):           # C % 64 != 0
        fused_ln_self_attention(x, b, b, w, w, w, w, b, 2)
    x = torch.zeros(1, 8, 64, device=cuda_device)
    w = torch.zeros(64, 64, device=cuda_device)
    b = torch.zeros(64, device=cuda_device)
    with pytest.raises(ValueError):           # fp32 operands
        fused_ln_self_attention(x, b, b, w, w, w, w, b, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("s,c,sk_ip", [(1024, 256, 512), (256, 384, 128), (64, 640, 8), (37, 128, 20)])
def test_training_kernels_match_plain(cuda_device, s, c, sk_ip):
    """K4 forward, K7/K8/K9 dx and K8's dk_ip/dv_ip at the training levels
    (B=2; the GPT-2 + AudioMAE context at 8 + sk_ip tokens of 768, the T5
    context at 64 tokens of 1024 with a padding bias) and one ragged size."""

    heads, b = 8, 2
    g = torch.Generator(device=cuda_device).manual_seed(1)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=cuda_device) * scale).to(torch.bfloat16)

    x, gy = r(b, s, c), r(b, s, c)
    ln_w, ln_b = 1 + r(c, scale=0.1), r(c, scale=0.1)
    wq, wk, wv, wo = (r(c, c, scale=c ** -0.5) for _ in range(4))
    bo = r(c, scale=0.1)
    before = dict(cuda_kernels.LAUNCHES)

    _check(fused_ln_self_attention_bwd_dx(x, gy, ln_w, ln_b, wq, wk, wv, wo, heads),
           fused_ln_self_attention_bwd_dx_plain(x, gy, ln_w, ln_b, wq, wk, wv, wo, heads), GRAD_TOL)

    w1, b1 = r(8 * c, c, scale=c ** -0.5), r(8 * c, scale=0.1)
    w2 = r(c, 4 * c, scale=(4 * c) ** -0.5)
    _check(fused_ln_geglu_ff_bwd_dx(x, gy, ln_w, ln_b, w1, b1, w2),
           fused_ln_geglu_ff_bwd_dx_plain(x, gy, ln_w, ln_b, w1, b1, w2), GRAD_TOL)

    ctx = r(b, 8 + sk_ip, 768)
    wkc, wvc, wki, wvi = (r(c, 768, scale=768 ** -0.5) for _ in range(4))
    kw = dict(wk_ip=wki, wv_ip=wvi, ip_scale=1.0)
    _check(fused_ln_cross_attention(x, ctx, ln_w, ln_b, wq, wkc, wvc, wo, bo, heads, **kw),
           fused_ln_cross_attention_plain(x, ctx, ln_w, ln_b, wq, wkc, wvc, wo, bo, heads, **kw))
    got = fused_ln_cross_attention_bwd(x, gy, ctx, ln_w, ln_b, wq, wkc, wvc, wo, heads, **kw)
    want = fused_ln_cross_attention_bwd_plain(x, gy, ctx, ln_w, ln_b, wq, wkc, wvc, wo, heads, **kw)
    for a, w in zip(got, want):
        _check(a, w, GRAD_TOL)

    t5 = r(b, 64, 1024)
    wk5, wv5 = (r(c, 1024, scale=1024 ** -0.5) for _ in range(2))
    bias = torch.zeros(b, 64, device=cuda_device)
    bias[0, 12:] = -10000.0
    _check(fused_ln_cross_attention(x, t5, ln_w, ln_b, wq, wk5, wv5, wo, bo, heads, bias=bias),
           fused_ln_cross_attention_plain(x, t5, ln_w, ln_b, wq, wk5, wv5, wo, bo, heads, bias=bias))
    got = fused_ln_cross_attention_bwd(x, gy, t5, ln_w, ln_b, wq, wk5, wv5, wo, heads, bias=bias)
    want = fused_ln_cross_attention_bwd_plain(x, gy, t5, ln_w, ln_b, wq, wk5, wv5, wo, heads, bias=bias)
    assert got[1] is None and want[1] is None
    _check(got[0], want[0], GRAD_TOL)

    moved = {k: cuda_kernels.LAUNCHES[k] - before[k] for k in before}
    assert moved == {**dict.fromkeys(before, 0), "fused_ln_cross_attention": 2,
                     "fused_ln_self_attention_bwd_dx": 1, "fused_ln_cross_attention_bwd": 2,
                     "fused_ln_geglu_ff_bwd_dx": 1}


@pytest.mark.gpu
def test_autograd_functions_on_the_card(cuda_device):
    """Gradients through the Functions: dx of K1 (K7) and the fp32 adapter
    weight gradients of K4 (K8 + one matmul) against autograd over the plain
    versions on the same bf16 inputs."""

    heads, b, s, c = 8, 2, 256, 384
    g = torch.Generator(device=cuda_device).manual_seed(2)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=cuda_device) * scale).to(torch.bfloat16)

    x = r(b, s, c).requires_grad_()
    ln_w, ln_b = 1 + r(c, scale=0.1), r(c, scale=0.1)
    wq, wk, wv, wo = (r(c, c, scale=c ** -0.5) for _ in range(4))
    bo = r(c, scale=0.1)
    ctx = r(b, 8 + 128, 768)
    wkc, wvc = (r(c, 768, scale=768 ** -0.5) for _ in range(2))
    wki, wvi = ((torch.randn(c, 768, generator=g, device=cuda_device) * 768 ** -0.5).requires_grad_()
                for _ in range(2))

    def run(self_attn, cross):
        y = self_attn(x, ln_w, ln_b, wq, wk, wv, wo, bo, heads)
        y = cross(y, ctx, ln_w, ln_b, wq, wkc, wvc, wo, bo, heads, wk_ip=wki, wv_ip=wvi, ip_scale=1.0)
        return torch.autograd.grad(y.float().square().mean(), [x, wki, wvi])

    got = run(fused_ln_self_attention_vjp, fused_ln_cross_attention_vjp)
    want = run(fused_ln_self_attention_plain, fused_ln_cross_attention_plain)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype
        _check(a, w, GRAD_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("s,c", [(1000, 256), (252, 384), (64, 640), (37, 128)])
def test_int8_kernels_match_plain(cuda_device, s, c):
    """K11a-c at the three UNet levels and one ragged size, on int8 weights
    from quantize_weight: the adapter site (8 text + 128 adapter tokens of
    768) and a T5 site (70 keys of 1024, more than one key tile, with a
    padding bias). Both versions quantize identically, so the limit is K1-K3's."""

    heads = 8
    g = torch.Generator(device=cuda_device).manual_seed(4)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=cuda_device) * scale).to(torch.bfloat16)

    x = r(2, s, c)
    ln_w, ln_b = 1 + r(c, scale=0.1), r(c, scale=0.1)
    wq8, sq = quantize_weight(r(c, c, scale=c ** -0.5))
    wo8, so = quantize_weight(r(c, c, scale=c ** -0.5))
    wk, wv, bo = r(c, c, scale=c ** -0.5), r(c, c, scale=c ** -0.5), r(c, scale=0.1)
    w1q, s1 = quantize_weight(r(8 * c, c, scale=c ** -0.5))
    w2q, s2 = quantize_weight(r(c, 4 * c, scale=(4 * c) ** -0.5))
    b1, b2 = r(8 * c, scale=0.1), r(c, scale=0.1)
    before = dict(cuda_kernels.LAUNCHES)

    ff = (x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2)
    _check(fused_ln_geglu_ff_int8(*ff), fused_ln_geglu_ff_int8_plain(*ff))
    sa = (x, ln_w, ln_b, wq8, sq, wk, wv, wo8, so, bo, heads)
    _check(fused_ln_self_attention_int8(*sa), fused_ln_self_attention_int8_plain(*sa))

    ctx = r(2, 8 + 128, 768)
    wkc, wvc, wki, wvi = (r(c, 768, scale=768 ** -0.5) for _ in range(4))
    ca = (x, ctx, ln_w, ln_b, wq8, sq, wkc, wvc, wo8, so, bo, heads)
    kw = dict(wk_ip=wki, wv_ip=wvi, ip_scale=0.5)
    _check(fused_ln_cross_attention_int8(*ca, **kw), fused_ln_cross_attention_int8_plain(*ca, **kw))
    t5 = r(2, 70, 1024)
    wk5, wv5 = (r(c, 1024, scale=1024 ** -0.5) for _ in range(2))
    bias = torch.zeros(2, 70, device=cuda_device)
    bias[0, 20:] = -10000.0
    ct = (x, t5, ln_w, ln_b, wq8, sq, wk5, wv5, wo8, so, bo, heads)
    _check(fused_ln_cross_attention_int8(*ct, bias=bias), fused_ln_cross_attention_int8_plain(*ct, bias=bias))

    moved = {k: cuda_kernels.LAUNCHES[k] - before[k] for k in before}
    assert moved == {**dict.fromkeys(before, 0), "fused_ln_geglu_ff_int8": 1,
                     "fused_ln_self_attention_int8": 1, "fused_ln_cross_attention_int8": 2}


@pytest.mark.gpu
def test_int8_kernels_refuse_what_they_cannot_take(cuda_device):
    """Float weights where int8 ones belong, widths the int8 GEMM cannot
    tile, fp32 activations and operands that require grad under grad mode
    raise; nothing falls back to the plain version."""

    c, heads = 128, 8
    x = torch.zeros(1, 8, c, device=cuda_device, dtype=torch.bfloat16)
    w = torch.zeros(c, c, device=cuda_device, dtype=torch.bfloat16)
    b = torch.zeros(c, device=cuda_device, dtype=torch.bfloat16)
    w8, s8 = quantize_weight(w + 1)
    with pytest.raises(ValueError):           # a bf16 weight as wq8
        fused_ln_self_attention_int8(x, b, b, w, s8, w, w, w8, s8, b, heads)
    with pytest.raises(ValueError):           # fp32 activations
        fused_ln_self_attention_int8(x.float(), b, b, w8, s8, w, w, w8, s8, b, heads)
    x96, w96, b96 = x[..., :96].contiguous(), w[:96, :96].contiguous(), b[:96].contiguous()
    q96, s96 = quantize_weight(w96 + 1)
    with pytest.raises(ValueError):           # C % 64 != 0
        fused_ln_self_attention_int8(x96, b96, b96, q96, s96, w96, w96, q96, s96, b96, 6)
    with pytest.raises(RuntimeError):         # grad mode, an operand that requires grad
        fused_ln_self_attention_int8(x.requires_grad_(), b, b, w8, s8, w, w, w8, s8, b, heads)



def _r(g, device, *shape, scale=1.0):
    return (torch.randn(*shape, generator=g, device=device) * scale).to(torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 4000, 1, 512), (2, 1000, 8, 80), (1, 37, 2, 32), (8, 1100, 1, 512),
                                   (1, 333, 2, 192), (1, 40, 1, 256), (9, 960, 1, 256)])
def test_self_attention_kernel_matches_plain(cuda_device, shape):
    """K5/K6 at the VAE mid block's edit shape (one head, d = 512: the wgmma
    kernel with its keys split over a 2-CTA cluster), at the UNet's d = 80
    and below one tile (the streamed routine), and on the wgmma kernel:
    without a cluster (144 query tiles, more than the 132 SMs), d = 192 with
    its keys split (three column blocks, a ragged query and key tile), two
    key tiles split one each, and at d = 256 without a cluster."""

    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = (_r(g, cuda_device, *shape) for _ in range(3))
    before = dict(cuda_kernels.LAUNCHES)
    _check(self_attention_kernel(q, k, v), self_attention_plain(q, k, v))
    moved = {n: cuda_kernels.LAUNCHES[n] - before[n] for n in before}
    assert moved == {**dict.fromkeys(before, 0), "self_attention": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("act", [False, True])
def test_group_norm_kernel_matches_plain(cuda_device, act):
    """K12 at the UNet's level-0 resnet shape (B=2, 128 channels, 250x16;
    channels-last), with a mean well away from 0."""

    g = torch.Generator(device=cuda_device).manual_seed(6)
    x = (_r(g, cuda_device, 2, 250, 16, 128) + 4).permute(0, 3, 1, 2)
    gamma, beta = 1 + _r(g, cuda_device, 128, scale=0.1), _r(g, cuda_device, 128, scale=0.1)
    before = dict(cuda_kernels.LAUNCHES)
    got = group_norm_silu(x, gamma, beta, 32, 1e-5, act)
    assert got.is_contiguous(memory_format=torch.channels_last)
    _check(got, group_norm_silu_plain(x, gamma, beta, 32, 1e-5, act))
    moved = {n: cuda_kernels.LAUNCHES[n] - before[n] for n in before}
    assert moved == {**dict.fromkeys(before, 0), "group_norm_silu": 1}


@pytest.mark.gpu
def test_group_norm_kernel_is_deterministic(cuda_device):
    """K12 at the largest edit GroupNorm sample (B=2, 384 channels, 250x16:
    a 16-CTA cluster holding its chunks) gives the same bits on two calls."""

    g = torch.Generator(device=cuda_device).manual_seed(8)
    x = (_r(g, cuda_device, 2, 250, 16, 384) + 2).permute(0, 3, 1, 2)
    gamma, beta = 1 + _r(g, cuda_device, 384, scale=0.1), _r(g, cuda_device, 384, scale=0.1)
    a = group_norm_silu(x, gamma, beta, 32, 1e-5, True)
    b = group_norm_silu(x, gamma, beta, 32, 1e-5, True)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    _check(a, group_norm_silu_plain(x, gamma, beta, 32, 1e-5, True))


@pytest.mark.gpu
@pytest.mark.parametrize("h,w,c_in,c_out,temb", [(125, 8, 128, 256, "batch"), (63, 4, 384, 384, "row"),
                                                 (32, 2, 1280, 640, None)])
def test_resnet_kernel_matches_plain(cuda_device, h, w, c_in, c_out, temb):
    """K13 at three UNet resnet shapes (B=2): a 1x1 shortcut with a per-sample
    temb, the identity shortcut with a hoisted temb row at H = 63, W = 4, and
    an up-block shortcut at W = 2 with no temb; the gradient through the
    autograd Function against autograd over the plain version."""

    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = _r(g, cuda_device, 2, h, w, c_in)
    t = {"batch": _r(g, cuda_device, 2, c_out), "row": _r(g, cuda_device, c_out), None: None}[temb]
    sc = c_in != c_out
    args = (x, t, 1 + _r(g, cuda_device, c_in, scale=0.1), _r(g, cuda_device, c_in, scale=0.1),
            _r(g, cuda_device, 3, 3, c_in, c_out, scale=(9 * c_in) ** -0.5), _r(g, cuda_device, c_out, scale=0.1),
            1 + _r(g, cuda_device, c_out, scale=0.1), _r(g, cuda_device, c_out, scale=0.1),
            _r(g, cuda_device, 3, 3, c_out, c_out, scale=(9 * c_out) ** -0.5), _r(g, cuda_device, c_out, scale=0.1),
            _r(g, cuda_device, 1, 1, c_in, c_out, scale=c_in ** -0.5) if sc else None,
            _r(g, cuda_device, c_out, scale=0.1) if sc else None)
    before = dict(cuda_kernels.LAUNCHES)
    _check(fused_resnet_block(*args, 32, 1e-5), fused_resnet_block_plain(*args, 32, 1e-5))
    moved = {n: cuda_kernels.LAUNCHES[n] - before[n] for n in before}
    assert moved == {**dict.fromkeys(before, 0), "fused_resnet_block": 1}
    xg = x.clone().requires_grad_()
    gy = _r(g, cuda_device, 2, h, w, c_out)
    got = torch.autograd.grad(fused_resnet_block_vjp(xg, *args[1:], 32, 1e-5), xg, gy)[0]
    want = torch.autograd.grad(fused_resnet_block_plain(xg, *args[1:], 32, 1e-5), xg, gy)[0]
    _check(got, want, GRAD_TOL)


@pytest.mark.gpu
def test_new_kernels_refuse_what_they_cannot_take(cuda_device):
    """Strided and fp32 operands, widths the kernels cannot tile and
    operands that require grad under grad mode raise; nothing falls back."""

    q = torch.zeros(1, 600, 1, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):           # fp32
        self_attention_kernel(q.float(), q.float(), q.float())
    qs = torch.zeros(1, 600, 2, 64, device=cuda_device, dtype=torch.bfloat16)[:, :, :1]
    with pytest.raises(ValueError):           # strided
        self_attention_kernel(qs, qs, qs)
    q24 = torch.zeros(1, 600, 1, 24, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):           # d % 16 != 0
        self_attention_kernel(q24, q24, q24)
    for d in (144, 576):                      # past the streamed routine, not a multiple of 64 / past 512
        qd = torch.zeros(1, 600, 1, d, device=cuda_device, dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            self_attention_kernel(qd, qd, qd)
    with pytest.raises(RuntimeError):         # grad mode, an operand that requires grad
        self_attention_kernel(q.clone().requires_grad_(), q, q)
    assert self_attention_vjp(q, q, q).shape == q.shape

    x = torch.zeros(2, 64, 8, 4, device=cuda_device, dtype=torch.bfloat16)
    gamma = torch.ones(64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):           # NCHW-contiguous, not channels-last
        group_norm_silu(x, gamma, gamma, 32)
    xc = x.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError):           # fp32
        group_norm_silu(xc.float(), gamma.float(), gamma.float(), 32)

    xr = torch.zeros(1, 4, 4, 64, device=cuda_device, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 64, 64, device=cuda_device, dtype=torch.bfloat16)
    b = torch.zeros(64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):           # strided x
        fused_resnet_block(xr.permute(0, 2, 1, 3), None, b, b, w, b, b, b, w, b, groups=32)
    with pytest.raises(ValueError):           # fp32 weights
        fused_resnet_block(xr, None, b, b, w.float(), b, b, b, w, b, groups=32)
    x48 = torch.zeros(1, 4, 4, 48, device=cuda_device, dtype=torch.bfloat16)
    w48 = torch.zeros(3, 3, 48, 48, device=cuda_device, dtype=torch.bfloat16)
    b48 = torch.zeros(48, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):           # C % 64 != 0
        fused_resnet_block(x48, None, b48, b48, w48, b48, b48, b48, w48, b48, groups=16)


@pytest.mark.gpu
@pytest.mark.parametrize("s,d,si", [(1000, 32, 32), (252, 48, 128), (64, 80, 512)])
def test_dual_kv_kernel_matches_plain(cuda_device, s, d, si):
    """K10 at the UNet's three levels (B=2, 8 heads, 8 text keys), each with
    one of the adapter's key counts (pool 4/4, 2/2, 1/1): one launch, within
    2e-2 of max|plain|."""

    g = torch.Generator(device=cuda_device).manual_seed(s)
    q, kt, vt, ki, vi = (torch.randn(2, n, 8, d, generator=g, device=cuda_device).to(torch.bfloat16)
                         for n in (s, 8, 8, si, si))
    before = cuda_kernels.LAUNCHES["dual_kv_attention"]
    got = fused_dual_kv_attention(q, kt, vt, ki, vi, 0.55)
    assert cuda_kernels.LAUNCHES["dual_kv_attention"] == before + 1
    _check(got, dual_kv_attention_plain(q, kt, vt, ki, vi, 0.55))


@pytest.mark.gpu
def test_dual_kv_kernel_launches_or_raises(cuda_device):
    """A CUDA operand launches K10 or raises: fp32, strided, an unsupported
    head dim, a bias, an empty key set, grad mode; nothing falls back."""

    q = torch.zeros(2, 64, 8, 80, device=cuda_device, dtype=torch.bfloat16)
    k = torch.zeros(2, 8, 8, 80, device=cuda_device, dtype=torch.bfloat16)
    before = cuda_kernels.LAUNCHES["dual_kv_attention"]
    with pytest.raises(ValueError):           # fp32
        fused_dual_kv_attention(q.float(), k.float(), k.float(), k.float(), k.float(), 0.5)
    with pytest.raises(ValueError):           # strided
        fused_dual_kv_attention(q[:, :, :4], k[:, :, :4], k[:, :, :4], k[:, :, :4], k[:, :, :4], 0.5)
    q40, k40 = q[..., :40].contiguous(), k[..., :40].contiguous()
    with pytest.raises(ValueError):           # d % 16 != 0
        fused_dual_kv_attention(q40, k40, k40, k40, k40, 0.5)
    with pytest.raises(ValueError):           # a text bias
        fused_dual_kv_attention(q, k, k, k, k, 0.5, bias=torch.zeros(2, 8, device=cuda_device))
    with pytest.raises(ValueError):           # no audio keys
        fused_dual_kv_attention(q, k, k, k[:, :0], k[:, :0], 0.5)
    with pytest.raises(RuntimeError):         # grad mode, an operand that requires grad
        fused_dual_kv_attention(q.clone().requires_grad_(), k, k, k, k, 0.5)
    assert cuda_kernels.LAUNCHES["dual_kv_attention"] == before
    assert fused_dual_kv_attention(q, k, k, k, k, 0.5).shape == q.shape
    assert cuda_kernels.LAUNCHES["dual_kv_attention"] == before + 1


@pytest.mark.gpu
def test_dual_kv_route_launches_on_a_full_width_unet(cuda_device):
    """One full-width UNet forward under use_pallas_attention (16x16 latent,
    hoisted K/V, 8 + 128 adapter-stream tokens, 64 T5 tokens): K10 at the 32
    adapter sites, K2 at the 32 T5 sites only, K1 and K3 as always."""

    from ap_adapter_torch.configs import UNetConfig
    from ap_adapter_torch.models.hoist import precompute_cross_kv
    from ap_adapter_torch.models.unet import AudioLDM2UNet

    with torch.device(cuda_device):
        unet = AudioLDM2UNet(UNetConfig(use_pallas_attention=True)).to(torch.bfloat16).eval()
    g = torch.Generator(device=cuda_device).manual_seed(0)
    lat = torch.randn(2, 16, 16, 8, generator=g, device=cuda_device)
    ehs0 = torch.randn(2, 8 + 128, 768, generator=g, device=cuda_device)
    ehs1 = torch.randn(2, 64, 1024, generator=g, device=cuda_device)
    mask = torch.ones(2, 64, dtype=torch.long, device=cuda_device)
    with torch.no_grad():
        kv = precompute_cross_kv(unet, ehs0, ehs1, mask)
        cuda_kernels.reset_launch_counts()
        out = unet(lat, torch.full((2,), 501.0, device=cuda_device), ehs0, ehs1, mask, ip_scale=0.55, ctx_kv=kv)
    torch.cuda.synchronize()
    assert out.shape == lat.shape and torch.isfinite(out).all()
    moved = {k: v for k, v in cuda_kernels.LAUNCHES.items() if v}
    assert moved == {"dual_kv_attention": 32, "fused_ln_cross_attention_kv": 32, "fused_ln_self_attention": 192,
                     "fused_ln_geglu_ff": 128}


# key counts of the two-key-set attention (K2, K10): one key, GPT-2's 8, T5's
# 64 and a 77-key set (a 64-key tile, then one that masks 51 of 64); the
# adapter's pooled AudioMAE counts and 520 (eight 64-key tiles and a ninth
# with 8)
TEXT_KEYS = (1, 8, 64, 77)
ADAPTER_KEYS = (32, 128, 512, 520)


def _padding_bias(device, b, sk):
    """A T5-style key bias [b, sk]: 0, or -10000 on the padded keys; batch
    entries padded from different keys."""

    bias = torch.zeros(b, sk, device=device)
    for i in range(b):
        bias[i, (sk + i) // (2 + i) + 1:] = -10000.0
    return bias


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,c", [(1, 1000, 256), (2, 1000, 256), (1, 252, 384), (2, 252, 384), (1, 64, 640),
                                   (2, 64, 640), (1, 63, 384), (2, 63, 640), (1, 17, 256), (2, 17, 384)])
def test_k2_key_sets_match_plain(cuda_device, b, s, c):
    """K2 on the Hopper routines (LN pass, Q GEMM, two-key-set attention, out
    GEMM): ragged M, d = 32, 48 and 80 (8 heads); every text key count,
    with the adapter set absent and at every adapter count, with and
    without the padding bias; one launch a call."""

    x, sa, _ = _block_operands(cuda_device, b, s, c, 5)
    ln_w, ln_b, wq, _, _, wo, bo = sa
    g = torch.Generator(device=cuda_device).manual_seed(6)

    def r(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device).to(torch.bfloat16)

    before = dict(cuda_kernels.LAUNCHES)
    calls = 0
    for sk in TEXT_KEYS:
        k, v = r(b, sk, c), r(b, sk, c)
        for sk_ip in (0,) + ADAPTER_KEYS:
            ad = {} if sk_ip == 0 else dict(ki=r(b, sk_ip, c), vi=r(b, sk_ip, c), ip_scale=0.55)
            for bias in (None, _padding_bias(cuda_device, b, sk)):
                _check(fused_ln_cross_attention_kv(x, k, v, ln_w, ln_b, wq, wo, bo, 8, bias=bias, **ad),
                       fused_ln_cross_attention_kv_plain(x, k, v, ln_w, ln_b, wq, wo, bo, 8, bias=bias, **ad))
                calls += 1
    moved = {k: cuda_kernels.LAUNCHES[k] - before[k] for k in before}
    assert moved == {**dict.fromkeys(before, 0), "fused_ln_cross_attention_kv": calls}


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,d", [(2, 1000, 32), (2, 252, 48), (2, 64, 80), (1, 63, 32), (1, 17, 80)])
def test_k10_key_sets_match_plain(cuda_device, b, s, d):
    """K10 on the two-key-set attention at every text and adapter key count
    of K2's test, ragged S: one launch a call."""

    g = torch.Generator(device=cuda_device).manual_seed(s + d)

    def r(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device).to(torch.bfloat16)

    q = r(b, s, 8, d)
    before = cuda_kernels.LAUNCHES["dual_kv_attention"]
    for st in TEXT_KEYS:
        kt, vt = r(b, st, 8, d), r(b, st, 8, d)
        for si in ADAPTER_KEYS:
            ki, vi = r(b, si, 8, d), r(b, si, 8, d)
            _check(fused_dual_kv_attention(q, kt, vt, ki, vi, 0.55), dual_kv_attention_plain(q, kt, vt, ki, vi, 0.55))
    assert cuda_kernels.LAUNCHES["dual_kv_attention"] == before + len(TEXT_KEYS) * len(ADAPTER_KEYS)


@pytest.mark.gpu
def test_k2_k10_are_deterministic(cuda_device):
    """Two calls give the same bits: K2 at the 640 level (its Q and out GEMMs
    split 8 ways over a cluster) with both key sets and the bias, and K10."""

    x, sa, _ = _block_operands(cuda_device, 2, 64, 640, 7)
    ln_w, ln_b, wq, _, _, wo, bo = sa
    g = torch.Generator(device=cuda_device).manual_seed(8)
    k, v, ki, vi = (torch.randn(2, n, 640, generator=g, device=cuda_device).to(torch.bfloat16)
                    for n in (77, 77, 520, 520))
    bias = _padding_bias(cuda_device, 2, 77)
    k2 = lambda: fused_ln_cross_attention_kv(x, k, v, ln_w, ln_b, wq, wo, bo, 8, ki=ki, vi=vi, ip_scale=0.55,
                                             bias=bias)
    heads = lambda t: t.reshape(2, -1, 8, 80)
    k10 = lambda: fused_dual_kv_attention(heads(x), heads(k), heads(v), heads(ki), heads(vi), 0.55)
    for fn in (k2, k10):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        assert torch.equal(first, second)


def _k11b_operands(device, b, s, c, seed):
    """x [b, s, c] and K11b's other operands (int8 wq8/wo8 from quantize_weight)."""

    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *shape, scale=1.0: _r(g, device, *shape, scale=scale)
    wq8, sq = quantize_weight(r(c, c, scale=c ** -0.5))
    wo8, so = quantize_weight(r(c, c, scale=c ** -0.5))
    return r(b, s, c), (1 + r(c, scale=0.1), r(c, scale=0.1), wq8, sq, r(c, c, scale=c ** -0.5),
                        r(c, c, scale=c ** -0.5), wo8, so, r(c, scale=0.1))


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,c,heads", [(2, 1000, 256, 8), (2, 252, 384, 8), (2, 64, 640, 8), (1, 37, 128, 4),
                                         (3, 17, 384, 8), (1, 63, 640, 8)])
def test_k11b_matches_plain(cuda_device, b, s, c, heads):
    """K11b on the int8 wgmma GEMM, K1's K/V GEMM and attention (fp32 store)
    at head dims 32, 48 and 80: the three UNet levels and ragged M (the last
    row tile and query tile part-filled); one launch a call."""

    x, ops = _k11b_operands(cuda_device, b, s, c, 11)
    before = dict(cuda_kernels.LAUNCHES)
    _check(fused_ln_self_attention_int8(x, *ops, heads), fused_ln_self_attention_int8_plain(x, *ops, heads))
    moved = {k: cuda_kernels.LAUNCHES[k] - before[k] for k in before}
    assert moved == {**dict.fromkeys(before, 0), "fused_ln_self_attention_int8": 1}


def _resnet_operands(device, b, h, w, c_in, c_out, temb, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *shape, scale=1.0: _r(g, device, *shape, scale=scale)
    sc = c_in != c_out
    t = {"batch": r(b, c_out), "row": r(c_out), None: None}[temb]
    return (r(b, h, w, c_in), t, 1 + r(c_in, scale=0.1), r(c_in, scale=0.1),
            r(3, 3, c_in, c_out, scale=(9 * c_in) ** -0.5), r(c_out, scale=0.1), 1 + r(c_out, scale=0.1),
            r(c_out, scale=0.1), r(3, 3, c_out, c_out, scale=(9 * c_out) ** -0.5), r(c_out, scale=0.1),
            r(1, 1, c_in, c_out, scale=c_in ** -0.5) if sc else None, r(c_out, scale=0.1) if sc else None)


@pytest.mark.gpu
@pytest.mark.parametrize("h,w,c_in,c_out,temb", [
    (250, 16, 128, 128, "batch"), (250, 16, 384, 128, None), (125, 8, 256, 256, "row"), (125, 8, 640, 256, None),
    (63, 4, 384, 384, None), (63, 4, 1024, 384, "batch"), (32, 2, 640, 640, "row"), (32, 2, 1280, 640, "batch"),
    (5, 2, 64, 128, None)])
def test_k13_matches_plain_at_every_level(cuda_device, h, w, c_in, c_out, temb):
    """K13's TMA implicit-GEMM convs at the four UNet levels (W = 16, 8, 4,
    2; ragged H 125 and 63, whose last position tile is part-filled), with
    the identity and the 1x1 shortcut, a temb per sample, one row for the
    batch, or none; and a tile past H at W = 2 (5 rows of a 32-row tile)."""

    args = _resnet_operands(cuda_device, 2, h, w, c_in, c_out, temb, 13)
    before = dict(cuda_kernels.LAUNCHES)
    _check(fused_resnet_block(*args, 32, 1e-5), fused_resnet_block_plain(*args, 32, 1e-5))
    moved = {n: cuda_kernels.LAUNCHES[n] - before[n] for n in before}
    assert moved == {**dict.fromkeys(before, 0), "fused_resnet_block": 1}


@pytest.mark.gpu
def test_k11b_k13_are_deterministic(cuda_device):
    """Two calls give the same bits: K11b at the 640 level (its int8 GEMMs
    split over a cluster, int32 partials) and K13 at level 3 (both convs
    split 8 ways, fp32 partials combined in rank order)."""

    x, ops = _k11b_operands(cuda_device, 2, 64, 640, 12)
    args = _resnet_operands(cuda_device, 2, 32, 2, 1280, 640, "batch", 14)
    for fn in (lambda: fused_ln_self_attention_int8(x, *ops, 8), lambda: fused_resnet_block(*args, 32, 1e-5)):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.gpu
def test_k13_activation_is_k12_bit_for_bit(cuda_device):
    """K13's convs read a1 = silu(gn1(x)) and a2 = silu(gn2(h)) from K12's
    launch with SiLU, the value the first port's conv recomputed inline at
    every tap, bf16(silu(fmaf(x, scale, shift))): the scratch the raw entry
    point fills equals K12's output on x and on h, bit for bit."""

    from ap_adapter_torch.ops.groupnorm import gn_cluster_plan
    from ap_adapter_torch.ops.resnet import conv_plan

    b, h, w, c_in, c_out = 2, 125, 8, 256, 384
    x, temb, *wts = _resnet_operands(cuda_device, b, h, w, c_in, c_out, "batch", 15)
    g1, g2 = gn_cluster_plan(h * w, c_in, 32), gn_cluster_plan(h * w, c_out, 32)
    a1 = x.new_empty(b, h, w, c_in)
    hb, a2, out = (x.new_empty(b, h, w, c_out) for _ in range(3))
    cuda_kernels.launch("fused_resnet_block", x.data_ptr(), temb.data_ptr(), c_out, *(t.data_ptr() for t in wts),
                        g1.n, g1.pchunk, g1.threads, int(g1.hold), a1.data_ptr(), hb.data_ptr(), g2.n, g2.pchunk,
                        g2.threads, int(g2.hold), a2.data_ptr(), out.data_ptr(), b, c_in, c_out, h, w, 32, 1e-5,
                        *conv_plan(b, h, w, c_in, c_out).launch_args,
                        *conv_plan(b, h, w, c_out, c_out, c_in).launch_args)
    k12 = lambda t, gamma, beta: group_norm_silu(t.permute(0, 3, 1, 2), gamma, beta, 32, 1e-5, True)
    torch.cuda.synchronize()
    assert torch.equal(a1.permute(0, 3, 1, 2), k12(x, wts[0], wts[1]))
    assert torch.equal(a2.permute(0, 3, 1, 2), k12(hb, wts[4], wts[5]))


def _k11a_operands(device, b, s, c, seed):
    """x [b, s, c] and K11a's other operands (int8 w1q/w2q from quantize_weight, inner = 4C)."""

    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *shape, scale=1.0: _r(g, device, *shape, scale=scale)
    w1q, s1 = quantize_weight(r(8 * c, c, scale=c ** -0.5))
    w2q, s2 = quantize_weight(r(c, 4 * c, scale=(4 * c) ** -0.5))
    return r(b, s, c), (1 + r(c, scale=0.1), r(c, scale=0.1), w1q, s1, r(8 * c, scale=0.1), w2q, s2,
                        r(c, scale=0.1))


def _k11c_operands(device, b, s, c, heads, sk, sk_ip, dc, biased, seed):
    """K11c's positional operands for x [b, s, c] against a context of sk text
    and sk_ip adapter rows of width dc, and its keyword arguments: the
    adapter's weights (sk_ip > 0, ip_scale 0.55) and a T5 padding bias."""

    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *shape, scale=1.0: _r(g, device, *shape, scale=scale)
    wq8, sq = quantize_weight(r(c, c, scale=c ** -0.5))
    wo8, so = quantize_weight(r(c, c, scale=c ** -0.5))
    args = (r(b, s, c), r(b, sk + sk_ip, dc), 1 + r(c, scale=0.1), r(c, scale=0.1), wq8, sq,
            r(c, dc, scale=dc ** -0.5), r(c, dc, scale=dc ** -0.5), wo8, so, r(c, scale=0.1), heads)
    kw = dict(num_ip_tokens=sk)
    if sk_ip:
        kw.update(wk_ip=r(c, dc, scale=dc ** -0.5), wv_ip=r(c, dc, scale=dc ** -0.5), ip_scale=0.55)
    if biased:
        bias = torch.zeros(b, sk, device=device)
        bias[0, sk // 3:] = -10000.0          # padded T5 positions
        kw["bias"] = bias
    return args, kw


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,c,heads", [(2, 1000, 256, 8), (2, 252, 384, 8), (2, 64, 640, 8), (1, 37, 128, 4),
                                         (3, 17, 384, 8), (1, 63, 640, 8)])
def test_k11a_k11c_match_plain(cuda_device, b, s, c, heads):
    """K11a (the int8 GEGLU GEMM with an fp32 store, quantize, the W2 GEMM)
    and K11c (the context K/V GEMM through 3-D tensor maps, the int8 q GEMM,
    the two-key-set attention with an fp32 store, the int8 out GEMM) at head
    dims 32, 48 and 80: the three UNet levels and ragged M; K11c at an
    adapter site (8 + 128 rows of 768) and a T5 site (64 rows of 1024 with
    its bias). One launch a call."""

    x, ops = _k11a_operands(cuda_device, b, s, c, 21)
    before = dict(cuda_kernels.LAUNCHES)
    _check(fused_ln_geglu_ff_int8(x, *ops), fused_ln_geglu_ff_int8_plain(x, *ops))
    for seed, keys in ((22, (8, 128, 768, False)), (23, (64, 0, 1024, True))):
        args, kw = _k11c_operands(cuda_device, b, s, c, heads, *keys, seed)
        _check(fused_ln_cross_attention_int8(*args, **kw), fused_ln_cross_attention_int8_plain(*args, **kw))
    moved = {k: cuda_kernels.LAUNCHES[k] - before[k] for k in before}
    assert moved == {**dict.fromkeys(before, 0), "fused_ln_geglu_ff_int8": 1, "fused_ln_cross_attention_int8": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("s,c", [(1000, 256), (64, 640)])
@pytest.mark.parametrize("sk,sk_ip,dc,biased", [(8, 32, 768, False), (8, 128, 768, False), (8, 512, 768, False),
                                                (8, 128, 768, True), (64, 0, 1024, True), (77, 0, 1024, False),
                                                (8, 0, 768, False)])
def test_k11c_key_sets_match_plain(cuda_device, s, c, sk, sk_ip, dc, biased):
    """K11c with 32, 128 and 512 adapter keys (pool 4, 2 and 1), with and
    without an adapter, with and without the T5 bias: the context GEMM's
    pairs of 2 or 4 weight sets over row tiles of the longer set, and the
    attention's key tiles (16 for 8 text keys, 64 for the rest; 77 keys on
    the one-set 64-key path)."""

    args, kw = _k11c_operands(cuda_device, 2, s, c, 8, sk, sk_ip, dc, biased, 24)
    _check(fused_ln_cross_attention_int8(*args, **kw), fused_ln_cross_attention_int8_plain(*args, **kw))


@pytest.mark.gpu
def test_k11a_k11c_are_deterministic(cuda_device):
    """Two calls give the same bits: K11a at the 640 level (its W2 GEMM split
    8 ways, int32 partials) and K11c at the 1000 level (its context GEMM's
    12 k-blocks split 4 ways, fp32 partials in rank order)."""

    x, ops = _k11a_operands(cuda_device, 2, 64, 640, 25)
    args, kw = _k11c_operands(cuda_device, 2, 1000, 256, 8, 8, 128, 768, False, 26)
    for fn in (lambda: fused_ln_geglu_ff_int8(x, *ops), lambda: fused_ln_cross_attention_int8(*args, **kw)):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.gpu
def test_k11a_k11c_device_kernels_as_planned(cuda_device):
    """A K11a call runs four device kernels (the LN + quantize row pass, the
    int8 GEGLU GEMM, the quantization of its rows, the int8 W2 GEMM) and a
    K11c call six (the context K/V GEMM, the row pass, the int8 q GEMM, the
    two-key-set attention, the quantization, the int8 out GEMM), none of the
    first port's mma.sync GEMM, WMMA GEMM or streamed attention."""

    from torch.profiler import ProfilerActivity, profile

    x, ops = _k11a_operands(cuda_device, 2, 252, 384, 27)
    args, kw = _k11c_operands(cuda_device, 2, 252, 384, 8, 8, 128, 768, False, 28)
    cases = [(lambda: fused_ln_geglu_ff_int8(x, *ops),
              ["ln_quant_rows_kernel<false>", "i8gemm_kernel<64, 2>", "quant_rows_kernel", "i8gemm_kernel<64, 1>"]),
             (lambda: fused_ln_cross_attention_int8(*args, **kw),
              ["hgemm_kernel<64, 3, false>", "ln_quant_rows_kernel<false>", "i8gemm_kernel<64, 0>",
               "reg_attention_kernel<48, false, false, float>", "quant_rows_kernel", "i8gemm_kernel<64, 1>"])]
    for fn, want in cases:
        fn()
        torch.cuda.synchronize()
        for _ in range(4):                    # the tracer now and then hands back no device events
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
            names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            if names:
                break
        short = [m.group(1) if (m := re.search(r"::(\w+(?:<[^>]*>)?)\(", n)) else n for n in names]
        assert sorted(short) == sorted(want * 3), short


def _k7_k9_operands(device, b, s, c, seed):
    """x, g [b, s, c] and the LayerNorm, K1 (wq, wk, wv, wo) and K3 (w1, b1,
    w2 at inner = 4c) weights of the backward kernels."""

    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *shape, scale=1.0: _r(g, device, *shape, scale=scale)
    ln = (1 + r(c, scale=0.1), r(c, scale=0.1))
    return (r(b, s, c), r(b, s, c), ln, tuple(r(c, c, scale=c ** -0.5) for _ in range(4)),
            (r(8 * c, c, scale=c ** -0.5), r(8 * c, scale=0.1), r(c, 4 * c, scale=(4 * c) ** -0.5)))


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,c,heads", [(8, 1024, 256, 8), (8, 256, 384, 8), (8, 64, 640, 8), (2, 81, 256, 8),
                                         (1, 145, 384, 8), (3, 17, 640, 8), (2, 100, 256, 4), (1, 70, 128, 8)])
def test_k7_k9_match_plain(cuda_device, b, s, c, heads):
    """K7 (the MN-major GEMMs, the two-sweep dq kernel, the dkv kernel, the
    K = 3C gxn GEMM) and K9 (the three-product GEMM with the GEGLU backward
    epilogue, gy1 . W1 in fp32) against autograd over their plain versions:
    the three training levels at B = 8 (head dims 32, 48, 80), ragged S (a
    part-filled last query and key tile, 17 rows past 64, and a sequence
    shorter than one tile), and head dims 64 and 16. One launch a call."""

    x, gy, ln, (wq, wk, wv, wo), (w1, b1, w2) = _k7_k9_operands(cuda_device, b, s, c, 31)
    before = dict(cuda_kernels.LAUNCHES)
    _check(fused_ln_self_attention_bwd_dx(x, gy, *ln, wq, wk, wv, wo, heads),
           fused_ln_self_attention_bwd_dx_plain(x, gy, *ln, wq, wk, wv, wo, heads), GRAD_TOL)
    _check(fused_ln_geglu_ff_bwd_dx(x, gy, *ln, w1, b1, w2),
           fused_ln_geglu_ff_bwd_dx_plain(x, gy, *ln, w1, b1, w2), GRAD_TOL)
    moved = {k: cuda_kernels.LAUNCHES[k] - before[k] for k in before}
    assert moved == {**dict.fromkeys(before, 0), "fused_ln_self_attention_bwd_dx": 1, "fused_ln_geglu_ff_bwd_dx": 1}


@pytest.mark.gpu
def test_k4_k7_k8_k9_are_deterministic(cuda_device):
    """Two calls give the same bits: K7 and K9 at the 1024 level and at the
    640 level (K9's gxn GEMM split over a cluster, fp32 partials in rank
    order; K7's dq and dkv kernels with no atomics), and K4 and K8 at the
    384 level with 512 adapter keys (the context GEMM's partials in rank
    order, K8's two-set dq kernel and its fp32 adapter dkv kernel with no
    atomics)."""

    fns = []
    for s, c in ((1024, 256), (64, 640)):
        x, gy, ln, (wq, wk, wv, wo), (w1, b1, w2) = _k7_k9_operands(cuda_device, 8, s, c, 32)
        fns += [lambda x=x, gy=gy, ln=ln, w=(wq, wk, wv, wo): fused_ln_self_attention_bwd_dx(x, gy, *ln, *w, 8),
                lambda x=x, gy=gy, ln=ln, w=(w1, b1, w2): fused_ln_geglu_ff_bwd_dx(x, gy, *ln, *w)]
    g = torch.Generator(device=cuda_device).manual_seed(33)
    r = lambda *shape, scale=1.0: _r(g, cuda_device, *shape, scale=scale)
    x, gy, ln, (wq, wk, wv, wo), _ = _k7_k9_operands(cuda_device, 8, 256, 384, 34)
    ctx, bo = r(8, 8 + 512, 768), r(384, scale=0.1)
    wkc, wvc, wki, wvi = (r(384, 768, scale=768 ** -0.5) for _ in range(4))
    kw = dict(wk_ip=wki, wv_ip=wvi, ip_scale=1.0)
    fns += [lambda: fused_ln_cross_attention(x, ctx, *ln, wq, wkc, wvc, wo, bo, 8, **kw),
            lambda: torch.cat([t.flatten().float() for t in
                               fused_ln_cross_attention_bwd(x, gy, ctx, *ln, wq, wkc, wvc, wo, 8, **kw)])]
    for fn in fns:
        first, second = fn(), fn()
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.gpu
def test_k7_k9_device_kernels_as_planned(cuda_device):
    """A K7 call runs seven device kernels (the LayerNorm rows, the QKV GEMM,
    g . Wo on the MN-major GEMM, the dq and dkv kernels, the gxn GEMM in
    fp32, the LayerNorm backward) and a K9 call four (the LayerNorm rows,
    the three-product GEMM, the gxn GEMM, the LayerNorm backward), none of
    the first port's WMMA GEMM or streamed attention passes."""

    from torch.profiler import ProfilerActivity, profile

    x, gy, ln, (wq, wk, wv, wo), (w1, b1, w2) = _k7_k9_operands(cuda_device, 8, 256, 384, 35)
    p7, p9 = k7_plan(8, 256, 384, 8), k9_plan(8, 256, 384, 4 * 384)
    cases = [(lambda: fused_ln_self_attention_bwd_dx(x, gy, *ln, wq, wk, wv, wo, 8),
              ["ln_rows_kernel", f"hgemm_kernel<{p7.qkv.bn}, 0, false>", f"hgemm_kernel<{p7.gattn.bn}, 0, true>",
               "reg_attn_bwd_dq_kernel<48, false>", "reg_attn_bwd_dkv_kernel<48, __nv_bfloat16>",
               f"hgemm_kernel<{p7.gxn.bn}, 4, true>",
               "ln_bwd_kernel"]),
             (lambda: fused_ln_geglu_ff_bwd_dx(x, gy, *ln, w1, b1, w2),
              ["ln_rows_kernel", "hgemm_kernel<64, 5, false>", f"hgemm_kernel<{p9.gxn.bn}, 4, true>",
               "ln_bwd_kernel"])]
    for fn, want in cases:
        fn()
        torch.cuda.synchronize()
        for _ in range(4):                    # the tracer now and then hands back no device events
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
            names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            if names:
                break
        short = [m.group(1) if (m := re.search(r"::(\w+(?:<[^>]*>)?)\(", n)) else n for n in names]
        assert sorted(short) == sorted(want * 3), short


def _k4_k8_operands(device, b, s, c, heads, sk, sk_ip, dc, biased, seed):
    """K4's and K8's operands for x [b, s, c] against a context of sk text and
    sk_ip adapter rows of width dc: (x, g, context, ln_w, ln_b, wq, wk, wv,
    wo, bo) and the keyword arguments (the adapter's weights with ip_scale
    0.55 where sk_ip > 0; a T5 padding bias that masks most keys of the
    first batch entry where biased)."""

    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *shape, scale=1.0: _r(g, device, *shape, scale=scale)
    args = (r(b, s, c), r(b, s, c), r(b, sk + sk_ip, dc), 1 + r(c, scale=0.1), r(c, scale=0.1),
            r(c, c, scale=c ** -0.5), r(c, dc, scale=dc ** -0.5), r(c, dc, scale=dc ** -0.5),
            r(c, c, scale=c ** -0.5), r(c, scale=0.1))
    kw = dict(num_ip_tokens=sk)
    if sk_ip:
        kw.update(wk_ip=r(c, dc, scale=dc ** -0.5), wv_ip=r(c, dc, scale=dc ** -0.5), ip_scale=0.55)
    if biased:
        bias = torch.zeros(b, sk, device=device)
        bias[0, sk // 3:] = -10000.0          # padded T5 positions
        kw["bias"] = bias
    return args, kw


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,c,heads", [(8, 1024, 256, 8), (8, 256, 384, 8), (8, 64, 640, 8), (2, 81, 256, 4),
                                         (3, 145, 384, 8), (1, 17, 128, 8)])
@pytest.mark.parametrize("sk,sk_ip,dc,biased", [(8, 20, 768, False), (8, 128, 768, False), (8, 512, 768, False),
                                                (64, 0, 1024, True), (70, 0, 1024, True), (8, 0, 768, False)])
def test_k4_k8_match_plain(cuda_device, b, s, c, heads, sk, sk_ip, dc, biased):
    """K4 (the context K/V GEMM, then K2's chain) and K8 (the context K/V
    GEMM, LN rows, the Q GEMM, g . Wo, the two-set dq kernel, the adapter's
    dkv kernel, dq . Wq in fp32, the LayerNorm backward) against their plain
    versions and autograd over them: the training levels at B = 8 (head dims
    32, 48, 80), ragged S (a part-filled last query tile, a sequence shorter
    than one tile) and head dims 64 and 16; 20, 128 and 512 adapter keys,
    no adapter set, and T5 contexts of 64 and 70 keys (one and two key
    tiles) with padding rows masked by the bias. K8's dk_ip/dv_ip and the
    adapter weight gradients (``adapter_weight_grads``) are held
    too. One launch a call."""

    (x, gy, ctx, *w), kw = _k4_k8_operands(cuda_device, b, s, c, heads, sk, sk_ip, dc, biased, 36)
    before = dict(cuda_kernels.LAUNCHES)
    _check(fused_ln_cross_attention(x, ctx, *w, heads, **kw), fused_ln_cross_attention_plain(x, ctx, *w, heads, **kw))
    got = fused_ln_cross_attention_bwd(x, gy, ctx, *w[:6], heads, **kw)       # no bo
    want = fused_ln_cross_attention_bwd_plain(x, gy, ctx, *w[:6], heads, **kw)
    _check(got[0], want[0], GRAD_TOL)
    if sk_ip:
        for a, wnt in zip(got[1:], want[1:]):
            assert a.dtype == torch.float32
            _check(a, wnt, GRAD_TOL)
        for a, wnt in zip(adapter_weight_grads(*got[1:], ctx[:, sk:]), adapter_weight_grads(*want[1:], ctx[:, sk:])):
            _check(a, wnt, GRAD_TOL)
    else:
        assert got[1:] == (None, None) and want[1:] == (None, None)
    moved = {k: cuda_kernels.LAUNCHES[k] - before[k] for k in before}
    assert moved == {**dict.fromkeys(before, 0), "fused_ln_cross_attention": 1, "fused_ln_cross_attention_bwd": 1}


@pytest.mark.gpu
def test_k4_k8_device_kernels_as_planned(cuda_device):
    """A K4 call runs five device kernels (the context K/V GEMM, the
    LayerNorm rows, the Q GEMM, the two-key-set attention, the out GEMM) and
    a K8 call eight at an adapter site (the context K/V GEMM, the LayerNorm
    rows, the Q GEMM, g . Wo on the MN-major GEMM, the two-set dq kernel,
    the adapter's dkv kernel, dq . Wq in fp32, the LayerNorm backward) and
    seven at a T5 site (no dkv kernel); none of the first port's WMMA GEMM
    or streamed attention."""

    from torch.profiler import ProfilerActivity, profile

    cases = []
    for sk, sk_ip, dc, biased in ((8, 512, 768, False), (64, 0, 1024, True)):
        (x, gy, ctx, *w), kw = _k4_k8_operands(cuda_device, 8, 256, 384, 8, sk, sk_ip, dc, biased, 37)
        p4, p8 = k4_plan(8, 256, 384, 8, sk, sk_ip, dc), k8_plan(8, 256, 384, 8, sk, sk_ip, dc)
        bias = "true" if biased else "false"
        cases.append((lambda x=x, ctx=ctx, w=w, kw=kw: fused_ln_cross_attention(x, ctx, *w, 8, **kw),
                      [f"hgemm_kernel<{p4.kv.bn}, 3, false>", "ln_rows_kernel", f"hgemm_kernel<{p4.q.bn}, 0, false>",
                       f"reg_attention_kernel<48, {bias}, false>", f"hgemm_kernel<{p4.out.bn}, 1, false>"]))
        cases.append((lambda x=x, gy=gy, ctx=ctx, w=w, kw=kw: fused_ln_cross_attention_bwd(x, gy, ctx, *w[:6], 8, **kw),
                      [f"hgemm_kernel<{p8.kv.bn}, 3, false>", "ln_rows_kernel", f"hgemm_kernel<{p8.q.bn}, 0, false>",
                       f"hgemm_kernel<{p8.gattn.bn}, 0, true>", "reg_attn_bwd_dq_kernel<48, true>"]
                      + (["reg_attn_bwd_dkv_kernel<48, float>"] if sk_ip else [])
                      + [f"hgemm_kernel<{p8.gxn.bn}, 4, true>", "ln_bwd_kernel"]))
    for fn, want in cases:
        fn()
        torch.cuda.synchronize()
        for _ in range(4):                    # the tracer now and then hands back no device events
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
            names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            if names:
                break
        short = [m.group(1) if (m := re.search(r"::(\w+(?:<[^>]*>)?)\(", n)) else n for n in names]
        # the attention's store type (its fourth template argument) is spelled as the compiler names bf16
        short = [re.sub(r"^(reg_attention_kernel<\d+, \w+, \w+), [^>]*>$", r"\1>", n) for n in short]
        assert sorted(short) == sorted(want * 3), short
        assert not any(n.startswith(("gemm_kernel<", "attention_kernel<")) for n in short)



@pytest.mark.gpu
@pytest.mark.parametrize("s,c", [(1000, 256), (252, 384), (64, 640)])
@pytest.mark.parametrize("sk,dc,biased", [(8, 768, False), (64, 1024, True)])
def test_k4_at_the_edit_shapes(cuda_device, s, c, sk, dc, biased):
    """K4 where the ControlNet-branch request runs it: B = 2 at the three
    edit levels, no adapter set; the GPT-2 stream cut to its 8 text keys at
    768 wide, and the T5 stream's 64 keys at 1024 wide with the padding
    bias. One launch a call."""

    (x, _, ctx, *w), kw = _k4_k8_operands(cuda_device, 2, s, c, 8, sk, 0, dc, biased, 38)
    before = cuda_kernels.LAUNCHES["fused_ln_cross_attention"]
    _check(fused_ln_cross_attention(x, ctx, *w, 8, **kw), fused_ln_cross_attention_plain(x, ctx, *w, 8, **kw))
    assert cuda_kernels.LAUNCHES["fused_ln_cross_attention"] == before + 1


@pytest.mark.gpu
def test_v1_unet_step_matches_fp32(cuda_device):
    """One step of the full-width v1 UNet (class labels, double
    self-attention; 16x16 latent, B = 2) with the bf16 kernels on the card
    against the same weights in fp32 on the CPU (the plain path), within
    5e-2 of max|ref|: 32 K1 and 16 K3, nothing else."""

    import copy

    from ap_adapter_torch.configs import PipelineConfig
    from ap_adapter_torch.pipeline.audioldm_v1 import AudioLDMv1Pipeline

    unet = AudioLDMv1Pipeline.init_random(PipelineConfig(), 0, cuda_device, torch.bfloat16).modules.unet
    g = torch.Generator().manual_seed(2)
    lat = torch.randn(2, 16, 16, 8, generator=g)
    labels = torch.nn.functional.normalize(torch.randn(2, unet.config.class_embed_dim, generator=g), dim=-1)
    ts = torch.full((2,), 501.0)
    cuda_kernels.reset_launch_counts()
    with torch.no_grad():
        got = unet(lat.to(cuda_device), ts.to(cuda_device), class_labels=labels.to(cuda_device)).float().cpu()
        moved = {k: v for k, v in cuda_kernels.LAUNCHES.items() if v}
        want = copy.deepcopy(unet).to("cpu", torch.float32)(lat, ts, class_labels=labels)
    assert moved == {"fused_ln_self_attention": 32, "fused_ln_geglu_ff": 16}
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 5e-2 * want.abs().max().item()


@pytest.mark.gpu
def test_cn_request_launch_counts(cuda_device):
    """A ControlNet-branch request (full width, hoisting off, 2 CFG DDIM
    steps of a 10 s clip, batch 1): per UNet forward 192 K1, 128 K3 and 64 K4
    (no K2), one self-attention launch in the VAE decode; the same seed with
    another audio prompt gives a bit-equal waveform."""

    import dataclasses

    import numpy as np

    from ap_adapter_torch.configs import PipelineConfig
    from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline
    from ap_adapter_torch.pipeline.tokenize import make_text_batch

    base = PipelineConfig()
    config = base.replace(unet=dataclasses.replace(base.unet, cn_text_only=True), hoist_step_invariants=False)
    pipe = AudioLDM2Pipeline.from_random(config, 0, cuda_device, torch.bfloat16)
    text = make_text_batch(config, ["a recording of a violin solo"])
    wavs = []
    for audio_seed in (0, 1):
        fbank = np.random.default_rng(audio_seed).standard_normal((1, 1024, 128)).astype(np.float32)
        cuda_kernels.reset_launch_counts()
        wavs.append(pipe.generate(text, text, fbank, audio_length_in_s=10.0, num_inference_steps=2, seed=0))
        assert {k: v for k, v in cuda_kernels.LAUNCHES.items() if v} == {
            "fused_ln_self_attention": 384, "fused_ln_geglu_ff": 256, "fused_ln_cross_attention": 128,
            "self_attention": 1}
    assert wavs[0].shape == (1, 160000) and np.all(np.isfinite(wavs[0]))
    assert np.array_equal(wavs[0], wavs[1])


# -- the UNet's CUDA graph (models/unet.py::AudioLDM2UNet.forward) ------------

GRAPH_CASES = {"a2l-128": ("a2l", 128, 0.5), "a2l-32": ("a2l", 32, 0.55), "v1": ("v1", 0, 0.0)}


@pytest.fixture(scope="module")
def graph_unets():
    """Full-width bf16 UNets with N(0, 0.02) weights, built once: AudioLDM2's
    and v1's (class labels, double self-attention)."""

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    from ap_adapter_torch.configs import UNetConfig, audioldm_v1_unet_config
    from ap_adapter_torch.models.unet import AudioLDM2UNet
    from ap_adapter_torch.pipeline.pipeline import fill_random_

    unets = {}
    for name, config in (("a2l", UNetConfig()), ("v1", audioldm_v1_unet_config())):
        with torch.device("cuda", 0):
            unets[name] = fill_random_(AudioLDM2UNet(config).to(torch.bfloat16).eval(), 0)
    return unets


def _graph_step(unets, case, step, ip_scale=None):
    """(the UNet, its keyword inputs at denoise step ``step`` of 50) at a 10 s
    clip's shapes, CFG batch 2, as the pipelines pass them: the edit's
    hoisted K/V (8 + 128 or 8 + 32 adapter keys, 64 T5 keys with padding)
    and this step's temb rows, or v1's class labels."""

    import numpy as np

    from ap_adapter_torch.configs import SchedulerConfig
    from ap_adapter_torch.diffusion.ddim import inference_timesteps
    from ap_adapter_torch.models.hoist import precompute_cross_kv, precompute_temb_rows

    kind, n_ip, scale = GRAPH_CASES[case]
    unet, dev = unets[kind], torch.device("cuda", 0)
    ts = inference_timesteps(SchedulerConfig(), 50)
    g = torch.Generator(device=dev).manual_seed(step)
    kw = dict(sample=torch.randn(2, 250, 16, 8, generator=g, device=dev).to(torch.bfloat16),
              timesteps=torch.full((2,), float(ts[step]), device=dev),
              ip_scale=scale if ip_scale is None else ip_scale)
    with torch.no_grad():
        if kind == "v1":
            kw["class_labels"] = torch.nn.functional.normalize(torch.randn(2, 512, generator=g, device=dev), dim=-1)
            return unet, kw
        ehs0 = torch.randn(2, 8 + n_ip, 768, generator=torch.Generator(device=dev).manual_seed(n_ip),
                           device=dev).to(torch.bfloat16)
        ehs1 = torch.randn(2, 64, 1024, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
        mask = torch.ones(2, 64, dtype=torch.long, device=dev)
        mask[:, 9:] = 0
        rows = precompute_temb_rows(unet, np.asarray(ts))
        kw.update(encoder_hidden_states=ehs0, encoder_hidden_states_1=ehs1.to(torch.bfloat16),
                  encoder_attention_mask_1=mask, ctx_kv=precompute_cross_kv(unet, ehs0, ehs1, mask),
                  temb_rows={k: v[step] for k, v in rows.items()})
    return unet, kw


def _eager(unet, kw):
    """The same forward run eager, past the graph cache."""

    full = dict(encoder_hidden_states=None, encoder_hidden_states_1=None, encoder_attention_mask_1=None,
                class_labels=None, ctx_kv=None, temb_rows=None, ip_scale=0.0)
    return unet._forward(**{**full, **kw})


def _graph_outs(unet) -> list:
    from ap_adapter_torch.models.graphs import _Graph

    return [e.out for e in unet._graphs.values() if isinstance(e, _Graph)]


def _within_eager_spread(got, eager, eager_again):
    """Bit-equal to the eager forward, or no farther from it than a second
    eager forward is (kernels that sum across CTAs in no fixed order)."""

    spread = (eager_again.float() - eager.float()).abs().max().item()
    return torch.equal(got, eager) or (got.float() - eager.float()).abs().max().item() <= spread


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_unet_graph_replay_matches_eager(graph_unets, case):
    """A signature's first forward runs eager, the second captures and
    replays, the third replays: both replays match eager forwards of the
    same inputs; the tensor a replay returned is no graph buffer and stays
    as it was after a later replay (the output check's hooks keep it);
    LAUNCHES after the three forwards reads three eager forwards' launches."""

    unet, kw0 = _graph_step(graph_unets, case, 0)
    _, kw1 = _graph_step(graph_unets, case, 17)
    unet.drop_graphs()
    cuda_kernels.reset_launch_counts()
    with torch.no_grad():
        eager0 = unet(**kw0)
        once = {k: v for k, v in cuda_kernels.LAUNCHES.items() if v}
        captured = unet(**kw0)
        assert cuda_kernels.LAUNCHES == {k: 2 * once.get(k, 0) for k in cuda_kernels.LAUNCHES}
        kept = captured.clone()
        replayed = unet(**kw1)
        assert cuda_kernels.LAUNCHES == {k: 3 * once.get(k, 0) for k in cuda_kernels.LAUNCHES}
        assert cuda_kernels.UNET_FORWARDS == {"captured": 1, "replayed": 1, "eager": 1}
        eager0_again, eager1, eager1_again = _eager(unet, kw0), _eager(unet, kw1), _eager(unet, kw1)
    torch.cuda.synchronize()
    assert once and torch.isfinite(eager0).all()
    assert _within_eager_spread(captured, eager0, eager0_again)
    assert _within_eager_spread(replayed, eager1, eager1_again)
    assert torch.equal(captured, kept) and not torch.equal(captured, replayed)
    outs = _graph_outs(unet)
    assert len(outs) == 1 and all(t.data_ptr() != outs[0].data_ptr() for t in (captured, replayed))
    unet.drop_graphs()


@pytest.mark.gpu
def test_unet_graph_new_ip_scale_captures_a_second_graph(graph_unets):
    """``ip_scale`` is baked into the kernels' arguments at capture: a new
    one is a new signature (eager once, then its own graph), and the first
    graph still replays its own scale."""

    unet, kw = _graph_step(graph_unets, "a2l-128", 3)
    _, kw55 = _graph_step(graph_unets, "a2l-128", 3, ip_scale=0.55)
    unet.drop_graphs()
    cuda_kernels.reset_launch_counts()
    with torch.no_grad():
        outs = [unet(**kw), unet(**kw), unet(**kw55), unet(**kw55), unet(**kw)]
        eager55_again = _eager(unet, kw55)
    torch.cuda.synchronize()
    assert cuda_kernels.UNET_FORWARDS == {"captured": 2, "replayed": 1, "eager": 2}
    assert len(_graph_outs(unet)) == 2
    assert _within_eager_spread(outs[3], outs[2], eager55_again)
    assert torch.equal(outs[4], outs[1]) and not torch.equal(outs[3], outs[1])
    unet.drop_graphs()


@pytest.mark.gpu
def test_unet_graph_follows_updated_and_reloaded_weights(graph_unets):
    """Weights changed in place (as the optimizer changes the adapter
    between validation rounds) are read at the next replay; a
    ``load_state_dict`` drops the graphs, so the next forward runs eager on
    the new weights and the one after captures them. conv_out's weight and
    bias times a power of two scale the output exactly."""

    unet, kw = _graph_step(graph_unets, "a2l-128", 5)
    conv = unet.conv_out
    w, b = conv.weight.detach().clone(), conv.bias.detach().clone()
    conv.bias.data.normal_(0.0, 0.02)
    unet.drop_graphs()
    cuda_kernels.reset_launch_counts()
    try:
        with torch.no_grad():
            base_eager, base = unet(**kw), unet(**kw)
            conv.weight.mul_(2)
            conv.bias.mul_(2)
            doubled = unet(**kw)
            assert cuda_kernels.UNET_FORWARDS == {"captured": 1, "replayed": 1, "eager": 1}
            sd = unet.state_dict()
            sd["conv_out.weight"], sd["conv_out.bias"] = conv.weight * 2, conv.bias * 2
            unet.load_state_dict(sd)
            assert not unet._graphs
            reloaded = [unet(**kw), unet(**kw)]
        torch.cuda.synchronize()
        assert cuda_kernels.UNET_FORWARDS == {"captured": 2, "replayed": 1, "eager": 2}
        assert torch.equal(doubled, 2 * base)
        assert torch.equal(reloaded[0], 4 * base_eager) and torch.equal(reloaded[1], 4 * base)
    finally:
        with torch.no_grad():
            conv.weight.copy_(w)
            conv.bias.copy_(b)
        unet.drop_graphs()
