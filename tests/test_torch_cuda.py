"""PyTorch port on the card: the hand-written CUDA kernels (K1-K4, K7-K9,
K11a-c) against their plain PyTorch versions and autograd over them.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither jax nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py
"""

import pytest
import torch

from ap_adapter_torch.ops import cuda_kernels
from ap_adapter_torch.ops.fused_block import (
    fused_ln_self_attention, fused_ln_self_attention_bwd_dx, fused_ln_self_attention_bwd_dx_plain,
    fused_ln_self_attention_plain, fused_ln_self_attention_vjp)
from ap_adapter_torch.ops.fused_cross import (
    fused_ln_cross_attention, fused_ln_cross_attention_bwd, fused_ln_cross_attention_bwd_plain,
    fused_ln_cross_attention_kv, fused_ln_cross_attention_kv_plain, fused_ln_cross_attention_plain,
    fused_ln_cross_attention_vjp)
from ap_adapter_torch.ops.fused_ff import (
    fused_ln_geglu_ff, fused_ln_geglu_ff_bwd_dx, fused_ln_geglu_ff_bwd_dx_plain, fused_ln_geglu_ff_plain)
from ap_adapter_torch.ops.int8 import (
    fused_ln_cross_attention_int8, fused_ln_cross_attention_int8_plain, fused_ln_geglu_ff_int8,
    fused_ln_geglu_ff_int8_plain, fused_ln_self_attention_int8, fused_ln_self_attention_int8_plain,
    quantize_weight)

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

