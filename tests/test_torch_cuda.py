"""PyTorch port on the card: the hand-written CUDA kernels (K1-K3) against
their plain PyTorch versions, and a full-width UNet forward through them.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither jax nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py
"""

import pytest
import torch

from ap_adapter_torch.ops import cuda_kernels
from ap_adapter_torch.ops.fused_block import fused_ln_self_attention, fused_ln_self_attention_plain
from ap_adapter_torch.ops.fused_cross import fused_ln_cross_attention_kv, fused_ln_cross_attention_kv_plain
from ap_adapter_torch.ops.fused_ff import fused_ln_geglu_ff, fused_ln_geglu_ff_plain

# bf16 kernels vs their plain versions: bf16 rounds q, k, v and the
# probabilities at different points in the two, so the limit is a fraction
# of max|plain|
TOL = 2e-2


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _check(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL * want.float().abs().max().item(), err


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
    assert moved == {"fused_ln_self_attention": 1, "fused_ln_cross_attention_kv": 2, "fused_ln_geglu_ff": 1}


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
