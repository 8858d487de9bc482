"""PyTorch port: the kernel modules (K1-K3) and the plain ops, held against
the JAX package on the same numpy inputs (fp32, CPU).

The plain versions of K1/K2/K3 are checked against the JAX
``_xla_reference`` and against the Pallas kernels run with
``interpret=True``. The CUDA kernels themselves are checked against their
plain versions in ``test_torch_cuda.py`` (on the card only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ap_adapter_tpu.configs import SchedulerConfig as JaxSchedulerConfig
from ap_adapter_tpu.diffusion import ddim as jddim
from ap_adapter_tpu.models import hoist as jhoist
from ap_adapter_tpu.models import layers as jlayers
from ap_adapter_tpu.ops import attention as jattn
from ap_adapter_tpu.ops import pallas_fused_block as jk1
from ap_adapter_tpu.ops import pallas_fused_cross as jk2
from ap_adapter_tpu.ops import pallas_fused_ff as jk3
from ap_adapter_tpu.ops import pooling as jpool
from ap_adapter_torch.configs import SchedulerConfig
from ap_adapter_torch.diffusion import ddim
from ap_adapter_torch.models import layers
from ap_adapter_torch.ops import attention, cuda_kernels, pooling
from ap_adapter_torch.ops.fused_block import (
    fused_ln_self_attention, fused_ln_self_attention_bwd_dx, fused_ln_self_attention_plain)
from ap_adapter_torch.ops.fused_cross import (
    fused_ln_cross_attention, fused_ln_cross_attention_bwd, fused_ln_cross_attention_kv,
    fused_ln_cross_attention_kv_plain)
from ap_adapter_torch.ops.fused_ff import fused_ln_geglu_ff, fused_ln_geglu_ff_bwd_dx, fused_ln_geglu_ff_plain
from tests.torch_port_common import close, one_torch_thread  # noqa: F401 (autouse fixture)


def _mk(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _block_inputs(rng, b, s, c):
    x = _mk(rng, b, s, c)
    ln_s, ln_b = 1.0 + _mk(rng, c, scale=0.1), _mk(rng, c, scale=0.1)
    ws = [_mk(rng, c, c, scale=c ** -0.5) for _ in range(4)]   # JAX layout [in, out]
    bo = _mk(rng, c, scale=0.1)
    return x, ln_s, ln_b, ws, bo


# -- K1 -------------------------------------------------------------------


@pytest.mark.parametrize("b,s,c,heads", [
    (2, 40, 256, 8),    # d=32, S not a multiple of the 32-row query tile
    (1, 24, 384, 8),    # d=48: padded to 64 heads on the JAX side
])
def test_k1_plain_matches_jax(rng, b, s, c, heads):
    x, ln_s, ln_b, ws, bo = _block_inputs(rng, b, s, c)
    jargs = [jnp.asarray(a) for a in (x, ln_s, ln_b, *ws, bo)]
    want_ref = np.asarray(jk1._xla_reference(*jargs, heads, 1e-5))
    want_pallas = np.asarray(jk1.fused_ln_self_attention(*jargs, heads, eps=1e-5, tile_q=32,
                                                         interpret=True))
    got = fused_ln_self_attention_plain(_t(x), _t(ln_s), _t(ln_b), *(_t(w.T) for w in ws),
                                        _t(bo), heads, 1e-5)
    close(got, want_ref)
    close(got, want_pallas)


# -- K2 -------------------------------------------------------------------


def _pad_kv(a, heads, d, skp):
    """[B, Sk, C] -> the JAX kernel's hoisted layout: head lanes and key rows padded."""

    d_p = jk1._pad_head_dim(d)
    a = jhoist._pad_heads(jnp.asarray(a), heads, d, d_p)
    return jnp.pad(a, ((0, 0), (0, skp - a.shape[1]), (0, 0)))


@pytest.mark.parametrize("b,s,c,heads,sk,sk_ip,with_bias", [
    (2, 40, 256, 8, 8, 20, False),    # GPT-2 + AudioMAE stream with the adapter, d=32
    (1, 24, 384, 8, 24, 0, True),     # T5 stream with its padding bias, d=48 padded
    (1, 40, 256, 8, 12, 0, False),    # no adapter, no bias
])
def test_k2_plain_matches_jax(rng, b, s, c, heads, sk, sk_ip, with_bias):
    d = c // heads
    x, ln_s, ln_b, (wq, wk, wv, wo), bo = _block_inputs(rng, b, s, c)
    dc = 48
    ctx = _mk(rng, b, sk + sk_ip, dc)
    wk, wv = _mk(rng, dc, c, scale=dc ** -0.5), _mk(rng, dc, c, scale=dc ** -0.5)
    wki, wvi = _mk(rng, dc, c, scale=dc ** -0.5), _mk(rng, dc, c, scale=dc ** -0.5)
    k, v = ctx[:, :sk] @ wk, ctx[:, :sk] @ wv
    ki = vi = None
    if sk_ip:
        ki, vi = ctx[:, sk:] @ wki, ctx[:, sk:] @ wvi
    bias = None
    if with_bias:
        bias = np.where(rng.random((b, sk)) < 0.3, -10000.0, 0.0).astype(np.float32)

    j = jnp.asarray
    want_ref = np.asarray(jk2._xla_reference(
        j(x), j(ctx), j(ln_s), j(ln_b), j(wq), j(wk), j(wv), j(wo), j(bo), heads,
        j(wki) if sk_ip else None, j(wvi) if sk_ip else None, 0.7, sk, None if bias is None else j(bias),
        1e-5))

    d_p = jk1._pad_head_dim(d)
    skp = jhoist.kv_row_pad(sk)
    bias_pre = None
    if bias is not None:
        bias_pre = jnp.pad(j(bias), ((0, 0), (0, skp - sk)))[:, None, :]
    want_pallas = np.asarray(jk2.fused_ln_cross_attention_kv(
        j(x), _pad_kv(k, heads, d, skp), _pad_kv(v, heads, d, skp), j(ln_s), j(ln_b),
        jk1._pad_heads_in(j(wq), heads, d, d_p), jk1._pad_heads_out(j(wo), heads, d, d_p), j(bo),
        heads, sk,
        ki=None if ki is None else _pad_kv(ki, heads, d, jhoist.kv_row_pad(sk_ip)),
        vi=None if vi is None else _pad_kv(vi, heads, d, jhoist.kv_row_pad(sk_ip)),
        sk_ip=sk_ip, ip_scale=0.7, bias_pre=bias_pre, tile_q=32, interpret=True))

    got = fused_ln_cross_attention_kv_plain(
        _t(x), _t(k), _t(v), _t(ln_s), _t(ln_b), _t(wq.T), _t(wo.T), _t(bo), heads,
        ki=None if ki is None else _t(ki), vi=None if vi is None else _t(vi), ip_scale=0.7,
        bias=None if bias is None else _t(bias))
    close(got, want_ref)
    close(got, want_pallas)


# -- K3 -------------------------------------------------------------------


@pytest.mark.parametrize("b,s,c", [(2, 40, 256), (1, 24, 384)])
def test_k3_plain_matches_jax(rng, b, s, c):
    inner = 4 * c
    x = _mk(rng, b, s, c)
    ln_s, ln_b = 1.0 + _mk(rng, c, scale=0.1), _mk(rng, c, scale=0.1)
    w1, b1 = _mk(rng, c, 2 * inner, scale=c ** -0.5), _mk(rng, 2 * inner, scale=0.1)
    w2, b2 = _mk(rng, inner, c, scale=inner ** -0.5), _mk(rng, c, scale=0.1)
    jargs = [jnp.asarray(a) for a in (x, ln_s, ln_b, w1, b1, w2, b2)]
    want_ref = np.asarray(jk3._xla_reference(*jargs, 1e-5))
    want_pallas = np.asarray(jk3.fused_ln_geglu_ff(*jargs, eps=1e-5, tile_q=32, interpret=True))
    got = fused_ln_geglu_ff_plain(_t(x), _t(ln_s), _t(ln_b), _t(w1.T), _t(b1), _t(w2.T), _t(b2))
    close(got, want_ref)
    # the Pallas body uses an A&S erf (error <= 1.5e-7) against the exact GELU here
    close(got, want_pallas)


def test_wrappers_take_the_plain_path_on_cpu(rng):
    """On CPU tensors each wrapper returns its plain version's result and
    launches nothing."""

    cuda_kernels.reset_launch_counts()
    b, s, c, heads = 1, 20, 64, 4
    x, ln_s, ln_b, ws, bo = _block_inputs(rng, b, s, c)
    x, ln_s, ln_b, bo = map(_t, (x, ln_s, ln_b, bo))
    ws = [_t(w.T) for w in ws]
    assert torch.equal(fused_ln_self_attention(x, ln_s, ln_b, *ws, bo, heads),
                       fused_ln_self_attention_plain(x, ln_s, ln_b, *ws, bo, heads))
    k, v = _t(_mk(rng, b, 5, c)), _t(_mk(rng, b, 5, c))
    assert torch.equal(fused_ln_cross_attention_kv(x, k, v, ln_s, ln_b, ws[0], ws[3], bo, heads),
                       fused_ln_cross_attention_kv_plain(x, k, v, ln_s, ln_b, ws[0], ws[3], bo, heads))
    w1, b1 = _t(_mk(rng, 8 * c, c, scale=0.1)), _t(_mk(rng, 8 * c))
    w2, b2 = _t(_mk(rng, c, 4 * c, scale=0.1)), _t(_mk(rng, c))
    assert torch.equal(fused_ln_geglu_ff(x, ln_s, ln_b, w1, b1, w2, b2),
                       fused_ln_geglu_ff_plain(x, ln_s, ln_b, w1, b1, w2, b2))
    assert set(cuda_kernels.LAUNCHES.values()) == {0}


def test_wrappers_refuse_strided_operands_on_cpu(rng):
    """The CPU path holds callers to the kernels' contiguous layout, so a
    strided operand fails here and not first on the card."""

    b, s, c, heads = 2, 6, 64, 4
    x, ln_s, ln_b, ws, bo = _block_inputs(rng, b, s, c)
    x_t = _t(x).transpose(0, 1)                     # [S, B, C] view, not contiguous
    ln_s, ln_b, bo = map(_t, (ln_s, ln_b, bo))
    ws = [_t(w) for w in ws]
    with pytest.raises(ValueError, match="contiguous"):
        fused_ln_self_attention(x_t, ln_s, ln_b, *ws, bo, heads)
    k = _t(_mk(rng, 5, b, c)).transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        fused_ln_cross_attention_kv(_t(x), k, k, ln_s, ln_b, ws[0], ws[3], bo, heads)
    w1, b1 = _t(_mk(rng, 8 * c, c)), _t(_mk(rng, 8 * c))
    w2, b2 = _t(_mk(rng, 4 * c, c)).T, _t(_mk(rng, c))
    with pytest.raises(ValueError, match="contiguous"):
        fused_ln_geglu_ff(_t(x), ln_s, ln_b, w1, b1, w2, b2)


def test_raw_wrappers_refuse_operands_that_require_grad(rng):
    """The raw kernel wrappers (K1-K4, K7-K9) write into fresh buffers and
    record no autograd graph, so under grad mode an operand that requires
    grad raises, on the CPU path too; under no_grad the same calls run.
    Differentiable callers go through the ``*_vjp`` Functions."""

    b, s, c, heads, dc = 1, 6, 64, 4, 32
    x, ln_s, ln_b, ws, bo = _block_inputs(rng, b, s, c)
    x, ln_s, ln_b, bo = map(_t, (x, ln_s, ln_b, bo))
    wq, wk, wv, wo = (_t(w.T) for w in ws)
    g = _t(_mk(rng, b, s, c))
    k = _t(_mk(rng, b, 5, c))
    ctx = _t(_mk(rng, b, 8 + 4, dc))
    wkc, wvc, wki, wvi = (_t(_mk(rng, c, dc, scale=0.1)) for _ in range(4))
    w1, b1 = _t(_mk(rng, 8 * c, c, scale=0.1)), _t(_mk(rng, 8 * c))
    w2, b2 = _t(_mk(rng, c, 4 * c, scale=0.1)), _t(_mk(rng, c))
    wq.requires_grad_(True)       # a frozen weight asked for, in the attention ops
    wki.requires_grad_(True)      # the adapter, in the cross ops
    w1.requires_grad_(True)       # in the feed-forward ops
    calls = {
        "K1": lambda: fused_ln_self_attention(x, ln_s, ln_b, wq, wk, wv, wo, bo, heads),
        "K2": lambda: fused_ln_cross_attention_kv(x, k, k, ln_s, ln_b, wq, wo, bo, heads),
        "K3": lambda: fused_ln_geglu_ff(x, ln_s, ln_b, w1, b1, w2, b2),
        "K4": lambda: fused_ln_cross_attention(x, ctx, ln_s, ln_b, wq, wkc, wvc, wo, bo, heads,
                                               wk_ip=wki, wv_ip=wvi),
        "K7": lambda: fused_ln_self_attention_bwd_dx(x, g, ln_s, ln_b, wq, wk, wv, wo, heads),
        "K8": lambda: fused_ln_cross_attention_bwd(x, g, ctx, ln_s, ln_b, wq, wkc, wvc, wo, heads,
                                                   wk_ip=wki, wv_ip=wvi),
        "K9": lambda: fused_ln_geglu_ff_bwd_dx(x, g, ln_s, ln_b, w1, b1, w2),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="require grad"):
            call()
        with torch.no_grad():
            call()


# -- plain ops -------------------------------------------------------------


@pytest.mark.parametrize("with_mask", [False, True])
def test_sdpa_matches_jax(rng, with_mask):
    q, k, v = _mk(rng, 2, 7, 3, 16), _mk(rng, 2, 9, 3, 16), _mk(rng, 2, 9, 3, 16)
    mask = jm = None
    if with_mask:
        m = (rng.random((2, 9)) > 0.3).astype(np.int32)
        m[:, 0] = 1
        jm, mask = jattn.mask_to_bias(jnp.asarray(m), 7), attention.mask_to_bias(_t(m))
        close(mask, jm, atol=0)
    close(attention.sdpa(_t(q), _t(k), _t(v), mask), jattn.sdpa(*map(jnp.asarray, (q, k, v)), jm), atol=1e-6)


def test_dual_kv_attention_matches_jax(rng):
    q, kt, vt = _mk(rng, 1, 6, 2, 8), _mk(rng, 1, 4, 2, 8), _mk(rng, 1, 4, 2, 8)
    ki, vi = _mk(rng, 1, 5, 2, 8), _mk(rng, 1, 5, 2, 8)
    want = jattn.dual_kv_attention(*map(jnp.asarray, (q, kt, vt, ki, vi)), 0.6)
    close(attention.dual_kv_attention(*map(_t, (q, kt, vt, ki, vi)), 0.6), want, atol=1e-6)


@pytest.mark.parametrize("tp,fp", [(1, 1), (2, 2), (4, 2)])
def test_avg_max_pool_matches_jax(rng, tp, fp):
    tok = _mk(rng, 2, 8 * 4, 5)
    close(pooling.avg_max_pool_tokens(_t(tok), (8, 4), tp, fp),
          jpool.avg_max_pool_tokens(jnp.asarray(tok), (8, 4), tp, fp), atol=1e-6)


@pytest.mark.parametrize("dim,flip,shift", [(128, True, 0), (32, False, 1), (7, True, 0)])
def test_timestep_embedding_matches_jax(dim, flip, shift):
    ts = np.array([0.0, 1.0, 251.0, 999.0], np.float32)
    # fp32 sin/cos of arguments up to ~1e3 rad: the two libraries' range
    # reductions differ by ~1e3 * 6e-8
    close(layers.get_timestep_embedding(_t(ts), dim, flip, shift),
          jlayers.get_timestep_embedding(jnp.asarray(ts), dim, flip, shift), atol=1e-4)


def test_audiomae_pos_embed_matches_jax():
    np.testing.assert_array_equal(layers.audiomae_pos_embed(32, (2, 4)),
                                  jlayers.audiomae_pos_embed(32, (2, 4)))


@pytest.mark.parametrize("spacing,pred,steps", [
    ("leading", "epsilon", 50), ("trailing", "v_prediction", 20), ("leading", "sample", 7)])
def test_ddim_matches_jax(rng, spacing, pred, steps):
    cfg = SchedulerConfig(timestep_spacing=spacing, prediction_type=pred)
    jcfg = JaxSchedulerConfig(timestep_spacing=spacing, prediction_type=pred)
    ts = ddim.inference_timesteps(cfg, steps)
    np.testing.assert_array_equal(ts, jddim.inference_timesteps(jcfg, steps))
    tab, jtab = ddim.make_tables(cfg), jddim.make_tables(jcfg)
    np.testing.assert_array_equal(tab.alphas_cumprod, np.asarray(jtab.alphas_cumprod))
    ratio = 1000 // steps
    sample, out = _mk(rng, 1, 4, 2, 3), _mk(rng, 1, 4, 2, 3)
    for t in (int(ts[0]), int(ts[-1])):
        want = jddim.ddim_step(jtab, jnp.asarray(out), jnp.asarray(t), jnp.asarray(t - ratio),
                               jnp.asarray(sample))
        close(ddim.ddim_step(tab, _t(out), t, t - ratio, _t(sample)), want, atol=1e-5, rtol=1e-5)
