"""PyTorch port: the int8 (W8A8) serving configuration, ``UNetConfig.use_int8``.

The quantizers and the plain versions of K11a-c are held against the JAX
package (``ops/pallas_int8.py``, its Pallas kernels in interpret mode) on
the same numpy inputs; the tiny UNet and ``generate`` run the int8 route on
the CPU against the port's own float path. No JAX UNet or pipeline is
compiled here.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from ap_adapter_tpu.ops import pallas_int8 as jint8
from ap_adapter_torch.configs import tiny_pipeline_config
from ap_adapter_torch.models import hoist
from ap_adapter_torch.models.unet import AudioLDM2UNet, quantize_unet_int8_
from ap_adapter_torch.ops import cuda_kernels
from ap_adapter_torch.ops import int8 as port_int8
from ap_adapter_torch.pipeline import pipeline as port_pipeline
from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline, PipelineModules
from ap_adapter_torch.pipeline.tokenize import make_text_batch
from ap_adapter_torch.train.trainer import TrainConfig, compute_loss
from tests.torch_port_common import one_torch_thread  # noqa: F401 (autouse fixture)

# The plain versions quantize as the TPU kernels do, so they differ from them
# only where an fp32 rounding (sum order, erf) tips a value across an int8
# rounding boundary: ten times tighter than the 3% error class of
# tests/test_pallas_int8.py, so a different quantization would fail.
BRANCH_TOL = 3e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_quantizers_match_jax():
    """int8 values equal and scales equal in fp32, with an all-zero output
    channel and an all-zero row (the 1e-8 floor) and a row of exact halves
    (half to even)."""

    rng = np.random.default_rng(0)
    w = rng.standard_normal((96, 64)).astype(np.float32)   # JAX layout [in, out]
    w[:, 5] = 0.0
    w8, s = port_int8.quantize_weight(_t(w.T))               # port layout [out, in]
    jw8, js = jax.jit(jint8.quantize_weight)(w)
    np.testing.assert_array_equal(w8.numpy(), np.asarray(jw8).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js)[0])
    assert w8.dtype == torch.int8 and not w8[5].any()

    x = (rng.standard_normal((12, 80)) * 3).astype(np.float32)
    x[4] = 0.0
    x[7] = np.arange(80) % 9 * 2 + 1.0     # odd values, amax 17
    x[7, 0] = 254.0                         # amax 254: scale 2, odd values land on halves
    q, sx = port_int8.quant_rows(_t(x))
    jq, jsx = jax.jit(jint8._quant_rows)(x)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx)[:, 0])
    assert not q[4].any()


def test_quantize_attention_weights_match_jax_without_head_padding():
    """C=384, 8 heads: JAX pads d=48 to 64; its padded columns and rows are
    zeros and change no scale, so the port's unpadded int8 weights and scales
    equal JAX's with the padding removed."""

    c, heads = 384, 8
    rng = np.random.default_rng(1)
    wq, wk, wv, wo = (rng.standard_normal((c, c)).astype(np.float32) * c ** -0.5 for _ in range(4))
    jwq8, jsq, jwk, jwv, jwo8, jso = map(np.asarray, jax.jit(
        functools.partial(jint8.quantize_attention_weights, heads=heads))(wq, wk, wv, wo))
    keep = np.arange(jwq8.shape[1]) % 64 < 48
    assert jwq8.shape == (c, 512) and not jwq8[:, ~keep].any() and not jwo8[~keep].any()
    wq8, sq, pk, pv, wo8, so = port_int8.quantize_attention_weights(*(_t(a.T) for a in (wq, wk, wv, wo)))
    np.testing.assert_array_equal(wq8.numpy(), jwq8[:, keep].T)
    np.testing.assert_array_equal(sq.numpy(), jsq[0, keep])
    np.testing.assert_array_equal(wo8.numpy(), jwo8[keep].T)
    np.testing.assert_array_equal(so.numpy(), jso[0])
    np.testing.assert_array_equal(pk.numpy(), jwk[:, keep].T)
    np.testing.assert_array_equal(pv.numpy(), jwv[:, keep].T)


def _branch_err(got, want, x) -> float:
    got, want, x = (np.asarray(a, np.float64) for a in (got, want, x))
    return float(np.linalg.norm((got - x) - (want - x)) / np.linalg.norm(want - x))


def _block_inputs(rng, b, s, c):
    x = rng.standard_normal((b, s, c)).astype(np.float32)
    ln_w = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    ln_b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, ln_w, ln_b


def _lin(rng, fan_in, fan_out):
    """A JAX-layout [in, out] weight."""

    return (rng.standard_normal((fan_in, fan_out)) * fan_in ** -0.5).astype(np.float32)


def test_ff_int8_plain_matches_jax_kernel():
    rng = np.random.default_rng(2)
    b, s, c = 2, 64, 128
    x, ln_w, ln_b = _block_inputs(rng, b, s, c)
    w1, w2 = _lin(rng, c, 8 * c), _lin(rng, 4 * c, c)
    b1, b2 = (0.1 * rng.standard_normal(8 * c)).astype(np.float32), (0.1 * rng.standard_normal(c)).astype(np.float32)

    def jax_fn(x, ln_w, ln_b, w1, b1, w2, b2):
        w1q, s1 = jint8.quantize_weight(w1)
        w2q, s2 = jint8.quantize_weight(w2)
        return jint8.fused_ln_geglu_ff_int8(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, tile_q=64, interpret=True)

    want = np.asarray(jax.jit(jax_fn)(x, ln_w, ln_b, w1, b1, w2, b2))
    w1q, s1 = port_int8.quantize_weight(_t(w1.T))
    w2q, s2 = port_int8.quantize_weight(_t(w2.T))
    got = port_int8.fused_ln_geglu_ff_int8(_t(x), _t(ln_w), _t(ln_b), w1q, s1, _t(b1), w2q, s2, _t(b2))
    assert _branch_err(got.numpy(), want, x) <= BRANCH_TOL


@pytest.mark.parametrize("c,heads", [(128, 4), (384, 8)])
def test_self_attention_int8_plain_matches_jax_kernel(c, heads):
    """d = 32, and d = 48, which JAX pads to 64 and the port does not."""

    rng = np.random.default_rng(3)
    b, s = 2, 64
    x, ln_w, ln_b = _block_inputs(rng, b, s, c)
    wq, wk, wv, wo = (_lin(rng, c, c) for _ in range(4))
    bo = (0.1 * rng.standard_normal(c)).astype(np.float32)

    def jax_fn(x, ln_w, ln_b, wq, wk, wv, wo, bo):
        wq8, sq, wk_p, wv_p, wo8, so = jint8.quantize_attention_weights(wq, wk, wv, wo, heads)
        return jint8.fused_ln_self_attention_int8(x, ln_w, ln_b, wq8, sq, wk_p, wv_p, wo8, so, bo, heads,
                                                  tile_q=64, interpret=True)

    want = np.asarray(jax.jit(jax_fn)(x, ln_w, ln_b, wq, wk, wv, wo, bo))
    wq8, sq, pk, pv, wo8, so = port_int8.quantize_attention_weights(*(_t(a.T) for a in (wq, wk, wv, wo)))
    got = port_int8.fused_ln_self_attention_int8(_t(x), _t(ln_w), _t(ln_b), wq8, sq, pk, pv, wo8, so, _t(bo),
                                                 heads)
    assert _branch_err(got.numpy(), want, x) <= BRANCH_TOL


@pytest.mark.parametrize("kind", ["adapter", "t5+bias"])
def test_cross_attention_int8_plain_matches_jax_kernel(kind):
    """The adapter site (8 text + 16 adapter tokens, ip_scale 0.5) and a T5
    site without the adapter whose last keys are masked by the bias."""

    rng = np.random.default_rng(4)
    b, s, c, heads = 2, 64, 128, 4
    x, ln_w, ln_b = _block_inputs(rng, b, s, c)
    dc, sk = (64, 24) if kind == "adapter" else (96, 12)
    ctx = rng.standard_normal((b, sk, dc)).astype(np.float32)
    wq, wo = _lin(rng, c, c), _lin(rng, c, c)
    wk, wv, wki, wvi = (_lin(rng, dc, c) for _ in range(4))
    bo = (0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = None
    if kind == "t5+bias":
        bias = np.zeros((b, sk), np.float32)
        bias[0, 7:] = -10000.0
        bias[1, 10:] = -10000.0
    ad = kind == "adapter"

    def jax_fn(x, ctx, ln_w, ln_b, wq, wk, wv, wo, bo, wki, wvi, bias):
        wq8, sq, wk_p, wv_p, wo8, so = jint8.quantize_attention_weights(wq, wk, wv, wo, heads)
        return jint8.fused_ln_cross_attention_int8(
            x, ctx, ln_w, ln_b, wq8, sq, wk_p, wv_p, wo8, so, bo, heads, wk_ip=wki if ad else None,
            wv_ip=wvi if ad else None, ip_scale=0.5, num_ip_tokens=8, mask_bias=bias, tile_q=64, interpret=True)

    want = np.asarray(jax.jit(jax_fn)(x, ctx, ln_w, ln_b, wq, wk, wv, wo, bo, wki, wvi, bias))
    wq8, sq, pk, pv, wo8, so = port_int8.quantize_attention_weights(*(_t(a.T) for a in (wq, wk, wv, wo)))
    got = port_int8.fused_ln_cross_attention_int8(
        _t(x), _t(ctx), _t(ln_w), _t(ln_b), wq8, sq, pk, pv, wo8, so, _t(bo), heads,
        wk_ip=_t(wki.T) if ad else None, wv_ip=_t(wvi.T) if ad else None, ip_scale=0.5, num_ip_tokens=8,
        bias=None if bias is None else _t(bias))
    assert _branch_err(got.numpy(), want, x) <= BRANCH_TOL


@functools.lru_cache(maxsize=1)
def _tiny_modules() -> PipelineModules:
    """Tiny modules with seeded weights (no JAX init): the UNet's Linear
    weights at std 1/sqrt(fan_in) and its biases at std 0.1, so that every
    transformer branch carries signal through the int8 projections."""

    mods = PipelineModules(tiny_pipeline_config()).init_random(seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in mods.unet.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, m.in_features ** -0.5, generator=g)
                if m.bias is not None:
                    m.bias.normal_(0.0, 0.1, generator=g)
    return mods


def test_unet_int8_route_against_float(monkeypatch):
    """Every transformer site of the tiny UNet runs its int8 op (plain
    versions on the CPU, launch counters at 0) and the output stays within
    the int8 error class of the float UNet on the same weights. Bound: each
    int8 operand carries a rounding error of up to half a step, amax/254 per
    row or channel, so each quantized product is off by up to ~0.5% of its
    scale; the int8 branches add to a residual stream, and 2% of max|float|
    leaves room for those errors over the tiny UNet's 21 transformer sites
    while a wrong scale or a dropped branch would exceed it by far."""

    base = _tiny_modules()
    unet8 = AudioLDM2UNet(dataclasses.replace(base.unet.config, use_int8=True))
    unet8.load_state_dict(base.unet.state_dict())
    rng = np.random.default_rng(5)
    b = 2
    args = (_t(rng.standard_normal((b, 7, 4, 8)).astype(np.float32)), torch.tensor([501.0, 501.0]),
            _t(rng.standard_normal((b, 8 + 16, 32)).astype(np.float32)),
            _t(rng.standard_normal((b, 6, 48)).astype(np.float32)), torch.tensor([[1] * 6, [1] * 3 + [0] * 3]))
    with torch.no_grad(), pytest.raises(RuntimeError, match="without its int8 weights"):
        unet8(*args, ip_scale=0.5)
    quantize_unet_int8_(unet8)
    assert not any("int8" in k or "scale" in k for k in unet8.state_dict())

    calls = {}
    for name in ("fused_ln_geglu_ff_int8", "fused_ln_self_attention_int8", "fused_ln_cross_attention_int8"):
        plain = getattr(port_int8, f"{name}_plain")

        def counted(*a, _plain=plain, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _plain(*a, **kw)
        monkeypatch.setattr(port_int8, f"{name}_plain", counted)
    cuda_kernels.reset_launch_counts()
    with torch.no_grad():
        got = unet8(*args, ip_scale=0.5)
        want = base.unet(*args, ip_scale=0.5)
        kv = hoist.precompute_cross_kv(unet8, args[2], args[3], args[4])
        with pytest.raises(ValueError, match="no hoisted K/V"):
            unet8(*args, ip_scale=0.5, ctx_kv=kv)
    c = unet8.config
    groups = sum(c.down_block_has_attn) * c.layers_per_block + 1 + sum(c.up_block_has_attn) * (c.layers_per_block + 1)
    blocks = groups * c.transformer_layers_per_block
    n_cross = sum(d is not None for d in c.cross_attention_dims)
    n = len(c.cross_attention_dims)
    assert calls == {"fused_ln_geglu_ff_int8": blocks * n, "fused_ln_self_attention_int8": blocks * (2 * n - n_cross),
                     "fused_ln_cross_attention_int8": blocks * n_cross}
    assert set(cuda_kernels.LAUNCHES.values()) == {0}
    err = (got - want).abs().max().item()
    peak = want.abs().max().item()
    assert torch.isfinite(got).all() and 0 < err <= 2e-2 * peak, (err, peak)


def test_generate_int8_on_cpu_and_trainer_refuses_it(monkeypatch):
    """AudioLDM2Pipeline.generate with use_int8 quantizes once, takes no
    hoisted K/V, and gives a finite waveform of the right shape; the trainer
    refuses the configuration."""

    base = _tiny_modules()
    mods = PipelineModules(base.config.replace(unet=dataclasses.replace(base.config.unet, use_int8=True)))
    mods.load_state_dict(base.state_dict(), strict=True, assign=True)     # the same tensors, not copies
    monkeypatch.setattr(port_pipeline, "precompute_cross_kv",
                        lambda *a, **k: pytest.fail("the int8 path took hoisted K/V"))
    pipe = AudioLDM2Pipeline(mods.config, mods)
    assert mods.unet.mid_block.attentions[1].transformer_blocks[0].attn2.wq_int8.dtype == torch.int8
    cfg = pipe.config
    pos = make_text_batch(cfg, ["a recording of a violin solo"], t5_len=8)
    neg = make_text_batch(cfg, ["a recording of a piano solo"], t5_len=8)
    fbank = np.random.default_rng(6).standard_normal((1, 64, 32)).astype(np.float32)
    wav = pipe.generate(pos, neg, fbank, audio_length_in_s=0.2, num_inference_steps=2, guidance_scale=3.0,
                        time_pool=2, freq_pool=2, seed=0)
    assert wav.shape == (1, int(0.2 * cfg.vocoder.sampling_rate)) and np.all(np.isfinite(wav))

    batch = {"mel": torch.zeros(1, 16, 64, 1), "generated_prompt_embeds": torch.zeros(1, 8, 32),
             "prompt_embeds": torch.zeros(1, 4, 48)}
    noise = {"vae_noise": torch.zeros(1, 4, 16, 8), "noise": torch.zeros(1, 4, 16, 8),
             "timesteps": torch.tensor([10])}
    with pytest.raises(ValueError, match="use_int8"):
        compute_loss(mods, TrainConfig(), batch, **noise)
