"""PyTorch port: the adapter-training path held against the JAX package on
the same numpy inputs (fp32, CPU).

* the plain versions of K4, K7, K8 and K9 against the JAX ``_xla_reference``
  (and ``jax.vjp`` of it), and at one small shape each against the Pallas
  kernel run with ``interpret=True``;
* the VAE moments, the VAE mel and the AudioMAE fbank against JAX;
* the tiny-config training loss and every adapter gradient of one
  micro-batch against ``jax.grad`` of a loss assembled from the JAX
  package's own pieces, stored by ``scripts/make_torch_train_golden.py``
  (jax.grad of the tiny UNet takes over a minute to trace and compile here)
  with fingerprints of the weights and of the JAX sources that made it;
* one AdamW step with the clip against ``make_optimizer`` (optax), and the
  four learning-rate schedules;
* the flat adapter export/import, the collate, and ``train()`` with resume.

The CUDA kernels themselves are checked against these plain versions in
``test_torch_cuda.py`` and ``chip_smoke.py`` (on the card only)."""

import copy
import itertools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ap_adapter_tpu.adapter import params as jadapter
from ap_adapter_tpu.audio import dsp as jdsp
from ap_adapter_tpu.audio import fbank as jfbank
from ap_adapter_tpu.audio import mel as jmel
from ap_adapter_tpu.configs import FbankConfig as JaxFbankConfig
from ap_adapter_tpu.configs import MelConfig as JaxMelConfig
from ap_adapter_tpu.models.vae import AutoencoderKL as JaxVAE
from ap_adapter_tpu.ops import pallas_fused_block as jk1
from ap_adapter_tpu.ops import pallas_fused_cross as jk2
from ap_adapter_tpu.ops import pallas_fused_ff as jk3
from ap_adapter_tpu.train import trainer as jtrainer
from ap_adapter_torch.adapter import params as adapter_params
from ap_adapter_torch.audio import dsp, fbank, mel
from ap_adapter_torch.audio.io import save_wav
from ap_adapter_torch.configs import FbankConfig, MelConfig
from ap_adapter_torch.ops.fused_block import (
    fused_ln_self_attention_bwd_dx_plain, fused_ln_self_attention_plain, fused_ln_self_attention_vjp)
from ap_adapter_torch.ops.fused_cross import (
    fused_ln_cross_attention_bwd_plain, fused_ln_cross_attention_plain, fused_ln_cross_attention_vjp)
from ap_adapter_torch.ops.fused_ff import (
    fused_ln_geglu_ff_bwd_dx_plain, fused_ln_geglu_ff_plain, fused_ln_geglu_ff_vjp)
from ap_adapter_torch.train import trainer
from ap_adapter_torch.train.data import AudioSetDataset, DeviceCollate, data_loader
from ap_adapter_torch.train.loop import train
from ap_adapter_torch.utils.checkpoint import TrainCheckpointer, load_flat_adapter
from tests.torch_port_common import (  # noqa: F401 (one_torch_thread: autouse fixture)
    close, jax_tiny, one_torch_thread, port_tiny, stale_reference)

GOLDEN = Path(__file__).parent / "golden" / "torch_train_grads.npz"


def _mk(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _block(rng, b, s, c, dc=48):
    """x, output gradient, LN, the four [C, C] weights and bo (JAX layout
    [in, out]), and context weights [Dc, C]."""

    x, g = _mk(rng, b, s, c), _mk(rng, b, s, c)
    ln_s, ln_b = 1.0 + _mk(rng, c, scale=0.1), _mk(rng, c, scale=0.1)
    ws = [_mk(rng, c, c, scale=c ** -0.5) for _ in range(4)]
    bo = _mk(rng, c, scale=0.1)
    wctx = [_mk(rng, dc, c, scale=dc ** -0.5) for _ in range(4)]
    return x, g, ln_s, ln_b, ws, bo, wctx


# -- K4 and K8 -----------------------------------------------------------------


@pytest.mark.parametrize("adapter", [True, False])
def test_k4_k8_plain_match_jax(rng, adapter):
    """K4's plain version against the JAX ``_xla_reference``, and K8's plain
    (dx, dk_ip, dv_ip) against ``jax.vjp`` of it (dk_ip/dv_ip through the
    adapter weight gradients ``dkᵀ·ctx``): the GPT-2 + AudioMAE stream with
    the adapter, and the T5 stream with its padding bias (d=32)."""

    b, s, c, heads, dc = 2, 24, 256, 8, 48
    x, g, ln_s, ln_b, (wq, _, _, wo), bo, (wk, wv, wki, wvi) = _block(rng, b, s, c, dc)
    sk = 8 + 12 if adapter else 9
    ctx = _mk(rng, b, sk, dc)
    bias = None if adapter else np.where(rng.random((b, sk)) < 0.3, -10000.0, 0.0).astype(np.float32)
    j = jnp.asarray
    jip = (j(wki), j(wvi)) if adapter else (None, None)

    def ref(x_, wki_, wvi_):
        return jk2._xla_reference(x_, j(ctx), j(ln_s), j(ln_b), j(wq), j(wk), j(wv), j(wo), j(bo), heads,
                                  wki_, wvi_, 0.7, 8, None if bias is None else j(bias), 1e-5)

    def value_and_vjp(g_, x_, *w):
        out, vjp = jax.vjp(lambda *a: ref(*a, *(None, None)[len(w):]), x_, *w)
        return out, vjp(g_)

    want, jgrads = jax.jit(value_and_vjp)(j(g), j(x), *(jip if adapter else ()))
    kw = dict(wk_ip=_t(wki.T), wv_ip=_t(wvi.T), ip_scale=0.7) if adapter else dict(bias=_t(bias))
    args = (_t(ctx), _t(ln_s), _t(ln_b), _t(wq.T), _t(wk.T), _t(wv.T))
    close(fused_ln_cross_attention_plain(_t(x), *args, _t(wo.T), _t(bo), heads, **kw), want)
    dx, dki, dvi = fused_ln_cross_attention_bwd_plain(_t(x), _t(g), *args, _t(wo.T), heads, **kw)
    close(dx, jgrads[0])
    if adapter:
        ip = _t(ctx[:, 8:])
        # JAX grads are wrt [in, out] kernels: dW = ctx_ipᵀ·dk
        close(torch.einsum("bkd,bkc->dc", ip, dki), jgrads[1])
        close(torch.einsum("bkd,bkc->dc", ip, dvi), jgrads[2])
    else:
        assert dki is None and dvi is None


def test_k4_k8_plain_match_pallas_interpret(rng):
    """The same functions against the Pallas kernels in interpret mode (the
    adapter stream; K8's dk_ip/dv_ip per position)."""

    b, s, c, heads, dc = 1, 40, 256, 8, 48
    x, g, ln_s, ln_b, (wq, _, _, wo), bo, (wk, wv, wki, wvi) = _block(rng, b, s, c, dc)
    ctx = _mk(rng, b, 8 + 12, dc)
    jargs = [jnp.asarray(a) for a in (ctx, ln_s, ln_b, wq, wk, wv)]
    kw = dict(wk_ip=jnp.asarray(wki), wv_ip=jnp.asarray(wvi), ip_scale=0.7, num_ip_tokens=8, interpret=True)
    want = jax.jit(lambda *a: jk2.fused_ln_cross_attention(*a, heads, **kw))(
        jnp.asarray(x), *jargs, jnp.asarray(wo), jnp.asarray(bo))
    wdx, wdki, wdvi = jax.jit(lambda *a: jk2.fused_ln_cross_attention_bwd(*a, heads, **kw))(
        jnp.asarray(x), jnp.asarray(g), *jargs, jnp.asarray(wo))
    tkw = dict(wk_ip=_t(wki.T), wv_ip=_t(wvi.T), ip_scale=0.7)
    targs = (_t(ctx), _t(ln_s), _t(ln_b), _t(wq.T), _t(wk.T), _t(wv.T))
    close(fused_ln_cross_attention_plain(_t(x), *targs, _t(wo.T), _t(bo), heads, **tkw), want)
    for got, w in zip(fused_ln_cross_attention_bwd_plain(_t(x), _t(g), *targs, _t(wo.T), heads, **tkw),
                      (wdx, wdki, wdvi)):
        close(got, w)


# -- K7 and K9 -----------------------------------------------------------------


def test_k7_plain_matches_jax(rng):
    """dx of the self-attention block against ``jax.vjp`` of the JAX
    ``_xla_reference`` (d=32, and d=48 that the TPU pads) and the Pallas
    backward kernel in interpret mode (d=32)."""

    for b, s, c, pallas in ((1, 40, 256, True), (1, 24, 384, False)):
        x, g, ln_s, ln_b, ws, bo, _ = _block(rng, b, s, c)
        jw = [jnp.asarray(a) for a in (ln_s, ln_b, *ws)]
        dx_ref = jax.jit(lambda x_, g_, *w: jax.vjp(lambda xx: jk1._xla_reference(xx, *w, 8, 1e-5), x_)[1](g_)[0])
        got = fused_ln_self_attention_bwd_dx_plain(_t(x), _t(g), _t(ln_s), _t(ln_b), *(_t(w.T) for w in ws), 8)
        close(got, dx_ref(jnp.asarray(x), jnp.asarray(g), *jw, jnp.asarray(bo)))
        if pallas:
            close(got, jax.jit(lambda *a: jk1.fused_ln_self_attention_bwd_dx(*a, 8, tile_q=40, interpret=True))(
                jnp.asarray(x), jnp.asarray(g), *jw))


def test_k9_plain_matches_jax(rng):
    """dx of the GEGLU feed-forward against ``jax.vjp`` of the JAX
    ``_xla_reference`` and the Pallas backward kernel in interpret mode (its
    A&S erf is within 1.5e-7 of the exact one)."""

    b, s, c = 1, 40, 256
    inner = 4 * c
    x, g = _mk(rng, b, s, c), _mk(rng, b, s, c)
    ln_s, ln_b = 1.0 + _mk(rng, c, scale=0.1), _mk(rng, c, scale=0.1)
    w1, b1 = _mk(rng, c, 2 * inner, scale=c ** -0.5), _mk(rng, 2 * inner, scale=0.1)
    w2, b2 = _mk(rng, inner, c, scale=inner ** -0.5), _mk(rng, c, scale=0.1)
    jargs = [jnp.asarray(a) for a in (ln_s, ln_b, w1, b1, w2)]
    dx_ref = jax.jit(lambda x_, g_, *w: jax.vjp(lambda xx: jk3._xla_reference(xx, *w, 1e-5), x_)[1](g_)[0])
    got = fused_ln_geglu_ff_bwd_dx_plain(_t(x), _t(g), _t(ln_s), _t(ln_b), _t(w1.T), _t(b1), _t(w2.T))
    close(got, dx_ref(jnp.asarray(x), jnp.asarray(g), *jargs, jnp.asarray(b2)))
    close(got, jax.jit(lambda *a: jk3.fused_ln_geglu_ff_bwd_dx(*a, tile_q=40, interpret=True))(
        jnp.asarray(x), jnp.asarray(g), *jargs))


def test_autograd_functions_match_plain_autograd(rng):
    """K1 -> K4 -> K3 through their autograd Functions (CPU: the plain
    forwards, the plain K7/K8/K9, the plain recompute for other weights)
    give the gradients of autograd through the plain versions: dx, the fp32
    adapter weights, and a frozen weight asked for too (wq)."""

    b, s, c, heads, dc = 2, 12, 64, 4, 32
    x, _, ln_s, ln_b, ws, bo, (wk, wv, wki, wvi) = _block(rng, b, s, c, dc)
    w1, b1 = _t(_mk(rng, 8 * c, c, scale=c ** -0.5)), _t(_mk(rng, 8 * c, scale=0.1))
    w2, b2 = _t(_mk(rng, c, 4 * c, scale=(4 * c) ** -0.5)), _t(_mk(rng, c, scale=0.1))
    ctx = _t(_mk(rng, b, 8 + 6, dc))
    mask_bias = None

    def run(sa, ca, ff):
        leaves = [_t(x), _t(ws[0].T), _t(wki.T), _t(wvi.T)]
        for t in leaves:
            t.requires_grad_(True)
        xx, wq, ki, vi = leaves
        lw, lb = _t(ln_s), _t(ln_b)
        y = sa(xx, lw, lb, wq, _t(ws[1].T), _t(ws[2].T), _t(ws[3].T), _t(bo), heads)
        y = ca(y, ctx, lw, lb, wq, _t(wk.T), _t(wv.T), _t(ws[3].T), _t(bo), heads, wk_ip=ki, wv_ip=vi,
               ip_scale=1.0, bias=mask_bias)
        y = ff(y, lw, lb, w1, b1, w2, b2)
        return torch.autograd.grad(y.square().mean(), leaves)

    got = run(fused_ln_self_attention_vjp, fused_ln_cross_attention_vjp, fused_ln_geglu_ff_vjp)
    want = run(fused_ln_self_attention_plain, fused_ln_cross_attention_plain, fused_ln_geglu_ff_plain)
    for a, w in zip(got, want):
        close(a, w.numpy(), atol=1e-6)


# -- VAE encoder and the audio front end ---------------------------------------


def test_vae_moments_and_encode_match_jax(rng):
    """The VAE encoder, quant_conv and the logvar clip on the tiny weights."""

    jm, params = jax_tiny()
    x = _mk(rng, 2, 16, 64, 1) - 4.0
    wmean, wlogvar = jax.jit(lambda p, x_: jm.vae.apply({"params": p}, x_, method=JaxVAE.moments))(
        params["vae"], jnp.asarray(x))
    vae = port_tiny().vae
    with torch.no_grad():
        mean, logvar = vae.moments(_t(x))
        noise = _mk(rng, *mean.shape)
        z = vae.encode(_t(x), _t(noise))
    close(mean, wmean, atol=1e-5)
    close(logvar, wlogvar, atol=1e-5)
    close(z, (np.asarray(wmean) + np.exp(0.5 * np.asarray(wlogvar)) * noise) * vae.config.scaling_factor, atol=1e-5)


def test_audio_front_end_matches_jax(rng):
    """``wav_to_vae_mel`` (full MelConfig), ``audiomae_fbank`` (full and the
    tiny FbankConfig) and ``resample`` on the same waveforms. Log-spectra
    compare in absolute terms (fp32 FFTs of two libraries)."""

    wav = (0.3 * np.sin(np.arange(8000) * 0.05)[None] + 0.05 * _mk(rng, 2, 8000)).astype(np.float32)
    close(mel.wav_to_vae_mel(_t(wav), 48, MelConfig()),
          jmel.wav_to_vae_mel(jnp.asarray(wav), 48, JaxMelConfig()), atol=2e-3)
    for cfg, jcfg in ((FbankConfig(), JaxFbankConfig()),
                      (FbankConfig(target_frames=64, num_mel_bins=32), JaxFbankConfig(target_frames=64,
                                                                                      num_mel_bins=32))):
        close(fbank.audiomae_fbank(_t(wav), cfg), jfbank.audiomae_fbank(jnp.asarray(wav), jcfg), atol=2e-3)
    close(dsp.resample(_t(wav[:, :4410]), 44100, 16000),
          jax.jit(lambda w: jdsp.resample(w, 44100, 16000))(jnp.asarray(wav[:, :4410])), atol=1e-5)


# -- the loss and its adapter gradient ------------------------------------------


def test_loss_and_adapter_grads_match_jax():
    """One micro-batch at the tiny config: the port's loss and all 32
    adapter gradients against ``jax.grad`` of the JAX package's loss on the
    same weights, inputs, noise and timesteps (scripts/make_torch_train_golden.py).
    fp32 on both sides; the gradients are ~1e-4, so the check is absolute
    (2e-7) and relative to each gradient's peak (1e-3).

    The stored gradients stay the reference only while what made them holds:
    every UNet and VAE weight of ``jax_tiny()`` has the stored fingerprint,
    and the JAX package's sources and the loss assembled from them have the
    stored digest (a live jax.grad, or even the forward alone, costs more
    than this file's time budget here). On a mismatch, regenerate the file."""

    ref = np.load(GOLDEN)
    stale_reference(ref, jax_tiny()[1], ("unet", "vae"), "scripts/make_torch_train_golden.py")

    mods = port_tiny()
    unet = copy.deepcopy(mods.unet)
    adapter = trainer.split_unet_params(unet)
    l1 = sum(p.detach().double().abs().sum().item() for p in adapter.values())
    assert l1 == pytest.approx(float(ref["adapter_weights_l1"]), rel=1e-6)   # the same weights
    shim = type("Mods", (), {"config": mods.config, "dtype": torch.float32, "vae": mods.vae, "unet": unet})()
    batch = {k: _t(ref[f"in/{k}"]) for k in ("mel", "generated_prompt_embeds", "prompt_embeds", "attention_mask")}
    noise = {k: _t(ref[f"in/{k}"]) for k in ("vae_noise", "noise")}
    noise["timesteps"] = _t(ref["in/timesteps"]).long()
    loss = trainer.compute_loss(shim, trainer.TrainConfig(), batch, **noise)
    loss.backward()
    assert loss.item() == pytest.approx(float(ref["loss"]), rel=1e-5)
    assert set(adapter) == {k[len("grad/"):] for k in ref.files if k.startswith("grad/")}
    for k, p in adapter.items():
        want = ref[f"grad/{k}"]
        err = np.abs(p.grad.numpy() - want).max()
        assert err <= 2e-7 + 1e-3 * np.abs(want).max(), (k, err)


# -- optimizer ------------------------------------------------------------------


@pytest.mark.parametrize("sched", ["constant", "constant_with_warmup", "linear", "cosine"])
def test_lr_schedules_match_optax(sched):
    tc = trainer.TrainConfig(lr_scheduler=sched, lr_warmup_steps=3, max_train_steps=11, learning_rate=2e-4)
    jtc = jtrainer.TrainConfig(lr_scheduler=sched, lr_warmup_steps=3, max_train_steps=11, learning_rate=2e-4)
    ours, theirs = trainer.make_lr_schedule(tc), jtrainer.make_lr_schedule(jtc)
    for count in range(14):
        # optax evaluates its schedules in fp32
        assert ours(count) == pytest.approx(float(theirs(count)), rel=1e-5, abs=1e-12), count


def test_optimizer_step_matches_optax(rng):
    """AdamW after the global-norm clip, over four steps whose gradients
    are alternately below and above max_grad_norm, against the JAX
    package's optax chain (warmup schedule, weight decay on)."""

    kw = dict(learning_rate=1e-2, lr_scheduler="linear", lr_warmup_steps=2, max_train_steps=6,
              gradient_accumulation_steps=1, max_grad_norm=1.0)
    tc, jtc = trainer.TrainConfig(**kw), jtrainer.TrainConfig(**kw)
    init = {"a": _mk(rng, 4, 3), "b": _mk(rng, 5)}
    params = {k: torch.nn.Parameter(_t(v.copy())) for k, v in init.items()}
    opt = trainer.make_optimizer(tc, params.values())
    tx = jtrainer.make_optimizer(jtc)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    update = jax.jit(tx.update)
    for step, scale in enumerate((0.05, 3.0, 0.2, 10.0)):
        grads = {k: _mk(rng, *v.shape, scale=scale) for k, v in init.items()}
        for k, p in params.items():
            p.grad = _t(grads[k].copy())
        m = trainer.optimizer_step(tc, params, opt, step)
        assert m["grad_norm"].item() == pytest.approx(float(optax.global_norm(grads)), rel=1e-6)
        updates, state = update({k: jnp.asarray(v) for k, v in grads.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            close(p, jparams[k], atol=1e-6)


def test_train_step_raises_on_adapter_without_gradient(monkeypatch):
    """An adapter matrix the backward never reached stops the step: a zero
    gradient in its place would still move it by the weight decay."""

    reached, stray = torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(3))
    monkeypatch.setattr(trainer, "sample_noise", lambda modules, mb, generator: {})
    monkeypatch.setattr(trainer, "compute_loss", lambda modules, tc, mb: (reached * 2.0).sum())
    tc = trainer.TrainConfig()
    adapter = {"reached.weight": reached, "stray.weight": stray}
    opt = trainer.make_optimizer(tc, adapter.values())
    with pytest.raises(RuntimeError, match="stray.weight got no gradient"):
        trainer.train_step(None, tc, adapter, opt, 0, [{}, {}], torch.Generator())
    assert torch.equal(stray.detach(), torch.ones(3))


# -- adapter IO, data, the loop ---------------------------------------------------


def test_flat_adapter_export_import_roundtrip():
    """The port's flat adapter dict has the reference keys and values of
    the JAX export of the same weights; import restores it exactly, and the
    zero-delta init copies to_k/to_v as the JAX one does."""

    _, params = jax_tiny()
    cfg = port_tiny().config.unet
    want = jadapter.export_flat_adapter(params["unet"], cfg)
    unet = copy.deepcopy(port_tiny().unet)
    flat = adapter_params.export_flat_adapter(unet)
    assert list(flat) == list(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k])
    assert [s for _, _, s in jadapter.adapter_sites(cfg)] == adapter_params.adapter_sites(cfg)
    adapter_params.init_adapter_from_text_kv(unet)
    want_init = jadapter.export_flat_adapter(jadapter.init_adapter_from_text_kv(params["unet"], cfg), cfg)
    for k, v in adapter_params.export_flat_adapter(unet).items():
        np.testing.assert_array_equal(v, want_init[k])
    adapter_params.import_flat_adapter(unet, {k.replace(".processor.", "."): v for k, v in flat.items()})
    for k, v in adapter_params.export_flat_adapter(unet).items():
        np.testing.assert_array_equal(v, flat[k])


def test_collate_batches_on_cpu(tmp_path, rng):
    """AudioSetDataset + DeviceCollate + data_loader at the tiny config: the
    batch layout, and the CFG dropout and pooling draws of the seeded
    ``random.Random``."""

    import random

    mods = port_tiny()
    items = []
    for i in range(3):
        path = tmp_path / f"c{i}.wav"
        save_wav(str(path), 0.2 * _mk(rng, 4410), 22050)         # resampled to 16 kHz on load
        items.append({"wav": path.name, "labels": ["violin", "piano"]})
    (tmp_path / "m.json").write_text(json.dumps({"data": items}))
    ds = AudioSetDataset(str(tmp_path / "m.json"), str(tmp_path), duration_s=0.32, seed=3)
    caption, wav = ds[0]
    assert wav.shape == (5120,) and caption.endswith("violin, piano")
    collate = DeviceCollate(mods, duration_s=0.32, seed=7, pool_choices=(1, 2))
    replay = random.Random(7)
    batches = data_loader(ds, 2, collate, seed=0)
    for _ in range(2):
        batch = next(batches)
        pool = replay.choice((1, 2))
        [replay.random() for _ in range(2)]
        c = mods.config
        grid = c.audiomae.grid_size
        assert batch["mel"].shape == (2, 32, c.mel.num_mel_bins, 1)
        assert batch["generated_prompt_embeds"].shape == (
            2, c.gpt2.max_new_tokens + grid[0] * grid[1] // pool ** 2, c.unet.adapter_cross_attention_dim)
        assert batch["prompt_embeds"].shape[:2] == batch["attention_mask"].shape == (2, 64)
        assert all(torch.isfinite(v.float()).all() for v in batch.values())


def _tiny_batch(rng, mods):
    c = mods.config
    return {"mel": _t(_mk(rng, 2, 16, c.mel.num_mel_bins, 1) - 4.0),
            "generated_prompt_embeds": _t(_mk(rng, 2, 12, c.unet.adapter_cross_attention_dim)),
            "prompt_embeds": _t(_mk(rng, 2, 5, c.t5.d_model)),
            "attention_mask": torch.tensor([[1, 1, 1, 0, 0], [1] * 5])}


def test_train_two_steps_with_resume(tmp_path, rng):
    """``train()`` on the CPU: 2 optimizer steps of 2 micro-batches in one
    run, and the same as 1 step, a stop, and a resumed run to step 2, end
    on the same adapter; checkpoints rotate and the exported flat adapter
    is the trained one."""

    batch = _tiny_batch(rng, port_tiny())
    tc = trainer.TrainConfig(learning_rate=1e-3, gradient_accumulation_steps=2, checkpointing_steps=1,
                             max_train_steps=2)

    def run(out, max_steps):
        mods = copy.deepcopy(port_tiny())
        return mods, train(mods, itertools.repeat(batch), tc, str(out), max_steps=max_steps, log_every=1)

    mods_a, a = run(tmp_path / "a", 2)
    run(tmp_path / "b", 1)
    mods_b, b = run(tmp_path / "b", 2)
    assert a.step == b.step == 2 and [m["step"] for m in b.history] == [2]
    assert TrainCheckpointer(str(tmp_path / "b" / "checkpoints")).steps() == [1, 2]
    flat = load_flat_adapter(str(tmp_path / "b" / "pytorch_model.npz"))
    for k, p in a.adapter.items():
        assert p.dtype == torch.float32
        torch.testing.assert_close(b.adapter[k], p, rtol=0, atol=0)
        np.testing.assert_array_equal(flat[k], p.detach().numpy())
    assert not torch.equal(a.adapter[k], port_tiny().unet.get_submodule(k[: -len(".weight")]).weight)
    frozen_a = {n: p for n, p in mods_a.unet.named_parameters() if not p.requires_grad}
    for n, p in port_tiny().unet.named_parameters():
        if n in frozen_a:
            assert torch.equal(frozen_a[n], p), n
    lines = (tmp_path / "a" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["step"] for line in lines] == [1, 2]
