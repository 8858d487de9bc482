"""The training entry point's switches on the CPU at the tiny config: remat
(``UNetConfig.remat``, ``torch.utils.checkpoint`` over every resnet and
attention group), the AdamW with a bf16 first moment (``use_8bit_adam``),
its checkpoint round trip, and ``train()`` with validation rounds and the
tensorboard backend.

Oracles: the stored ``jax.grad`` of the JAX loss
(``tests/golden/torch_train_grads.npz``, written by
``scripts/make_torch_train_golden.py``), ``optax.adamw(mu_dtype=bfloat16)``
on seeded numpy gradients (optax alone, no model), and the port's own
non-remat / no-validation runs. No JAX model is built or traced here.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import json
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ap_adapter_torch.models import unet_blocks
from ap_adapter_torch.train import trainer
from ap_adapter_torch.train.loop import train
from ap_adapter_torch.train.validation import make_validation_fn
from ap_adapter_torch.utils.checkpoint import TrainCheckpointer
from tests.torch_port_common import jax_tiny, one_torch_thread, port_tiny, stale_reference  # noqa: F401

GOLDEN = Path(__file__).parent / "golden" / "torch_train_grads.npz"
KERNELS = {"fused_ln_self_attention_vjp": "self", "fused_ln_cross_attention_vjp": "cross",
           "fused_ln_geglu_ff_vjp": "ff"}


def _with_remat(unet, remat: bool):
    unet = copy.deepcopy(unet)
    unet.config = dataclasses.replace(unet.config, remat=remat)
    return unet


def _loss_and_grads(remat: bool, monkeypatch=None):
    """The golden micro-batch through ``compute_loss`` on a copy of the tiny
    UNet: (loss, {adapter key: grad}, calls of each fused op)."""

    ref = np.load(GOLDEN)
    mods = port_tiny()
    unet = _with_remat(mods.unet, remat)
    adapter = trainer.split_unet_params(unet)
    calls = dict.fromkeys(KERNELS.values(), 0)
    if monkeypatch is not None:
        for name, kind in KERNELS.items():
            fn = getattr(unet_blocks, name)

            def counted(*a, _fn=fn, _kind=kind, **k):
                calls[_kind] += 1
                return _fn(*a, **k)

            monkeypatch.setattr(unet_blocks, name, counted)
    shim = type("Mods", (), {"config": mods.config, "dtype": torch.float32, "vae": mods.vae, "unet": unet})()
    t = lambda k: torch.from_numpy(np.asarray(ref[f"in/{k}"]))  # noqa: E731
    batch = {k: t(k) for k in ("mel", "generated_prompt_embeds", "prompt_embeds", "attention_mask")}
    loss = trainer.compute_loss(shim, trainer.TrainConfig(), batch, vae_noise=t("vae_noise"), noise=t("noise"),
                                timesteps=t("timesteps").long())
    loss.backward()
    return loss.item(), {k: p.grad.clone() for k, p in adapter.items()}, calls


def _expected_calls(c, remat: bool) -> dict:
    """Fused-op calls of one forward and backward: each transformer block
    runs self-attention at attn1, self or cross at attn2 and the feed-forward;
    under remat, every attention group from the one holding the first
    adapter site on runs its forward again in the backward."""

    groups = (sum(c.down_block_has_attn) * c.layers_per_block + 1
              + sum(c.up_block_has_attn) * (c.layers_per_block + 1))
    group = []
    for dim in c.cross_attention_dims:
        group += ["self", "self" if dim is None else "adapter" if dim == c.adapter_cross_attention_dim
                  else "cross", "ff"] * c.transformer_layers_per_block
    order = group * groups
    recomputed = order[order.index("adapter") // len(group) * len(group):] if remat else []
    kinds = [("cross" if k == "adapter" else k) for k in order + recomputed]
    return {k: kinds.count(k) for k in ("self", "cross", "ff")}


def test_remat_matches_no_remat_and_golden(monkeypatch):
    """Remat changes no value: the loss and all adapter gradients equal the
    non-remat ones (1e-6 relative, fp32), the adapter gradients survive the
    checkpoint of the first adapter site's group (whose tensor inputs need
    no gradient), and both meet the stored JAX gradients at that fixture's
    tolerance. The fused ops run again exactly where the count from the
    config says."""

    ref = np.load(GOLDEN)
    stale_reference(ref, jax_tiny()[1], ("unet", "vae"), "scripts/make_torch_train_golden.py")
    with monkeypatch.context() as m:
        loss0, g0, calls0 = _loss_and_grads(False, m)
    with monkeypatch.context() as m:
        loss1, g1, calls1 = _loss_and_grads(True, m)
    c = port_tiny().config.unet
    assert calls0 == _expected_calls(c, False)
    assert calls1 == _expected_calls(c, True) and calls1["self"] > calls0["self"]
    assert loss1 == pytest.approx(loss0, rel=1e-6)
    for k in g0:
        assert torch.linalg.vector_norm(g1[k]) > 0, k
        err = (g1[k] - g0[k]).abs().max().item()
        assert err <= 1e-6 * g0[k].abs().max().item(), (k, err)
        want = ref[f"grad/{k}"]
        assert np.abs(g1[k].numpy() - want).max() <= 2e-7 + 1e-3 * np.abs(want).max(), k
    assert loss1 == pytest.approx(float(ref["loss"]), rel=1e-5)


def test_remat_skipped_without_grad(monkeypatch):
    """No gradient recorded, no checkpoint: the remat UNet's forward under
    ``no_grad`` calls ``torch.utils.checkpoint`` nowhere and equals the
    plain UNet's."""

    def refuse(*a, **k):
        raise AssertionError("checkpoint called under no_grad")

    mods = port_tiny()
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", refuse)
    g = torch.Generator().manual_seed(0)
    c = mods.config.unet
    args = (torch.randn(1, 8, 16, c.in_channels, generator=g), torch.tensor([10.0]),
            torch.randn(1, 12, c.adapter_cross_attention_dim, generator=g), torch.randn(1, 5, 48, generator=g))
    with torch.no_grad():
        got = _with_remat(mods.unet, True)(*args, ip_scale=0.5)
        want = mods.unet(*args, ip_scale=0.5)
    assert torch.equal(got, want)


# -- the AdamW with a bf16 first moment ----------------------------------------


def _adamw_runs(rng, steps: int = 5):
    """The port's BF16MomentAdamW and torch's AdamW beside optax's
    ``adamw(mu_dtype=bfloat16)``, on the same seeded gradients."""

    init = {"a": rng.standard_normal((64, 48)).astype(np.float32), "b": rng.standard_normal(33).astype(np.float32)}
    kw = dict(lr=1e-2, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2)
    ours = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in init.items()}
    fp32 = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in init.items()}
    opt, opt32 = trainer.BF16MomentAdamW(ours.values(), **kw), torch.optim.AdamW(fp32.values(), **kw)
    tx = optax.adamw(1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2, mu_dtype=jnp.bfloat16)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)

    @jax.jit
    def update(g, s, p):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    for scale in (0.05, 3.0, 0.2, 10.0, 0.5)[:steps]:
        grads = {k: (rng.standard_normal(v.shape) * scale).astype(np.float32) for k, v in init.items()}
        for params, o in ((ours, opt), (fp32, opt32)):
            for k, p in params.items():
                p.grad = torch.tensor(grads[k])
            o.step()
        jp, state = update({k: jnp.asarray(v) for k, v in grads.items()}, state, jp)
    return ours, opt, fp32, jp, state[0]


def test_bf16_moment_adamw_matches_optax():
    """Five steps against optax: the bf16 first moment equal (at most one bf16
    ulp apart), the fp32 second moment and the parameters within 1e-6 of
    max|optax|; and not the result of the fp32-moment AdamW."""

    ours, opt, fp32, jp, adam = _adamw_runs(np.random.default_rng(0))
    for k, p in ours.items():
        st = opt.state[p]
        assert st["exp_avg"].dtype == torch.bfloat16 and st["exp_avg_sq"].dtype == torch.float32
        mu, want_mu = st["exp_avg"].float().numpy(), np.asarray(adam.mu[k].astype(jnp.float32))
        ulp = np.abs(want_mu) * 2.0 ** -7
        assert np.all(np.abs(mu - want_mu) <= ulp), k
        want_nu = np.asarray(adam.nu[k])
        assert np.abs(st["exp_avg_sq"].numpy() - want_nu).max() <= 1e-6 * np.abs(want_nu).max(), k
        want = np.asarray(jp[k])
        assert np.abs(p.detach().numpy() - want).max() <= 1e-6 * np.abs(want).max(), k
        assert not torch.equal(p, fp32[k]), k


def test_bf16_moment_survives_checkpoint(tmp_path):
    """TrainCheckpointer round trip: the restored optimizer keeps the bf16
    first moment bit for bit, and its next step equals the uninterrupted
    optimizer's."""

    ours, opt, _, _, _ = _adamw_runs(np.random.default_rng(1), steps=3)
    ckpt = TrainCheckpointer(str(tmp_path))
    ckpt.save(3, {"step": 3, "optimizer": opt.state_dict(),
                  "adapter": {k: p.detach().clone() for k, p in ours.items()}})
    saved = ckpt.restore()
    params = {k: torch.nn.Parameter(v.clone()) for k, v in saved["adapter"].items()}
    opt2 = trainer.make_optimizer(trainer.TrainConfig(use_8bit_adam=True), params.values())
    opt2.load_state_dict(saved["optimizer"])
    for k in ours:
        a, b = opt.state[ours[k]], opt2.state[params[k]]
        assert b["exp_avg"].dtype == torch.bfloat16 and torch.equal(a["exp_avg"], b["exp_avg"])
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
    g = torch.Generator().manual_seed(2)
    for k in ours:
        ours[k].grad = torch.randn(ours[k].shape, generator=g)
        params[k].grad = ours[k].grad.clone()
    opt.step()
    opt2.step()
    for k in ours:
        assert torch.equal(ours[k], params[k]), k


# -- train() with validation and tensorboard ----------------------------------


def test_train_with_validation_and_tensorboard(tmp_path, monkeypatch):
    """Two optimizer steps with a validation round after each and the
    tensorboard backend: the same losses, gradient norms, learning rates and
    trained adapter, bit for bit, as a run with neither; the validation files
    of both rounds; the JSONL and the tensorboard scalars read back.

    tensorboard is told to use its bundled TensorFlow stub (the module
    ``tensorboard.compat.notf``) where TensorFlow is installed: importing
    TensorFlow takes about 15 s of a CPU, and the event files are the same."""

    monkeypatch.setitem(sys.modules, "tensorboard.compat.notf", types.ModuleType("tensorboard.compat.notf"))
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    mods0 = port_tiny()
    c = mods0.config
    rng = np.random.default_rng(0)
    batch = {"mel": torch.tensor(rng.standard_normal((2, 16, c.mel.num_mel_bins, 1)).astype(np.float32) - 4.0),
             "generated_prompt_embeds": torch.tensor(rng.standard_normal((2, 12, 32)).astype(np.float32)),
             "prompt_embeds": torch.tensor(rng.standard_normal((2, 5, 48)).astype(np.float32)),
             "attention_mask": torch.tensor([[1, 1, 1, 0, 0], [1] * 5])}
    clips = [(f"clip {i}", (0.1 * rng.standard_normal(3200)).astype(np.float32)) for i in range(3)]
    tc = trainer.TrainConfig(learning_rate=1e-3, gradient_accumulation_steps=2, max_train_steps=2,
                             validation_steps=1, use_8bit_adam=True)

    def run(out, validate: bool):
        mods = copy.deepcopy(mods0)
        fn = make_validation_fn(mods, clips, str(out), num_inference_steps=2, audio_length_in_s=0.2,
                                seed=5, num_files=2) if validate else None
        state = train(mods, itertools.repeat(batch), tc, str(out), log_every=1, validation_fn=fn,
                      report_to="tensorboard" if validate else "jsonl")
        return state

    a, b = run(tmp_path / "a", True), run(tmp_path / "b", False)
    keys = ("step", "loss", "grad_norm", "lr")
    assert [{k: m[k] for k in keys} for m in a.history] == [{k: m[k] for k in keys} for m in b.history]
    assert all("validation_seconds" in m for m in a.history)
    for k, p in a.adapter.items():
        assert torch.equal(p, b.adapter[k]), k
        assert a.optimizer.state[p]["exp_avg"].dtype == torch.bfloat16
    files = sorted(p.name for p in (tmp_path / "a" / "validation").iterdir())
    assert len(files) == 2 * 5 and sum(f.startswith("step1_") for f in files) == 5
    lines = [json.loads(x) for x in (tmp_path / "a" / "metrics.jsonl").read_text().splitlines()]
    assert [x["loss"] for x in lines] == [m["loss"] for m in a.history]
    acc = EventAccumulator(str(tmp_path / "a" / "tb"))
    acc.Reload()
    for key in ("loss", "grad_norm", "lr"):
        events = acc.Scalars(key)
        assert [e.step for e in events] == [1, 2]
        assert [e.value for e in events] == [float(np.float32(m[key])) for m in a.history]
    assert not (tmp_path / "b" / "tb").exists()
