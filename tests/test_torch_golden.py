"""PyTorch port against the framework-free fixtures in ``tests/golden/``
(written from HF transformers models, torch replicas of the diffusers
modules and the reference's own attention processors by
``scripts/make_golden_fixtures.py``): an oracle independent of the JAX
package, so an error that JAX shares does not pass here.

Numpy and torch only; no JAX. Each fixture's ``param/`` tree goes through
``ap_adapter_torch/convert/from_jax.py`` into the port's module, which runs
on the CPU in fp32. Every check passes two bounds: the JAX test's own
``assert_allclose`` rtol/atol (``tests/test_golden_pipeline.py``), and a
max-abs error within 1e-4 of max|want| (1e-3 for gradients), which bounds
the port also where a fixture's values are below the atol.

Not here: ``mae_pretrain.npz`` (held in ``test_torch_mae_pretrain.py``),
``tiny_e2e.npz`` (the JAX package's own regression, with the JAX vocoder's
slope), and ``vocoder.npz`` and ``vggish.npz`` (held in
``test_torch_models.py`` and ``test_torch_eval.py``).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ap_adapter_torch import configs
from ap_adapter_torch.convert import from_jax
from ap_adapter_torch.diffusion import ddim
from ap_adapter_torch.models.audiomae import AudioMAECondition
from ap_adapter_torch.models.clap import ClapTextEncoder
from ap_adapter_torch.models.gpt2 import GPT2Model, generate_hidden_states
from ap_adapter_torch.models.projection import ProjectionModel
from ap_adapter_torch.models.t5 import T5Encoder
from ap_adapter_torch.models.unet import AudioLDM2UNet
from ap_adapter_torch.models.unet_blocks import CrossAttention, Transformer2DModel
from ap_adapter_torch.models.vae import AutoencoderKL
from ap_adapter_torch.ops.attention import strip_adapter_tokens

GOLDEN = Path(__file__).parent / "golden"
ENCODER_TOL = dict(rtol=1e-4, atol=1e-5)
BLOCK_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _listify(v):
    return tuple(_listify(x) for x in v) if isinstance(v, list) else v


def load(name):
    """(param tree as nested dicts of numpy, data with ``config``/``meta`` parsed)."""

    with np.load(GOLDEN / f"{name}.npz", allow_pickle=False) as z:
        tree: dict = {}
        for k in z.files:
            if k.startswith("param/"):
                node = tree
                *path, leaf = k.split("/")[1:]
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = z[k]
        data = {k: z[k] for k in z.files if not k.startswith("param/")}
    for key in ("config_json", "meta_json"):
        if key in data:
            data[key[:-5]] = {k: _listify(v) for k, v in json.loads(str(data.pop(key))).items()}
    return tree, data


def build(module, state_dict):
    module.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state_dict.items()}, strict=True)
    return module.eval()


def t(a):
    return torch.from_numpy(np.asarray(a))


def check(got, want, tol, rel=1e-4, what=""):
    """The JAX test's assert_allclose, and max|got - want| <= rel * max|want|."""

    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, err_msg=what, **tol)
    err, peak = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * peak, (what, err, peak)


@torch.no_grad()
def test_golden_unet_full():
    """The composed UNet (group routing, double self-attention, skips,
    odd-size upsampling, the T5 mask bias, two stacked layers) with the
    reference's own processors as the oracle."""

    tree, d = load("unet_full")
    cfg = configs.UNetConfig(**d["config"])
    unet = build(AudioLDM2UNet(cfg), from_jax.unet_state_dict(tree, cfg))
    out = unet(t(d["sample"].transpose(0, 2, 3, 1)), t(d["t"]), t(d["ehs0"]), t(d["ehs1"]), t(d["mask1"]),
               ip_scale=float(d["ip_scale"]))
    check(out.permute(0, 3, 1, 2), d["want"], dict(rtol=1e-4, atol=1e-4), what="unet_full")


def _t2d(tree, m):
    mod = Transformer2DModel(int(m["heads"]) * int(m["dim_head"]), int(m["heads"]), 1, int(m["cross_dim"]),
                             use_adapter=True, num_ip_tokens=int(m["num_tokens"]), groups=int(m["groups"]))
    return build(mod, from_jax.transformer2d_state_dict(tree, 1, has_adapter=True))


@torch.no_grad()
def test_golden_t2d_block():
    """One adapter-active UNet attention block (Transformer2DModel) against
    the reference's AttnProcessor2_0 + IPAttnProcessor2_0."""

    tree, d = load("t2d_block")
    m = d["meta"]
    out = _t2d(tree, m)(t(d["x"]), t(d["ctx"]), None, float(m["scale"]))
    check(out, d["want"], BLOCK_TOL, what="t2d_block")


def test_golden_t2d_block_adapter_grads():
    """d sum(out * g_cot) / d to_k_ip, to_v_ip (torch autograd through the
    reference's IPAttnProcessor2_0) against autograd over the port's block,
    whose cross site runs K4's and K8's plain versions on the CPU."""

    tree, d = load("t2d_block")
    m = d["meta"]
    mod = _t2d(tree, m)
    for p in mod.parameters():
        p.requires_grad_(False)
    proc = mod.transformer_blocks[0].attn2.processor
    proc.to_k_ip.weight.requires_grad_(True)
    proc.to_v_ip.weight.requires_grad_(True)
    out = mod(t(d["x"]), t(d["ctx"]), None, float(m["scale"]))
    (out * t(d["g_cot"])).sum().backward()
    check(proc.to_k_ip.weight.grad, d["want_gk"], GRAD_TOL, rel=1e-3, what="dW k_ip")
    check(proc.to_v_ip.weight.grad, d["want_gv"], GRAD_TOL, rel=1e-3, what="dW v_ip")


def test_golden_ddim():
    """diffusers DDIMScheduler: timestep spacings, the alpha tables, 50-step
    recursive chains for epsilon and v_prediction (with and without clip),
    add_noise and the velocity target."""

    _, d = load("ddim")
    for spacing, steps in [("leading", 50), ("leading", 4), ("trailing", 8)]:
        got = ddim.inference_timesteps(configs.SchedulerConfig(timestep_spacing=spacing), steps)
        np.testing.assert_array_equal(got, d[f"timesteps_{spacing}_{steps}"])
    tables = ddim.make_tables(configs.SchedulerConfig())
    check(tables.alphas_cumprod, d["alphas_cumprod"], dict(rtol=1e-6, atol=1e-7), what="alphas_cumprod")
    check(np.float32(tables.final_alpha_cumprod), d["final_alpha_cumprod"], dict(rtol=1e-6, atol=0),
          what="final_alpha_cumprod")

    ts = ddim.inference_timesteps(configs.SchedulerConfig(), 50)
    for pred in ("epsilon", "v_prediction"):
        for clip in (False, True):
            tables = ddim.make_tables(configs.SchedulerConfig(prediction_type=pred, clip_sample=clip))
            x = t(d["chain_x_init"])
            for i, step in enumerate(int(s) for s in ts):
                x = ddim.ddim_step(tables, t(d["chain_model_outputs"][i]), step, step - 1000 // 50, x)
            check(x, d[f"chain_final_{pred}_clip{int(clip)}"], dict(rtol=2e-4, atol=2e-4),
                  what=f"50-step {pred} clip={clip}")

    tables = ddim.make_tables(configs.SchedulerConfig())
    args = (t(d["an_x0"]), t(d["an_noise"]), t(d["an_timesteps"]))
    check(ddim.add_noise(tables, *args), d["want_noisy"], dict(rtol=1e-5, atol=1e-5), what="add_noise")
    check(ddim.velocity_target(tables, *args), d["want_velocity"], dict(rtol=1e-5, atol=1e-5), what="velocity")


@torch.no_grad()
def test_golden_vae_moments_and_decode():
    """diffusers AutoencoderKL: the encoder's moments and the decode."""

    tree, d = load("vae")
    cfg = configs.VAEConfig(**d["config"])
    vae = build(AutoencoderKL(cfg), from_jax.vae_state_dict(tree, cfg))
    mean, logvar = vae.moments(t(d["mel"])[..., None])
    check(mean.permute(0, 3, 1, 2), d["want_mean"], ENCODER_TOL, what="mean")
    check(logvar.permute(0, 3, 1, 2), d["want_logvar"], ENCODER_TOL, what="logvar")
    dec = vae.decode(t(d["z"].transpose(0, 2, 3, 1)))
    check(dec.permute(0, 3, 1, 2), d["want_dec"], dict(rtol=1e-4, atol=2e-5), what="decode")


@torch.no_grad()
def test_golden_clap_text():
    tree, d = load("clap_text")
    cfg = configs.ClapTextConfig(**d["config"])
    clap = build(ClapTextEncoder(cfg), from_jax.clap_text_state_dict(tree, cfg.num_layers))
    check(clap(t(d["ids"]), t(d["mask"])), d["want"], ENCODER_TOL, what="clap_text")


@torch.no_grad()
def test_golden_t5():
    tree, d = load("t5")
    cfg = configs.T5Config(**d["config"])
    t5 = build(T5Encoder(cfg), from_jax.t5_encoder_state_dict(tree, cfg.num_layers))
    check(t5(t(d["ids"]), t(d["mask"])), d["want"], ENCODER_TOL, what="t5")


@torch.no_grad()
def test_golden_gpt2_forward_and_generate():
    tree, d = load("gpt2")
    cfg = configs.GPT2Config(**d["config"])
    gpt2 = build(GPT2Model(cfg), from_jax.gpt2_state_dict(tree, cfg.n_layer))
    check(gpt2(t(d["embeds"]), t(d["mask"])), d["want_fwd"], ENCODER_TOL, what="forward")
    gen = generate_hidden_states(gpt2, t(d["embeds"]), t(d["gen_mask"]), int(d["gen_steps"]))
    check(gen, d["want_gen"], ENCODER_TOL, what="generate")


@torch.no_grad()
def test_golden_projection():
    """AudioLDM2ProjectionModel: per-stream linear, SOS/EOS, mask extension,
    [CLAP | T5] concatenation."""

    tree, d = load("projection")
    proj = build(ProjectionModel(configs.ProjectionConfig(**d["config"])), from_jax.projection_state_dict(tree))
    h, mask = proj(t(d["clap"]), t(d["t5"]), t(d["m0"]), t(d["m1"]))
    check(h, d["want_h"], ENCODER_TOL, what="hidden")
    np.testing.assert_array_equal(mask.numpy(), d["want_m"])


@torch.no_grad()
def test_golden_audiomae_encoder_and_pooling():
    """The reference's models_mae.py encoder (final-norm path and the
    contextual average) and the AudioMAE.py (avg + max) / 2 pooling at three
    pool sizes."""

    tree, d = load("audiomae")
    cfg = configs.AudioMAEConfig(**d["config"])
    cond = build(AudioMAECondition(cfg), from_jax.audiomae_condition_state_dict(tree, cfg.depth))
    fbank = t(d["fbank"])
    check(cond.model(fbank), d["want_tokens"], ENCODER_TOL, what="tokens")
    check(cond.model.contextual(fbank), d["want_ctx"], ENCODER_TOL, what="ctx")
    for tp, fp in ((1, 1), (2, 2), (4, 2)):
        check(cond(fbank, tp, fp), d[f"want_pool_{tp}x{fp}"], ENCODER_TOL, what=f"pool {tp}x{fp}")


@torch.no_grad()
@pytest.mark.parametrize("name", ["adapter_ip", "adapter_plain_masked", "adapter_cn"])
def test_golden_adapter_fixture(name):
    """The bare cross-attention (no preceding LayerNorm, no residual)
    against the reference's IPAttnProcessor2_0 (adapter live), its
    AttnProcessor2_0 with an additive mask, and its CNAttnProcessor2_0 (the
    trailing adapter tokens stripped)."""

    tree, d = load(name)
    m = d["meta"]
    adapter = bool(m.get("use_adapter"))
    mod = build(CrossAttention(m["query_dim"], m["heads"], m["dim_head"], m["cross_dim"], use_adapter=adapter,
                               num_ip_tokens=int(m.get("num_tokens", 8))),
                from_jax.attention_state_dict(tree, adapter))
    x, ctx = t(d["x"]), t(d["ctx"])
    if m["case"] == "ip":
        out = mod(x, None, ctx, ip_scale=m["scale"])
    elif m["case"] == "plain_masked":
        out = mod(x, None, ctx, t(d["bias"])[:, None])
    else:
        out = mod(x, None, strip_adapter_tokens(ctx, int(m["num_tokens"])))
    check(out, d["want"], BLOCK_TOL, what=name)
