"""PyTorch port: the class-embedding UNet and the AudioLDM v1 pipeline, and
the ControlNet-branch (``cn_text_only``) UNet, held against the JAX package
at the tiny config (fp32, CPU).

The JAX references are ``tests/golden/torch_v1.npz`` and
``tests/golden/torch_cn.npz``, written by ``scripts/make_torch_v1_golden.py``
(jitting the JAX tiny UNets and tracing the JAX generate take 8-15 s each on
a CPU, so the tests read the stored results): the JAX v1 UNet's and the JAX
cn UNet's outputs on stored inputs, and the JAX v1 generate's initial latents
and VAE-decoded mel (the vocoder's input), with the fingerprints of the
weights (``jax_v1_tiny()``'s, ``jax_tiny()``'s UNet without the adapter's)
and the JAX sources' digest, which each test checks first.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from ap_adapter_tpu.configs import tiny_pipeline_config as jax_tiny_config
from ap_adapter_tpu.convert import torch_import
from ap_adapter_torch.configs import tiny_pipeline_config
from ap_adapter_torch.convert import from_jax
from ap_adapter_torch.models.hoist import precompute_cross_kv, precompute_temb_rows
from ap_adapter_torch.models.unet import AudioLDM2UNet
from ap_adapter_torch.ops import cuda_kernels
from ap_adapter_torch.pipeline.audioldm_v1 import AudioLDMv1Pipeline, v1_unet_config
from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline, PipelineModules, TextBatch
from ap_adapter_torch.pipeline.tokenize import make_text_batch
from tests.torch_port_common import (  # noqa: F401 (autouse fixture)
    cn_unet_tree, jax_tiny, jax_v1_tiny, jax_v1_unet_config, one_torch_thread, stale_reference, vocoder_input,
    within)

GOLDEN = Path(__file__).parent / "golden"
SCRIPT = "scripts/make_torch_v1_golden.py"


def v1_golden():
    g = np.load(GOLDEN / "torch_v1.npz")
    stale_reference(g, jax_v1_tiny(), ("clap", "unet", "vae", "vocoder"), SCRIPT)
    return g


def cn_golden():
    g = np.load(GOLDEN / "torch_cn.npz")
    stale_reference(g, {"unet": cn_tree()}, ("unet",), SCRIPT)
    return g


def rel_close(got, want, rel=1e-4):
    """max|got - want| within ``rel`` of max|want|."""

    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.all(np.isfinite(got)), (got.shape, want.shape)
    err, peak = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * peak, (err, peak)


def cn_config():
    cfg = tiny_pipeline_config()
    return cfg.replace(unet=dataclasses.replace(cfg.unet, cn_text_only=True))


def cn_tree():
    return cn_unet_tree(jax_tiny()[1]["unet"])


def port_unet(config, tree):
    unet = AudioLDM2UNet(config)
    sd = from_jax.unet_state_dict(tree, config)
    unet.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return unet.eval()


def test_class_embedding_unet_matches_jax():
    """``audioldm_v1_unet_config(tiny)``: the class label through the
    "simple projection", concatenated onto the time embedding (every resnet's
    time_emb_proj reads both), double self-attention at every site; against
    the JAX ``AudioLDM2UNet.apply`` with ``class_labels``."""

    g = v1_golden()
    ucfg = v1_unet_config(tiny_pipeline_config())
    unet = port_unet(ucfg, jax_v1_tiny()["unet"])
    assert unet.down_blocks[0].resnets[0].time_emb_proj.in_features == 2 * ucfg.time_embed_dim
    with torch.no_grad():
        got = unet(torch.from_numpy(g["unet_x"]), torch.from_numpy(g["unet_t"]),
                   class_labels=torch.from_numpy(g["unet_labels"]))
    rel_close(got.numpy(), g["unet_want"])


def test_cn_unet_matches_jax_and_ignores_the_audio_tokens():
    """The ControlNet branch attends the leading ``adapter_num_tokens`` text
    tokens only (JAX tests/test_unet.py:270-307): the port against the JAX
    UNet on the same weights, and a bit-equal output when the trailing audio
    tokens change."""

    g = cn_golden()
    unet = port_unet(cn_config().unet, cn_tree())
    assert not [k for k in unet.state_dict() if "_ip" in k]

    def run(context):
        with torch.no_grad():
            return unet(*(torch.from_numpy(a) for a in (g["x"], g["t"], context, g["ehs1"], g["mask1"])),
                        ip_scale=float(g["ip_scale"]))

    got = run(g["ehs0"])
    rel_close(got.numpy(), g["want"])
    other = g["ehs0"].copy()
    other[:, 8:] = np.random.default_rng(7).standard_normal((2, other.shape[1] - 8, other.shape[2]))
    assert torch.equal(run(other), got)


def test_cn_refusals():
    """As in JAX: no hoisted K/V for a cn UNet (the rows would hold the
    stripped audio tokens), neither in ``precompute_cross_kv`` nor through a
    generate with ``hoist_step_invariants`` on; and a class-embedding UNet
    refuses class labels with hoisted temb rows."""

    cfg = cn_config()
    unet = port_unet(cfg.unet, cn_tree())
    with pytest.raises(ValueError, match="cn_text_only"):
        precompute_cross_kv(unet, torch.zeros(1, 12, 32), torch.zeros(1, 6, 48), None)
    pipe = AudioLDM2Pipeline(cfg, PipelineModules(cfg).init_random(0, "cpu"))
    pos = make_text_batch(cfg, ["a violin"], t5_len=8)
    with pytest.raises(ValueError, match="cn_text_only"):
        pipe.generate(pos, pos, np.zeros((1, 64, 32), np.float32), audio_length_in_s=0.05, num_inference_steps=1)

    ucfg = v1_unet_config(tiny_pipeline_config())
    v1 = port_unet(ucfg, jax_v1_tiny()["unet"])
    rows = {k: v[0] for k, v in precompute_temb_rows(
        AudioLDM2UNet(dataclasses.replace(ucfg, class_embed_dim=None)), np.array([1])).items()}
    with pytest.raises(ValueError, match="temb_rows"):
        v1(torch.zeros(1, 5, 16, 8), torch.ones(1), class_labels=torch.zeros(1, ucfg.class_embed_dim),
           temb_rows=rows)


def test_from_jax_round_trips_v1_and_cn():
    """``torch_import.unet_params`` gives the JAX trees back bit-exactly from
    the port's state dicts of the v1 and cn UNets; ``class_embedding``,
    which torch_import does not map, is checked directly."""

    from tests.test_torch_models import _tree_equal

    jc = jax_tiny_config()
    v1_tree = jax_v1_tiny()["unet"]
    v1_sd = from_jax.unet_state_dict(v1_tree, v1_unet_config(tiny_pipeline_config()))
    np.testing.assert_array_equal(v1_sd["class_embedding.weight"], v1_tree["class_embedding"]["kernel"].T)
    np.testing.assert_array_equal(v1_sd["class_embedding.bias"], v1_tree["class_embedding"]["bias"])
    back = torch_import.unet_params(v1_sd, jax_v1_unet_config(jc))
    _tree_equal(back, {k: v for k, v in v1_tree.items() if k != "class_embedding"})

    tree = cn_tree()
    sd = from_jax.unet_state_dict(tree, cn_config().unet)
    assert set(sd) == set(AudioLDM2UNet(cn_config().unet).state_dict())
    # the JAX cn UNet gives its groups no adapter dim (its unet.py:118)
    _tree_equal(torch_import.unet_params(sd, dataclasses.replace(jc.unet, adapter_cross_attention_dim=None)), tree)


def test_v1_generate_matches_jax_golden():
    """The whole v1 generate (CLAP class labels, [negative; positive], 4 CFG
    DDIM steps without hoisting, VAE decode) from the JAX draw of the initial
    latents: the mel that reaches the vocoder against JAX's."""

    g = v1_golden()
    params = jax_v1_tiny()
    cfg = tiny_pipeline_config()
    sds = {"clap": from_jax.clap_text_state_dict(params["clap"], cfg.clap.num_layers),
           "unet": from_jax.unet_state_dict(params["unet"], v1_unet_config(cfg)),
           "vae": from_jax.vae_state_dict(params["vae"], cfg.vae),
           "vocoder": from_jax.vocoder_state_dict(params["vocoder"], cfg.vocoder)}
    pipe = AudioLDMv1Pipeline.load_state_dicts(cfg, sds, device="cpu")
    no_t5 = np.zeros((2, 1), np.int32)      # the v1 pipeline reads only the CLAP ids
    pos = TextBatch(g["clap_ids"], g["clap_mask"], no_t5, no_t5)
    neg = TextBatch(g["neg_clap_ids"], g["neg_clap_mask"], no_t5, no_t5)
    cuda_kernels.reset_launch_counts()
    with vocoder_input(pipe.modules) as mels:
        wav = pipe.generate(pos, neg, audio_length_in_s=0.2, num_inference_steps=4, guidance_scale=2.5,
                            latents=torch.from_numpy(g["latents"]))
    assert len(mels) == 1 and set(cuda_kernels.LAUNCHES.values()) == {0}
    within(mels[0].numpy(), g["mel"], "mel")
    assert wav.shape == (2, 3200) and np.all(np.isfinite(wav))
