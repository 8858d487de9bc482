"""PyTorch port: configs, tokenizer, the JAX->port converter, and every
conditioning encoder and decoder, held against the JAX package at the tiny
config on the same weights (fp32, CPU)."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ap_adapter_tpu import configs as jconfigs
from ap_adapter_tpu.convert import torch_import
from ap_adapter_tpu.models.gpt2 import generate_hidden_states as jax_generate_hidden_states
from ap_adapter_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from ap_adapter_tpu.pipeline import tokenize as jtokenize
from ap_adapter_torch import configs
from ap_adapter_torch.convert import from_jax
from ap_adapter_torch.models.gpt2 import generate_hidden_states
from ap_adapter_torch.pipeline import tokenize
from tests.torch_port_common import (  # noqa: F401 (autouse fixture)
    close, hf_vocoder, jax_tiny, one_torch_thread, port_tiny)

# UNet switches that exist only for the TPU build and are not ported
TPU_ONLY = {"use_weight_prep", "scan_unroll"}
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _same_config(port, ref, path="config"):
    if dataclasses.is_dataclass(ref):
        ref_fields = {f.name for f in dataclasses.fields(ref)} - TPU_ONLY
        assert {f.name for f in dataclasses.fields(port)} == ref_fields, path
        for name in ref_fields:
            _same_config(getattr(port, name), getattr(ref, name), f"{path}.{name}")
    elif path.endswith(".dtype"):
        assert port == DTYPES[ref], path
    else:
        assert port == ref, path


@pytest.mark.parametrize("which", ["default", "tiny"])
def test_configs_match_jax(which):
    if which == "default":
        _same_config(configs.PipelineConfig(), jconfigs.PipelineConfig())
    else:
        _same_config(configs.tiny_pipeline_config(), jconfigs.tiny_pipeline_config())
    for task in ("timbre_transfer", "style_transfer", "accompaniment_generation", "test"):
        _same_config(configs.get_task_config(task), jconfigs.get_task_config(task))


def test_hash_tokenizer_matches_jax():
    cfg, jcfg = configs.PipelineConfig(), jconfigs.PipelineConfig()
    prompts = ["a recording of a violin solo", "Jazz style music", ""]
    got = tokenize.make_text_batch(cfg, prompts, t5_len=16)
    want = jtokenize.make_text_batch(jcfg, prompts, t5_len=16)
    for name in ("clap_ids", "clap_mask", "t5_ids", "t5_mask"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)))
    assert got.clap_ids.shape == (3, cfg.clap.max_length)


def _tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _tree_equal(got[k], want[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


@pytest.mark.parametrize("name", ["clap", "t5", "gpt2", "projection", "audiomae", "unet", "vae", "vocoder"])
def test_from_jax_is_the_inverse_of_torch_import(name):
    """torch_import.*_params(the port's state dict as numpy) gives the JAX tree back exactly."""

    _, params = jax_tiny()
    jc = jconfigs.tiny_pipeline_config()
    sd = {k: v.numpy() for k, v in getattr(port_tiny(), name).state_dict().items()}
    if name == "vae":   # the port's VAE holds the encoder too: every converted key, none more
        assert set(sd) == set(from_jax.vae_state_dict(params["vae"], jc.vae))
    back = {
        "clap": lambda: torch_import.clap_text_params(sd, jc.clap.num_layers),
        "t5": lambda: torch_import.t5_encoder_params(sd, jc.t5.num_layers),
        "gpt2": lambda: torch_import.gpt2_params(sd, jc.gpt2.n_layer),
        "projection": lambda: torch_import.projection_params(sd),
        "audiomae": lambda: torch_import.audiomae_condition_params(sd, jc.audiomae.depth),
        "unet": lambda: torch_import.unet_params(sd, jc.unet),
        "vae": lambda: torch_import.vae_params(sd, jc.vae),
        "vocoder": lambda: torch_import.vocoder_params(sd, jc.vocoder),
    }[name]()
    _tree_equal(back, params[name])


@pytest.fixture
def text(rng):
    b = 2
    clap = rng.integers(3, 128, (b, 12))
    clap[1, 9:] = 1                       # padded (pad id 1)
    clap_mask = (clap != 1).astype(np.int32)
    t5 = rng.integers(3, 128, (b, 7))
    t5_mask = np.ones((b, 7), np.int32)
    t5_mask[0, 5:] = 0
    return clap.astype(np.int32), clap_mask, t5.astype(np.int32), t5_mask


def test_clap_matches_jax(text):
    jm, params = jax_tiny()
    ids, mask = text[0], text[1]
    want = jm.clap.apply({"params": params["clap"]}, jnp.asarray(ids), jnp.asarray(mask))
    close(port_tiny().clap(torch.from_numpy(ids).long(), torch.from_numpy(mask)), want, atol=1e-5)


def test_t5_matches_jax(text):
    jm, params = jax_tiny()
    ids, mask = text[2], text[3]
    want = jm.t5.apply({"params": params["t5"]}, jnp.asarray(ids), jnp.asarray(mask))
    close(port_tiny().t5(torch.from_numpy(ids).long(), torch.from_numpy(mask)), want, atol=1e-5)


def test_projection_matches_jax(rng, text):
    jm, params = jax_tiny()
    clap = rng.standard_normal((2, 1, 16)).astype(np.float32)
    t5 = rng.standard_normal((2, 7, 48)).astype(np.float32)
    cm, tm = np.ones((2, 1), np.int32), text[3]
    want_h, want_m = jm.projection.apply({"params": params["projection"]}, *map(jnp.asarray, (clap, t5, cm, tm)))
    got_h, got_m = port_tiny().projection(*map(torch.from_numpy, (clap, t5, cm, tm)))
    close(got_h, want_h, atol=1e-6)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


def test_gpt2_generation_matches_jax(rng):
    """Prefill + 7 decode forwards over the KV cache; the returned window is
    [prefill_last, decode_1..decode_7]."""

    jm, params = jax_tiny()
    embeds = rng.standard_normal((2, 9, 32)).astype(np.float32)
    mask = np.ones((2, 9), np.int32)
    mask[0, 4:6] = 0                      # T5 padding sits mid-sequence
    want = jax_generate_hidden_states(jm.gpt2, params["gpt2"], jnp.asarray(embeds), jnp.asarray(mask),
                                      max_new_tokens=8)
    got = generate_hidden_states(port_tiny().gpt2, torch.from_numpy(embeds), torch.from_numpy(mask), 8)
    assert got.shape == (2, 8, 32)
    close(got, want, atol=1e-5)


@pytest.mark.parametrize("tp,fp", [(2, 2), (1, 1)])
def test_audiomae_condition_matches_jax(rng, tp, fp):
    jm, params = jax_tiny()
    fbank = rng.standard_normal((2, 64, 32)).astype(np.float32)
    want = jm.audiomae.apply({"params": params["audiomae"]}, jnp.asarray(fbank), tp, fp)
    close(port_tiny().audiomae(torch.from_numpy(fbank), tp, fp), want, atol=1e-5)


def test_vae_decode_matches_jax(rng):
    jm, params = jax_tiny()
    z = rng.standard_normal((1, 5, 4, 8)).astype(np.float32)
    want = jm.vae.apply({"params": params["vae"]}, jnp.asarray(z), method=JaxAutoencoderKL.decode)
    got = port_tiny().vae.decode(torch.from_numpy(z))
    assert got.shape == (1, 20, 16, 1)
    close(got, want, atol=1e-5)


@pytest.mark.parametrize("oracle", ["live", "golden"])
def test_vocoder_matches_speecht5_hifigan(rng, oracle):
    """The port's HiFi-GAN against the reference model, transformers'
    ``SpeechT5HifiGan``, not against JAX (whose last LeakyReLU takes the
    config's slope where the reference takes 0.01). ``live``: the tiny
    vocoder at N(0, 0.3) weights, so that the tanh saturates, loaded into a
    live HF module; ``golden``: ``tests/golden/vocoder.npz`` (written from HF)
    through ``from_jax``. Each bound is absolute and relative to max|want|:
    the golden's max|want| is 8.1e-6, so an atol alone would guard nothing."""

    import json

    from flax.traverse_util import unflatten_dict

    from ap_adapter_torch.models.vocoder import HiFiGAN

    if oracle == "live":
        voc = HiFiGAN(configs.tiny_pipeline_config().vocoder).eval()
        with torch.no_grad():
            for p in voc.parameters():
                p.copy_(torch.from_numpy(rng.normal(0.0, 0.3, p.shape).astype(np.float32)))
        mel = rng.standard_normal((2, 6, 64)).astype(np.float32)
        with torch.no_grad():
            want = hf_vocoder(voc)(torch.from_numpy(mel)).numpy()
        assert np.abs(want).max() > 0.99          # saturated: the last slope decides the result
    else:
        with np.load(Path(__file__).parent / "golden" / "vocoder.npz") as f:
            cfg = configs.VocoderConfig(**{k: tuple(map(tuple, v)) if k == "resblock_dilation_sizes" else
                                           tuple(v) if isinstance(v, list) else v
                                           for k, v in json.loads(str(f["config_json"])).items()})
            tree = unflatten_dict({k[len("param/"):]: f[k] for k in f.files if k.startswith("param/")}, sep="/")
            mel, want = f["mel"], f["want"]
        voc = HiFiGAN(cfg).eval()
        sd = from_jax.vocoder_state_dict(tree, cfg)
        if not cfg.normalize_before:
            sd = {k: v for k, v in sd.items() if k not in ("mean", "scale")}
        voc.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.no_grad():
        got = voc(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, mel.shape[1] * voc.config.upsample_factor)
    err = np.abs(got - want).max()
    assert err <= 1e-6 and err <= 1e-6 * np.abs(want).max(), (err, np.abs(want).max())
