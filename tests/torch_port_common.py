"""Shared set-up for the ``test_torch_*`` files: the JAX package's tiny
pipeline params (``PipelineModules(tiny_pipeline_config()).init_params(0)``)
and the same weights loaded into the PyTorch port through ``from_jax``.
Built once per process. The JAX init dominates the set-up time (about 15 s on
a CPU), so its result is also kept on disk under ``build/test_cache/``, keyed
by a digest of the JAX package's sources and the jax version, for the other
test processes of a run and for later runs."""

from __future__ import annotations

import contextlib
import functools
import hashlib
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ap_adapter_tpu.configs import tiny_pipeline_config as jax_tiny_config
from ap_adapter_tpu.pipeline.pipeline import PipelineModules as JaxModules
from ap_adapter_torch.configs import tiny_pipeline_config
from ap_adapter_torch.convert import from_jax
from ap_adapter_torch.pipeline.pipeline import PipelineModules

# fp32 on the CPU: the point is the algorithm, not the working type
ATOL = 1e-4



@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for each port test (imported into the test
    modules): the tiny models are launch-bound, and a pool contends with the
    other test workers. The old count is restored, so other tests in the
    same worker keep theirs."""

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CACHE_DIR = Path(__file__).resolve().parents[1] / "build" / "test_cache"


@functools.lru_cache(maxsize=1)
def jax_tiny():
    """(JAX PipelineModules, its params as numpy trees of dicts)."""

    from flax.traverse_util import flatten_dict, unflatten_dict

    mods = JaxModules(jax_tiny_config())
    path = CACHE_DIR / f"jax_tiny_params_{jax_source_digest()[:16]}_jax{jax.__version__}.npz"
    if path.exists():
        with np.load(path) as f:
            return mods, unflatten_dict({k: f[k] for k in f.files}, sep="/")
    params = jax.tree_util.tree_map(np.asarray, mods.init_params(0))
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp.npz")
    np.savez(tmp, **flatten_dict(params, sep="/"))
    os.replace(tmp, path)       # whole or absent: another process may read it at any time
    return mods, params


def jax_v1_unet_config(jax_config):
    """The JAX v1 UNet config that ``AudioLDMv1Pipeline.from_random`` builds
    from ``jax_config`` (its audioldm_v1.py:52-64)."""

    from ap_adapter_tpu.configs import UNetConfig as JaxUNetConfig
    from ap_adapter_tpu.pipeline.audioldm_v1 import audioldm_v1_unet_config

    u = jax_config.unet
    return audioldm_v1_unet_config(
        JaxUNetConfig(block_out_channels=u.block_out_channels, down_block_has_attn=u.down_block_has_attn,
                      up_block_has_attn=u.up_block_has_attn, layers_per_block=u.layers_per_block,
                      transformer_layers_per_block=1, num_attention_heads=u.num_attention_heads,
                      norm_num_groups=u.norm_num_groups),
        clap_dim=jax_config.clap.projection_dim)


@functools.lru_cache(maxsize=1)
def jax_v1_tiny() -> dict:
    """The JAX ``AudioLDMv1Pipeline.from_random(tiny_pipeline_config(), 0)``
    params as numpy trees of dicts ({clap, unet, vae, vocoder}), cached on
    disk as ``jax_tiny`` caches its own (the init takes about 7 s)."""

    from flax.traverse_util import flatten_dict, unflatten_dict

    from ap_adapter_tpu.pipeline.audioldm_v1 import AudioLDMv1Pipeline as JaxV1Pipeline

    path = CACHE_DIR / f"jax_v1_tiny_params_{jax_source_digest()[:16]}_jax{jax.__version__}.npz"
    if path.exists():
        with np.load(path) as f:
            return unflatten_dict({k: f[k] for k in f.files}, sep="/")
    params = jax.tree_util.tree_map(np.asarray, JaxV1Pipeline.from_random(jax_tiny_config(), seed=0).params)
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp.npz")
    np.savez(tmp, **flatten_dict(params, sep="/"))
    os.replace(tmp, path)
    return params


def cn_unet_tree(unet_tree) -> dict:
    """A JAX UNet tree without the adapter's weights: the tree of the same
    UNet under ``cn_text_only``."""

    if not isinstance(unet_tree, dict):
        return unet_tree
    return {k: cn_unet_tree(v) for k, v in unet_tree.items() if k not in ("to_k_ip", "to_v_ip")}


def stale_reference(stored, params, trees, script: str) -> None:
    """Fail as "stale reference" unless ``stored`` (an npz a script wrote)
    has the digest of the JAX sources and the fingerprints of ``params``'
    ``trees`` that this run has."""

    fp = param_fingerprints(params, trees)
    if (str(stored["jax_source_sha256"]) != jax_source_digest() or list(stored["fp_names"]) != list(fp["fp_names"])
            or not np.allclose(stored["fp_values"], fp["fp_values"], rtol=1e-9, atol=0)):
        pytest.fail(f"stale reference: rerun {script}")


@functools.lru_cache(maxsize=1)
def port_tiny() -> PipelineModules:
    """The port's tiny PipelineModules on the CPU with the JAX tiny weights."""

    cfg = tiny_pipeline_config()
    return PipelineModules(cfg).load_state_dicts(from_jax.pipeline_state_dicts(jax_tiny()[1], cfg),
                                                device="cpu")


def hf_vocoder(vocoder):
    """A live transformers ``SpeechT5HifiGan`` built from the port
    ``HiFiGAN``'s config, holding its weights: the reference model of the
    vocoder, an oracle independent of the JAX package. Only ``mean``/``scale``
    may be missing (the port has them only with ``normalize_before``)."""

    os.environ.setdefault("USE_TF", "0")     # transformers would import tensorflow first: 6 s
    from transformers import SpeechT5HifiGan, SpeechT5HifiGanConfig

    c = vocoder.config
    hf = SpeechT5HifiGan(SpeechT5HifiGanConfig(
        model_in_dim=c.model_in_dim, sampling_rate=c.sampling_rate,
        upsample_initial_channel=c.upsample_initial_channel, upsample_rates=list(c.upsample_rates),
        upsample_kernel_sizes=list(c.upsample_kernel_sizes), resblock_kernel_sizes=list(c.resblock_kernel_sizes),
        resblock_dilation_sizes=[list(d) for d in c.resblock_dilation_sizes],
        leaky_relu_slope=c.leaky_relu_slope, normalize_before=c.normalize_before)).eval()
    missing, unexpected = hf.load_state_dict(vocoder.state_dict(), strict=False)
    assert not unexpected and set(missing) <= {"mean", "scale"}, (missing, unexpected)
    return hf


class JaxMelTap:
    """Stands in for a JAX ``PipelineModules.vocoder``: ``apply`` returns its
    input, so the JAX package's own generate and SDEdit functions, unchanged,
    return the VAE-decoded mel [B, T, F] (the vocoder's input) in place of the
    waveform. Set it on a ``copy.copy`` of the modules."""

    @staticmethod
    def apply(variables, mel):
        return mel


@contextlib.contextmanager
def vocoder_input(modules: PipelineModules):
    """Around a port run: yields a list that receives the mel each call of
    ``modules.vocoder`` is given."""

    mels = []
    handle = modules.vocoder.register_forward_pre_hook(lambda mod, args: mels.append(args[0].detach().clone()))
    try:
        yield mels
    finally:
        handle.remove()


def param_fingerprints(params, trees=("unet", "vae")) -> dict:
    """Every leaf of the named trees of ``params``: its path (``fp_names``,
    "<tree>/<path>") and [sum, sum of |x|] in float64 (``fp_values``, one row
    per leaf)."""

    names, values = [], []
    for tree in trees:
        for path, leaf in jax.tree_util.tree_flatten_with_path(params[tree])[0]:
            a = np.asarray(leaf, np.float64)
            names.append("/".join([tree, *(str(getattr(k, "key", k)) for k in path)]))
            values.append([a.sum(), np.abs(a).sum()])
    return {"fp_names": np.array(names), "fp_values": np.array(values)}


def jax_source_digest() -> str:
    """sha256 of the JAX package's sources and of ``jax_train_loss``: what
    computed a stored JAX reference, beside the weights it used."""

    import inspect
    from pathlib import Path

    import ap_adapter_tpu

    h = hashlib.sha256(inspect.getsource(jax_train_loss).encode())
    root = Path(ap_adapter_tpu.__file__).parent
    for path in sorted(root.rglob("*.py")):
        h.update(str(path.relative_to(root)).encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def jax_train_loss(mods, params, inputs):
    """The training loss of one micro-batch assembled from the JAX package's
    own pieces: ``AutoencoderKL.moments`` -> z = (mean + exp(logvar / 2) *
    vae_noise) * scaling_factor -> ``add_noise`` -> ``unet.apply(...,
    ip_scale=1.0)`` -> MSE to the noise. Returns (loss as a function of the
    adapter subtree, that subtree), split by ``split_unet_params``."""

    import jax.numpy as jnp

    from ap_adapter_tpu.diffusion.ddim import add_noise, make_tables
    from ap_adapter_tpu.models.vae import AutoencoderKL
    from ap_adapter_tpu.train.trainer import merge_unet_params, split_unet_params

    cfg = mods.config
    adapter, frozen = split_unet_params(params["unet"])
    tables = make_tables(cfg.scheduler)

    def loss_fn(ad):
        mean, logvar = mods.vae.apply({"params": params["vae"]}, jnp.asarray(inputs["mel"]),
                                      method=AutoencoderKL.moments)
        z = (mean + jnp.exp(0.5 * logvar) * inputs["vae_noise"]) * cfg.vae.scaling_factor
        t = jnp.asarray(inputs["timesteps"])
        noisy = add_noise(tables, z, jnp.asarray(inputs["noise"]), t)
        pred = mods.unet.apply({"params": merge_unet_params(ad, frozen)}, noisy, t.astype(jnp.float32),
                               jnp.asarray(inputs["generated_prompt_embeds"]),
                               jnp.asarray(inputs["prompt_embeds"]), jnp.asarray(inputs["attention_mask"]),
                               ip_scale=1.0)
        return jnp.mean(jnp.square(pred - inputs["noise"]))

    return loss_fn, adapter


def within(got, want, what):
    """Within 1e-3 absolute and 1e-3 of max|want|: the waveform is
    tanh-bounded and small with the random 0.02-std weights, the mel is not."""

    assert got.shape == want.shape and np.all(np.isfinite(got)) and np.abs(want).max() > 0, what
    err = np.abs(got - want).max()
    assert err <= 1e-3 and err <= 1e-3 * np.abs(want).max(), (what, err, np.abs(want).max())


def close(got, want, atol: float = ATOL, rtol: float = 0.0) -> None:
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)
