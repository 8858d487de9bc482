"""PyTorch port: the slice (``generate_waveform``, the edit pipeline's
generate) held against the JAX pipeline at the tiny config, plus the
package's import isolation and its random-weight rules."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ap_adapter_tpu.configs import tiny_pipeline_config as jax_tiny_config
from ap_adapter_tpu.pipeline.pipeline import AudioLDM2Pipeline as JaxPipeline
from ap_adapter_tpu.pipeline.pipeline import TextBatch as JaxTextBatch
from ap_adapter_torch.configs import PipelineConfig, tiny_pipeline_config
from ap_adapter_torch.models.layers import NORM_TYPES
from ap_adapter_torch.ops import cuda_kernels
from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline, PipelineModules
from ap_adapter_torch.pipeline.tokenize import make_text_batch
from tests.torch_port_common import jax_tiny, one_torch_thread, port_tiny  # noqa: F401 (autouse fixture)


def test_generate_waveform_matches_jax():
    """4 CFG DDIM steps with the adapter live, the same init latents, hoisted
    step invariants on both sides. The waveform is tanh-bounded; with the
    random 0.02-std weights it is small, so the check is both absolute (1e-3)
    and relative to its peak (1e-3)."""

    jm, params = jax_tiny()
    cfg = tiny_pipeline_config()
    pos = make_text_batch(cfg, ["a recording of a violin solo"], t5_len=8)
    neg = make_text_batch(cfg, ["a recording of a piano solo"], t5_len=8)
    rng = np.random.default_rng(0)
    fbank = rng.standard_normal((1, 64, 32)).astype(np.float32)
    latents = rng.standard_normal((1, 4, 16, 8)).astype(np.float32)
    kw = dict(num_inference_steps=4, guidance_scale=3.0, ap_scale=0.5, time_pool=2, freq_pool=2,
              latent_time=4)

    def jtb(t):
        return JaxTextBatch(*(jnp.asarray(a) for a in (t.clap_ids, t.clap_mask, t.t5_ids, t.t5_mask)))

    fn = jax.jit(lambda p, f, a, b, lat: jm.generate_waveform(
        p, jax.random.PRNGKey(0), f, a, b, init_latents=lat, **kw))
    want = np.asarray(fn(params, jnp.asarray(fbank), jtb(pos), jtb(neg), jnp.asarray(latents)))

    cuda_kernels.reset_launch_counts()
    got = port_tiny().generate_waveform(torch.from_numpy(fbank), pos, neg,
                                        init_latents=torch.from_numpy(latents), **kw).numpy()
    assert got.shape == want.shape == (1, 4 * 4 * 16)
    assert np.all(np.isfinite(got)) and np.abs(want).max() > 0
    err = np.abs(got - want).max()
    assert err <= 1e-3 and err <= 1e-3 * np.abs(want).max(), err
    assert set(cuda_kernels.LAUNCHES.values()) == {0}


def test_generate_entry_point_on_cpu():
    """AudioLDM2Pipeline.generate: the length math, the trim, and a seeded run
    that repeats exactly and moves with the seed and with ap_scale."""

    pipe = AudioLDM2Pipeline(tiny_pipeline_config(), port_tiny())
    cfg = pipe.config
    assert pipe.latent_time_for_seconds(0.2) == JaxPipeline(jax_tiny_config(), {}).latent_time_for_seconds(0.2)
    assert AudioLDM2Pipeline(PipelineConfig(), None).latent_time_for_seconds(10.0) == 250
    pos = make_text_batch(cfg, ["a recording of a violin solo"], t5_len=8)
    neg = make_text_batch(cfg, ["a recording of a piano solo"], t5_len=8)
    fbank = np.random.default_rng(1).standard_normal((1, 64, 32)).astype(np.float32)
    kw = dict(audio_length_in_s=0.2, num_inference_steps=2, guidance_scale=3.0, time_pool=2, freq_pool=2)
    a = pipe.generate(pos, neg, fbank, seed=0, **kw)
    assert a.shape == (1, int(0.2 * cfg.vocoder.sampling_rate)) and np.all(np.isfinite(a))
    np.testing.assert_array_equal(a, pipe.generate(pos, neg, fbank, seed=0, **kw))
    assert not np.array_equal(a, pipe.generate(pos, neg, fbank, seed=1, **kw))
    assert not np.array_equal(a, pipe.generate(pos, neg, fbank, seed=0, ap_scale=0.0, **kw))


def test_init_random_rules():
    """Ones for norm scales and the sos/eos embeds, zeros for biases,
    N(0, 0.02) for the rest, reproducible from the seed."""

    cfg = tiny_pipeline_config()
    a = PipelineModules(cfg).init_random(seed=3)
    b = PipelineModules(cfg).init_random(seed=3)
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), name
    weights = []
    for mod_name, mod in a.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            if name == "bias":
                assert not p.any(), f"{mod_name}.{name}"
            elif isinstance(mod, NORM_TYPES) or name.endswith(("_embed", "_embed_1")):
                assert torch.all(p == 1), f"{mod_name}.{name}"
            else:
                weights.append(p.flatten())
    w = torch.cat(weights)
    assert abs(w.std().item() - 0.02) < 1e-3 and abs(w.mean().item()) < 1e-3


def test_port_imports_no_jax():
    """In a fresh interpreter, importing every module of the port loads no
    jax, flax or ap_adapter_tpu, and builds no kernel."""

    code = """
import importlib, pkgutil, sys
import ap_adapter_torch
for m in pkgutil.walk_packages(ap_adapter_torch.__path__, "ap_adapter_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "flax", "ap_adapter_tpu"))
assert not bad, bad
from ap_adapter_torch.ops import cuda_kernels
assert cuda_kernels._lib is None
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
