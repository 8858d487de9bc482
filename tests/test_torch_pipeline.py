"""PyTorch port: the slice (``generate_waveform``, the edit pipeline's
generate, and the SDEdit edit) held against the JAX pipeline at the tiny
config, plus the package's import isolation and its random-weight rules.

Both edits are held against JAX at the VAE-decoded mel, the vocoder's input,
and their waveforms against a live transformers ``SpeechT5HifiGan`` (the
reference's vocoder) applied to the JAX mel: the port's vocoder differs from
JAX's on purpose (its last LeakyReLU takes the reference's slope, 0.01).
The JAX functions run unchanged, with ``JaxMelTap`` in place of their
vocoder. The SDEdit reference is ``tests/golden/torch_sdedit.npz``, written
by ``scripts/make_torch_sdedit_golden.py`` from the JAX
``sdedit_generate_waveform`` on ``jax_tiny()``'s weights with the JAX
function's own random draws (tracing the whole JAX edit takes about half a
minute, so the test reads the stored result)."""

import copy
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
from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline, PipelineModules, TextBatch
from ap_adapter_torch.pipeline.style_transfer import sdedit_generate_waveform
from ap_adapter_torch.pipeline.tokenize import make_text_batch
from tests.torch_port_common import (  # noqa: F401 (autouse fixture)
    JaxMelTap, hf_vocoder, jax_tiny, one_torch_thread, port_tiny, stale_reference, vocoder_input, within)

GOLDEN = Path(__file__).parent / "golden" / "torch_sdedit.npz"


def check_edit(run, jax_mel):
    """``run()`` is a port edit: its mel against JAX's, then its waveform
    against the live HF vocoder on the JAX mel."""

    cuda_kernels.reset_launch_counts()
    with vocoder_input(port_tiny()) as mels:
        wav = run().numpy()
    assert len(mels) == 1 and set(cuda_kernels.LAUNCHES.values()) == {0}
    within(mels[0].numpy(), jax_mel, "mel")
    with torch.no_grad():
        want = hf_vocoder(port_tiny().vocoder)(torch.from_numpy(jax_mel)).numpy()
    within(wav, want, "waveform")
    return wav


def test_generate_waveform_matches_jax():
    """4 CFG DDIM steps with the adapter live, the same init latents, hoisted
    step invariants on both sides: the mel against JAX's, the waveform
    against the HF vocoder on JAX's mel."""

    jm, params = jax_tiny()
    jm = copy.copy(jm)
    jm.vocoder = JaxMelTap()
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
    jax_mel = np.asarray(fn(params, jnp.asarray(fbank), jtb(pos), jtb(neg), jnp.asarray(latents)))
    assert jax_mel.shape == (1, 4 * 4, 64)

    wav = check_edit(lambda: port_tiny().generate_waveform(torch.from_numpy(fbank), pos, neg,
                                                           init_latents=torch.from_numpy(latents), **kw), jax_mel)
    assert wav.shape == (1, 4 * 4 * 16)


def test_sdedit_matches_jax():
    """The port's SDEdit (VAE encode of the source's mel, add_noise at the
    truncated schedule's first step, 4 hoisted CFG DDIM steps with the
    adapter live, decode, vocoder) on the JAX draws: the mel against the JAX
    edit's, the waveform against the HF vocoder on it, as the generate test
    holds them."""

    ref = np.load(GOLDEN)
    _, params = jax_tiny()
    stale_reference(ref, params, sorted(params), "scripts/make_torch_sdedit_golden.py")

    def text(name):
        return TextBatch(*(ref[f"in/{name}/{f}"] for f in ("clap_ids", "clap_mask", "t5_ids", "t5_mask")))

    check_edit(lambda: sdedit_generate_waveform(
        port_tiny(), torch.from_numpy(ref["in/source"]), torch.from_numpy(ref["in/fbank"]), text("pos"), text("neg"),
        num_inference_steps=4, guidance_scale=3.0, ap_scale=0.5, time_pool=2, freq_pool=2,
        mel_frames=int(ref["in/mel_frames"]), vae_noise=torch.from_numpy(ref["in/vae_noise"]),
        noise=torch.from_numpy(ref["in/noise"])), ref["mel"])


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
    a = PipelineModules(cfg).init_random(seed=3, device="cpu")
    b = PipelineModules(cfg).init_random(seed=3, device="cpu")
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


def test_entry_points_default_to_cuda():
    """The entry points run on the card unless the caller asks for the CPU
    (the tests do), and nothing moves to the CPU quietly without a card."""

    import inspect

    from ap_adapter_torch.eval import runner
    from ap_adapter_torch.eval.clap_scoring import ClapScorer
    from ap_adapter_torch.eval.vggish import VggishEmbedder
    from ap_adapter_torch.pipeline.audioldm_v1 import AudioLDMv1Pipeline
    from ap_adapter_torch.pipeline.tasks import load_pipeline
    from ap_adapter_torch.train.cli import build_parser

    for fn in (PipelineModules.init_random, PipelineModules.load_state_dicts, AudioLDM2Pipeline.from_random,
               AudioLDMv1Pipeline.init_random, AudioLDMv1Pipeline.load_state_dicts,
               load_pipeline, ClapScorer, VggishEmbedder, VggishEmbedder.from_torch_checkpoint):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
    assert build_parser().parse_args(["--train-manifest", "m.json"]).device == "cuda"
    assert runner.build_parser().parse_args(["--clip-dirs", "clips"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            PipelineModules(tiny_pipeline_config()).init_random(seed=0)


def test_port_imports_no_jax():
    """In a fresh interpreter, importing every module of the port loads no
    jax, flax or ap_adapter_tpu, nor transformers or safetensors (which the
    machine with the card lacks; ``HFTokenizers`` imports transformers when
    built, ``convert/cli.py`` reads ``.safetensors`` itself), and builds no
    kernel."""

    code = """
import importlib, pkgutil, sys
import ap_adapter_torch
for m in pkgutil.walk_packages(ap_adapter_torch.__path__, "ap_adapter_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "flax", "ap_adapter_tpu", "transformers",
                                                          "safetensors"))
assert not bad, bad
from ap_adapter_torch.ops import cuda_kernels
assert cuda_kernels._lib is None
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
