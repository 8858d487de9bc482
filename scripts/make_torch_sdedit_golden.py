"""Write ``tests/golden/torch_sdedit.npz``: the JAX package's SDEdit edit
(``pipeline/style_transfer.py::sdedit_generate_waveform``) at the tiny
config, the reference that ``tests/test_torch_pipeline.py`` holds the
PyTorch port's to.

    JAX_PLATFORMS=cpu python scripts/make_torch_sdedit_golden.py

The weights are ``jax_tiny()``'s (``PipelineModules(tiny_pipeline_config())
.init_params(0)``). The source clip, the fbank and the prompts are made here
from a fixed numpy seed; the two random draws are the JAX function's own
(``jax.random.split(PRNGKey(0))``: the VAE posterior sample and the forward
noise), stored so that the port gets the same numbers. 4 CFG DDIM steps of a
0.2 s clip (the truncated schedule keeps all 4), adapter live. Stored beside
the result: a fingerprint of every weight (``param_fingerprints``) and a
digest of the JAX sources (``jax_source_digest``), which the test checks
against what it runs. What is stored is the VAE-decoded mel (``mel``), the
vocoder's input: the JAX function runs unchanged with ``JaxMelTap`` in place
of its vocoder, since the port's vocoder follows the reference's
``SpeechT5HifiGan`` where JAX's differs (the test applies a live one). Tracing the whole edit takes about half a minute on a
CPU, which is why the test reads this file instead of running it.
"""

from __future__ import annotations

import copy
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "golden", "torch_sdedit.npz")
SETTINGS = dict(num_inference_steps=4, guidance_scale=3.0, ap_scale=0.5, time_pool=2, freq_pool=2)
SECONDS = 0.2


def main() -> None:
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from ap_adapter_tpu.pipeline.pipeline import AudioLDM2Pipeline, TextBatch
    from ap_adapter_tpu.pipeline.style_transfer import sdedit_generate_waveform
    from ap_adapter_tpu.pipeline.tokenize import make_text_batch
    from tests.torch_port_common import JaxMelTap, jax_source_digest, jax_tiny, param_fingerprints

    mods, params = jax_tiny()
    mods = copy.copy(mods)
    mods.vocoder = JaxMelTap()
    cfg = mods.config
    rng = np.random.default_rng(0)
    sr = cfg.mel.sample_rate
    t = np.arange(int(SECONDS * sr)) / sr
    source = (0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(t.size)).astype(np.float32)[None]
    fbank = rng.standard_normal((1, *cfg.audiomae.img_size)).astype(np.float32)
    pos = make_text_batch(cfg, ["Jazz style music"], t5_len=8)
    neg = make_text_batch(cfg, ["Low quality"], t5_len=8)
    mel_frames = AudioLDM2Pipeline(cfg, {}).latent_time_for_seconds(SECONDS) * cfg.vae.scale_factor

    key = jax.random.PRNGKey(0)
    rng_z, rng_n = jax.random.split(key)          # the split sdedit_generate_waveform makes
    sf = cfg.vae.scale_factor
    lat = (1, mel_frames // sf, cfg.mel.num_mel_bins // sf, cfg.vae.latent_channels)
    vae_noise = jax.random.normal(rng_z, lat, dtype=jnp.float32)
    noise = jax.random.normal(rng_n, lat, dtype=jnp.float32)

    def tb(batch):
        return TextBatch(*(jnp.asarray(getattr(batch, f)) for f in ("clap_ids", "clap_mask", "t5_ids", "t5_mask")))

    fn = jax.jit(lambda p, src, fb, tp, tn: sdedit_generate_waveform(
        mods, p, key, src, fb, tp, tn, mel_frames=mel_frames, **SETTINGS))
    mel = np.asarray(fn(params, jnp.asarray(source), jnp.asarray(fbank), tb(pos), tb(neg)))

    out = {"in/source": source, "in/fbank": fbank, "in/vae_noise": np.asarray(vae_noise),
           "in/noise": np.asarray(noise), "in/mel_frames": np.asarray(mel_frames)}
    for name, batch in (("pos", pos), ("neg", neg)):
        for f in ("clap_ids", "clap_mask", "t5_ids", "t5_mask"):
            out[f"in/{name}/{f}"] = np.asarray(getattr(batch, f))
    out["mel"] = mel
    out.update(param_fingerprints(params, trees=sorted(params)))
    out["jax_source_sha256"] = np.asarray(jax_source_digest())
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: mel {mel.shape}, max|mel| {np.abs(mel).max():.6g}")


if __name__ == "__main__":
    main()
