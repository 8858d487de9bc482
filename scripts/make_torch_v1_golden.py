"""Write ``tests/golden/torch_v1.npz`` and ``tests/golden/torch_cn.npz``:
the JAX package's AudioLDM v1 generate
(``pipeline/audioldm_v1.py::AudioLDMv1Pipeline.generate``), its
class-embedding UNet, and its ControlNet-branch (``cn_text_only``) UNet at
the tiny config, the references that ``tests/test_torch_v1_cn.py`` holds
the PyTorch port's ``AudioLDMv1Pipeline`` and UNet to.

    JAX_PLATFORMS=cpu python scripts/make_torch_v1_golden.py

The weights are ``AudioLDMv1Pipeline.from_random(tiny_pipeline_config(),
seed=0)``'s (``tests/torch_port_common.py::jax_v1_tiny``). Two prompts and
their negatives go through the hash tokenizer; 4 CFG DDIM steps of a 0.2 s
clip at guidance 2.5. Stored: the token ids, the initial latents (the JAX
function's own draw, ``jax.random.normal(PRNGKey(0), ...)``), the
VAE-decoded mel (``mel``, the vocoder's input: the JAX generate runs
unchanged with ``JaxMelTap`` in place of its vocoder, since the port's
vocoder follows the reference's slope), a fingerprint of every weight
(``param_fingerprints``) and a digest of the JAX sources
(``jax_source_digest``), which the test checks against what it runs.
Tracing the JAX generate takes about 10 s on a CPU, which is why the test
reads this file, and the UNet outputs are stored for the same reason
(jitting the tiny v1 UNet takes about 8 s, the cn UNet about 15 s).

``torch_v1.npz`` also holds one v1 UNet forward (``unet_*``: latents [2, 5,
16, 8], timesteps, class labels, the output). ``torch_cn.npz`` holds one
forward of the JAX tiny UNet (``jax_tiny()``'s weights without the adapter's)
under ``cn_text_only`` on 8 text + 4 audio tokens, a T5 stream with a padded
row and ip_scale 0.7, with the fingerprints of that UNet's weights.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "golden", "torch_v1.npz")
OUT_CN = os.path.join(ROOT, "tests", "golden", "torch_cn.npz")
PROMPTS = ["a recording of a violin solo", "jazz piano trio"]
NEGATIVES = ["low quality", "noise"]
SETTINGS = dict(audio_length_in_s=0.2, num_inference_steps=4, guidance_scale=2.5, seed=0)


def main() -> None:
    sys.path.insert(0, ROOT)
    import dataclasses

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from ap_adapter_tpu.configs import tiny_pipeline_config
    from ap_adapter_tpu.models.unet import AudioLDM2UNet
    from ap_adapter_tpu.pipeline.audioldm_v1 import AudioLDMv1Pipeline
    from ap_adapter_tpu.pipeline.tokenize import make_text_batch
    from tests.torch_port_common import (
        JaxMelTap, cn_unet_tree, jax_source_digest, jax_tiny, jax_v1_tiny, jax_v1_unet_config, param_fingerprints)

    def unet_apply(config, tree, *args):
        return np.asarray(jax.jit(lambda p, *a: AudioLDM2UNet(config).apply({"params": p}, *a))(tree, *args))

    cfg = tiny_pipeline_config()
    ucfg = jax_v1_unet_config(cfg)
    params = jax_v1_tiny()
    pipe = AudioLDMv1Pipeline(cfg, ucfg, params)
    pipe.vocoder = JaxMelTap()
    pos = make_text_batch(cfg, PROMPTS, t5_len=8)
    neg = make_text_batch(cfg, NEGATIVES, t5_len=8)
    mel = np.asarray(pipe.generate(pos, neg, **SETTINGS), np.float32)

    # the draw inside the JAX generate, with its shape
    scale = cfg.vae.scale_factor
    height = int(SETTINGS["audio_length_in_s"] / (cfg.vocoder.upsample_factor / cfg.vocoder.sampling_rate))
    shape = (len(PROMPTS), (height + scale - 1) // scale, cfg.vocoder.model_in_dim // scale, ucfg.in_channels)
    latents = np.asarray(jax.random.normal(jax.random.PRNGKey(SETTINGS["seed"]), shape, jax.numpy.float32))

    rng = np.random.default_rng(5)
    unet_in = dict(unet_x=rng.standard_normal((2, 5, 16, 8)).astype(np.float32),
                   unet_t=np.array([17.0, 901.0], np.float32),
                   unet_labels=rng.standard_normal((2, ucfg.class_embed_dim)).astype(np.float32))
    dummy = jnp.zeros((2, 1, 8))      # the v1 UNet reads no context (the JAX generate passes the same)
    unet_want = unet_apply(ucfg, params["unet"], unet_in["unet_x"], unet_in["unet_t"], dummy, dummy, None, 0.0,
                           unet_in["unet_labels"])
    digest = np.array(jax_source_digest())
    np.savez_compressed(OUT, clap_ids=np.asarray(pos.clap_ids), clap_mask=np.asarray(pos.clap_mask),
             neg_clap_ids=np.asarray(neg.clap_ids), neg_clap_mask=np.asarray(neg.clap_mask),
             latents=latents, mel=mel, **unet_in, unet_want=unet_want, jax_source_sha256=digest,
             **param_fingerprints(params, ("clap", "unet", "vae", "vocoder")))
    print(f"wrote {OUT}: mel {mel.shape}, max|mel| {np.abs(mel).max():.4g}, "
          f"max|unet_want| {np.abs(unet_want).max():.4g}")

    tree = cn_unet_tree(jax_tiny()[1]["unet"])
    cn_cfg = dataclasses.replace(cfg.unet, cn_text_only=True)
    rng = np.random.default_rng(6)
    mask = np.ones((2, 6), np.int32)
    mask[1, 4:] = 0
    cn_in = dict(x=rng.standard_normal((2, 5, 16, 8)).astype(np.float32), t=np.array([3.0, 640.0], np.float32),
                 ehs0=rng.standard_normal((2, 8 + 4, 32)).astype(np.float32),
                 ehs1=rng.standard_normal((2, 6, 48)).astype(np.float32), mask1=mask, ip_scale=np.float32(0.7))
    want = unet_apply(cn_cfg, tree, *(cn_in[k] for k in ("x", "t", "ehs0", "ehs1", "mask1", "ip_scale")))
    np.savez_compressed(OUT_CN, **cn_in, want=want, jax_source_sha256=digest, **param_fingerprints({"unet": tree}, ("unet",)))
    print(f"wrote {OUT_CN}: max|want| {np.abs(want).max():.4g}")


if __name__ == "__main__":
    main()
