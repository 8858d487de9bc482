"""Write ``tests/golden/torch_train_grads.npz``: the JAX package's training
loss and adapter gradient at the tiny config, the reference that
``tests/test_torch_train.py`` holds the PyTorch port's to.

    JAX_PLATFORMS=cpu python scripts/make_torch_train_golden.py

The loss is ``tests.torch_port_common.jax_train_loss`` (assembled from the
JAX package's own pieces) on the weights of ``jax_tiny()``
(``PipelineModules(tiny_pipeline_config()).init_params(0)``), and the
gradient is ``jax.grad`` of it with respect to the adapter subtree. The
inputs, noise and timesteps are drawn here from numpy with a fixed seed and
stored beside the results, with a fingerprint of every UNet and VAE weight
(``param_fingerprints``) and a digest of the JAX sources and of the loss
(``jax_source_digest``), which the test checks against what it runs.
jax.grad of the tiny UNet traces and compiles for over a minute on a CPU,
which is why the test reads this file instead of running it.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "golden", "torch_train_grads.npz")


def main() -> None:
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")

    from ap_adapter_tpu.adapter.params import export_flat_adapter
    from ap_adapter_tpu.train.trainer import merge_unet_params, split_unet_params
    from tests.torch_port_common import jax_source_digest, jax_tiny, jax_train_loss, param_fingerprints

    mods, params = jax_tiny()
    cfg = mods.config
    rng = np.random.default_rng(0)
    b, s1 = 2, 5
    f32 = np.float32
    inputs = {
        "mel": (rng.standard_normal((b, 16, cfg.mel.num_mel_bins, 1)) - 4.0).astype(f32),
        "generated_prompt_embeds": rng.standard_normal(
            (b, cfg.unet.adapter_num_tokens + 4, cfg.unet.adapter_cross_attention_dim)).astype(f32),
        "prompt_embeds": rng.standard_normal((b, s1, cfg.t5.d_model)).astype(f32),
        "attention_mask": np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.int32),
    }
    sf = cfg.vae.scale_factor
    lat = (b, 16 // sf, cfg.mel.num_mel_bins // sf, cfg.vae.latent_channels)
    inputs["vae_noise"] = rng.standard_normal(lat).astype(f32)
    inputs["noise"] = rng.standard_normal(lat).astype(f32)
    inputs["timesteps"] = np.array([37, 811], np.int32)

    loss_fn, adapter = jax_train_loss(mods, params, inputs)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(adapter)
    frozen = split_unet_params(params["unet"])[1]
    flat = export_flat_adapter(merge_unet_params(jax.device_get(grads), frozen), cfg.unet)
    out = {f"in/{k}": v for k, v in inputs.items()}
    out["loss"] = np.asarray(loss, np.float64)
    out.update({f"grad/{k}": np.asarray(v, f32) for k, v in flat.items()})
    out.update(param_fingerprints(params))
    out["jax_source_sha256"] = np.asarray(jax_source_digest())
    # the port's copy of the adapter weights, as converted from these
    out["adapter_weights_l1"] = np.asarray(
        sum(np.abs(v).sum(dtype=np.float64) for v in export_flat_adapter(params["unet"], cfg.unet).values()))
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: loss {float(loss):.8g}, {len(flat)} adapter gradients")


if __name__ == "__main__":
    main()
