"""PyTorch port: the dual-stream UNet (with and without the hoisted
step invariants) held against the JAX UNet at the tiny config on the same
weights and inputs (fp32, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ap_adapter_tpu.configs import tiny_pipeline_config as jax_tiny_config
from ap_adapter_tpu.models import hoist as jhoist
from ap_adapter_torch.models import hoist
from ap_adapter_torch.ops import cuda_kernels
from tests.torch_port_common import close, jax_tiny, one_torch_thread, port_tiny  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def unet_inputs_np():
    rng = np.random.default_rng(0)
    b = 2
    x = rng.standard_normal((b, 7, 4, 8)).astype(np.float32)       # odd latent time: odd upsampling
    ts = np.array([501.0, 501.0], np.float32)
    ehs0 = rng.standard_normal((b, 8 + 16, 32)).astype(np.float32)  # GPT-2 + pooled AudioMAE tokens
    ehs1 = rng.standard_normal((b, 6, 48)).astype(np.float32)       # T5 tokens
    mask = np.ones((b, 6), np.int32)
    mask[0, 3:] = 0
    return x, ts, ehs0, ehs1, mask


@pytest.fixture(scope="module")
def jax_unet_out(unet_inputs_np):
    """The JAX UNet on the tiny weights (one jitted trace, shared by both port routes)."""

    jm, params = jax_tiny()
    fn = jax.jit(lambda p, *a: jm.unet.apply({"params": p}, *a, ip_scale=0.5))
    return np.asarray(fn(params["unet"], *map(jnp.asarray, unet_inputs_np)))


@pytest.mark.parametrize("hoisted", [False, True])
def test_unet_matches_jax(unet_inputs_np, jax_unet_out, hoisted):
    """The port's UNet, with K/V, T5 bias and temb rows either computed in
    the step or hoisted (models/hoist.py), against the JAX UNet."""

    x, ts, ehs0, ehs1, mask = unet_inputs_np
    unet = port_tiny().unet
    kw = {}
    if hoisted:
        kw["ctx_kv"] = hoist.precompute_cross_kv(unet, torch.from_numpy(ehs0), torch.from_numpy(ehs1),
                                                 torch.from_numpy(mask))
        rows = hoist.precompute_temb_rows(unet, np.array([int(ts[0])]))
        kw["temb_rows"] = {k: v[0] for k, v in rows.items()}
    cuda_kernels.reset_launch_counts()
    with torch.no_grad():
        got = unet(*map(torch.from_numpy, (x, ts, ehs0, ehs1, mask)), ip_scale=0.5, **kw)
    assert got.shape == x.shape
    close(got, jax_unet_out)
    assert set(cuda_kernels.LAUNCHES.values()) == {0}   # CPU tensors: the plain path only


def test_hoisted_temb_rows_match_jax():
    _, params = jax_tiny()
    ts = np.array([981, 501, 21, 1])
    want = jhoist.precompute_temb_rows(params["unet"], jax_tiny_config().unet, ts, jnp.float32)
    got = hoist.precompute_temb_rows(port_tiny().unet, ts)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], atol=1e-5)


def test_hoisted_kv_matches_jax(unet_inputs_np):
    """Natural [L, B, Sk, C] layout: text K/V over the 8 GPT-2 tokens and the
    adapter K/V over the audio tokens at the 768-dim (here 32-dim) sites;
    T5 K/V and the [B, S1] bias on the other stream. The JAX K/V carry
    padded key rows, dropped here (the tiny head dim 16 needs no lane pad)."""

    _, _, ehs0, ehs1, mask = unet_inputs_np
    _, params = jax_tiny()
    want = jhoist.precompute_cross_kv(params["unet"], jax_tiny_config().unet, *map(jnp.asarray, (ehs0, ehs1, mask)),
                                      jnp.float32)
    unet = port_tiny().unet
    kv = hoist.precompute_cross_kv(unet, torch.from_numpy(ehs0), torch.from_numpy(ehs1),
                                   torch.from_numpy(mask))
    c = unet.config
    groups = dict(unet.attention_groups())
    assert set(kv) == set(groups) | {"__bias1__"}
    close(kv["__bias1__"], (1.0 - mask) * -10000.0, atol=0)
    k, v, ki, vi = kv["mid_attn_0"]["attentions_1"]
    L, ch = c.transformer_layers_per_block, c.block_out_channels[-1]
    assert k.shape == (L, 2, 8, ch) and ki.shape == (L, 2, 16, ch)
    k, v, ki, vi = kv["mid_attn_0"]["attentions_2"]
    assert k.shape == (L, 2, 6, ch) and ki is None
    close(kv["__bias1__"], np.asarray(want["__bias1__"])[:, 0, :6], atol=0)
    for group, entry in want.items():
        if group == "__bias1__":
            continue
        for site, arrays in entry.items():
            for got_a, want_a in zip(kv[group][site], arrays):
                assert (got_a is None) == (want_a is None)
                if got_a is not None:
                    close(got_a, np.asarray(want_a)[:, :, : got_a.shape[2]], atol=1e-5)
