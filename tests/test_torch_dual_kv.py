"""PyTorch port: K10, the bare dual-KV attention (``ops/dual_kv_attention.py``),
held against the JAX Pallas kernel in interpret mode; its refusals; and the
trainer's refusal of ``use_pallas_attention``. The tiny UNet under the switch
is in ``test_torch_unet.py`` (it reuses that file's JAX UNet output)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ap_adapter_tpu.ops.pallas_attention import fused_dual_kv_attention as jax_fused_dual_kv_attention
from ap_adapter_torch.configs import tiny_pipeline_config
from ap_adapter_torch.ops import cuda_kernels
from ap_adapter_torch.ops.dual_kv_attention import _plain, fused_dual_kv_attention
from ap_adapter_torch.train.trainer import TrainConfig, compute_loss
from tests.torch_port_common import one_torch_thread  # noqa: F401 (autouse fixture)

# (B, Sq, H, D, St, Si): test_pallas_attention.py's adapter-realistic shapes
SHAPES = [(2, 64, 2, 32, 8, 128), (1, 100, 4, 48, 8, 32), (1, 256, 1, 80, 8, 512)]


def _inputs(shape, seed=0):
    b, sq, h, d, st, si = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, st, h, d), (b, st, h, d), (b, si, h, d), (b, si, h, d))]


def _jax(arrays, dtype=jnp.float32):
    return np.asarray(jax_fused_dual_kv_attention(*(jnp.asarray(a, dtype) for a in arrays), 0.7, tile_q=128,
                                                  interpret=True).astype(jnp.float32))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret(shape):
    arrays = _inputs(shape)
    want = _jax(arrays)
    cuda_kernels.reset_launch_counts()
    got = fused_dual_kv_attention(*map(torch.from_numpy, arrays), 0.7)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert cuda_kernels.LAUNCHES["dual_kv_attention"] == 0        # CPU tensors: the plain path


def test_plain_rounds_once_in_bf16():
    """bf16 inputs: the two branches are summed in fp32 and cast once, as the
    Pallas body does, so the result is within one bf16 ulp of its own max."""

    arrays = _inputs(SHAPES[0], seed=1)
    want = _jax(arrays, jnp.bfloat16)
    got = _plain(*(torch.from_numpy(a).to(torch.bfloat16) for a in arrays), 0.7)
    assert got.dtype == torch.bfloat16
    peak = np.abs(want).max()
    ulp = 2.0 ** (np.floor(np.log2(peak)) - 7)
    assert np.abs(got.float().numpy() - want).max() <= ulp


def test_wrapper_refuses_what_k10_does_not_define():
    q, kt, vt, ki, vi = map(torch.from_numpy, _inputs(SHAPES[0]))
    with pytest.raises(ValueError, match="empty key set"):
        fused_dual_kv_attention(q, kt, vt, ki[:, :0], vi[:, :0], 0.5)
    with pytest.raises(ValueError, match="empty key set"):
        fused_dual_kv_attention(q, kt[:, :0], vt[:, :0], ki, vi, 0.5)
    with pytest.raises(ValueError, match="unmasked"):
        fused_dual_kv_attention(q, kt, vt, ki, vi, 0.5, bias=torch.zeros(q.shape[0], kt.shape[1]))
    with pytest.raises(ValueError, match="contiguous"):
        fused_dual_kv_attention(q.transpose(1, 2).contiguous().transpose(1, 2), kt, vt, ki, vi, 0.5)
    with pytest.raises(ValueError, match="must be"):
        fused_dual_kv_attention(q, kt, vt, ki[..., :16], vi, 0.5)
    with pytest.raises(RuntimeError, match="require grad"):
        fused_dual_kv_attention(q.requires_grad_(), kt, vt, ki, vi, 0.5)
    with torch.no_grad():
        assert fused_dual_kv_attention(q, kt, vt, ki, vi, 0.5).shape == q.shape


def test_trainer_refuses_use_pallas_attention():
    cfg = tiny_pipeline_config()
    cfg = cfg.replace(unet=type(cfg.unet)(**{**cfg.unet.__dict__, "use_pallas_attention": True}))
    with pytest.raises(ValueError, match="K10"):
        compute_loss(types.SimpleNamespace(config=cfg), TrainConfig(), {}, vae_noise=None, noise=None,
                     timesteps=None)
