"""PyTorch port: the K5/K6 self-attention module (``ops/self_attention.py``)
and its routing (``ops/attention.py::self_attention``), held against the JAX
package's two Pallas kernels run with ``interpret=True`` and against its
routine, on the same numpy inputs (fp32, CPU). Tolerance 2e-4, as the JAX
package's own kernel tests use. The CUDA kernel is held against the plain
version in ``test_torch_cuda.py`` (on the card only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ap_adapter_tpu.ops import attention as jattn
from ap_adapter_tpu.ops.pallas_packed_attention import packed_self_attention
from ap_adapter_tpu.ops.pallas_self_attention import pallas_self_attention
from ap_adapter_torch.ops import attention, cuda_kernels
from ap_adapter_torch.ops.self_attention import self_attention_kernel, self_attention_plain, self_attention_vjp
from tests.torch_port_common import close, one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 2e-4


def _qkv(rng, shape):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("kernel,shape", [
    ("packed", (2, 100, 8, 32)),   # K5: 4 heads packed per 128 lanes
    ("packed", (1, 70, 4, 64)),
    ("packed", (1, 130, 8, 16)),
    ("whole_kv", (2, 64, 2, 32)),  # K6: any d, whole K/V resident
    ("whole_kv", (1, 100, 4, 48)),
])
def test_plain_matches_jax_kernels(rng, kernel, shape):
    """The port's plain version and its wrapper on a CPU tensor against the
    JAX kernels in interpret mode, at the shapes of test_pallas_attention.py."""

    q, k, v = _qkv(rng, shape)
    args = [jnp.asarray(a) for a in (q, k, v)]
    if kernel == "packed":
        want = packed_self_attention(*args, tile_q=64, interpret=True)
    else:
        want = pallas_self_attention(*args, tile_q=128, interpret=True)
    cuda_kernels.reset_launch_counts()
    t = [torch.from_numpy(a) for a in (q, k, v)]
    close(self_attention_plain(*t), np.asarray(want), atol=TOL)
    close(self_attention_kernel(*t), np.asarray(want), atol=TOL)
    assert cuda_kernels.LAUNCHES["self_attention"] == 0      # a CPU tensor: the plain version only


@pytest.mark.parametrize("s", [511, 600])
def test_routing_matches_jax_routine(rng, s):
    """``self_attention`` on both sides of the 512-token threshold (the VAE
    mid block's one head of d = 512, narrowed) against the JAX routine, which
    takes XLA on a CPU."""

    q, k, v = _qkv(rng, (1, s, 1, 64))
    want = jattn.self_attention(*(jnp.asarray(a) for a in (q, k, v)))
    close(attention.self_attention(*(torch.from_numpy(a) for a in (q, k, v))), np.asarray(want), atol=TOL)


def test_autograd_function_gives_plain_gradients(rng):
    """The autograd Function (forward the kernel's module, backward autograd
    over the plain version) against autograd through the plain version."""

    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(rng, (1, 40, 2, 16)))
    g = torch.from_numpy(rng.standard_normal((1, 40, 2, 16)).astype(np.float32))
    got = torch.autograd.grad(self_attention_vjp(q, k, v), (q, k, v), g)
    want = torch.autograd.grad(self_attention_plain(q, k, v), (q, k, v), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    with pytest.raises(RuntimeError, match="self_attention_vjp"):   # the raw op records no graph
        self_attention_kernel(q, k, v)
