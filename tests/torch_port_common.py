"""Shared set-up for the ``test_torch_*`` files: the JAX package's tiny
pipeline params (``PipelineModules(tiny_pipeline_config()).init_params(0)``)
and the same weights loaded into the PyTorch port through ``from_jax``.
Built once per process: the JAX init dominates the set-up time."""

from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=1)
def jax_tiny():
    """(JAX PipelineModules, its params as numpy trees)."""

    mods = JaxModules(jax_tiny_config())
    return mods, jax.tree_util.tree_map(np.asarray, mods.init_params(0))


@functools.lru_cache(maxsize=1)
def port_tiny() -> PipelineModules:
    """The port's tiny PipelineModules on the CPU with the JAX tiny weights."""

    cfg = tiny_pipeline_config()
    return PipelineModules(cfg).load_state_dicts(from_jax.pipeline_state_dicts(jax_tiny()[1], cfg))


def close(got, want, atol: float = ATOL, rtol: float = 0.0) -> None:
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)
