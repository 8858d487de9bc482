"""The port's parallel layer on the CPU: the tensor-parallel rules against
the JAX package's, the GEGLU split, the refusals, the single-process
mesh, and tensor-parallel serving on gloo ranks
(``tests/torch_dist_worker.py``: case ``tp2``, two ranks over a (1, 2)
mesh, with ``tasks.main --tensor-parallel 2``; case ``tp2dp2``, four ranks
over (2, 2)) against one process, within the JAX test's atol = rtol = 2e-4
(``tests/test_tp.py``) and within 1e-5 of max|want|: the tiny clips peak
near 3e-4, under that absolute tolerance.
"""

from __future__ import annotations

import copy
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ap_adapter_torch.audio.io import save_wav
from ap_adapter_torch.configs import tiny_pipeline_config
from ap_adapter_torch.convert import from_jax
from ap_adapter_torch.models.unet import AudioLDM2UNet
from ap_adapter_torch.models.unet_blocks import FeedForward
from ap_adapter_torch.parallel import distributed, tp
from ap_adapter_torch.parallel.mesh import Mesh, all_reduce_mean_, barrier, create_mesh, shard_batch
from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline, PipelineModules
from ap_adapter_tpu.parallel.tp import _spec_for
from tests import torch_dist_worker as W
from tests.torch_port_common import jax_tiny, one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """{case: W.Ranks}: the two-rank and the four-rank run, started at once
    before the module's first test, so they run while the others do."""

    out = tmp_path_factory.mktemp("tp")
    save_wav(str(out / "source.wav"), (0.2 * np.random.default_rng(0).standard_normal(3200)).astype(np.float32),
             16000)
    runs = {"tp2": W.Ranks("tp2", 2, str(out)), "tp2dp2": W.Ranks("tp2dp2", 4, str(out))}
    yield runs
    for r in runs.values():
        r.close()


def test_tp_rules_match_jax_spec_for():
    """For every leaf of the JAX tiny UNet, ``_spec_for(path, leaf, 2,
    heads)`` splits it exactly where ``split_rule`` splits the torch key it
    converts to (``from_jax.unet_state_dict``), and along the same axis:
    each leaf is filled with 1 + its index along JAX's split axis (0 where
    whole), so the converted tensor varies along the port's split dimension
    alone, or is all zeros."""

    jax_cfg = jax_tiny()[0].config
    heads = jax_cfg.unet.num_attention_heads

    def marker(path, leaf):
        spec = tuple(_spec_for(path, leaf, 2, heads))
        if "model" not in spec:
            return np.zeros(leaf.shape, np.float32)
        axis = leaf.ndim - len(spec) + spec.index("model")
        shape = [1] * leaf.ndim
        shape[axis] = leaf.shape[axis]
        return np.broadcast_to(1.0 + np.arange(leaf.shape[axis], dtype=np.float32).reshape(shape), leaf.shape)

    sd = from_jax.unet_state_dict(jax.tree_util.tree_map_with_path(marker, jax_tiny()[1]["unet"]),
                                  tiny_pipeline_config().unet)
    assert set(sd) == set(AudioLDM2UNet(tiny_pipeline_config().unet).state_dict())
    split = 0
    for key, value in sd.items():
        value = np.asarray(value)
        rule = tp.split_rule(key)
        assert (rule is not None) == bool(value.any()), key
        if rule is not None:
            split += 1
            other = tuple(d for d in range(value.ndim) if d != rule[1])
            assert np.ptp(value, axis=other).max() == 0 and np.ptp(value, axis=rule[1]).min() > 0, key
    assert split == 736


@pytest.mark.parametrize("n", [2, 4])
def test_geglu_split_holds_matching_value_and_gate_columns(n):
    """Each rank's ``ff.net.0.proj`` rows are the same column slice of the
    value half and of the gate half (its bias likewise), and the ranks'
    partial outputs sum to the whole feed-forward; JAX's contiguous split
    of the [.., 2 * inner] axis would give rank 0 only value columns."""

    torch.manual_seed(0)
    dim, inner = 32, 128
    ff = FeedForward(dim, force_xla=True)
    norm = torch.nn.LayerNorm(dim)
    with torch.no_grad():
        for p in list(ff.parameters()) + list(norm.parameters()):
            p.normal_(0.0, 0.2)
    x = torch.randn(2, 7, dim)
    want = ff(x, norm)
    b = ff.net[2].bias
    total = torch.zeros_like(x)
    c = inner // n
    for r in range(n):
        local = copy.deepcopy(ff)
        for key, p in local.named_parameters():
            rule = tp.split_rule(f"ff.{key}")
            if rule is not None:
                p.data = tp.shard(p.data, rule[0], n, r)
        w = local.net[0].proj.weight
        torch.testing.assert_close(w[:c], ff.net[0].proj.weight[r * c:(r + 1) * c], rtol=0, atol=0)
        torch.testing.assert_close(w[c:], ff.net[0].proj.weight[inner + r * c: inner + (r + 1) * c], rtol=0, atol=0)
        bias = ff.net[0].proj.bias
        torch.testing.assert_close(local.net[0].proj.bias[c:], bias[inner + r * c: inner + (r + 1) * c], rtol=0, atol=0)
        assert local.net[2].weight.shape == (dim, c) and local.net[2].bias.shape == (dim,)
        total += local(x, norm) - x - b
    torch.testing.assert_close(total + x + b, want, rtol=0, atol=1e-5 * want.abs().max().item())
    path = (jax.tree_util.DictKey("geglu_proj"), jax.tree_util.DictKey("kernel"))
    spec = _spec_for(path, np.zeros((dim, 2 * inner)), 2, 2)
    assert tuple(spec) == (None, "model")          # contiguous: rank 0 holds [0, inner), the value half


def test_refusals_and_the_single_process_mesh(monkeypatch):
    """``tensor_parallel=True`` without a ``model`` axis larger than 1, and
    a ``model`` size that does not divide the heads, raise ``ValueError``;
    so does a world of 2 without a rank. One process makes a (1, 1) mesh
    whose collectives are the identity."""

    cfg = tiny_pipeline_config()
    assert not distributed.maybe_initialize(device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert not distributed.maybe_initialize(device="cpu")
    monkeypatch.setenv("APX_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="no rank"):
        distributed.maybe_initialize(device="cpu")
    monkeypatch.delenv("APX_NUM_PROCESSES")
    assert distributed.process_count() == 1 and distributed.host_local_batch_size(4) == 4
    mesh = create_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.groups == {"data": None, "model": None}
    assert mesh.rows(3) == (0, 3)
    x = torch.arange(6.0).reshape(3, 2)
    torch.testing.assert_close(shard_batch(mesh, {"x": x})["x"], x, rtol=0, atol=0)
    y = x.clone()
    all_reduce_mean_(mesh, [y])
    barrier(mesh)
    torch.testing.assert_close(y, x, rtol=0, atol=0)
    assert distributed.shard_host_batch(mesh, {"a": x, "b": x[:, :1]})["b"].shape == (3, 1)
    with pytest.raises(ValueError):
        distributed.shard_host_batch(mesh, {"a": x, "b": x[:2]})
    stacked = {"a": torch.zeros(2, 3, 5), "b": torch.zeros(2, 3)}       # [K, B_local, ...] micro-batches
    assert distributed.shard_host_batch(mesh, stacked, (None, "data"))["a"].shape == (2, 3, 5)
    with pytest.raises(ValueError):
        distributed.shard_host_batch(mesh, {**stacked, "c": torch.zeros(2, 4)}, (None, "data"))
    with pytest.raises(ValueError, match="model"):
        AudioLDM2Pipeline(cfg, None, tensor_parallel=True)
    with pytest.raises(ValueError, match="model"):
        AudioLDM2Pipeline(cfg, None, mesh=mesh, tensor_parallel=True)
    three = Mesh({"data": 1, "model": 3}, {"data": 0, "model": 0}, {"data": (0,), "model": (0, 1, 2)},
                 {"data": None, "model": None}, torch.device("cpu"))
    with torch.device("meta"):
        unet = AudioLDM2UNet(cfg.unet)
    with pytest.raises(ValueError, match="2 heads"):
        tp.tp_shard_unet_(unet, three)
    with pytest.raises(ValueError, match="mesh needs 2 ranks"):
        create_mesh(data=2, device="cpu")


@pytest.mark.parametrize("case", ["tp2", "tp2dp2"])
def test_tp_generate_matches_one_process(ranks, case):
    """Tensor-parallel generate on the ranks (each the rows of its data
    index) against one process on the default route: every split site
    narrowed (736 parameters, ``to_q`` at 32 / 2 rows), ``force_xla_core``
    set, the clips within the tolerances of the module docstring."""

    data = 2 if case == "tp2dp2" else 1
    pos, neg, fbank = W.generate_inputs(2 * data)
    want = AudioLDM2Pipeline(tiny_pipeline_config(), W.tiny_modules()).generate(pos, neg, fbank, **W.GENERATE)
    results = ranks[case].results()
    assert len(results) == 2 * data
    for rank, r in enumerate(results):
        rows = want[2 * (rank // 2): 2 * (rank // 2) + 2]
        assert int(r["sharded"]) == 736 and int(r["to_q_rows"]) == 16 and bool(r["force_xla_core"])
        np.testing.assert_allclose(r["generate"], rows, atol=2e-4, rtol=2e-4)
        assert np.abs(r["generate"] - rows).max() <= 1e-5 * np.abs(want).max()


def test_tasks_tensor_parallel_writes_on_rank_zero(ranks):
    """``tasks.main([... "--tensor-parallel", "2"])`` on both ranks: the
    same file names, the wav written by rank 0 alone."""

    results = ranks["tp2"].results()
    out = Path(ranks["tp2"].out_dir)
    names = [[Path(p).name for p in r["task_paths"]] for r in results]
    assert names[0] == names[1] == ["t_0_ip0.5_t2_f2.wav"]
    assert (out / "tasks_rank0" / names[0][0]).is_file()
    assert not (out / "tasks_rank1").exists()


def test_force_xla_core_route_matches_the_default_route():
    """One process: ``force_xla_core`` (no kernel's plain version) against
    the default route's UNet on the same weights, within 1e-5 of max."""

    cfg = tiny_pipeline_config()
    xla = cfg.replace(unet=dataclasses.replace(cfg.unet, force_xla_core=True))
    mods = W.tiny_modules()
    other = PipelineModules(xla).init_random(seed=0, device="cpu")
    g = torch.Generator().manual_seed(2)
    args = (torch.randn(2, 8, 16, 8, generator=g), torch.tensor([10.0, 500.0]),
            torch.randn(2, 12, 32, generator=g), torch.randn(2, 5, 48, generator=g),
            torch.tensor([[1, 1, 1, 0, 0], [1] * 5]))
    with torch.no_grad():
        want = mods.unet(*args, ip_scale=0.5)
        got = other.unet(*args, ip_scale=0.5)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())
