"""The port's data-parallel paths on the CPU: two gloo ranks
(``tests/torch_dist_worker.py``, case ``dp``, tiny config, fp32) against
one process at the global batch.

The one-process training step is held against JAX by
``test_torch_train.py``; here the rule is that two ranks at B = 2 equal one
process at B = 4, up to the order of the fp32 sums: the loss, the gradient
norm and the all-reduced gradients within 1e-5 relative. AdamW divides
each gradient entry by its own magnitude, so an entry near ``adam_epsilon``
turns those last-digit differences into a visible share of a step: the
updated weights are held within 1e-3 of max|w| (the largest seen is 3.4e-4,
at entries of |g| ~ 1e-8), and the ranks' weights bit-equal to each other.
"""

from __future__ import annotations

import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from ap_adapter_torch.audio.io import save_wav
from ap_adapter_torch.configs import tiny_pipeline_config
from ap_adapter_torch.models.mae_pretrain import make_mae_pretrain_step
from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline
from ap_adapter_torch.train.data import AudioSetDataset, DeviceCollate, data_loader
from ap_adapter_torch.train.loop import train
from ap_adapter_torch.utils.checkpoint import TrainCheckpointer, load_flat_adapter
from tests import torch_dist_worker as W
from tests.torch_port_common import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-5
WEIGHT_TOL = 1e-3


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The two ranks (``W.Ranks``): every ``dp`` check in one start of the
    two processes, which run while the first test computes its reference."""

    ranks = W.Ranks("dp", 2, str(tmp_path_factory.mktemp("dp")))
    yield ranks
    ranks.close()


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def stacked(results: dict, prefix: str) -> np.ndarray:
    return np.concatenate([v.ravel() for k, v in sorted(results.items()) if k.startswith(prefix)])


@pytest.mark.parametrize("accum", [1, 2])
def test_dp_train_matches_one_process(dp, tmp_path, accum):
    """``train(..., mesh=)`` on two ranks at B = 2 against ``train()`` in one
    process at B = 4 on the same micro-batches (2 steps; accumulation 1 and
    2): loss, gradient norm, the last step's gradients, the weights."""

    state = train(W.tiny_modules(), iter(W.train_batches(accum)), W.train_config(accum), str(tmp_path), log_every=1)
    ranks = dp.results()
    for r in ranks:
        assert rel(r[f"accum{accum}/loss"], [m["loss"] for m in state.history]) <= TOL
        assert rel(r[f"accum{accum}/grad_norm"], [m["grad_norm"] for m in state.history]) <= TOL
    want_grad = np.concatenate([p.grad.numpy().ravel() for _, p in sorted(state.adapter.items())])
    want_w = np.concatenate([p.detach().numpy().ravel() for _, p in sorted(state.adapter.items())])
    got_grad, got_w = stacked(ranks[0], f"accum{accum}/grad/"), stacked(ranks[0], f"accum{accum}/adapter/")
    assert got_w.size == want_w.size == got_grad.size
    assert rel(got_grad, want_grad) <= TOL
    assert rel(got_w, want_w) <= WEIGHT_TOL
    np.testing.assert_array_equal(got_w, stacked(ranks[1], f"accum{accum}/adapter/"))


def test_dp_loop_writes_on_rank_zero(dp):
    """Rank 0 alone wrote the metrics (one line a step), the rotating
    checkpoints and the flat adapter, which is the trained one, and ran
    the validation rounds (every step of the accumulation-2 run; rank 1
    had no ``validation_fn`` and waited at the barrier)."""

    ranks = dp.results()
    assert list(ranks[0]["validated"]) == [1, 2] and list(ranks[1]["validated"]) == []
    run = Path(dp.out_dir) / "train_accum2"
    assert [json.loads(line)["step"] for line in (run / "metrics.jsonl").read_text().splitlines()] == [1, 2]
    assert TrainCheckpointer(str(run / "checkpoints")).steps() == [1, 2]
    flat = load_flat_adapter(str(run / "pytorch_model.npz"))
    for k, v in flat.items():
        np.testing.assert_array_equal(v, ranks[0][f"accum2/adapter/{k}"])


def test_replicate_params_broadcasts_rank_zero(dp):
    """``replicate_params``: each rank drew other weights and a buffer; all
    hold rank 0's after it."""

    torch.manual_seed(0)
    lin = torch.nn.Linear(3, 2)
    want = torch.cat([lin.weight.detach().ravel(), lin.bias.detach(), torch.rand(2)]).numpy()
    for r in dp.results():
        np.testing.assert_array_equal(r["replicated"], want)


def test_mae_dp_step_matches_one_process(dp):
    """``make_mae_pretrain_step(..., mesh=)`` on two ranks at B = 2 against
    one process at B = 4: the losses, the weights after 2 steps."""

    model = W.mae_model()
    step = make_mae_pretrain_step(model, torch.optim.AdamW(model.parameters(), lr=1e-3))
    gen = torch.Generator().manual_seed(5)
    losses = [step(fb, gen).item() for fb in W.mae_fbanks()]
    want = np.concatenate([v.numpy().ravel() for _, v in sorted(model.state_dict().items())])
    ranks = dp.results()
    for r in ranks:
        assert rel(r["mae/loss"], losses) <= TOL
    assert rel(stacked(ranks[0], "mae/weights/"), want) <= WEIGHT_TOL
    np.testing.assert_array_equal(stacked(ranks[0], "mae/weights/"), stacked(ranks[1], "mae/weights/"))


def test_dp_generate_matches_one_process(dp):
    """``AudioLDM2Pipeline(..., mesh=)``: rank r's clip from its own row of
    the request is row r of one process's batch of 2."""

    pos, neg, fbank = W.generate_inputs(2)
    want = AudioLDM2Pipeline(tiny_pipeline_config(), W.tiny_modules()).generate(pos, neg, fbank, **W.GENERATE)
    got = np.concatenate([r["generate"] for r in dp.results()])
    assert got.shape == want.shape
    assert rel(got, want) <= TOL


def test_loader_ranks_split_the_global_batch(tmp_path):
    """``data_loader(..., rank, world=2)``: the two ranks' items are
    disjoint and together the single process's global batch, captions
    included; ``DeviceCollate(rank, world=2)`` keeps its rows of the global
    batch's dropout and pooling draws."""

    rng = np.random.default_rng(3)
    items = []
    for i in range(6):
        save_wav(str(tmp_path / f"c{i}.wav"), (0.2 * rng.standard_normal(3200)).astype(np.float32), 16000)
        items.append({"wav": f"c{i}.wav", "labels": ["violin", "piano", "harp"][i % 3]})
    (tmp_path / "m.json").write_text(json.dumps({"data": items}))

    def batches(rank, world, b):
        ds = AudioSetDataset(str(tmp_path / "m.json"), str(tmp_path), duration_s=0.2, seed=3)
        it = data_loader(ds, b, lambda examples: examples, seed=1, rank=rank, world=world)
        return [next(it) for _ in range(3)]           # three epochs of one global batch of 4

    whole = batches(0, 1, 4)
    split = [batches(r, 2, 2) for r in (0, 1)]
    for i, batch in enumerate(whole):
        got = split[0][i] + split[1][i]
        assert [c for c, _ in got] == [c for c, _ in batch]
        for (_, a), (_, b) in zip(got, batch):
            np.testing.assert_array_equal(a, b)
        assert not {w.tobytes() for _, w in split[0][i]} & {w.tobytes() for _, w in split[1][i]}

    # seed 1: the global batch's draws drop rank 1's rows (audio; text and
    # audio) and neither of rank 0's, which a per-rank draw would not repeat
    replay = random.Random(1)
    replay.choice((1, 2))
    assert [d < 0.15 for d in (replay.random() for _ in range(4))] == [False, False, True, True]
    mods = W.tiny_modules()
    examples = whole[0]
    kw = dict(duration_s=0.2, seed=1, pool_choices=(1, 2))
    want = DeviceCollate(mods, **kw)(examples)
    for r in (0, 1):
        got = DeviceCollate(mods, rank=r, world=2, **kw)(examples[2 * r: 2 * r + 2])
        for k, v in want.items():
            assert got[k].shape == v[2 * r: 2 * r + 2].shape, k
            torch.testing.assert_close(got[k], v[2 * r: 2 * r + 2], rtol=0, atol=TOL * max(v.abs().max(), 1))
