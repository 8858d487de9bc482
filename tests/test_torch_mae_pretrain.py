"""The port's AudioMAE pretraining stack (``models/mae_pretrain.py``,
``AudioMAEEncoder.masked``/``contextual``) on the CPU in fp32.

Oracles: the framework-free fixtures ``tests/golden/mae_pretrain.npz`` (the
reference's own ``models_mae.py`` forward_encoder/forward_decoder/
forward_loss) and ``audiomae.npz``'s ``want_ctx`` (its
``forward_encoder_no_mask``); the JAX package's masking functions, which
are jnp functions of one ``jax.random`` draw (no model), fed the same noise;
and ``torch_import`` for the weight layout. No JAX model is built here.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from ap_adapter_tpu.convert import torch_import
from ap_adapter_tpu.models import mae_pretrain as jmae
from ap_adapter_torch import configs
from ap_adapter_torch.convert import from_jax
from ap_adapter_torch.models.audiomae import AudioMAEEncoder
from ap_adapter_torch.models.mae_pretrain import (
    MAEPretrain, ViTClassifier, make_mae_pretrain_step, mae_pretrain_loss, masking_plan, masking_plan_2d,
    patchify, random_masking, random_masking_2d, reconstruction_loss, unpatchify)
from tests.test_torch_golden import ENCODER_TOL, build, check, load, t
from tests.torch_port_common import one_torch_thread  # noqa: F401 (autouse fixture)

TINY = configs.AudioMAEConfig(img_size=(64, 32), patch_size=16, embed_dim=32, depth=2, num_heads=2,
                              decoder_embed_dim=16, decoder_depth=1, decoder_num_heads=2)


def _golden_model():
    tree, d = load("mae_pretrain")
    cfg = configs.AudioMAEConfig(**d["config"])
    return tree, d, cfg, build(MAEPretrain(cfg), from_jax.mae_pretrain_state_dict(tree, cfg.depth,
                                                                                   cfg.decoder_depth))


@torch.no_grad()
def test_golden_pretrain_pred_and_loss():
    """Same weights and mask plan: the predictions and the masked loss of the
    reference's models_mae.py (the JAX test's atol 2e-4 and rtol 1e-4)."""

    _, d, cfg, model = _golden_model()
    len_keep = d["ids_keep"].shape[1]
    np.testing.assert_array_equal(d["mask"], (d["ids_restore"] >= len_keep).astype(np.float32))
    pred = model(t(d["fbank"]), t(d["ids_keep"]), t(d["ids_restore"]))
    check(pred, d["want_pred"], dict(rtol=0, atol=2e-4), what="pred")
    loss = reconstruction_loss(t(d["fbank"]), pred, t(d["mask"]), cfg.patch_size)
    assert loss.dtype == torch.float32
    assert loss.item() == pytest.approx(float(d["want_loss"]), rel=1e-4)


@torch.no_grad()
def test_golden_audiomae_contextual():
    """The contextual-average path (mean of the normed activations after the
    blocks past ``contextual_depth``) against ``forward_encoder_no_mask``."""

    tree, d = load("audiomae")
    cfg = configs.AudioMAEConfig(**d["config"])
    sd = from_jax.audiomae_condition_state_dict(tree, cfg.depth)
    enc = build(AudioMAEEncoder(cfg), {k[len("model."):]: v for k, v in sd.items()})
    check(enc.contextual(t(d["fbank"])), d["want_ctx"], ENCODER_TOL, what="ctx")


def test_from_jax_pretrain_roundtrip():
    """The port's MAEPretrain state dict, through torch_import.
    audiomae_pretrain_params, is the fixture's JAX tree bit for bit."""

    tree, _, cfg, model = _golden_model()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = torch_import.audiomae_pretrain_params(sd, depth=cfg.depth, decoder_depth=cfg.decoder_depth)
    _tree_equal(back, tree)


@pytest.mark.parametrize("global_pool", [True, False])
def test_from_jax_classifier_roundtrip(global_pool):
    """A classifier tree in the JAX layout (random values) loads strictly
    into ViTClassifier and comes back through torch_import's encoder,
    LayerNorm and Dense converters bit for bit."""

    rng = np.random.default_rng(3)
    model = ViTClassifier(TINY, num_classes=7, global_pool=global_pool)
    tree = {"patch_embed": {"kernel": rng.standard_normal((16, 16, 1, 32), np.float32),
                            "bias": rng.standard_normal(32, np.float32)},
            "cls_token": rng.standard_normal((1, 1, 32), np.float32),
            "head": {"kernel": rng.standard_normal((32, 7), np.float32), "bias": rng.standard_normal(7, np.float32)},
            ("fc_norm" if global_pool else "norm"): {"scale": rng.standard_normal(32, np.float32),
                                                     "bias": rng.standard_normal(32, np.float32)}}
    for i in range(TINY.depth):
        dense = lambda n, m: {"kernel": rng.standard_normal((n, m), np.float32),  # noqa: E731
                              "bias": rng.standard_normal(m, np.float32)}
        norm = lambda: {"scale": rng.standard_normal(32, np.float32), "bias": rng.standard_normal(32, np.float32)}  # noqa: E731
        tree[f"block_{i}"] = {"norm1": norm(), "attn": {"qkv": dense(32, 96), "proj": dense(32, 32)}, "norm2": norm(),
                              "fc1": dense(32, 128), "fc2": dense(128, 32)}
    build(model, from_jax.vit_classifier_state_dict(tree, TINY.depth))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    if global_pool:   # torch_import reads a final norm; the pooled classifier has fc_norm in its place
        sd = {**sd, "norm.weight": sd["fc_norm.weight"], "norm.bias": sd["fc_norm.bias"]}
    back = torch_import.audiomae_encoder_params(sd, depth=TINY.depth)
    back["head"] = torch_import.t_linear(sd, "head")
    if global_pool:
        back["fc_norm"] = back.pop("norm")
    _tree_equal(back, tree)


def _tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _tree_equal(got[k], want[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


# -- masking plans from JAX's noise ---------------------------------------------


def _ties(noise):
    return np.floor(np.asarray(noise) * 4.0) / 4.0     # four values: many equal keys, for the sorts' stability


@pytest.mark.parametrize("b, n, ratio, quantize", [(3, 20, 0.75, False), (2, 512, 0.8, False),
                                                   (4, 16, 0.5, True)])
def test_masking_plan_matches_jax(monkeypatch, b, n, ratio, quantize):
    """``masking_plan`` of the noise that ``jax.random.uniform`` draws for
    the JAX ``random_masking`` gives its plan exactly (``quantize``: the
    noise cut to four values, the same for both, so the stable sorts decide)."""

    key = jax.random.PRNGKey(n)
    if quantize:
        uniform = jax.random.uniform
        monkeypatch.setattr(jax.random, "uniform", lambda *a, **k: _ties(uniform(*a, **k)))
    noise = np.asarray(jax.random.uniform(key, (b, n)))
    want = jmae.random_masking(key, b, n, ratio)
    got = masking_plan(torch.tensor(noise), ratio)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("grid, pt, pf, quantize", [((8, 4), 0.5, 0.25, False), ((64, 8), 0.6, 0.5, False),
                                                    ((8, 8), 0.5, 0.5, True)])
def test_masking_plan_2d_matches_jax(monkeypatch, grid, pt, pf, quantize):
    """``masking_plan_2d`` of the row and column noise of the JAX
    ``random_masking_2d`` (one split of the key) gives its plan exactly,
    the 2-D key trick included."""

    key = jax.random.PRNGKey(grid[0] + 1)
    if quantize:
        uniform = jax.random.uniform
        monkeypatch.setattr(jax.random, "uniform", lambda *a, **k: _ties(uniform(*a, **k)))
    rt, rf = jax.random.split(key)
    nt, nf = (np.asarray(jax.random.uniform(k, (2, s))) for k, s in ((rt, grid[0]), (rf, grid[1])))
    want = jmae.random_masking_2d(key, 2, grid, pt, pf)
    got = masking_plan_2d(torch.tensor(nt), torch.tensor(nf), pt, pf)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_random_masking_draws_from_the_generator():
    """The same generator state gives the same plan; the 2-D plan keeps whole
    rows and columns, kept tokens in ascending order."""

    a = random_masking(torch.Generator().manual_seed(5), 2, 40, 0.75)
    b = random_masking(torch.Generator().manual_seed(5), 2, 40, 0.75)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a[0].shape == (2, 10) and a[1].sum().item() == 60
    ids_keep, mask, ids_restore = random_masking_2d(torch.Generator().manual_seed(1), 2, (8, 4), 0.5, 0.25)
    assert ids_keep.shape == (2, 4 * 3)
    assert torch.equal(ids_keep, ids_keep.sort(dim=1).values)
    m = mask.reshape(2, 8, 4)
    for i in range(2):
        rows, cols = (m[i] == 0).any(dim=1), (m[i] == 0).any(dim=0)
        assert torch.equal(m[i] == 0, rows[:, None] & cols[None, :])
    assert torch.equal(torch.gather(ids_restore, 1, ids_restore.argsort(dim=1)), torch.arange(32).expand(2, -1))


# -- patches, loss, step --------------------------------------------------------


def test_patchify_and_norm_pix_loss():
    """patchify/unpatchify are inverse; the patch order is the encoder's
    token order; norm_pix_loss normalises each target patch by its own
    population mean and variance."""

    g = torch.Generator().manual_seed(0)
    fbank = torch.randn(2, 64, 32, generator=g)
    p = patchify(fbank, 16)
    assert p.shape == (2, 8, 256)
    assert torch.equal(unpatchify(p, (4, 2), 16), fbank)
    assert torch.equal(p[0, 3], fbank[0, 16:32, 16:32].reshape(-1))     # token (1, 1) of the (4, 2) grid
    pred, mask = torch.randn(2, 8, 256, generator=g), torch.tensor([[1.0] * 6 + [0.0] * 2] * 2)
    tgt = p.double()
    tgt = (tgt - tgt.mean(-1, keepdim=True)) / torch.sqrt(tgt.var(-1, unbiased=False, keepdim=True) + 1e-6)
    want = (((pred.double() - tgt) ** 2).mean(-1) * mask).sum() / mask.sum()
    got = reconstruction_loss(fbank, pred, mask, 16, norm_pix_loss=True)
    assert got.item() == pytest.approx(want.item(), rel=1e-6)


@pytest.mark.parametrize("mask_2d", [False, True])
def test_pretrain_step_moves_weights(mask_2d):
    """make_mae_pretrain_step: the loss it returns is ``mae_pretrain_loss``
    at the same generator state, finite, and every weight that the loss
    reaches moves."""

    torch.manual_seed(0)
    model = MAEPretrain(TINY)
    fbank = torch.randn(3, 64, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = mae_pretrain_loss(model, fbank, torch.Generator().manual_seed(7), mask_2d=mask_2d)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_mae_pretrain_step(model, torch.optim.AdamW(model.parameters(), lr=1e-3), mask_2d=mask_2d)
    gen = torch.Generator().manual_seed(7)
    losses = [step(fbank, gen).item() for _ in range(3)]
    assert losses[0] == want.item() and all(np.isfinite(losses))
    moved = [k for k, v in model.state_dict().items() if not torch.equal(v, before[k])]
    assert set(moved) == set(before)


@torch.no_grad()
@pytest.mark.parametrize("global_pool", [True, False])
def test_classifier_paths(global_pool):
    """The classifier's two poolings and its masked path, against the
    encoder's own computations on the same weights: the final-norm CLS token
    (pooling off), fc_norm over the mean of the patch tokens (pooling on),
    and ``AudioMAEEncoder.masked`` for an ``ids_keep`` plan."""

    torch.manual_seed(2)
    clf = ViTClassifier(TINY, num_classes=7, global_pool=global_pool).eval()
    enc = AudioMAEEncoder(TINY)
    enc.load_state_dict({k: v for k, v in clf.state_dict().items() if not k.startswith(("head", "fc_norm"))},
                        strict=not global_pool)
    fbank = torch.randn(2, 64, 32, generator=torch.Generator().manual_seed(3))
    ids_keep = random_masking_2d(torch.Generator().manual_seed(4), 2, TINY.grid_size, 0.5, 0.5)[0]

    def pre_norm(ids=None):
        x, cls = enc.patch_tokens(fbank)
        if ids is not None:
            x = torch.gather(x, 1, ids[..., None].expand(-1, -1, x.shape[-1]))
        x = torch.cat([cls, x], dim=1)
        for blk in enc.blocks:
            x = blk(x)
        return x

    for ids in (None, ids_keep):
        got = clf(fbank, ids)
        assert got.shape == (2, 7)
        if global_pool:
            want = clf.head(clf.fc_norm(pre_norm(ids)[:, 1:].mean(dim=1)))
        else:
            want = clf.head((enc(fbank) if ids is None else enc.masked(fbank, ids))[:, 0])
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
