"""The port's checkpoint converter (``ap_adapter_torch/convert/cli.py``)
against the JAX package's on the same synthetic AudioLDM2 directory.

The directory is the JAX end-to-end test's (``tests/test_convert_e2e.py::
write_checkpoint_dir``: real transformers instances for CLAP, T5, GPT-2 and
the vocoder, an independent enumeration of the diffusers names for the UNet,
the VAE and the projection). Beside it: a reference-format adapter ``.bin``
and an AudioMAE ``pretrained.pth`` at the published depth and token grid,
narrow (32 wide), with its decoder and ``pos_embed``. The JAX converter's
params are carried into the port's keys by ``from_jax.pipeline_state_dicts``
and must equal the port's bit for bit. No JAX function is compiled.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from ap_adapter_torch import configs
from ap_adapter_torch.adapter.params import adapter_sites
from ap_adapter_torch.convert import cli, from_jax
from ap_adapter_torch.models.audiomae import AudioMAECondition
from ap_adapter_torch.models.layers import audiomae_pos_embed
from ap_adapter_torch.models.mae_pretrain import MAEPretrain
from ap_adapter_torch.pipeline import tasks
from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline, PipelineModules
from ap_adapter_torch.pipeline.tokenize import make_text_batch
from tests.test_convert_e2e import write_checkpoint_dir
from tests.torch_port_common import one_torch_thread  # noqa: F401 (autouse fixture)

MAE = configs.AudioMAEConfig(embed_dim=32, num_heads=2)   # the published depth and grid, narrow
SUBDIRS = {name: sub for name, sub, _ in cli.SUBMODELS if sub}


def _bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def audiomae_checkpoint(rng) -> dict:
    """The reference MAE's flat keys at ``MAE``: encoder, decoder and the
    two fixed sin-cos tables it stores as parameters."""

    with torch.device("meta"):
        names = MAEPretrain(MAE).state_dict()
    sd = {k: torch.from_numpy((rng.standard_normal(v.shape) * 0.02).astype(np.float32)) for k, v in names.items()}
    t, f = MAE.grid_size
    sd["pos_embed"] = torch.from_numpy(audiomae_pos_embed(MAE.embed_dim, (f, t))[None].copy())
    sd["decoder_pos_embed"] = torch.from_numpy(audiomae_pos_embed(MAE.decoder_embed_dim, (f, t))[None].copy())
    return sd


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    """(root, source directory, adapter .bin, AudioMAE .pth, port config)."""

    os.environ.setdefault("USE_TF", "0")     # transformers would import tensorflow first: 6 s
    root = tmp_path_factory.mktemp("convert")
    d = str(root / "audioldm2")
    write_checkpoint_dir(d)
    cfg = cli.build_config(d)
    rng = np.random.default_rng(1)
    with torch.device("meta"):
        unet = PipelineModules(cfg).unet.state_dict()
    adapter = {}
    for site in adapter_sites(cfg.unet):
        for name, of in (("to_k_ip", "to_k"), ("to_v_ip", "to_v")):
            shape = unet[f"{site}.{of}.weight"].shape
            adapter[f"{site}.processor.{name}.weight"] = torch.from_numpy(
                (rng.standard_normal(shape) * 0.02).astype(np.float32))
    adapter_path = str(root / "pytorch_model.bin")
    torch.save(adapter, adapter_path)
    mae_path = str(root / "pretrained.pth")
    torch.save({"model": audiomae_checkpoint(rng)}, mae_path)
    return root, d, adapter_path, mae_path, cfg


@pytest.fixture(scope="module")
def sources(src):
    """Every source state dict in memory (fp32 numpy), keyed by the port's
    submodel name, and the adapter's under ``adapter``."""

    _, d, adapter_path, mae_path, _ = src
    out = {name: cli.load_torch_weights(os.path.join(d, sub), *cli.WEIGHT_NAMES) for name, sub in SUBDIRS.items()}
    out["audiomae"] = cli.load_torch_weights(mae_path)
    out["adapter"] = cli.load_torch_weights(adapter_path)
    return out


@pytest.fixture(scope="module")
def jax_converted(src):
    """``(source directory, adapter .bin or None) ->`` the JAX converter's
    output (with the AudioMAE checkpoint), read back and carried into the
    port's keys; each conversion made once."""

    from ap_adapter_tpu.convert.cli import build_config, convert
    from ap_adapter_tpu.utils.checkpoint import load_params

    done = {}

    def get(src_dir: str, adapter_ckpt=None) -> dict:
        if (src_dir, adapter_ckpt) not in done:
            out_dir = str(src[0] / f"jax_{len(done)}")
            convert(src_dir, out_dir, src[3], adapter_ckpt)
            done[src_dir, adapter_ckpt] = from_jax.pipeline_state_dicts(load_params(out_dir), build_config(src_dir))
        return {name: dict(sd) for name, sd in done[src_dir, adapter_ckpt].items()}

    return get


def read_npz_dir(directory: str) -> dict:
    out = {}
    for fn in os.listdir(directory):
        if fn.endswith(".npz"):
            with np.load(os.path.join(directory, fn)) as f:
                out[fn[:-4]] = {k: f[k] for k in f.files}
    return out


# -- (a) the config ----------------------------------------------------------------


@pytest.mark.parametrize("part", ["unet", "vae", "vocoder", "scheduler", "clap", "t5", "gpt2", "projection",
                                  "audiomae", "fbank", "mel"])
def test_build_config_matches_jax(src, part):
    """Every field the two packages share, equal; none of the fields the
    JAX ``build_config`` sets is missing from the port's."""

    from ap_adapter_tpu.convert.cli import build_config

    ours = dataclasses.asdict(getattr(src[4], part))
    theirs = dataclasses.asdict(getattr(build_config(src[1]), part))
    shared = set(ours) & set(theirs)
    assert set(theirs) - shared <= {"use_weight_prep", "scan_unroll"}
    for k in sorted(shared):
        assert ours[k] == theirs[k], (part, k, ours[k], theirs[k])


# -- (b) bit for bit against the JAX converter ------------------------------------


@pytest.mark.parametrize("unet", ["as_written", "with_adapter_bin", "published_no_adapter_keys"])
def test_convert_matches_jax(src, jax_converted, tmp_path, unet):
    """The port's npz files equal the JAX converter's params carried across,
    key for key and bit for bit; only the vocoder's ``mean``/``scale``, which
    the port holds only with ``normalize_before``, are not written."""

    _, d, adapter_path, mae_path, cfg = src
    adapter = adapter_path if unet == "with_adapter_bin" else None
    if unet == "published_no_adapter_keys":     # the published UNet: no to_k_ip/to_v_ip anywhere
        d2 = str(tmp_path / "published")
        shutil.copytree(d, d2)
        path = os.path.join(d2, "unet", "diffusion_pytorch_model.bin")
        sd = torch.load(path, weights_only=True)
        torch.save({k: v for k, v in sd.items() if ".processor." not in k}, path)
        d = d2
    cli.convert(d, str(tmp_path / "ours"), mae_path, adapter)
    ours = read_npz_dir(str(tmp_path / "ours"))
    theirs = jax_converted(d, adapter)
    assert set(ours) == set(theirs) == set(PipelineModules.NAMES)
    for name in PipelineModules.NAMES:
        dropped = {"mean", "scale"} if name == "vocoder" else set()
        assert set(ours[name]) == set(theirs[name]) - dropped, name
        for k, v in ours[name].items():
            assert _bits_equal(v, theirs[name][k]), (name, k)
    sites = adapter_sites(cfg.unet)
    k_ip = ours["unet"][f"{sites[0]}.processor.to_k_ip.weight"]
    if unet == "published_no_adapter_keys":
        assert _bits_equal(k_ip, ours["unet"][f"{sites[0]}.to_k.weight"])
    elif unet == "with_adapter_bin":
        assert _bits_equal(k_ip, cli.load_torch_weights(adapter_path)[f"{sites[0]}.processor.to_k_ip.weight"])


def test_adapter_keys_with_or_without_processor(src, sources):
    """The reference writes the adapter's keys with and without
    ``.processor``; both merge into the same UNet."""

    cfg = src[4]
    bare = {k.replace(".processor.", "."): v for k, v in sources["adapter"].items()}
    with_proc = cli.unet_state_dict(sources["unet"], cfg, sources["adapter"])
    without = cli.unet_state_dict(sources["unet"], cfg, bare)
    assert set(with_proc) == set(without)
    assert all(_bits_equal(with_proc[k], without[k]) for k in with_proc)
    assert all(_bits_equal(with_proc[k], v) for k, v in sources["adapter"].items())


# -- (c) inventories the JAX test does not build ------------------------------------


@pytest.mark.parametrize("form", ["ClapModel", "ClapTextModel"])
def test_clap_inventories_convert(src, sources, form):
    """A whole ``ClapModel`` (its audio branch, logit scales and buffers
    dropped), and a bare ``ClapTextModel`` with the projection beside it,
    give the text branch's keys and values."""

    from transformers import ClapConfig, ClapModel

    cfg = src[4]
    want = cli.expected_keys(cfg)["clap"]
    if form == "ClapModel":
        torch.manual_seed(0)
        c = cfg.clap
        model = ClapModel(ClapConfig(
            text_config=dict(vocab_size=c.vocab_size, hidden_size=c.hidden_size, num_hidden_layers=c.num_layers,
                             num_attention_heads=c.num_heads, intermediate_size=c.intermediate_size,
                             max_position_embeddings=c.max_position_embeddings),
            audio_config=dict(spec_size=64, num_mel_bins=16, window_size=4, depths=[1, 1],
                              num_attention_heads=[1, 2], patch_embeds_hidden_size=8, hidden_size=16),
            projection_dim=c.projection_dim))
        sd = {k: v.float().numpy() for k, v in model.state_dict().items()}
        assert sum(not k.startswith(("text_model.", "text_projection.")) for k in sd) > 50
    else:
        sd = {k[len("text_model."):] if k.startswith("text_model.") else k: v
              for k, v in sources["clap"].items()}
    out = cli.clap_state_dict(sd, cfg)
    cli.check_keys("clap", out, want)
    for k, v in out.items():
        src_key = k if form == "ClapModel" or k.startswith("text_projection.") else k[len("text_model."):]
        assert _bits_equal(v, sd[src_key]), k
    PipelineModules(cfg).clap.to_empty(device="cpu").load_state_dict(
        {k: torch.from_numpy(v) for k, v in out.items()}, strict=True)


@pytest.mark.parametrize("form", ["model_nesting", "bare", "audiomae.model.", "model."])
def test_audiomae_forms_convert(src, sources, tmp_path, form):
    """``{'model': ...}``, the bare dict, the reference's ``audiomae.model.``
    prefix and the port's ``model.`` give the same conditioner keys; the
    decoder and the sin-cos tables are dropped."""

    cfg = src[4]
    flat = {k: torch.from_numpy(v) for k, v in sources["audiomae"].items()}
    if form == "model_nesting":
        path = src[3]
    else:
        path = str(tmp_path / "pretrained.pth")
        prefix = "" if form == "bare" else form
        torch.save({prefix + k: v for k, v in flat.items()}, path)
    out = cli.audiomae_state_dict(cli.load_torch_weights(path), cfg)
    cli.check_keys("audiomae", out, cli.expected_keys(cfg)["audiomae"])
    assert all(_bits_equal(v, sources["audiomae"][k[len("model."):]]) for k, v in out.items())
    AudioMAECondition(MAE).load_state_dict({k: torch.from_numpy(v) for k, v in out.items()}, strict=True)


@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16"])
def test_safetensors_submodel_converts(src, sources, tmp_path, dtype):
    """T5 as ``model.safetensors`` (written by the ``safetensors`` package;
    the tied embedding left out, as transformers writes it) reads through the
    port's reader into the values of the source rounded to that type."""

    from safetensors.torch import load_file, save_file

    cfg = src[4]
    tdtype = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}[dtype]
    d = tmp_path / "text_encoder_2"
    d.mkdir()
    tensors = {k: torch.from_numpy(v).to(tdtype) for k, v in sources["t5"].items()
               if k != "encoder.embed_tokens.weight"}
    tensors["position_ids"] = torch.arange(7, dtype=torch.int64)[None]   # an integer buffer rides along
    save_file(tensors, str(d / "model.safetensors"), metadata={"format": "pt"})
    raw = cli.read_safetensors(str(d / "model.safetensors"))
    lib = load_file(str(d / "model.safetensors"))
    assert set(raw) == set(lib) and all(raw[k].dtype == lib[k].dtype and torch.equal(raw[k], lib[k]) for k in lib)
    sd = cli.load_torch_weights(str(d), *cli.WEIGHT_NAMES)
    assert sd.pop("position_ids").tolist() == [list(range(7))]
    out = cli.t5_state_dict(sd, cfg)
    cli.check_keys("t5", out, cli.expected_keys(cfg)["t5"])
    for k, v in out.items():
        assert _bits_equal(v, sources["t5"][k].astype(np.float32) if dtype == "F32"
                           else torch.from_numpy(sources["t5"][k]).to(tdtype).float().numpy()), k


# -- (d) what is not mapped raises ----------------------------------------------------


@pytest.mark.parametrize("source", list(SUBDIRS) + ["audiomae", "adapter"])
def test_stray_key_raises(src, sources, source):
    """One stray key in any source raises, naming it."""

    cfg = src[4]
    mappings = {name: mapping for name, _, mapping in cli.SUBMODELS}
    want = cli.expected_keys(cfg)
    stray = {"stray_layer.weight": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="stray_layer.weight"):
        if source == "adapter":
            cli.unet_state_dict(sources["unet"], cfg, {**sources["adapter"], **stray})
        else:
            name = source
            out = mappings[name]({**sources[name], **stray}, cfg)
            cli.check_keys(name, out, want[name])


@pytest.mark.parametrize("case", ["t5_untied_embedding", "audiomae_learned_pos_embed"])
def test_dropped_keys_are_checked_by_value(src, sources, case):
    """A key is dropped only where it is what the port computes or ties: an
    ``embed_tokens`` that differs from ``shared``, or a ``pos_embed`` that is
    not the sin-cos table, raises."""

    cfg = src[4]
    if case == "t5_untied_embedding":
        sd = dict(sources["t5"])
        sd["encoder.embed_tokens.weight"] = sd["shared.weight"] + 1e-3
        with pytest.raises(ValueError, match="embed_tokens"):
            cli.t5_state_dict(sd, cfg)
    else:
        sd = dict(sources["audiomae"])
        sd["pos_embed"] = sd["pos_embed"] + 1e-3
        with pytest.raises(ValueError, match="sin-cos"):
            cli.audiomae_state_dict(sd, cfg)


# -- (e) serving from the converted directory -------------------------------------------


def test_generate_from_converted_dir_is_bit_equal(src, jax_converted, tmp_path):
    """``tasks.load_pipeline`` on the converted directory (fp32, CPU): a
    2-step edit bit-equal to one on the JAX converter's state dicts loaded
    directly. The config is ``build_config``'s (its VAE scaling factor is not
    the tiny config's) with the narrow AudioMAE."""

    _, d, adapter_path, mae_path, cfg = src
    out = str(tmp_path / "converted")
    cli.convert(d, out, mae_path, adapter_path)
    cfg = cfg.replace(audiomae=MAE, dtype=torch.float32)
    direct = jax_converted(d, adapter_path)
    del direct["vocoder"]["mean"], direct["vocoder"]["scale"]
    pipes = [tasks.load_pipeline(cfg, checkpoint_dir=out, device="cpu"),
             AudioLDM2Pipeline(cfg, PipelineModules(cfg).load_state_dicts(direct, device="cpu"))]
    pos = make_text_batch(cfg, ["piano"], clap_len=16, t5_len=8)
    neg = make_text_batch(cfg, [""], clap_len=16, t5_len=8)
    fbank = np.random.default_rng(0).standard_normal((1, *MAE.img_size)).astype(np.float32)
    wavs = [p.generate(pos, neg, fbank, audio_length_in_s=0.2, num_inference_steps=2, seed=0) for p in pipes]
    assert wavs[0].shape == (1, 3200) and np.all(np.isfinite(wavs[0])) and wavs[0].std() > 0
    assert _bits_equal(np.asarray(wavs[0]), np.asarray(wavs[1]))


# -- (f) the CLI ------------------------------------------------------------------------


@pytest.mark.parametrize("with_audiomae", [True, False])
def test_main_writes_the_checkpoint_dir(src, tmp_path, capsys, with_audiomae):
    """``main`` writes one npz per submodel (``audiomae.npz`` only with
    ``--audiomae-ckpt``, as the JAX CLI writes no ``audiomae.msgpack``
    without it) and ``config.json``, ``dtype`` null."""

    _, d, adapter_path, mae_path, cfg = src
    out = str(tmp_path / "out")
    argv = ["--audioldm2-dir", d, "--adapter-ckpt", adapter_path, "--out", out]
    cli.main(argv + (["--audiomae-ckpt", mae_path] if with_audiomae else []))
    names = set(PipelineModules.NAMES) - (set() if with_audiomae else {"audiomae"})
    assert set(os.listdir(out)) == {f"{n}.npz" for n in names} | {"config.json"}
    assert capsys.readouterr().out.strip() == f"converted -> {out}"
    with open(os.path.join(out, "config.json")) as f:
        written = json.load(f)
    assert written["dtype"] is None
    assert written == json.loads(json.dumps(dataclasses.asdict(cfg.replace(dtype=None)), default=str))
    if not with_audiomae:
        with pytest.raises(FileNotFoundError, match="--audiomae-ckpt"):
            tasks.load_pipeline(cfg, checkpoint_dir=out, device="cpu")


# -- the smoke's public-layout writer (phase 24 of chip_smoke.py) ----------------------


def test_smoke_config_writer_inverts_build_config(tmp_path):
    """``chip_smoke.audioldm2_configs`` writes the per-submodel config.json
    from which ``build_config`` gives back ``PipelineConfig()``."""

    import chip_smoke

    for (sub, name), obj in chip_smoke.audioldm2_configs(configs.PipelineConfig()).items():
        (tmp_path / sub).mkdir(exist_ok=True)
        (tmp_path / sub / name).write_text(json.dumps(obj))
    assert cli.build_config(str(tmp_path)) == configs.PipelineConfig()


def test_smoke_public_layout_converts_back(tmp_path):
    """Tiny bf16 weights through ``chip_smoke.write_audioldm2_dir`` (the HF
    extras, the UNet as a BF16 ``.safetensors`` without adapter keys, the
    adapter ``.bin``) and the converter come back bit for bit. The AudioMAE
    checkpoint is left out: the converter takes the published geometry,
    not the tiny one."""

    import chip_smoke

    cfg = configs.tiny_pipeline_config(torch.bfloat16)
    mods = PipelineModules(cfg).init_random(0, device="cpu", dtype=torch.bfloat16)
    paths = chip_smoke.write_audioldm2_dir(str(tmp_path / "src"), mods)
    cli.convert(paths["audioldm2_dir"], str(tmp_path / "out"), adapter_ckpt=paths["adapter"])
    got = read_npz_dir(str(tmp_path / "out"))
    assert set(got) == set(PipelineModules.NAMES) - {"audiomae"}
    for name, sd in got.items():
        own = getattr(mods, name).state_dict()
        assert set(sd) == set(own), name
        assert all(_bits_equal(v, own[k].float().numpy()) for k, v in sd.items()), name
    mae = cli.audiomae_state_dict(cli.load_torch_weights(paths["audiomae"]), cfg)
    assert all(_bits_equal(v, mods.audiomae.state_dict()[k].float().numpy()) for k, v in mae.items())
