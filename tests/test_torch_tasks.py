"""PyTorch port: the SDEdit schedule, ``prepare_fbank`` and the task CLI
(``pipeline/tasks.py``), held against the JAX package at the tiny config
(fp32, CPU). The tiny SDEdit edit itself is held against the JAX one in
``test_torch_pipeline.py``, beside the generate path. Nothing here needs the
JAX tiny params: the CLI runs on random weights."""

import numpy as np
import pytest
import torch

from ap_adapter_tpu.configs import SchedulerConfig as JaxSchedulerConfig
from ap_adapter_tpu.configs import tiny_pipeline_config as jax_tiny_config
from ap_adapter_tpu.diffusion.sampling import sdedit_timesteps as jax_sdedit_timesteps
from ap_adapter_tpu.pipeline.pipeline import AudioLDM2Pipeline as JaxPipeline
from ap_adapter_torch.adapter.params import adapter_parameters, export_flat_adapter
from ap_adapter_torch.audio.io import load_wav, save_wav
from ap_adapter_torch.configs import SchedulerConfig, tiny_pipeline_config
from ap_adapter_torch.pipeline import tasks
from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline, PipelineModules
from ap_adapter_torch.pipeline.style_transfer import sdedit_timesteps
from tests.torch_port_common import one_torch_thread  # noqa: F401 (autouse fixture)


def test_sdedit_timesteps_match_jax():
    """The truncated schedule: the last steps - steps // 4 * 2 (26 of 50)."""

    got = sdedit_timesteps(50, SchedulerConfig())
    want = jax_sdedit_timesteps(JaxSchedulerConfig(), 50, 50 - 50 // 4 * 2)
    assert len(got) == 26
    np.testing.assert_array_equal(got, want)


def test_prepare_fbank_matches_jax():
    """Host resample (22.05 -> 16 kHz, two channels mixed) and Kaldi fbank."""

    wav = np.random.default_rng(2).standard_normal((2, 5000)).astype(np.float32) * 0.2
    want = JaxPipeline(jax_tiny_config(), {}).prepare_fbank(wav, 22050)
    got = AudioLDM2Pipeline(tiny_pipeline_config(), None).prepare_fbank(wav, 22050)
    assert got.shape == want.shape == (1, 64, 32) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=0)


@pytest.fixture
def source_wav(tmp_path):
    t = np.arange(4000) / 16000
    path = str(tmp_path / "source.wav")
    save_wav(path, (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32), 16000)
    return path


def test_cli_writes_reference_file_names(tmp_path, source_wav):
    """``main`` on the CPU at the tiny config: the SDEdit route and the
    generate route (here text only, without an audio prompt) write 16 kHz
    wavs under the reference's names (the prompt's first character, file
    index, ap scale, pooling)."""

    common = ["--tiny", "--random-weights", "--steps", "2", "--device", "cpu", "--audio-length", "0.2",
              "--time-pool", "2", "--freq-pool", "2"]
    out = tmp_path / "out"
    paths = tasks.main(["--task", "style_transfer", "--sdedit", "--prompt", "Jazz style music",
                        "--audio-prompt", source_wav, "--output-dir", str(out), *common])
    assert paths == [str(out / "J_0_ip0.55_t2_f2_sdedit.wav")]
    paths = tasks.main(["--task", "timbre_transfer", "--num-files", "2", "--output-dir", str(out), *common])
    assert paths == [str(out / f"a_{j}_ip0.5_t2_f2.wav") for _ in range(3) for j in range(2)]
    for p in set(paths) | {str(out / "J_0_ip0.55_t2_f2_sdedit.wav")}:
        wav, sr = load_wav(p)
        assert sr == 16000 and wav.shape == (3200,) and np.all(np.isfinite(wav))


def test_cli_refuses_what_is_not_ported(tmp_path, source_wav, monkeypatch):
    """``--tensor-parallel 2`` in a world of one process is refused (the
    served case is in ``test_torch_parallel.py``); a checkpoint's
    ``tokenizer/`` folder is loaded (``HFTokenizers``; the whole run is in
    ``test_torch_tokenize.py``); the flag and audio-prompt checks hold."""

    with pytest.raises(ValueError, match="world of 2 ranks"):
        tasks.main(["--tiny", "--device", "cpu", "--tensor-parallel", "2", "--output-dir", str(tmp_path)])
    (tmp_path / "ckpt" / "tokenizer").mkdir(parents=True)
    loaded = []

    class Loaded(Exception):
        pass

    def load(checkpoint_dir):
        loaded.append(checkpoint_dir)
        raise Loaded

    monkeypatch.setattr(tasks, "HFTokenizers", load)
    with pytest.raises(Loaded):
        tasks.main(["--tiny", "--device", "cpu", "--checkpoint-dir", str(tmp_path / "ckpt")])
    assert loaded == [str(tmp_path / "ckpt")]
    with pytest.raises(SystemExit):
        tasks.main(["--task", "timbre_transfer", "--sdedit", "--tiny", "--device", "cpu"])
    pipe = AudioLDM2Pipeline(tiny_pipeline_config(), PipelineModules(tiny_pipeline_config()).init_random(0, "cpu"))
    task = tasks.get_task_config("style_transfer", output_dir=str(tmp_path))
    with pytest.raises(ValueError, match="--audio-prompt"):
        tasks.run_sdedit_task(task, pipe)


@pytest.mark.parametrize("fmt", ["npz", "bin"])
def test_adapter_checkpoint_lands_on_the_unet(tmp_path, fmt):
    """``load_pipeline(adapter_ckpt=...)`` copies a flat adapter (ours or the
    reference's torch .bin) into the UNet's own tensors: its device and
    dtype, bf16 here."""

    flat = export_flat_adapter(PipelineModules(tiny_pipeline_config()).init_random(7, device="cpu").unet)
    path = str(tmp_path / f"adapter.{fmt}")
    if fmt == "npz":
        np.savez(path, **flat)
    else:
        torch.save({k.replace(".processor.", "."): torch.from_numpy(v) for k, v in flat.items()}, path)
    pipe = tasks.load_pipeline(tiny_pipeline_config(torch.bfloat16), adapter_ckpt=path, device="cpu")
    params = adapter_parameters(pipe.modules.unet)
    assert set(params) == set(flat)
    for k, p in params.items():
        assert p.dtype == torch.bfloat16 and p.device.type == "cpu"
        torch.testing.assert_close(p, torch.from_numpy(flat[k]).to(torch.bfloat16), rtol=0, atol=0)
