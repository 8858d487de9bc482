"""Validation sampling (``train/validation.py``) on the CPU at the tiny
config, 2 DDIM steps and 0.2 s clips: the files of a round, the draws in the
JAX package's order (clip indices, then the pooling rate, then the
generate's seed, from one ``random.Random(seed)``), and the waveform against
the port's own ``generate`` with that seed and the adapter in the compute
dtype. No JAX model runs here.
"""

from __future__ import annotations

import copy
import random

import numpy as np
import torch
from scipy.io import wavfile

from ap_adapter_torch.adapter.params import adapter_parameters
from ap_adapter_torch.audio.fbank import audiomae_fbank
from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline
from ap_adapter_torch.pipeline.tokenize import make_text_batch
from ap_adapter_torch.train import trainer
from ap_adapter_torch.train.data import POOL_CHOICES
from ap_adapter_torch.train.validation import make_validation_fn
from tests.torch_port_common import one_torch_thread, port_tiny  # noqa: F401 (autouse fixture)

STEPS, SECONDS, SEED = 2, 0.2, 11


def _clips(n=5):
    rng = np.random.default_rng(1)
    return [(f"caption {i}", (0.2 * rng.standard_normal(4000)).astype(np.float32)) for i in range(n)]


def _draws(seed, n_clips, n, grid, rounds):
    """The JAX package's draws (train/validation.py:63-68, 90) for each round."""

    rng = random.Random(seed)
    out = []
    for _ in range(rounds):
        picks = [rng.randrange(n_clips) for _ in range(n)]
        pool = rng.choice([p for p in POOL_CHOICES if grid[0] % p == 0 and grid[1] % p == 0])
        out.append((picks, pool, rng.randrange(2**31)))
    return out


def test_validation_round_files_draws_and_waveform(tmp_path):
    """Two rounds in bf16 on a trainer-style UNet (fp32 adapter parameters
    with gradients and AdamW state): the files of each round; each wav the
    port's ``generate`` of the drawn clips, pool and seed with the adapter
    cast to bf16 (bit for bit); the fp32 adapter, its gradients and the
    optimizer state unchanged by the rounds."""

    clips = _clips()
    mods = copy.deepcopy(port_tiny()).to(dtype=torch.bfloat16)
    ref = copy.deepcopy(mods)                 # the same UNet with bf16 adapter matrices
    adapter = trainer.split_unet_params(mods.unet)
    opt = trainer.make_optimizer(trainer.TrainConfig(use_8bit_adam=True), adapter.values())
    for p in adapter.values():
        p.grad = torch.full_like(p, 1e-3)
    opt.step()
    before = {k: (p.detach().clone(), p.grad.clone()) for k, p in adapter.items()}
    state_before = copy.deepcopy(opt.state_dict())
    for k, p in adapter_parameters(ref.unet).items():
        with torch.no_grad():
            p.copy_(adapter[k].to(p.dtype))

    c = mods.config
    fn = make_validation_fn(mods, clips, str(tmp_path), num_inference_steps=STEPS, audio_length_in_s=SECONDS,
                            seed=SEED, num_files=2)
    paths = [fn(7), fn(14)]
    draws = _draws(SEED, len(clips), 2, c.audiomae.grid_size, 2)

    pipe = AudioLDM2Pipeline(c, ref)
    samples = int(SECONDS * c.vocoder.sampling_rate)
    for step, path, (picks, pool, seed) in zip((7, 14), paths, draws):
        assert path == str(tmp_path / "validation" / f"step{step}_pool{pool}.wav")
        names = {f"step{step}_pool{pool}.wav", f"step{step}_pool{pool}_1.wav", f"step{step}_original.wav",
                 f"step{step}_original_1.wav", f"step{step}_caption.txt"}
        assert names <= {p.name for p in (tmp_path / "validation").iterdir()}
        captions = [clips[i][0] for i in picks]
        assert (tmp_path / "validation" / f"step{step}_caption.txt").read_text() == (
            "\n".join(captions) + f"\n(pool={pool})\n")
        fbank = audiomae_fbank(torch.as_tensor(np.stack([clips[i][1] for i in picks])), c.fbank)
        want = pipe.generate(make_text_batch(c, captions), make_text_batch(c, ["low quality, average quality"] * 2),
                             fbank, audio_length_in_s=SECONDS, num_inference_steps=STEPS, time_pool=pool,
                             freq_pool=pool, seed=seed)
        assert want.shape == (2, samples) and np.isfinite(want).all()
        for i, suffix in enumerate(("", "_1")):
            sr, got = wavfile.read(tmp_path / "validation" / f"step{step}_pool{pool}{suffix}.wav")
            assert sr == c.vocoder.sampling_rate
            np.testing.assert_array_equal(got, (np.clip(want[i], -1, 1) * 32767.0).astype(np.int16))
            sr, orig = wavfile.read(tmp_path / "validation" / f"step{step}_original{suffix}.wav")
            np.testing.assert_array_equal(orig, (np.clip(clips[picks[i]][1], -1, 1) * 32767.0).astype(np.int16))

    for k, p in adapter.items():
        assert p.dtype == torch.float32 and torch.equal(p, before[k][0]) and torch.equal(p.grad, before[k][1]), k
    after = opt.state_dict()
    for i, st in state_before["state"].items():
        for name, v in st.items():
            assert after["state"][i][name].dtype == v.dtype and torch.equal(after["state"][i][name], v)


def test_validation_files_capped_by_the_dataset(tmp_path):
    """``num_files`` is capped by the dataset's length: a one-clip dataset
    gives one generated wav, its original and the caption file."""

    mods = port_tiny()
    path = make_validation_fn(mods, _clips(1), str(tmp_path), num_inference_steps=1, audio_length_in_s=SECONDS,
                              seed=0, num_files=3)(1)
    (_, pool, _), = _draws(0, 1, 1, mods.config.audiomae.grid_size, 1)
    assert path == str(tmp_path / "validation" / f"step1_pool{pool}.wav")
    assert sorted(p.name for p in (tmp_path / "validation").iterdir()) == sorted(
        [f"step1_pool{pool}.wav", "step1_original.wav", "step1_caption.txt"])
