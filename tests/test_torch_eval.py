"""PyTorch port: the eval side (``ap_adapter_torch/eval/``): FAD and cosine
similarity, the VGGish front end and network (against JAX and against
``tests/golden/vggish.npz``, both heads), VGGish's state-dict round trip,
and the batched runner and eval protocol against the JAX runner driven over
the same edits (fp32, CPU)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ap_adapter_tpu.configs import get_task_config as jax_get_task_config
from ap_adapter_tpu.configs import tiny_pipeline_config as jax_tiny_config
from ap_adapter_tpu.convert.torch_import import vggish_params
from ap_adapter_tpu.eval import metrics as jmetrics
from ap_adapter_tpu.eval import runner as jrunner
from ap_adapter_tpu.eval.vggish import VGGish as JaxVGGish
from ap_adapter_tpu.eval.vggish import vggish_log_mel_examples as jax_vggish_log_mel_examples
from ap_adapter_torch.audio.io import load_wav, save_wav
from ap_adapter_torch.configs import get_task_config, tiny_pipeline_config
from ap_adapter_torch.convert import from_jax
from ap_adapter_torch.eval import metrics, runner
from ap_adapter_torch.eval.vggish import VGGish, vggish_clip_embeddings, vggish_log_mel_examples
from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline, PipelineModules, TextBatch
from ap_adapter_torch.pipeline.tokenize import make_text_batch
from tests.torch_port_common import close, one_torch_thread  # noqa: F401 (autouse fixture)
from tests.vggish_synth import state_dict_checksum, synth_state_dict

GOLDEN = Path(__file__).parent / "golden" / "vggish.npz"


def test_fad_and_cosine_match_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((40, 6))
    b = rng.standard_normal((30, 6)) * 1.3 + 0.4
    assert metrics.fad(a, b) == pytest.approx(jmetrics.fad(a, b), rel=1e-12)
    assert abs(metrics.fad(a, a.copy())) < 1e-6
    mu1, s1 = metrics.embedding_stats(a)
    mu2, s2 = metrics.embedding_stats(b)
    assert metrics.frechet_distance(mu1, s1, mu2, s2) == pytest.approx(jmetrics.frechet_distance(mu1, s1, mu2, s2),
                                                                       rel=1e-12)
    assert metrics.cosine_similarity(a[0], b[0]) == pytest.approx(jmetrics.cosine_similarity(a[0], b[0]), rel=1e-12)


@pytest.fixture(scope="module")
def vggish_sd():
    ref = np.load(GOLDEN)
    sd = synth_state_dict(seed=0)
    assert np.isclose(state_dict_checksum(sd), float(ref["sd_checksum"]), rtol=1e-9), \
        "numpy Generator stream drifted: regenerate vggish.npz (scripts/make_golden_fixtures.py)"
    return sd, ref


def test_vggish_matches_golden_and_jax(vggish_sd):
    """The torchvggish state dict loads by key; both heads against the torch
    oracle's outputs, the default head against the JAX VGGish."""

    sd, ref = vggish_sd
    model = VGGish()
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    ex = torch.from_numpy(ref["examples"])            # [3, 1, 96, 64] NCHW
    with torch.no_grad():
        noact, act = model(ex), model(ex, use_activation=True)
    close(noact, ref["want_noact"], atol=1e-4, rtol=1e-4)
    close(act, ref["want_act"], atol=1e-4, rtol=1e-4)
    want = jax.jit(JaxVGGish().apply)({"params": vggish_params(sd)},
                                      jnp.asarray(ref["examples"].transpose(0, 2, 3, 1)))
    close(noact, np.asarray(want), atol=1e-4, rtol=1e-4)


def test_vggish_state_dict_round_trips():
    """torch_import.vggish_params(from_jax.vggish_state_dict(tree)) is the tree
    bit for bit (on narrow random leaves: the mapping is by key and layout)."""

    rng = np.random.default_rng(4)
    sd = {}
    for idx in (0, 3, 6, 8, 11, 13):
        sd[f"features.{idx}.weight"] = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
        sd[f"features.{idx}.bias"] = rng.standard_normal(4).astype(np.float32)
    for idx in (0, 2, 4):
        sd[f"embeddings.{idx}.weight"] = rng.standard_normal((5, 6)).astype(np.float32)
        sd[f"embeddings.{idx}.bias"] = rng.standard_normal(5).astype(np.float32)
    tree = vggish_params(sd)
    back = vggish_params(from_jax.vggish_state_dict(tree))
    assert set(back) == set(tree)
    for name in tree:
        for leaf in tree[name]:
            np.testing.assert_array_equal(back[name][leaf], tree[name][leaf], err_msg=f"{name}/{leaf}")


def test_vggish_front_end_matches_jax():
    wav = (np.random.default_rng(1).standard_normal((2, 16000 + 3000)) * 0.3).astype(np.float32)
    want = np.asarray(jax_vggish_log_mel_examples(jnp.asarray(wav)))
    got = vggish_log_mel_examples(torch.from_numpy(wav))
    assert got.shape == want.shape == (2, 1, 96, 64)
    close(got, want, atol=1e-4, rtol=1e-4)


def test_vggish_clip_embeddings_concatenate_examples(vggish_sd):
    """frechet-audio-distance's get_embeddings: every clip's 0.96 s examples,
    concatenated across the set; the ReLU head on request."""

    model = VGGish()
    model.load_state_dict({k: torch.as_tensor(v) for k, v in vggish_sd[0].items()})
    wav = (np.random.default_rng(2).standard_normal(32000) * 0.3).astype(np.float32)
    embs = vggish_clip_embeddings(model, [wav, wav[:16000]], 16000)
    assert embs.shape == (3, 128) and (embs < 0).any()
    relu = vggish_clip_embeddings(model, [wav, wav[:16000]], 16000, use_activation=True)
    np.testing.assert_array_equal(relu, np.maximum(embs, 0))


class _Frames:
    """A deterministic example-level embedder (the ``.embed`` surface of a
    VggishEmbedder): per-chunk mean, std and max of each clip."""

    def embed(self, waveforms, sample_rate):
        return np.concatenate([np.stack([c.mean(1), c.std(1), c.max(1)], 1)
                               for c in (np.asarray(w, np.float64).reshape(10, -1) for w in waveforms)])


class _JaxSidePipe:
    """What the JAX runner calls on a pipeline, answered by the port's
    pipeline (the same edits: no JAX generate is traced)."""

    def __init__(self, pipe):
        self.pipe, self.config = pipe, jax_tiny_config()

    def prepare_fbank(self, wav, sr):
        return self.pipe.prepare_fbank(wav, sr).numpy()

    def generate(self, pos, neg, fbank, *, materialize, **kw):
        def tb(t):
            return TextBatch(*(np.asarray(a) for a in (t.clap_ids, t.clap_mask, t.t5_ids, t.t5_mask)))

        return self.pipe.generate(tb(pos), tb(neg), torch.as_tensor(np.asarray(fbank)), **kw)


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    cfg = tiny_pipeline_config()
    pipe = AudioLDM2Pipeline(cfg, PipelineModules(cfg).init_random(0, device="cpu"))
    root = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(3)
    dirs = {}
    for domain in ("in_domain", "out_of_domain"):
        (root / domain).mkdir()
        for i in range(2):
            save_wav(str(root / domain / f"{domain}{i}.wav"), (rng.standard_normal(3200) * 0.3).astype(np.float32))
        dirs[domain] = [str(root / domain)]
    task = dict(num_inference_steps=2, audio_length_in_s=0.2, time_pooling=2, freq_pooling=2,
                positive_text_prompts=("piano",), negative_text_prompts=("noise",))
    return pipe, dirs, task


def test_run_batched_eval_matches_jax_runner(eval_setup, tmp_path):
    """Two 0.2 s clips at batch 1: the JAX runner's result keys and FAD, and
    edits equal to ``generate``'s."""

    pipe, dirs, task = eval_setup
    clips = runner.eval_clips(dirs["in_domain"])
    got = runner.run_batched_eval(pipe, clips, get_task_config("timbre_transfer", **task), batch_size=1,
                                  output_dir=str(tmp_path), scorer=_Frames())
    want = jrunner.run_batched_eval(_JaxSidePipe(pipe), clips, jax_get_task_config("timbre_transfer", **task),
                                    batch_size=1, scorer=_Frames())
    assert set(got) == set(want) == {"n", "clips_per_s", "fad_vggish"} and got["n"] == 2
    assert np.isfinite(got["clips_per_s"]) and got["fad_vggish"] == pytest.approx(want["fad_vggish"], rel=1e-9)
    t = get_task_config("timbre_transfer", **task)
    pos, neg = (make_text_batch(pipe.config, [p]) for p in ("piano", "noise"))
    for i, clip in enumerate(clips):
        wav, sr = load_wav(clip)
        edit = pipe.generate(pos, neg, pipe.prepare_fbank(wav, sr), audio_length_in_s=t.audio_length_in_s,
                             num_inference_steps=t.num_inference_steps, guidance_scale=t.guidance_scale,
                             ap_scale=t.ap_scale, time_pool=2, freq_pool=2, seed=i)[0]
        save_wav(str(tmp_path / "want.wav"), edit)        # the same 16-bit rounding as the runner's file
        written = load_wav(str(tmp_path / Path(clip).name.replace(".wav", "_edit.wav")))[0]
        np.testing.assert_array_equal(written, load_wav(str(tmp_path / "want.wav"))[0])


def test_run_eval_protocol_matches_jax_runner(eval_setup):
    """Two domains, the out-of-domain one judged against the in-domain
    reference set: the JAX protocol's keys and numbers on the same edits."""

    pipe, dirs, task = eval_setup
    domains = {"in_domain": {"source": dirs["in_domain"], "reference": dirs["in_domain"]},
               "out_of_domain": {"source": dirs["out_of_domain"], "reference": dirs["in_domain"]}}
    got = runner.run_eval_protocol(pipe, domains, get_task_config("timbre_transfer", **task), batch_size=1,
                                   scorer=_Frames())
    want = jrunner.run_eval_protocol(_JaxSidePipe(pipe), domains, jax_get_task_config("timbre_transfer", **task),
                                     batch_size=1, scorer=_Frames())
    assert set(got) == set(want)
    for k, v in want.items():
        if k != "clips_per_s":          # a wall-clock rate
            assert got[k] == (pytest.approx(v, rel=1e-9) if isinstance(v, float) else v), k
    assert got["fad_in_domain"] == got["fad_faithfulness_in_domain"]
    assert got["fad_out_of_domain"] != got["fad_faithfulness_out_of_domain"]


def test_runner_cli_refuses_without_clips():
    with pytest.raises(SystemExit):
        runner.main(["--device", "cpu"])
