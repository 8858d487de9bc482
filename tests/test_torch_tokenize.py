"""PyTorch port: a checkpoint's transformers tokenizers
(``pipeline/tokenize.py::HFTokenizers``), the T5 buckets and
``make_text_batch`` against the JAX package's, and the task CLI on a
checkpoint directory that holds ``tokenizer/`` and ``tokenizer_2/``. The
tokenizers are WordLevel ones written to a tmp directory, as
``tests/test_tokenize.py`` writes them; transformers is imported only
inside the tests and the port's ``HFTokenizers``."""

import json
import os

import numpy as np
import pytest

from ap_adapter_tpu.configs import tiny_pipeline_config as jax_tiny_config
from ap_adapter_tpu.pipeline import tokenize as jtokenize
from ap_adapter_torch.audio.io import load_wav
from ap_adapter_torch.configs import tiny_pipeline_config
from ap_adapter_torch.pipeline import tasks, tokenize
from ap_adapter_torch.pipeline.pipeline import PipelineModules
from tests.torch_port_common import one_torch_thread  # noqa: F401 (autouse fixture)

VOCAB = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "piano": 4, "playing": 5, "trumpet": 6, "solo": 7, "low": 8,
         "quality": 9, "noise": 10}
TEXTS = ["playing piano", "trumpet solo playing piano trumpet", "low quality noise"]


def _write_fast_tokenizer(d, vocab):
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    os.makedirs(d, exist_ok=True)
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(
        single="<s> $A </s>", special_tokens=[("<s>", vocab["<s>"]), ("</s>", vocab["</s>"])])
    tok.save(os.path.join(d, "tokenizer.json"))
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<pad>", "unk_token": "<unk>",
                   "bos_token": "<s>", "eos_token": "</s>", "model_max_length": 512}, f)


@pytest.fixture()
def ckpt(tmp_path):
    os.environ.setdefault("USE_TF", "0")     # transformers would import tensorflow first
    d = tmp_path / "ckpt"
    _write_fast_tokenizer(str(d / "tokenizer"), VOCAB)
    _write_fast_tokenizer(str(d / "tokenizer_2"), VOCAB)
    return str(d)


def test_pick_t5_bucket_at_the_edges():
    for n in (1, 15, 16, 17, 32, 33, 64, 65, 128, 129, 256, 257, 512, 513, 10_000):
        assert tokenize.pick_t5_bucket(n) == jtokenize.pick_t5_bucket(n)
    assert tokenize.T5_BUCKETS == jtokenize.T5_BUCKETS
    assert [tokenize.pick_t5_bucket(n) for n in (16, 17, 512, 513)] == [16, 32, 512, 512]


def test_hf_tokenizers_match_jax(ckpt):
    got, want = tokenize.HFTokenizers(ckpt), jtokenize.HFTokenizers(ckpt)
    for t5_len in (16, None):
        for a, b in zip(got(TEXTS, 12, t5_len), want(TEXTS, 12, t5_len)):
            np.testing.assert_array_equal(a, b)
    assert got.t5_length(TEXTS) == want.t5_length(TEXTS) == 7


@pytest.mark.parametrize("hf", [False, True])
def test_make_text_batch_auto_bucket_matches_jax(ckpt, hf):
    """``t5_len=None`` picks the smallest bucket over the longest prompt,
    with the checkpoint's tokenizers and with the hash tokenizer."""

    cfg, jcfg = tiny_pipeline_config(), jax_tiny_config()
    long = ["piano " * 20]
    for texts in (TEXTS, long):
        got = tokenize.make_text_batch(cfg, texts, tokenize.HFTokenizers(ckpt) if hf else None, t5_len=None)
        want = jtokenize.make_text_batch(jcfg, texts, jtokenize.HFTokenizers(ckpt) if hf else None, t5_len=None)
        for a, b in zip((got.clap_ids, got.clap_mask, got.t5_ids, got.t5_mask),
                        (want.clap_ids, want.clap_mask, want.t5_ids, want.t5_mask)):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, np.asarray(b))
    assert got.t5_ids.shape[1] == 32


def test_cli_runs_on_a_checkpoint_with_tokenizers(ckpt):
    """``main`` with ``--checkpoint-dir``: the submodels' state dicts load,
    the prompts go through the folder's tokenizers, the wavs are written."""

    cfg = tiny_pipeline_config()
    mods = PipelineModules(cfg).init_random(3, "cpu")
    for name in PipelineModules.NAMES:
        np.savez(os.path.join(ckpt, f"{name}.npz"),
                 **{k: v.numpy() for k, v in getattr(mods, name).state_dict().items()})
    out = os.path.join(ckpt, "out")
    paths = tasks.main(["--task", "style_transfer", "--prompt", "piano solo", "--tiny", "--device", "cpu",
                        "--checkpoint-dir", ckpt, "--steps", "2", "--audio-length", "0.2", "--time-pool", "2",
                        "--freq-pool", "2", "--output-dir", out])
    assert paths == [os.path.join(out, "p_0_ip0.55_t2_f2.wav")]
    wav, sr = load_wav(paths[0])
    assert sr == 16000 and wav.shape == (3200,) and np.all(np.isfinite(wav))
