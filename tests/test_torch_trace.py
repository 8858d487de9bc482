"""The port's tracer (``ap_adapter_torch/utils/trace.py``) on the tiny
pipelines, on the CPU: off it records nothing and changes no output; on,
the generate path's spans with their parents, request ids and counts, the
same names as ``torch.profiler`` ranges, and the cap. No JAX: random
weights through ``init_random``."""

from collections import Counter

import numpy as np
import pytest
import torch

from ap_adapter_torch.configs import tiny_pipeline_config
from ap_adapter_torch.pipeline.audioldm_v1 import AudioLDMv1Pipeline
from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline, PipelineModules
from ap_adapter_torch.pipeline.tokenize import make_text_batch
from ap_adapter_torch.utils import trace

CFG = tiny_pipeline_config()
STEPS = 2
KW = dict(audio_length_in_s=0.2, num_inference_steps=STEPS, guidance_scale=3.0, seed=1)
# name -> parent's name (None: a root)
A2L_PARENTS = {"ap.fbank": None, "ap.generate": None, "ap.text": "ap.generate", "ap.gpt2": "ap.text",
               "ap.audiomae": "ap.generate", "ap.hoist": "ap.generate", "ap.denoise": "ap.generate",
               "ap.step": "ap.denoise", "ap.unet": "ap.step", "ap.unet.resnet": "ap.unet",
               "ap.unet.attn": "ap.unet", "ap.vae_decode": "ap.generate", "ap.vocoder": "ap.generate",
               "ap.to_host": "ap.generate"}
V1_PARENTS = {k: v for k, v in A2L_PARENTS.items() if k not in ("ap.fbank", "ap.gpt2", "ap.audiomae", "ap.hoist")}


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


@pytest.fixture(scope="module")
def a2l():
    return AudioLDM2Pipeline(CFG, PipelineModules(CFG).init_random(0, device="cpu"))


@pytest.fixture(scope="module")
def v1():
    return AudioLDMv1Pipeline.init_random(CFG, seed=0, device="cpu")


def edit(pipe, n_prompts=1):
    pos = make_text_batch(CFG, ["a recording of a violin solo"] * n_prompts, t5_len=8)
    neg = make_text_batch(CFG, [""] * n_prompts, t5_len=8)
    wav = np.random.default_rng(5).standard_normal(8000).astype(np.float32)
    fbank = torch.cat([pipe.prepare_fbank(wav, 16000) for _ in range(n_prompts)])
    return pipe.generate(pos, neg, fbank, time_pool=2, freq_pool=2, **KW)


def t2a(pipe):
    return pipe.generate(make_text_batch(CFG, ["jazz"]), make_text_batch(CFG, [""]), **KW)


def unet_sizes(pipe):
    unet = pipe.modules.unet
    return sum(1 for _ in unet.resnet_blocks()), sum(1 for _ in unet.attention_groups())


@pytest.mark.parametrize("which", ["a2l", "v1"])
def test_spans_of_a_request(which, request):
    """Off: nothing recorded. On: the same clips bit for bit, every span of
    the path under its parent, one request id for every span under the
    ``ap.generate`` root, and the step, forward, resnet and group counts."""

    pipe = request.getfixturevalue(which)
    run, parents = (edit, A2L_PARENTS) if which == "a2l" else (t2a, V1_PARENTS)
    off = run(pipe)
    assert trace.drain() == ([], 0) and not trace.enabled()
    trace.enable()
    on = run(pipe)
    records, dropped = trace.drain()
    np.testing.assert_array_equal(on, off)
    assert dropped == 0
    resnets, groups = unet_sizes(pipe)
    counts = Counter(r.name for r in records)
    assert counts == {**{n: 1 for n in parents}, "ap.step": STEPS, "ap.unet": STEPS,
                      "ap.unet.resnet": STEPS * resnets, "ap.unet.attn": STEPS * groups}
    by_id = {r.id: r for r in records}
    root = next(r for r in records if r.name == "ap.generate")
    assert root.attrs == {"rows": 1, "steps": STEPS} and root.request == root.id
    for r in records:
        assert (by_id[r.parent].name if r.parent is not None else None) == parents[r.name], r.name
        assert r.request == (None if r.name == "ap.fbank" else root.id), r.name
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns, r.name


def test_request_ids_and_rows_per_generate(a2l):
    """Two calls, two request ids; ``rows`` is the call's batch."""

    trace.enable()
    edit(a2l)
    edit(a2l, n_prompts=2)
    records, _ = trace.drain()
    roots = [r for r in records if r.name == "ap.generate"]
    assert [r.attrs["rows"] for r in roots] == [1, 2]
    assert {r.request for r in records if r.request is not None} == {r.id for r in roots}
    assert sum(r.name == "ap.fbank" for r in records) == 3


def test_spans_are_profiler_ranges(v1):
    """Under a CPU-only ``torch.profiler``, every span is a
    ``record_function`` range of its name, once per record."""

    from torch.profiler import ProfilerActivity, profile

    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t2a(v1)
    records, _ = trace.drain()
    ranges = Counter(e.name() for e in prof.profiler.kineto_results.events() if e.name().startswith("ap."))
    assert ranges == Counter(r.name for r in records)


def test_past_the_cap_spans_are_dropped(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 3)
    trace.enable()
    with trace.span("ap.generate", rows=1):
        for _ in range(4):
            with trace.span("ap.step"):
                pass
    records, dropped = trace.drain()
    assert [r.name for r in records] == ["ap.step"] * 3 and dropped == 2
    assert trace.drain() == ([], 0)
    trace.disable()
    with trace.span("ap.step"):
        pass
    assert trace.drain() == ([], 0)
