"""Faults planted under the timed path, for the checks that must catch
them (``tests/test_bench_outputs.py`` at the tiny sizes on the CPU,
``calibrate.py --fault`` at a cell's sizes on the card): each patches the
program in this process and returns a function that undoes the patch."""

from __future__ import annotations

import numpy as np


def _patch(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    return lambda: setattr(obj, name, old)


def _patch_generate(wrap):
    from ap_adapter_torch.pipeline.audioldm_v1 import AudioLDMv1Pipeline
    from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline

    undo = [_patch(cls, "generate", wrap(cls.generate)) for cls in (AudioLDM2Pipeline, AudioLDMv1Pipeline)]
    return lambda: [u() for u in undo]


def answer_altered():
    """Every served clip comes back reversed in time."""

    return _patch_generate(lambda gen: lambda self, *a, **k: np.ascontiguousarray(gen(self, *a, **k)[:, ::-1]))


def step_unchanged():
    """Every DDIM step returns the latents it was given."""

    import ap_adapter_torch.diffusion.sampling as sampling

    return _patch(sampling, "ddim_step", lambda tables, out, t, prev, sample: sample.float())


def half_batch():
    """An edit call serves the first half of its clips and repeats them for
    the other half."""

    from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline, TextBatch

    def wrap(gen):
        def half(self, pos, neg, fbank, **kw):
            n = len(pos.clap_ids) // 2
            cut = lambda tb: TextBatch(*(np.asarray(a)[:n] for a in (tb.clap_ids, tb.clap_mask, tb.t5_ids, tb.t5_mask)))
            out = gen(self, cut(pos), cut(neg), fbank[:n], **kw)
            return np.concatenate([out, out])
        return half

    return _patch(AudioLDM2Pipeline, "generate", wrap(AudioLDM2Pipeline.generate))


FAULTS = {"answer_altered": answer_altered, "step_unchanged": step_unchanged, "half_batch": half_batch}
