"""Traffic driver ``musicgen``: MusicGen text-to-music through
``MusicGenPipeline.generate``, ``batch`` descriptions a call, one
closed-loop client. Call ``i`` takes the mix's descriptions in turn from
an offset drawn from the seed, T5 ids padded to ``t5_length``, and its own
sampling seed.

The output check follows the program's own state (``check``): its
projected text states and hoisted cross K/V, its logits at the kept decode
steps against one float32 full causal forward of the reference over the
token sequence the program's decoder read, its sampling (every token it
drew lies in the top-k of the reference's CFG scores at that step, and the
tokens it fed are the delay pattern of the codes it served), and its
waveform against the reference's EnCodec on the program's own codes."""

from __future__ import annotations

import sys

import numpy as np
import torch

from h100_bench import flops_musicgen
from h100_bench.drivers.common import dtype_of, free, kept_steps, materialize_, rel, rel_err
from h100_bench.inputs import fill_weights_, sub_seed, tuples, weight_spec, word_ids
from h100_bench.reference import musicgen as reference

NAMES = reference.NAMES


def port_config(config: dict):
    """The program's ``MusicGenConfig`` for a configuration file."""

    from ap_adapter_torch import configs as pc

    return pc.MusicGenConfig(t5=pc.T5Config(**config["t5"]), decoder=pc.MusicGenDecoderConfig(**config["decoder"]),
                             encodec=pc.EncodecConfig(**{k: tuples(v) for k, v in config["encodec"].items()}),
                             dtype=dtype_of(config))


def call_inputs(config: dict, mix: dict, seed: int, i: int) -> dict:
    n, b = len(mix["prompts"]), mix["batch"]
    start = sub_seed(seed, "prompts") % n
    prompts = [mix["prompts"][(start + i * b + j) % n] for j in range(b)]
    ids, mask = word_ids(prompts, config["t5"]["vocab_size"], 0, mix["t5_length"])
    return {"ids": ids, "mask": mask, "sample_seed": sub_seed(seed, "sample", i)}


def kept(seed: int, i: int, steps: int, keep: int) -> set:
    """The decode steps whose logits the check reads: ``kept_steps``' (the
    first and ``keep`` drawn from the seed) and the last."""

    return kept_steps(seed, i, steps, keep) | {steps - 1}


def kept_layers(layers: int) -> list:
    return [0, layers // 2, layers - 1]


def reference_models(config: dict, seed: int, device) -> dict:
    """The reference's submodels in float32 with the values the program got
    (the same draws in the served dtype, then widened)."""

    models = reference.build(config, device)
    for name, m in models.items():
        fill_weights_(m, sub_seed(seed, "weights", name), dtype_of(config))
    return models


def _text(x: dict, device):
    return (torch.as_tensor(x["ids"], dtype=torch.long, device=device),
            torch.as_tensor(x["mask"], dtype=torch.long, device=device))


class Capture:
    """Hooks that keep, for the call being run, what the check reads: the
    projection's output, every decoder forward's tokens, the logits of the
    kept steps and EnCodec's codes. References only: no copy, no wait."""

    def __init__(self, mods, seed: int, steps: int, keep: int):
        self.seed, self.steps, self.keep = seed, steps, keep
        self.cur = None
        self._handles = [mods.enc_to_dec_proj.register_forward_hook(self._proj),
                         mods.decoder.register_forward_hook(self._decoder),
                         mods.encodec.register_forward_pre_hook(self._codes)]

    def start(self, i: int) -> None:
        self.cur = {"keep": kept(self.seed, i, self.steps, self.keep), "n": 0, "tokens": [], "logits": {}}

    def stop(self) -> dict:
        cur, self.cur = self.cur, None
        return cur

    def _proj(self, module, args, out):
        if self.cur is not None:
            self.cur["proj"] = out

    def _decoder(self, module, args, out):
        c = self.cur
        if c is not None:
            c["tokens"].append(args[0])
            if c["n"] in c["keep"]:
                c["logits"][c["n"]] = out[:, :, 0]
            c["n"] += 1

    def _codes(self, module, args):
        if self.cur is not None:
            self.cur["codes"] = args[0]

    def remove(self) -> None:
        for h in self._handles:
            h.remove()


def topk_miss_share(logits, drawn, guidance: float, top_k: int, pad: int) -> float:
    """The share of the drawn tokens (``drawn`` [B, K, steps], ``pad`` where
    the delay pattern pads) that lie outside the ``top_k`` highest CFG
    scores of the reference's ``logits`` [2B, K, steps, V] at their step."""

    top = reference.cfg_scores(logits, guidance).topk(top_k, dim=-1).indices
    live = drawn != pad
    inside = (top == drawn[..., None]).any(-1)
    return float((live & ~inside).sum()) / max(int(live.sum()), 1)


@torch.no_grad()
def _readings(ref: dict, config: dict, mix: dict, x: dict, device, got: dict) -> dict:
    """The widest relative errors of ``got`` (``proj``: the projected states
    [B, S, C] before the mask; ``kv``: (k, v) [layers, 2B, S, C] at
    ``kept_layers``; ``logits``: {step: [2B, K, V]}; ``tokens`` [2B, K,
    steps], the decoder's inputs; ``drawn`` [B, K, steps], the token drawn
    at each step; ``codes`` and ``wav``) against the reference on the same
    inputs and on the program's own tokens and codes; the share of drawn
    tokens outside the reference's top-k (``topk_miss_share``; beside it,
    not compared, the share a loop that dropped the guidance or swapped its
    operands would have read); and the count of fed tokens that are not the
    delay pattern of the served codes (both CFG halves)."""

    ids, mask = _text(x, device)
    states, mask2 = reference.conditioning(ref, ids, mask)
    b = ids.shape[0]
    cond = [rel(got["proj"].float() * mask[..., None], states[:b])]
    for j, layer in enumerate(kept_layers(config["decoder"]["num_hidden_layers"])):
        k, v = reference.cross_kv(ref["decoder"], states, layer)
        cond += [rel(got["kv"][0][j], k), rel(got["kv"][1][j], v)]
    tokens, d = got["tokens"], config["decoder"]
    want = ref["decoder"](tokens, states, mask2)
    logits = [rel(v, want[:, :, n]) for n, v in got["logits"].items()]
    pattern = reference.delay_pattern(got["codes"], d["pad_token_id"])[:, :, : tokens.shape[2]]
    g, k, pad = mix["guidance"], mix["top_k"], d["pad_token_id"]
    return {"cond_rel_err": max(cond), "logits_rel_err": max(logits),
            "topk_miss_share": topk_miss_share(want, got["drawn"], g, k, pad),
            "topk_miss_share.no_guidance": topk_miss_share(want, got["drawn"], 1.0, k, pad),
            "topk_miss_share.swapped_guidance": topk_miss_share(want, got["drawn"], 1.0 - g, k, pad),
            "pattern_errors": int((tokens[:b] != pattern).sum() + (tokens[b:] != pattern).sum()),
            "decode_rel_err": max(rel_err(got["wav"], ref["encodec"](got["codes"])))}


class Driver:
    def __init__(self, config: dict, mix: dict, seed: int, device):
        from ap_adapter_torch.ops.cuda_kernels import DECODE_FORWARDS
        from ap_adapter_torch.pipeline.musicgen import MusicGenModules, MusicGenPipeline

        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        cfg = port_config(config)
        mods = materialize_(MusicGenModules(cfg), NAMES, seed, device, dtype_of(config))
        self.spec = {n: weight_spec(getattr(mods, n)) for n in NAMES}
        self.pipe = MusicGenPipeline(cfg, mods)
        self.clips = mix["batch"]
        self.shapes = flops_musicgen.shapes(config, mix)
        self.work_of_a_call = flops_musicgen.call_work(config, mix)
        self.forwards = DECODE_FORWARDS
        self.capture = Capture(mods, seed, self.shapes["steps"], mix["check_steps"])
        self.captured, self.decode_forwards, self.after_warmup = {}, {}, None     # captured: the newest calls

    def unet(self):
        """The module whose forwards the harness times: the decoder, one forward a decode step."""

        return self.pipe.modules.decoder

    def inputs(self, i: int) -> dict:
        return call_inputs(self.config, self.mix, self.seed, i)

    def warmup_calls(self) -> list:
        return [0]

    def call(self, i: int, steps: int = 0) -> np.ndarray:
        x, m = self.inputs(i), self.mix
        if not steps:
            if self.after_warmup is None:
                self.after_warmup = dict(self.forwards)
            self.capture.start(i)
        before = sum(self.forwards.values())
        out = self.pipe.generate(x["ids"], x["mask"], seconds=m["audio_seconds"], guidance_scale=m["guidance"],
                                 top_k=m["top_k"], temperature=m["temperature"], seed=x["sample_seed"],
                                 max_steps=steps or None)
        self.decode_forwards[i] = sum(self.forwards.values()) - before
        if not steps:
            cap = self.capture.stop()
            state = self.pipe.state
            layers = kept_layers(self.config["decoder"]["num_hidden_layers"])
            cap["kv"] = (state.cross_k[layers], state.cross_v[layers])          # copies: the next call overwrites
            self.captured[i] = cap
            for j in sorted(self.captured)[: -m["check_calls"]]:
                del self.captured[j]
        return out

    def work(self, i: int) -> dict:
        return {**self.work_of_a_call, "decode_forwards": self.decode_forwards.get(i, 0)}

    def release(self):
        if self.after_warmup is not None:
            print(f"decoder forwards after the warm-up: "
                  f"{ {k: v - self.after_warmup[k] for k, v in self.forwards.items()} }", file=sys.stderr)
        self.capture.remove()
        del self.pipe, self.capture
        free()

    def check(self, outputs: dict) -> dict:
        """Over the newest ``check_calls`` completed calls (the only ones whose
        state is kept), the widest relative error against the float32
        reference of: the conditioning (the projected, masked T5 states and
        the hoisted cross K/V of the first, middle and last layers), the CFG
        rows' logits at the kept decode steps (one full causal forward of
        the reference over the tokens the program's decoder read) and the
        served clips (the reference's EnCodec on the program's own codes);
        the share of the drawn tokens outside the reference's top-k CFG
        scores at their step, and the fed tokens that break the delay
        pattern of the served codes."""

        calls = sorted(i for i in self.captured if i in outputs)
        ref = reference_models(self.config, self.seed, self.device)
        for name, m in ref.items():
            if self.spec[name] != weight_spec(m):
                raise RuntimeError(f"reference {name}: parameter names or shapes differ from the program's")
        err = {}
        for i in calls:
            cap = self.captured[i]
            got = {**cap, "tokens": torch.cat(cap["tokens"], dim=2), "wav": outputs[i],
                   "drawn": reference.delay_pattern(cap["codes"], self.config["decoder"]["pad_token_id"])[:, :, 1:]}
            for k, v in _readings(ref, self.config, self.mix, self.inputs(i), self.device, got).items():
                err[k] = max(err.get(k, 0.0), v)
        del ref
        free()
        return {**err, "clips_checked": len(calls) * self.clips}


def control(config: dict, mix: dict, seed: int, device) -> dict:
    """The control: the reference with every product's operands in fp8
    (``reference/lowp.py``) in the program's place, against the float32
    reference: its conditioning, its logits at the kept steps over a token
    sequence drawn from the seed in the delay pattern, a token drawn at each
    step from the top-k of its own CFG scores there (Gumbel-max, as the
    program draws), and its EnCodec on codes drawn from the seed."""

    from h100_bench.reference.lowp import Fp8Products

    ref = reference_models(config, seed, device)
    s, d = flops_musicgen.shapes(config, mix), config["decoder"]
    err = {}
    for i in range(mix["check_calls"]):
        x = call_inputs(config, mix, seed, i)
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "control", i))
        codes = torch.randint(0, d["vocab_size"], (mix["batch"], d["num_codebooks"], s["frames"]), generator=gen,
                              device=device)
        tokens = reference.delay_pattern(codes, d["pad_token_id"])[:, :, : s["steps"]]
        ids, mask = _text(x, device)
        with torch.no_grad(), Fp8Products():
            low_states, _ = reference.conditioning(ref, ids, mask)
            layers = kept_layers(d["num_hidden_layers"])
            kv = [reference.cross_kv(ref["decoder"], low_states, layer) for layer in layers]
            logits = ref["decoder"](torch.cat([tokens, tokens]), low_states,
                                    torch.cat([mask, torch.zeros_like(mask)]))
            wav = ref["encodec"](codes)
            top, idx = reference.cfg_scores(logits, mix["guidance"]).topk(mix["top_k"], dim=-1)
            noise = torch.empty_like(top).exponential_(generator=gen)
            drawn = idx.gather(-1, (top - noise.log()).argmax(-1, keepdim=True))[..., 0]
            full = reference.delay_pattern(codes, d["pad_token_id"])
            drawn = drawn.masked_fill(full[:, :, 1:] == d["pad_token_id"], d["pad_token_id"])
        got = {"proj": low_states[: mix["batch"]], "kv": (torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv])),
               "tokens": torch.cat([tokens, tokens]), "codes": codes, "wav": wav.cpu().numpy(), "drawn": drawn,
               "logits": {n: logits[:, :, n] for n in sorted(kept(seed, i, s["steps"], mix["check_steps"]))}}
        del logits, top, idx, noise
        for k, v in _readings(ref, config, mix, x, device, got).items():
            err[k] = max(err.get(k, 0.0), v)
    del ref
    free()
    return err
