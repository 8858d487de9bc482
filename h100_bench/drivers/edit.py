"""Traffic driver ``edit``: AudioLDM2 + AP-adapter edits through
``AudioLDM2Pipeline.generate``, ``batch`` clips a call, one closed-loop
client.

Call ``i`` takes the template ``rotation[(seed + i) % len(rotation)]``
(its adapter scale, pooling and guidance), one of the template's positive
prompts for each clip (drawn from the seed), the template's negative
prompt, a seeded 10 s audio prompt for each clip, turned into AudioMAE's
fbank by the program (``prepare_fbank``) inside the call, and its own
latent seed.
"""

from __future__ import annotations

import numpy as np
import torch

from h100_bench import flops
from h100_bench.drivers.common import (Capture, check_spec, control_ddim_err, ddim_err, decode_err, dtype_of, free,
                                       materialize_, port_config, reference_models, rel, rel_err, sample_calls,
                                       unet_steps_err)
from h100_bench.inputs import audio_prompt, sub_seed, text_batch, weight_spec
from h100_bench.reference.common import Cfg
from h100_bench.reference.pipelines import edit


def call_inputs(config: dict, mix: dict, seed: int, i: int) -> dict:
    name = mix["rotation"][(seed + i) % len(mix["rotation"])]
    tpl, b = mix["templates"][name], mix["batch"]
    rng = np.random.default_rng(sub_seed(seed, "prompts", i))
    prompts = [tpl["positive"][k] for k in rng.integers(0, len(tpl["positive"]), size=b)]
    return {"template": name, "tpl": tpl,
            "pos": text_batch(config, prompts, mix["t5_length"]),
            "neg": text_batch(config, [tpl["negative"]] * b, mix["t5_length"]),
            "wavs": np.stack([audio_prompt(sub_seed(seed, "audio", i, j), mix["audio_seconds"], mix["sample_rate"])
                              for j in range(b)]),
            "latent_seed": sub_seed(seed, "latents", i)}


def initial_latents(config: dict, mix: dict, x: dict, device) -> torch.Tensor:
    """The call's starting noise, drawn as the pipeline draws it from the
    call's latent seed."""

    t, f = flops.latent_shape(config, mix["audio_seconds"])
    gen = torch.Generator(device=device).manual_seed(x["latent_seed"])
    return torch.randn(mix["batch"], t, f, config["unet"]["in_channels"], generator=gen, device=device)


def reference_call(ref, config: dict, mix: dict, x: dict, device, taps: dict, lowp=None) -> torch.Tensor:
    tpl = x["tpl"]
    return edit(ref, config, x["pos"], x["neg"], x["wavs"], initial_latents(config, mix, x, device),
                ap_scale=tpl["ap_scale"], time_pool=tpl["time_pool"], freq_pool=tpl["freq_pool"],
                guidance=tpl["guidance"], steps=mix["steps"],
                samples=int(mix["audio_seconds"] * config["vocoder"]["sampling_rate"]), taps=taps, lowp=lowp)


def control(config: dict, mix: dict, seed: int, device) -> dict:
    """The control: the reference itself in the program's place, with every
    product's operands, and the operands and result of each guidance and
    DDIM update, in fp8 (``reference/lowp.py``), over the calls a run
    compares, against the float32 reference: the conditioning, the UNet's
    first step on the control's own inputs, its updates at the steps a run
    keeps on its own latents and outputs, the decoders on its own latents
    and the served clip."""

    from h100_bench.reference.lowp import Fp8Products, fp8
    from h100_bench.reference.pipelines import PIPELINE_NAMES, timesteps

    ref = reference_models(config, PIPELINE_NAMES["audioldm2"], seed, device)
    err = {"cond_rel_err": [], "unet_rel_err": [], "ddim_rel_err": [], "decode_rel_err": [], "wav_rel_err": []}
    for i in range(mix["check_calls"]):
        x, low, want = call_inputs(config, mix, seed, i), {}, {}
        with Fp8Products():
            got = reference_call(ref, config, mix, x, device, low, lowp=fp8)
        wav = reference_call(ref, config, mix, x, device, want)
        err["cond_rel_err"] += [rel(torch.cat([low["gpt2"], low["audio"]], 1), torch.cat([want["gpt2"], want["audio"]], 1)),
                                rel(low["t5"], want["t5"])]
        lat0 = initial_latents(config, mix, x, device)
        t0 = torch.full((2 * mix["batch"],), float(timesteps(Cfg(config["scheduler"]), mix["steps"])[0]), device=device)
        with torch.no_grad():
            out0 = ref["unet"](torch.cat([lat0, lat0]), t0, torch.cat([low["gpt2"], low["audio"]], 1), low["t5"],
                               low["t5_mask"], x["tpl"]["ap_scale"])
            dec = ref["vocoder"](ref["vae"].decode(low["latents"]))[:, : got.shape[-1]]
        err["unet_rel_err"].append(rel(low["unet_out0"], out0))
        err["ddim_rel_err"].append(control_ddim_err(config, mix, seed, i, x["tpl"]["guidance"], low))
        err["decode_rel_err"] += rel_err(got.cpu().numpy(), dec)
        err["wav_rel_err"] += rel_err(got.cpu().numpy(), wav)
    del ref
    free()
    return {k: max(v) for k, v in err.items()}


class Driver:
    def __init__(self, config: dict, mix: dict, seed: int, device):
        from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline, PipelineModules

        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        pc = port_config(config)
        mods = materialize_(PipelineModules(pc), PipelineModules.NAMES, seed, device, dtype_of(config))
        self.spec = {n: weight_spec(getattr(mods, n)) for n in PipelineModules.NAMES}
        self.pipe = AudioLDM2Pipeline(pc, mods)
        self.clips = mix["batch"]
        self.capture = Capture(mods.unet, mods.vae.post_quant_conv, seed, mix["steps"], mix["check_steps"])
        self.captured = {}

    def unet(self):
        return self.pipe.modules.unet

    def inputs(self, i: int) -> dict:
        return call_inputs(self.config, self.mix, self.seed, i)

    def warmup_calls(self) -> list:
        """One call of each distinct shape (the templates' poolings), with
        two denoise steps: the same kernels at the same shapes as the
        window's calls."""

        seen, calls = set(), []
        for i in range(len(self.mix["rotation"])):
            tpl = self.inputs(i)["tpl"]
            key = (tpl["time_pool"], tpl["freq_pool"])
            if key not in seen:
                seen.add(key)
                calls.append(i)
        return calls

    def call(self, i: int, steps: int = 0) -> np.ndarray:
        from ap_adapter_torch.pipeline.pipeline import TextBatch

        x, m = self.inputs(i), self.mix
        tpl = x["tpl"]
        if not steps:
            self.capture.start(i)
        fbank = torch.cat([self.pipe.prepare_fbank(w, m["sample_rate"]) for w in x["wavs"]])
        out = self.pipe.generate(
            TextBatch(**x["pos"]), TextBatch(**x["neg"]), fbank, audio_length_in_s=m["audio_seconds"],
            num_inference_steps=steps or m["steps"], guidance_scale=tpl["guidance"], ap_scale=tpl["ap_scale"],
            time_pool=tpl["time_pool"], freq_pool=tpl["freq_pool"], seed=x["latent_seed"])
        if not steps:
            self.captured[i] = self.capture.stop()
        return out

    def work(self, i: int) -> dict:
        tpl = self.inputs(i)["tpl"]
        a = self.config["audiomae"]
        grid = (a["img_size"][0] // a["patch_size"]) * (a["img_size"][1] // a["patch_size"])
        return flops.edit_request(self.config, self.clips, self.mix["t5_length"],
                                  grid // (tpl["time_pool"] * tpl["freq_pool"]), self.mix["steps"],
                                  self.mix["audio_seconds"])

    def release(self):
        self.capture.remove()
        del self.pipe, self.capture
        free()

    def check(self, outputs: dict) -> dict:
        """Over ``check_calls`` completed calls drawn from the seed, the widest
        relative error against the float32 reference of: the conditioning
        (GPT-2 + AudioMAE and T5 streams), the UNet's output at the kept
        steps (the reference UNet on the program's own inputs of that step),
        the latents that the guidance and DDIM update made from those steps
        (the reference's update of the program's own input and output), the
        decoded clip (the reference's VAE decoder and vocoder on the
        program's own latents) and the served clip (the reference run
        whole, from the same inputs)."""

        m = self.mix
        calls = sample_calls(sorted(outputs), m["check_calls"], self.seed)
        ref = reference_models(self.config, self.spec, self.seed, self.device)
        check_spec(self.spec, ref)
        err = {"cond_rel_err": [], "unet_rel_err": [], "ddim_rel_err": [], "decode_rel_err": [], "wav_rel_err": []}
        for i in calls:
            x, taps, cap = self.inputs(i), {}, self.captured[i]
            want = reference_call(ref, self.config, m, x, self.device, taps)
            step = cap["unet"][0]
            err["cond_rel_err"] += [rel(step["ehs0"], torch.cat([taps["gpt2"], taps["audio"]], dim=1)),
                                    rel(step["ehs1"], taps["t5"])]
            err["unet_rel_err"].append(unet_steps_err(ref["unet"], cap["unet"]))
            err["ddim_rel_err"].append(ddim_err(self.config, m["steps"], x["tpl"]["guidance"], cap["unet"]))
            err["decode_rel_err"] += decode_err(ref, self.config, cap["z"], outputs[i])
            err["wav_rel_err"] += rel_err(outputs[i], want)
        del ref
        free()
        return {**{k: max(v) for k, v in err.items()}, "clips_checked": len(err["wav_rel_err"])}
