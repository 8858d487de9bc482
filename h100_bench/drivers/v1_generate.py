"""Traffic driver ``v1_generate``: AudioLDM v1 text-to-audio through
``AudioLDMv1Pipeline.generate``, ``batch`` prompts a call, one closed-loop
client. Call ``i`` takes prompts drawn from the mix's list by the seed,
the mix's negative prompt and its own latent seed."""

from __future__ import annotations

import numpy as np
import torch

from h100_bench import flops
from h100_bench.drivers.common import (Capture, check_spec, control_ddim_err, ddim_err, decode_err, dtype_of, free,
                                       materialize_, port_config, reference_models, rel, rel_err, sample_calls,
                                       unet_steps_err)
from h100_bench.inputs import sub_seed, text_batch, tuples, weight_spec
from h100_bench.reference.common import Cfg
from h100_bench.reference.pipelines import text_to_audio

NAMES = ("clap", "unet", "vae", "vocoder")


def call_inputs(config: dict, mix: dict, seed: int, i: int) -> dict:
    rng = np.random.default_rng(sub_seed(seed, "prompts", i))
    prompts = [mix["prompts"][k] for k in rng.integers(0, len(mix["prompts"]), size=mix["batch"])]
    return {"pos": text_batch(config, prompts), "neg": text_batch(config, [mix["negative"]] * mix["batch"]),
            "latent_seed": sub_seed(seed, "latents", i)}


def initial_latents(config: dict, mix: dict, x: dict, device) -> torch.Tensor:
    t, f = flops.latent_shape(config, mix["audio_seconds"])
    gen = torch.Generator(device=device).manual_seed(x["latent_seed"])
    return torch.randn(mix["batch"], t, f, config["unet"]["in_channels"], generator=gen, device=device)


def reference_call(ref, config: dict, mix: dict, x: dict, device, taps: dict, lowp=None) -> torch.Tensor:
    return text_to_audio(ref, config, x["pos"], x["neg"], initial_latents(config, mix, x, device),
                         guidance=mix["guidance"], steps=mix["steps"],
                         samples=int(mix["audio_seconds"] * config["vocoder"]["sampling_rate"]), taps=taps,
                         lowp=lowp)


def control(config: dict, mix: dict, seed: int, device) -> dict:
    """The control: the reference in the program's place with every
    product's operands, and the operands and result of each guidance and
    DDIM update, in fp8 (``reference/lowp.py``), against the float32
    reference, as ``edit.control``."""

    from h100_bench.reference.lowp import Fp8Products, fp8
    from h100_bench.reference.pipelines import timesteps

    ref = reference_models(config, NAMES, seed, device)
    err = {"cond_rel_err": [], "unet_rel_err": [], "ddim_rel_err": [], "decode_rel_err": [], "wav_rel_err": []}
    for i in range(mix["check_calls"]):
        x, low, want = call_inputs(config, mix, seed, i), {}, {}
        with Fp8Products():
            got = reference_call(ref, config, mix, x, device, low, lowp=fp8)
        wav = reference_call(ref, config, mix, x, device, want)
        err["cond_rel_err"].append(rel(low["class_labels"], want["class_labels"]))
        lat0 = initial_latents(config, mix, x, device)
        t0 = torch.full((2 * mix["batch"],), float(timesteps(Cfg(config["scheduler"]), mix["steps"])[0]), device=device)
        with torch.no_grad():
            out0 = ref["unet"](torch.cat([lat0, lat0]), t0, class_labels=low["class_labels"])
            dec = ref["vocoder"](ref["vae"].decode(low["latents"]))[:, : got.shape[-1]]
        err["unet_rel_err"].append(rel(low["unet_out0"], out0))
        err["ddim_rel_err"].append(control_ddim_err(config, mix, seed, i, mix["guidance"], low))
        err["decode_rel_err"] += rel_err(got.cpu().numpy(), dec)
        err["wav_rel_err"] += rel_err(got.cpu().numpy(), wav)
    del ref
    free()
    return {k: max(v) for k, v in err.items()}


class Driver:
    def __init__(self, config: dict, mix: dict, seed: int, device):
        from ap_adapter_torch.configs import UNetConfig
        from ap_adapter_torch.pipeline.audioldm_v1 import AudioLDMv1Modules, AudioLDMv1Pipeline

        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        ucfg = UNetConfig(**{k: tuples(v) for k, v in config["unet"].items()})
        mods = materialize_(AudioLDMv1Modules(port_config(config), ucfg), NAMES, seed, device, dtype_of(config))
        self.spec = {n: weight_spec(getattr(mods, n)) for n in NAMES}
        self.pipe = AudioLDMv1Pipeline(port_config(config), mods)
        self.clips = mix["batch"]
        self.capture = Capture(mods.unet, mods.vae.post_quant_conv, seed, mix["steps"], mix["check_steps"])
        self.captured = {}

    def unet(self):
        return self.pipe.modules.unet

    def inputs(self, i: int) -> dict:
        return call_inputs(self.config, self.mix, self.seed, i)

    def warmup_calls(self) -> list:
        return [0]

    def call(self, i: int, steps: int = 0) -> np.ndarray:
        from ap_adapter_torch.pipeline.pipeline import TextBatch

        x, m = self.inputs(i), self.mix
        unused = np.zeros((self.clips, 1), dtype=np.int32)          # v1 reads no T5 stream
        t5 = {"t5_ids": unused, "t5_mask": unused}
        if not steps:
            self.capture.start(i)
        out = self.pipe.generate(TextBatch(**x["pos"], **t5), TextBatch(**x["neg"], **t5),
                                 audio_length_in_s=m["audio_seconds"], num_inference_steps=steps or m["steps"],
                                 guidance_scale=m["guidance"], seed=x["latent_seed"])
        if not steps:
            self.captured[i] = self.capture.stop()
        return out

    def work(self, i: int) -> dict:
        return flops.v1_request(self.config, self.clips, self.mix["steps"], self.mix["audio_seconds"])

    def release(self):
        self.capture.remove()
        del self.pipe, self.capture
        free()

    def check(self, outputs: dict) -> dict:
        """Over ``check_calls`` completed calls drawn from the seed, the widest
        relative error against the float32 reference of: the conditioning
        (the CLAP class labels), the UNet's output at the kept steps (the
        reference UNet on the program's own inputs of that step), the
        latents that the guidance and DDIM update made from those steps
        (the reference's update of the program's own input and output), the
        decoded clip (the reference's decoders on the program's own latents)
        and the served clip (the reference run whole)."""

        m = self.mix
        calls = sample_calls(sorted(outputs), m["check_calls"], self.seed)
        ref = reference_models(self.config, NAMES, self.seed, self.device)
        check_spec(self.spec, ref)
        err = {"cond_rel_err": [], "unet_rel_err": [], "ddim_rel_err": [], "decode_rel_err": [], "wav_rel_err": []}
        for i in calls:
            x, taps, cap = self.inputs(i), {}, self.captured[i]
            want = reference_call(ref, self.config, m, x, self.device, taps)
            err["cond_rel_err"].append(rel(cap["unet"][0]["class_labels"], taps["class_labels"]))
            err["unet_rel_err"].append(unet_steps_err(ref["unet"], cap["unet"]))
            err["ddim_rel_err"].append(ddim_err(self.config, m["steps"], m["guidance"], cap["unet"]))
            err["decode_rel_err"] += decode_err(ref, self.config, cap["z"], outputs[i])
            err["wav_rel_err"] += rel_err(outputs[i], want)
        del ref
        free()
        return {**{k: max(v) for k, v in err.items()}, "clips_checked": len(err["wav_rel_err"])}
