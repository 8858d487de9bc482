"""What the traffic drivers share: the program's configuration built from a
configuration file, its weights and the reference's, and the comparison
of served waveforms."""

from __future__ import annotations

import gc
from typing import Dict, Iterable, List

import numpy as np
import torch

from h100_bench.inputs import fill_weights_, sub_seed, tuples, weight_spec

GROUPS = ("fbank", "mel", "audiomae", "clap", "t5", "gpt2", "projection", "unet", "vae", "vocoder", "scheduler")


def dtype_of(config: dict) -> torch.dtype:
    return getattr(torch, config["dtype"])


def port_config(config: dict):
    """The program's ``PipelineConfig`` for a configuration file."""

    from ap_adapter_torch import configs as pc

    classes = {"fbank": pc.FbankConfig, "mel": pc.MelConfig, "audiomae": pc.AudioMAEConfig,
               "clap": pc.ClapTextConfig, "t5": pc.T5Config, "gpt2": pc.GPT2Config,
               "projection": pc.ProjectionConfig, "unet": pc.UNetConfig, "vae": pc.VAEConfig,
               "vocoder": pc.VocoderConfig, "scheduler": pc.SchedulerConfig}
    groups = {g: classes[g](**{k: tuples(v) for k, v in config[g].items()}) for g in GROUPS if g in config}
    return pc.PipelineConfig(**groups, dtype=dtype_of(config),
                             hoist_step_invariants=config.get("hoist_step_invariants", True))


def materialize_(modules, names: Iterable[str], seed: int, device, dtype: torch.dtype):
    """Module tree built on the meta device -> ``dtype`` on ``device``, each
    submodel ``name`` filled from its own seed (``fill_weights_``)."""

    modules.to(dtype=dtype)
    modules.to_empty(device=device)
    for name in names:
        fill_weights_(getattr(modules, name), sub_seed(seed, "weights", name), dtype)
    return modules


def reference_models(config: dict, names, seed: int, device) -> Dict[str, torch.nn.Module]:
    """The reference's submodels in float32 with the values the program got
    (the same draws in the served dtype, then widened)."""

    from h100_bench.reference.pipelines import build

    models = build(config, names, device)
    for name, m in models.items():
        fill_weights_(m, sub_seed(seed, "weights", name), dtype_of(config))
    return models


def check_spec(spec: Dict[str, list], reference: Dict[str, torch.nn.Module]) -> None:
    """The reference has the program's parameter names and shapes (``spec``,
    taken from the program's modules), so both got the same weights."""

    for name, m in reference.items():
        if spec[name] != weight_spec(m):
            raise RuntimeError(f"reference {name}: parameter names or shapes differ from the program's")


def free() -> None:
    """Return the freed device memory to the card."""

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _finite(r: float) -> float:
    """NaN as infinite, so that the widest of several errors never drops it."""

    return r if r == r else float("inf")


def rel_err(got: np.ndarray, want: torch.Tensor) -> List[float]:
    """Per clip: ||got - want|| / ||want||; infinite where the shapes differ
    or the error is not a number."""

    want = want.double().cpu().numpy()
    got = np.asarray(got, dtype=np.float64)
    if got.shape != want.shape:
        return [float("inf")]
    return [_finite(float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))) for g, w in zip(got, want)]


def kept_steps(seed: int, i: int, steps: int, keep: int) -> set:
    """The denoise steps of call ``i`` whose UNet call the output check
    reads: the first, and ``keep`` more drawn from the seed among those
    that have a next step. The first is always read because there the
    update meets latents that no step has rounded yet: later in a run on
    random weights the update is nearly a uniform scaling of the latents,
    which a state kept one precision lower carries with almost no loss."""

    rng = np.random.default_rng(sub_seed(seed, "steps", i))
    rest = rng.choice(np.arange(1, steps - 1), size=min(keep, steps - 2), replace=False) if steps > 2 else []
    return {0, *map(int, rest)}


class Capture:
    """Hooks on the program's modules that keep, for the call being run,
    what the output check reads besides the served clips: the UNet's inputs
    and output at the forwards ``kept_steps`` names, the input of
    the forward after each of those (the latents the guidance and the DDIM
    update made), and the VAE decoder's input. References only: no copy,
    no wait; returning None, the hooks change nothing the program computes."""

    def __init__(self, unet, post_quant_conv, seed: int, steps: int, keep: int):
        self.seed, self.steps, self.keep = seed, steps, keep
        self.cur = None
        self._handles = [unet.register_forward_hook(self._unet, with_kwargs=True),
                         post_quant_conv.register_forward_pre_hook(self._decoder)]

    def start(self, i: int) -> None:
        self.cur = {"keep": kept_steps(self.seed, i, self.steps, self.keep), "n": 0, "unet": [], "z": None}

    def stop(self) -> dict:
        cur, self.cur = self.cur, None
        return cur

    def _unet(self, module, args, kwargs, out):
        c = self.cur
        if c is not None:
            if c["unet"] and c["unet"][-1]["k"] == c["n"] - 1:
                c["unet"][-1]["next"] = args[0]
            if c["n"] in c["keep"]:
                names = ("sample", "t", "ehs0", "ehs1", "mask1")
                c["unet"].append({**dict(zip(names, args)), "ip_scale": kwargs.get("ip_scale", 0.0),
                                  "class_labels": kwargs.get("class_labels"), "out": out, "k": c["n"]})
            c["n"] += 1

    def _decoder(self, module, args):
        if self.cur is not None:
            self.cur["z"] = args[0]

    def remove(self) -> None:
        for h in self._handles:
            h.remove()


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| over the whole tensor, in float64; infinite
    where the shapes differ or the error is not a number."""

    if got.shape != want.shape:
        return float("inf")
    got, want = got.detach().double(), want.detach().double().to(got.device)
    return _finite(float((got - want).norm() / want.norm().clamp_min(1e-300)))


@torch.no_grad()
def unet_steps_err(ref_unet, captured: list) -> float:
    """The widest relative error of the program's kept UNet outputs against
    the reference UNet run on the program's own inputs of those steps."""

    errs = []
    for s in captured:
        f = lambda x: None if x is None else x.float()
        want = ref_unet(s["sample"].float(), f(s["t"]), f(s.get("ehs0")), f(s.get("ehs1")), s.get("mask1"),
                        s["ip_scale"], f(s["class_labels"]))
        errs.append(rel(s["out"], want))
    return max(errs)


@torch.no_grad()
def ddim_err(config: dict, steps: int, guidance: float, captured: list) -> float:
    """The widest relative error of the latents that the program's guidance
    and DDIM update made at the kept steps (the next UNet call's input)
    against the reference's float32 update of the program's own input and
    output of that step."""

    from h100_bench.reference.common import Cfg
    from h100_bench.reference.pipelines import ddim_update

    errs = []
    for s in captured:
        want = ddim_update(s["sample"].float().chunk(2)[0], s["out"], int(s["t"][0]), Cfg(config["scheduler"]),
                           steps, guidance)
        errs.append(rel(s["next"].chunk(2)[0], want) if "next" in s else float("inf"))
    return max(errs)


def control_ddim_err(config: dict, mix: dict, seed: int, i: int, guidance: float, taps: dict) -> float:
    """``ddim_err`` of the control at the steps a run keeps for call ``i``,
    from its taps (every step's latents and output)."""

    from h100_bench.reference.common import Cfg
    from h100_bench.reference.pipelines import timesteps

    ts, steps = timesteps(Cfg(config["scheduler"]), mix["steps"]), taps["steps"]
    return ddim_err(config, mix["steps"], guidance, [
        {"sample": torch.cat([steps[k][0]] * 2), "out": steps[k][1], "t": torch.tensor([int(ts[k])]),
         "next": torch.cat([steps[k + 1][0]] * 2)}
        for k in sorted(kept_steps(seed, i, mix["steps"], mix["check_steps"]))])


@torch.no_grad()
def decode_err(ref: dict, config: dict, z: torch.Tensor, wav: np.ndarray) -> List[float]:
    """Per clip: the program's clip against the reference's VAE decoder and
    vocoder run on the program's own decoder input ``z`` (NCHW, latents over
    the scaling factor)."""

    lat = z.float().permute(0, 2, 3, 1) * config["vae"]["scaling_factor"]
    want = ref["vocoder"](ref["vae"].decode(lat))[:, : wav.shape[-1]]
    return rel_err(wav, want)


def sample_calls(done: List[int], k: int, seed: int) -> List[int]:
    """``k`` of the completed calls, drawn from the seed."""

    rng = np.random.default_rng(sub_seed(seed, "check"))
    return sorted(rng.choice(done, size=min(k, len(done)), replace=False).tolist())
