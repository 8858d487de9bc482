"""AudioLDM2 + audio-prompt-adapter generation in PyTorch.

Counterpart of ``ap_adapter_tpu/pipeline/pipeline.py``: text conditioning
(CLAP + T5 -> projection -> GPT-2), AudioMAE conditioning with time/freq
pooling and a zeros-fbank unconditional branch, the step-invariant precompute
(``models/hoist.py``), the classifier-free-guidance DDIM loop over the
dual-stream UNet with the adapter live, VAE decode and HiFi-GAN vocoding.
Token ids come from the host (``pipeline/tokenize.py``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ap_adapter_torch.audio.dsp import resample
from ap_adapter_torch.audio.fbank import audiomae_fbank
from ap_adapter_torch.configs import PipelineConfig
from ap_adapter_torch.diffusion.ddim import inference_timesteps
from ap_adapter_torch.diffusion.sampling import ddim_sample_loop
from ap_adapter_torch.models.audiomae import AudioMAECondition
from ap_adapter_torch.models.clap import ClapTextEncoder
from ap_adapter_torch.models.gpt2 import GPT2Model, generate_hidden_states
from ap_adapter_torch.models.hoist import precompute_cross_kv, precompute_temb_rows
from ap_adapter_torch.models.layers import NORM_TYPES
from ap_adapter_torch.models.projection import ProjectionModel
from ap_adapter_torch.models.t5 import T5Encoder
from ap_adapter_torch.models.unet import AudioLDM2UNet, prepare_resnet_kernel_weights_, quantize_unet_int8_
from ap_adapter_torch.models.vae import AutoencoderKL
from ap_adapter_torch.models.vocoder import HiFiGAN
from ap_adapter_torch.parallel.tp import tp_shard_unet_

_ONES = ("scale", "sos_embed", "eos_embed", "sos_embed_1", "eos_embed_1")


@torch.no_grad()
def fill_random_(module: nn.Module, seed: int) -> nn.Module:
    """Random weights in place, drawn on the module's device from a seeded
    ``torch.Generator``: ones for norm scales and the sos/eos embeddings,
    zeros for biases, N(0, 0.02) for everything else (the JAX package's
    fast_init rules). Buffers keep their values."""

    device = next(module.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    for m in module.modules():
        for name, p in m.named_parameters(recurse=False):
            if name == "bias":
                p.zero_()
            elif isinstance(m, NORM_TYPES) or name in _ONES:
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=gen)
    return module


@dataclasses.dataclass(frozen=True)
class TextBatch:
    """Tokenized prompts, padded to fixed lengths: numpy arrays or tensors [B, S]."""

    clap_ids: object
    clap_mask: object
    t5_ids: object
    t5_mask: object

    def to(self, device) -> "TextBatch":
        return TextBatch(*(torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                                           dtype=torch.long, device=device)
                           for a in dataclasses.astuple(self)))

    def repeat_interleave(self, n: int) -> "TextBatch":
        """Each prompt's row ``n`` times in a row, as tensors."""

        return TextBatch(*(torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a).repeat_interleave(n, 0)
                           for a in dataclasses.astuple(self)))

    @staticmethod
    def cat(first: "TextBatch", second: "TextBatch") -> "TextBatch":
        return TextBatch(*(torch.cat([a, b]) for a, b in zip(dataclasses.astuple(first),
                                                            dataclasses.astuple(second))))


class Submodels(nn.Module):
    """Named submodels (``NAMES``) built on the meta device (no memory):
    ``init_random`` or ``load_state_dicts`` materializes the weights on a
    device."""

    NAMES: Tuple[str, ...] = ()

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.unet.conv_in.weight.dtype

    @torch.no_grad()
    def init_random(self, seed: int = 0, device="cuda", dtype: Optional[torch.dtype] = None) -> "Submodels":
        """Random weights, drawn on ``device`` from a seeded ``torch.Generator``:
        ones for norm scales and the sos/eos embeddings, zeros for biases,
        N(0, 0.02) for everything else (the JAX package's fast_init rules)."""

        self.to_empty(device=device)
        return fill_random_(self.to(dtype or self.config.dtype), seed)

    def load_state_dicts(self, state_dicts: Mapping[str, Mapping[str, object]], device="cuda",
                         dtype: Optional[torch.dtype] = None) -> "Submodels":
        """Load ``{submodel name: HF/diffusers state dict}`` (numpy arrays or
        tensors) strictly, the VAE's encoder and decoder both."""

        dtype = dtype or self.config.dtype
        for name in self.NAMES:
            module = getattr(self, name)
            own = set(module.state_dict())
            sd = {k: torch.as_tensor(np.asarray(v)) for k, v in state_dicts[name].items()}
            extra = [k for k in sd if k not in own]
            if extra:
                raise KeyError(f"{name}: unexpected keys {extra[:5]}")
            module.load_state_dict(sd, strict=True, assign=True)
        return self.to(device=device, dtype=dtype)


class PipelineModules(Submodels):
    """Every submodel of one PipelineConfig."""

    NAMES = ("clap", "t5", "gpt2", "projection", "audiomae", "unet", "vae", "vocoder")

    def __init__(self, config: PipelineConfig):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.clap = ClapTextEncoder(config.clap)
            self.t5 = T5Encoder(config.t5)
            self.gpt2 = GPT2Model(config.gpt2)
            self.projection = ProjectionModel(config.projection)
            self.audiomae = AudioMAECondition(config.audiomae)
            self.unet = AudioLDM2UNet(config.unet)
            self.vae = AutoencoderKL(config.vae)
            self.vocoder = HiFiGAN(config.vocoder)

    # -- conditioning --------------------------------------------------------

    def encode_prompt(self, text: TextBatch):
        """(t5_hidden [B, St, D1], t5_mask [B, St], gpt2_tokens [B, 8, D0])."""

        clap_feat = self.clap(text.clap_ids, text.clap_mask)[:, None, :]
        clap_mask = torch.ones(clap_feat.shape[0], 1, dtype=text.t5_mask.dtype, device=clap_feat.device)
        t5_hidden = self.t5(text.t5_ids, text.t5_mask)
        proj, proj_mask = self.projection(clap_feat, t5_hidden, clap_mask, text.t5_mask)
        gpt2_tokens = generate_hidden_states(self.gpt2, proj, proj_mask, self.config.gpt2.max_new_tokens)
        return t5_hidden, text.t5_mask, gpt2_tokens

    def encode_audio(self, fbank: torch.Tensor, time_pool: int, freq_pool: int) -> torch.Tensor:
        """Pooled AudioMAE tokens of [zeros; fbank]: the zeros fbank is the
        unconditional branch of classifier-free guidance."""

        return self.audiomae(torch.cat([torch.zeros_like(fbank), fbank]), time_pool, freq_pool)

    # -- generation ----------------------------------------------------------

    @torch.no_grad()
    def generate_waveform(
        self,
        fbank: Optional[torch.Tensor],
        text_pos: TextBatch,
        text_neg: TextBatch,
        *,
        num_inference_steps: int,
        guidance_scale: float,
        ap_scale: float,
        time_pool: int,
        freq_pool: int,
        latent_time: int,
        init_latents: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        rows: Optional[Tuple[int, int]] = None,
    ) -> torch.Tensor:
        """Text + audio (fbank [B, T, F], or None for text only) -> waveforms
        [B, latent_time * vae_scale * vocoder_upsample], fp32. ``rows``
        (first row, global batch): the B rows are those rows of a global
        batch, whose initial latents are drawn whole and sliced, so a data
        rank's clips are the single process's clips of those rows."""

        c = self.config
        b = text_pos.clap_ids.shape[0]
        latent_freq = c.vocoder.model_in_dim // c.vae.scale_factor
        if init_latents is None:
            first, total = (0, b) if rows is None else rows
            latents = torch.randn(total, latent_time, latent_freq, c.unet.in_channels,
                                  generator=generator, device=self.device, dtype=torch.float32)[first: first + b]
        else:
            latents = torch.as_tensor(init_latents, dtype=torch.float32, device=self.device)
        return self.denoise_to_waveform(latents, fbank, text_pos, text_neg,
                                        num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
                                        ap_scale=ap_scale, time_pool=time_pool, freq_pool=freq_pool)

    @torch.no_grad()
    def denoise_to_waveform(
        self,
        latents: torch.Tensor,
        fbank: Optional[torch.Tensor],
        text_pos: TextBatch,
        text_neg: TextBatch,
        *,
        num_inference_steps: int,
        guidance_scale: float,
        ap_scale: float,
        time_pool: int,
        freq_pool: int,
        timesteps: Optional[np.ndarray] = None,
    ) -> torch.Tensor:
        """The conditioning of [negative; positive] prompts and of the fbank
        (None: text only), the step invariants, the CFG DDIM loop from fp32
        ``latents`` over ``timesteps`` (default: the whole schedule), VAE
        decode and the vocoder -> waveforms, fp32."""

        c = self.config
        dev, dtype = self.device, self.dtype
        text_pos, text_neg = text_pos.to(dev), text_neg.to(dev)
        # CFG order: uncond (negative) first
        t5_hidden, t5_mask, gpt2_tokens = self.encode_prompt(TextBatch.cat(text_neg, text_pos))
        ehs0 = gpt2_tokens
        if fbank is not None:
            audio = self.encode_audio(torch.as_tensor(fbank, device=dev), time_pool, freq_pool)
            ehs0 = torch.cat([gpt2_tokens, audio.to(gpt2_tokens.dtype)], dim=1)
        ts = inference_timesteps(c.scheduler, num_inference_steps) if timesteps is None else timesteps

        ctx_kv = temb = None
        if c.hoist_step_invariants:
            if not c.unet.use_int8:
                # int8 sites project K/V in the step, with the T5 bias built
                # from the mask (JAX pipeline.py:272-277)
                ctx_kv = precompute_cross_kv(self.unet, ehs0, t5_hidden, t5_mask)
            temb = precompute_temb_rows(self.unet, ts)

        def unet_fn(model_in, t, i):
            t_batch = torch.full((model_in.shape[0],), float(t), device=dev)
            rows = {k: v[i] for k, v in temb.items()} if temb is not None else None
            return self.unet(model_in.to(dtype), t_batch, ehs0, t5_hidden, t5_mask, ip_scale=ap_scale,
                             ctx_kv=ctx_kv, temb_rows=rows)

        latents = ddim_sample_loop(unet_fn, latents, c.scheduler, num_inference_steps, guidance_scale,
                                   timesteps=ts)
        mel = self.vae.decode((latents / c.vae.scaling_factor).to(dtype))   # [B, T, F, 1]
        return self.vocoder(mel[..., 0].float()).float()


def read_checkpoint_dir(directory: str) -> Dict[str, Dict[str, np.ndarray]]:
    """The ``<submodel>.npz`` state dicts of a ``--checkpoint-dir``, one per
    ``PipelineModules.NAMES``, as ``python -m ap_adapter_torch.convert.cli``
    writes them from the public AudioLDM2 directory."""

    sds = {}
    for name in PipelineModules.NAMES:
        path = os.path.join(directory, f"{name}.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path} is missing: write the directory with python -m "
                                    f"ap_adapter_torch.convert.cli (audiomae.npz needs its --audiomae-ckpt)")
        with np.load(path) as f:
            sds[name] = {k: f[k] for k in f.files}
    return sds


class AudioLDM2Pipeline:
    """User-facing pipeline: owns the modules on one device. With
    ``config.unet.use_int8`` it quantizes the UNet's int8 serving weights
    once, here (JAX pipeline.py:374-380); with ``use_pallas_resnet`` it
    prepares K13's HWIO conv weights once.

    ``mesh`` (``parallel/mesh.py``): data-parallel serving over its ``data``
    axis, each rank generating its own rows of a global batch (JAX
    pipeline.py:545-552); no collective. ``tensor_parallel``: the UNet's
    transformer stacks split by heads over the ``model`` axis, which must
    be larger than 1 (``parallel/tp.py``), and ``force_xla_core`` on with
    ``use_int8`` off, as JAX's pipeline.py:318-338 sets them: the modules'
    configs are replaced and their UNet is sharded in place, so load the
    weights and the adapter before."""

    def __init__(self, config: PipelineConfig, modules: PipelineModules, mesh=None, tensor_parallel: bool = False):
        if tensor_parallel and (mesh is None or mesh.shape["model"] <= 1):
            raise ValueError("tensor_parallel=True needs a mesh with a 'model' axis of size > 1 (got mesh="
                             f"{None if mesh is None else mesh.shape})")
        self.mesh = mesh
        if tensor_parallel:
            config = config.replace(unet=dataclasses.replace(config.unet, force_xla_core=True, use_int8=False))
            if modules is not None:
                modules.config, modules.unet.config = config, config.unet
                tp_shard_unet_(modules.unet, mesh)
        self.config = config
        self.modules = modules
        if config.unet.use_int8 and modules is not None:
            quantize_unet_int8_(modules.unet)
        if config.unet.use_pallas_resnet and modules is not None:
            prepare_resnet_kernel_weights_(modules.unet)

    @classmethod
    def from_random(cls, config: PipelineConfig, seed: int = 0, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> "AudioLDM2Pipeline":
        return cls(config, PipelineModules(config).init_random(seed, device, dtype))

    def latent_time_for_seconds(self, seconds: float) -> int:
        """mel frames = seconds / (upsample_factor / sr), rounded up to the VAE
        scale; latent frames = frames / vae_scale."""

        c = self.config
        frame_s = c.vocoder.upsample_factor / c.vocoder.sampling_rate
        height = int(seconds / frame_s)
        scale = c.vae.scale_factor
        if height % scale != 0:
            height = ((height // scale) + 1) * scale
        return height // scale

    def prepare_fbank(self, waveform: np.ndarray, sample_rate: int) -> torch.Tensor:
        """Host wav -> normalized AudioMAE fbank [1, T, F] (fp32, on the CPU):
        channels averaged, resampled to the fbank rate (``audio/dsp.py``),
        Kaldi fbank (``audio/fbank.py``). The counterpart of the JAX
        ``prepare_fbank`` (pipeline.py:471), which also keeps this off the
        accelerator."""

        wav = torch.as_tensor(np.atleast_2d(waveform).mean(axis=0), dtype=torch.float32)
        if sample_rate != self.config.fbank.sample_rate:
            wav = resample(wav, sample_rate, self.config.fbank.sample_rate)
        return audiomae_fbank(wav, self.config.fbank)[None]

    def generate(
        self,
        text_pos: TextBatch,
        text_neg: TextBatch,
        fbank,
        *,
        audio_length_in_s: float = 10.0,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        ap_scale: float = 0.5,
        time_pool: int = 2,
        freq_pool: int = 2,
        seed: int = 0,
        materialize: bool = True,
    ):
        """Waveforms [B, samples] trimmed to ``audio_length_in_s``, as numpy
        (``fbank`` None: text only). ``materialize=False`` returns the fp32
        tensor on the pipeline's device without waiting for it, so that host
        work can overlap the device's (the eval runner's sweep). With a
        mesh, the B rows are this rank's rows of the global batch (B x the
        ``data`` axis): its latents are those rows of the global draw from
        ``seed``."""

        dev = self.modules.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        b = np.shape(text_pos.clap_ids)[0]
        wav = self.modules.generate_waveform(
            fbank, text_pos, text_neg, num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, ap_scale=ap_scale, time_pool=time_pool,
            freq_pool=freq_pool, latent_time=self.latent_time_for_seconds(audio_length_in_s),
            generator=gen, rows=None if self.mesh is None else self.mesh.rows(b))
        samples = int(audio_length_in_s * self.config.vocoder.sampling_rate)
        return wav[:, :samples].cpu().numpy() if materialize else wav[:, :samples]

    def generate_ranked(self, text_pos: TextBatch, text_neg: TextBatch, fbank=None, *,
                        num_waveforms_per_prompt: int = 1, scorer=None, **kwargs) -> np.ndarray:
        """``num_waveforms_per_prompt`` candidates per prompt from one
        ``generate`` call (each prompt's text rows and fbank repeated), each
        prompt's group re-ranked best first by ``scorer.rank``
        (``eval/clap_scoring.py::ClapScorer``), the reference's
        ``num_waveforms_per_prompt`` + ``score_waveforms``
        (pipeline_audioldm2.py:592-614, 1047-1054; JAX pipeline.py:564-607).
        Without a scorer, or with one candidate, generation order is kept.
        Returns [B * n, samples], grouped by prompt; runs on the pipeline's
        device."""

        n = num_waveforms_per_prompt
        if n > 1:
            text_pos, text_neg = text_pos.repeat_interleave(n), text_neg.repeat_interleave(n)
            if fbank is not None:
                fbank = torch.as_tensor(fbank).repeat_interleave(n, 0)
        wavs = self.generate(text_pos, text_neg, fbank, **kwargs)
        if scorer is None or n == 1:
            return wavs
        sr = self.config.vocoder.sampling_rate
        out = np.empty_like(wavs)
        for i in range(wavs.shape[0] // n):
            group = wavs[i * n:(i + 1) * n]
            ids = np.asarray(text_pos.clap_ids[i * n:i * n + 1].cpu())
            mask = np.asarray(text_pos.clap_mask[i * n:i * n + 1].cpu())
            out[i * n:(i + 1) * n] = group[scorer.rank(ids, mask, list(group), sr)]
        return out
