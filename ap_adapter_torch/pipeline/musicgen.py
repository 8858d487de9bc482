"""MusicGen text-to-music: T5 text -> the decoder's cached decode loop with
classifier-free guidance and top-k sampling -> EnCodec.

Counterpart of transformers' ``MusicgenForConditionalGeneration.generate``
(Copet et al., arXiv 2306.05284) beside ``pipeline/audioldm_v1.py``. One
``generate`` call over B prompts:

* the T5 encoder on the padded ids, ``enc_to_dec_proj``, times the mask;
  the CFG null rows are zero states under a zero mask (transformers'
  ``guidance_scale > 1`` branch), so their cross-attention adds nothing;
* the 2B rows' cross K/V of every layer, hoisted once into the decode
  cache (``models/hoist.py``);
* one decoder forward a position after the BOS, each a replay of one
  captured graph on the card (``models/musicgen.py``), then on the device
  the CFG combine uncond + g (cond - uncond), top-k and a sample at the
  temperature (Gumbel-max, from a generator seeded with ``seed``), and the
  delay pattern's pads;
* the delay pattern reverted, EnCodec's decoder, the copy to the host.

Token ids come from the host (a tokenizer's, padded to a fixed length).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from ap_adapter_torch.configs import MusicGenConfig
from ap_adapter_torch.models.encodec import EncodecModel
from ap_adapter_torch.models.hoist import precompute_decoder_cross_kv
from ap_adapter_torch.models.musicgen import DecodeState, MusicgenForCausalLM, delay_pattern_mask, revert_delay_pattern
from ap_adapter_torch.models.t5 import T5Encoder
from ap_adapter_torch.pipeline.pipeline import Submodels
from ap_adapter_torch.utils import trace


class MusicGenModules(Submodels):
    """The submodels under transformers' ``MusicgenForConditionalGeneration``
    names: ``t5`` (``text_encoder``), ``enc_to_dec_proj``, ``decoder`` and
    ``encodec`` (``audio_encoder``, its decoder side)."""

    NAMES = ("t5", "enc_to_dec_proj", "decoder", "encodec")

    def __init__(self, config: MusicGenConfig):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.t5 = T5Encoder(config.t5)
            self.enc_to_dec_proj = nn.Linear(config.t5.d_model, config.decoder.hidden_size)
            self.decoder = MusicgenForCausalLM(config.decoder)
            self.encodec = EncodecModel(config.encodec)

    @property
    def device(self) -> torch.device:
        return self.enc_to_dec_proj.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.enc_to_dec_proj.weight.dtype


class MusicGenPipeline:
    """Text ids -> waveforms through MusicGen (module docstring)."""

    def __init__(self, config: MusicGenConfig, modules: MusicGenModules):
        self.config = config
        self.modules = modules
        self.state: Optional[DecodeState] = None          # the decode cache of the last call

    @classmethod
    def init_random(cls, config: MusicGenConfig, seed: int = 0, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> "MusicGenPipeline":
        """Random weights from ``seed`` (``Submodels.init_random``)."""

        return cls(config, MusicGenModules(config).init_random(seed, device, dtype))

    @classmethod
    def load_state_dicts(cls, config: MusicGenConfig, state_dicts: Mapping[str, Mapping[str, object]],
                         device="cuda", dtype: Optional[torch.dtype] = None) -> "MusicGenPipeline":
        """``{"t5", "enc_to_dec_proj", "decoder", "encodec": state dict}`` under
        transformers' key names, loaded strictly."""

        return cls(config, MusicGenModules(config).load_state_dicts(state_dicts, device, dtype))

    def decode_state(self, rows: int, length: int, text: int) -> DecodeState:
        """The decode cache for ``rows`` rows of ``length`` positions over
        ``text`` keys, kept from the last call where the sizes match."""

        m = self.modules
        if self.state is None or not self.state.matches(rows, length, text, m.device, m.dtype):
            self.state = None                   # the old cache's memory first
            self.state = DecodeState(self.config.decoder, rows, length, text, m.device, m.dtype)
        return self.state

    @torch.no_grad()
    def generate(
        self,
        t5_ids,
        t5_mask,
        *,
        seconds: float = 30.0,
        guidance_scale: Optional[float] = None,
        top_k: Optional[int] = None,
        temperature: Optional[float] = None,
        seed: int = 0,
        max_steps: Optional[int] = None,
    ) -> np.ndarray:
        """Waveforms [B, seconds x sampling rate] as numpy from T5 ids and mask
        [B, S] (the config's generation defaults where an argument is None).
        ``max_steps`` stops the decode loop early (a warm-up); the codes of
        the positions it leaves are 0."""

        c, m = self.config, self.modules
        dc = c.decoder
        g = c.guidance_scale if guidance_scale is None else guidance_scale
        k_top = c.top_k if top_k is None else top_k
        temp = c.temperature if temperature is None else temperature
        dev, dtype = m.device, m.dtype
        ids = torch.as_tensor(np.asarray(t5_ids), dtype=torch.long, device=dev)
        mask = torch.as_tensor(np.asarray(t5_mask), dtype=torch.long, device=dev)
        b, kb = ids.shape[0], dc.num_codebooks
        frames = int(round(seconds * c.encodec.frame_rate))
        length = frames + kb
        steps = length - 1 if max_steps is None else min(max_steps, length - 1)
        with trace.span("ap.generate", rows=b, steps=steps):
            with trace.span("ap.musicgen.text"):
                states = m.enc_to_dec_proj(m.t5(ids, mask).to(dtype)) * mask[..., None].to(dtype)
                states = torch.cat([states, torch.zeros_like(states)])          # CFG: cond rows, then null rows
                mask2 = torch.cat([mask, torch.zeros_like(mask)])
            with trace.span("ap.musicgen.hoist"):
                state = self.decode_state(2 * b, length, ids.shape[1])
                precompute_decoder_cross_kv(m.decoder, states, mask2, state)
                state.pos.zero_()
            with trace.span("ap.musicgen.decode"):
                gen = torch.Generator(device=dev).manual_seed(seed)
                pads = delay_pattern_mask(kb, length, dev)[:, :, None]            # [K, L, 1]
                seq = torch.zeros(b, kb, length, dtype=torch.long, device=dev)
                seq[:, :, 0] = dc.pad_token_id
                tok = seq[:, :, :1]
                for t in range(1, steps + 1):
                    logits = m.decoder(torch.cat([tok, tok]), state)[:, :, 0].float()     # [2B, K, V]
                    scores = torch.lerp(logits[b:], logits[:b], g)
                    if temp != 1.0:
                        scores = scores / temp
                    top, idx = scores.topk(k_top, dim=-1)
                    noise = torch.empty_like(top).exponential_(generator=gen)
                    tok = idx.gather(-1, (top - noise.log()).argmax(-1, keepdim=True))    # [B, K, 1]
                    tok = tok.masked_fill(pads[:, t], dc.pad_token_id)
                    seq[:, :, t: t + 1] = tok
            with trace.span("ap.encodec"):
                wav = m.encodec(revert_delay_pattern(seq))
            with trace.span("ap.to_host"):
                return wav[:, : int(seconds * c.encodec.sampling_rate)].float().cpu().numpy()
