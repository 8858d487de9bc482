"""CLAP text-audio similarity scoring, the re-ranking of ``generate_ranked``.

Counterpart of ``ap_adapter_tpu/eval/clap_scoring.py`` (the reference's
``score_waveforms``, pipeline_audioldm2.py:592-614): resample to 48 kHz,
"repeatpad" to the extractor's length, the CLAP log-mel
(``audio/mel.py::clap_log_mel``), the HTSAT audio tower against the CLAP
text tower, argsort. Both towers run on the scorer's device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ap_adapter_torch.audio.dsp import resample
from ap_adapter_torch.audio.mel import clap_log_mel
from ap_adapter_torch.models.clap import ClapTextEncoder
from ap_adapter_torch.models.clap_audio import ClapAudioTower


class ClapScorer:
    """Text-audio similarity with CLAP: the port's ``ClapTextEncoder`` and
    ``ClapAudioTower``, moved to ``device`` (the card unless asked)."""

    def __init__(self, text_model: ClapTextEncoder, audio_model: ClapAudioTower, device="cuda"):
        self.device = torch.device(device)
        self.text_model = text_model.to(self.device).eval()
        self.audio_model = audio_model.to(self.device).eval()
        self.text_config, self.audio_config = text_model.config, audio_model.config

    @torch.no_grad()
    def text_features(self, input_ids: np.ndarray, attention_mask: np.ndarray) -> np.ndarray:
        ids, mask = (torch.as_tensor(np.asarray(a), dtype=torch.long, device=self.device)
                     for a in (input_ids, attention_mask))
        return self.text_model(ids, mask).float().cpu().numpy()

    @torch.no_grad()
    def audio_features(self, waveform: np.ndarray, sample_rate: int) -> np.ndarray:
        """waveform [N] or [B, N] -> normalised audio embeddings [B, proj_dim]."""

        c = self.audio_config
        wav = torch.as_tensor(np.atleast_2d(waveform), dtype=torch.float32, device=self.device)
        if sample_rate != c.sampling_rate:
            wav = resample(wav, sample_rate, c.sampling_rate)
        max_len = c.max_length_s * c.sampling_rate
        n = wav.shape[-1]
        if n < max_len:      # "repeatpad": tile, then zero-pad (HF's non-fusion path)
            wav = wav.repeat(1, max_len // n)
            wav = F.pad(wav, (0, max_len - wav.shape[-1]))
        else:
            wav = wav[:, :max_len]
        mel = clap_log_mel(wav, sr=c.sampling_rate, n_fft=c.n_fft, hop=c.hop_length, n_mels=c.num_mel_bins,
                           fmin=c.frequency_min, fmax=c.frequency_max)
        return self.audio_model(mel[:, None]).float().cpu().numpy()

    def similarities(self, text_input_ids: np.ndarray, text_attention_mask: np.ndarray,
                     waveforms: Sequence[np.ndarray], sample_rate: int) -> np.ndarray:
        """[len(waveforms)] CLAP similarities to the first prompt of the batch."""

        text = self.text_features(text_input_ids, text_attention_mask)[0]
        return self.audio_features(np.stack(list(waveforms)), sample_rate) @ text

    def rank(self, text_input_ids: np.ndarray, text_attention_mask: np.ndarray,
             waveforms: Sequence[np.ndarray], sample_rate: int) -> np.ndarray:
        """Indices of ``waveforms`` sorted by CLAP similarity, best first."""

        return np.argsort(self.similarities(text_input_ids, text_attention_mask, waveforms, sample_rate))[::-1]
