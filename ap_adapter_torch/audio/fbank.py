"""Kaldi-compatible log-mel filterbank for AudioMAE, in PyTorch.

Counterpart of ``ap_adapter_tpu/audio/fbank.py``: ``torchaudio.compliance.kaldi.fbank``
for the argument set the reference uses (htk_compat, no energy, Hann window,
128 bins, no dither, 10 ms shift, snip edges): frames, DC removal,
pre-emphasis, symmetric Hann window, zero-pad to 512, rFFT power spectrum and
a [frames, 257] x [257, 128] mel product.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ap_adapter_torch.audio.dsp import frame_signal, hanning_window
from ap_adapter_torch.audio.mel import _fit_last
from ap_adapter_torch.configs import FbankConfig

_F32_EPS = float(np.finfo(np.float32).eps)


def _mel_scale(freq: np.ndarray) -> np.ndarray:
    return 1127.0 * np.log(1.0 + freq / 700.0)


@functools.lru_cache(maxsize=8)
def kaldi_mel_banks(num_bins: int, padded_window_size: int, sample_rate: int, low_freq: float,
                    high_freq: float) -> np.ndarray:
    """Kaldi's triangular mel filterbank [num_fft_bins + 1, num_bins]; the last
    (Nyquist) row is zero."""

    if high_freq <= 0.0:
        high_freq = 0.5 * sample_rate + high_freq
    num_fft_bins = padded_window_size // 2
    mel_low, mel_high = _mel_scale(np.array(low_freq)), _mel_scale(np.array(high_freq))
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    bins = np.arange(num_bins, dtype=np.float64)[:, None]
    left = mel_low + bins * mel_delta
    center = mel_low + (bins + 1.0) * mel_delta
    right = mel_low + (bins + 2.0) * mel_delta
    mel = _mel_scale(sample_rate / padded_window_size * np.arange(num_fft_bins, dtype=np.float64)[None, :])
    weights = np.maximum(0.0, np.minimum((mel - left) / (center - left), (right - mel) / (right - center)))
    weights = np.concatenate([weights, np.zeros((num_bins, 1))], axis=1)
    return weights.T.astype(np.float32)


def kaldi_fbank(waveform: torch.Tensor, config: FbankConfig = FbankConfig()) -> torch.Tensor:
    """waveform [..., N] at config.sample_rate -> log-mel fbank [..., frames, bins]."""

    frames = frame_signal(waveform.float(), config.frame_length, config.frame_shift)
    if config.remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if config.preemphasis != 0.0:
        # kaldi: x[i] -= coeff * x[i-1], with x[-1] := x[0]
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - config.preemphasis * prev
    window = torch.as_tensor(hanning_window(config.frame_length, periodic=False), dtype=torch.float32,
                             device=frames.device)
    frames = F.pad(frames * window, (0, config.padded_window_size - config.frame_length))
    spectrum = torch.fft.rfft(frames, dim=-1)
    power = spectrum.real.square() + spectrum.imag.square()
    if not config.use_power:
        power = power.sqrt()
    banks = torch.as_tensor(kaldi_mel_banks(config.num_mel_bins, config.padded_window_size, config.sample_rate,
                                            config.low_freq, config.high_freq), device=frames.device)
    return torch.log(torch.clamp(power @ banks, min=_F32_EPS))


def audiomae_fbank(waveform: torch.Tensor, config: FbankConfig = FbankConfig()) -> torch.Tensor:
    """The AudioMAE front end (reference ``extract_kaldi_fbank_feature``):
    mean-subtract, fbank, pad/cut to ``config.target_frames``, AudioSet
    normalisation. 16 kHz input; returns [..., target_frames, num_mel_bins]."""

    fbank = kaldi_fbank(waveform - waveform.mean(dim=-1, keepdim=True), config)
    fbank = _fit_last(fbank, config.target_frames, -2)
    return (fbank - config.norm_mean) / (config.norm_std * 2.0)
