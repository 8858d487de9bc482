"""Log-mel front ends in PyTorch: the Tacotron-style 64-bin mel of the VAE
and the CLAP audio tower's 48 kHz dB mel.

Counterpart of ``ap_adapter_tpu/audio/mel.py``. The VAE's (the ``audioldm``
package's ``TacotronSTFT`` numerics as the reference trainer uses them):
1024-point STFT, hop 160, periodic Hann, reflection centre padding, librosa
slaney-scale/slaney-norm mel filterbank (64 bins, 0-8 kHz), and
dynamic-range compression ln(clamp(x, 1e-5)). CLAP's (transformers
``ClapFeatureExtractor``): a centred power spectrogram, slaney or HTK mel
filters, 10·log10(max(x, 1e-10)).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ap_adapter_torch.audio.dsp import frame_signal, hanning_window, normalize_wav
from ap_adapter_torch.configs import MelConfig


def _hz_to_slaney_mel(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _slaney_mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), m * f_sp)


def _hz_to_htk_mel(f: np.ndarray) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _htk_mel_to_hz(m: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_banks(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float, htk: bool = False,
              norm_slaney: bool = True) -> np.ndarray:
    """Triangular mel filterbank [1 + n_fft//2, n_mels], librosa's (slaney
    scale) or HTK's, with or without slaney area normalisation."""

    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    to_mel, from_mel = (_hz_to_htk_mel, _htk_mel_to_hz) if htk else (_hz_to_slaney_mel, _slaney_mel_to_hz)
    mel_pts = from_mel(np.linspace(to_mel(np.array(fmin)), to_mel(np.array(fmax)), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm_slaney:
        weights *= (2.0 / (mel_pts[2: n_mels + 2] - mel_pts[:n_mels]))[:, None]
    return weights.T.astype(np.float32)


def slaney_mel_banks(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """librosa.filters.mel(htk=False, norm='slaney') as [1 + n_fft//2, n_mels]."""

    return mel_banks(sr, n_fft, n_mels, fmin, fmax)


def _centred_frames(waveform: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """fp32 frames [..., T, n_fft] of ``waveform`` [..., N], reflection-padded
    by n_fft // 2 at both ends."""

    lead = waveform.shape[:-1]
    x = waveform.float().reshape(-1, 1, waveform.shape[-1])
    x = F.pad(x, (n_fft // 2, n_fft // 2), mode="reflect").reshape(*lead, -1)
    return frame_signal(x, n_fft, hop)


def clap_log_mel(waveform: torch.Tensor, sr: int = 48_000, n_fft: int = 1024, hop: int = 480, n_mels: int = 64,
                 fmin: float = 0.0, fmax: float = 14_000.0, htk: bool = False) -> torch.Tensor:
    """waveform [..., N] at 48 kHz -> dB log-mel [..., frames, n_mels]:
    transformers ``ClapFeatureExtractor._np_extract_fbank_features``, a
    centred power spectrogram with a periodic Hann, the mel product, then
    ``10·log10(max(x, 1e-10))``. Slaney filters (htk=False) are the
    extractor's non-fusion path, HTK filters its fusion path."""

    frames = _centred_frames(waveform, n_fft, hop)
    window = torch.as_tensor(hanning_window(n_fft, periodic=True), dtype=torch.float32, device=frames.device)
    spectrum = torch.fft.rfft(frames * window, dim=-1)
    power = spectrum.real.square() + spectrum.imag.square()
    banks = torch.as_tensor(mel_banks(sr, n_fft, n_mels, fmin, fmax, htk=htk, norm_slaney=not htk),
                            device=frames.device)
    return 10.0 * torch.log10(torch.clamp(power @ banks, min=1e-10))


def tacotron_mel(waveform: torch.Tensor, config: MelConfig = MelConfig()) -> torch.Tensor:
    """waveform [..., N] -> log-mel [..., 1 + N // hop, num_mel_bins] (centred STFT)."""

    n_fft = config.n_fft
    frames = _centred_frames(waveform, n_fft, config.hop_length)
    window = np.zeros(n_fft, dtype=np.float64)
    off = (n_fft - config.win_length) // 2
    window[off: off + config.win_length] = hanning_window(config.win_length, periodic=True)
    spectrum = torch.fft.rfft(frames * torch.as_tensor(window, dtype=torch.float32, device=frames.device), dim=-1)
    magnitude = torch.sqrt(spectrum.real.square() + spectrum.imag.square() + 1e-12)
    banks = torch.as_tensor(slaney_mel_banks(config.sample_rate, n_fft, config.num_mel_bins,
                                             config.mel_fmin, config.mel_fmax), device=frames.device)
    return torch.log(torch.clamp(magnitude @ banks, min=config.log_clamp))


def _fit_last(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """Zero-pad at the end or cut axis ``dim`` to length n."""

    have = x.shape[dim]
    if have > n:
        return x.narrow(dim, 0, n)
    if have < n:
        pad = [0, 0] * (x.ndim - 1 - dim % x.ndim) + [0, n - have]
        return F.pad(x, pad)
    return x


def wav_to_vae_mel(waveform: torch.Tensor, target_frames: int,
                   config: MelConfig = MelConfig()) -> torch.Tensor:
    """The reference ``wav_to_mel``: normalise to peak 0.5, pad/cut the wave to
    target_frames * hop samples, STFT mel, pad/cut to target_frames.
    Returns [..., target_frames, num_mel_bins]."""

    x = _fit_last(normalize_wav(waveform.float()), target_frames * config.hop_length, -1)
    return _fit_last(tacotron_mel(x, config), target_frames, -2)
