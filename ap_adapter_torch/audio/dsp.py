"""Shared DSP primitives in PyTorch: windows, framing, polyphase resampling,
waveform normalisation.

Counterpart of ``ap_adapter_tpu/audio/dsp.py``. Filter and window tables are
built in float64 numpy (cached) and applied in fp32 on the input's device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def hanning_window(n: int, periodic: bool = False) -> np.ndarray:
    """Hann window. Kaldi uses the symmetric form 0.5-0.5cos(2*pi*k/(n-1));
    Tacotron/scipy ``get_window('hann', n, fftbins=True)`` uses the periodic
    form 0.5-0.5cos(2*pi*k/n)."""

    k = np.arange(n, dtype=np.float64)
    denom = n if periodic else (n - 1)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / denom)


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """Slice ``x`` [..., N] into overlapping frames [..., num_frames, frame_length],
    num_frames = 1 + (N - frame_length) // hop (snip-edges semantics)."""

    return x.unfold(-1, frame_length, hop)


@functools.lru_cache(maxsize=32)
def _sinc_resample_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                          rolloff: float = 0.99) -> tuple:
    """Polyphase windowed-sinc kernel (torchaudio's ``sinc_interp_hann``
    resampler): (kernel [new_freq, width*2 + orig_freq], width)."""

    g = math.gcd(orig_freq, new_freq)
    orig_freq //= g
    new_freq //= g
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :] / orig_freq
    t = (-np.arange(new_freq, dtype=np.float64)[:, None] / new_freq + idx) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t *= np.pi
    scale = base_freq / orig_freq
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel *= window * scale
    return kernel.astype(np.float32), width


def resample(x: torch.Tensor, orig_freq: int, new_freq: int) -> torch.Tensor:
    """Resample the last axis of ``x`` from orig_freq to new_freq."""

    if orig_freq == new_freq:
        return x
    g = math.gcd(int(orig_freq), int(new_freq))
    orig, new = int(orig_freq) // g, int(new_freq) // g
    kernel, width = _sinc_resample_kernel(int(orig_freq), int(new_freq))
    *lead, n = x.shape
    target_len = int(math.ceil(new * n / orig))
    flat = F.pad(x.reshape(-1, 1, n).float(), (width, width + orig))
    w = torch.as_tensor(kernel, device=x.device)[:, None, :]          # [new, 1, W]
    out = F.conv1d(flat, w, stride=orig)                               # [B, new, frames]
    out = out.transpose(1, 2).reshape(flat.shape[0], -1)[:, :target_len]
    return out.reshape(*lead, target_len)


def normalize_wav(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Mean-centre and scale so that the waveform's peak is 0.5 (the audioldm
    ``normalize_wav`` composed with the reference re-normalisation)."""

    x = x - x.mean(dim=-1, keepdim=True)
    peak = x.abs().amax(dim=-1, keepdim=True)
    return 0.5 * x / peak.clamp_min(eps)
