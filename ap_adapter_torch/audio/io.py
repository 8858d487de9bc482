"""Wav file IO through ``scipy.io.wavfile`` (the port's own copy of the JAX
package's scipy path; the native batched decoder is not ported)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a wav file -> (float32 mono waveform [N] in [-1, 1], sample rate);
    channels are averaged."""

    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    return data, int(sr)


def save_wav(path: str, waveform: np.ndarray, sample_rate: int = 16_000) -> None:
    """Write float32 [-1, 1] (or int16) audio as 16-bit PCM."""

    from scipy.io import wavfile

    data = np.asarray(waveform)
    if data.dtype != np.int16:
        data = (np.clip(data, -1.0, 1.0) * 32767.0).astype(np.int16)
    wavfile.write(path, sample_rate, data)
