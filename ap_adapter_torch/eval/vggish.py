"""VGGish audio embedder, the embedding space of the paper's FAD numbers.

Counterpart of ``ap_adapter_tpu/eval/vggish.py``: the torchvggish VGG stack
(its key names, ``features.N`` and ``embeddings.N``) and Google's
``mel_features.py`` front end, 16 kHz mono, a 25 ms / 10 ms periodic-Hann
MAGNITUDE spectrogram (fft 512), a 64-band 125-7500 Hz mel matrix with
triangles in the mel domain, log(mel + 0.01), framed into non-overlapping
0.96 s examples of [96, 64]. With the public torchvggish checkpoint
(``VggishEmbedder.from_torch_checkpoint``, a local ``.pt`` only), FAD lands
in the paper's space.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ap_adapter_torch.audio.dsp import frame_signal, hanning_window, resample

# Google mel_features.py constants
_MEL_BREAK_HZ = 700.0
_MEL_HIGH_Q = 1127.0
SAMPLE_RATE = 16_000
WINDOW = 400        # 25 ms
HOP = 160           # 10 ms
FFT = 512
NUM_MELS = 64
FMIN, FMAX = 125.0, 7500.0
EXAMPLE_FRAMES = 96   # 0.96 s
LOG_OFFSET = 0.01


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    return _MEL_HIGH_Q * np.log(1.0 + np.asarray(f, np.float64) / _MEL_BREAK_HZ)


@functools.lru_cache(maxsize=2)
def vggish_mel_matrix() -> np.ndarray:
    """[1 + FFT//2, NUM_MELS], ``spectrogram_to_mel_matrix``: bin 0 (DC) gets
    an all-zero row, and the slopes are taken against the bins' MEL
    positions (not librosa's Hz-domain triangles)."""

    spec_mel = _hz_to_mel(np.linspace(0.0, SAMPLE_RATE / 2.0, 1 + FFT // 2)[1:])
    edges = np.linspace(_hz_to_mel(np.array(FMIN)), _hz_to_mel(np.array(FMAX)), NUM_MELS + 2)
    lower = (spec_mel[:, None] - edges[None, :-2]) / (edges[1:-1] - edges[:-2])
    upper = (edges[None, 2:] - spec_mel[:, None]) / (edges[2:] - edges[1:-1])
    weights = np.maximum(0.0, np.minimum(lower, upper))
    return np.vstack([np.zeros((1, NUM_MELS)), weights]).astype(np.float32)


def vggish_log_mel_examples(waveform: torch.Tensor) -> torch.Tensor:
    """waveform [..., N] at 16 kHz -> examples [..., num_examples, 96, 64]:
    no centring or padding, the trailing partial example dropped."""

    x = waveform.float()
    window = torch.as_tensor(hanning_window(WINDOW, periodic=True), dtype=torch.float32, device=x.device)
    mag = torch.fft.rfft(frame_signal(x, WINDOW, HOP) * window, n=FFT, dim=-1).abs()
    log_mel = torch.log(mag @ torch.as_tensor(vggish_mel_matrix(), device=x.device) + LOG_OFFSET)
    n_ex = log_mel.shape[-2] // EXAMPLE_FRAMES
    log_mel = log_mel[..., : n_ex * EXAMPLE_FRAMES, :]
    return log_mel.reshape(*log_mel.shape[:-2], n_ex, EXAMPLE_FRAMES, NUM_MELS)


class VGGish(nn.Module):
    """torchvggish's VGG stack -> 128-d embeddings; examples [B, 1, 96, 64].

    The flatten before the MLP is torchvggish's ``permute(0, 2, 3, 1)`` +
    view. ``use_activation`` mirrors frechet-audio-distance's flag: its
    default (False) strips the final ReLU, so the paper's FAD runs on the
    raw ``embeddings.4`` outputs; True gives torchvggish's post-ReLU output."""

    def __init__(self, use_activation: bool = False):
        super().__init__()
        self.use_activation = use_activation
        layers, c_in = [], 1
        for item in (64, "M", 128, "M", 256, 256, "M", 512, 512, "M"):
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(c_in, item, 3, padding=1), nn.ReLU()]
                c_in = item
        self.features = nn.Sequential(*layers)
        self.embeddings = nn.Sequential(nn.Linear(512 * 4 * 6, 4096), nn.ReLU(), nn.Linear(4096, 4096), nn.ReLU(),
                                        nn.Linear(4096, 128), nn.ReLU())

    def forward(self, x: torch.Tensor, use_activation: Optional[bool] = None) -> torch.Tensor:
        """``use_activation``: this call's head (default: the module's flag)."""

        x = self.features(x.to(self.embeddings[0].weight.dtype))
        x = self.embeddings[:5](x.permute(0, 2, 3, 1).flatten(1))
        act = self.use_activation if use_activation is None else use_activation
        return F.relu(x) if act else x


class VggishEmbedder:
    """The ``.embed(wavs, sr)`` surface of ``eval/runner._embed_wavs``:
    example-level (0.96 s) VGGish embeddings concatenated across the clip
    set, as frechet-audio-distance's ``get_embeddings`` gives them."""

    def __init__(self, model: VGGish, device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()

    @classmethod
    def from_torch_checkpoint(cls, path: str, device="cuda") -> "VggishEmbedder":
        """Load a local torchvggish ``.pt`` state dict (never fetched)."""

        sd = torch.load(path, map_location="cpu", weights_only=True)
        model = VGGish()
        model.load_state_dict(sd.get("state_dict", sd))
        return cls(model, device)

    def embed(self, waveforms, sample_rate: int) -> np.ndarray:
        return vggish_clip_embeddings(self.model, waveforms, sample_rate)


@torch.no_grad()
def vggish_clip_embeddings(model: VGGish, waveforms, sample_rate: int,
                           use_activation: Optional[bool] = None) -> np.ndarray:
    """List of 1-D wavs (or one [B, N] array) -> [total_examples, 128]:
    every clip's 0.96 s examples embedded and concatenated across the set
    (FAD statistics run over examples, not per-clip pools), the final ReLU
    stripped unless ``use_activation`` (default: the model's flag); on the
    model's device."""

    device = model.embeddings[0].weight.device
    if isinstance(waveforms, np.ndarray) and waveforms.ndim == 2:
        waveforms = list(waveforms)
    out = []
    for wav in waveforms:
        w = torch.as_tensor(np.atleast_2d(wav).mean(axis=0), dtype=torch.float32, device=device)
        if sample_rate != SAMPLE_RATE:
            w = resample(w, sample_rate, SAMPLE_RATE)
        out.append(model(vggish_log_mel_examples(w)[:, None], use_activation).float().cpu().numpy())
    return np.concatenate(out, axis=0)
