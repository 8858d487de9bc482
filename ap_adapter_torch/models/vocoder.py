"""HiFi-GAN vocoder (transformers SpeechT5HifiGan key names).

Counterpart of ``ap_adapter_tpu/models/vocoder.py``: mel [B, T, 64] ->
waveform [B, T * 160]. The transposed convolutions are ``conv_transpose1d``
with torch's [in, out, W] weights (the JAX module flips its [W, in, out]
kernel inside its forward instead).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ap_adapter_torch.configs import VocoderConfig


class ResBlock(nn.Module):
    def __init__(self, channels: int, kernel_size: int, dilations, slope: float):
        super().__init__()
        self.slope = slope
        self.convs1 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, dilation=d, padding=(kernel_size - 1) // 2 * d)
            for d in dilations])
        self.convs2 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, padding=(kernel_size - 1) // 2)
            for _ in dilations])

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, T]
        for c1, c2 in zip(self.convs1, self.convs2):
            y = c2(F.leaky_relu(c1(F.leaky_relu(x, self.slope)), self.slope))
            x = x + y
        return x


class HiFiGAN(nn.Module):
    def __init__(self, config: VocoderConfig = VocoderConfig()):
        super().__init__()
        c = self.config = config
        if c.normalize_before:
            self.mean = nn.Parameter(torch.zeros(c.model_in_dim))
            self.scale = nn.Parameter(torch.ones(c.model_in_dim))
        self.conv_pre = nn.Conv1d(c.model_in_dim, c.upsample_initial_channel, 7, padding=3)
        self.upsampler = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (rate, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            ch = c.upsample_initial_channel // (2 ** (i + 1))
            self.upsampler.append(nn.ConvTranspose1d(2 * ch, ch, k, stride=rate, padding=(k - rate) // 2))
            for rk, rd in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes):
                self.resblocks.append(ResBlock(ch, rk, rd, c.leaky_relu_slope))
        self.conv_post = nn.Conv1d(c.upsample_initial_channel // 2 ** len(c.upsample_rates), 1, 7, padding=3)

    def forward(self, spectrogram: torch.Tensor) -> torch.Tensor:
        c = self.config
        x = spectrogram.to(self.conv_pre.weight.dtype)
        if c.normalize_before:
            x = (x - self.mean) / self.scale
        x = self.conv_pre(x.transpose(1, 2))
        nk = len(c.resblock_kernel_sizes)
        for i, up in enumerate(self.upsampler):
            x = up(F.leaky_relu(x, c.leaky_relu_slope))
            acc = None
            for j in range(nk):
                y = self.resblocks[i * nk + j](x)
                acc = y if acc is None else acc + y
            x = acc / nk
        x = self.conv_post(F.leaky_relu(x, c.leaky_relu_slope))
        return torch.tanh(x)[:, 0]
