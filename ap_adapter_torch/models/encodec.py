"""EnCodec's decoder side with transformers' ``EncodecModel`` key names: the
residual vector quantizer's codebooks and the SEANet decoder.

Counterpart of transformers' ``models/encodec/modeling_encodec.py``
(``EncodecModel.decode`` without chunking or scales): each codebook's
embedding of its codes, summed; a weight-normed convolution; a 2-layer LSTM
with a residual; per upsampling ratio r an ELU, a transposed convolution of
width 2r and stride r and a residual block (ELU, width-3 dilated
convolution to half the channels, ELU, width-1 convolution back); ELU and
the last convolution. Convolutions are non-causal with reflect padding.
The LSTM keeps float32 weights and runs in float32 whatever dtype the rest
takes. Only the codebooks' ``embed`` is kept of the quantizer's buffers
(a parameter here), and nothing of the encoder: a converter drops those
keys.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils.parametrizations import weight_norm

from ap_adapter_torch.configs import EncodecConfig


def _pad1d(x: torch.Tensor, paddings: Tuple[int, int], mode: str) -> torch.Tensor:
    """transformers' ``EncodecConv1d._pad1d``: reflect padding of an input
    shorter than the padding through zeros on its right first."""

    left, right = paddings
    if mode != "reflect":
        return F.pad(x, paddings, mode)
    extra = max(0, max(left, right) - x.shape[-1] + 1)
    if extra:
        x = F.pad(x, (0, extra))
    out = F.pad(x, paddings, mode)
    return out[..., : out.shape[-1] - extra]


class EncodecConv1d(nn.Module):
    """A stride-1 weight-normed convolution, padded on both sides (the right
    takes the smaller half) to keep the length."""

    def __init__(self, c: EncodecConfig, cin: int, cout: int, kernel: int, dilation: int = 1):
        super().__init__()
        self.conv = weight_norm(nn.Conv1d(cin, cout, kernel, dilation=dilation))
        self.pad_total, self.pad_mode = (kernel - 1) * dilation, c.pad_mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        right = self.pad_total // 2
        return self.conv(_pad1d(x, (self.pad_total - right, right), self.pad_mode))


class EncodecConvTranspose1d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int):
        super().__init__()
        self.conv = weight_norm(nn.ConvTranspose1d(cin, cout, kernel, stride))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        total = self.conv.kernel_size[0] - self.conv.stride[0]
        right = total // 2
        return y[..., total - right: y.shape[-1] - right]


class _Float32LSTM(nn.LSTM):
    """An ``nn.LSTM`` whose floating parameters stay float32 when the module
    tree is cast to another dtype."""

    def _apply(self, fn, *args, **kwargs):
        return super()._apply(lambda t: fn(t).float() if t.is_floating_point() else fn(t), *args, **kwargs)


class EncodecLSTM(nn.Module):
    def __init__(self, c: EncodecConfig, dim: int):
        super().__init__()
        self.lstm = _Float32LSTM(dim, dim, c.num_lstm_layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(2, 0, 1).float()                 # [T, B, C]
        return (self.lstm(h)[0] + h).permute(1, 2, 0).to(x.dtype)


class EncodecResnetBlock(nn.Module):
    def __init__(self, c: EncodecConfig, dim: int, dilation: int):
        super().__init__()
        hidden = dim // c.compress
        self.block = nn.ModuleList([nn.ELU(), EncodecConv1d(c, dim, hidden, c.residual_kernel_size, dilation),
                                    nn.ELU(), EncodecConv1d(c, hidden, dim, 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self.block:
            h = layer(h)
        return x + h


class EncodecDecoder(nn.Module):
    def __init__(self, c: EncodecConfig):
        super().__init__()
        scale = 2 ** len(c.upsampling_ratios)
        layers = [EncodecConv1d(c, c.hidden_size, scale * c.num_filters, c.kernel_size),
                  EncodecLSTM(c, scale * c.num_filters)]
        for ratio in c.upsampling_ratios:
            dim = scale * c.num_filters
            layers += [nn.ELU(), EncodecConvTranspose1d(dim, dim // 2, 2 * ratio, ratio)]
            layers += [EncodecResnetBlock(c, dim // 2, c.dilation_growth_rate ** j)
                       for j in range(c.num_residual_layers)]
            scale //= 2
        layers += [nn.ELU(), EncodecConv1d(c, c.num_filters, c.audio_channels, c.last_kernel_size)]
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class EncodecCodebook(nn.Module):
    def __init__(self, c: EncodecConfig):
        super().__init__()
        self.embed = nn.Parameter(torch.zeros(c.codebook_size, c.hidden_size), requires_grad=False)


class EncodecVectorQuantization(nn.Module):
    def __init__(self, c: EncodecConfig):
        super().__init__()
        self.codebook = EncodecCodebook(c)


class EncodecQuantizer(nn.Module):
    def __init__(self, c: EncodecConfig):
        super().__init__()
        self.layers = nn.ModuleList([EncodecVectorQuantization(c) for _ in range(c.num_quantizers)])


class EncodecModel(nn.Module):
    """codes [B, K, frames] -> waveforms [B, frames x prod(upsampling_ratios)]
    (mono)."""

    def __init__(self, config: EncodecConfig = EncodecConfig()):
        super().__init__()
        self.config = config
        self.quantizer = EncodecQuantizer(config)
        self.decoder = EncodecDecoder(config)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        emb = None
        for k, q in enumerate(self.quantizer.layers):
            e = F.embedding(codes[:, k], q.codebook.embed)
            emb = e if emb is None else emb + e
        return self.decoder(emb.transpose(1, 2))[:, 0]

    forward = decode
