"""Audio side of the reference: AudioMAE's Kaldi fbank front end, the
AudioMAE ViT-B/16 encoder with its (avg + max) / 2 token pooling, the KL
VAE and the SpeechT5 HiFi-GAN vocoder."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from h100_bench.reference.common import attention, sincos_2d


def _mel(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


def kaldi_fbank(wav: torch.Tensor, c) -> torch.Tensor:
    """``torchaudio.compliance.kaldi.fbank`` as AudioMAE calls it (htk_compat,
    Hann window, no dither, no energy, 10 ms shift, snip edges), then the
    pad/cut to ``target_frames`` and the AudioSet normalisation. wav [N] at
    ``c.sample_rate`` -> [target_frames, num_mel_bins]."""

    n = int(c.sample_rate * c.frame_length_ms / 1000.0)
    hop = int(c.sample_rate * c.frame_shift_ms / 1000.0)
    nfft = 1 << (n - 1).bit_length()
    x = wav.double() - wav.double().mean()
    frames = x.unfold(0, n, hop)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    frames = frames - c.preemphasis * torch.cat([frames[:, :1], frames[:, :-1]], dim=1)
    window = 0.5 - 0.5 * torch.cos(2 * np.pi * torch.arange(n, dtype=torch.float64, device=wav.device) / (n - 1))
    power = torch.fft.rfft(F.pad(frames * window, (0, nfft - n)), dim=-1).abs().square()
    high = c.high_freq if c.high_freq > 0 else 0.5 * c.sample_rate + c.high_freq
    lo, hi = _mel(c.low_freq), _mel(high)
    delta = (hi - lo) / (c.num_mel_bins + 1)
    b = np.arange(c.num_mel_bins, dtype=np.float64)[:, None]
    mel = _mel(c.sample_rate / nfft * np.arange(nfft // 2, dtype=np.float64))[None, :]
    left, center, right = lo + b * delta, lo + (b + 1) * delta, lo + (b + 2) * delta
    banks = np.maximum(0.0, np.minimum((mel - left) / (center - left), (right - mel) / (right - center)))
    banks = torch.as_tensor(np.pad(banks, ((0, 0), (0, 1))).T, device=wav.device)
    fb = torch.log(torch.clamp(power @ banks, min=float(np.finfo(np.float32).eps)))
    fb = F.pad(fb, (0, 0, 0, max(0, c.target_frames - fb.shape[0])))[: c.target_frames]
    return ((fb - c.norm_mean) / (c.norm_std * 2.0)).float()


class ViTBlock(nn.Module):
    def __init__(self, dim, heads, mlp_ratio, eps):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = nn.ModuleDict({"qkv": nn.Linear(dim, 3 * dim), "proj": nn.Linear(dim, dim)})
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = nn.ModuleDict({"fc1": nn.Linear(dim, int(dim * mlp_ratio)), "fc2": nn.Linear(int(dim * mlp_ratio), dim)})

    def forward(self, x):
        b, n, d = x.shape
        qkv = self.attn["qkv"](self.norm1(x)).reshape(b, n, 3, self.heads, d // self.heads)
        x = x + self.attn["proj"](attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]).reshape(b, n, d))
        return x + self.mlp["fc2"](F.gelu(self.mlp["fc1"](self.norm2(x))))


class AudioMAE(nn.Module):
    """Held as ``model``: fbank [B, T, F] -> pooled tokens [B, T/16/tp * F/16/fp, D]."""

    def __init__(self, c):
        super().__init__()
        self.c = c
        self.model = nn.Module()
        self.model.patch_embed = nn.Module()
        self.model.patch_embed.proj = nn.Conv2d(c.in_chans, c.embed_dim, c.patch_size, stride=c.patch_size)
        self.model.cls_token = nn.Parameter(torch.zeros(1, 1, c.embed_dim))
        self.model.blocks = nn.ModuleList([ViTBlock(c.embed_dim, c.num_heads, c.mlp_ratio, c.layer_norm_eps)
                                           for _ in range(c.depth)])
        self.model.norm = nn.LayerNorm(c.embed_dim, eps=c.layer_norm_eps)

    def forward(self, fbank, time_pool: int, freq_pool: int):
        c, m = self.c, self.model
        gt, gf = c.img_size[0] // c.patch_size, c.img_size[1] // c.patch_size
        x = m.patch_embed.proj(fbank[:, None]).flatten(2).transpose(1, 2)       # [B, gt*gf, D], time-major
        pos = torch.as_tensor(sincos_2d(c.embed_dim, gf, gt), device=x.device)
        cls = (m.cls_token + pos[None, :1]).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x + pos[None, 1:]], dim=1)
        for blk in m.blocks:
            x = blk(x)
        t = m.norm(x)[:, 1:]
        b, _, d = t.shape
        t = t.reshape(b, gt // time_pool, time_pool, gf // freq_pool, freq_pool, d)
        return ((t.mean(dim=(2, 4)) + t.amax(dim=(2, 4))) * 0.5).reshape(b, -1, d)


class Resnet(nn.Module):
    """GN -> SiLU -> conv (+ temb) -> GN -> SiLU -> conv, plus the (1x1) shortcut."""

    def __init__(self, cin, cout, groups, eps, temb=None):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb, cout) if temb else None
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class Upsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x, size=None):
        return self.conv(F.interpolate(x, size=size or (2 * x.shape[2], 2 * x.shape[3]), mode="nearest"))


class VAEAttention(nn.Module):
    def __init__(self, ch, groups):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.to_q, self.to_k, self.to_v = (nn.Linear(ch, ch) for _ in range(3))
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, 1, c)
        out = attention(self.to_q(y), self.to_k(y), self.to_v(y)).reshape(b, h * w, c)
        return self.to_out[0](out).reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class VAEDecoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        ch, g = list(reversed(c.block_out_channels)), c.norm_num_groups
        self.conv_in = nn.Conv2d(c.latent_channels, ch[0], 3, padding=1)
        self.mid_block = nn.ModuleDict({"resnets": nn.ModuleList([Resnet(ch[0], ch[0], g, 1e-6) for _ in range(2)]),
                                        "attentions": nn.ModuleList([VAEAttention(ch[0], g)])})
        self.up_blocks = nn.ModuleList()
        x_ch = ch[0]
        for bi, out in enumerate(ch):
            blk = {"resnets": nn.ModuleList()}
            for _ in range(c.layers_per_block + 1):
                blk["resnets"].append(Resnet(x_ch, out, g, 1e-6))
                x_ch = out
            if bi < len(ch) - 1:
                blk["upsamplers"] = nn.ModuleList([Upsample(out)])
            self.up_blocks.append(nn.ModuleDict(blk))
        self.conv_norm_out = nn.GroupNorm(g, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], c.out_channels, 3, padding=1)

    def forward(self, z):
        m = self.mid_block
        x = m["resnets"][1](m["attentions"][0](m["resnets"][0](self.conv_in(z))))
        for blk in self.up_blocks:
            for r in blk["resnets"]:
                x = r(x)
            if "upsamplers" in blk:
                x = blk["upsamplers"][0](x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAEEncoder(nn.Module):
    """Present for the checkpoint's key set; generation does not run it."""

    def __init__(self, c):
        super().__init__()
        ch, g = c.block_out_channels, c.norm_num_groups
        self.conv_in = nn.Conv2d(c.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        x_ch = ch[0]
        for bi, out in enumerate(ch):
            blk = {"resnets": nn.ModuleList()}
            for _ in range(c.layers_per_block):
                blk["resnets"].append(Resnet(x_ch, out, g, 1e-6))
                x_ch = out
            if bi < len(ch) - 1:
                blk["downsamplers"] = nn.ModuleList([nn.Module()])
                blk["downsamplers"][0].conv = nn.Conv2d(out, out, 3, stride=2)
            self.down_blocks.append(nn.ModuleDict(blk))
        self.mid_block = nn.ModuleDict({"resnets": nn.ModuleList([Resnet(ch[-1], ch[-1], g, 1e-6) for _ in range(2)]),
                                        "attentions": nn.ModuleList([VAEAttention(ch[-1], g)])})
        self.conv_norm_out = nn.GroupNorm(g, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * c.latent_channels, 3, padding=1)


class VAE(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.c = c
        self.encoder = VAEEncoder(c)
        self.decoder = VAEDecoder(c)
        self.quant_conv = nn.Conv2d(2 * c.latent_channels, 2 * c.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(c.latent_channels, c.latent_channels, 1)

    def decode(self, latents):
        """latents [B, T, F, C] (NHWC, unscaled) -> mel [B, 4T, 4F]."""

        z = (latents / self.c.scaling_factor).permute(0, 3, 1, 2)
        return self.decoder(self.post_quant_conv(z))[:, 0]


class HiFiResBlock(nn.Module):
    def __init__(self, ch, k, dilations, slope):
        super().__init__()
        self.slope = slope
        self.convs1 = nn.ModuleList([nn.Conv1d(ch, ch, k, dilation=d, padding=(k - 1) // 2 * d) for d in dilations])
        self.convs2 = nn.ModuleList([nn.Conv1d(ch, ch, k, padding=(k - 1) // 2) for _ in dilations])

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(F.leaky_relu(c1(F.leaky_relu(x, self.slope)), self.slope))
        return x


class HiFiGAN(nn.Module):
    """transformers' SpeechT5HifiGan: mel [B, T, 64] -> waveform [B, T * 160]."""

    def __init__(self, c):
        super().__init__()
        self.c = c
        self.conv_pre = nn.Conv1d(c.model_in_dim, c.upsample_initial_channel, 7, padding=3)
        self.upsampler, self.resblocks = nn.ModuleList(), nn.ModuleList()
        for i, (rate, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            ch = c.upsample_initial_channel // 2 ** (i + 1)
            self.upsampler.append(nn.ConvTranspose1d(2 * ch, ch, k, stride=rate, padding=(k - rate) // 2))
            for rk, rd in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes):
                self.resblocks.append(HiFiResBlock(ch, rk, rd, c.leaky_relu_slope))
        self.conv_post = nn.Conv1d(c.upsample_initial_channel // 2 ** len(c.upsample_rates), 1, 7, padding=3)

    def forward(self, mel):
        c = self.c
        nk = len(c.resblock_kernel_sizes)
        x = self.conv_pre(mel.transpose(1, 2))
        for i, up in enumerate(self.upsampler):
            x = up(F.leaky_relu(x, c.leaky_relu_slope))
            x = sum(self.resblocks[i * nk + j](x) for j in range(nk)) / nk
        # transformers applies the default slope (0.01) before conv_post
        return torch.tanh(self.conv_post(F.leaky_relu(x)))[:, 0]
