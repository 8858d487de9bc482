"""CLAP audio tower (HTSAT Swin transformer) in PyTorch.

Counterpart of ``ap_adapter_tpu/models/clap_audio.py`` (transformers
``ClapAudioModelWithProjection``), used to re-rank generated waveforms by
CLAP text-audio similarity (``eval/clap_scoring.py``) and as an FAD
embedding space (``eval/metrics.py``). State-dict keys are HF's
(``audio_model.audio_encoder.*``, ``audio_projection.linear1/2``, the
relative-position index buffers and the batch-norm counter included), so a
real checkpoint loads by key.

Pipeline: batch norm over the mel bins (running statistics), the 4-crop mel
"image" (bicubic time resize with align_corners=True as a precomputed
matrix), patch embedding, Swin stages with windowed attention, relative
position bias and cyclic shifts, patch merging, the HTSAT average-pool head,
the MLP projection and L2 normalisation. The window attention is 64 tokens
long and runs ``ops/attention.py::sdpa``; it is no TPU kernel.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ap_adapter_torch.configs import ClapAudioConfig
from ap_adapter_torch.ops.attention import sdpa


def _cubic_kernel(s: np.ndarray, a: float = -0.75) -> np.ndarray:
    s = np.abs(s)
    return np.where(s <= 1.0, (a + 2) * s ** 3 - (a + 3) * s ** 2 + 1,
                    np.where(s < 2.0, a * s ** 3 - 5 * a * s ** 2 + 8 * a * s - 4 * a, 0.0))


@functools.lru_cache(maxsize=16)
def bicubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] 1-D cubic-convolution resize, align_corners=True,
    replicate border (torch bicubic along one axis)."""

    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    scale = (n_in - 1) / (n_out - 1)
    w = np.zeros((n_out, n_in), dtype=np.float64)
    for i in range(n_out):
        x = i * scale
        x0 = int(np.floor(x))
        t = x - x0
        for off in (-1, 0, 1, 2):
            w[i, min(max(x0 + off, 0), n_in - 1)] += _cubic_kernel(np.array(t - off))
    return w.astype(np.float32)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nH*nW, ws*ws, C]."""

    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """[B*nH*nW, ws, ws, C] -> [B, H, W, C]."""

    c = windows.shape[-1]
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


@functools.lru_cache(maxsize=32)
def relative_position_index(ws: int) -> np.ndarray:
    """[ws*ws, ws*ws] index into the (2ws-1)^2-row relative-position table."""

    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=32)
def shift_attn_mask(h: int, w: int, ws: int, shift: int) -> Optional[np.ndarray]:
    """Additive mask [num_windows, ws*ws, ws*ws] for shifted windows (-100)."""

    if shift == 0:
        return None
    img = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class SwinSelfAttention(nn.Module):
    """HF ``attention.self``: q/k/v projections, the relative-position bias
    table and its index buffer."""

    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.query, self.key, self.value = (nn.Linear(dim, dim) for _ in range(3))
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             torch.as_tensor(relative_position_index(window_size)).long())


class SwinAttention(nn.ModuleDict):
    """Window attention, HF ``attention.self`` + ``attention.output.dense``."""

    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__({"self": SwinSelfAttention(dim, num_heads, window_size),
                          "output": nn.ModuleDict({"dense": nn.Linear(dim, dim)})})

    def forward(self, windows: torch.Tensor, attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """windows [NW_total, ws*ws, C]; attn_mask [num_windows, N, N] or None."""

        sa = self["self"]
        bw, n, c = windows.shape
        h = sa.num_heads
        q, k, v = (lin(windows).reshape(bw, n, h, c // h) for lin in (sa.query, sa.key, sa.value))
        idx = sa.relative_position_index.reshape(-1)
        bias = sa.relative_position_bias_table[idx].reshape(n, n, h).permute(2, 0, 1)[None]
        if attn_mask is not None:
            nw = attn_mask.shape[0]
            bias = (bias + attn_mask[:, None]).repeat(bw // nw, 1, 1, 1)
        out = sdpa(q, k, v, mask=bias.to(torch.float32))
        return self["output"]["dense"](out.reshape(bw, n, c))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, resolution: Tuple[int, int], window_size: int,
                 shift_size: int, mlp_ratio: float, eps: float):
        super().__init__()
        if min(resolution) <= window_size:      # window larger than the input: no partition, no shift
            window_size, shift_size = min(resolution), 0
        self.resolution, self.window_size, self.shift_size = resolution, window_size, shift_size
        self.layernorm_before = nn.LayerNorm(dim, eps=eps)
        self.attention = SwinAttention(dim, num_heads, window_size)
        self.layernorm_after = nn.LayerNorm(dim, eps=eps)
        self.intermediate = nn.ModuleDict({"dense": nn.Linear(dim, int(dim * mlp_ratio))})
        self.output = nn.ModuleDict({"dense": nn.Linear(int(dim * mlp_ratio), dim)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hgt, wid = self.resolution
        ws, shift = self.window_size, self.shift_size
        b, n, c = x.shape
        y = self.layernorm_before(x).reshape(b, hgt, wid, c)
        pad_b, pad_r = (ws - hgt % ws) % ws, (ws - wid % ws) % ws
        if pad_b or pad_r:
            y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = hgt + pad_b, wid + pad_r
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        mask = shift_attn_mask(hp, wp, ws, shift)
        mask = None if mask is None else torch.as_tensor(mask, device=x.device)
        attn = self.attention(window_partition(y, ws), mask)
        y = window_reverse(attn.reshape(-1, ws, ws, c), ws, hp, wp)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y[:, :hgt, :wid, :].reshape(b, n, c)
        y = F.gelu(self.intermediate["dense"](self.layernorm_after(x)))
        return x + self.output["dense"](y)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, resolution: Tuple[int, int], eps: float):
        super().__init__()
        self.resolution = resolution
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hgt, wid = self.resolution
        b, n, c = x.shape
        y = x.reshape(b, hgt, wid, c)
        if hgt % 2 or wid % 2:
            y = F.pad(y, (0, 0, 0, wid % 2, 0, hgt % 2))
        y = torch.cat([y[:, 0::2, 0::2], y[:, 1::2, 0::2], y[:, 0::2, 1::2], y[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(y.reshape(b, -1, 4 * c)))


class ClapAudioEncoder(nn.Module):
    """input_features [B, 1, T, F] (log-mel, the CLAP extractor's layout) ->
    pooled [B, hidden]."""

    def __init__(self, config: ClapAudioConfig = ClapAudioConfig()):
        super().__init__()
        c = self.config = config
        self.patch_embed = nn.ModuleDict({
            "proj": nn.Conv2d(1, c.patch_embeds_hidden_size, c.patch_size, stride=c.patch_stride,
                              padding=((c.patch_size - c.patch_stride[0]) // 2,
                                       (c.patch_size - c.patch_stride[1]) // 2)),
            "norm": nn.LayerNorm(c.patch_embeds_hidden_size, eps=c.layer_norm_eps)})
        self.batch_norm = nn.BatchNorm2d(c.num_mel_bins)
        grid = c.spec_size // c.patch_stride[0], c.spec_size // c.patch_stride[1]
        self.layers = nn.ModuleList()
        for si, depth in enumerate(c.depths):
            dim = c.patch_embeds_hidden_size * 2 ** si
            stage = nn.Module()
            stage.blocks = nn.ModuleList([
                SwinBlock(dim, c.num_heads[si], grid, c.window_size, 0 if bi % 2 == 0 else c.window_size // 2,
                          c.mlp_ratio, c.layer_norm_eps) for bi in range(depth)])
            if si < len(c.depths) - 1:
                stage.downsample = PatchMerging(dim, grid, c.layer_norm_eps)
                grid = ((grid[0] + 1) // 2, (grid[1] + 1) // 2)
            self.layers.append(stage)
        self.norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, input_features: torch.Tensor) -> torch.Tensor:
        c = self.config
        dtype = self.norm.weight.dtype
        x = input_features.to(dtype)
        b, ch, t, f = x.shape
        bn = self.batch_norm        # running statistics over the mel bins, whatever the module's mode
        x = F.batch_norm(x.transpose(1, 3), bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0,
                         bn.eps).transpose(1, 3)
        # reshape_mel2img: bicubic time (and frequency) resize + 4-crop stack
        fr = c.freq_ratio
        spec_w, spec_h = c.spec_size * fr, c.spec_size // fr
        if t != spec_w:
            x = torch.einsum("ot,bctf->bcof", torch.as_tensor(bicubic_resize_matrix(t, spec_w), device=x.device,
                                                              dtype=dtype), x)
        if f != spec_h:
            x = torch.einsum("of,bctf->bcto", torch.as_tensor(bicubic_resize_matrix(f, spec_h), device=x.device,
                                                              dtype=dtype), x)
        x = x.reshape(b, ch * fr, spec_w // fr, spec_h).transpose(2, 3).reshape(b, ch, spec_h * fr, spec_w // fr)
        x = self.patch_embed["proj"](x)                       # [B, C, gh, gw]
        x = self.patch_embed["norm"](x.flatten(2).transpose(1, 2))
        for stage in self.layers:
            for blk in stage.blocks:
                x = blk(x)
            if hasattr(stage, "downsample"):
                x = stage.downsample(x)
        x = self.norm(x)
        # the HTSAT head regroups the [freq, time] token grid by frequency
        # bins before its average pool; the pool covers every token, so the
        # regrouping does not change it
        return x.mean(dim=1)


class ClapAudioTower(nn.Module):
    """``get_audio_features``: encoder -> MLP projection -> L2 normalise."""

    def __init__(self, config: ClapAudioConfig = ClapAudioConfig()):
        super().__init__()
        self.config = config
        self.audio_model = nn.ModuleDict({"audio_encoder": ClapAudioEncoder(config)})
        self.audio_projection = nn.ModuleDict({
            "linear1": nn.Linear(config.hidden_size, config.projection_dim),
            "linear2": nn.Linear(config.projection_dim, config.projection_dim)})

    def forward(self, input_features: torch.Tensor) -> torch.Tensor:
        pooled = self.audio_model["audio_encoder"](input_features)
        proj = self.audio_projection
        y = proj["linear2"](F.relu(proj["linear1"](pooled))).float()
        return (y / y.norm(dim=-1, keepdim=True).clamp_min(1e-12)).to(pooled.dtype)
