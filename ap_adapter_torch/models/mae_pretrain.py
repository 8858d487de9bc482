"""AudioMAE's pretraining stack: masking plans, the MAE decoder, the
reconstruction loss, the pretraining step, and the finetuning classifier.

Counterpart of ``ap_adapter_tpu/models/mae_pretrain.py`` (the reference's
``audio_encoder/models_mae.py`` decoder, 1-D and 2-D random masking, masked
encoder, ``forward_decoder``/``forward_loss``, and ``models_vit.py``'s
classifier). Plain PyTorch: the ViT attention is ``ops/attention.py::sdpa``,
as in the JAX package, outside any kernel.

The masking functions draw their uniform noise from a ``torch.Generator``
and build the plan with a pure function of that noise
(``masking_plan``/``masking_plan_2d``, stable sorts as ``jnp.argsort``), so
the same noise gives the JAX package's plan exactly. Only the plain-ViT
decoder (``decoder_mode=0``, the ``mae_vit_base_patch16`` factory's) is
here, as in the JAX package. Parameter names are the reference
checkpoint's: the encoder's (``patch_embed.proj``, ``cls_token``,
``blocks.{i}``, ``norm``) and ``decoder_embed``, ``mask_token``,
``decoder_blocks.{i}``, ``decoder_norm``, ``decoder_pred``, flat in one
module as in ``MaskedAutoencoderViT``; the classifier's are ``models_vit``'s
(``fc_norm`` or ``norm``, ``head``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from ap_adapter_torch.configs import AudioMAEConfig
from ap_adapter_torch.models.audiomae import AudioMAEEncoder, ViTBlock
from ap_adapter_torch.models.layers import audiomae_pos_embed
from ap_adapter_torch.parallel.mesh import all_reduce_mean_

# -- masking plans ---------------------------------------------------------------


def masking_plan(noise: torch.Tensor, mask_ratio: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """1-D plan from uniform ``noise`` [B, L]: ``(ids_keep [B, len_keep],
    mask [B, L] with 1.0 at removed tokens, ids_restore [B, L])``; the
    ``len_keep = int(L * (1 - mask_ratio))`` tokens of least noise are kept."""

    len_keep = int(noise.shape[1] * (1 - mask_ratio))
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    mask = (ids_restore >= len_keep).float()
    return ids_shuffle[:, :len_keep], mask, ids_restore


def masking_plan_2d(noise_t: torch.Tensor, noise_f: torch.Tensor, mask_t_prob: float,
                    mask_f_prob: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """2-D (time x freq) plan from uniform noise over the time rows [B, T] and
    the freq columns [B, F]: whole rows and whole columns are removed, a
    token is kept only where both survive, and the kept tokens come first in
    ascending original index (the reference's argsort of offset ids)."""

    b, t = noise_t.shape
    f = noise_f.shape[1]
    len_keep_t, len_keep_f = int(t * (1 - mask_t_prob)), int(f * (1 - mask_f_prob))
    rank_t = torch.argsort(torch.argsort(noise_t, dim=1, stable=True), dim=1, stable=True)
    rank_f = torch.argsort(torch.argsort(noise_f, dim=1, stable=True), dim=1, stable=True)
    mask = ((rank_t >= len_keep_t)[:, :, None] | (rank_f >= len_keep_f)[:, None, :]).reshape(b, t * f)
    # kept tokens first, masked after: any offset above T*F keeps the two groups apart
    key = torch.arange(t * f, device=mask.device)[None, :] + (2 * t * f) * mask.long()
    ids_shuffle = torch.argsort(key, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    return ids_shuffle[:, : len_keep_t * len_keep_f], mask.float(), ids_restore


def random_masking(generator: torch.Generator, batch: int, num_tokens: int, mask_ratio: float,
                   device=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """1-D random masking (the reference's ``random_masking``): uniform noise
    [batch, num_tokens] from ``generator``, then :func:`masking_plan`."""

    return masking_plan(torch.rand(batch, num_tokens, generator=generator, device=device), mask_ratio)


def random_masking_2d(generator: torch.Generator, batch: int, grid: Tuple[int, int], mask_t_prob: float,
                      mask_f_prob: float, device=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """2-D random masking (the reference's ``random_masking_2d``): noise over
    the time rows, then over the freq columns, from ``generator``, then
    :func:`masking_plan_2d`."""

    t, f = grid
    noise_t = torch.rand(batch, t, generator=generator, device=device)
    noise_f = torch.rand(batch, f, generator=generator, device=device)
    return masking_plan_2d(noise_t, noise_f, mask_t_prob, mask_f_prob)


# -- patches ---------------------------------------------------------------------


def patchify(fbank: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, T, F] -> [B, (T/p)(F/p), p*p], row-major over (time, freq) as the
    encoder's tokens."""

    b, tt, ff = fbank.shape
    h, w = tt // patch, ff // patch
    return fbank.reshape(b, h, patch, w, patch).permute(0, 1, 3, 2, 4).reshape(b, h * w, patch * patch)


def unpatchify(patches: torch.Tensor, grid: Tuple[int, int], patch: int) -> torch.Tensor:
    """The inverse of :func:`patchify`."""

    h, w = grid
    b = patches.shape[0]
    return patches.reshape(b, h, w, patch, patch).permute(0, 1, 3, 2, 4).reshape(b, h * patch, w * patch)


# -- decoder and the whole autoencoder ----------------------------------------


class MAEDecoder(nn.Module):
    """The plain-ViT MAE decoder (the reference's ``forward_decoder``): embed
    the kept tokens to ``decoder_embed_dim``, put the shared mask token in
    the removed slots, unshuffle, add the fixed sin-cos table, run the
    decoder blocks, predict p*p values per token (CLS dropped)."""

    def __init__(self, config: AudioMAEConfig = AudioMAEConfig()):
        super().__init__()
        self.config = config
        self._init_decoder(config)

    def _init_decoder(self, c: AudioMAEConfig) -> None:
        dd = c.decoder_embed_dim
        self.decoder_embed = nn.Linear(c.embed_dim, dd)
        self.mask_token = nn.Parameter(torch.randn(1, 1, dd) * 0.02)
        self.decoder_blocks = nn.ModuleList([ViTBlock(dd, c.decoder_num_heads, c.mlp_ratio, c.layer_norm_eps)
                                             for _ in range(c.decoder_depth)])
        self.decoder_norm = nn.LayerNorm(dd, eps=c.layer_norm_eps)
        self.decoder_pred = nn.Linear(dd, c.patch_size ** 2)

    def decode(self, tokens: torch.Tensor, ids_restore: torch.Tensor) -> torch.Tensor:
        """tokens [B, 1 + len_keep, D] (CLS first), ids_restore [B, L] ->
        [B, L, p*p]."""

        c = self.config
        x = self.decoder_embed(tokens)
        b, n_in, dd = x.shape
        n_all = ids_restore.shape[1]
        filler = self.mask_token.to(x.dtype).expand(b, n_all + 1 - n_in, dd)
        x_ = torch.cat([x[:, 1:], filler], dim=1)
        x_ = torch.gather(x_, 1, ids_restore[..., None].expand(-1, -1, dd))
        x = torch.cat([x[:, :1], x_], dim=1)
        t, f = c.grid_size
        pos = torch.from_numpy(audiomae_pos_embed(dd, (f, t)).copy()).to(x.device)
        x = x + pos[None].to(x.dtype)
        for blk in self.decoder_blocks:
            x = blk(x)
        return self.decoder_pred(self.decoder_norm(x))[:, 1:]

    forward = decode


class MAEPretrain(AudioMAEEncoder):
    """The whole masked autoencoder (the reference's ``forward`` without its
    always-zero contrastive term): masked encode, then decode. The encoder's
    and the decoder's parameters sit in this one module, under the
    reference checkpoint's names."""

    def __init__(self, config: AudioMAEConfig = AudioMAEConfig()):
        super().__init__(config)
        MAEDecoder._init_decoder(self, config)

    decode = MAEDecoder.decode

    def forward(self, fbank: torch.Tensor, ids_keep: torch.Tensor, ids_restore: torch.Tensor) -> torch.Tensor:
        """fbank [B, T, F] and a masking plan -> per-patch predictions
        [B, (T/p)(F/p), p*p]."""

        return self.decode(self.masked(fbank, ids_keep), ids_restore)


def reconstruction_loss(fbank: torch.Tensor, pred: torch.Tensor, mask: torch.Tensor, patch: int,
                        norm_pix_loss: bool = False) -> torch.Tensor:
    """The masked MSE over the removed patches (the reference's
    ``forward_loss``), in fp32 whatever the compute dtype; with
    ``norm_pix_loss`` each target patch is normalised by its own mean and
    variance."""

    target = patchify(fbank.float(), patch)
    if norm_pix_loss:
        mean = target.mean(dim=-1, keepdim=True)
        var = target.var(dim=-1, keepdim=True, unbiased=False)
        target = (target - mean) / torch.sqrt(var + 1.0e-6)
    loss = (pred.float() - target).square().mean(dim=-1)
    mask = mask.float()
    return (loss * mask).sum() / mask.sum()


def mae_pretrain_loss(model: MAEPretrain, fbank: torch.Tensor, generator: torch.Generator, *,
                      mask_2d: bool = False, norm_pix_loss: bool = False,
                      rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One pretraining loss: a masking plan drawn from ``generator`` (1-D at
    ``mask_ratio``, or 2-D at ``mask_t_prob``/``mask_f_prob``, the
    reference's defaults), encode and decode, and the reconstruction loss.
    ``rows`` (first row, global batch): ``fbank`` holds those rows of a
    global batch, whose plan is drawn whole and sliced."""

    c = model.config
    t, f = c.grid_size
    dev = fbank.device
    b = fbank.shape[0]
    first, total = (0, b) if rows is None else rows
    if mask_2d:
        plan = random_masking_2d(generator, total, (t, f), c.mask_t_prob, c.mask_f_prob, device=dev)
    else:
        plan = random_masking(generator, total, t * f, c.mask_ratio, device=dev)
    ids_keep, mask, ids_restore = (x[first: first + b] for x in plan)
    pred = model(fbank, ids_keep, ids_restore)
    return reconstruction_loss(fbank, pred, mask, c.patch_size, norm_pix_loss)


def make_mae_pretrain_step(model: MAEPretrain, optimizer: torch.optim.Optimizer, mask_2d: bool = False,
                           norm_pix_loss: bool = False, mesh=None):
    """The pretraining step: ``step(fbank, generator) -> loss`` (a detached
    fp32 scalar) takes the gradient of :func:`mae_pretrain_loss` and one
    ``optimizer`` step over ``model``. With ``mesh`` (``parallel/mesh.py``;
    JAX mae_pretrain.py:247-290) ``fbank`` is this rank's rows of the global
    batch: the masking plan is drawn for the global batch and sliced, and
    every gradient and the loss are averaged over the ``data`` axis before
    the step. Every row masks the same number of tokens, so the mean of the
    ranks' losses is the global batch's loss."""

    def step(fbank: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        rows = None if mesh is None else mesh.rows(fbank.shape[0])
        loss = mae_pretrain_loss(model, fbank, generator, mask_2d=mask_2d, norm_pix_loss=norm_pix_loss, rows=rows)
        loss.backward()
        loss = loss.detach()
        if mesh is not None:
            all_reduce_mean_(mesh, [p.grad for p in model.parameters() if p.grad is not None] + [loss])
        optimizer.step()
        return loss

    return step


# -- finetuning classifier ---------------------------------------------------------


class ViTClassifier(AudioMAEEncoder):
    """The AudioMAE finetuning classifier (the reference's ``models_vit.py``):
    the encoder's patch embedding, CLS and blocks, then with ``global_pool``
    the mean over the patch tokens (CLS excluded), ``fc_norm`` and the linear
    ``head``; without it the final ``norm`` and the CLS token. An
    ``ids_keep`` plan (``random_masking_2d``) keeps only those tokens (the
    reference's ``forward_features_mask``)."""

    def __init__(self, config: AudioMAEConfig = AudioMAEConfig(), num_classes: int = 527,
                 global_pool: bool = True):
        super().__init__(config)
        self.global_pool = global_pool
        if global_pool:
            del self.norm
            self.fc_norm = nn.LayerNorm(config.embed_dim, eps=config.layer_norm_eps)
        self.head = nn.Linear(config.embed_dim, num_classes)

    def forward(self, fbank: torch.Tensor, ids_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        x, cls = self.patch_tokens(fbank)
        if ids_keep is not None:
            x = torch.gather(x, 1, ids_keep[..., None].expand(-1, -1, x.shape[-1]))
        x = torch.cat([cls, x], dim=1)
        for blk in self.blocks:
            x = blk(x)
        pooled = self.fc_norm(x[:, 1:].mean(dim=1)) if self.global_pool else self.norm(x)[:, 0]
        return self.head(pooled)

