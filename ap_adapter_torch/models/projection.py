"""AudioLDM2 projection model: CLAP/T5 -> GPT-2 space with SOS/EOS tokens.

Counterpart of ``ap_adapter_tpu/models/projection.py`` (diffusers
``AudioLDM2ProjectionModel`` key names).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from ap_adapter_torch.configs import ProjectionConfig


def _add_special_tokens(hidden, mask, sos, eos):
    b = hidden.shape[0]
    sos = sos.to(hidden.dtype)[None, None].expand(b, 1, -1)
    eos = eos.to(hidden.dtype)[None, None].expand(b, 1, -1)
    hidden = torch.cat([sos, hidden, eos], dim=1)
    if mask is not None:
        ones = torch.ones(b, 1, dtype=mask.dtype, device=mask.device)
        mask = torch.cat([ones, mask, ones], dim=-1)
    return hidden, mask


class ProjectionModel(nn.Module):
    def __init__(self, config: ProjectionConfig = ProjectionConfig()):
        super().__init__()
        c = self.config = config
        d = c.language_model_dim
        self.projection = nn.Linear(c.text_encoder_dim, d)
        self.projection_1 = nn.Linear(c.text_encoder_1_dim, d)
        self.sos_embed = nn.Parameter(torch.ones(d))
        self.eos_embed = nn.Parameter(torch.ones(d))
        self.sos_embed_1 = nn.Parameter(torch.ones(d))
        self.eos_embed_1 = nn.Parameter(torch.ones(d))

    def forward(self, clap_features, t5_features, clap_mask=None, t5_mask=None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        h0, m0 = _add_special_tokens(self.projection(clap_features), clap_mask,
                                     self.sos_embed, self.eos_embed)
        h1, m1 = _add_special_tokens(self.projection_1(t5_features), t5_mask,
                                     self.sos_embed_1, self.eos_embed_1)
        mask = torch.cat([m0, m1], dim=-1) if m0 is not None and m1 is not None else None
        return torch.cat([h0, h1], dim=1), mask
