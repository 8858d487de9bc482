"""The reference one precision below the configurations' bf16: every
matrix product, convolution and attention product takes its operands
rounded to fp8 (e4m3, one scale a tensor), and the denoise loop keeps its
latents in fp8 (``pipelines.ddim_update``): the control of the output
check."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

FP8_MAX = 448.0


def fp8(t):
    """``t`` rounded to float8 e4m3 under one scale (its largest magnitude
    at the format's largest), back in its own dtype."""

    if not isinstance(t, torch.Tensor) or not t.is_floating_point():
        return t
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class Fp8Products(TorchFunctionMode):
    """Within this mode, the operands of ``F.linear``, the convolutions,
    ``torch.einsum`` and ``@`` are rounded by ``fp8`` first."""

    OPS = {F.linear, F.conv1d, F.conv2d, F.conv_transpose1d, torch.einsum, torch.matmul,
           torch.Tensor.__matmul__}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.OPS:
            if func is torch.einsum and len(args) == 2 and isinstance(args[1], (list, tuple)):
                args = (args[0], [fp8(a) for a in args[1]])
            else:
                args = tuple(fp8(a) for a in args)
                kwargs = {k: fp8(v) if k in ("weight", "bias") else v for k, v in kwargs.items()}
        return func(*args, **kwargs)
