"""K13: the whole ResnetBlock2D,
``GN+SiLU → conv3x3 → +temb → GN+SiLU → conv3x3 → +shortcut``.

Replaces ``ap_adapter_tpu/ops/pallas_resnet.py::fused_resnet_block`` (one
VMEM-resident kernel per batch row on the TPU) and keeps its interface: x
``[B, H, W, C_in]``, conv weights HWIO ``[3, 3, C_in, C_out]``, the 1x1
shortcut ``[1, 1, C_in, C_out]``. ``UNetConfig.use_pallas_resnet`` routes
every UNet resnet here (``models/unet_blocks.py::ResnetBlock2D``), as the JAX
routes them at unet_blocks.py:111-136; the JAX's VMEM-fit test has no
counterpart, since the Hopper kernel takes every UNet resnet shape. The
UNet's NCHW activations are channels-last in memory, so their NHWC view is
what the kernel reads, with no copy; the HWIO weights are prepared once from
the torch weights (``models/unet.py::prepare_resnet_kernel_weights_``).

Kernel (``csrc/resnet.cu``, ``apk_fused_resnet_block``), redesigned for
Hopper: the GroupNorm statistics need a whole sample before either conv can
start, so one wrapper runs four launches: K12's clustered kernel on x with
SiLU (``a1 = silu(gn1(x))`` once, into scratch), conv1 over ``a1`` with bias
+ temb in its epilogue (h stored in bf16, as the TPU kernel stages it),
K12's kernel on h, and conv2 over ``a2 = silu(gn2(h))`` with bias +
shortcut in its epilogue (the 1x1 shortcut is C_in more k-blocks over the
raw x). Each conv is an implicit GEMM on ``wgmma``, fed by TMA: the
activated input through a 4-D tensor map whose boxes are whole rows of one
sample, 64 positions, moved by the tap's (dh, dw), so that TMA's zero fill
outside the tensor is the SAME padding; the HWIO weight as it lies, read
as a transposed B operand; split-K clusters where the output tiles are
fewer than the SMs (``conv_plan``). What bounds it on an H100: operations,
``2·B·H·W·C_out·(9·C_in + 9·C_out [+ C_in])``, and at level 3 the weights'
bytes.

The plain version is the JAX ``_xla_reference`` (pallas_resnet.py:272-301)
in PyTorch: GN+SiLU in fp32 rounded to x's dtype, convs in x's dtype.
``fused_resnet_block_vjp`` is an autograd Function whose backward is
autograd over the plain version (pallas_resnet.py:304-345).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ap_adapter_torch.ops import cuda_kernels as ck
from ap_adapter_torch.ops.groupnorm import GN_MAX_C, gn_cluster_plan, group_norm_silu_plain
from ap_adapter_torch.ops.hopper_gemm import BM, H100_SMS, GemmPlan, tile_plan

CONV_BK = 64            # channels a conv k-block: one 128-byte swizzle row of bf16
CONV_MAX_W = 64         # a conv tile is whole rows of one sample, R = 64 // W of them


def fused_resnet_block_plain(x, temb, gn1_scale, gn1_bias, conv1_w, conv1_b, gn2_scale, gn2_bias, conv2_w,
                             conv2_b, sc_w=None, sc_b=None, groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version: x [B, H, W, C_in] -> [B, H, W, C_out]; temb
    None, [C_out] (one row for the batch) or [B, C_out]; conv weights HWIO."""

    def conv(h, w, b, pad):
        return F.conv2d(h, w.to(h.dtype).permute(3, 2, 0, 1), b.to(h.dtype), padding=pad)

    xc = x.permute(0, 3, 1, 2)
    h = conv(group_norm_silu_plain(xc, gn1_scale, gn1_bias, groups, eps, act=True), conv1_w, conv1_b, 1)
    if temb is not None:
        h = h + temb.to(h.dtype).reshape(-1, h.shape[1], 1, 1)
    out = conv(group_norm_silu_plain(h, gn2_scale, gn2_bias, groups, eps, act=True), conv2_w, conv2_b, 1)
    sc = conv(xc, sc_w, sc_b, 0) if sc_w is not None else xc
    return (sc + out).permute(0, 2, 3, 1)


def conv_rows(w: int) -> int:
    """Rows R of a conv tile: as many whole rows of W positions as fit in 64."""

    return BM // w


def conv_plan(b: int, h: int, w: int, cx: int, cout: int, c_sc: int = 0, sms: int = H100_SMS) -> GemmPlan:
    """The launch of one of K13's convs over a [b, h, w, cx] input into cout
    channels (c_sc: the 1x1 shortcut's input channels, 0 without one):
    ``b * ceil(h / R)`` position tiles by cout columns over ``9 * cx / 64 +
    c_sc / 64`` k-blocks, by ``tile_plan``. Raises on what the kernel does
    not take: channels off multiples of 64, W past 64."""

    if cx % CONV_BK or cout % CONV_BK or c_sc % CONV_BK or not 1 <= w <= CONV_MAX_W or b < 1 or h < 1:
        raise ValueError(f"fused_resnet_block: the conv kernel needs channels that are multiples of {CONV_BK} "
                         f"and W <= {CONV_MAX_W} (C_x={cx}, C_out={cout}, C_shortcut={c_sc}, W={w})")
    return tile_plan(b * -(-h // conv_rows(w)), cout, 9 * cx // CONV_BK + c_sc // CONV_BK, sms=sms)


def conv_tile_positions(y: int, b: int, h: int, w: int):
    """The (sample, row, column) that tile row r of position tile y stores,
    r = 0..63, by the kernel's formulas (None where the row stores nothing:
    past R * W, or past H)."""

    rows = conv_rows(w)
    tps = -(-h // rows)
    bi, h0 = y // tps, (y % tps) * rows
    return [(bi, h0 + r // w, r % w) if r < rows * w and h0 + r // w < h else None for r in range(BM)]


def _check_shapes(op, x, temb, gn1_scale, gn1_bias, conv1_w, conv1_b, gn2_scale, gn2_bias, conv2_w, conv2_b,
                  sc_w, sc_b, groups) -> None:
    if x.ndim != 4:
        raise ValueError(f"{op}: x must be [B, H, W, C_in], got {tuple(x.shape)}")
    b, cin = x.shape[0], x.shape[3]
    cout = conv1_w.shape[-1]
    got = dict(gn1_scale=gn1_scale, gn1_bias=gn1_bias, conv1_w=conv1_w, conv1_b=conv1_b, gn2_scale=gn2_scale,
               gn2_bias=gn2_bias, conv2_w=conv2_w, conv2_b=conv2_b)
    want = dict(gn1_scale=(cin,), gn1_bias=(cin,), conv1_w=(3, 3, cin, cout), conv1_b=(cout,),
                gn2_scale=(cout,), gn2_bias=(cout,), conv2_w=(3, 3, cout, cout), conv2_b=(cout,))
    if sc_w is not None:
        got.update(sc_w=sc_w, sc_b=sc_b)
        want.update(sc_w=(1, 1, cin, cout), sc_b=(cout,))
    elif cin != cout:
        raise ValueError(f"{op}: C_in {cin} != C_out {cout} needs the 1x1 shortcut")
    bad = {k: tuple(got[k].shape) for k in want if tuple(got[k].shape) != want[k]}
    if bad or cin % groups or cout % groups:
        raise ValueError(f"{op}: x {tuple(x.shape)}, groups {groups}: bad shapes {bad}")
    if temb is not None and tuple(temb.shape) not in ((cout,), (b, cout)):
        raise ValueError(f"{op}: temb must be [{cout}] or [{b}, {cout}], got {tuple(temb.shape)}")


def fused_resnet_block(x, temb, gn1_scale, gn1_bias, conv1_w, conv1_b, gn2_scale, gn2_bias, conv2_w, conv2_b,
                       sc_w=None, sc_b=None, groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """K13 on a CUDA tensor (every operand bf16; C_in and C_out multiples of
    64, at most 2048; W at most 64), the plain version on a CPU tensor.
    Records no autograd graph: differentiable callers use
    ``fused_resnet_block_vjp``."""

    op = "fused_resnet_block"
    args = (x, temb, gn1_scale, gn1_bias, conv1_w, conv1_b, gn2_scale, gn2_bias, conv2_w, conv2_b, sc_w, sc_b)
    _check_shapes(op, *args, groups)
    operands = dict(x=x, temb=temb, gn1_scale=gn1_scale, gn1_bias=gn1_bias, conv1_w=conv1_w, conv1_b=conv1_b,
                    gn2_scale=gn2_scale, gn2_bias=gn2_bias, conv2_w=conv2_w, conv2_b=conv2_b, sc_w=sc_w, sc_b=sc_b)
    ck.check_contiguous(op, **operands)
    ck.check_no_grad(op, **operands)
    if x.device.type == "cpu":
        return fused_resnet_block_plain(*args, groups, eps)
    b, h, w, cin = x.shape
    cout = conv1_w.shape[-1]
    if max(cin, cout) > GN_MAX_C:
        raise ValueError(f"{op}: kernel needs C_in and C_out at most {GN_MAX_C} (C_in={cin}, C_out={cout})")
    sms = ck.sm_count(x.device)
    p1 = conv_plan(b, h, w, cin, cout, sms=sms)
    p2 = conv_plan(b, h, w, cout, cout, cin if sc_w is not None else 0, sms=sms)
    ck.check_operands(op, x, **operands)
    g1, g2 = gn_cluster_plan(h * w, cin, groups), gn_cluster_plan(h * w, cout, groups)
    a1 = x.new_empty(b, h, w, cin)
    hbuf, a2, out = (x.new_empty(b, h, w, cout) for _ in range(3))
    temb_stride = 0 if temb is None or temb.ndim == 1 else cout
    ck.launch(op, x.data_ptr(), ck.ptr(temb), temb_stride, gn1_scale.data_ptr(), gn1_bias.data_ptr(),
              conv1_w.data_ptr(), conv1_b.data_ptr(), gn2_scale.data_ptr(), gn2_bias.data_ptr(), conv2_w.data_ptr(),
              conv2_b.data_ptr(), ck.ptr(sc_w), ck.ptr(sc_b), g1.n, g1.pchunk, g1.threads, int(g1.hold),
              a1.data_ptr(), hbuf.data_ptr(), g2.n, g2.pchunk, g2.threads, int(g2.hold), a2.data_ptr(),
              out.data_ptr(), b, cin, cout, h, w, groups, eps, *p1.launch_args, *p2.launch_args)
    return out


class _FusedResnetBlock(torch.autograd.Function):
    """Forward K13, backward autograd over the plain version, recomputed."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args[:12])
        ctx.args = args[12:]
        return fused_resnet_block(*args)

    @staticmethod
    def backward(ctx, g):
        grads = ck.plain_vjp(lambda *a: fused_resnet_block_plain(*a, *ctx.args), ctx.saved_tensors,
                             ctx.needs_input_grad[:12], g.contiguous())
        return (*grads, None, None)


def fused_resnet_block_vjp(x, temb: Optional[torch.Tensor], gn1_scale, gn1_bias, conv1_w, conv1_b, gn2_scale,
                           gn2_bias, conv2_w, conv2_b, sc_w=None, sc_b=None, groups: int = 32,
                           eps: float = 1e-5) -> torch.Tensor:
    """K13 as a differentiable op (the JAX ``fused_resnet_block_vjp``)."""

    args = (x, temb, gn1_scale, gn1_bias, conv1_w, conv1_b, gn2_scale, gn2_bias, conv2_w, conv2_b, sc_w, sc_b,
            groups, eps)
    if not torch.is_grad_enabled():   # inference: the raw op, no autograd node
        return fused_resnet_block(*args)
    return _FusedResnetBlock.apply(*args)
