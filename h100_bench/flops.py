"""The benchmark's yardstick for work: operations and bytes computed from a
configuration's shapes, never from what the program launches, and the H100
peaks they are held against.

``work``, ``bound`` and ``ops_ms`` are a frozen copy of the per-call
arithmetic of the port's fused kernels (``chip_smoke.py``), kept for the
per-kernel rooflines that a later change reads from the trace. The rest
counts whole models: every matrix product, convolution and attention
product as 2 operations a multiply-add (normalisations, activations and
other elementwise work are not counted), and the bytes of a roofline bound
as each input read once and each output written once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

PEAK_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_INT8 = 1979e12     # H100 SXM dense int8 tensor-core peak (operations/s)
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s
BF16 = 2


# -- frozen per-call arithmetic of the fused kernels ------------------------


def ops_ms(flops: float, int8_ops: float = 0.0) -> float:
    """The operations' least time: bf16 ones at the bf16 peak, int8 ones at the int8 peak."""

    return (flops / PEAK_FLOPS + int8_ops / PEAK_INT8) * 1e3


def bound(flops: float, nbytes: float, int8_ops: float = 0.0) -> dict:
    """The least time the card could take: the larger of the operations'
    least time (``ops_ms``) and the bytes (each input read once, each output
    written once) over the HBM rate."""

    t_ops, t_bytes = ops_ms(flops, int8_ops), nbytes / PEAK_BYTES * 1e3
    return {"flops": flops, "int8_ops": int8_ops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def work(name: str, b: int, s: int, c: int, sk: int = 0, sk_ip: int = 0, dc: int = 0) -> dict:
    """Operations and bytes of one call of kernel ``name`` on [b, s, c]
    activations (sk/sk_ip text and adapter keys, dc the context width), as
    the function needs them: K7-K9 count the forward recompute that their
    TPU counterparts do too."""

    m, mc = b * s, b * s * c
    attn = 2 * b * s * c            # one [S, d] x [d, Sk] product per key, all heads
    if name == "fused_ln_self_attention":          # QKV, QK^T + PV, out
        return bound(8 * mc * c + 2 * attn * s, 2 * (2 * mc + 4 * c * c + 3 * c))
    if name == "fused_ln_cross_attention_kv":      # Q, two key sets, out
        return bound(4 * mc * c + 2 * attn * (sk + sk_ip),
                     2 * (2 * mc + 2 * c * c + 2 * c + 2 * b * (sk + sk_ip) * c) + 4 * b * sk)
    if name == "fused_ln_geglu_ff":                # W1 [C, 8C], W2 [4C, C]
        return bound(24 * mc * c, 2 * (2 * mc + 12 * c * c + 11 * c))
    proj = 2 * b * (sk + sk_ip) * dc * 2 * c       # the context K/V projections
    ctx_bytes = 2 * (b * (sk + sk_ip) * dc + (4 if sk_ip else 2) * c * dc) + 4 * b * sk
    if name == "fused_ln_cross_attention":
        return bound(proj + 4 * mc * c + 2 * attn * (sk + sk_ip), ctx_bytes + 2 * (2 * mc + 2 * c * c + 3 * c))
    if name == "fused_ln_self_attention_bwd_dx":   # QKV, gattn, 5 attention products, gxn
        return bound(14 * mc * c + 5 * attn * s, 2 * (3 * mc + 4 * c * c + 2 * c))
    if name == "fused_ln_cross_attention_bwd":     # proj, Q, gattn, text 3 and adapter 5 products, gxn
        return bound(proj + 6 * mc * c + attn * (3 * sk + 5 * sk_ip),
                     ctx_bytes + 2 * (3 * mc + 2 * c * c + 2 * c) + 2 * 4 * b * sk_ip * c)
    if name == "fused_ln_geglu_ff_bwd_dx":         # gh, recomputed h, gxn
        return bound(40 * mc * c, 2 * (3 * mc + 12 * c * c + 10 * c))
    # int8: one-byte weights, fp32 scales, bf16 activations, LN and biases
    if name == "fused_ln_geglu_ff_int8":           # W1 [C, 8C], W2 [4C, C] in int8
        return bound(0, 2 * 2 * mc + 12 * c * c + 4 * 9 * c + 2 * 11 * c, int8_ops=24 * mc * c)
    if name == "fused_ln_self_attention_int8":     # int8 q, out; bf16 K/V, QK^T + PV
        return bound(4 * mc * c + 2 * attn * s, 2 * 2 * mc + 2 * c * c + 2 * 2 * c * c + 4 * 2 * c + 2 * 3 * c,
                     int8_ops=4 * mc * c)
    if name == "fused_ln_cross_attention_int8":    # context K/V bf16, int8 q and out, two key sets
        return bound(proj + 2 * attn * (sk + sk_ip),
                     ctx_bytes + 2 * 2 * mc + 2 * c * c + 4 * 2 * c + 2 * 3 * c, int8_ops=4 * mc * c)
    raise KeyError(name)


# -- whole models -----------------------------------------------------------


@dataclasses.dataclass
class Work:
    """Operations and weights (parameter count) of a piece of a model; of the
    operations, ``attn`` are attention products and ``adapter`` the
    adapter's K/V projections."""

    flops: float = 0.0
    params: float = 0.0
    attn: float = 0.0
    adapter: float = 0.0

    def __iadd__(self, other: "Work") -> "Work":
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))
        return self

    def __add__(self, other: "Work") -> "Work":
        out = Work(**dataclasses.asdict(self))
        out += other
        return out


def linear(rows: float, k: int, n: int, bias: bool = True) -> Work:
    return Work(2.0 * rows * k * n, k * n + (n if bias else 0))


def conv2d(b: int, h: int, w: int, cin: int, cout: int, k: int) -> Work:
    """A k x k convolution producing [b, cout, h, w]."""

    return Work(2.0 * b * h * w * cin * cout * k * k, cin * cout * k * k + cout)


def conv1d(b: int, length: int, cin: int, cout: int, k: int) -> Work:
    """A width-k convolution (or transposed convolution, counted on its
    input length) producing or reading ``length`` positions."""

    return Work(2.0 * b * length * cin * cout * k, cin * cout * k + cout)


def attention(b: int, sq: int, sk: int, inner: int) -> Work:
    """QK^T and PV over all heads (``inner`` = heads x head width)."""

    return Work(4.0 * b * sq * sk * inner, attn=4.0 * b * sq * sk * inner)


def _down(n: int) -> int:
    return (n - 1) // 2 + 1          # a stride-2 3x3 conv with padding 1


def unet_levels(u: dict, t: int, f: int) -> list:
    """(h, w) of each resolution level of the UNet for a [t, f] latent."""

    sizes = [(t, f)]
    for _ in range(len(u["block_out_channels"]) - 1):
        sizes.append((_down(sizes[-1][0]), _down(sizes[-1][1])))
    return sizes


def _t2d(u: dict, b: int, s: int, c: int, ctx_dim: Optional[int], sk: int, sk_ip: int) -> Tuple[Work, Work]:
    """One Transformer2DModel at [b, s, c] tokens: (work in the step, the
    context K/V projections, which do not depend on the step)."""

    step = linear(b * s, c, c) + linear(b * s, c, c)                      # proj_in, proj_out (1x1 convs)
    kv = Work()
    for _ in range(u["transformer_layers_per_block"]):
        step += linear(b * s, c, 3 * c, bias=False) + attention(b, s, s, c) + linear(b * s, c, c)   # attn1
        if ctx_dim is None:                                               # double self-attention
            step += linear(b * s, c, 3 * c, bias=False) + attention(b, s, s, c) + linear(b * s, c, c)
        else:
            step += linear(b * s, c, c, bias=False) + attention(b, s, sk + sk_ip, c) + linear(b * s, c, c)
            kv += linear(b * sk, ctx_dim, 2 * c, bias=False)
            if sk_ip:
                ip = linear(b * sk_ip, ctx_dim, 2 * c, bias=False)
                kv += Work(ip.flops, ip.params, adapter=ip.flops)
        step += linear(b * s, c, 8 * c) + linear(b * s, 4 * c, c)        # GEGLU feed-forward
    return step, kv


def unet_forward(u: dict, b: int, t: int, f: int, ctx: Sequence[Tuple[int, int]] = ()) -> Tuple[Work, Work]:
    """One UNet forward over [b, t, f, in_channels] latents.

    ``ctx`` gives, for each entry of ``cross_attention_dims`` that is not
    None, (text keys, adapter keys). Returns (the work of the step, the
    context K/V projections, which a caller may count once a request)."""

    ch = u["block_out_channels"]
    ted = 4 * ch[0]
    temb_ch = 2 * ted if u.get("class_embed_dim") and u.get("class_embeddings_concat") else ted
    levels = unet_levels(u, t, f)
    dims = u["cross_attention_dims"]
    keys = iter(ctx)
    site_keys = [None if d is None else next(keys) for d in dims]
    step, kv = Work(), Work()

    def resnet(h, w, cin, cout):
        r = conv2d(b, h, w, cin, cout, 3) + conv2d(b, h, w, cout, cout, 3) + linear(b, temb_ch, cout)
        return r + conv2d(b, h, w, cin, cout, 1) if cin != cout else r

    def group(h, w, c):
        for d, k in zip(dims, site_keys):
            s_, k_ = _t2d(u, b, h * w, c, d, *(k or (0, 0)))
            step.__iadd__(s_)
            kv.__iadd__(k_)

    step += linear(b, ch[0], ted) + linear(b, ted, ted)                  # time embedding MLP
    if u.get("class_embed_dim"):
        step += linear(b, u["class_embed_dim"], ted)
    step += conv2d(b, t, f, u["in_channels"], ch[0], 3)
    skips, x_ch = [ch[0]], ch[0]
    for bi, out in enumerate(ch):
        h, w = levels[bi]
        for _ in range(u["layers_per_block"]):
            step += resnet(h, w, x_ch, out)
            if u["down_block_has_attn"][bi]:
                group(h, w, out)
            x_ch = out
            skips.append(x_ch)
        if bi < len(ch) - 1:
            step += conv2d(b, *levels[bi + 1], out, out, 3)
            skips.append(x_ch)
    h, w = levels[-1]
    step += resnet(h, w, ch[-1], ch[-1])
    group(h, w, ch[-1])
    step += resnet(h, w, ch[-1], ch[-1])
    for bi, out in enumerate(reversed(ch)):
        h, w = levels[len(ch) - 1 - bi]
        for _ in range(u["layers_per_block"] + 1):
            step += resnet(h, w, x_ch + skips.pop(), out)
            if u["up_block_has_attn"][bi]:
                group(h, w, out)
            x_ch = out
        if bi < len(ch) - 1:
            step += conv2d(b, *levels[len(ch) - 2 - bi], out, out, 3)
    step += conv2d(b, t, f, ch[0], u["out_channels"], 3)
    return step, kv


def unet_bound_s(u: dict, b: int, t: int, f: int, ctx=()) -> float:
    """The least time of one UNet step on the card: the larger of its
    operations at the bf16 peak and its bf16 weights, read once, over the
    HBM rate (the latents and contexts are negligible beside them)."""

    step, kv = unet_forward(u, b, t, f, ctx)
    return max(step.flops / PEAK_FLOPS, BF16 * (step.params + kv.params) / PEAK_BYTES)


def clap_text(c: dict, b: int, s: int) -> Work:
    d, ff = c["hidden_size"], c["intermediate_size"]
    layer = linear(b * s, d, 4 * d) + attention(b, s, s, d) + linear(b * s, d, ff) + linear(b * s, ff, d)
    total = Work()
    for _ in range(c["num_layers"]):
        total += layer
    return total + linear(b, d, d) + linear(b, d, c["projection_dim"]) + linear(b, c["projection_dim"], c["projection_dim"])


def t5_encoder(c: dict, b: int, s: int) -> Work:
    d, inner, ff = c["d_model"], c["num_heads"] * c["d_kv"], c["d_ff"]
    layer = linear(b * s, d, 4 * inner, bias=False) + attention(b, s, s, inner) + linear(b * s, d, 3 * ff, bias=False)
    total = Work()
    for _ in range(c["num_layers"]):
        total += layer
    return total


def gpt2_generate(c: dict, b: int, prefix: int, steps: int) -> Work:
    """A prefill over ``prefix`` positions, then ``steps - 1`` single
    positions against the cached keys."""

    d = c["n_embd"]
    total = Work()
    for i in range(steps):
        n, ctx = (prefix, prefix) if i == 0 else (1, prefix + i)
        for _ in range(c["n_layer"]):
            total += linear(b * n, d, 3 * d) + attention(b, n, ctx, d) + linear(b * n, d, d) \
                + linear(b * n, d, 4 * d) + linear(b * n, 4 * d, d)
    return total


def projection(c: dict, b: int, s1: int) -> Work:
    return linear(b, c["text_encoder_dim"], c["language_model_dim"]) \
        + linear(b * s1, c["text_encoder_1_dim"], c["language_model_dim"])


def audiomae(c: dict, b: int) -> Work:
    p, d = c["patch_size"], c["embed_dim"]
    n = (c["img_size"][0] // p) * (c["img_size"][1] // p)
    hid = int(d * c["mlp_ratio"])
    total = linear(b * n, c["in_chans"] * p * p, d)
    s = n + 1
    for _ in range(c["depth"]):
        total += linear(b * s, d, 3 * d) + attention(b, s, s, d) + linear(b * s, d, d) \
            + linear(b * s, d, hid) + linear(b * s, hid, d)
    return total


def vae_decode(c: dict, b: int, t: int, f: int) -> Work:
    ch = list(reversed(c["block_out_channels"]))
    total = conv2d(b, t, f, c["latent_channels"], c["latent_channels"], 1)          # post_quant_conv
    total += conv2d(b, t, f, c["latent_channels"], ch[0], 3)

    def resnet(h, w, cin, cout):
        r = conv2d(b, h, w, cin, cout, 3) + conv2d(b, h, w, cout, cout, 3)
        return r + conv2d(b, h, w, cin, cout, 1) if cin != cout else r

    total += resnet(t, f, ch[0], ch[0]) + resnet(t, f, ch[0], ch[0])
    total += linear(b * t * f, ch[0], 4 * ch[0]) + attention(b, t * f, t * f, ch[0])
    h, w, x_ch = t, f, ch[0]
    for bi, out in enumerate(ch):
        for _ in range(c["layers_per_block"] + 1):
            total += resnet(h, w, x_ch, out)
            x_ch = out
        if bi < len(ch) - 1:
            h, w = 2 * h, 2 * w
            total += conv2d(b, h, w, out, out, 3)
    return total + conv2d(b, h, w, ch[-1], c["out_channels"], 3)


def vocoder(c: dict, b: int, frames: int) -> Work:
    ch0 = c["upsample_initial_channel"]
    total = conv1d(b, frames, c["model_in_dim"], ch0, 7)
    length = frames
    for i, (rate, k) in enumerate(zip(c["upsample_rates"], c["upsample_kernel_sizes"])):
        ch = ch0 // 2 ** (i + 1)
        total += conv1d(b, length, 2 * ch, ch, k)                 # transposed: every input position x k taps
        length *= rate
        for rk, dil in zip(c["resblock_kernel_sizes"], c["resblock_dilation_sizes"]):
            for _ in dil:
                total += conv1d(b, length, ch, ch, rk) + conv1d(b, length, ch, ch, rk)
    return total + conv1d(b, length, ch0 // 2 ** len(c["upsample_rates"]), 1, 7)


def latent_shape(config: dict, seconds: float) -> Tuple[int, int]:
    """(T, F) of the latent for a clip of ``seconds``, as the pipelines size it."""

    voc, scale = config["vocoder"], 2 ** (len(config["vae"]["block_out_channels"]) - 1)
    frame_s = math.prod(voc["upsample_rates"]) / voc["sampling_rate"]
    height = int(seconds / frame_s)
    return -(-height // scale), voc["model_in_dim"] // scale


def edit_request(config: dict, b: int, t5_len: int, adapter_tokens: int, steps: int, seconds: float) -> dict:
    """Model work of one AudioLDM2 + adapter ``generate`` call over ``b``
    clips (the encoders and the UNet at the CFG batch 2b): ``unet_step``,
    per UNet forward, and ``total``, the whole call's operations."""

    t, f = latent_shape(config, seconds)
    u = config["unet"]
    ctx = [(config["unet"]["adapter_num_tokens"], adapter_tokens), (t5_len, 0)]
    step, kv = unet_forward(u, 2 * b, t, f, ctx)
    cond = clap_text(config["clap"], 2 * b, config["clap"]["max_length"]) + t5_encoder(config["t5"], 2 * b, t5_len) \
        + projection(config["projection"], 2 * b, t5_len) \
        + gpt2_generate(config["gpt2"], 2 * b, t5_len + 5, config["gpt2"]["max_new_tokens"]) \
        + audiomae(config["audiomae"], 2 * b)
    dec = vae_decode(config["vae"], b, t, f) + vocoder(config["vocoder"], b, t * 2 ** (len(config["vae"]["block_out_channels"]) - 1))
    return {"unet_step": step.flops, "unet_bound_s": unet_bound_s(u, 2 * b, t, f, ctx), "unet_steps": steps,
            "total": steps * step.flops + kv.flops + cond.flops + dec.flops}


def v1_request(config: dict, b: int, steps: int, seconds: float) -> dict:
    """The same for one AudioLDM v1 ``generate`` call over ``b`` prompts."""

    t, f = latent_shape(config, seconds)
    u = config["unet"]
    step, _ = unet_forward(u, 2 * b, t, f)
    cond = clap_text(config["clap"], 2 * b, config["clap"]["max_length"])
    dec = vae_decode(config["vae"], b, t, f) + vocoder(config["vocoder"], b, t * 2 ** (len(config["vae"]["block_out_channels"]) - 1))
    return {"unet_step": step.flops, "unet_bound_s": unet_bound_s(u, 2 * b, t, f), "unet_steps": steps,
            "total": steps * step.flops + cond.flops + dec.flops}


def unet_train_backward(u: dict, b: int, t: int, f: int, ctx=()) -> float:
    """Operations of adapter training's UNet backward: the input gradients
    through every frozen product (as many operations as the forward's
    products, and twice its attention products: dQ, dK, dV and dP), and
    the weight gradients of the adapter's K/V matrices alone (as many as
    their forward). Not read by a metric yet; kept for a training cell."""

    step, kv = unet_forward(u, b, t, f, ctx)
    return (step.flops - step.attn) + 2 * step.attn + kv.adapter
