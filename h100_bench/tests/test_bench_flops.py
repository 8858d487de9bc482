"""flops.py against counts made another way: a hand count of one
transformer site, torch's FlopCounterMode over the reference models at a
tiny size (every product the reference runs), the parameter count of the
program's UNet at the published widths, and the frozen per-kernel
arithmetic against its original in chip_smoke.py."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100_bench import flops
from h100_bench.harness import ROOT
from h100_bench.reference.common import Cfg
from h100_bench.reference.audio import VAE, AudioMAE, HiFiGAN
from h100_bench.reference.text import T5, ClapText
from h100_bench.reference.unet import UNet
from h100_bench.tests.tiny import tiny_config

A2L = json.loads((ROOT / "h100_bench/configs/audioldm2-large-apadapter.json").read_text())
V1 = json.loads((ROOT / "h100_bench/configs/audioldm-s-full-v2.json").read_text())


def counted(fn) -> float:
    with FlopCounterMode(display=False) as mode:
        with torch.no_grad():
            fn()
    return float(mode.get_total_flops())


def no_norm_params(module) -> int:
    return sum(p.numel() for n, p in module.named_parameters() if "norm" not in n)


def test_transformer_site_by_hand():
    b, s, c, sk, sk_ip, dc = 2, 10, 16, 8, 4, 12
    u = {"transformer_layers_per_block": 1}
    step, kv = flops._t2d(u, b, s, c, dc, sk, sk_ip)
    proj_io = 2 * (2 * b * s * c * c)
    attn1 = 2 * b * s * c * 3 * c + 4 * b * s * s * c + 2 * b * s * c * c
    attn2 = 2 * b * s * c * c + 4 * b * s * (sk + sk_ip) * c + 2 * b * s * c * c
    ff = 2 * b * s * c * 8 * c + 2 * b * s * 4 * c * c
    assert step.flops == proj_io + attn1 + attn2 + ff
    assert kv.flops == 2 * b * sk * dc * 2 * c + 2 * b * sk_ip * dc * 2 * c
    assert kv.adapter == 2 * b * sk_ip * dc * 2 * c
    assert step.attn == 4 * b * s * s * c + 4 * b * s * (sk + sk_ip) * c


@pytest.mark.parametrize("pipeline", ["audioldm2", "audioldm_v1"])
def test_unet_forward_against_flop_counter(pipeline):
    cfg = tiny_config(pipeline)
    u = cfg["unet"]
    unet = UNet(Cfg(u)).eval()
    b, t, f = 2, 12, 8
    x = torch.randn(b, t, f, u["in_channels"])
    ts = torch.full((b,), 500.0)
    if pipeline == "audioldm2":
        ehs0 = torch.randn(b, u["adapter_num_tokens"] + 6, u["cross_attention_dims"][1])
        ehs1 = torch.randn(b, 5, u["cross_attention_dims"][2])
        got = counted(lambda: unet(x, ts, ehs0, ehs1, torch.ones(b, 5), 0.5))
        step, kv = flops.unet_forward(u, b, t, f, [(u["adapter_num_tokens"], 6), (5, 0)])
    else:
        labels = torch.randn(b, u["class_embed_dim"])
        got = counted(lambda: unet(x, ts, class_labels=labels))
        step, kv = flops.unet_forward(u, b, t, f)
    assert step.flops + kv.flops == got
    assert step.params + kv.params == no_norm_params(unet)


def test_encoders_and_decoders_against_flop_counter():
    cfg = tiny_config("audioldm2")
    b = 3
    clap = ClapText(Cfg(cfg["clap"])).eval()
    ids = torch.randint(3, 100, (b, 9))
    assert counted(lambda: clap(ids, torch.ones(b, 9))) == flops.clap_text(cfg["clap"], b, 9).flops
    t5 = T5(Cfg(cfg["t5"])).eval()
    assert counted(lambda: t5(ids, torch.ones(b, 9))) == flops.t5_encoder(cfg["t5"], b, 9).flops
    mae = AudioMAE(Cfg(cfg["audiomae"])).eval()
    fb = torch.randn(b, *cfg["audiomae"]["img_size"])
    assert counted(lambda: mae(fb, 2, 2)) == flops.audiomae(cfg["audiomae"], b).flops
    vae = VAE(Cfg(cfg["vae"])).eval()
    z = torch.randn(b, 6, 4, cfg["vae"]["latent_channels"])
    assert counted(lambda: vae.decode(z)) == flops.vae_decode(cfg["vae"], b, 6, 4).flops
    voc = HiFiGAN(Cfg(cfg["vocoder"])).eval()
    mel = torch.randn(b, 7, cfg["vocoder"]["model_in_dim"])
    assert counted(lambda: voc(mel)) == flops.vocoder(cfg["vocoder"], b, 7).flops


def test_unet_weights_are_the_programs():
    """The traversal visits every product of the published UNets: its
    weights (norms aside) are the program's parameter count."""

    from ap_adapter_torch.models.unet import AudioLDM2UNet
    from h100_bench.drivers.common import port_config

    for cfg, ctx in ((A2L, [(8, 128), (64, 0)]), (V1, [])):
        step, kv = flops.unet_forward(cfg["unet"], 2, 250, 16, ctx)
        with torch.device("meta"):
            unet = AudioLDM2UNet(port_config(A2L).unet.__class__(
                **{k: tuple(v) if isinstance(v, list) else v for k, v in cfg["unet"].items()}))
        assert step.params + kv.params == no_norm_params(unet)


def test_published_sizes():
    """The edit's UNet step at the CFG batch is operation-bound; the
    latent of a 10 s clip is 250 x 16."""

    assert flops.latent_shape(A2L, 10.0) == (250, 16)
    w = flops.edit_request(A2L, 1, 64, 128, 50, 10.0)
    step, kv = flops.unet_forward(A2L["unet"], 2, 250, 16, [(8, 128), (64, 0)])
    assert w["unet_bound_s"] == step.flops / flops.PEAK_FLOPS
    assert 2 * (step.params + kv.params) / flops.PEAK_BYTES < w["unet_bound_s"]
    assert w["total"] > 50 * w["unet_step"]
    b8 = flops.edit_request(A2L, 8, 64, 128, 50, 10.0)
    assert b8["unet_step"] == pytest.approx(8 * w["unet_step"], rel=1e-12)


def test_training_backward_by_hand():
    u = tiny_config("audioldm2")["unet"]
    step, kv = flops.unet_forward(u, 2, 12, 8, [(8, 6), (5, 0)])
    assert flops.unet_train_backward(u, 2, 12, 8, [(8, 6), (5, 0)]) == step.flops + step.attn + kv.adapter


@pytest.mark.parametrize("name, kw", [
    ("fused_ln_self_attention", {}), ("fused_ln_cross_attention_kv", dict(sk=8, sk_ip=128)),
    ("fused_ln_geglu_ff", {}), ("fused_ln_cross_attention", dict(sk=8, sk_ip=512, dc=768)),
    ("fused_ln_self_attention_bwd_dx", {}), ("fused_ln_cross_attention_bwd", dict(sk=64, dc=1024)),
    ("fused_ln_geglu_ff_bwd_dx", {}), ("fused_ln_geglu_ff_int8", {}), ("fused_ln_self_attention_int8", {}),
    ("fused_ln_cross_attention_int8", dict(sk=8, sk_ip=128, dc=768))])
def test_frozen_kernel_arithmetic(name, kw):
    import chip_smoke

    assert flops.work(name, 2, 252, 384, **kw) == chip_smoke.work(name, 2, 252, 384, **kw)
