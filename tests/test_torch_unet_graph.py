"""The UNet's CUDA-graph dispatch (``models/unet.py::AudioLDM2UNet.forward``)
on the CPU: CPU and grad-mode forwards run eager and record no graph; the
input signature that keys a graph; every replacement of the UNet's
parameters or buffers drops its graphs. No JAX, no card: the tiny UNet with
its own random weights (the replays themselves are in
``test_torch_cuda.py``)."""

import copy
import dataclasses
import types

import numpy as np
import pytest
import torch

from ap_adapter_torch.configs import tiny_pipeline_config
from ap_adapter_torch.models import unet as unet_mod
from ap_adapter_torch.models.hoist import precompute_cross_kv, precompute_temb_rows
from ap_adapter_torch.ops.cuda_kernels import UNET_FORWARDS

# the tiny UNet cut to two levels, one resnet a down block: a tenth of its
# build time, every kind of site and both hoisted inputs kept
CFG = dataclasses.replace(tiny_pipeline_config().unet, block_out_channels=(32, 32), down_block_has_attn=(False, True),
                          up_block_has_attn=(True, False), layers_per_block=1)
CPU = torch.device("cpu")


def tiny_unet(**switches) -> unet_mod.AudioLDM2UNet:
    torch.manual_seed(0)
    return unet_mod.AudioLDM2UNet(dataclasses.replace(CFG, **switches)).eval()


@pytest.fixture(scope="module")
def unet():
    return tiny_unet()


def step_inputs(unet, b=2, n_ip=16, steps=2, i=0, mask=True, hoist=True):
    """One denoise step's UNet inputs, as ``AudioLDM2Pipeline`` passes them:
    (sample, timesteps, ehs0, ehs1, mask, class_labels, ctx_kv, temb_rows)."""

    g = torch.Generator().manual_seed(b * 100 + n_ip)
    sample = torch.randn(b, 8, 8, CFG.in_channels, generator=g)
    ehs0 = torch.randn(b, 8 + n_ip, 32, generator=g)
    ehs1 = torch.randn(b, 8, 48, generator=g)
    mask1 = torch.ones(b, 8, dtype=torch.long) if mask else None
    ctx_kv = temb_rows = None
    if hoist:
        ctx_kv = precompute_cross_kv(unet, ehs0, ehs1, mask1)
        table = precompute_temb_rows(unet, np.linspace(900, 1, steps).astype(np.int64))
        temb_rows = {k: v[i] for k, v in table.items()}
    return sample, torch.full((b,), 501.0), ehs0, ehs1, mask1, None, ctx_kv, temb_rows


def signature(inputs, ip_scale=0.5, device=CPU):
    return unet_mod.graph_signature(inputs, ip_scale, device, [])


def test_cpu_and_grad_mode_forwards_stay_eager(unet):
    """Two CPU forwards of one signature under no_grad (the denoise loop's)
    and a grad-mode forward without hoisting (training's)."""

    sample, ts, ehs0, ehs1, mask1, _, ctx_kv, rows = step_inputs(unet)
    before = dict(UNET_FORWARDS)
    with torch.no_grad():
        outs = [unet(sample, ts, ehs0, ehs1, mask1, ip_scale=0.5, ctx_kv=ctx_kv, temb_rows=rows) for _ in range(2)]
    with torch.enable_grad():
        assert unet(sample, ts, ehs0, ehs1, mask1, ip_scale=0.5).requires_grad
    assert {k: UNET_FORWARDS[k] - before[k] for k in before} == {"captured": 0, "replayed": 0, "eager": 3}
    assert not unet._graphs and unet._graphs.pool is None
    assert torch.equal(outs[0], outs[1])


def test_signature_ignores_the_step(unet):
    """The same key at every step of a 2- and a 50-step schedule: the step
    count and the temb rows' values are no part of it."""

    keys = {signature(step_inputs(unet, steps=n, i=i)) for n, i in ((2, 0), (2, 1), (50, 0), (50, 37))}
    assert len(keys) == 1 and None not in keys


def _changed(unet, what):
    base = step_inputs(unet)
    if what == "ip_scale":
        return signature(base, ip_scale=0.55)
    if what == "adapter_tokens":
        return signature(step_inputs(unet, n_ip=4))
    if what == "batch":
        return signature(step_inputs(unet, b=4))
    if what == "no_mask":
        return signature(step_inputs(unet, mask=False))
    if what == "no_hoist":
        return signature(step_inputs(unet, hoist=False))
    if what == "class_labels":
        return signature(base[:5] + (torch.zeros(2, 4),) + base[6:])
    if what == "dtype":
        return signature((base[0].double(),) + base[1:])
    raise AssertionError(what)


@pytest.mark.parametrize("what", ["ip_scale", "adapter_tokens", "batch", "no_mask", "no_hoist", "class_labels",
                                  "dtype"])
def test_signature_changes_with_the_inputs(unet, what):
    key = _changed(unet, what)
    assert key is not None and key != signature(step_inputs(unet))


@pytest.mark.parametrize("what", ["python_timesteps", "other_device", "tensor_ip_scale"])
def test_no_signature_where_a_capture_would_bake_in_a_value(unet, what):
    """A Python number as ``timesteps``, a tensor on another device than
    the sample's, or a tensor ``ip_scale``: no key, so the forward runs eager."""

    inputs = step_inputs(unet)
    if what == "python_timesteps":
        assert signature(inputs[:1] + (501.0,) + inputs[2:]) is None
    elif what == "other_device":
        assert signature(inputs[:1] + (torch.empty(2, device="meta"),) + inputs[2:]) is None
    else:
        assert signature(inputs, ip_scale=torch.tensor(0.5)) is None


def _stub_mesh():
    return types.SimpleNamespace(shape={"model": 1}, coords={"model": 0}, groups={"model": None})


def _drop(what):
    """A fresh tiny UNet with a sentinel graph planted, and the operation."""

    from ap_adapter_torch.parallel.tp import tp_shard_unet_
    from ap_adapter_torch.train.trainer import split_unet_params

    switches = {"quantize_unet_int8_": {"use_int8": True}, "prepare_resnet_kernel_weights_": {"use_pallas_resnet": True}}
    ops = {
        "load_state_dict": lambda u: u.load_state_dict(u.state_dict()),
        "load_state_dict_assign": lambda u: u.load_state_dict({k: v.clone() for k, v in u.state_dict().items()},
                                                              assign=True),
        "load_state_dict_of_a_holder": lambda u: (h := torch.nn.ModuleDict({"unet": u})).load_state_dict(h.state_dict()),
        "to": lambda u: u.to(torch.float64),
        "to_of_a_holder": lambda u: torch.nn.ModuleDict({"unet": u}).to(torch.float64),
        "quantize_unet_int8_": unet_mod.quantize_unet_int8_,
        "prepare_resnet_kernel_weights_": unet_mod.prepare_resnet_kernel_weights_,
        "tp_shard_unet_": lambda u: tp_shard_unet_(u, _stub_mesh()),
        "split_unet_params": split_unet_params,
    }
    u = tiny_unet(**switches.get(what, {}))
    u._graphs["sentinel"] = unet_mod._WARMED
    u._graphs.pool = object()
    return u, ops[what]


@pytest.mark.parametrize("what", ["load_state_dict", "load_state_dict_assign", "load_state_dict_of_a_holder", "to",
                                  "to_of_a_holder", "quantize_unet_int8_", "prepare_resnet_kernel_weights_",
                                  "tp_shard_unet_", "split_unet_params"])
def test_replacing_weights_drops_the_graphs(what):
    u, op = _drop(what)
    op(u)
    assert not u._graphs and u._graphs.pool is None


def test_a_copy_starts_without_graphs(unet):
    unet._graphs["sentinel"] = unet_mod._WARMED
    try:
        dup = copy.deepcopy(unet)
        assert not dup._graphs and dup._graphs.pool is None
        assert "sentinel" in unet._graphs
    finally:
        unet.drop_graphs()
