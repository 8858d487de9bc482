"""PyTorch port: ``scripts/kernel_redesign_order.py`` on a small synthetic
smoke log and profile (no card): the kernels slower than their library call,
then the excess time per unit of each kernel's path, the main path (the
default bf16 request) first."""

import importlib.util
import json
from pathlib import Path

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "kernel_redesign_order.py"


def _order_module():
    spec = importlib.util.spec_from_file_location("kernel_redesign_order", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernel(name, launches, ms, bound_ms, cases, library_ms=None, library_cases_ms=0.0):
    return {"name": name, "launches": launches, "ms": ms, "bound_ms": bound_ms, "library_ms": library_ms,
            "library_cases_ms": library_cases_ms, "cases": [{}] * cases}


def test_order_lists_the_main_path_first(tmp_path, capsys):
    order = _order_module()
    kernels = [
        _kernel("fused_ln_self_attention", 19200, 0.30, 0.006, 3),
        _kernel("fused_ln_geglu_ff", 12800, 0.24, 0.009, 3),
        _kernel("self_attention", 2, 1.2, 0.6, 4, library_ms=2.0, library_cases_ms=1.2),
        _kernel("fused_ln_self_attention_int8", 19200, 3.0, 0.006, 3),    # the largest excess, off the main path
        _kernel("group_norm_silu", 2200, 0.5, 0.03, 34, library_ms=0.2, library_cases_ms=0.3),
    ]
    log = tmp_path / "smoke.log"
    log.write_text("build: ...\n" + json.dumps({"kernels": kernels}) + "\nNVIDIA H100 80GB HBM3, 700.00 W\n")
    profile = tmp_path / "profile.json"
    profile.write_text(json.dumps({"kernels": {"fused_ln_self_attention": {"device_ms": 0.09},
                                               "group_norm_silu": {"device_ms": 0.2, "library_device_ms": 0.1,
                                                                   "library_cases_device_ms": 0.15}}}))
    order.main([str(log), str(profile)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == "  group_norm_silu: 1.500x (device)"          # self_attention is below its library call
    main, other = lines.index(" main path (the default bf16 request):"), lines.index(" other paths:")
    assert main < other
    names = [line.split(":")[0].strip() for line in lines]
    assert names[main + 1:other] == ["fused_ln_geglu_ff", "fused_ln_self_attention", "self_attention"]
    assert names[other + 1:] == ["fused_ln_self_attention_int8", "group_norm_silu"]
    # K1 by device time: 9600 launches per request x (0.09 / 3 - 0.006 / 3) ms
    assert lines[main + 2].startswith("  fused_ln_self_attention: 268.8 ms per bf16 request (9600 launches")
    assert lines[main + 2].endswith("device)")
