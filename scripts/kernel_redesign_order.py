#!/usr/bin/env python3
"""Order the port's kernels for redesign from one ``chip_smoke.py`` run.

    python3 chip_smoke.py > smoke.log
    python3 scripts/profile_kernels.py      # writes build/profile_kernels.json
    python3 scripts/kernel_redesign_order.py smoke.log [build/profile_kernels.json]

Reads the ``{"kernels": [...]}`` line that ``chip_smoke.py`` prints and,
where given, the device times of ``scripts/profile_kernels.py``, and
prints two lists:

1. the kernels slower than one PyTorch call for the same function (those
   with ``library_ms``), the largest factor first: kernel ms on the cases
   that have a library call over the library's ms, by device time where
   the profile has it, else by CUDA events (which enclose the wrapper's
   host path);
2. every kernel by its excess time per unit of its path,
   launches x (ms per launch - bound per launch), the largest first: first
   the kernels of the main path (the default bf16 edit request, which
   ``bench.py`` and the smoke's edit requests run), then the rest (the
   training step and the serving switches, off by default). A
   kernel's ms per launch is its summed device ms (else event ms) over the
   path's shapes divided by the number of shapes and variants it was timed
   at (each is one call at one shape of the path), the same for the bound;
   launches are the kernels line's count divided by the units the smoke's
   run covered (two bf16 and two int8 edit requests, six training
   micro-steps, one request under each resnet switch and under
   use_pallas_attention).

Runs anywhere: it reads a log, it touches no card.
"""

from __future__ import annotations

import json
import sys

# (units of the smoke's run, unit, on the main path: the default bf16 request) for each kernel's launches
UNITS = {
    "fused_ln_self_attention": (2, "bf16 request", True),
    "fused_ln_cross_attention_kv": (2, "bf16 request", True),
    "fused_ln_geglu_ff": (2, "bf16 request", True),
    "self_attention": (2, "bf16 request", True),
    "fused_ln_cross_attention": (6, "training micro-step", False),
    "fused_ln_self_attention_bwd_dx": (6, "training micro-step", False),
    "fused_ln_cross_attention_bwd": (6, "training micro-step", False),
    "fused_ln_geglu_ff_bwd_dx": (6, "training micro-step", False),
    "fused_ln_geglu_ff_int8": (2, "int8 request", False),
    "fused_ln_self_attention_int8": (2, "int8 request", False),
    "fused_ln_cross_attention_int8": (2, "int8 request", False),
    "group_norm_silu": (1, "K12 request", False),
    "fused_resnet_block": (1, "K13 request", False),
    "dual_kv_attention": (1, "K10 request", False),
}


def kernels_line(path: str) -> list:
    with open(path) as f:
        for line in f:
            if line.startswith('{"kernels"'):
                return json.loads(line)["kernels"]
    raise SystemExit(f"{path}: no kernels line")


def main(argv=None) -> None:
    argv = argv or sys.argv[1:]
    kernels = kernels_line(argv[0])
    device = {}
    if len(argv) > 1:
        with open(argv[1]) as f:
            device = json.load(f)["kernels"]
    print("slower than one PyTorch call (kernel ms / library ms on the same cases):")
    slow = []
    for k in kernels:
        dev = device.get(k["name"], {})
        if dev.get("library_device_ms"):
            slow.append((dev["library_cases_device_ms"] / dev["library_device_ms"], k["name"], "device"))
        elif k["library_ms"]:
            slow.append((k["library_cases_ms"] / k["library_ms"], k["name"], "events"))
    for ratio, name, by in sorted(slow, reverse=True):
        if ratio > 1:
            print(f"  {name}: {ratio:.3f}x ({by})")
    print("launches x (ms per launch - bound per launch), per unit of the kernel's path:")
    rows = {True: [], False: []}
    for k in kernels:
        n = len(k["cases"])
        units, unit, main_path = UNITS[k["name"]]
        by = "device" if k["name"] in device else "events"
        ms = device[k["name"]]["device_ms"] if by == "device" else k["ms"]
        per_launch, bound = ms / n, k["bound_ms"] / n
        launches = k["launches"] / units
        rows[main_path].append((launches * (per_launch - bound), k["name"], launches, unit, per_launch, bound, by))
    for main_path, title in ((True, "main path (the default bf16 request)"), (False, "other paths")):
        print(f" {title}:")
        for excess, name, launches, unit, per_launch, bound, by in sorted(rows[main_path], reverse=True):
            print(f"  {name}: {excess:.1f} ms per {unit} ({launches:g} launches x ({per_launch:.4f} - {bound:.4f}) ms, "
                  f"{by})")


if __name__ == "__main__":
    main()
