#!/usr/bin/env python3
"""Device time of the port's kernels at every case of ``chip_smoke.py``'s
kernel phases, from ``torch.profiler``.

    python3 scripts/profile_kernels.py [--root DIR] [--phases resnet,...] [--tag NAME] [--out-dir DIR]

Imports ``chip_smoke.py`` and ``ap_adapter_torch`` from ``--root`` (default:
this checkout; an unpacked ``git archive`` of another commit measures that
commit in the same call) and runs its kernel phases (``kernels``,
``training``, ``int8``, ``resnet``, ``dual_kv``) with ``run_case`` replaced:
each case's kernel (and its library call, where the smoke times one) runs
3 times to warm up, then 10 times under the profiler (CPU and CUDA
activities) with a synchronise at the end. Per call: the device time, the
sum of the CUDA events' durations (kernels, memsets, copies), and the
number of device events, with their names and each name's device ms (the
split of a call by device kernel); and the device ms of any call the smoke
times beside a case as information (``sdpa`` beside K1, two ``sdpa`` plus
the add beside K10, K13's two convs as channels-last ``F.conv2d`` calls),
summed per kernel too; and the first 16 hex digits of a sha256 of the
output's bytes (``output_sha256``), so that two trees' outputs on the
smoke's seeded inputs can be compared bit for bit. The plain versions are
not run: ``chip_smoke.py`` holds the kernels against them.

Prints one line per case and one per kernel (device ms summed over its
cases, device kernels per call against ``EXPECTED_DEVICE_KERNELS``, the
library call's device ms summed over the cases that have one, beside the
kernel's device ms on those cases, and the information calls' device ms),
then the card's ``nvidia-smi`` line, and writes everything as JSON to
``OUT_DIR/profile_kernels[_TAG].json`` (default ``build/`` of this
checkout). Fails without a CUDA device and when the profiler records no
device time.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import sys
import time

PHASES = ("kernels", "training", "int8", "resnet", "dual_kv")
ITERS = 10
TRACE_TRIES = 4          # the tracer now and then hands back no device events: retry
# device kernels a call of the redesigned kernels and K12 (K11a: LN+quantize rows, int8 GEGLU GEMM, quantize
# rows, int8 W2 GEMM; K11b: LN+quantize rows, int8 q GEMM, K/V GEMM, attention, quantize rows, int8 out GEMM;
# K11c: context K/V GEMM, LN+quantize rows, int8 q GEMM, attention, quantize rows, int8 out GEMM; K13: GN1+SiLU,
# conv1, GN2+SiLU, conv2; K7: LN rows, QKV GEMM, g.Wo GEMM, dq kernel, dkv kernel, gxn GEMM, LN backward; K9: LN
# rows, the three-product GEMM, gxn GEMM, LN backward; K4: context K/V GEMM, then K2's four; K8 at a T5 site:
# context K/V GEMM, LN rows, Q GEMM, g.Wo GEMM, dq kernel, gxn GEMM, LN backward). A dict holds a count by case
# variant: K8's adapter cases also run the adapter weight-gradient products, library calls.
EXPECTED_DEVICE_KERNELS = {"fused_ln_self_attention": 4, "fused_ln_cross_attention_kv": 4, "fused_ln_geglu_ff": 3,
                           "dual_kv_attention": 1, "group_norm_silu": 1, "fused_ln_geglu_ff_int8": 4,
                           "fused_ln_self_attention_int8": 6, "fused_ln_cross_attention_int8": 6,
                           "fused_resnet_block": 4, "fused_ln_self_attention_bwd_dx": 7,
                           "fused_ln_geglu_ff_bwd_dx": 4, "fused_ln_cross_attention": 5,
                           "fused_ln_cross_attention_bwd": {"t5+bias": 7}}


def device_profile(fn, iters: int = ITERS) -> dict:
    """Device ms and device events per call of ``fn``, with the events' names."""

    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    else:
        raise RuntimeError("the profiler recorded no device events")
    total_us = sum(e.time_range.end - e.time_range.start for e in events)
    names = collections.Counter(e.name for e in events)
    names_ms = collections.Counter()
    for e in events:
        names_ms[e.name] += (e.time_range.end - e.time_range.start) / iters / 1e3
    return {"device_ms": total_us / iters / 1e3, "device_kernels": len(events) / iters,
            "names": {n: c / iters for n, c in names.items()}, "names_ms": dict(names_ms)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--phases", default=",".join(PHASES))
    parser.add_argument("--tag", default="")
    parser.add_argument("--out-dir", default=os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                                          "build"))
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    phases = args.phases.split(",")
    if set(phases) - set(PHASES):
        parser.error(f"--phases takes {PHASES}")

    import torch

    if not torch.cuda.is_available():
        print("profile_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    import chip_smoke
    from ap_adapter_torch.configs import PipelineConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(f"card: {card}; tree: {root}", flush=True)

    per_kernel: dict = {}

    def profile_case(results, name, variant, shape, keys, kernel, plain, tol, bd=None, library=None, split=False,
                     info=None) -> None:
        got = device_profile(kernel)
        lib = device_profile(library) if library is not None else None
        out = kernel()
        torch.cuda.synchronize()
        digest = hashlib.sha256(b"".join(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes()
                                         for t in (out if isinstance(out, tuple) else (out,))
                                         if torch.is_tensor(t))).hexdigest()[:16]
        case = {"variant": variant, "shape": list(shape), **{k: v for k, v in keys.items()}, **got,
                "output_sha256": digest,
                "library_device_ms": lib["device_ms"] if lib else None,
                "info_device_ms": {k: device_profile(fn)["device_ms"] for k, fn in (info or {}).items()}}
        k = per_kernel.setdefault(name, {"device_ms": 0.0, "device_kernels": [], "library_device_ms": None,
                                         "library_cases_device_ms": 0.0, "info_device_ms": {}, "cases": []})
        k["device_ms"] += got["device_ms"]
        for n, t in case["info_device_ms"].items():
            k["info_device_ms"][n] = k["info_device_ms"].get(n, 0.0) + t
        k["device_kernels"].append(got["device_kernels"])
        if lib:
            k["library_device_ms"] = (k["library_device_ms"] or 0.0) + lib["device_ms"]
            k["library_cases_device_ms"] += got["device_ms"]
        k["cases"].append(case)
        results[name]["cases"].append(case)      # the phase reads its last case
        names = ", ".join(f"{n[:60]} x{c:g} {got['names_ms'][n]:.4f} ms" for n, c in got["names"].items())
        print(f"case {name:30s} {variant:8s} {tuple(shape)} {keys}: sha256={digest} device_ms={got['device_ms']:.4f} "
              f"kernels/call={got['device_kernels']:g} [{names}]"
              + (f" library_device_ms={lib['device_ms']:.4f}" if lib else "")
              + "".join(f" {k}_device_ms={t:.4f} (information)" for k, t in case["info_device_ms"].items()),
              flush=True)

    chip_smoke.run_case = profile_case
    chip_smoke.build_phase()
    config = PipelineConfig()
    runs = {"kernels": lambda: chip_smoke.kernel_phase(device),
            "training": lambda: chip_smoke.train_kernel_phase(device),
            "int8": lambda: chip_smoke.int8_kernel_phase(device),
            "resnet": lambda: chip_smoke.resnet_kernel_phase(device, config.unet),
            "dual_kv": lambda: chip_smoke.dual_kv_kernel_phase(device)}
    t0 = time.perf_counter()
    for p in phases:
        runs[p]()
    torch.cuda.synchronize()
    for name, k in per_kernel.items():
        n = k["device_kernels"]
        k["device_kernels_per_call"] = sum(n) / len(n)
        k["device_kernels"] = sorted(set(n))
        want = EXPECTED_DEVICE_KERNELS.get(name)
        k["expected_device_kernels"] = want
        by_case = want if isinstance(want, dict) else {c["variant"]: want for c in k["cases"]}
        differs = any(c["variant"] in by_case and by_case[c["variant"]] is not None
                      and c["device_kernels"] != by_case[c["variant"]] for c in k["cases"])
        print(f"kernel {name:30s} device_ms={k['device_ms']:.4f} over {len(k['cases'])} cases, device kernels per "
              f"call {k['device_kernels']}"
              + ("" if want is None else f" (expected {want}{': DIFFERS' if differs else ''})")
              + (f", library_device_ms={k['library_device_ms']:.4f} (kernel {k['library_cases_device_ms']:.4f} "
                 f"on those cases)" if k["library_device_ms"] is not None else "")
              + "".join(f", {n}_device_ms={t:.4f} (information)" for n, t in k["info_device_ms"].items()),
              flush=True)
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, f"profile_kernels{'_' + args.tag if args.tag else ''}.json")
    with open(out, "w") as f:
        json.dump({"card": card, "root": root, "seconds": time.perf_counter() - t0, "kernels": per_kernel}, f)
    print(f"wrote {out} in {time.perf_counter() - t0:.1f} s", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
