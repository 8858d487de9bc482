"""One run of one benchmark cell.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything about a cell is found by name: the cell in ``BENCHMARK.json``
names its configuration (a file of sizes) and its traffic mix
(``traffic/<mix>.json``, whose ``driver`` names ``drivers/<driver>.py``);
every metric is read by ``metrics/<metric>.py``; the limits of the output
check are ``limits/<cell>.json``.

A run: set-up (weights drawn on the card from the seed, one call of each
of the mix's shapes at two denoise steps), then whole calls, back to back
from one client, until ``--seconds`` have passed; the peak device memory;
a check that nothing loaded JAX or the JAX package; the program freed;
the served clips of some calls, drawn from the seed, against the float32
reference. With ``--trace 1`` the harness's hooks time every UNet forward,
and ``torch.profiler`` records the first ``trace_calls`` calls: the
device's metrics are read from those, the host's spans and the model
operations a second from the calls after them, which run without the
profiler. The peak device memory is the window's: it is reset after the
warm-up. The last line of standard output is
the result; the last lines of standard error are the numbers compared,
each beside its limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
import traceback
import types
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ap_adapter_tpu")


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(workload: str, root: Path = ROOT) -> dict:
    """The cell, its configuration, its traffic mix, the metrics it reports
    in each kind of run, and its limits, all by name."""

    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         f"{[w['name'] for w in bench['workloads']]}")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def reports(m):
        return "workloads" not in m or workload in m["workloads"]

    return {"cell": cell,
            "config": json.loads((root / entry["file"]).read_text()),
            "mix": json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text()),
            "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
            "per_layer": [m for m in bench["per_layer"] if reports(m)],
            "limits": json.loads((BENCH / "limits" / f"{workload}.json").read_text())}


def driver_class(mix: dict):
    return load_file(BENCH / "drivers" / f"{mix['driver']}.py", f"h100_bench.drivers.{mix['driver']}").Driver


def read_metric(name: str, ctx) -> object:
    return load_file(BENCH / "metrics" / f"{name}.py", f"h100_bench_metric_{name}").read(ctx)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """Set-up, the window and the output check of one run (no look for a
    card here: ``main`` makes it). Returns the result's parts."""

    from h100_bench import trace as tr

    mix = spec["mix"]
    t_imports = time.perf_counter()
    drv = driver_class(mix)(spec["config"], mix, seed, device)
    sync(device)
    t_weights = time.perf_counter()
    for i in drv.warmup_calls():
        drv.call(i, steps=2)
    sync(device)
    setup_s = time.perf_counter() - t_start
    print(f"setup: {setup_s} s = imports {t_imports - t_start} + program and weights {t_weights - t_imports} "
          f"+ warm-up calls (the kernel library's build or load included) {t_start + setup_s - t_weights}",
          file=sys.stderr)

    spans = tr.UNetSpans(drv.unet()) if trace else None
    prof = tr.profiler() if trace else None
    calls, outputs, failed = [], {}, 0
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        traced = trace and i < mix["trace_calls"]
        if traced and i == 0:
            prof.start()
            spans.profiling = True
        start = time.perf_counter()
        try:
            if traced:
                with torch.profiler.record_function("request"):
                    out = drv.call(i)
            else:
                out = drv.call(i)
            outputs[i] = out
            ok = True
        except Exception:                       # a failed call counts, and the run goes on
            traceback.print_exc()
            failed += 1
            ok = False
        end = time.perf_counter()
        calls.append({"i": i, "start": start, "end": end, "ok": ok, "clips": drv.clips, "traced": traced,
                      "work": drv.work(i)})
        if spans is not None and spans.profiling and (i == mix["trace_calls"] - 1
                                                       or time.perf_counter() - t0 >= seconds):
            spans.profiling = False
            prof.stop()
        i += 1
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    trace_numbers = tr.read(prof) if trace else None
    unet_spans = list(spans.spans) if trace else []
    if spans is not None:
        spans.remove()
    bad = forbidden_modules()
    drv.release()
    checks = drv.check(outputs) if outputs else {}
    return {"setup_s": setup_s, "calls": calls, "failed": failed, "peak": peak, "forbidden": bad,
            "checks": checks, "trace": trace_numbers, "unet_spans": unet_spans}


def context(spec: dict, run: dict) -> types.SimpleNamespace:
    """What a metric's reader reads."""

    ok = [c for c in run["calls"] if c["ok"]]
    return types.SimpleNamespace(cell=spec["cell"], mix=spec["mix"], config=spec["config"],
                                 setup_s=run["setup_s"], calls=ok, traced_calls=[c for c in ok if c["traced"]],
                                 untraced_calls=[c for c in ok if not c["traced"]], unet_spans=run["unet_spans"],
                                 trace=run["trace"])


def judge(run: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)])."""

    compared = [(k, run["checks"].get(k), v) for k, v in limits.items()]
    ok = (run["failed"] == 0 and bool(run["checks"])
          and all(val is not None and val <= lim for _, val, lim in compared))
    return ok, compared


def main(argv=None, t_start: float = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = resolve(args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", file=sys.stderr)
    run = run_cell(spec, args.seed, args.seconds, bool(args.trace), device, t_start)
    if run["forbidden"]:
        print(f"modules of JAX or the JAX package were loaded: {run['forbidden']}", file=sys.stderr)
        return 3
    ctx = context(spec, run)
    durations = [c["end"] - c["start"] for c in ctx.calls]
    if durations:
        print(f"calls: {len(durations)}; seconds a call min {min(durations)} median "
              f"{statistics.median(durations)} max {max(durations)}; in order {durations}", file=sys.stderr)
    kinds = spec["per_layer"] if args.trace else spec["end_to_end"]
    metrics = {}
    for m in kinds:
        value = read_metric(m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, compared = judge(run, spec["limits"])
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                   "memory_peak_bytes": run["peak"]}
    result = {"correct": correct, "attempted": len(run["calls"]), "failed": run["failed"], "metrics": metrics,
              "device": device_info}
    if args.trace and run["trace"]:
        device_info.update(busy_s=run["trace"]["busy_s"], window_s=run["trace"]["window_s"])
        result["breakdown"] = run["trace"]["breakdown"]
        print(f"trace: {json.dumps({k: v for k, v in run['trace'].items() if k != 'breakdown'})}", file=sys.stderr)
    other = {k: v for k, v in run["checks"].items() if k not in spec["limits"]}
    if other:
        print(f"readings not compared: {json.dumps(other)}", file=sys.stderr)
    result["checks"] = {name: {"value": val, "limit": lim} for name, val, lim in compared}
    for name, val, lim in compared:
        print(f"check {name} {val} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
