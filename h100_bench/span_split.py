#!/usr/bin/env python3
"""The program's spans over one cell, on the card of the machine it is
started on:

    python3 h100_bench/span_split.py --workload <cell> --seed <n> [--pairs 6] [--out <file>]

from the root of a checkout. Set-up and warm-up as ``harness.run_cell``,
then:

1. the host nanoseconds of one span with the tracer off and on (a loop of
   empty ``with`` blocks, less the bare loop);
2. the cell's first ``trace_calls`` calls under ``torch.profiler``, with
   the tracer on and the harness's hooks and ``request`` ranges: the
   device's idle gaps labelled by the program's spans and its time put
   down to the span that launched it (``program_spans.read_events``) and,
   with those ranges left out, the gaps under the harness's labels alone;
3. ``--pairs`` pairs of calls, one call index a pair, run with the tracer
   off and on in turns (off, on, then on, off, ...), the harness's UNet
   hooks on throughout: each side's seconds, whether the two clips are
   bit-equal, and over the calls with the tracer on every reader of
   ``program_spans`` beside the harness's ``unet_step_ms`` and
   ``outside_loop_ms``, with the accounting of a call's time outside its
   UNet forwards.

A program without the tracer runs all three with nothing to read. The
last line of standard output is the result (JSON); ``--out`` writes it
to a file too.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    # as run.py: the same threads, no JAX through transformers
    os.environ.update(USE_FLAX="0", USE_TF="0", OMP_NUM_THREADS="4")
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from h100_bench import program_spans as ps  # noqa: E402
from h100_bench import trace as tr  # noqa: E402
from h100_bench.harness import card_line, driver_class, resolve, sync  # noqa: E402
from h100_bench.metrics import common  # noqa: E402


def tracer():
    """The program's tracer, or None where the program has none."""

    try:
        from ap_adapter_torch.utils import trace
    except ImportError:
        return None
    return trace


def span_ns(trace, n: int = 200_000) -> dict:
    """Host ns of one empty ``with span(...)`` block off and on, less the
    bare loop's ns an iteration."""

    def per_iter(body) -> float:
        t0 = time.perf_counter_ns()
        body()
        return (time.perf_counter_ns() - t0) / n

    def bare():
        for _ in range(n):
            pass

    def spans():
        for _ in range(n):
            with trace.span("ap.bench"):
                pass

    loop = per_iter(bare)
    off = per_iter(spans)
    trace.enable()
    on = per_iter(spans)
    trace.drain()
    trace.disable()
    return {"loop_ns": loop, "off_ns": off - loop, "on_ns": on - loop}


def accounting(ctx) -> dict:
    """Mean over the calls: the ``ap.generate`` span less its ``ap.unet``
    spans plus the ``ap.fbank`` spans, against the phases' sum."""

    whole, steps = [], []
    for c in ctx.untraced_calls:
        mine = [(n, e - s) for n, _, _, _, s, e in ctx.program_spans if s >= c["start"] and e <= c["end"]]
        of = lambda name: sum(d for n, d in mine if n == name)
        whole.append(1e3 * (of("ap.generate") - of("ap.unet") + of("ap.fbank")))
        steps.append(sum(1 for n, _ in mine if n == "ap.step"))
    if not whole:
        return {}
    parts = {k: f(ctx) or 0.0 for k, f in (("text_ms", ps.text_ms), ("audio_ms", ps.audio_ms),
                                            ("hoist_ms", ps.hoist_ms), ("step_glue_ms", ps.step_glue_ms),
                                            ("decode_ms", ps.decode_ms))}
    n_steps, program = statistics.fmean(steps), statistics.fmean(whole)
    total = (parts["text_ms"] + parts["audio_ms"] + parts["hoist_ms"] + n_steps * parts["step_glue_ms"]
             + parts["decode_ms"])
    outside = common.outside_loop_ms(ctx)
    return {"generate_less_unet_plus_fbank_ms": program, "steps": n_steps, "phases_ms": total,
            "phases_share": total / program, "outside_loop_ms": outside, "outside_less_program_ms": outside - program}


def run(spec: dict, seed: int, pairs: int, device) -> dict:
    trace = tracer()
    mix = spec["mix"]
    drv = driver_class(mix)(spec["config"], mix, seed, device)
    for i in drv.warmup_calls():
        drv.call(i, steps=2)
    sync(device)
    out = {"tracer": trace is not None, "span_ns": span_ns(trace) if trace is not None else None}

    hooks = tr.UNetSpans(drv.unet())
    if trace is not None:
        trace.enable()
    prof = tr.profiler()
    prof.start()
    hooks.profiling = True
    for i in range(mix["trace_calls"]):
        with torch.profiler.record_function("request"):
            drv.call(i)
    sync(device)
    hooks.profiling = False
    prof.stop()
    if trace is not None:
        trace.disable()
        trace.drain()
    events = [(e.name(), e.device_type() == torch.autograd.DeviceType.CPU, e.start_ns(), e.duration_ns(),
               e.correlation_id()) for e in prof.profiler.kineto_results.events()]
    harness_only = [e for e in events if not (e[1] and e[0].startswith(ps.PREFIX))]
    out["profiled"] = {"calls": mix["trace_calls"], "program": ps.read_events(events),
                       "harness_labels": ps.read_events(harness_only)}
    del events, harness_only, prof

    calls, pair_rows = [], []
    for k in range(pairs):
        i, clips, row = mix["trace_calls"] + k, {}, {}
        for on in ((False, True) if k % 2 == 0 else (True, False)):
            if on and trace is not None:
                trace.enable()
            start = time.perf_counter()
            clips[on] = drv.call(i)
            end = time.perf_counter()
            if trace is not None:
                trace.disable()
            calls.append({"i": i, "on": on, "start": start, "end": end, "clips": drv.clips})
            row["on_s" if on else "off_s"] = end - start
        pair_rows.append({"i": i, **row, "equal": bool(np.array_equal(clips[False], clips[True]))})
    records, dropped = trace.drain() if trace is not None else ([], 0)
    program = ps.spans(records)
    unet_spans = list(hooks.spans)
    hooks.remove()

    def side(on: bool) -> types.SimpleNamespace:
        mine = [c for c in calls if c["on"] == on]
        return types.SimpleNamespace(calls=mine, untraced_calls=mine, unet_spans=unet_spans,
                                     program_spans=program)

    off, on = side(False), side(True)
    out.update(
        pairs=pair_rows,
        request_s={"off": common.seconds_per_call(off), "on": common.seconds_per_call(on)},
        clips_per_s={"off": common.clips_per_second(off), "on": common.clips_per_second(on)},
        unet_step_ms={"off": common.unet_step_ms(off), "on": common.unet_step_ms(on)},
        outside_loop_ms={"off": common.outside_loop_ms(off), "on": common.outside_loop_ms(on)},
        spans=len(records), dropped=dropped,
        readers={name: getattr(ps, name)(on) for name in ("text_ms", "audio_ms", "hoist_ms", "decode_ms",
                                                          "step_glue_ms", "unet_ms", "unet_resnet_ms",
                                                          "unet_attn_ms")},
        accounting=accounting(on) if records else {})
    r = out["request_s"]
    out["on_cost_pct"] = 100.0 * (r["on"] - r["off"]) / r["off"]
    drv.release()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = {"workload": args.workload, "seed": args.seed, "card": card_line(),
              "torch": torch.__version__, **run(resolve(args.workload), args.seed, args.pairs, device)}
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
