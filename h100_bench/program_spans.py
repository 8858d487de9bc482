"""Readers of the program's own spans (``ap_adapter_torch/utils/trace.py``).

A span is a tuple (name, id, parent id, request id, start s, end s) on the
clock of ``time.perf_counter``, the clock of the calls' ``start`` and
``end``; ``spans(records)`` makes them from the tracer's ``drain()``. A
span belongs to a call when it lies inside the call's ``start``/``end``.
Each reader takes a context with ``program_spans`` and ``untraced_calls``
(``harness.context``'s calls) and returns milliseconds, or None where no
span was recorded (a program without the tracer records none):

- ``text_ms``: a call's time in ``ap.text`` (CLAP, T5, projection, GPT-2);
- ``audio_ms``: in ``ap.fbank`` and ``ap.audiomae``;
- ``decode_ms``: in ``ap.vae_decode``, ``ap.vocoder`` and ``ap.to_host``
  (the host's wait for the device's tail);
- ``hoist_ms``: in ``ap.hoist``;
- ``step_glue_ms``: an ``ap.step`` span less its ``ap.unet`` span;
- ``unet_ms``: an ``ap.unet`` span;
- ``unet_resnet_ms``, ``unet_attn_ms``: an ``ap.unet`` span's time in its
  ``ap.unet.resnet`` and its ``ap.unet.attn`` children.

``read_events`` labels the device's idle gaps of a profiled window by the
innermost ``ap.`` range of the profiler's trace that holds each gap's
midpoint ("host in ap.unet.attn"); a gap that no such range holds keeps
``trace.read``'s labels (``request``, ``unet_fwd``). It puts each device
operation's time down to the innermost ``ap.`` range that held its
launch, over the window and inside the ``ap.to_host`` waits.
"""

from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from h100_bench.trace import RANGES, _inside, _union

PREFIX = "ap."


def spans(records: Iterable) -> List[tuple]:
    """The tracer's records as (name, id, parent, request, start s, end s)."""

    return [(r[0], r[1], r[2], r[3], r[4] / 1e9, r[5] / 1e9) for r in records]


def _per_call(ctx, names: Tuple[str, ...]) -> Optional[float]:
    """Mean over the calls of the milliseconds in spans named ``names``;
    None where no call holds one."""

    out = []
    for c in ctx.untraced_calls:
        d = [e - s for n, _, _, _, s, e in ctx.program_spans
             if n in names and s >= c["start"] and e <= c["end"]]
        if d:
            out.append(sum(d))
    return 1e3 * statistics.fmean(out) if out else None


def _children(ctx, parent: str, child: str) -> Optional[float]:
    """Mean over the ``parent`` spans of the calls of the milliseconds
    in their ``child`` children."""

    calls = ctx.untraced_calls
    inside = lambda s, e: any(s >= c["start"] and e <= c["end"] for c in calls)
    parents = {i: 0.0 for n, i, _, _, s, e in ctx.program_spans if n == parent and inside(s, e)}
    if not parents:
        return None
    for n, _, p, _, s, e in ctx.program_spans:
        if n == child and p in parents:
            parents[p] += e - s
    return 1e3 * statistics.fmean(parents.values())


def _mean_span(ctx, name: str) -> Optional[float]:
    calls = ctx.untraced_calls
    d = [e - s for n, _, _, _, s, e in ctx.program_spans
         if n == name and any(s >= c["start"] and e <= c["end"] for c in calls)]
    return 1e3 * statistics.fmean(d) if d else None


def text_ms(ctx):
    return _per_call(ctx, ("ap.text",))


def audio_ms(ctx):
    return _per_call(ctx, ("ap.fbank", "ap.audiomae"))


def decode_ms(ctx):
    return _per_call(ctx, ("ap.vae_decode", "ap.vocoder", "ap.to_host"))


def hoist_ms(ctx):
    return _per_call(ctx, ("ap.hoist",))


def unet_ms(ctx):
    return _mean_span(ctx, "ap.unet")


def step_glue_ms(ctx):
    step, unet = _mean_span(ctx, "ap.step"), _children(ctx, "ap.step", "ap.unet")
    return None if step is None else step - unet


def unet_resnet_ms(ctx):
    return _children(ctx, "ap.unet", "ap.unet.resnet")


def unet_attn_ms(ctx):
    return _children(ctx, "ap.unet", "ap.unet.attn")


def _innermost(times: List[int], ranges: Dict[str, list]) -> List[Optional[str]]:
    """For the ascending ``times``, the name of the innermost ``ap.`` range
    of ``ranges`` ({name: [(start, end)]} of the host's ranges, which nest
    on one thread) that holds each, or None."""

    prog = sorted(((s, e, n) for n, rs in ranges.items() if n.startswith(PREFIX) for s, e in rs),
                  key=lambda r: (r[0], -r[1]))
    out, stack, k = [], [], 0
    for t in times:
        while k < len(prog) and prog[k][0] <= t:
            while stack and stack[-1][1] < prog[k][0]:
                stack.pop()
            stack.append(prog[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def label_gaps(gaps: List[Tuple[int, int]], ranges: Dict[str, list]) -> Tuple[Dict[str, int], int, int]:
    """({label: idle ns}, idle ns inside ``request`` ranges, of which ns
    under an ``ap.`` range) for the sorted, disjoint ``gaps``. ``ranges``:
    {name: [(start, end)]} of the host's ranges. A gap's label is the
    innermost ``ap.`` range that holds its midpoint, else ``trace.read``'s."""

    req, unet = sorted(ranges.get("request", [])), sorted(ranges.get("unet_fwd", []))
    labels: Dict[str, int] = defaultdict(int)
    in_req = covered = 0
    mids = [(a + b) // 2 for a, b in gaps]
    for (a, b), mid, inner in zip(gaps, mids, _innermost(mids, ranges)):
        inside_req = _inside(mid, req)
        if inner:
            label = f"host in {inner}"
        elif _inside(mid, unet):
            label = "host in unet_fwd"
        else:
            label = "host in request, outside unet_fwd" if inside_req else "host between requests"
        labels[label] += b - a
        if inside_req:
            in_req += b - a
            covered += (b - a) if inner else 0
    return dict(labels), in_req, covered


def _device_by_launch(ops: List[tuple], launches: Dict[int, int], ranges: Dict[str, list]) -> Tuple[dict, dict]:
    """({span: device s}, {span: device s inside ``ap.to_host`` ranges}) of
    the device operations ``ops`` (start, end, correlation id), each put
    down to the innermost ``ap.`` range that held its launch ("none"
    outside them or unmatched)."""

    matched = sorted((launches[c], s, e) for s, e, c in ops if c in launches)
    names = _innermost([t for t, _, _ in matched], ranges)
    to_host = ranges.get("ap.to_host", [])
    total: Dict[str, int] = defaultdict(int)
    tail: Dict[str, int] = defaultdict(int)
    for (_, s, e), name in zip(matched, names):
        name = name or "none"
        total[name] += e - s
        for a, b in to_host:
            if e > a and s < b:
                tail[name] += min(e, b) - max(s, a)
    total["none"] += sum(e - s for s, e, c in ops if c not in launches)
    order = lambda d: {k: v / 1e9 for k, v in sorted(d.items(), key=lambda kv: -kv[1]) if v}
    return order(total), order(tail)


def read_events(events: Iterable[tuple]) -> Optional[dict]:
    """The window from the first ``request`` range's start to the last
    one's end: its idle gaps labelled by ``label_gaps``, the device time
    put down to the span that launched it, and the host seconds of each
    ``ap.`` range. ``events``: (name, on the host, start ns, duration ns,
    correlation id) of every profiler event. None where no device
    operation or no request was recorded."""

    ranges: Dict[str, list] = defaultdict(list)
    launches: Dict[int, int] = {}
    ops = []
    for name, host, start, dur, corr in events:
        if host:
            if name in RANGES or name.startswith(PREFIX):
                ranges[name].append((start, start + dur))
            elif name.startswith("cu"):                     # runtime calls: launches, copies, sets
                launches[corr] = start
        elif name not in RANGES and not name.startswith(PREFIX) and dur > 0:   # not the ranges' device copies
            ops.append((start, start + dur, corr))
    if not ops or not ranges["request"]:
        return None
    req = sorted(ranges["request"])
    w0, w1 = req[0][0], req[-1][1]
    ops = [(max(s, w0), min(e, w1), c) for s, e, c in ops if e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _ in ops])
    edges = [(w0, w0)] + busy + [(w1, w1)]
    gaps = [(a, b) for (_, a), (b, _) in zip(edges, edges[1:]) if b > a]
    labels, in_req, covered = label_gaps(gaps, ranges)
    top = sorted(labels.items(), key=lambda kv: -kv[1])
    device, to_host = _device_by_launch(ops, launches, ranges)
    return {"window_s": (w1 - w0) / 1e9, "busy_s": sum(e - s for s, e in busy) / 1e9,
            "idle_gaps": [[k, v / 1e9] for k, v in top], "idle_in_calls_s": in_req / 1e9,
            "program_share": covered / in_req if in_req else None,
            "program_ranges": sum(len(v) for k, v in ranges.items() if k.startswith(PREFIX)),
            "device_s_by_launch": device, "device_s_in_to_host_by_launch": to_host,
            "host_s": {k: sum(e - s for s, e in v) / 1e9 for k, v in ranges.items() if k.startswith(PREFIX)}}
