"""Spans and device activity of a traced run.

The harness's own hooks on the program's UNet module time every forward on
the host clock and, while the profiler runs, open and close a
``record_function`` range ``unet_fwd`` around it; the harness wraps every
call in a ``request`` range. ``torch.profiler`` records the device's
kernels, copies and sets over the traced calls. This module reads them:
the traced window, the device's busy time (the union of its operations'
intervals), the device time of the operations launched inside a
``unet_fwd`` range (a kernel's launch is matched to the host's runtime call
by the profiler's correlation id), and the breakdown by operation name and
by what the host was doing while the device idled.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

RANGES = ("request", "unet_fwd")


class UNetSpans:
    """Forward pre- and post-hooks on a module: host-clock (start, end) of
    every forward, and a ``unet_fwd`` profiler range around it while
    ``profiling`` is set."""

    def __init__(self, module: torch.nn.Module):
        self.spans: List[Tuple[float, float]] = []
        self.profiling = False
        self._open = []
        self._handles = [module.register_forward_pre_hook(self._pre), module.register_forward_hook(self._post)]

    def _pre(self, module, args):
        rf = None
        if self.profiling:
            rf = torch.profiler.record_function("unet_fwd")
            rf.__enter__()
        self._open.append((time.perf_counter(), rf))

    def _post(self, module, args, out):
        start, rf = self._open.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        self.spans.append((start, time.perf_counter()))

    def remove(self):
        for h in self._handles:
            h.remove()


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _inside(t: int, ranges: List[Tuple[int, int]]) -> bool:
    import bisect

    k = bisect.bisect_right(ranges, (t, float("inf"))) - 1
    return k >= 0 and ranges[k][0] <= t <= ranges[k][1]


def read(prof) -> Optional[dict]:
    """The traced window's numbers, or None where the profiler recorded no
    device operation. Times in seconds."""

    cpu = torch.autograd.DeviceType.CPU
    ranges: Dict[str, list] = defaultdict(list)
    launches: Dict[int, int] = {}
    ops = []
    for e in prof.profiler.kineto_results.events():
        name, start, dur = e.name(), e.start_ns(), e.duration_ns()
        if e.device_type() == cpu:
            if name in RANGES:
                ranges[name].append((start, start + dur))
            elif name.startswith("cu"):                      # runtime calls: launches, copies, sets
                launches[e.correlation_id()] = start
        elif name not in RANGES and dur > 0:
            ops.append((start, start + dur, name, e.correlation_id()))
    if not ops or not ranges["request"]:
        return None
    req = sorted(ranges["request"])
    w0, w1 = req[0][0], req[-1][1]
    ops = [o for o in ops if o[1] > w0 and o[0] < w1]
    busy = _union([(max(s, w0), min(e, w1)) for s, e, _, _ in ops])
    unet = sorted(ranges["unet_fwd"])
    matched = [o for o in ops if o[3] in launches]
    in_unet = sum(e - s for s, e, _, c in matched if _inside(launches[c], unet))
    by_name: Dict[str, int] = defaultdict(int)
    for s, e, name, _ in ops:
        by_name[name] += e - s
    gaps: Dict[str, int] = defaultdict(int)
    edges = [(w0, w0)] + busy + [(w1, w1)]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b > a:
            mid = (a + b) // 2
            label = ("host in unet_fwd" if _inside(mid, unet) else
                     "host in request, outside unet_fwd" if _inside(mid, req) else "host between requests")
            gaps[label] += b - a
    top = lambda d: [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": (w1 - w0) / 1e9, "busy_s": sum(e - s for s, e in busy) / 1e9,
            "unet_device_s": in_unet / 1e9, "ops": len(ops), "ops_matched": len(matched),
            "unet_ranges": len(unet), "breakdown": {"device_ops": top(by_name), "idle_gaps": top(gaps)}}
