"""Readers shared by metrics of several names (one name a kind of cell).

A reader takes the run's context (``harness.context``): ``calls`` (every
completed call: host-clock ``start`` and ``end``, ``clips``, and ``work``,
the model operations ``flops.py`` counts for it from the cell's shapes),
``traced_calls`` (those the profiler recorded), ``untraced_calls`` (the
others), ``unet_spans`` (host-clock start and end of every UNet forward of
a ``--trace 1`` run, from the harness's hooks) and ``trace``
(``trace.read``: the traced window, the device's busy time, the device time
of the operations launched inside UNet forwards). The host's spans and the
model operations a second are read from the untraced calls alone, since
the profiler slows the host; the device's metrics from the traced ones.
"""

from __future__ import annotations

import statistics

from h100_bench.flops import PEAK_FLOPS


def seconds_per_call(ctx):
    """Wall seconds of all completed calls over their count."""

    if not ctx.calls:
        return None
    return sum(c["end"] - c["start"] for c in ctx.calls) / len(ctx.calls)


def clips_per_second(ctx):
    """Clips of all completed calls over the wall seconds they took."""

    if not ctx.calls:
        return None
    return sum(c["clips"] for c in ctx.calls) / sum(c["end"] - c["start"] for c in ctx.calls)


def _spans_of(ctx, c):
    return [e - s for s, e in ctx.unet_spans if s >= c["start"] and e <= c["end"]]


def unet_step_ms(ctx):
    """Mean host-clock milliseconds of one UNet forward (the denoise step's
    model call) over the untraced calls of a ``--trace 1`` run."""

    spans = [d for c in ctx.untraced_calls for d in _spans_of(ctx, c)]
    if not spans:
        return None
    return 1e3 * statistics.fmean(spans)


def outside_loop_ms(ctx):
    """Mean over the untraced calls of a ``--trace 1`` run of the call's
    wall time less its UNet forwards': conditioning, the step glue, the VAE
    decode and the vocoder."""

    out = [c["end"] - c["start"] - sum(_spans_of(ctx, c)) for c in ctx.untraced_calls if _spans_of(ctx, c)]
    if not out:
        return None
    return 1e3 * statistics.fmean(out)


def unet_roofline(ctx):
    """Percent: the least time of the traced calls' UNet steps on the card
    (``flops.unet_bound_s`` from the cell's shapes) over the device time of
    the operations launched inside the UNet forwards."""

    t = ctx.trace
    if not t or not t["unet_device_s"] or not ctx.traced_calls:
        return None
    least = sum(c["work"]["unet_steps"] * c["work"]["unet_bound_s"] for c in ctx.traced_calls)
    return 100.0 * least / t["unet_device_s"]


def mfu(ctx):
    """Percent: the model operations of the untraced calls of a ``--trace
    1`` run over the wall seconds they took at the card's bf16 peak."""

    if not ctx.untraced_calls:
        return None
    seconds = sum(c["end"] - c["start"] for c in ctx.untraced_calls)
    return 100.0 * sum(c["work"]["total"] for c in ctx.untraced_calls) / (seconds * PEAK_FLOPS)


def device_idle(ctx):
    """Percent of the traced window in which no operation ran on the card."""

    t = ctx.trace
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
