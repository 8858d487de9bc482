"""``program_spans``: the idle-gap labels from the program's ``ap.`` ranges
on a synthetic event list, the harness's labels where there are none,
each reader on hand-built spans, and ``span_split`` on a tiny cell."""

import types

import pytest

from h100_bench import program_spans as ps

MS = 1_000_000          # ns


def events(with_program: bool) -> list:
    """Two requests of 100 ms (host ranges), the device busy in three
    stretches, each launched by a runtime call of the same correlation id;
    the program's ranges nest inside the first request."""

    host = [("request", 0, 100 * MS, 0), ("unet_fwd", 20 * MS, 40 * MS, 0), ("request", 150 * MS, 100 * MS, 0),
            ("cudaLaunchKernel", 1, 1, 1), ("cudaLaunchKernel", 35 * MS, 1, 2), ("cudaLaunchKernel", 75 * MS, 1, 3)]
    if with_program:
        host += [("ap.generate", 5 * MS, 90 * MS, 0), ("ap.step", 18 * MS, 45 * MS, 0),
                 ("ap.unet", 20 * MS, 40 * MS, 0), ("ap.unet.attn", 30 * MS, 10 * MS, 0),
                 ("ap.vocoder", 70 * MS, 20 * MS, 0), ("ap.to_host", 90 * MS, 5 * MS, 0)]
    device = [("gemm", 0, 10 * MS, 1), ("gemm", 40 * MS, 10 * MS, 2), ("conv", 80 * MS, 170 * MS, 3),
              ("ap.unet", 25 * MS, 50 * MS, 0)]       # a range's device copy: not an operation
    return [(n, True, s, d, c) for n, s, d, c in host] + [(n, False, s, d, c) for n, s, d, c in device]


def test_gaps_take_the_innermost_program_range():
    got = ps.read_events(events(True))
    gaps = dict(got["idle_gaps"])
    # gaps: 10-40 (mid 25: ap.unet), 50-80 (mid 65: ap.generate)
    assert gaps == {"host in ap.unet": 0.030, "host in ap.generate": 0.030}
    assert got["window_s"] == 0.25 and got["busy_s"] == pytest.approx(0.19)
    assert got["idle_in_calls_s"] == pytest.approx(0.060) and got["program_share"] == 1.0
    # launched at 0 (no range), 35 ms (ap.unet.attn), 75 ms (ap.vocoder; 5 ms of it inside ap.to_host)
    assert got["device_s_by_launch"] == pytest.approx({"ap.vocoder": 0.17, "none": 0.01, "ap.unet.attn": 0.01})
    assert got["device_s_in_to_host_by_launch"] == pytest.approx({"ap.vocoder": 0.005})
    assert got["host_s"]["ap.unet"] == pytest.approx(0.04)
    mid_attn = ps.label_gaps([(31 * MS, 33 * MS), (72 * MS, 74 * MS), (96 * MS, 98 * MS)],
                             {"request": [(0, 100 * MS)], "ap.generate": [(5 * MS, 95 * MS)],
                              "ap.unet": [(20 * MS, 60 * MS)], "ap.unet.attn": [(30 * MS, 40 * MS)],
                              "ap.vocoder": [(70 * MS, 90 * MS)]})
    assert mid_attn == ({"host in ap.unet.attn": 2 * MS, "host in ap.vocoder": 2 * MS,
                         "host in request, outside unet_fwd": 2 * MS}, 6 * MS, 4 * MS)


def test_without_program_ranges_the_harness_labels_stay():
    got = ps.read_events(events(False))
    assert dict(got["idle_gaps"]) == {"host in unet_fwd": 0.030, "host in request, outside unet_fwd": 0.030}
    assert got["program_share"] == 0.0 and got["program_ranges"] == 0
    assert got["device_s_by_launch"] == pytest.approx({"none": 0.19})
    gaps = ps.label_gaps([(1, 2), (25 * MS, 26 * MS), (120 * MS, 121 * MS)],
                         {"request": [(0, 100 * MS)], "unet_fwd": [(20 * MS, 60 * MS)]})
    assert gaps[0] == {"host in request, outside unet_fwd": 1, "host in unet_fwd": MS, "host between requests": MS}
    assert ps.read_events([("request", True, 0, 10, 0)]) is None


def ctx(program_spans):
    calls = [{"start": 0.0, "end": 10.0}, {"start": 10.0, "end": 20.0}]
    return types.SimpleNamespace(untraced_calls=calls, program_spans=program_spans)


def call_spans(t0: float, ids: int, scale: float) -> list:
    """One call's spans (seconds from ``t0``): fbank, text, audiomae, hoist,
    two steps each with a forward holding a resnet and an attention group,
    the decode, the vocoder, the copy to the host."""

    g = ids
    out = [("ap.fbank", g + 1, None, None, t0 + 0.0, t0 + 0.1 * scale),
           ("ap.generate", g, None, g, t0 + 0.2, t0 + 9.0),
           ("ap.text", g + 2, g, g, t0 + 0.3, t0 + 0.3 + 0.4 * scale),
           ("ap.audiomae", g + 3, g, g, t0 + 1.0, t0 + 1.0 + 0.2 * scale),
           ("ap.hoist", g + 4, g, g, t0 + 1.5, t0 + 1.6)]
    for k in range(2):
        s, step, unet = t0 + 2 + 3 * k, g + 10 + 10 * k, g + 11 + 10 * k
        out += [("ap.step", step, g, g, s, s + 2.0), ("ap.unet", unet, step, g, s + 0.5, s + 1.5),
                ("ap.unet.resnet", unet + 1, unet, g, s + 0.5, s + 0.5 + 0.2 * scale),
                ("ap.unet.attn", unet + 2, unet, g, s + 0.8, s + 0.8 + 0.6 * scale)]
    out += [("ap.vae_decode", g + 40, g, g, t0 + 8.0, t0 + 8.3), ("ap.vocoder", g + 41, g, g, t0 + 8.3, t0 + 8.5),
            ("ap.to_host", g + 42, g, g, t0 + 8.5, t0 + 8.5 + 0.5 * scale)]
    return out


@pytest.mark.parametrize("name, want", [
    ("text_ms", 1e3 * 0.4 * 1.5), ("audio_ms", 1e3 * 0.3 * 1.5), ("decode_ms", 1e3 * (0.5 + 0.5 * 1.5)),
    ("hoist_ms", 100.0), ("step_glue_ms", 1e3), ("unet_ms", 1e3), ("unet_resnet_ms", 1e3 * 0.2 * 1.5),
    ("unet_attn_ms", 1e3 * 0.6 * 1.5)])
def test_readers(name, want):
    """Two calls, the second's fbank, text, AudioMAE, copy, resnet and group
    twice the first's: each reader's mean over calls or spans; None
    without spans, and spans outside every call count for none."""

    spans = call_spans(0.0, 100, 1.0) + call_spans(10.0, 200, 2.0)
    reader = getattr(ps, name)
    assert reader(ctx(spans)) == pytest.approx(want)
    assert reader(ctx(spans + [(s[0], 999, None, None, 30.0, 31.0) for s in spans])) == pytest.approx(want)
    assert reader(ctx([])) is None


def test_spans_from_the_tracers_records():
    recs = [("ap.unet", 7, 3, 1, 1_500_000_000, 2_000_000_000, None)]
    assert ps.spans(recs) == [("ap.unet", 7, 3, 1, 1.5, 2.0)]


def test_split_of_a_tiny_cell():
    """``span_split.run`` on the tiny edit cell on the CPU: the tracer on
    and off give the same clips, and every reader reads."""

    from h100_bench import span_split
    from h100_bench.tests.tiny import tiny_spec

    out = span_split.run(tiny_spec("a2l-edit-b1"), 2 ** 31 + 3, 1, "cpu")
    assert out["tracer"] and out["pairs"][0]["equal"] and out["dropped"] == 0
    assert all(v is not None for v in out["readers"].values())
    assert out["profiled"]["program"] is None            # no device operation on the CPU
    assert 0.5 < out["accounting"]["phases_share"] <= 1.0
