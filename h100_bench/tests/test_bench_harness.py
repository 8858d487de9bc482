"""The harness's command line, its refusal without a card, the last
line's JSON form, and what a run loads: no module of JAX or of the JAX
package, and a reference that imports nothing of the program."""

import ast
import json
import subprocess
import sys
import time

import pytest
import torch

from h100_bench import harness
from h100_bench.harness import BENCH, ROOT


def test_arguments_are_required():
    with pytest.raises(SystemExit) as e:
        harness.main(["--workload", "a2l-edit-b1", "--seed", "1"])
    assert e.value.code == 2


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "a2l-edit-b1", "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_result_line(capsys, monkeypatch):
    """With the card and the run faked, the last line holds the contract's
    keys, the cell's metrics and the compared numbers last."""

    limits = json.loads((BENCH / "limits" / "a2l-edit-b1.json").read_text())
    fake = {"setup_s": 12.5, "failed": 0, "peak": 123, "forbidden": [], "trace": None, "unet_spans": [],
            "checks": {k: v / 2 for k, v in limits.items()}, "calls": [
                {"i": i, "start": 10.0 + 4 * i, "end": 14.0 + 4 * i, "ok": True, "clips": 1, "traced": False,
                 "work": {}} for i in range(3)]}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(harness, "card_line", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: fake)
    assert harness.main(["--workload", "a2l-edit-b1", "--seed", "7", "--seconds", "12", "--trace", "0"]) == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["attempted"] == 3 and line["failed"] == 0
    assert line["metrics"] == {"request_s": {"value": 4.0, "unit": "s"}, "setup_s": {"value": 12.5, "unit": "s"}}
    assert line["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1, "memory_peak_bytes": 123}
    assert line["checks"] == {k: {"value": v / 2, "limit": v} for k, v in limits.items()}
    last = out.err.strip().splitlines()[-len(limits):]
    assert last == [f"check {k} {v / 2} limit {v}" for k, v in limits.items()]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ap_adapter_tpu_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ap_adapter_tpu.ops", sys)
    assert harness.forbidden_modules() == ["ap_adapter_tpu.ops"]


def test_a_run_loads_no_jax():
    """A whole tiny run on the CPU in a fresh process: afterwards no module
    whose top-level name is jax, jaxlib, flax or ap_adapter_tpu is loaded."""

    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from h100_bench.tests.tiny import tiny_spec\n"
        "from h100_bench import harness\n"
        "run = harness.run_cell(tiny_spec('a2l-edit-b1'), 3, 0.1, False, 'cpu', time.perf_counter())\n"
        "print(run['forbidden'], sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'ap_adapter_tpu'}))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0", "HOME": str(ROOT / "build")})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] []"


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("ap_adapter_torch", "ap_adapter_tpu", "jax", "flax", "jaxlib"), \
                    (path.name, n)
    code = ("import sys; sys.path.insert(0, %r); import h100_bench.reference.pipelines; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'ap_adapter_torch', 'ap_adapter_tpu', 'jax'}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr[-2000:]


def test_trace_reader_on_a_cpu_profile():
    """Without device operations the trace reader returns nothing, and
    the readers of device metrics then report nothing."""

    from h100_bench import trace

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("request"):
            torch.randn(8, 8) @ torch.randn(8, 8)
    assert trace.read(prof) is None
    ctx = harness.context({"cell": {}, "mix": {}, "config": {}}, {
        "setup_s": 1.0, "calls": [], "unet_spans": [], "trace": None})
    for name in ("unet_roofline.request", "mfu.request", "device_idle.request", "unet_step_ms.request"):
        assert harness.read_metric(name, ctx) is None


def test_setup_counts_from_the_process_start():
    t0 = time.perf_counter() - 3.0
    ctx = harness.context({"cell": {}, "mix": {}, "config": {}}, {
        "setup_s": time.perf_counter() - t0, "calls": [], "unet_spans": [], "trace": None})
    assert harness.read_metric("setup_s", ctx) >= 3.0


def test_host_readers_read_the_untraced_calls():
    """The host's spans and the model operations a second come from the
    calls that ran without the profiler, never mixed with the slower
    profiled ones."""

    from h100_bench.flops import PEAK_FLOPS

    calls = [{"i": i, "start": 10.0 * i, "end": 10.0 * i + 10.0, "ok": True, "clips": 1, "traced": True,
              "work": {"total": 1e15}} for i in range(2)]
    calls += [{"i": 2 + i, "start": 20.0 + 4 * i, "end": 24.0 + 4 * i, "ok": True, "clips": 1, "traced": False,
               "work": {"total": 1e15}} for i in range(2)]
    spans = [(c["start"] + 1 + k * d, c["start"] + 1 + k * d + d) for c in calls
             for d in ([4.0] if c["traced"] else [1.0]) for k in range(2)]
    ctx = harness.context({"cell": {}, "mix": {}, "config": {}}, {
        "setup_s": 1.0, "calls": calls, "unet_spans": spans, "trace": None})
    assert harness.read_metric("unet_step_ms.request", ctx) == pytest.approx(1000.0)
    assert harness.read_metric("outside_loop_ms.request", ctx) == pytest.approx(2000.0)
    assert harness.read_metric("mfu.request", ctx) == pytest.approx(100.0 * 2e15 / (8.0 * PEAK_FLOPS))


def test_a_nan_error_counts_as_infinite():
    """The widest of several errors is taken with ``max``, which drops a NaN
    that is not first: so an error that is not a number reads infinite."""

    from h100_bench.drivers.common import rel, rel_err

    nan = torch.tensor([[float("nan"), 1.0]])
    assert rel(nan, torch.ones(1, 2)) == float("inf")
    assert rel_err(nan.numpy(), torch.ones(1, 2)) == [float("inf")]
    assert max([0.001, rel(nan, torch.ones(1, 2))]) == float("inf")
