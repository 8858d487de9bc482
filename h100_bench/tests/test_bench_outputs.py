"""The output check: a whole run at the tiny sizes on the CPU (no look for
a card; the program in float32 on its plain paths) comes out correct
against the reference, and with the timed path broken underneath
(``faults.py``) it comes out not correct, once for each fault a serving
cell can have: an answer altered where it is produced, a denoise step
that returns its state unchanged, and half of a batch left out (its other
half served twice)."""

import time

import pytest

from h100_bench import faults, harness
from h100_bench.tests.tiny import tiny_spec

SEED = 2 ** 31 + 11


def run(cell, seconds=0.3):
    spec = tiny_spec(cell)
    out = harness.run_cell(spec, SEED, seconds, False, "cpu", time.perf_counter())
    return harness.judge(out, spec["limits"]), out


@pytest.mark.parametrize("cell", ["a2l-edit-b1", "s-t2a-b1", "a2l-edit-b8"])
def test_sound_run_is_correct(cell):
    (ok, compared), out = run(cell)
    assert ok, compared
    assert out["checks"]["clips_checked"] >= 1
    assert max(v for _, v, _ in compared) < 1e-3            # float32 against float32: rounding alone


@pytest.mark.parametrize("cell, fault", [
    ("a2l-edit-b1", "answer_altered"), ("s-t2a-b1", "answer_altered"), ("a2l-edit-b8", "answer_altered"),
    ("a2l-edit-b1", "step_unchanged"), ("s-t2a-b1", "step_unchanged"), ("a2l-edit-b8", "step_unchanged"),
    ("a2l-edit-b8", "half_batch")])
def test_fault_is_caught(cell, fault):
    undo = faults.FAULTS[fault]()
    try:
        (ok, compared), _ = run(cell)
    finally:
        undo()
    assert not ok, compared
