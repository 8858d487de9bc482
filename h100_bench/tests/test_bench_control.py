"""The control of the output check: the reference in the program's place
with every product's operands in fp8 (one precision below the
configurations' bf16) comes out not correct. At the tiny sizes on the CPU
here; at each cell's own sizes on the card (three seeds) with
``-m gpu``:

    python -m pytest -p no:cacheprovider -m gpu h100_bench/tests/test_bench_control.py
"""

import json

import pytest
import torch

from h100_bench import harness
from h100_bench.harness import BENCH, ROOT
from h100_bench.tests.tiny import tiny_spec

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def control(spec, seed, device):
    driver = harness.load_file(BENCH / "drivers" / f"{spec['mix']['driver']}.py", "control_driver")
    return driver.control(spec["config"], spec["mix"], seed, device)


def fails(row, limits):
    return any(row[k] > lim for k, lim in limits.items() if k in row)


@pytest.mark.parametrize("cell", ["a2l-edit-b1", "s-t2a-b1"])
def test_control_fails_at_tiny_sizes(cell):
    spec = tiny_spec(cell)
    assert fails(control(spec, 2 ** 31 + 21, "cpu"), spec["limits"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_sizes(card, cell):
    spec = harness.resolve(cell)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        row = control(spec, seed, card)
        assert fails(row, spec["limits"]), row
