"""The root ``conftest.py``'s pytest-xdist scheduler: which tests travel
together to one worker, and which go out first."""

import ast
import importlib.util
import os
from collections import OrderedDict

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root_conftest():
    spec = importlib.util.spec_from_file_location(
        "root_conftest", os.path.join(ROOT, "conftest.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


sched = _root_conftest()


def _tests_of(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    return [n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")]


@pytest.mark.parametrize("path", sorted(sched.GROUPS))
def test_groups_name_tests_of_their_file(path):
    # a renamed test would fall back to the file's own scope unnoticed
    assert set(sched.GROUPS[path]) <= set(_tests_of(path))


def test_every_trainer_test_is_in_a_group():
    assert set(_tests_of("tests/test_train.py")) == set(sched.GROUPS["tests/test_train.py"])


def test_costs_name_existing_scopes():
    for scope in sched.COST_S:
        path, _, group = scope.partition("::")
        assert os.path.exists(os.path.join(ROOT, path)), scope
        assert not group or group in sched.GROUPS[path].values(), scope


@pytest.mark.parametrize("nodeid, scope", [
    ("tests/test_train.py::test_remat_grads_match", "tests/test_train.py::remat"),
    ("tests/test_train.py::test_overfit_fixed_batch[a-1]", "tests/test_train.py::overfit"),
    ("tests/test_train_loop.py::test_default_validation_fn_writes_wavs",
     "tests/test_train_loop.py"),
    ("tests/test_dsp.py::test_normalize_wav", "tests/test_dsp.py"),
    ("tests/test_torch_ops.py::TestX::test_y[2]", "tests/test_torch_ops.py"),
    ("tests/test_golden_adapter.py", "tests/test_golden_adapter.py"),
])
def test_scope_of(nodeid, scope):
    assert sched.scope_of(nodeid) == scope


def test_costliest_first_keeps_the_rest_in_order():
    q = OrderedDict((s, {}) for s in [
        "tests/a.py", "tests/test_tp.py", "tests/b.py", "tests/test_distributed.py"])
    sched.costliest_first(q)
    assert list(q) == ["tests/test_distributed.py", "tests/test_tp.py", "tests/a.py", "tests/b.py"]


class _Config:
    def __init__(self, dist, workers):
        self.values = {"dist": dist, "tx": [f"{workers}*popen"]}
        self.option = type("Option", (), {"loadscopereorder": True})()

    def getvalue(self, name):
        return self.values[name]


class _Node:
    shutting_down = False

    def __init__(self, name):
        self.gateway = type("Gateway", (), {"id": name})()
        self.sent = []

    def send_runtest_some(self, indices):
        self.sent.extend(indices)

    def shutdown(self):
        self.shutting_down = True


def test_only_loadfile_gets_this_scheduler():
    pytest.importorskip("xdist")
    assert sched.pytest_xdist_make_scheduler(_Config("load", 2), None) is None


def test_scheduler_sends_groups_whole_and_costliest_first():
    pytest.importorskip("xdist")
    collection = [
        *(f"tests/test_dsp.py::test_{i}" for i in range(5)),
        *(f"tests/test_train.py::{t}" for t in sched.GROUPS["tests/test_train.py"]),
        "tests/test_distributed.py::test_two_process_train_step",
    ]
    s = sched.pytest_xdist_make_scheduler(_Config("loadfile", 2), None)
    nodes = [_Node("gw0"), _Node("gw1")]
    for n in nodes:
        s.add_node(n)
        s.add_node_collection(n, collection)
    s.schedule()
    got = [[collection[i] for i in n.sent] for n in nodes]
    # a node is sent another unit once 2 or fewer of its tests are pending
    assert [sched.scope_of(t) for t in got[0]] == (
        ["tests/test_distributed.py"] + ["tests/test_train.py::sharded"] * 3)
    assert [sched.scope_of(t) for t in got[1]] == ["tests/test_train.py::step"] * 4
    assert list(s.workqueue) == [
        "tests/test_train.py::remat", "tests/test_train.py::overfit", "tests/test_dsp.py"]
