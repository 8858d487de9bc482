"""How pytest-xdist hands out the test files under ``-n N --dist loadfile``.

xdist's ``loadfile`` scheduler sends each test file whole to one worker and
hands the files out in descending order of their test count. A file of few
but slow tests so starts late and runs alone at the end of the run, and one
slow file sets the wall time. This scheduler changes two things and nothing
else:

- ``GROUPS`` cuts a file into named groups of its tests. Each group is sent
  whole to one worker, so a module fixture is set up once per group.
- ``COST_S`` lists the slowest scopes (a file, or ``file::group``) with their
  seconds of one worker (the mean of three runs of the Tier-1 command, each
  read from its JUnit file with ``scripts/tier1_file_times.py``). They are handed out first, slowest first;
  every other file follows in xdist's own order.

Every test still runs once, on one worker. Other ``--dist`` modes are left
to xdist. This file imports nothing heavy: ``tests/conftest.py`` has to set
up JAX before anything imports it.
"""

import pytest

GROUPS = {
    "tests/test_train.py": {
        "test_split_merge_roundtrip": "step",
        "test_train_step_updates_adapter": "step",
        "test_8bit_adam_parity_flag": "step",
        "test_gradient_accumulation": "step",
        "test_sharded_train_step_8_devices": "sharded",
        "test_split_train_step_matches_monolithic": "sharded",
        "test_accum_train_step_scan": "sharded",
        "test_remat_grads_match": "remat",
        "test_remat_scan_two_blocks_grads": "remat",
        "test_overfit_fixed_batch": "overfit",
        "test_overfit_remat_matches": "overfit",
    },
}

COST_S = {
    "tests/test_distributed.py": 398.6,
    "tests/test_train_loop.py": 353.5,
    "tests/test_eval_and_data.py": 334.1,
    "tests/test_graft_entry.py": 329.3,
    "tests/test_train.py::step": 323.4,
    "tests/test_train.py::sharded": 300.5,
    "tests/test_unet.py": 289.8,
    "tests/test_train.py::remat": 266.8,
    "tests/test_pipeline.py": 227.2,
    "tests/test_train.py::overfit": 203.6,
    "tests/test_tp.py": 164.0,
    "tests/test_golden_pipeline.py": 152.8,
    "tests/test_torch_trace.py": 87.8,
    "tests/test_mae_pretrain.py": 61.9,
}


def scope_of(nodeid: str) -> str:
    """The unit of work a test belongs to: its file, or ``file::group``."""

    path, _, test = nodeid.partition("::")
    group = GROUPS.get(path, {}).get(test.split("[", 1)[0])
    return f"{path}::{group}" if group else path


def costliest_first(workqueue) -> None:
    """Move the scopes of ``COST_S`` to the front of an ``OrderedDict``,
    slowest first; the others keep their order behind them."""

    for scope in sorted((s for s in workqueue if s in COST_S), key=COST_S.get):
        workqueue.move_to_end(scope, last=False)


# tryfirst: xdist's own implementation is registered later, so it would
# be asked first and answer for every mode
@pytest.hookimpl(optionalhook=True, tryfirst=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class CostFirstScheduling(LoadFileScheduling):
        ordered = False

        def _split_scope(self, nodeid):
            return scope_of(nodeid)

        def _assign_work_unit(self, node):
            # the first call sees the whole queue that schedule() built
            if not self.ordered:
                costliest_first(self.workqueue)
                self.ordered = True
            super()._assign_work_unit(node)

    return CostFirstScheduling(config, log)
