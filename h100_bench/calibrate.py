#!/usr/bin/env python3
"""Readings that set a cell's output limit, on the card, in one process:

    python3 h100_bench/calibrate.py --workload <cell> --seeds 1,2,3 [--control | --fault NAME] [--out FILE]

For each seed: the cell's weights from the seed, the first ``check_calls``
calls of its traffic at the cell's own sizes (what a run compares), the
program freed, and the compared numbers against the float32 reference,
printed as one JSON line a seed (and appended to ``--out``). By default
the program runs as the configuration states (the lower reading);
``--control`` runs the control instead of the program: the reference in
the program's place with the operands of every product and of every
guidance and DDIM update in fp8, one precision below the configuration's
bf16 (the upper reading); ``--fault`` plants one of ``faults.py``'s faults
under the timed path. The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.update(USE_FLAX="0", USE_TF="0")
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from h100_bench.faults import FAULTS  # noqa: E402
from h100_bench.harness import BENCH, card_line, driver_class, load_file, resolve  # noqa: E402


def readings(workload: str, seeds, control: bool = False, device="cuda", fault: str = ""):
    spec = resolve(workload)
    undo = FAULTS[fault]() if fault else None
    try:
        yield from _readings(spec, workload, seeds, control, device, fault)
    finally:
        if undo:
            undo()


def _readings(spec, workload, seeds, control, device, fault):
    for seed in seeds:
        t0 = time.perf_counter()
        if control:
            driver = load_file(BENCH / "drivers" / f"{spec['mix']['driver']}.py", "control_driver")
            yield {"workload": workload, "run": "control", "fault": fault, "seed": seed,
                   **driver.control(spec["config"], spec["mix"], seed, device), "reference_s": time.perf_counter() - t0}
            continue
        drv = driver_class(spec["mix"])(spec["config"], spec["mix"], seed, device)
        outputs = {i: drv.call(i) for i in range(spec["mix"]["check_calls"])}
        t_calls = time.perf_counter() - t0
        drv.release()
        t1 = time.perf_counter()
        checks = drv.check(outputs)
        yield {"workload": workload, "run": "program", "fault": fault, "seed": seed, **checks,
               "calls_s": t_calls, "reference_s": time.perf_counter() - t1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", action="store_true", help="read the control instead of the program")
    ap.add_argument("--fault", default="", choices=[""] + sorted(FAULTS))
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr)
    for row in readings(args.workload, [int(s) for s in args.seeds.split(",")], args.control, fault=args.fault):
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
