#!/usr/bin/env python3
"""How a benchmark cell's UNet forwards ran: captured, replayed or eager.

    python3 scripts/unet_graph_counts.py --workload a2l-edit-b1 --seed 7 --seconds 51 [--trace 0|1] [--out f.json]

Runs the cell once as ``h100_bench/run.py`` does (``harness.run_cell``:
set-up, the window, the output check) and prints one JSON line with
``ops/cuda_kernels.py::UNET_FORWARDS`` after the warm-up calls and over the
window, the window's calls, the warm-up forwards' seconds by kind (each
forward timed between two device synchronisations), the window's peak
allocated and reserved device bytes (the peak is reset after the warm-up
and read before the program is freed) and the output check's readings.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for key, value in (("USE_FLAX", "0"), ("USE_TF", "0"), ("OMP_NUM_THREADS", "4")):
    os.environ[key] = value
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from ap_adapter_torch.ops.cuda_kernels import UNET_FORWARDS  # noqa: E402
from h100_bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None, help="also write the line to this file")
    args = ap.parse_args(argv)
    spec = harness.resolve(args.workload)
    got = {"workload": args.workload, "seed": args.seed, "card": harness.card_line()}
    warm_s = {"captured": [], "replayed": [], "eager": []}

    def counted(cls):
        class Counted(cls):
            def warmup_calls(self):
                unet = self.unet()
                opened = []

                def pre(module, a):
                    torch.cuda.synchronize()
                    opened.append((time.perf_counter(), dict(UNET_FORWARDS)))

                def post(module, a, out):
                    torch.cuda.synchronize()
                    start, before = opened.pop()
                    kind = next(k for k in UNET_FORWARDS if UNET_FORWARDS[k] != before[k])
                    warm_s[kind].append(time.perf_counter() - start)

                hooks = [unet.register_forward_pre_hook(pre), unet.register_forward_hook(post)]
                yield from super().warmup_calls()
                for h in hooks:
                    h.remove()
                got["after_warmup"] = dict(UNET_FORWARDS)

            def release(self):
                dev = torch.device("cuda", 0)
                got["window"] = {k: UNET_FORWARDS[k] - got["after_warmup"][k] for k in UNET_FORWARDS}
                got["peak_allocated"] = torch.cuda.max_memory_allocated(dev)
                got["peak_reserved"] = torch.cuda.max_memory_reserved(dev)
                super().release()

        return Counted

    plain = harness.driver_class
    harness.driver_class = lambda mix: counted(plain(mix))
    run = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    got.update(warmup_forward_s=warm_s, setup_s=run["setup_s"], calls=len(run["calls"]), failed=run["failed"],
               steps=spec["mix"].get("steps"), checks=run["checks"])
    line = json.dumps(got)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
