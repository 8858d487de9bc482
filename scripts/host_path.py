#!/usr/bin/env python3
"""Host time a call of the K1 and K3 wrappers spends submitting its work,
at the edit path's shapes, on one NVIDIA GPU.

    python3 scripts/host_path.py [--root DIR] [--calls 200]

Imports ``ap_adapter_torch`` from ``--root`` (default: this checkout; an
unpacked ``git archive`` of another commit measures that commit in the same
call). For K1 (``fused_ln_self_attention``) and K3 (``fused_ln_geglu_ff``)
at B=2 and each (S, C) of ``chip_smoke.SHAPES``, bf16 inputs, it times
``--calls`` calls back to back on the host clock, with no synchronise inside
the loop (the device runs each call in less time than the host takes to
submit it, so the loop measures the host), five rounds, and prints the
median round's microseconds a call:

* ``wrapper``: the whole wrapper, as the UNet calls it;
* ``python``: the wrapper with ``cuda_kernels.launch`` replaced by a stub
  that records its arguments (checks, plan, allocations);
* ``entry``: the C entry point alone, called through ctypes with the
  arguments the wrapper passed (tensor maps and launches). The buffers those
  arguments point to were freed back to PyTorch's caching allocator when the
  wrapper returned; nothing else allocates during the loop, so the kernels
  write into blocks that no tensor owns.

Prints one line per case, then the card's ``nvidia-smi`` line. Fails
without a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time


def host_us(fn, calls: int, rounds: int = 5) -> float:
    """Median over ``rounds`` of the host microseconds a call of ``fn``, each
    round ``calls`` calls back to back, synchronised after the round."""

    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per_call)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--calls", type=int, default=200)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("host_path: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke
    from ap_adapter_torch.ops import cuda_kernels as ck
    from ap_adapter_torch.ops.fused_block import fused_ln_self_attention
    from ap_adapter_torch.ops.fused_ff import fused_ln_geglu_ff

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(0)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    card = chip_smoke.card_line()
    print(f"card: {card}; tree: {os.path.abspath(args.root)}", flush=True)
    ck.library()
    launch = ck.launch
    for s, c in chip_smoke.SHAPES:
        x, ln_w, ln_b = r(2, s, c), 1 + r(c, scale=0.1), r(c, scale=0.1)
        sa = (ln_w, ln_b, *(r(c, c, scale=c ** -0.5) for _ in range(4)), r(c, scale=0.1), chip_smoke.HEADS)
        ff = (ln_w, ln_b, r(8 * c, c, scale=c ** -0.5), r(8 * c, scale=0.1), r(c, 4 * c, scale=(4 * c) ** -0.5),
              r(c, scale=0.1))
        for fn, rest in ((fused_ln_self_attention, sa), (fused_ln_geglu_ff, ff)):
            wrapper = host_us(lambda: fn(x, *rest), args.calls)
            recorded = []
            ck.launch = lambda op, *a: recorded.append((op, a))
            try:
                python = host_us(lambda: fn(x, *rest), args.calls)
            finally:
                ck.launch = launch
            op, a = recorded[-1]
            entry_fn = getattr(ck.library(), f"apk_{op}")
            stream = torch.cuda.current_stream().cuda_stream
            if entry_fn(*a, stream) != 0:
                raise RuntimeError(f"{op}: the entry point refused the recorded arguments")
            entry = host_us(lambda: entry_fn(*a, stream), args.calls)
            print(f"host {op:26s} B=2 S={s} C={c}: wrapper {wrapper:.1f} us, python {python:.1f} us, "
                  f"entry {entry:.1f} us a call", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
