#!/usr/bin/env python3
"""Host time a call of the K1, K2, K3 and K10 wrappers spends submitting its
work, at the edit path's shapes, on one NVIDIA GPU.

    python3 scripts/host_path.py [--root DIR] [--calls 200]

Imports ``ap_adapter_torch`` from ``--root`` (default: this checkout; an
unpacked ``git archive`` of another commit measures that commit in the same
call). For K1 (``fused_ln_self_attention``), K2
(``fused_ln_cross_attention_kv``, 8 text + 128 adapter keys, and 64 T5 keys
with their bias), K3 (``fused_ln_geglu_ff``) and K10
(``fused_dual_kv_attention``, 8 text + 128 audio keys) at B=2 and each
(S, C) of ``chip_smoke.SHAPES`` (8 heads), bf16 inputs, it times
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
    from ap_adapter_torch.ops.dual_kv_attention import fused_dual_kv_attention
    from ap_adapter_torch.ops.fused_block import fused_ln_self_attention
    from ap_adapter_torch.ops.fused_cross import fused_ln_cross_attention_kv
    from ap_adapter_torch.ops.fused_ff import fused_ln_geglu_ff

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(0)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    card = chip_smoke.card_line()
    print(f"card: {card}; tree: {os.path.abspath(args.root)}", flush=True)
    ck.library()
    launch = ck.launch
    heads = chip_smoke.HEADS
    for s, c in chip_smoke.SHAPES:
        x, ln_w, ln_b = r(2, s, c), 1 + r(c, scale=0.1), r(c, scale=0.1)
        wq, wk, wv, wo = (r(c, c, scale=c ** -0.5) for _ in range(4))
        bo = r(c, scale=0.1)
        ff = (ln_w, ln_b, r(8 * c, c, scale=c ** -0.5), r(8 * c, scale=0.1), r(c, 4 * c, scale=(4 * c) ** -0.5),
              r(c, scale=0.1))
        k, v, ki, vi, k5, v5 = r(2, 8, c), r(2, 8, c), r(2, 128, c), r(2, 128, c), r(2, 64, c), r(2, 64, c)
        t5_bias = torch.zeros(2, 64, device=device)
        t5_bias[:, 30:] = -10000.0
        hd = lambda t: t.reshape(2, -1, heads, c // heads)
        cases = [
            ("K1", lambda: fused_ln_self_attention(x, ln_w, ln_b, wq, wk, wv, wo, bo, heads)),
            ("K2 adapter", lambda: fused_ln_cross_attention_kv(x, k, v, ln_w, ln_b, wq, wo, bo, heads, ki=ki, vi=vi,
                                                               ip_scale=0.5)),
            ("K2 t5+bias", lambda: fused_ln_cross_attention_kv(x, k5, v5, ln_w, ln_b, wq, wo, bo, heads,
                                                               bias=t5_bias)),
            ("K3", lambda: fused_ln_geglu_ff(x, *ff)),
            ("K10", lambda: fused_dual_kv_attention(hd(x), hd(k), hd(v), hd(ki), hd(vi), 0.55)),
        ]
        for label, fn in cases:
            wrapper = host_us(fn, args.calls)
            recorded = []
            ck.launch = lambda op, *a: recorded.append((op, a))
            try:
                python = host_us(fn, args.calls)
            finally:
                ck.launch = launch
            op, a = recorded[-1]
            entry_fn = getattr(ck.library(), f"apk_{op}")
            stream = torch.cuda.current_stream().cuda_stream
            if entry_fn(*a, stream) != 0:
                raise RuntimeError(f"{op}: the entry point refused the recorded arguments")
            entry = host_us(lambda: entry_fn(*a, stream), args.calls)
            print(f"host {label:10s} {op:30s} B=2 S={s} C={c}: wrapper {wrapper:.1f} us, python {python:.1f} us, "
                  f"entry {entry:.1f} us a call", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
