#!/usr/bin/env python3
"""Device time of one MusicGen decoder step at a cell's sizes, by route.

    python3 scripts/musicgen_decode_step.py [--rows 16] [--text 64] [--length 1504] [--steps 200] [--out f.json]

Builds the decoder of ``configs.musicgen_large()`` on the card (N(0, 0.02)
bf16 weights), its ``DecodeState`` for ``rows`` rows, hoists random text
states, and times ``steps`` decoder forwards with CUDA events, in turns,
for each route of the cross sublayer: K2 (the shipped route) and its plain
PyTorch version (patched in for the comparison), each as captured-graph
replays and as eager forwards. Prints one JSON line: milliseconds a step (median of
the turns), the graph's count of copied inputs, the bytes the state holds
and the peak allocated bytes.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from ap_adapter_torch.configs import musicgen_large  # noqa: E402
from ap_adapter_torch.models.graphs import _Graph  # noqa: E402
from ap_adapter_torch.models import musicgen  # noqa: E402
from ap_adapter_torch.models.hoist import precompute_decoder_cross_kv  # noqa: E402
from ap_adapter_torch.models.musicgen import DecodeState, MusicgenForCausalLM  # noqa: E402
from ap_adapter_torch.ops import fused_cross  # noqa: E402
from ap_adapter_torch.pipeline.pipeline import fill_random_  # noqa: E402


def time_steps(dec, state, tokens, steps: int, graphed: bool) -> float:
    """Milliseconds a step over ``steps`` forwards (a warm forward first)."""

    run = dec if graphed else dec._forward
    state.pos.zero_()
    run(tokens, state)
    run(tokens, state)              # a graph's capture
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        run(tokens, state)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


@torch.no_grad()
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=16)
    ap.add_argument("--text", type=int, default=64)
    ap.add_argument("--length", type=int, default=1504)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    c = musicgen_large()
    dev = torch.device("cuda")
    with torch.device("meta"):
        dec = MusicgenForCausalLM(c.decoder)
    dec = fill_random_(dec.to_empty(device=dev).to(torch.bfloat16), 0)
    state = DecodeState(c.decoder, args.rows, args.length, args.text, dev, torch.bfloat16)
    states = torch.randn(args.rows, args.text, c.decoder.hidden_size, device=dev, dtype=torch.bfloat16)
    mask = torch.ones(args.rows, args.text, dtype=torch.long, device=dev)
    mask[args.rows // 2:] = 0
    mask[: args.rows // 2, 20:] = 0
    precompute_decoder_cross_kv(dec, states * mask[..., None], mask, state)
    tokens = torch.randint(0, c.decoder.vocab_size, (args.rows, c.decoder.num_codebooks, 1), device=dev)
    times = {}
    for _ in range(args.turns):
        for route, cross in (("k2", fused_cross.fused_ln_cross_attention_kv),
                             ("plain", fused_cross.fused_ln_cross_attention_kv_plain)):
            musicgen.fused_ln_cross_attention_kv = cross
            dec.drop_graphs()
            for graphed in (True, False):
                key = f"{route}_{'replay' if graphed else 'eager'}_ms"
                times.setdefault(key, []).append(time_steps(dec, state, tokens, args.steps, graphed))
    musicgen.fused_ln_cross_attention_kv = fused_cross.fused_ln_cross_attention_kv
    graphs = [e for e in dec._graphs.values() if isinstance(e, _Graph)]
    out = {"card": torch.cuda.get_device_name(0), "rows": args.rows, "length": args.length, "text": args.text,
           **{k: statistics.median(v) for k, v in times.items()}, "turns": times,
           "copied_inputs": [list(t.shape) for t in graphs[0].inputs] if graphs else None,
           "state_bytes": sum(t.numel() * t.element_size() for t in state.tensors()),
           "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
