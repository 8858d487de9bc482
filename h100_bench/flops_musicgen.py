"""The yardstick of the MusicGen cell (``drivers/musicgen.py``): operations
and bytes of one text-to-music call from the configuration's shapes, never
from what the program launches, counted as ``flops.py`` counts (2
operations a multiply-add of every matrix product, convolution and
attention product; normalisations and activations not counted).

A decoder step at position t (t = 0 .. steps - 1) over R rows reads every
weight of the step once, the t + 1 cached keys and values of every layer
and the hoisted cross K/V; its least time is the larger of its operations
at the bf16 peak and those bytes at the HBM rate. ``decode_bound_s`` sums
that over the call's steps.
"""

from __future__ import annotations

import math

from h100_bench.flops import BF16, PEAK_BYTES, PEAK_FLOPS, Work, attention, conv1d, linear


def shapes(config: dict, mix: dict) -> dict:
    """rows (CFG doubles the batch), text keys, frames and decoder steps of a call."""

    e = config["encodec"]
    frames = int(round(mix["audio_seconds"] * (e["sampling_rate"] // math.prod(e["upsampling_ratios"]))))
    k = config["decoder"]["num_codebooks"]
    return {"rows": 2 * mix["batch"], "text": mix["t5_length"], "frames": frames, "steps": frames + k - 1}


def decoder_step(d: dict, rows: int, prefix: int, text: int) -> tuple:
    """(operations, bytes) of one decoder forward of one position over
    ``prefix`` cached positions (its own included) and ``text`` keys."""

    c, ffn, layers = d["hidden_size"], d["ffn_dim"], d["num_hidden_layers"]
    layer = (linear(rows, c, 3 * c, bias=False) + attention(rows, 1, prefix, c) + linear(rows, c, c, bias=False)
             + linear(rows, c, c, bias=False) + attention(rows, 1, text, c) + linear(rows, c, c, bias=False)
             + linear(rows, c, ffn, bias=False) + linear(rows, ffn, c, bias=False))
    heads = linear(rows, c, d["num_codebooks"] * d["vocab_size"], bias=False)
    flops = layers * layer.flops + heads.flops
    weights = layers * layer.params + heads.params
    nbytes = BF16 * (weights + layers * 2 * rows * (prefix + text) * c       # cache prefix and cross K/V
                     + d["num_codebooks"] * rows * c)                         # the tokens' embedding rows
    return flops, nbytes


def decode_bound_s(config: dict, mix: dict) -> float:
    """The least time of a call's decoder steps on the card."""

    s, d = shapes(config, mix), config["decoder"]
    total = 0.0
    for t in range(s["steps"]):
        flops, nbytes = decoder_step(d, s["rows"], t + 1, s["text"])
        total += max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
    return total


def t5_relu(c: dict, b: int, s: int) -> Work:
    d, inner, ff = c["d_model"], c["num_heads"] * c["d_kv"], c["d_ff"]
    total = Work()
    for _ in range(c["num_layers"]):
        total += linear(b * s, d, 4 * inner, bias=False) + attention(b, s, s, inner) + linear(b * s, d, 2 * ff,
                                                                                                bias=False)
    return total


def encodec_decode(e: dict, b: int, frames: int) -> Work:
    """The SEANet decoder: each convolution counted on the length it reads
    (a transposed one on its input), the LSTM's gate products."""

    ch = e["num_filters"] * 2 ** len(e["upsampling_ratios"])
    total = conv1d(b, frames, e["hidden_size"], ch, e["kernel_size"])
    for _ in range(e["num_lstm_layers"]):
        total += linear(b * frames, 2 * ch, 4 * ch)
    n = frames
    for r in e["upsampling_ratios"]:
        total += conv1d(b, n, ch, ch // 2, 2 * r)
        n, ch = n * r, ch // 2
        for _ in range(e["num_residual_layers"]):
            hidden = ch // e["compress"]
            total += conv1d(b, n, ch, hidden, e["residual_kernel_size"]) + conv1d(b, n, hidden, ch, 1)
    return total + conv1d(b, n, e["num_filters"], e["audio_channels"], e["last_kernel_size"])


def call_work(config: dict, mix: dict) -> dict:
    """Model work of one ``generate`` call: ``total`` operations,
    ``decode_steps`` and ``decode_bound_s``."""

    s, d = shapes(config, mix), config["decoder"]
    c = d["hidden_size"]
    text = t5_relu(config["t5"], mix["batch"], s["text"]).flops
    text += linear(mix["batch"] * s["text"], config["t5"]["d_model"], c).flops
    hoist = d["num_hidden_layers"] * linear(s["rows"] * s["text"], c, 2 * c, bias=False).flops
    decode = sum(decoder_step(d, s["rows"], t + 1, s["text"])[0] for t in range(s["steps"]))
    audio = encodec_decode(config["encodec"], mix["batch"], s["frames"]).flops
    return {"total": text + hoist + decode + audio, "decode_steps": s["steps"],
            "decode_bound_s": decode_bound_s(config, mix)}
