"""MusicGen in the port (``models/musicgen.py``, ``models/encodec.py``,
``pipeline/musicgen.py``) against its float32 reference
(``h100_bench/reference/musicgen.py``) at the tiny config, on the same weights:
the cached decode against one full causal forward, the CFG null rows, the
T5 ReLU path, EnCodec, the draw against the reference's CFG scores, and one
CUDA test of the captured decode step."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ap_adapter_torch.configs import tiny_musicgen_config
from ap_adapter_torch.models.hoist import precompute_decoder_cross_kv
from ap_adapter_torch.models.musicgen import DecodeState, delay_pattern_mask, revert_delay_pattern
from ap_adapter_torch.ops import cuda_kernels
from ap_adapter_torch.pipeline.musicgen import MusicGenPipeline
from h100_bench.reference import musicgen as ref

CFG = tiny_musicgen_config()


def ref_config(c=CFG) -> dict:
    import dataclasses

    return {"t5": dataclasses.asdict(c.t5), "decoder": dataclasses.asdict(c.decoder),
            "encodec": dataclasses.asdict(c.encodec)}


@pytest.fixture(scope="module")
def pair():
    """The port's pipeline on random weights and the reference loaded with
    the same state dicts by key."""

    torch.manual_seed(0)
    pipe = MusicGenPipeline.init_random(CFG, seed=3, device="cpu")
    models = ref.build(ref_config(), "cpu")
    for name, m in models.items():
        sd = getattr(pipe.modules, name).state_dict()
        m.load_state_dict({k: v.float() for k, v in sd.items()}, strict=True)
    return pipe, models


def text(b=2, s=7, seed=0):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(3, CFG.t5.vocab_size, (b, s), generator=g)
    mask = torch.ones(b, s, dtype=torch.long)
    mask[0, 5:] = 0
    return ids, mask


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_t5_relu_path_matches_the_reference(pair):
    pipe, models = pair
    ids, mask = text()
    with torch.no_grad():
        got = pipe.modules.t5(ids, mask)
        want = models["t5"](ids, mask)
    assert rel(got * mask[..., None], want * mask[..., None]) < 1e-5


def _hoisted(pipe, models, length):
    ids, mask = text()
    states, mask2 = ref.conditioning(models, ids, mask)
    state = DecodeState(CFG.decoder, states.shape[0], length, states.shape[1], "cpu", torch.float32)
    precompute_decoder_cross_kv(pipe.modules.decoder, states, mask2, state)
    return states, mask2, state


@pytest.mark.parametrize("prefill", [1, 4])
def test_cached_decode_matches_the_full_causal_forward(pair, prefill):
    """A prefill of ``prefill`` positions, then one cached step a position,
    against the reference's one forward over the whole sequence: logits
    within 1e-5 relative at every position."""

    pipe, models = pair
    n = 10
    states, mask2, state = _hoisted(pipe, models, length=12)
    ids = torch.randint(0, CFG.decoder.vocab_size + 1, (states.shape[0], CFG.decoder.num_codebooks, n),
                        generator=torch.Generator().manual_seed(prefill))
    with torch.no_grad():
        want = models["decoder"](ids, states, mask2)
        got = [pipe.modules.decoder(ids[:, :, :prefill], state)]
        got += [pipe.modules.decoder(ids[:, :, t: t + 1], state) for t in range(prefill, n)]
    got = torch.cat(got, dim=2)
    assert int(state.pos) == n
    for t in range(n):
        assert rel(got[:, :, t], want[:, :, t]) < 1e-5, t
    k, v = ref.cross_kv(models["decoder"], states, 1)
    assert rel(state.cross_k[1], k) < 1e-6 and rel(state.cross_v[1], v) < 1e-6


def test_null_rows_cross_attention_adds_exactly_zero(pair):
    """The CFG null rows' hoisted K/V are exactly zero, and the cross
    sublayer returns its input unchanged there, bit for bit."""

    from ap_adapter_torch.ops.fused_cross import fused_ln_cross_attention_kv

    pipe, models = pair
    _, _, state = _hoisted(pipe, models, length=4)
    b = state.rows // 2
    assert not state.cross_k[:, b:].any() and not state.cross_v[:, b:].any()
    layer = pipe.modules.decoder.model["decoder"].layers[0]
    ln, e = layer.encoder_attn_layer_norm, layer.encoder_attn
    x = torch.randn(state.rows, 1, CFG.decoder.hidden_size)
    with torch.no_grad():
        out = fused_ln_cross_attention_kv(x, state.cross_k[0], state.cross_v[0], ln.weight, ln.bias,
                                          e.q_proj.weight, e.out_proj.weight, state.zero_bias,
                                          CFG.decoder.num_attention_heads, bias=state.cross_bias)
    assert torch.equal(out[b:], x[b:]) and not torch.equal(out[:b], x[:b])


def test_delay_pattern_round_trip():
    """The port's pads and revert against the reference's build."""

    codes = torch.randint(0, 16, (2, 4, 5))
    seq = ref.delay_pattern(codes, 16)
    assert torch.equal(revert_delay_pattern(seq), codes)
    assert torch.equal(seq == 16, delay_pattern_mask(4, 9)[None].expand(2, -1, -1))


def test_generate_serves_the_reference_encodec_of_its_codes(pair):
    """A whole CPU call: the waveform is EnCodec's of the codes the loop
    made (the reference decoder on the same codes), one eager decoder
    forward a position, and the same seed serves the same clip."""

    pipe, models = pair
    ids, mask = text()
    codes = []
    hook = pipe.modules.encodec.register_forward_pre_hook(lambda m, a: codes.append(a[0]))
    before = dict(cuda_kernels.DECODE_FORWARDS)
    try:
        wav = pipe.generate(ids.numpy(), mask.numpy(), seconds=0.12, seed=5)
        again = pipe.generate(ids.numpy(), mask.numpy(), seconds=0.12, seed=5)
    finally:
        hook.remove()
    frames = 6
    assert cuda_kernels.DECODE_FORWARDS["eager"] - before["eager"] == 2 * (frames + 3)
    assert wav.shape == (2, frames * 4) and np.array_equal(wav, again)
    assert codes[0].shape == (2, 4, frames) and int(codes[0].max()) < CFG.encodec.codebook_size
    with torch.no_grad():
        want = models["encodec"](codes[0])
    assert rel(torch.as_tensor(wav), want) < 1e-5


def test_generate_draws_the_argmax_of_the_reference_cfg_scores_at_top_k_1(pair):
    """With top-k 1 the draw is the argmax: every code ``generate`` served is
    the argmax of the reference's uncond + g (cond - uncond) at its step,
    over one full causal forward on the sequence the codes make in the
    delay pattern, and that sequence differs from the argmax of the cond
    logits alone and of the swapped combine (the guidance matters here)."""

    pipe, models = pair
    ids, mask = text()
    codes = []
    hook = pipe.modules.encodec.register_forward_pre_hook(lambda m, a: codes.append(a[0]))
    try:
        pipe.generate(ids.numpy(), mask.numpy(), seconds=0.2, guidance_scale=3.0, top_k=1, seed=7)
    finally:
        hook.remove()
    pad = CFG.decoder.pad_token_id
    seq = ref.delay_pattern(codes[0], pad)
    live = seq[:, :, 1:] != pad
    states, mask2 = ref.conditioning(models, ids, mask)
    with torch.no_grad():
        logits = models["decoder"](torch.cat([seq[:, :, :-1]] * 2), states, mask2)
    drawn = {g: ref.cfg_scores(logits, g).argmax(-1) for g in (3.0, 1.0, -2.0)}
    assert torch.equal(drawn[3.0][live], seq[:, :, 1:][live])
    assert not torch.equal(drawn[1.0][live], seq[:, :, 1:][live])
    assert not torch.equal(drawn[-2.0][live], seq[:, :, 1:][live])


@pytest.mark.gpu
def test_replayed_decode_step_is_bitwise_eager_and_copies_no_cache():
    """On the card, bf16: a replayed step's logits and cache writes equal
    the eager forward's bit for bit, and the graph's only copied input is
    the step's tokens (the cache, cross K/V and position are held)."""

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ap_adapter_torch.models.graphs import _Graph

    pipe = MusicGenPipeline.init_random(tiny_musicgen_config(torch.bfloat16), seed=1, device="cuda")
    dec = pipe.modules.decoder
    ids, mask = text()
    rows = 2 * ids.shape[0]
    states = torch.randn(rows, ids.shape[1], CFG.decoder.hidden_size, device="cuda", dtype=torch.bfloat16)
    toks = torch.randint(0, CFG.decoder.vocab_size, (rows, 4, 8, 1), device="cuda")
    runs = []
    for graphed in (False, True):
        state = DecodeState(CFG.decoder, rows, 8, ids.shape[1], "cuda", torch.bfloat16)
        precompute_decoder_cross_kv(dec, states, torch.cat([mask, 0 * mask]).cuda(), state)
        dec.drop_graphs()
        with torch.no_grad():
            out = [dec(toks[:, :, t], state) if graphed else dec._forward(toks[:, :, t], state) for t in range(8)]
        runs.append((torch.stack(out), state.k.clone(), state.v.clone()))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    graphs = [e for e in dec._graphs.values() if isinstance(e, _Graph)]
    assert len(graphs) == 1 and [t.shape for t in graphs[0].inputs] == [torch.Size([rows, 4, 1])]


def test_decode_signature_holds_the_state_and_ignores_the_step():
    """The decoder's graph key: the tokens' shape and the state's tensors by
    address and shape; the state's tensors are never leaves (never copied
    in), the position's value is no part of the key, and another state of
    the same sizes is another key."""

    from ap_adapter_torch.models.graphs import graph_signature

    cpu = torch.device("cpu")
    state = DecodeState(CFG.decoder, 4, 8, 7, "cpu", torch.float32)
    tokens = torch.zeros(4, CFG.decoder.num_codebooks, 1, dtype=torch.long)
    leaves = []
    key = graph_signature((tokens, state), 0.0, cpu, leaves)
    assert key is not None and len(leaves) == 1 and leaves[0] is tokens
    state.pos.add_(5)
    assert graph_signature((tokens + 1, state), 0.0, cpu, []) == key
    other = DecodeState(CFG.decoder, 4, 8, 7, "cpu", torch.float32)
    assert graph_signature((tokens, other), 0.0, cpu, []) != key
