"""The MusicGen reference (``h100_bench/reference/musicgen.py``) against
transformers' own ``MusicgenForCausalLM``, ``EncodecModel.decode`` and
``T5EncoderModel`` at tiny sizes on the same random weights, loaded by key
without renaming; the port loads the same state dicts by key; the delay
pattern against ``build_delay_pattern_mask``. This pins the reference to
the published code, and the port's keys to a future converter."""

from __future__ import annotations

import dataclasses
import os

import pytest
import torch

from ap_adapter_torch.configs import tiny_musicgen_config
from ap_adapter_torch.models.musicgen import delay_pattern_mask
from ap_adapter_torch.pipeline.musicgen import MusicGenPipeline
from h100_bench.reference import musicgen as ref

CFG = tiny_musicgen_config()


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture(scope="module")
def hf():
    """transformers' models at the tiny config, random weights (eager attention)."""

    for framework in ("USE_TF", "USE_FLAX"):       # transformers would import tensorflow and flax first
        os.environ.setdefault(framework, "0")
    pytest.importorskip("transformers")
    from transformers import EncodecConfig, EncodecModel, MusicgenDecoderConfig, MusicgenForCausalLM, T5Config, \
        T5EncoderModel

    torch.manual_seed(0)
    d, t, e = CFG.decoder, CFG.t5, CFG.encodec
    dec = MusicgenForCausalLM(MusicgenDecoderConfig(
        vocab_size=d.vocab_size, hidden_size=d.hidden_size, num_hidden_layers=d.num_hidden_layers,
        num_attention_heads=d.num_attention_heads, ffn_dim=d.ffn_dim, num_codebooks=d.num_codebooks,
        max_position_embeddings=d.max_position_embeddings, pad_token_id=d.pad_token_id, bos_token_id=d.pad_token_id,
        activation_function="gelu", scale_embedding=False, dropout=0.0, attn_implementation="eager")).eval()
    t5 = T5EncoderModel(T5Config(vocab_size=t.vocab_size, d_model=t.d_model, d_kv=t.d_kv, d_ff=t.d_ff,
                                 num_layers=t.num_layers, num_heads=t.num_heads, feed_forward_proj="relu",
                                 dropout_rate=0.0, attn_implementation="eager")).eval()
    codec = EncodecModel(EncodecConfig(
        audio_channels=1, num_filters=e.num_filters, hidden_size=e.hidden_size, codebook_size=e.codebook_size,
        upsampling_ratios=list(e.upsampling_ratios), sampling_rate=e.sampling_rate, target_bandwidths=[0.8],
        num_lstm_layers=e.num_lstm_layers, use_causal_conv=False, use_conv_shortcut=False, pad_mode="reflect",
        norm_type="weight_norm", normalize=False, chunk_length_s=None, overlap=None)).eval()
    assert codec.config.num_quantizers == e.num_quantizers and codec.config.frame_rate == e.frame_rate
    with torch.no_grad():       # codebooks and biases are zeros at init
        for name, p in list(codec.named_parameters()) + list(codec.named_buffers()):
            if name.endswith("embed") or name.endswith("bias"):
                p.normal_(0.0, 0.5)
    return {"decoder": dec, "t5": t5, "encodec": codec}


def _reference(hf, name):
    c = {"t5": dataclasses.asdict(CFG.t5), "decoder": dataclasses.asdict(CFG.decoder),
         "encodec": dataclasses.asdict(CFG.encodec)}
    model = ref.build(c, "cpu")[name]
    sd = hf[name].state_dict()
    model.load_state_dict({k: sd[k] for k in model.state_dict()}, strict=True)
    return model


def test_the_reference_decoder_is_transformers_musicgen(hf):
    """Logits of every position, the CFG null rows (zero states, zero mask)
    included, within 1e-5 relative."""

    model = _reference(hf, "decoder")
    assert set(model.state_dict()) == set(hf["decoder"].state_dict())
    g = torch.Generator().manual_seed(1)
    b, n, s = 2, 9, 5
    ids = torch.randint(0, CFG.decoder.vocab_size + 1, (2 * b, CFG.decoder.num_codebooks, n), generator=g)
    states = torch.randn(b, s, CFG.decoder.hidden_size, generator=g)
    mask = torch.ones(b, s, dtype=torch.long)
    mask[1, 3:] = 0
    states, mask = torch.cat([states * mask[..., None], 0 * states]), torch.cat([mask, 0 * mask])
    with torch.no_grad():
        want = hf["decoder"](input_ids=ids.reshape(-1, n), encoder_hidden_states=states,
                             encoder_attention_mask=mask).logits.reshape(2 * b, CFG.decoder.num_codebooks, n, -1)
        got = model(ids, states, mask)
    assert rel(got, want) < 1e-5


def test_the_reference_t5_is_transformers_t5_relu(hf):
    model = _reference(hf, "t5")
    assert set(model.state_dict()) == set(hf["t5"].state_dict()) - {"encoder.embed_tokens.weight"}
    ids = torch.randint(0, CFG.t5.vocab_size, (2, 7), generator=torch.Generator().manual_seed(2))
    mask = torch.ones(2, 7, dtype=torch.long)
    mask[0, 4:] = 0
    with torch.no_grad():
        want = hf["t5"](input_ids=ids, attention_mask=mask).last_hidden_state
        got = model(ids, mask)
    assert rel(got * mask[..., None], want * mask[..., None]) < 1e-5


def test_the_reference_encodec_is_transformers_decode(hf):
    model = _reference(hf, "encodec")
    assert set(model.state_dict()) <= set(hf["encodec"].state_dict())
    codes = torch.randint(0, CFG.encodec.codebook_size, (2, CFG.encodec.num_quantizers, 6),
                          generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = hf["encodec"].decode(codes[None], [None]).audio_values[:, 0]
        got = model(codes)
    assert got.shape == (2, 6 * 4) and rel(got, want) < 1e-5


def test_the_port_loads_transformers_state_dicts_by_key(hf):
    """The port's submodels take transformers' keys one to one (T5's tied
    ``encoder.embed_tokens`` copy and EnCodec's encoder and quantizer
    statistics dropped), and its decoder serves transformers' logits."""

    from ap_adapter_torch.models.musicgen import DecodeState

    proj = torch.nn.Linear(CFG.t5.d_model, CFG.decoder.hidden_size)
    port_keys = {n: set(getattr(MusicGenPipeline.init_random(CFG, device="cpu").modules, n).state_dict())
                 for n in ("t5", "decoder", "encodec")}
    sds = {n: {k: v for k, v in hf[n].state_dict().items() if k in port_keys[n]} for n in port_keys}
    sds["enc_to_dec_proj"] = proj.state_dict()
    assert set(sds["decoder"]) == set(hf["decoder"].state_dict())
    pipe = MusicGenPipeline.load_state_dicts(CFG, sds, device="cpu")
    ids = torch.randint(0, CFG.decoder.vocab_size, (2, CFG.decoder.num_codebooks, 3),
                        generator=torch.Generator().manual_seed(4))
    states = torch.zeros(2, 1, CFG.decoder.hidden_size)
    state = DecodeState(CFG.decoder, 2, 4, 1, "cpu", torch.float32)
    with torch.no_grad():
        got = pipe.modules.decoder(ids, state)
        want = hf["decoder"](input_ids=ids.reshape(-1, 3), encoder_hidden_states=states,
                             encoder_attention_mask=torch.zeros(2, 1, dtype=torch.long)).logits
    assert rel(got.reshape(want.shape), want) < 1e-5


def test_delay_pattern_matches_transformers(hf):
    """``delay_pattern_mask`` marks the pads of transformers' pattern for a
    sequence of BOS and 12 positions."""

    length = 12
    bos = torch.full((CFG.decoder.num_codebooks, 1), CFG.decoder.pad_token_id)
    ids, pattern = hf["decoder"].build_delay_pattern_mask(bos, CFG.decoder.pad_token_id, max_length=length)
    assert torch.equal(pattern == CFG.decoder.pad_token_id, delay_pattern_mask(CFG.decoder.num_codebooks, length))
    assert torch.equal(ids, bos)
