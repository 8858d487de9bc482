"""PyTorch port: CLAP re-ranking, the CLAP log-mel, the HTSAT audio tower
(``models/clap_audio.py``), ``ClapScorer`` and ``generate_ranked``, held
against the JAX package on the same weights and inputs (fp32, CPU), and the
tower's state dict against ``torch_import``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ap_adapter_tpu.audio.mel import clap_log_mel as jax_clap_log_mel
from ap_adapter_tpu.configs import ClapAudioConfig as JaxClapAudioConfig
from ap_adapter_tpu.configs import ClapTextConfig as JaxClapTextConfig
from ap_adapter_tpu.convert import torch_import
from ap_adapter_tpu.eval.clap_scoring import ClapScorer as JaxClapScorer
from ap_adapter_tpu.models.clap import ClapTextEncoder as JaxClapTextEncoder
from ap_adapter_tpu.models.clap_audio import ClapAudioTower as JaxClapAudioTower
from ap_adapter_tpu.utils.init import fast_init
from ap_adapter_torch.audio.mel import clap_log_mel
from ap_adapter_torch.configs import ClapAudioConfig, ClapTextConfig, tiny_pipeline_config
from ap_adapter_torch.convert import from_jax
from ap_adapter_torch.eval.clap_scoring import ClapScorer
from ap_adapter_torch.models.clap import ClapTextEncoder
from ap_adapter_torch.models.clap_audio import ClapAudioTower
from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline, PipelineModules
from ap_adapter_torch.pipeline.tokenize import make_text_batch
from tests.torch_port_common import close, one_torch_thread  # noqa: F401 (autouse fixture)

# test_clap_audio.py's parity config, and test_clap_scorer_rank's two towers
TOWER = dict(spec_size=64, patch_size=4, patch_stride=(4, 4), patch_embeds_hidden_size=16, depths=(2, 2),
             num_heads=(2, 4), window_size=4, num_mel_bins=16, mlp_ratio=2.0, projection_dim=8)
SCORER_TEXT = dict(vocab_size=50, hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32,
                   max_position_embeddings=32, projection_dim=8, max_length=8)
SCORER_AUDIO = dict(spec_size=64, patch_size=4, patch_stride=(4, 4), patch_embeds_hidden_size=8, depths=(1, 1),
                    num_heads=(2, 2), window_size=4, num_mel_bins=16, mlp_ratio=1.0, projection_dim=8,
                    sampling_rate=8000, hop_length=80, n_fft=256, max_length_s=1)


def _jax_tower_params(cfg, time_len=256, seed=0):
    """fast_init tower params with randomised batch-norm statistics and
    relative-position tables, so that parity means something."""

    params = jax.tree_util.tree_map(np.asarray, fast_init(
        lambda k: JaxClapAudioTower(cfg).init(k, jnp.zeros((1, 1, time_len, cfg.num_mel_bins))), seed=seed)["params"])
    rng = np.random.default_rng(seed + 1)
    enc = params["encoder"]
    enc["bn_mean"] = rng.normal(0, 0.5, enc["bn_mean"].shape).astype(np.float32)
    enc["bn_var"] = rng.uniform(0.5, 2.0, enc["bn_var"].shape).astype(np.float32)
    for name, block in enc.items():
        if "block" in name:
            t = block["attention"]["relative_position_bias_table"]
            block["attention"]["relative_position_bias_table"] = rng.normal(0, 0.5, t.shape).astype(np.float32)
    return params


def _port_tower(params, cfg) -> ClapAudioTower:
    tower = ClapAudioTower(cfg)
    tower.load_state_dict({k: torch.as_tensor(v) for k, v in from_jax.clap_audio_state_dict(params, cfg).items()})
    return tower.eval()


@pytest.fixture(scope="module")
def tower_params():
    return _jax_tower_params(JaxClapAudioConfig(**TOWER))


def test_clap_log_mel_matches_jax():
    wav = (np.random.default_rng(0).standard_normal((2, 48_000)) * 0.2).astype(np.float32)
    want = np.asarray(jax_clap_log_mel(jnp.asarray(wav), fmin=50.0))
    got = clap_log_mel(torch.from_numpy(wav), fmin=50.0)
    assert got.shape == want.shape == (2, 101, 64)
    close(got, want, atol=2e-3, rtol=1e-4)


@pytest.mark.parametrize("time_len", [256, 200])    # exact and interpolated
def test_clap_audio_tower_matches_jax(tower_params, time_len):
    cfg = ClapAudioConfig(**TOWER)
    feats = np.random.default_rng(time_len).standard_normal((2, 1, time_len, 16)).astype(np.float32)
    want = np.asarray(jax.jit(JaxClapAudioTower(JaxClapAudioConfig(**TOWER)).apply)(
        {"params": tower_params}, jnp.asarray(feats)))
    with torch.no_grad():
        got = _port_tower(tower_params, cfg)(torch.from_numpy(feats))
    assert got.shape == want.shape == (2, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)


def test_clap_audio_state_dict_round_trips(tower_params):
    """torch_import.clap_audio_params (which reads HF's
    ClapAudioModelWithProjection keys) of from_jax's state dict is the JAX
    tree bit for bit, and that state dict is the tower's, buffers included."""

    cfg = ClapAudioConfig(**TOWER)
    sd = from_jax.clap_audio_state_dict(tower_params, cfg)
    back = torch_import.clap_audio_params(sd, cfg)
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])   # noqa: E731
    got, want = flat(back), flat(tower_params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=str(k))
    assert set(sd) == set(ClapAudioTower(cfg).state_dict())


@pytest.fixture(scope="module")
def scorers():
    """test_clap_scorer_rank's JAX scorer and the port's on the same weights."""

    tcfg, acfg = JaxClapTextConfig(**SCORER_TEXT), JaxClapAudioConfig(**SCORER_AUDIO)
    tparams = jax.tree_util.tree_map(np.asarray, fast_init(lambda k: JaxClapTextEncoder(tcfg).init(
        k, jnp.ones((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32)))["params"])
    aparams = _jax_tower_params(acfg, time_len=101, seed=3)
    text = ClapTextEncoder(ClapTextConfig(**SCORER_TEXT))
    text.load_state_dict({k: torch.as_tensor(v) for k, v in
                          from_jax.clap_text_state_dict(tparams, tcfg.num_layers).items()})
    port = ClapScorer(text, _port_tower(aparams, ClapAudioConfig(**SCORER_AUDIO)), device="cpu")
    return JaxClapScorer(tcfg, acfg, {"text": tparams, "audio": aparams}), port


def test_clap_scorer_rank_matches_jax(scorers):
    jax_scorer, port = scorers
    ids = np.arange(8, dtype=np.int32)[None] % 47 + 3
    mask = np.ones((1, 8), np.int32)
    rng = np.random.default_rng(4)
    wavs = [(rng.standard_normal(8000) * s).astype(np.float32) for s in (0.05, 0.1, 0.3)]
    want = jax_scorer.audio_features(np.stack(wavs), 8000) @ jax_scorer.text_features(ids, mask)[0]
    got = port.similarities(ids, mask, wavs, 8000)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(port.rank(ids, mask, wavs, 8000), jax_scorer.rank(ids, mask, wavs, 8000))


def test_generate_ranked_reorders_generate_by_the_scorer():
    """Two candidates of one prompt from one ``generate`` call, in the
    scorer's order; without a scorer, in generation order."""

    cfg = tiny_pipeline_config()
    pipe = AudioLDM2Pipeline(cfg, PipelineModules(cfg).init_random(0, device="cpu"))
    acfg = {**SCORER_AUDIO, "projection_dim": cfg.clap.projection_dim}
    tower = _port_tower(_jax_tower_params(JaxClapAudioConfig(**acfg), time_len=101, seed=5), ClapAudioConfig(**acfg))
    scorer = ClapScorer(pipe.modules.clap, tower, device="cpu")
    pos = make_text_batch(cfg, ["a recording of a violin solo"], t5_len=8)
    neg = make_text_batch(cfg, [""], t5_len=8)
    fbank = np.random.default_rng(5).standard_normal((1, 64, 32)).astype(np.float32)
    kw = dict(audio_length_in_s=0.2, num_inference_steps=2, guidance_scale=3.0, time_pool=2, freq_pool=2,
              seed=1)
    wavs = pipe.generate(pos.repeat_interleave(2), neg.repeat_interleave(2), np.repeat(fbank, 2, axis=0), **kw)
    assert wavs.shape == (2, int(0.2 * cfg.vocoder.sampling_rate)) and not np.array_equal(wavs[0], wavs[1])
    ranked = pipe.generate_ranked(pos, neg, fbank, num_waveforms_per_prompt=2, scorer=scorer, **kw)
    sims = scorer.similarities(pos.clap_ids, pos.clap_mask, list(wavs), cfg.vocoder.sampling_rate)
    np.testing.assert_array_equal(ranked, wavs[np.argsort(sims)[::-1]])
    np.testing.assert_array_equal(pipe.generate_ranked(pos, neg, fbank, num_waveforms_per_prompt=2, **kw), wavs)
