"""The port's batched wav decoder (``audio/io.py::load_wav_batch`` over
``native/wavio.cpp``, compiled into ``build/`` at first use), the training
dataset's ``get_batch`` and the loader's prefetch thread, on the CPU.

The oracles are the port's own scipy ``load_wav`` (file by file) and the
JAX package's ``ap_adapter_tpu.audio.io.load_wav_batch``, a numpy module
that imports no JAX. No model runs here.
"""

from __future__ import annotations

import gc
import itertools
import json
import threading
import weakref

import numpy as np
import pytest
from scipy.io import wavfile

from ap_adapter_tpu.audio import io as jio
from ap_adapter_torch.audio import io
from ap_adapter_torch.train.data import AudioSetDataset, prefetch

CAPACITY = 8000


def _write(tmp_path, name, data, sr=16_000):
    path = tmp_path / name
    wavfile.write(str(path), sr, data)
    return str(path)


@pytest.fixture
def clips(tmp_path):
    rng = np.random.default_rng(0)
    f = rng.uniform(-0.9, 0.9, size=9000)
    return {
        "int16": _write(tmp_path, "int16.wav", (f * 32767).astype(np.int16)),
        "int32": _write(tmp_path, "int32.wav", (f * 2**31).astype(np.int32)),
        "float32": _write(tmp_path, "float32.wav", f.astype(np.float32)),
        "stereo": _write(tmp_path, "stereo.wav", (rng.uniform(-0.9, 0.9, size=(9000, 2)) * 32767).astype(np.int16)),
        "44k1": _write(tmp_path, "44k1.wav", (f * 32767).astype(np.int16), sr=44_100),
        "short": _write(tmp_path, "short.wav", (f[:1234] * 32767).astype(np.int16)),
    }


def test_batch_matches_load_wav_and_jax(clips):
    """Each row is ``load_wav``'s mono waveform bit for bit, cut to the
    capacity or zero-padded, with its decoded length and rate; the same
    arrays as the JAX package's ``load_wav_batch``."""

    paths = list(clips.values())
    wavs, frames, srs = io.load_wav_batch(paths, CAPACITY, n_threads=3)
    assert wavs.shape == (len(paths), CAPACITY) and wavs.dtype == np.float32
    for i, p in enumerate(paths):
        wav, sr = io.load_wav(p)
        m = min(wav.shape[0], CAPACITY)
        assert frames[i] == m and srs[i] == sr, p
        np.testing.assert_array_equal(wavs[i, :m], wav[:m], err_msg=p)
        assert not wavs[i, m:].any()
    assert frames[list(clips).index("short")] == 1234 and srs[list(clips).index("44k1")] == 44_100
    jw, jf, js = jio.load_wav_batch(paths, CAPACITY)
    np.testing.assert_array_equal(wavs, jw)
    np.testing.assert_array_equal(frames, jf)
    np.testing.assert_array_equal(srs, js)


def test_missing_file_raises_as_jax(clips, tmp_path):
    """A file the C++ reader cannot open goes through ``load_wav``, which
    raises, as the JAX package's does; an empty batch is three empty arrays."""

    paths = [clips["int16"], str(tmp_path / "missing.wav")]
    with pytest.raises(FileNotFoundError):
        io.load_wav_batch(paths, CAPACITY)
    with pytest.raises(FileNotFoundError):
        jio.load_wav_batch(paths, CAPACITY)
    wavs, frames, srs = io.load_wav_batch([], CAPACITY)
    assert wavs.shape == (0, CAPACITY) and frames.shape == srs.shape == (0,)


def test_native_library_is_built_under_build(clips):
    """The decoder is compiled into ``build/ap_adapter_torch/``, never into
    ``native/``, under a name keyed by the source and flags."""

    io.load_wav_batch([clips["int16"]], 16)
    path = io.wavio_library_path()
    assert path.exists() and path.parent == io.BUILD_DIR and path.parent.parent.name == "build"
    assert not list(io.WAVIO_SOURCE.parent.glob("libwavio_*"))


def test_load_wav_mono_argument(clips):
    """``mono=False`` keeps the channels as [channels, N], as the JAX
    ``load_wav`` does; ``mono=True`` averages them."""

    both, sr = io.load_wav(clips["stereo"], mono=False)
    jboth, jsr = jio.load_wav(clips["stereo"], mono=False)
    assert both.shape == (2, 9000) and sr == jsr == 16_000
    np.testing.assert_array_equal(both, jboth)
    np.testing.assert_array_equal(io.load_wav(clips["stereo"])[0], both.T.mean(axis=1))


def test_get_batch_equals_getitem(clips, tmp_path):
    """``AudioSetDataset.get_batch`` gives ``[dataset[i] for i in idxs]``:
    the same captions (the same draws of its caption generator) and the same
    resampled, padded or cut waveforms."""

    names = ["int16", "44k1", "short", "stereo", "float32"]
    manifest = tmp_path / "m.json"
    manifest.write_text(json.dumps({"data": [{"wav": clips[n].rsplit("/", 1)[1], "labels": [n, "x"]}
                                             for n in names]}))
    a = AudioSetDataset(str(manifest), str(tmp_path), duration_s=0.5, seed=3)
    b = AudioSetDataset(str(manifest), str(tmp_path), duration_s=0.5, seed=3)
    idxs = [4, 1, 2, 0, 3, 1]
    got = a.get_batch(idxs)
    want = [b[i] for i in idxs]
    for (gc, gw), (wc, ww) in zip(got, want):
        assert gc == wc
        assert gw.dtype == np.float32 and gw.shape == (8000,)
        np.testing.assert_array_equal(gw, ww)


def test_prefetch_stops_with_its_consumer():
    """Closing the prefetching generator stops its thread, which then draws
    no more batches, and frees the batches it held."""

    class Batch:
        pass

    made = []

    def source():
        for _ in itertools.count():
            made.append(weakref.ref(b := Batch()))
            yield b

    gen = prefetch(source(), depth=2)
    got = [next(gen) for _ in range(3)]
    threads = [t for t in threading.enumerate() if t.name == "ap-data-prefetch" and t.is_alive()]
    assert len(got) == 3 and threads
    gen.close()
    assert not any(t.is_alive() for t in threads)
    n = len(made)
    del got, gen
    gc.collect()
    assert len(made) == n and all(r() is None for r in made)
