"""Wav file IO: ``scipy.io.wavfile`` per file, and a batched decoder over the
repo's C++ thread pool (``native/wavio.cpp``) for the training loader.

Counterpart of ``ap_adapter_tpu/audio/io.py``. The C++ source is compiled
with the host compiler at first use (the flags of ``native/Makefile``) into
``build/ap_adapter_torch/`` at the root of the checkout, under a name that
carries a hash of the source and flags, and is bound with ``ctypes``. A
failed build or load raises: the batched decoder never switches to scipy
behind the caller's back. Only files the C++ reader refuses (status < 0: a
format it does not decode, or a file it cannot open) go through
:func:`load_wav`, one at a time, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
WAVIO_SOURCE = ROOT / "native" / "wavio.cpp"
BUILD_DIR = ROOT / "build" / "ap_adapter_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-shared")

_lock = threading.Lock()
_native = None


def wavio_library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(WAVIO_SOURCE.read_bytes())
    return BUILD_DIR / f"libwavio_{h.hexdigest()[:16]}.so"


def build_wavio() -> Path:
    """Compile ``native/wavio.cpp`` into the shared library if it is not built
    yet (written under a temporary name and renamed, so concurrent processes
    never load a partial file). Raises if the compiler fails."""

    out = wavio_library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++/c++, or $CXX) to build native/wavio.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(WAVIO_SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building native/wavio.cpp failed:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def native_wavio() -> ctypes.CDLL:
    """The C++ decoder, built at first call; the three entry points bound with
    the JAX package's signatures."""

    global _native
    with _lock:
        if _native is None:
            lib = ctypes.CDLL(str(build_wavio()))
            i64p, i32p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)
            f32p = ctypes.POINTER(ctypes.c_float)
            lib.wavio_read_info.argtypes = [ctypes.c_char_p, i64p, i32p, i32p]
            lib.wavio_read_info.restype = ctypes.c_int32
            lib.wavio_read_f32.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64]
            lib.wavio_read_f32.restype = ctypes.c_int64
            lib.wavio_read_batch_f32.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, f32p,
                                                 ctypes.c_int64, i64p, i32p, i32p, ctypes.c_int32]
            lib.wavio_read_batch_f32.restype = ctypes.c_int32
            _native = lib
    return _native


def load_wav(path: str, mono: bool = True) -> Tuple[np.ndarray, int]:
    """Read a wav file -> (float32 waveform in [-1, 1], sample rate): [N] with
    the channels averaged (``mono``), else [channels, N] for a multichannel
    file."""

    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1) if mono else data.T
    return data, int(sr)


def load_wav_batch(paths, capacity: int, n_threads: int = 4) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode a batch of wavs in one call of the C++ thread pool.

    Returns ``(wavs [n, capacity] float32 mono, zero-padded; frames [n], the
    decoded lengths before the padding; sample_rates [n])``. Resampling stays
    with the caller. Files the C++ reader refuses go through :func:`load_wav`
    (which raises for a file that does not exist)."""

    paths = [os.fspath(p) for p in paths]
    n = len(paths)
    out = np.zeros((n, capacity), dtype=np.float32)
    frames = np.zeros(n, dtype=np.int64)
    srs = np.zeros(n, dtype=np.int32)
    if n == 0:
        return out, frames, srs
    lib = native_wavio()
    status = np.zeros(n, dtype=np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.wavio_read_batch_f32(c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), capacity,
                             frames.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                             srs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                             status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_threads)
    for i in np.nonzero(status < 0)[0]:
        wav, sr = load_wav(paths[i])
        m = min(wav.shape[-1], capacity)
        out[i, :m] = wav[:m]
        out[i, m:] = 0.0
        frames[i] = m
        srs[i] = sr
    return out, frames, srs


def save_wav(path: str, waveform: np.ndarray, sample_rate: int = 16_000) -> None:
    """Write float32 [-1, 1] (or int16) audio as 16-bit PCM."""

    from scipy.io import wavfile

    data = np.asarray(waveform)
    if data.dtype != np.int16:
        data = (np.clip(data, -1.0, 1.0) * 32767.0).astype(np.int16)
    wavfile.write(path, sample_rate, data)
