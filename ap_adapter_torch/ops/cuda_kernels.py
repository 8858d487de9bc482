"""Build, load and launch the hand-written Hopper kernels in ``csrc/``.

The CUDA sources are compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, under ``build/`` at the root
of the checkout (the library name carries a hash of the sources and flags,
so an edited source never loads a stale build). The library is bound with
``ctypes``: pointers are passed as ``c_void_p`` from ``tensor.data_ptr()``,
and every op launches on PyTorch's current stream.

Importing this module touches neither ``nvcc`` nor the GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ap_adapter_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "apk_fused_ln_self_attention": [_P] * 13 + [_I] * 4 + [_F, _P],
    "apk_fused_ln_cross_attention_kv": [_P] * 8 + [_I, _P, _P, _P, _I, _F, _P, _P, _P]
    + [_I] * 4 + [_F, _P],
    "apk_fused_ln_geglu_ff": [_P] * 9 + [_I] * 4 + [_F, _P],
}

# Launch counts per op, incremented by each wrapper right after its kernels
# were launched without error (never by the plain CPU path).
LAUNCHES: Dict[str, int] = {
    "fused_ln_self_attention": 0,
    "fused_ln_cross_attention_kv": 0,
    "fused_ln_geglu_ff": 0,
}

_lock = threading.Lock()
_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libapk_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library if it is not built yet.
    The compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside the library as ``nvcc.log``."""

    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / "nvcc.log").write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""

    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.apk_error_string.argtypes = [ctypes.c_int]
            lib.apk_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(op: str, *args) -> None:
    """Call ``apk_<op>`` on the current stream; raise on a launch error."""

    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, f"apk_{op}")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{op}: CUDA launch failed: {lib.apk_error_string(rc).decode()} ({rc})")
    LAUNCHES[op] += 1


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def check_contiguous(op: str, **tensors: torch.Tensor | None) -> None:
    """Raise unless every operand is contiguous. Checked on every device, so
    that the CPU path holds its callers to the layout the kernels read."""

    for name, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous, got strides {t.stride()}")


def check_operands(op: str, ref: torch.Tensor, **tensors: torch.Tensor | None) -> None:
    """Raise unless every operand is a 16-byte aligned bf16 CUDA tensor on
    ``ref``'s device (fp32 for names starting with ``bias``)."""

    if ref.device.type != "cuda":
        raise RuntimeError(f"{op}: no kernel for device {ref.device}")
    for name, t in tensors.items():
        if t is None:
            continue
        want = torch.float32 if name.startswith("bias") else torch.bfloat16
        if t.device != ref.device or t.dtype != want:
            raise ValueError(f"{op}: {name} must be {want} on {ref.device}, got {t.dtype} on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} must be 16-byte aligned")


def check_heads(op: str, c: int, heads: int) -> int:
    """Width limits of the CUDA kernels: C % 64 == 0, head dim d % 16 == 0, d <= 128."""

    d = c // heads
    if c % 64 or c % heads or d % 16 or d > 128:
        raise ValueError(f"{op}: kernel needs C % 64 == 0 and head dim % 16 == 0, <= 128 "
                         f"(C={c}, heads={heads})")
    return d
