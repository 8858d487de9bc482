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
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ap_adapter_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "apk_fused_ln_self_attention": [_P] * 10 + [_I] * 4 + [_F] + [_I] * 6 + [_P],
    "apk_fused_ln_cross_attention_kv": [_P] * 8 + [_I, _P, _P, _P, _I, _F, _P, _P] + [_I] * 4 + [_F]
    + [_I] * 8 + [_P],
    "apk_fused_ln_geglu_ff": [_P] * 9 + [_I] * 4 + [_F] + [_I] * 5 + [_P],
    "apk_fused_ln_cross_attention": [_P, _P, _I, _I, _I] + [_P] * 9 + [_F] + [_P] * 4 + [_I] * 4 + [_F]
    + [_I] * 11 + [_P],
    "apk_fused_ln_self_attention_bwd_dx": [_P] * 11 + [_I] * 4 + [_F] + [_I] * 9 + [_P],
    "apk_fused_ln_cross_attention_bwd": [_P, _P, _P, _I, _I, _I] + [_P] * 8 + [_F] + [_P] * 7 + [_I] * 4 + [_F]
    + [_I] * 12 + [_P],
    "apk_fused_ln_geglu_ff_bwd_dx": [_P] * 10 + [_I] * 4 + [_F] + [_I] * 5 + [_P],
    "apk_fused_ln_geglu_ff_int8": [_P] * 15 + [_I] * 4 + [_F] + [_I] * 5 + [_P],
    "apk_fused_ln_self_attention_int8": [_P] * 15 + [_I] * 4 + [_F, _F] + [_I] * 9 + [_P],
    "apk_fused_ln_cross_attention_int8": [_P, _P, _I, _I, _I] + [_P] * 11 + [_F] + [_P] * 7
    + [_I] * 4 + [_F, _F] + [_I] * 11 + [_P],
    "apk_self_attention": [_P] * 4 + [_I] * 5 + [_P],
    "apk_group_norm_silu": [_P] * 4 + [_I] * 8 + [_F, _I, _P],
    "apk_fused_resnet_block": [_P] * 2 + [_I] + [_P] * 10 + [_I] * 4 + [_P] * 2 + [_I] * 4 + [_P] * 2
    + [_I] * 6 + [_F] + [_I] * 6 + [_P],
    "apk_dual_kv_attention": [_P] * 3 + [_I] + [_P] * 2 + [_I, _F, _P] + [_I] * 6 + [_P],
}

# Launch counts per op, incremented by each wrapper right after its kernels
# were launched without error (never by the plain CPU path).
LAUNCHES: Dict[str, int] = {
    "fused_ln_self_attention": 0,
    "fused_ln_cross_attention_kv": 0,
    "fused_ln_geglu_ff": 0,
    "fused_ln_cross_attention": 0,
    "fused_ln_self_attention_bwd_dx": 0,
    "fused_ln_cross_attention_bwd": 0,
    "fused_ln_geglu_ff_bwd_dx": 0,
    "fused_ln_geglu_ff_int8": 0,
    "fused_ln_self_attention_int8": 0,
    "fused_ln_cross_attention_int8": 0,
    "self_attention": 0,
    "group_norm_silu": 0,
    "fused_resnet_block": 0,
    "dual_kv_attention": 0,
}

# UNet forwards by how they ran (``models/unet.py::AudioLDM2UNet.forward``):
# "captured" a CUDA graph of a new input signature and replayed it,
# "replayed" a graph captured before, or "eager" (every CPU, grad-mode and
# tensor-parallel forward, and the first of each signature). A replay adds
# its graph's kernel launches to LAUNCHES, as an eager forward would.
UNET_FORWARDS: Dict[str, int] = {"captured": 0, "replayed": 0, "eager": 0}

_lock = threading.Lock()
_lib = None
_entries: Dict[str, Callable] = {}      # op -> the library's bound apk_<op>


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, UNET_FORWARDS):
        for k in counts:
            counts[k] = 0


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
    """Compile ``csrc/*.cu`` into the shared library if it is not built yet:
    one ``nvcc -c`` per source, all started together, then one link. The
    compilers' output (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside the library as ``nvcc.log``."""

    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                                text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        stdout, stderr = proc.communicate()
        log.append(" ".join(cmd) + "\n" + stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{stderr[-4000:]}")
    if not failed:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs), "-ldl"]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(f"link ({res.returncode}):\n{res.stderr[-4000:]}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    (BUILD_DIR / "nvcc.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
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

    fn = _entries.get(op)
    if fn is None:
        fn = _entries[op] = getattr(library(), f"apk_{op}")
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{op}: CUDA launch failed: {library().apk_error_string(rc).decode()} ({rc})")
    LAUNCHES[op] += 1


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def check_no_grad(op: str, **tensors: torch.Tensor | None) -> None:
    """Raise when autograd would need a gradient through this raw op: its
    kernel writes into fresh buffers and records no graph, so a caller that
    differentiates must go through the op's ``torch.autograd.Function``."""

    if not torch.is_grad_enabled():
        return
    needs = [name for name, t in tensors.items() if t is not None and t.requires_grad]
    if needs:
        raise RuntimeError(f"{op}: operands {needs} require grad under grad mode; the raw op records "
                           f"no graph: call {op}_vjp (its autograd Function) instead")


def plain_vjp(fn: Callable, args: Sequence, needs: Sequence[bool], grad: torch.Tensor) -> List:
    """Gradients of ``fn(*args)`` against ``grad`` for the tensor arguments
    flagged in ``needs`` (None elsewhere), by autograd over a recomputation
    with ``fn``, a plain PyTorch version."""

    with torch.enable_grad():
        leaves = [a.detach().requires_grad_(bool(n)) if torch.is_tensor(a) else a for a, n in zip(args, needs)]
        wanted = [leaf for leaf, n in zip(leaves, needs) if n]
        grads = iter(torch.autograd.grad(fn(*leaves), wanted, grad, allow_unused=True))
    return [next(grads) if n else None for n in needs]


def check_contiguous(op: str, **tensors: torch.Tensor | None) -> None:
    """Raise unless every operand is contiguous. Checked on every device, so
    that the CPU path holds its callers to the layout the kernels read."""

    for name, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous, got strides {t.stride()}")


def check_operands(op: str, ref: torch.Tensor, dtypes: Dict[str, torch.dtype] | None = None,
                   **tensors: torch.Tensor | None) -> None:
    """Raise unless every operand is a 16-byte aligned CUDA tensor on
    ``ref``'s device, of the type ``dtypes`` names for it, else fp32 for
    names starting with ``bias`` and bf16 for the rest."""

    if not ref.is_cuda:
        raise RuntimeError(f"{op}: no kernel for device {ref.device}")
    index = ref.get_device()
    for name, t in tensors.items():
        if t is None:
            continue
        want = (dtypes or {}).get(name, torch.float32 if name.startswith("bias") else torch.bfloat16)
        if t.dtype != want or not t.is_cuda or t.get_device() != index:
            raise ValueError(f"{op}: {name} must be {want} on {ref.device}, got {t.dtype} on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} must be 16-byte aligned")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (the launch plans fill them)."""

    return torch.cuda.get_device_properties(device).multi_processor_count


def check_heads(op: str, c: int, heads: int) -> int:
    """Width limits of the CUDA kernels: C % 64 == 0, head dim d % 16 == 0, d <= 128."""

    d = c // heads
    if c % 64 or c % heads or d % 16 or d > 128:
        raise ValueError(f"{op}: kernel needs C % 64 == 0 and head dim % 16 == 0, <= 128 "
                         f"(C={c}, heads={heads})")
    return d
