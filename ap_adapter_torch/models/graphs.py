"""CUDA graph capture and replay of a module's forward, shared by the UNet
(``models/unet.py``) and the MusicGen decoder (``models/musicgen.py``).

A forward is keyed by ``graph_signature``: the nest of its inputs with each
tensor's shape, strides and dtype in its place, and the numbers its kernels
take baked in. The first forward of a signature runs eager and warms the
kernels' plans, the second captures the graph and replays it, and every
later one copies its input tensors into the graph's static buffers,
replays it and returns a fresh copy of its output.

A ``StaticBuffers`` object among the inputs is held by the graph as it is:
its tensors are read and written in place at every replay and never copied
in, and the signature holds their addresses, shapes and dtypes.
A cache that a decode loop grows step by step lives there, with the step
index on the device, so one graph serves every step.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn as nn

from ap_adapter_torch.ops.cuda_kernels import LAUNCHES
from ap_adapter_torch.utils import trace

# a signature's value in a graph cache after its first, eager forward
WARMED = "warmed"
# graphs a module keeps; past it the least recently used one is dropped
MAX_GRAPHS = 8


class StaticBuffers:
    """Tensors that a captured forward reads and writes in place (a decode
    cache, its step index): a graph holds them, never a copy."""

    def tensors(self) -> Sequence[torch.Tensor]:
        raise NotImplementedError


class _NotCapturable(Exception):
    pass


def _structure(obj, device: torch.device, leaves: List[torch.Tensor]):
    if isinstance(obj, torch.Tensor):
        if obj.device != device:
            raise _NotCapturable
        leaves.append(obj)
        return obj.shape, obj.stride(), obj.dtype
    if obj is None:
        return None
    if isinstance(obj, StaticBuffers):
        ts = obj.tensors()
        if any(t.device != device for t in ts):
            raise _NotCapturable
        return StaticBuffers, tuple((t.data_ptr(), t.shape, t.stride(), t.dtype) for t in ts)
    if isinstance(obj, dict):
        return dict, tuple((k, _structure(v, device, leaves)) for k, v in obj.items())
    if isinstance(obj, (tuple, list)):
        return tuple, tuple(_structure(v, device, leaves) for v in obj)
    raise _NotCapturable


def graph_signature(inputs: tuple, ip_scale: float, device: torch.device,
                    leaves: List[torch.Tensor]) -> Optional[tuple]:
    """The key of a forward's captured graph: the nest of ``inputs`` (tensors,
    Nones, dicts, tuples and ``StaticBuffers``) with each tensor's shape,
    strides and dtype in its place, and ``ip_scale``, which the kernels take
    as a number baked in at capture. The step is not part of it. Appends the
    nest's tensors, those of ``StaticBuffers`` excepted, to ``leaves`` in
    order. None, and the forward runs eager, where a tensor lies on another
    device than ``device`` or the nest holds another value (a Python number
    as ``timesteps`` would be baked in)."""

    if not isinstance(ip_scale, (int, float)):
        return None
    try:
        return _structure(inputs, device, leaves), float(ip_scale)
    except _NotCapturable:
        return None


def _static_nest(obj, out: List[torch.Tensor]):
    """``obj`` with a new tensor like each of its tensors in its place, each
    appended to ``out`` in ``graph_signature``'s order; ``StaticBuffers``
    stay themselves."""

    if isinstance(obj, torch.Tensor):
        out.append(torch.empty_like(obj))
        return out[-1]
    if isinstance(obj, dict):
        return {k: _static_nest(v, out) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_static_nest(v, out) for v in obj)
    return obj


class _Graph:
    """One captured forward: the graph, its static inputs, its static output
    and the kernel launches one replay makes."""

    __slots__ = ("graph", "inputs", "out", "launches")

    def __init__(self, graph, inputs: List[torch.Tensor], out: torch.Tensor, launches: Dict[str, int]):
        self.graph, self.inputs, self.out, self.launches = graph, inputs, out, launches

    def replay(self, leaves: List[torch.Tensor]) -> torch.Tensor:
        """Copy ``leaves`` (``graph_signature``'s) into the static inputs,
        replay, and return a copy of the output: the next replay overwrites
        the static one."""

        if self.inputs:
            torch._foreach_copy_(self.inputs, leaves)
        self.graph.replay()
        for k, n in self.launches.items():
            LAUNCHES[k] += n
        return self.out.clone()


class _GraphCache(dict):
    """Signature -> ``_Graph`` (or ``WARMED``), at most ``MAX_GRAPHS`` of
    them, the least recently used dropped first, and the private memory
    pool the graphs share. A copy of the module starts with none."""

    pool = None

    def __deepcopy__(self, memo):
        return _GraphCache()

    def get(self, key, default=None):
        if key not in self:
            return default
        value = self[key] = self.pop(key)       # the newest at the end
        return value

    def put(self, key, value):
        self.pop(key, None)
        self[key] = value
        while len(self) > MAX_GRAPHS:
            del self[next(iter(self))]
        return value


class GraphedModule(nn.Module):
    """A module whose CUDA forwards under ``no_grad`` replay captured graphs
    of ``_forward`` (``graphed``). The graphs are dropped whenever a
    parameter or buffer is replaced (``drop_graphs``)."""

    def __init__(self):
        super().__init__()
        self._graphs = _GraphCache()

    def drop_graphs(self) -> None:
        """Forget every captured forward: the next forward of each signature
        runs eager, and the one after it captures anew."""

        self._graphs = _GraphCache()

    def _apply(self, fn, *args, **kwargs):
        # .to(), .cuda(), .half(), to_empty(): new parameter and buffer tensors
        self.drop_graphs()
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        # load_state_dict, on this module or on one that holds it (assign=True swaps the tensors)
        self.drop_graphs()
        super()._load_from_state_dict(*args, **kwargs)

    def graphed(self, inputs: tuple, number: float, device: torch.device, capturable: bool,
                run: Callable, counter: Dict[str, int], span: str):
        """``run(*inputs)``, replayed from a captured graph where
        ``capturable`` and the inputs have a signature (``graph_signature``
        with ``number`` baked in), else eager; ``counter`` counts the forward
        as "captured", "replayed" or "eager", and ``span`` names the trace
        span of a capture or replay."""

        leaves: List[torch.Tensor] = []
        key = graph_signature(inputs, number, device, leaves) if capturable else None
        entry = self._graphs.get(key) if key is not None else None
        if entry is not None:
            with trace.span(span):
                if entry is WARMED:
                    counter["captured"] += 1
                    entry = self._graphs.put(key, self._capture(inputs, run))
                else:
                    counter["replayed"] += 1
                return entry.replay(leaves)
        counter["eager"] += 1
        out = run(*inputs)
        if key is not None:
            self._graphs.put(key, WARMED)
        return out

    def _capture(self, inputs: tuple, run: Callable) -> _Graph:
        """Capture ``run`` on static copies of ``inputs`` into the module's
        graph pool. The static inputs are allocated outside the pool; the
        kernel launches the capture counted move from ``LAUNCHES`` to the
        graph, which adds them back at every replay."""

        static: List[torch.Tensor] = []
        nest = _static_nest(inputs, static)
        if self._graphs.pool is None:
            self._graphs.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = dict(LAUNCHES)
        with torch.cuda.graph(graph, pool=self._graphs.pool, capture_error_mode="thread_local"):
            out = run(*nest)
        launches = {k: n - before[k] for k, n in LAUNCHES.items() if n != before[k]}
        for k, n in launches.items():
            LAUNCHES[k] -= n
        return _Graph(graph, static, out, launches)
