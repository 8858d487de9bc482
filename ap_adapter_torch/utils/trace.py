"""Host spans at the port's layer boundaries, off by default.

    from ap_adapter_torch.utils import trace

    trace.enable()
    wavs = pipe.generate(pos, neg, fbank)
    records, dropped = trace.drain()
    trace.disable()

``span(name, **attrs)`` is a context manager. Off, it is one shared no-op:
one flag check, no clock read and no object of its own. On, it records its
name, its id, its parent's id (a stack per thread), the id of its root
``ap.generate`` span (None outside one), ``time.perf_counter_ns()`` at
entry and exit (the clock of ``time.perf_counter``) and ``attrs``; while
``torch.profiler`` records, it is also a ``record_function`` range of the
same name, so the profiler's trace holds it on its own clock. Records stay
in memory, up to ``CAP`` until the next ``drain``; past it a span is
counted as dropped. Nothing is written while the program runs: the caller drains.

Every name starts with ``ap.``. The root of a request is ``ap.generate``.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import List, NamedTuple, Optional, Tuple

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

CAP = 1 << 18          # records kept between drains: some 130 edit requests


class SpanRecord(NamedTuple):
    name: str
    id: int
    parent: Optional[int]
    request: Optional[int]
    start_ns: int
    end_ns: int
    attrs: Optional[dict]


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


class _Local(threading.local):
    def __init__(self):
        self.stack = []


_NO_SPAN = _NoSpan()
_on = False
_records: List[tuple] = []          # SpanRecord fields, made SpanRecords by drain()
_dropped = 0
_ids = itertools.count(1)
_local = _Local()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "request", "start", "rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs or None

    def __enter__(self):
        st = _local.stack
        self.id = next(_ids)
        if st:
            top = st[-1]
            self.parent, self.request = top.id, top.request
        else:
            self.parent, self.request = None, self.id if self.name == "ap.generate" else None
        st.append(self)
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        end = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _local.stack.pop()
        if len(_records) < CAP:
            _records.append((self.name, self.id, self.parent, self.request, self.start, end, self.attrs))
        else:
            _dropped += 1
        return False


def span(name: str, **attrs):
    """A span named ``name`` around a ``with`` block (see the module's
    docstring); ``attrs`` are kept with its record."""

    if not _on:
        return _NO_SPAN
    return _Span(name, attrs)


def enable() -> None:
    """Record spans from now on, at most ``CAP`` until the next ``drain``."""

    global _on
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until ``drain``."""

    global _on
    _on = False


def enabled() -> bool:
    return _on


def drain() -> Tuple[List[SpanRecord], int]:
    """(the records, in the order the spans ended; the count of spans
    dropped past the cap), and both cleared."""

    global _records, _dropped
    out, dropped = _records, _dropped
    _records, _dropped = [], 0
    return [SpanRecord._make(r) for r in out], dropped
