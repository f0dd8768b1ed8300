"""Spans at the port's layer boundaries, recorded while a ``torch.profiler``
profile runs.

``span(name)`` is a context manager around one boundary of the program: the
train step and its phases (``train/loop.py``), the batch transfer
(``data/loader.to_device``), ``Predictor.predict`` and its parts
(``serve.py``). It records only while a profiler runs in the process
(``torch.profiler.profile`` or the autograd profiler, started on any
thread), so whoever profiles the program gets its spans, and nothing else
turns them on. With no profiler running a span is one shared no-op
context: it reads no clock, allocates nothing and opens no range.

While a profiler runs, each span records its name, its id, its parent's and
its root's ids (the spans of one step or one request share the root), its
thread's native id and its start and end on ``time.monotonic_ns``, into a
bounded buffer in memory; ``spans()`` copies the records and ``clear()``
empties them. A span also opens ``torch.profiler.record_function(name)``,
so that on the profiling thread it is a range of the trace, on the trace's
own clock. The profiler does not record the ranges of other threads; their
spans are placed on the trace by their monotonic times.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import List, NamedTuple, Optional

import torch

# the records kept; the oldest are dropped first
CAPACITY = 1 << 16


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]
    root: int
    thread: int
    start_ns: int
    end_ns: int


_records: "collections.deque[Span]" = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_local = threading.local()
_OFF = contextlib.nullcontext()


def tracing() -> bool:
    """Whether a profiler runs in this process: the switch of every span."""
    return getattr(torch.autograd.profiler, "_is_profiler_enabled", False)


class _Open:
    """One span while it is open; its parent is the innermost span open on
    the same thread."""

    __slots__ = ("name", "id", "parent", "root", "range", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = up.id if up else None
        self.root = up.root if up else self.id
        stack.append(self)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.start = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        end = time.monotonic_ns()
        self.range.__exit__(*exc)
        _local.stack.pop()
        _records.append(Span(self.name, self.id, self.parent, self.root,
                             threading.get_native_id(), self.start, end))
        return False


def span(name: str):
    """A context manager that records the span ``name`` while a profiler
    runs, and does nothing otherwise."""
    return _Open(name) if tracing() else _OFF


def spans() -> List[Span]:
    """A copy of the records, oldest first."""
    return list(_records)


def clear() -> None:
    _records.clear()
