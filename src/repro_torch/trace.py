"""Spans and counters of the port's serving path.

The engine (``serve/continuous.py``), the decoder stack
(``models/transformer.py``), the flash forward and the kernels' build
(``kernels/``) and ``PlanServer``'s flushes mark their work with
:func:`span` and :func:`count`. Nothing is kept until a recorder is on; an
operator turns one on around a serving loop and writes out what it saw::

    import json
    from repro_torch import trace

    with trace.recording() as rec:
        engine.run()
    with open("spans.json", "w") as f:
        json.dump(rec.export(), f)

The export holds ``spans``, in the order they started, each with its
``name``, ``id``, ``parent`` (the id of the span it opened inside, or
None), ``start`` and ``end`` (seconds on ``time.perf_counter()``, the
clock the engine stamps its requests with) and ``attrs`` (``rid`` for the
work of one request, ``layer``, ``tokens``, ``slots``, ...); and
``counters``, name -> total.

With a recorder on and a ``torch.profiler`` trace active when a span
opens, the span is also a ``torch.profiler.record_function`` range of the
same name: it sits on the device trace's own clock beside the kernels
launched inside it, so the profiler attributes device time and idle gaps
to it. With no trace active the range is left out, since it would cost
more than the rest of the span and reach nothing. Nothing here
synchronises the card or records CUDA events; a span's ``start`` and
``end`` are when the host entered and left it, which for work on the card
is its enqueue.

With no recorder on, :func:`span` returns one shared context that does
nothing and :func:`count` returns at once: the whole cost is a global read
and a call.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function

_CURRENT: Optional["Recorder"] = None
_OFF = contextlib.nullcontext()


class Recorder:
    """The spans and counters of one :func:`recording`, kept in memory."""

    def __init__(self):
        self.spans: List[Dict[str, Any]] = []
        self.counters: Dict[str, int] = {}
        self._ids = itertools.count(1)
        self._local = threading.local()   # each thread's open span ids

    def _stack(self) -> List[int]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def add_span(self, name: str, start: float, end: float,
                 **attrs) -> None:
        """A span that ended before it was recorded, caused by no open
        span (a request's wait in a queue)."""
        self.spans.append({"name": name, "id": next(self._ids),
                           "parent": None, "start": start, "end": end,
                           "attrs": attrs})

    def export(self) -> Dict[str, Any]:
        """``{"spans": [...], "counters": {...}}``, copies that JSON
        writes as they are."""
        return {"spans": [dict(s, attrs=dict(s["attrs"]))
                          for s in self.spans],
                "counters": dict(self.counters)}


class _Span:
    __slots__ = ("rec", "name", "attrs", "entry", "rec_fn")

    def __init__(self, rec: Recorder, name: str, attrs: Dict[str, Any]):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        self.entry = {"name": self.name, "id": next(rec._ids),
                      "parent": stack[-1] if stack else None,
                      "start": 0.0, "end": None, "attrs": self.attrs}
        stack.append(self.entry["id"])
        rec.spans.append(self.entry)
        self.rec_fn = record_function(self.name) if _profiler_enabled() \
            else None
        if self.rec_fn is not None:
            self.rec_fn.__enter__()
        self.entry["start"] = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.entry["end"] = time.perf_counter()
        if self.rec_fn is not None:
            self.rec_fn.__exit__(*exc)
        self.rec._stack().pop()
        return False


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Turn a new :class:`Recorder` on for the block and off after it,
    also when the block raises. One is on at a time: a second
    ``recording()`` inside the first raises."""
    global _CURRENT
    if _CURRENT is not None:
        raise RuntimeError("trace: a recorder is already on")
    rec = _CURRENT = Recorder()
    try:
        yield rec
    finally:
        _CURRENT = None


def span(name: str, **attrs):
    """A context that records ``name`` from its entry to its exit, with
    ``attrs``, in the recorder that is on; with none on, a shared no-op."""
    rec = _CURRENT
    if rec is None:
        return _OFF
    return _Span(rec, name, attrs)


def add_span(name: str, start: float, end: float, **attrs) -> None:
    """:meth:`Recorder.add_span` on the recorder that is on, if any."""
    rec = _CURRENT
    if rec is not None:
        rec.add_span(name, start, end, **attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the recorder that is on, if
    any."""
    rec = _CURRENT
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n
