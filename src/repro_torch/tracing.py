"""Named host spans and counters inside the program, off unless enabled.

    from repro_torch import tracing

    tracing.enable()
    ...                       # the program's own spans and counters record
    tracing.disable()
    spans, counters = tracing.drain()

:func:`span` is a context manager placed where the load path and the decode
step do their work; :func:`count` adds to a named counter.  While tracing
is off (the default) a span reads one module flag and returns a shared
no-op object: no allocation of its own, no clock reading, and never a
device synchronize.  While it is on, each span records its name, its two
stamps in ``time.time_ns()`` (the clock ``torch.profiler`` stamps its
device events in, so program spans and device events lie on one time
axis), the thread it ran on, the index of the span it was opened inside on
that thread (``-1`` for none), and its attributes.  Each thread keeps its
own stack of open spans, so spans opened on a transport's worker thread
have no parent on the main thread.

Nothing here synchronizes the device: a span around work that only
enqueues device kernels measures the host's enqueue, not the kernels.

Records stay in memory until :func:`drain` returns and clears them; call
it when no span is open on another thread.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Tuple

__all__ = ["Span", "enable", "disable", "enabled", "span", "count", "drain"]


class Span(NamedTuple):
    name: str
    t0_ns: int
    t1_ns: int
    thread: int
    parent: int  # index into the drained list, -1 for none
    attrs: dict


_on = False
_records: List[list] = []  # [name, t0, t1, thread, parent record or None, attrs], closed spans
_counters: Dict[str, int] = {}
_lock = threading.Lock()  # counters are added to from worker threads too
_local = threading.local()


class _Off:
    """The span while tracing is off: enters and exits doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("rec", "stack")

    def __init__(self, name: str, attrs: dict):
        self.rec = [name, 0, 0, 0, None, attrs]

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        rec = self.rec
        rec[3] = threading.get_ident()
        rec[4] = stack[-1] if stack else None
        stack.append(rec)
        self.stack = stack
        rec[1] = time.time_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec[2] = time.time_ns()
        self.stack.pop()
        _records.append(rec)
        return False


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def span(name: str, **attrs):
    """A context manager around one piece of the program's work."""
    if not _on:
        return _OFF
    return _On(name, attrs)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name``."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def drain() -> Tuple[List[Span], Dict[str, int]]:
    """The spans closed since the last drain, in order of their start, and
    the counters; both are cleared."""
    global _records, _counters
    with _lock:
        recs, _records = _records, []
        counters, _counters = _counters, {}
    recs.sort(key=lambda r: (r[1], -r[2]))
    index = {id(r): i for i, r in enumerate(recs)}
    spans = [Span(r[0], r[1], r[2], r[3], -1 if r[4] is None else index.get(id(r[4]), -1), r[5])
             for r in recs]
    return spans, counters
