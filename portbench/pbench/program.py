"""The program's own spans and counters (``repro_torch.tracing``) in a run:
how they are collected, what the readers under ``portbench/metrics/``
make of them, and the idle gaps labelled by the program span the host was
in.

Collection: :class:`ProgramTrace` is the harness's ``DeviceTrace`` that
also switches the program's tracer on when the profiler starts and drains
it when the profiler stops, so only the traced window is recorded and the
warm-up wave never is.  ``record.program`` then holds
``{"spans": [...], "counters": {...}, "main": <thread id>}``.  A program
without ``repro_torch.tracing`` records nothing: ``record.program`` stays
unset and every reader here returns None.

``portbench/trace_program.py`` runs a cell with this collection; the
benchmark's own entry (``run.py``) does not collect yet.
"""
from __future__ import annotations

import bisect
import threading
from typing import List, Optional

from pbench import yardstick
from pbench.tracing import DeviceTrace

__all__ = ["ProgramTrace", "collected", "wave_ms", "crc_passes", "unpack_ms", "per_step_ms", "label_gaps"]


def _tracer():
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing


class ProgramTrace(DeviceTrace):
    """The device trace, and the program's spans and counters over the
    same interval (``program`` after :meth:`stop`; None without a tracer)."""

    def __init__(self):
        super().__init__()
        self.program: Optional[dict] = None

    def start(self) -> None:
        super().start()
        t = _tracer()
        if t is not None:
            t.drain()
            t.enable()

    def stop(self) -> None:
        super().stop()
        t = _tracer()
        if t is not None:
            t.disable()
            spans, counters = t.drain()
            self.program = {"spans": spans, "counters": counters, "main": threading.get_ident()}


def collected(record) -> Optional[dict]:
    """The program's spans inside the window, their counters and the main
    thread, or None where the run collected none."""
    prog = getattr(record, "program", None)
    if not prog or not prog["spans"]:
        return None
    a, b = record.window
    return dict(prog, spans=[s for s in prog["spans"] if a <= s.t0_ns < b])


def _total_ns(spans, name: str) -> int:
    return sum(s.t1_ns - s.t0_ns for s in spans if s.name == name)


def wave_ms(record, name: str) -> Optional[float]:
    """The ``name`` spans of the window, on every thread, summed; a wave."""
    prog = collected(record)
    if prog is None or not record.waves:
        return None
    return _total_ns(prog["spans"], name) / len(record.waves) / 1e6


def unpack_ms(record) -> Optional[float]:
    """``codec.unpack`` less its ``crc`` children: the parse and its
    copies, a wave."""
    prog = collected(record)
    if prog is None or not record.waves:
        return None
    all_spans = record.program["spans"]
    spans = prog["spans"]
    crc = sum(s.t1_ns - s.t0_ns for s in spans
              if s.name == "crc" and s.parent >= 0 and all_spans[s.parent].name == "codec.unpack")
    return (_total_ns(spans, "codec.unpack") - crc) / len(record.waves) / 1e6


def crc_passes(record) -> Optional[float]:
    """Bytes checksummed over bytes handed to the sessions."""
    prog = collected(record)
    if prog is None:
        return None
    wire = prog["counters"].get("wire_bytes", 0)
    return prog["counters"].get("crc_bytes", 0) / wire if wire else None


def per_step_ms(record, name: str) -> Optional[float]:
    """The ``name`` spans of the window summed, over the window's
    ``engine.step`` spans (decode steps)."""
    prog = collected(record)
    if prog is None:
        return None
    n = sum(1 for s in prog["spans"] if s.name == "engine.step")
    return _total_ns(prog["spans"], name) / n / 1e6 if n else None


def _innermost(spans, starts: List[int], order: List[int], t: int) -> Optional[str]:
    """The innermost of one thread's spans (``order``: their indices in
    ``spans``, by start; ``starts`` their starts) that holds ``t``.  One
    thread's spans nest, so it is the latest started by ``t`` or one of
    its ancestors."""
    k = bisect.bisect_right(starts, t) - 1
    i = order[k] if k >= 0 else -1
    while i >= 0:
        s = spans[i]
        if s.t0_ns <= t < s.t1_ns:
            return s.name
        i = s.parent
    return None


def label_gaps(record, top: int = 10) -> List[list]:
    """The window's ``top`` longest device idle gaps as the breakdown gives
    them, ``[label, seconds]``, the harness label followed by ``/`` and the
    innermost program span the main thread was in at the gap's midpoint,
    where it was in one."""
    a, b = record.window
    merged = yardstick.merge_intervals((s, e) for _, s, e in record.device)
    holes = sorted(yardstick.gaps(merged, a, b), key=lambda g: g[0] - g[1])[:top]
    prog = getattr(record, "program", None)
    spans = prog["spans"] if prog else []
    order = [i for i, s in enumerate(spans) if s.thread == prog["main"]] if prog else []
    starts = [spans[i].t0_ns for i in order]
    out = []
    for s, e in holes:
        mid = (s + e) // 2
        label = record.spans.label_at(mid)
        inner = _innermost(spans, starts, order, mid)
        out.append([label if inner is None else f"{label}/{inner}", (e - s) / 1e9])
    return out
