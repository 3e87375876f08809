"""The harness's own spans around the program's entries, the device trace
of a traced run, and the record of the K7 calls a traced window makes.

Spans are host-clock intervals (``time.time_ns``, the clock the profiler
stamps its events in) labelled ``load``, ``question`` and ``step``.  The
device trace is ``torch.profiler`` with the CUDA activity alone (no host
operator events, so the host path is not slowed): each device operation's
name and [start, end) in the same clock.
"""
from __future__ import annotations

import contextlib
import time
from typing import List, Optional, Tuple

__all__ = ["Spans", "DeviceTrace", "K7Calls"]


class Spans:
    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def __call__(self, label: str):
        a = time.time_ns()
        try:
            yield
        finally:
            self.items.append((label, a, time.time_ns()))

    def of(self, label: str) -> List[Tuple[int, int]]:
        return [(a, b) for lab, a, b in self.items if lab == label]

    def label_at(self, t: int) -> str:
        for lab, a, b in self.items:
            if a <= t < b:
                return lab
        return "between"


class DeviceTrace:
    """The profiler's CUDA activity over a window: ``events`` is a list of
    (name, start_ns, end_ns), kernels, copies and fills alike."""

    def __init__(self):
        self.events: List[Tuple[str, int, int]] = []
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0:
                self.events.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        self._prof = None


class K7Calls:
    """While installed, records each ``kernels.ops.rans_decode`` call's
    lanes, symbols a lane and payload words (the K7 launch's shape)."""

    def __init__(self):
        self.calls: List[Tuple[int, int, int]] = []
        self._orig: Optional[object] = None

    def install(self) -> None:
        from repro_torch.kernels import ops

        orig = self._orig = ops.rans_decode

        def recorded(payload, n_words, offsets, state, table_idx, tables, n_sym):
            self.calls.append((int(n_words.shape[0]), int(n_sym), int(payload.numel())))
            return orig(payload, n_words, offsets, state, table_idx, tables, n_sym)

        ops.rans_decode = recorded

    def remove(self) -> None:
        from repro_torch.kernels import ops

        if self._orig is not None:
            ops.rans_decode = self._orig
            self._orig = None
