"""Trace-driven network model for KV bitstream streaming.

The paper evaluates under piecewise-constant bandwidth traces (Fig. 7, Fig.
14: per-chunk bandwidth sampled from 0.1–10 Gbps).  ``BandwidthTrace``
integrates transfer time for a byte count starting at any instant and
supports per-fetch latency plus a heavy-tailed straggler model (used by the
hedged-fetch straggler mitigation).

This module is the *virtual-clock* model that ``simulate_stream`` walks.
It is numpy and plain Python only — no torch — so a plan computed here is
equal, not merely close, to the reference package's for the same inputs.

Straggler draws are keyed per ``(chunk_idx, attempt)`` — not consumed from
one shared RNG stream — so hedged and concurrent simulations are
order-independent: the delay a chunk's fetch suffers does not depend on how
many other fetches were simulated first.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "BandwidthTrace",
    "FetchOutcome",
    "NetworkModel",
    "keyed_straggler_delay",
]


@dataclasses.dataclass(frozen=True)
class BandwidthTrace:
    """Piecewise-constant bandwidth.  times[i] is the start of segment i.

    Zero-length segments (``times[i] == times[i+1]``) are permitted — they
    appear when traces are spliced or resampled — and carry no bytes; at a
    duplicated instant the *last* segment starting there is in effect.
    """

    times: np.ndarray  # (N,) seconds, non-decreasing, times[0] == 0
    gbps: np.ndarray  # (N,) bandwidth in Gbit/s for [times[i], times[i+1])

    def __post_init__(self):
        t = np.asarray(self.times, dtype=np.float64)
        g = np.asarray(self.gbps, dtype=np.float64)
        if t.ndim != 1 or t.shape != g.shape or t[0] != 0.0:
            raise ValueError("bad trace")
        if (np.diff(t) < 0).any() or (g <= 0).any():
            raise ValueError("times must be non-decreasing; bandwidth must be positive")
        object.__setattr__(self, "times", t)
        object.__setattr__(self, "gbps", g)

    @staticmethod
    def constant(gbps: float) -> "BandwidthTrace":
        return BandwidthTrace(np.array([0.0]), np.array([float(gbps)]))

    @staticmethod
    def steps(segment_s: float, gbps: Sequence[float]) -> "BandwidthTrace":
        g = np.asarray(list(gbps), dtype=np.float64)
        t = np.arange(len(g)) * float(segment_s)
        return BandwidthTrace(t, g)

    @staticmethod
    def sampled(
        rng: np.random.Generator,
        n_segments: int,
        segment_s: float,
        lo_gbps: float,
        hi_gbps: float,
        log_uniform: bool = True,
    ) -> "BandwidthTrace":
        """Paper Fig. 14 style: per-segment bandwidth ~ U[lo, hi]."""
        if log_uniform:
            g = np.exp(rng.uniform(np.log(lo_gbps), np.log(hi_gbps), n_segments))
        else:
            g = rng.uniform(lo_gbps, hi_gbps, n_segments)
        return BandwidthTrace.steps(segment_s, g)

    def bandwidth_at(self, t: float) -> float:
        i = int(np.searchsorted(self.times, t, side="right") - 1)
        return float(self.gbps[max(i, 0)])

    def transmit_time(self, nbytes: float, start_t: float) -> float:
        """Seconds to push ``nbytes`` starting at ``start_t``."""
        remaining_bits = float(nbytes) * 8.0
        t = float(start_t)
        i = int(np.searchsorted(self.times, t, side="right") - 1)
        i = max(i, 0)
        while remaining_bits > 0:
            rate = self.gbps[i] * 1e9  # bits/s
            seg_end = self.times[i + 1] if i + 1 < len(self.times) else np.inf
            dt_seg = seg_end - t
            bits_seg = rate * dt_seg
            if bits_seg >= remaining_bits:
                t += remaining_bits / rate
                remaining_bits = 0.0
            else:
                remaining_bits -= bits_seg
                t = seg_end
                i += 1
        return t - float(start_t)

    def bytes_in_window(self, duration: float, start_t: float) -> float:
        """Bytes transferable in ``[start_t, start_t + duration)``.

        Byte-integration inverse of :meth:`transmit_time`:
        ``transmit_time(bytes_in_window(d, t), t) == d`` for any ``d > 0``
        (bandwidth is strictly positive on every segment), and
        ``bytes_in_window(transmit_time(nbytes, t), t) == nbytes``.
        """
        t = float(start_t)
        end = t + float(duration)
        i = int(np.searchsorted(self.times, t, side="right") - 1)
        i = max(i, 0)
        bits = 0.0
        while t < end:
            seg_end = self.times[i + 1] if i + 1 < len(self.times) else np.inf
            stop = min(seg_end, end)
            bits += self.gbps[i] * 1e9 * (stop - t)
            t = stop
            i += 1
        return bits / 8.0

    def measured_throughput_gbps(self, nbytes: float, start_t: float) -> float:
        """What a sender would measure for this transfer (paper's estimator)."""
        dur = self.transmit_time(nbytes, start_t)
        if dur <= 0:
            return float(self.gbps[-1])
        return float(nbytes) * 8.0 / dur / 1e9


def keyed_straggler_delay(
    seed: int,
    chunk_idx: int,
    attempt: int,
    *,
    p: float,
    scale_s: float,
    alpha: float,
) -> float:
    """Pareto-tailed straggler stall, keyed per ``(seed, chunk_idx, attempt)``.

    Deterministic in the key and independent of any draw order — the shared
    primitive behind :meth:`NetworkModel.straggler_delay`.
    """
    if p <= 0:
        return 0.0
    rng = np.random.default_rng(
        (int(seed) & 0xFFFFFFFF, int(chunk_idx) & 0xFFFFFFFF, int(attempt) & 0xFF)
    )
    if rng.uniform() >= p:
        return 0.0
    return float(scale_s * (rng.pareto(alpha) + 1.0))


@dataclasses.dataclass(frozen=True)
class FetchOutcome:
    """Resolved timing of one (possibly hedged) fetch on a clock.

    Produced by :meth:`NetworkModel.fetch_outcome` (virtual clock); the
    transports in ``streaming.transport`` report the same fields for
    realized I/O.  ``hedged`` means a duplicate fetch
    was issued *and won*; ``hedge_issued`` counts the duplicate regardless of
    who won; ``duplicate_bytes`` is what the losing attempt transferred
    before being cancelled (0 when no hedge was issued).
    """

    start_t: float
    end_t: float
    throughput_gbps: float
    hedged: bool = False
    hedge_issued: bool = False
    duplicate_bytes: float = 0.0


@dataclasses.dataclass
class NetworkModel:
    """Trace + fixed per-fetch latency + optional straggler tail.

    Straggler model: with prob ``straggler_p`` a fetch stalls for an extra
    Pareto-tailed delay, keyed per ``(chunk_idx, attempt)`` so concurrent /
    hedged simulations are order-independent.  The mitigation (a hedged
    second fetch after ``hedge_after_s``) lives in :meth:`fetch_outcome`,
    used by the virtual-clock simulator (``streaming/pipeline.py``).
    """

    trace: BandwidthTrace
    rtt_s: float = 0.0
    straggler_p: float = 0.0
    straggler_scale_s: float = 1.0
    straggler_alpha: float = 1.5
    seed: int = 0

    def straggler_delay(self, chunk_idx: int, attempt: int = 0) -> float:
        return keyed_straggler_delay(
            self.seed,
            chunk_idx,
            attempt,
            p=self.straggler_p,
            scale_s=self.straggler_scale_s,
            alpha=self.straggler_alpha,
        )

    def fetch_time(
        self,
        nbytes: float,
        start_t: float,
        *,
        chunk_idx: int = 0,
        attempt: int = 0,
        straggle: bool = True,
    ) -> float:
        base = self.rtt_s + self.trace.transmit_time(nbytes, start_t + self.rtt_s)
        extra = self.straggler_delay(chunk_idx, attempt) if straggle else 0.0
        return base + extra

    def fetch_outcome(
        self,
        nbytes: float,
        start_t: float,
        *,
        chunk_idx: int = 0,
        hedge_after_s: Optional[float] = None,
        straggle: bool = True,
    ) -> FetchOutcome:
        """One fetch with optional hedging, resolved on the virtual clock.

        The single source of the hedging arithmetic: a duplicate fetch is
        issued ``hedge_after_s`` after the primary (attempt 1, no straggler
        tail — a fresh replica), the earlier completion wins, and the loser
        is cancelled at the winner's completion instant.  ``duplicate_bytes``
        integrates the trace over the loser's active transfer window
        (straggler stalls are modeled as up-front server stall, during which
        no bytes flow), capped at ``nbytes``.
        """
        base = self.fetch_time(
            nbytes, start_t, chunk_idx=chunk_idx, attempt=0, straggle=straggle
        )
        end_t = start_t + base
        hedged = False
        hedge_issued = False
        duplicate_bytes = 0.0
        if hedge_after_s is not None and base > hedge_after_s:
            hedge_issued = True
            hedged_fetch = hedge_after_s + self.fetch_time(
                nbytes,
                start_t + hedge_after_s,
                chunk_idx=chunk_idx,
                attempt=1,
                straggle=False,
            )
            if hedged_fetch < base:
                # hedge wins; primary is cancelled at the hedge's completion.
                hedged = True
                end_t = start_t + hedged_fetch
                stall = base - self.rtt_s - self.trace.transmit_time(
                    nbytes, start_t + self.rtt_s
                )
                flow_start = start_t + self.rtt_s + stall
                window = end_t - flow_start
                if window > 0:
                    duplicate_bytes = min(
                        float(nbytes),
                        self.trace.bytes_in_window(window, flow_start),
                    )
            else:
                # primary wins; the hedge transferred bytes until cancelled.
                flow_start = start_t + hedge_after_s + self.rtt_s
                window = end_t - flow_start
                if window > 0:
                    duplicate_bytes = min(
                        float(nbytes),
                        self.trace.bytes_in_window(window, flow_start),
                    )
        return FetchOutcome(
            start_t=start_t,
            end_t=end_t,
            throughput_gbps=self.trace.measured_throughput_gbps(
                max(nbytes, 1.0), start_t
            ),
            hedged=hedged,
            hedge_issued=hedge_issued,
            duplicate_bytes=duplicate_bytes,
        )
