"""Closed-loop adaptive serving session over real codec bitstreams.

Session / simulator split
-------------------------
``streaming/pipeline.simulate_stream`` is a *byte-count* model: it walks
Algorithm 1 (paper §5.3) over chunk metadata and a bandwidth trace, charging
``nbytes / decode_bytes_per_s`` for decode and a cost-model callable for
recompute, and never touches a bitstream.  :class:`ServeSession` is the
live counterpart of the same loop: identical per-chunk decisions against the
identical trace-driven virtual clock (both drive the *same* loop body —
``pipeline.StreamClock`` — with policies built by ``adaptation.make_policy``,
so decisions match by construction), but every bitstream chunk is actually
fetched from the :class:`~repro_torch.streaming.storage.KVStore`, validated
against the plan (``codec.peek_chunk_header``: level, token count, chunk
identity), decoded through the fused batched path (``codec.decode_chunks``,
kernels K1/K2 → ``Engine.decode_to_cache``), and every TEXT chunk is
actually recomputed with ``Engine.prefill_extend`` (plain attention,
``lm._extend_mha``) on top of the already-materialized prefix.

Work items
----------
The per-chunk loop body lives in :class:`SessionTask`: one in-flight context
load that owns its policy, ``StreamClock``, trace, and double-buffered
:class:`~repro_torch.streaming.streamer.RunSegmenter`, and that ``step()``-s
one chunk at a time, emitting typed *work items* — :class:`RunWork` (a run
of fetched bitstream chunks to decode and land at a token offset) and
:class:`TextWork` (a text chunk to recompute).  :class:`ServeSession` is the
single-request consumer: it executes each item immediately against its own
cache.  Decisions stay per-request, so every load remains
simulator-differential.

Transport
---------
Bitstream fetches go through a pluggable
:class:`~repro_torch.streaming.transport.Transport`: the task *issues* a
chunk's fetch (``fetch_run`` → cancellable handle, I/O on a worker thread)
in one step and *resolves* it in the next, so the returned work items'
decodes overlap the in-flight fetch — and a hedged duplicate fetch is real
duplicated I/O whose loser is cancelled, with the losing attempt's bytes
surfaced as ``SessionResult.duplicate_bytes``.  The default transport is
:class:`~repro_torch.streaming.transport.SimTransport` over the request's
``NetworkModel``, whose completion timing is the simulator's own
``fetch_outcome`` arithmetic — which is what keeps the session
differential-exact against ``simulate_stream``.  TEXT chunks never touch
storage; their modeled transfer is charged straight on the virtual clock
(``StreamClock.virtual_fetch``).  Worker threads move ``bytes`` only; every
decode and cache write runs on the caller's thread, on the engine's device.

Fetch/decode overlap additionally uses the segmenter's double buffering:
fetched chunks accumulate until ``max_run_tokens``, then the run is
dispatched as one batched decode.  A TEXT chunk force-flushes the buffer
first — its ``prefill_extend`` reads the cache at its own token offset, so
all earlier chunks must have landed; the task asserts contiguous segment
coverage with a host-side token counter (reading ``caches.length`` back
would sync the device per segment).

Fault tolerance
---------------
With a ``retry_policy`` (:class:`~repro_torch.streaming.transport.
RetryPolicy`) the task survives injected and real fetch faults
(``streaming/faults.py``): every resolved blob is checksum-gated before
decode, failed attempts are classified (``transport.classify_failure``),
retried with exponential backoff charged to the ``StreamClock``
(Algorithm-1 re-planning sees the lost time), then the chunk is re-decided
with the failed level and everything finer excluded — coarser levels,
ultimately TEXT recompute — and only when every configuration is exhausted
does the task finish with a clean ``SessionResult.status == "failed"``
carrying the realized prefix.  Without a policy the first fetch error
raises straight through ``run()``.

Byte-range resume
-----------------
With a range-capable transport (``supports_range``), a fetch that fails,
times out, is preempted, or is cancelled mid-chunk keeps its realized bytes.
The task verifies the partial payload against the chunk's out-of-band
segment index (``bitstream.SegmentIndex.verified_prefix``) and carries the
verified prefix across attempts — and across suspend/resume — in a
per-chunk salvage slot.  The next attempt then issues a *byte-range* fetch:
``resume`` (same level — refetch only ``[verified_end, total)``),
``compose`` (degraded to a different lossy level — keep the level-invariant
anchor segment, refetch only that level's delta suffix, and splice
``synthesized head + salvaged anchor + new suffix`` into a blob that must
pass the whole-chunk CRC gate before decode), or ``full`` (nothing
salvageable).  ``adaptation.salvage_credit`` tells Algorithm 1 what the
prefix is worth per level so re-decisions price only the bytes still owed.
With ``replan_factor`` set, a fetch running far past the live throughput
estimate is cancelled *mid-chunk* on the virtual clock (§C.1): the prefix
is salvaged, the collapsed throughput is observed, and ``choose_config``
re-decides the remainder — possibly at a coarser level (compose) or as TEXT
recompute (whole chunk: rANS lanes span the full token axis, so a byte
prefix cannot shorten the recompute).  Accounting reconciles per chunk:
``salvaged_bytes + refetched_bytes == wire_bytes``.

The session emits :class:`~repro_torch.streaming.pipeline.ChunkTimeline`-
compatible records (``SessionResult.stream_result()``), so everything that
consumes simulator output reads session output unchanged.  Virtual time
(``ttft_s``) stays simulator-comparable; realized host time is reported
separately (``wall_*``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import bitstream
from repro_torch.core import codec as kvcodec
from repro_torch.models.lm import Caches
from repro_torch.serving.engine import Engine
from repro_torch.streaming.adaptation import (
    TEXT,
    NoFeasibleConfigError,
    make_policy,
    salvage_credit,
)
from repro_torch.streaming.calibration import measured_decode_bytes_per_s
from repro_torch.streaming.network import NetworkModel
from repro_torch.streaming.pipeline import ChunkTimeline, StreamClock, StreamResult
from repro_torch.streaming.streamer import CacheGenStreamer, PlanSegment, RunSegmenter
from repro_torch.streaming.transport import (
    RetryPolicy,
    Salvage,
    SimTransport,
    Transport,
    classify_failure,
)

__all__ = [
    "ServeSession",
    "SessionResult",
    "SessionTask",
    "RunWork",
    "TextWork",
    "validate_blob",
]

# context token ids: a numpy array or a tensor (on any device)
Tokens = Union[np.ndarray, torch.Tensor]

# level 0 is lossless-after-8bit: its anchor stream uses different rANS
# tables, so lossy anchor bytes never compose with it (and vice versa)
_LOSSLESS_LEVEL = 0


@dataclasses.dataclass
class SessionResult:
    """Outcome of one closed-loop context load.

    ``timelines``/``ttft_s`` use the trace-driven virtual clock (fetch) plus
    the simulator's compute charging — directly comparable to
    ``simulate_stream`` output.  ``caches`` is the real materialized serving
    cache; ``wall_*`` are realized host seconds (decode dispatch is
    asynchronous, so per-category times are dispatch times and
    ``wall_total_s`` — measured through a final blocking sync — is the
    end-to-end truth).
    """

    timelines: List[ChunkTimeline]
    configs: List[int]
    ttft_s: float
    slo_s: float
    caches: Caches
    wall_decode_s: float
    wall_recompute_s: float
    wall_total_s: float
    n_runs: int
    # fault tolerance: "ok" or "failed"; a failed load's caches
    # hold only the realized prefix and ttft_s is +inf (an SLO miss)
    status: str = "ok"
    failure: Optional[str] = None
    n_retries: int = 0  # failed attempts that were retried
    n_degrades: int = 0  # level re-decisions forced by exhausted retries
    n_fault_text: int = 0  # chunks that fell all the way back to TEXT
    n_failed_attempts: int = 0  # every fetch attempt that did not deliver
    fault_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    # byte-range resume: verified partial bytes reused instead of
    # refetched, byte-range continuations issued, and §C.1 mid-chunk
    # cancel→re-plan events.  wire/refetched are the full realized ledger
    # (clean chunks contribute their blob size to both); per chunk,
    # salvaged + refetched == wire.
    salvaged_bytes: float = 0.0
    n_resumes: int = 0
    n_mid_chunk_replans: int = 0
    refetched_bytes: float = 0.0
    wire_bytes: float = 0.0

    @property
    def failed(self) -> bool:
        return self.status != "ok"

    @property
    def slo_violated(self) -> bool:
        return self.ttft_s > self.slo_s

    @property
    def total_bytes(self) -> float:
        return sum(t.nbytes for t in self.timelines)

    @property
    def duplicate_bytes(self) -> float:
        """Wire bytes the cancelled hedge losers transferred (hedged I/O
        overhead; 0 when no hedge fired)."""
        return sum(t.duplicate_bytes for t in self.timelines)

    @property
    def n_hedged(self) -> int:
        return sum(1 for t in self.timelines if t.hedged)

    @property
    def n_cold_hits(self) -> int:
        """Chunk fetches that touched the tiered store's cold tier (their
        slower realized timing already fed the throughput estimator)."""
        return sum(1 for t in self.timelines if t.cold_hit)

    def level_histogram(self) -> Dict[int, int]:
        """Realized streaming-config histogram (TEXT keyed as -1)."""
        hist: Dict[int, int] = {}
        for c in self.configs:
            hist[c] = hist.get(c, 0) + 1
        return hist

    def stream_result(self) -> StreamResult:
        """ChunkTimeline-compatible view for simulator-consuming code."""
        return StreamResult(
            timelines=list(self.timelines),
            ttft_s=self.ttft_s,
            configs=list(self.configs),
            slo_s=self.slo_s,
        )


# ---------------------------------------------------------------------------
# Work items: the unit of execution shared by session and scheduler
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RunWork:
    """A run of consecutive fetched bitstream chunks, ready to decode and
    land in the cache at ``[start, end)`` of row ``row``."""

    row: int
    start: int
    end: int
    blobs: List[bytes]
    tables: kvcodec.CodecTables

    @property
    def n_tokens(self) -> int:
        return self.end - self.start


@dataclasses.dataclass
class TextWork:
    """A text chunk ready to recompute (``prefill_extend``) at its own
    token offset on row ``row``.  ``tokens`` is the (batch, Tc) slice."""

    row: int
    start: int
    end: int
    tokens: Tokens

    @property
    def n_tokens(self) -> int:
        return self.end - self.start


def validate_blob(blob: bytes, meta, level: int) -> None:
    """Reject a fetched bitstream that does not match its plan entry.

    The checksum gate runs first: a corrupted blob raises
    ``bitstream.IntegrityError`` here, *before* any header parse or decode
    touches the bytes (corruption is detected, never interpreted).
    """
    with tracing.span("session.validate", bytes=len(blob)):
        _validate_blob(blob, meta, level)


def _validate_blob(blob: bytes, meta, level: int) -> None:
    kvcodec.verify_chunk(blob)
    h = kvcodec.peek_chunk_header(blob)
    # chunk_idx is present on store-written blobs; standalone encodes
    # (no identity known) skip that part of the check.  Missing v1 keys
    # (foreign/corrupt producer) are a mismatch, not a KeyError.
    idx = h.get("chunk_idx", meta.chunk_idx)
    if (
        h.get("level") != level
        or h.get("n_tokens") != meta.n_tokens
        or idx != meta.chunk_idx
    ):
        raise ValueError(
            f"storage returned a mismatched bitstream for chunk "
            f"{meta.chunk_idx}: header level={h.get('level')} "
            f"tokens={h.get('n_tokens')} chunk_idx={h.get('chunk_idx')}, "
            f"plan wants level={level} tokens={meta.n_tokens}"
        )


@dataclasses.dataclass
class _ChunkSalvage:
    """Verified partial bytes of the *current* chunk, carried across fetch
    attempts — and across suspend/resume — until the chunk lands (or falls
    back to TEXT) and :meth:`SessionTask._advance` clears it.

    ``data`` always starts at blob offset 0 and is trimmed to
    ``verified_end`` (a segment boundary of ``index``); bytes past the last
    complete segment are never kept — they re-travel on the resume fetch.
    """

    level: int  # encoding level the salvaged bytes belong to
    data: bytes  # verified prefix, from blob offset 0
    verified_end: int  # == len(data); a SegmentIndex boundary
    index: bitstream.SegmentIndex  # full-blob index at `level`
    total: int  # full blob length at `level`


class SessionTask:
    """One in-flight context load, stepped one chunk at a time.

    Owns everything *per-request*: the Algorithm 1 policy, the trace-driven
    ``StreamClock`` (decide → fetch → charge compute → observe), the
    double-buffered segmenter, and the positional-bookkeeping cursor.  Each
    :meth:`step` advances one chunk and returns the work items whose inputs
    are now fully resolved (possibly none while the double buffer fills).
    The caller decides *how* to execute them: ``ServeSession`` runs each
    immediately; the multi-request schedulers (``serving.scheduler``) batch
    items from many tasks.

    ``compute_scale`` (optional callable) is the live contention hook: the
    clock stretches this task's charged decode/recompute seconds — and the
    remaining-recompute estimate feeding ``choose_config`` — by its current
    value (``pipeline.ContentionModel``), so adaptation under a loaded
    engine sheds compute (TEXT) work exactly like it sheds bytes under a
    collapsing link.

    Stepping is two-phase per bitstream chunk: one :meth:`step` decides the
    chunk's config and *issues* its fetch through the transport (returning
    no work yet — the I/O is now in flight on a worker thread), the next
    resolves the handle, accounts the realized timing on the clock, and
    emits the work items whose inputs are complete.  TEXT chunks resolve in
    a single step (no storage I/O).

    Preemption: a task is resumable mid-load.  :meth:`suspend`
    cancels the in-flight fetch handle (an un-accounted chunk simply gets
    re-decided later — ``decide`` mutates nothing, so rewinding is dropping
    ``_pending``) and freezes the task; :meth:`resume` hands it a new cache
    row and advances the clock frontiers to the resumption instant, with
    everything realized so far — timelines, policy state, the segmenter's
    half-filled buffer — carried across untouched.  The *cache* side of a
    suspension (saving/restoring the realized row prefix) belongs to the
    caller — ``serving.scheduler.ContinuousScheduler`` does it with
    ``Engine.save_row``/``restore_row``.
    """

    def __init__(
        self,
        session: "ServeSession",
        context_id: str,
        tokens: Tokens,
        network: NetworkModel,
        *,
        row: int = 0,
        prior_throughput_gbps: Optional[float] = None,
        start_t: float = 0.0,
        compute_scale: Optional[Callable[[], float]] = None,
        text_scale: Optional[Callable[[], float]] = None,
        transport: Optional[Transport] = None,
        label: Optional[str] = None,
    ):
        self.session = session
        self.context_id = context_id
        self.tokens = tokens
        self.row = row
        self.label = label if label is not None else context_id
        store = session.streamer.store
        self.store = store
        self.metas = store.meta(context_id)
        policy = make_policy(
            store.tables.config.n_levels,
            slo_s=session.slo_s,
            default_level=session.default_level,
            prior_throughput_gbps=prior_throughput_gbps,
            allow_text=session.allow_text,
            adapt=session.adapt,
            fixed_level=session.fixed_level,
        )
        # the simulator's per-chunk loop body, verbatim: decide -> fetch
        # (hedging included) -> charge the virtual compute window -> observe
        self.clock = StreamClock(
            policy=policy,
            network=network,
            decode_bytes_per_s=session.decode_bytes_per_s,
            recompute_s=session.recompute_s,
            hedge_after_s=session.hedge_after_s,
            start_t=start_t,
            compute_scale=compute_scale,
            text_scale=text_scale,
        )
        self.segmenter = RunSegmenter(session.max_run_tokens)
        # the fetch path: explicit transport, or the session's; default is
        # the simulator-exact SimTransport over this request's NetworkModel
        t = transport if transport is not None else session.transport
        self.transport: Transport = (
            t if t is not None else SimTransport(store, network)
        )
        self.timelines: List[ChunkTimeline] = []
        self._i = 0
        self._offset = 0  # tokens whose work items have been emitted
        self._pending = None  # (handle, meta, config, nbytes, scale) in flight
        # preemption bookkeeping (continuous scheduler)
        self.suspended_at: Optional[float] = None
        self.n_preemptions = 0
        self.n_resumes = 0
        self.cancelled_fetches: List[tuple] = []  # (chunk_idx, config)
        # fault-tolerance bookkeeping (active when the session has
        # a retry_policy — without one the legacy raise-through path runs)
        self._failure: Optional[str] = None
        self._banned: set = set()  # configs excluded for the current chunk
        self._attempt = 0  # attempts at the current chunk's current config
        self._chunk_retries = 0  # retries across the current chunk's configs
        self._issue_wall: Optional[float] = None
        self.n_retries = 0
        self.n_degrades = 0
        self.n_fault_text = 0
        self.n_failed_attempts = 0
        self.fault_counts: Dict[str, int] = {}
        # byte-range resume.  _measure: the transport computes
        # segment indexes so partial deliveries are *measurable* (wire
        # ledger); _resumable: verified prefixes are actually *reused*
        # (resume/compose byte-range refetches) instead of thrown away —
        # session.resume_fetch=False keeps whole-blob retries
        # while still measuring the wire, which is what the
        # resume-vs-whole-blob benchmark compares.
        self._measure = (
            session.retry_policy is not None
            and bool(getattr(self.transport, "supports_range", False))
        )
        self._resumable = self._measure and bool(
            getattr(session, "resume_fetch", True)
        )
        self._salvage: Optional[_ChunkSalvage] = None
        self._chunk_wire = 0.0  # realized wire bytes of past attempts
        self._pending_mode = "full"  # issue mode of the in-flight fetch
        self._pending_range: Optional[tuple] = None  # (offset, total)
        self._replanned = False  # one mid-chunk re-plan per chunk
        self.n_fetch_resumes = 0
        self.n_mid_chunk_replans = 0
        self.salvaged_bytes = 0.0
        self.refetched_bytes = 0.0
        self.wire_bytes = 0.0

    @property
    def done(self) -> bool:
        if self._failure is not None:
            return True
        return self._i >= len(self.metas) and self._pending is None

    @property
    def failed(self) -> bool:
        return self._failure is not None

    @property
    def fetch_ready(self) -> bool:
        """True when :meth:`step` would not block on in-flight wall-real
        I/O: no fetch pending, the pending handle already completed, or the
        transport resolves on the virtual clock (blocking costs ~no wall
        time).  The concurrent scheduler uses this to keep a straggling
        socket fetch from convoying other sessions' ready work."""
        if self._pending is None or self._pending[0].done():
            return True
        return not getattr(self.transport, "realtime", False)

    @property
    def next_fetch_t(self) -> float:
        """When this task's next chunk fetch would start (virtual clock)."""
        return self.clock.fetch_t

    @property
    def suspended(self) -> bool:
        return self.suspended_at is not None

    @property
    def realized_tokens(self) -> int:
        """Tokens whose work items have been emitted (and, under the
        schedulers' execute-in-emitting-round discipline, executed) — the
        prefix a row snapshot must cover at suspension."""
        return self._offset

    @property
    def deadline_t(self) -> float:
        """Absolute virtual instant of this request's TTFT SLO."""
        return self.clock.start_t + self.session.slo_s

    def begin_at(self, t: float) -> None:
        """Advance the clock's busy-until frontiers to the admission instant.

        A request admitted later than it arrived (``start_t``) keeps its SLO
        anchored at arrival — ``elapsed_s`` then includes the queue wait —
        but cannot fetch or compute before it holds a row.  No-op when
        ``t <= start_t`` (immediate admission), which is what keeps the
        all-arrivals-at-t0 path bit-identical to the wave scheduler.
        """
        self.clock.fetch_t = max(self.clock.fetch_t, float(t))
        self.clock.compute_t = max(self.clock.compute_t, float(t))

    def peek_pending_end_t(self) -> Optional[float]:
        """Completion instant of the in-flight fetch, when knowable without
        blocking on wall-real I/O: the handle already completed, or the
        transport resolves on the virtual clock.  ``None`` while a wall-real
        fetch is still streaming (its completion is genuinely unknown) or
        when nothing is pending; a failed fetch also reads ``None`` here —
        its error surfaces through :meth:`step`."""
        if self._pending is None:
            return None
        handle = self._pending[0]
        if not handle.done() and getattr(self.transport, "realtime", False):
            return None
        try:
            return handle.result().end_t
        except Exception:
            return None

    def horizon_t(self) -> float:
        """Virtual instant this task next acts: its pending fetch's
        completion when peekable, else its next fetch start — the continuous
        scheduler's admission frontier is the minimum of these over the live
        set."""
        end = self.peek_pending_end_t()
        return self.next_fetch_t if end is None else end

    def suspend(self, now_t: float) -> None:
        """Preempt this task: cancel the in-flight fetch (real I/O stops;
        the chunk is re-decided from scratch on resume) and mark the task
        suspended.  The caller owns the row snapshot (``Engine.save_row``
        over :attr:`realized_tokens`) and the row's release."""
        if self.done:
            raise RuntimeError(
                f"preempting request {self.label!r}: session already "
                f"finished (all {len(self.metas)} chunks realized)"
            )
        if self.suspended:
            raise RuntimeError(
                f"preempting request {self.label!r}: already suspended at "
                f"t={self.suspended_at:.6f}"
            )
        if self._pending is not None:
            handle, m, config, _nbytes, _scale = self._pending
            mode = self._pending_mode
            self._pending = None
            if self._measure:
                # the cancelled fetch's realized prefix survives the
                # preemption: verify it now and park it in the salvage
                # slot — the post-resume re-decision resumes from it
                salv = handle.cancel(float(now_t))
                self._absorb_salvage(salv, config, mode)
            else:
                handle.cancel()
            self.cancelled_fetches.append((m.chunk_idx, config))
        self.suspended_at = float(now_t)
        self.n_preemptions += 1

    def resume(self, row: int, resume_t: float) -> None:
        """Take a (possibly different) row and continue from the suspended
        state: the next :meth:`step` re-decides the interrupted chunk at the
        resumption instant — elapsed SLO time includes the suspension."""
        if not self.suspended:
            state = "finished" if self.done else f"live on row {self.row}"
            raise RuntimeError(
                f"resuming request {self.label!r}: not suspended "
                f"(state: {state})"
            )
        self.row = row
        self.suspended_at = None
        self.n_resumes += 1
        self.begin_at(resume_t)

    def _advance(self, m, config: int, blob: Optional[bytes]) -> List[object]:
        """Segment one accounted chunk and emit any completed work items."""
        if config == TEXT:
            segs = self.segmenter.push(m, TEXT)
        else:
            segs = self.segmenter.push(m, config, blob)
        self._i += 1
        # per-chunk fault state resets once the chunk lands
        self._banned.clear()
        self._attempt = 0
        self._chunk_retries = 0
        self._salvage = None
        self._chunk_wire = 0.0
        self._replanned = False
        self._pending_mode = "full"
        self._pending_range = None
        if self._i == len(self.metas):
            segs = segs + self.segmenter.flush()
        return [self._to_work(s) for s in segs]

    def step(self) -> List[object]:
        """Advance one phase: resolve the in-flight fetch, or decide the
        next chunk (issuing its fetch through the transport).

        Returns the work items now ready to execute (in order); a step that
        only *issues* I/O returns none.  The last chunk also flushes the
        segmenter, so once :attr:`done` every item has been emitted.
        """
        with tracing.span("session.step", req=self.label):
            return self._step()

    def _step(self) -> List[object]:
        if self.suspended:
            raise RuntimeError(
                f"stepping request {self.label!r}: suspended at "
                f"t={self.suspended_at:.6f}; resume() it onto a row first"
            )
        policy = self.session.retry_policy
        if self._pending is not None:
            handle, m, config, nbytes, scale = self._pending
            if policy is None:
                # legacy path: any fetch failure raises straight through
                self._pending = None
                with tracing.span("session.wait", req=self.label):
                    res = handle.result()
                tracing.count("wire_bytes", sum(len(b) for b in res.blobs))
                if self.session.validate_blobs:
                    validate_blob(res.blobs[0], m, config)
                tl = self.clock.account(m, config, nbytes, res, scale)
                tl.cold_hit = getattr(res, "cold_entries", 0) > 0
                self.timelines.append(tl)
                return self._advance(m, config, res.blobs[0])
            return self._resolve_with_policy(
                policy, handle, m, config, nbytes, scale
            )
        if self.done:
            return []
        i = self._i
        m = self.metas[i]
        if policy is not None and (self._banned or self._salvage is not None):
            try:
                config, nbytes, scale = self.clock.decide(
                    self.metas,
                    i,
                    exclude=self._banned,
                    credit=self._credit(m),
                )
            except NoFeasibleConfigError as e:
                return self._fail(e)
            if config == TEXT and self._banned:
                self.n_fault_text += 1
        else:
            config, nbytes, scale = self.clock.decide(self.metas, i)
        if config == TEXT:
            # text is already local — its transfer is modeled, not fetched
            outcome = self.clock.virtual_fetch(nbytes, m.chunk_idx)
            tl = self.clock.account(m, config, nbytes, outcome, scale)
            if policy is not None:
                # any salvaged bitstream bytes are dead weight here (TEXT
                # recomputes the whole chunk); the ledger still counts them
                wire = self._chunk_wire + float(nbytes)
                if self._chunk_wire > 0.0 or self._replanned:
                    tl.wire_bytes = wire
                    tl.refetched_bytes = wire
                    tl.replanned = self._replanned
                self.wire_bytes += wire
                self.refetched_bytes += wire
            self.timelines.append(tl)
            return self._advance(m, TEXT, None)
        self._issue_fetch(m, config, nbytes, scale)
        return []

    def _issue_fetch(self, m, config: int, nbytes: float, scale: float) -> None:
        byte_range = None
        mode = "full"
        sv = self._salvage
        if sv is not None and self._resumable:
            if config == sv.level and 0 < sv.verified_end < sv.total:
                # same level: refetch only the unverified suffix
                byte_range = (sv.verified_end, None)
                mode = "resume"
            elif (
                config != sv.level
                and config != _LOSSLESS_LEVEL
                and sv.level != _LOSSLESS_LEVEL
                and sv.index.anchor_end > sv.index.head.end
                and sv.verified_end >= sv.index.anchor_end
            ):
                # degraded to another lossy level with the whole anchor in
                # hand: keep it, refetch only that level's delta suffix.
                # The range is expressed in the *fine* blob's coordinates;
                # lossy heads re-pack to identical bytes (only the level
                # int changes, same width), so the offsets coincide — and
                # if a pathological table ever breaks that, the composed
                # blob fails the whole-chunk CRC gate and the chunk falls
                # back to a full refetch.
                byte_range = (sv.index.anchor_end, None)
                mode = "compose"
        kw = {}
        if self._measure:
            kw["resumable"] = True
            if byte_range is not None:
                kw["byte_range"] = byte_range
        handle = self.transport.fetch_run(
            self.context_id,
            [(m.chunk_idx, config)],
            start_t=self.clock.fetch_t,
            hedge_after_s=self.session.hedge_after_s,
            **kw,
        )
        self._pending = (handle, m, config, nbytes, scale)
        self._pending_mode = mode
        self._pending_range = (
            (byte_range[0], sv.total) if byte_range is not None else None
        )
        if mode != "full":
            self.n_fetch_resumes += 1
        if self.session.retry_policy is not None:
            self._issue_wall = time.perf_counter()

    # -- fault-tolerant resolve (retry_policy set) -------------------------

    def _resolve_with_policy(
        self, policy: RetryPolicy, handle, m, config, nbytes, scale
    ) -> List[object]:
        realtime = bool(getattr(self.transport, "realtime", False))
        timeout = policy.wall_timeout_s if realtime else None
        mode = self._pending_mode
        try:
            with tracing.span("session.wait", req=self.label):
                res = handle.result(timeout=timeout)
        except Exception as e:
            return self._on_fetch_failure(e, handle, m, config, nbytes, scale)
        tracing.count("wire_bytes", sum(len(b) for b in res.blobs))
        # §C.1 mid-chunk re-plan (virtual clock only): the fetch ran far
        # past what the live estimator predicted — a client watching the
        # socket would have cancelled partway in, kept the verified prefix,
        # and re-decided the remainder
        rf = getattr(self.session, "replan_factor", None)
        est = self.clock.policy.throughput_gbps
        if (
            rf is not None
            and not realtime
            and self._resumable
            and not self._replanned
            and est is not None
            and est > 0.0
        ):
            exp_bytes = (
                float(nbytes)
                if self._pending_range is None
                else float(max(self._pending_range[1] - self._pending_range[0], 1))
            )
            predicted = (
                float(getattr(self.clock.network, "rtt_s", 0.0))
                + exp_bytes * 8.0 / (est * 1e9)
            )
            if res.end_t - res.start_t > rf * predicted:
                return self._replan_mid_chunk(
                    handle, m, config, res, mode, rf * predicted
                )
        # assemble: splice the salvaged prefix in front of a resumed or
        # composed suffix before any verification touches the bytes
        raw = res.blobs[0]
        sv = self._salvage
        blob: Optional[bytes] = raw
        credit_used = 0.0
        if mode == "resume" and sv is not None:
            blob = sv.data[: sv.verified_end] + raw
            credit_used = float(sv.verified_end)
        elif mode == "compose" and sv is not None:
            try:
                head = self._synthesize_head(sv, config, res.seg_index)
                blob = (
                    head
                    + sv.data[sv.index.head.end : sv.index.anchor_end]
                    + raw
                )
                credit_used = float(sv.index.anchor_end - sv.index.head.end)
            except Exception:
                blob = None  # unreadable salvage header — integrity failure
        attempt_wire = float(res.nbytes)
        try:
            if blob is None:
                raise bitstream.IntegrityError(
                    f"chunk {m.chunk_idx}: could not compose salvaged "
                    f"anchor with the level-{config} delta suffix"
                )
            # checksum first (corruption is detected, never interpreted),
            # then the plan match — even with validate_blobs off, corrupt
            # bytes must not reach the rANS decoder.  For resume/compose
            # this whole-blob CRC is also the composition gate: a spliced
            # blob that does not hash like a clean whole-blob fetch never
            # reaches decode.
            kvcodec.verify_chunk(blob)
            if self.session.validate_blobs:
                validate_blob(blob, m, config)
        except ValueError as e:
            if mode != "full":
                # the salvage poisoned the assembly: drop it so the retry
                # ladder refetches the whole blob from byte 0
                self._salvage = None
            self._chunk_wire += attempt_wire
            return self._on_fetch_failure(
                e, handle, m, config, nbytes, scale, res=res, harvest=False
            )
        if (
            policy.timeout_s is not None
            and not realtime
            and res.end_t - res.start_t > policy.timeout_s
        ):
            # virtual-clock stall past the attempt budget: the client would
            # have given up timeout_s in, not waited out the whole stall
            return self._on_fetch_failure(
                TimeoutError(
                    f"fetch of chunk {m.chunk_idx} level {config} took "
                    f"{res.end_t - res.start_t:.3f}s virtual "
                    f"(> timeout {policy.timeout_s}s)"
                ),
                handle, m, config, nbytes, scale, res=res,
            )
        self._pending = None
        tl = self.clock.account(m, config, nbytes, res, scale)
        tl.n_retries = self._chunk_retries
        tl.fault_fallback = bool(self._banned)
        tl.cold_hit = getattr(res, "cold_entries", 0) > 0
        if self._measure:
            wire = self._chunk_wire + attempt_wire
            if self._chunk_wire > 0.0 or mode != "full" or self._replanned:
                tl.wire_bytes = wire
                tl.salvaged_bytes = credit_used
                tl.refetched_bytes = wire - credit_used
                tl.resumed = mode != "full"
                tl.replanned = self._replanned
            self.salvaged_bytes += credit_used
            self.wire_bytes += wire
            self.refetched_bytes += wire - credit_used
        self.timelines.append(tl)
        return self._advance(m, config, blob)

    def _on_fetch_failure(
        self, err, handle, m, config, nbytes, scale, *, res=None, harvest=True
    ) -> List[object]:
        """Classify a failed attempt; retry, degrade, or fail the session.

        Before the retry ladder runs, the attempt's realized bytes are
        harvested: from the error's attached :class:`Salvage`
        (truncate faults carry one), or by asking the handle for the prefix
        realized at the failure/timeout instant.  ``harvest=False`` is the
        verification-failure path — the bytes arrived whole but are
        untrustworthy, so only the wire ledger was charged (by the caller).
        """
        policy = self.session.retry_policy
        kind = classify_failure(err)
        if kind == "fatal":
            raise err  # programming error — never masked by retries
        mode = self._pending_mode
        self._pending = None
        salv: Optional[Salvage] = None
        if self._measure and harvest:
            salv = getattr(err, "salvage", None)
            if salv is None:
                if kind == "timeout" and policy.timeout_s is not None and res is not None:
                    at_t = res.start_t + policy.timeout_s
                else:
                    ft = getattr(err, "fail_t", None)
                    at_t = float(ft) if ft is not None else None
                try:
                    salv = handle.salvage_at(at_t)
                except Exception:
                    salv = None
        if kind == "timeout" and not handle.done():
            # the stalled attempt keeps no claim on the link; its realized
            # prefix (if any) was captured above
            cancelled = handle.cancel()
            if salv is None and self._measure and harvest:
                salv = cancelled
        self._absorb_salvage(salv, config, mode)
        self.n_failed_attempts += 1
        self.fault_counts[kind] = self.fault_counts.get(kind, 0) + 1
        self._attempt += 1

        # detection latency on this task's clock: wall-derived on realtime
        # transports, the timeout budget for a timed-out virtual attempt,
        # else the transport-reported failure instant
        if kind == "timeout" and policy.timeout_s is not None and res is not None:
            detect_s = policy.timeout_s
        elif self._issue_wall is not None and bool(
            getattr(self.transport, "realtime", False)
        ):
            detect_s = max(time.perf_counter() - self._issue_wall, 0.0)
        else:
            fail_t = getattr(err, "fail_t", None)
            if fail_t is None and res is not None:
                fail_t = res.end_t
            detect_s = (
                max(float(fail_t) - self.clock.fetch_t, 0.0)
                if fail_t is not None
                else 0.0
            )

        # "missing" is permanent at this level — retrying the same key
        # cannot succeed, go straight to the degrade ladder
        if kind != "missing" and self._attempt < policy.max_attempts:
            backoff = policy.backoff(self._attempt)
            self.clock.charge_failure(detect_s + backoff)
            if getattr(self.transport, "realtime", False) and backoff > 0:
                time.sleep(min(backoff, 1.0))  # a wall-real link waits it out
            self.n_retries += 1
            self._chunk_retries += 1
            self._issue_fetch(m, config, nbytes, scale)
            return []

        self.clock.charge_failure(detect_s)
        if not policy.degrade:
            return self._fail(err)
        # degrade: ban the failed level and everything finer (a coarser
        # level is a different stored blob and a smaller transfer; TEXT is
        # fetch-free and never banned here) and let Algorithm 1 re-decide
        order = list(self.clock.policy.levels_quality_order)
        if config in order:
            self._banned.update(order[: order.index(config) + 1])
        else:
            self._banned.add(config)
        self._attempt = 0
        self.n_degrades += 1
        return []

    # -- byte-range resume machinery ---------------------------------------

    def _replan_mid_chunk(
        self, handle, m, config, res, mode, cancel_after_s
    ) -> List[object]:
        """Cancel the in-flight chunk on the virtual clock, keep the
        verified prefix, observe the collapsed throughput, and let the next
        :meth:`step` re-decide the remainder (§C.1 generalized)."""
        t_cancel = res.start_t + cancel_after_s
        self._pending = None
        self._replanned = True
        self.n_mid_chunk_replans += 1
        try:
            salv = handle.salvage_at(t_cancel)
        except Exception:
            salv = None
        self._absorb_salvage(salv, config, mode)
        # the spent window is charged like a failed attempt (elapsed_s
        # grows, so the re-decision sees the lost time) ...
        self.clock.charge_failure(max(t_cancel - self.clock.fetch_t, 0.0))
        # ... and the collapse itself is observed: realized prefix bytes
        # over the cancelled window feed the estimator, which is exactly
        # the signal that makes choose_config pick a coarser remainder
        if salv is not None and salv.nbytes_wire > 0 and t_cancel > res.start_t:
            self.clock.policy.observe_throughput(
                float(salv.nbytes_wire) * 8.0 / ((t_cancel - res.start_t) * 1e9)
            )
        return []

    def _absorb_salvage(self, salv: Optional[Salvage], level, mode) -> None:
        """Fold a partial attempt's realized bytes into the chunk's wire
        ledger and — when they verify against the segment index — into the
        cross-attempt salvage slot.

        Corruption is never kept: a complete-but-corrupt segment raises
        inside ``verified_prefix`` and the new bytes are discarded (any
        previously verified salvage stays).  A resumed suffix extends the
        existing prefix; a composed suffix *upgrades* the slot to the new
        level by splicing head+anchor+suffix and re-verifying from byte 0.
        """
        if salv is None:
            return
        self._chunk_wire += float(salv.nbytes_wire)
        if not self._resumable or salv.index is None or not salv.data:
            return
        idx = salv.index
        sv = self._salvage
        try:
            if (
                mode == "resume"
                and sv is not None
                and level == sv.level
                and salv.offset == sv.verified_end
            ):
                data = sv.data[: sv.verified_end] + bytes(salv.data)
            elif mode == "compose" and sv is not None and salv.offset > 0:
                head = self._synthesize_head(sv, level, idx)
                anchor = sv.data[sv.index.head.end : sv.index.anchor_end]
                if len(head) + len(anchor) != salv.offset:
                    return  # geometry mismatch: splice would not align
                data = head + anchor + bytes(salv.data)
            elif salv.offset == 0:
                data = bytes(salv.data)
            else:
                return  # an offset we cannot anchor to anything verified
            ve = idx.verified_prefix(data)
        except bitstream.IntegrityError:
            return  # corrupt partial: keep whatever salvage already exists
        except Exception:
            return
        total = int(salv.total)
        if ve <= 0 or total <= 0:
            return
        self._salvage = _ChunkSalvage(
            level=int(level),
            data=data[:ve],
            verified_end=int(ve),
            index=idx,
            total=total,
        )

    def _synthesize_head(self, sv: _ChunkSalvage, level, idx) -> bytes:
        """Rebuild the target level's head bytes (msgpack framing + header)
        from the salvaged blob's header with only the level swapped —
        byte-exact for lossy↔lossy because the header is a flat map of
        small ints and every lossy level packs to the same width."""
        hdr = dict(kvcodec.peek_chunk_header(bytes(sv.data)))
        hdr["level"] = int(level)
        n_arrays = idx.n_arrays if idx is not None else sv.index.n_arrays
        return bitstream.synthesize_head(hdr, n_arrays)

    def _credit(self, m) -> Optional[Dict[int, float]]:
        """``adaptation.salvage_credit`` for the current chunk, or None."""
        sv = self._salvage
        if sv is None or not self._resumable:
            return None
        return salvage_credit(
            {lvl: float(s) for lvl, s in m.sizes.items()},
            sv.level,
            sv.verified_end,
            sv.index.head.end,
            sv.index.anchor_end,
            lossless_level=_LOSSLESS_LEVEL,
        )

    def _fail(self, err) -> List[object]:
        """Terminal failure: record it, flush the segmenter, and emit the
        valid realized prefix (the schedulers then release this task's row
        without poisoning any batch)."""
        kind = (
            "exhausted"
            if isinstance(err, NoFeasibleConfigError)
            else classify_failure(err)
        )
        self._failure = f"{kind}: {err}"
        self._pending = None
        # the failed chunk's partial deliveries stay on the ledger (all
        # refetched — nothing landed to credit them against)
        if self._chunk_wire > 0.0:
            self.wire_bytes += self._chunk_wire
            self.refetched_bytes += self._chunk_wire
            self._chunk_wire = 0.0
        segs = self.segmenter.flush()
        return [self._to_work(s) for s in segs]

    def _to_work(self, seg: PlanSegment):
        # positional bookkeeping: every segment must start exactly where
        # the materialized prefix ends (host-side counter — reading
        # caches.length here would force a device sync per segment and
        # stall the decode/fetch overlap)
        if seg.start != self._offset:
            raise AssertionError(
                f"segment starts at token {seg.start} but {self._offset} "
                "tokens are materialized; decoded/recomputed chunk "
                "interleaving lost sync"
            )
        self._offset = seg.end
        if seg.kind == "text":
            return TextWork(
                row=self.row,
                start=seg.start,
                end=seg.end,
                tokens=self.tokens[:, seg.start : seg.end],
            )
        return RunWork(
            row=self.row,
            start=seg.start,
            end=seg.end,
            blobs=list(seg.blobs),
            tables=self.store.tables,
        )

    def result(
        self,
        caches: Caches,
        *,
        wall_decode_s: float,
        wall_recompute_s: float,
        wall_total_s: float,
        n_runs: int,
    ) -> SessionResult:
        return SessionResult(
            timelines=list(self.timelines),
            configs=[t.config for t in self.timelines],
            # a failed load never produced a first token: ttft is +inf, so
            # failures always count as SLO misses downstream
            ttft_s=(
                float("inf")
                if self.failed
                else self.clock.ttft_s(self.timelines, self.session.final_step_s)
            ),
            slo_s=self.session.slo_s,
            caches=caches,
            wall_decode_s=wall_decode_s,
            wall_recompute_s=wall_recompute_s,
            wall_total_s=wall_total_s,
            n_runs=n_runs,
            status="failed" if self.failed else "ok",
            failure=self._failure,
            n_retries=self.n_retries,
            n_degrades=self.n_degrades,
            n_fault_text=self.n_fault_text,
            n_failed_attempts=self.n_failed_attempts,
            fault_counts=dict(self.fault_counts),
            salvaged_bytes=self.salvaged_bytes,
            n_resumes=self.n_fetch_resumes,
            n_mid_chunk_replans=self.n_mid_chunk_replans,
            refetched_bytes=self.refetched_bytes,
            wire_bytes=self.wire_bytes,
        )


class ServeSession:
    """Bandwidth-adaptive context load: decide → fetch → decode/recompute.

    One instance is reusable across requests (it holds no per-request
    state); each :meth:`run` builds a fresh :class:`SessionTask` (policy +
    clock + segmenter) and serving cache, and executes the task's work items
    one at a time.  For N concurrent loads sharing one Engine, hand the
    session(s) to a scheduler that executes the same work items batched
    across requests (``serving.scheduler.ConcurrentScheduler``).
    """

    def __init__(
        self,
        streamer: CacheGenStreamer,
        engine: Engine,
        *,
        slo_s: float,
        recompute_s: Callable[[int, int], float],  # (chunk_tokens, prefix) -> s
        decode_bytes_per_s: Optional[float] = None,
        default_level: Optional[int] = None,
        allow_text: bool = True,
        adapt: bool = True,
        fixed_level: Optional[int] = None,
        hedge_after_s: Optional[float] = None,
        final_step_s: float = 0.0,
        max_run_tokens: Optional[int] = None,
        validate_blobs: bool = True,
        transport: Optional[Transport] = None,
        retry_policy: Optional[RetryPolicy] = None,
        resume_fetch: bool = True,
        replan_factor: Optional[float] = None,
    ):
        self.streamer = streamer
        self.engine = engine
        # None -> each run builds a SimTransport over that run's NetworkModel
        # (simulator-differential default); pass LocalTransport for direct
        # reads
        self.transport = transport
        self.slo_s = slo_s
        self.recompute_s = recompute_s
        self.decode_bytes_per_s = (
            decode_bytes_per_s
            if decode_bytes_per_s is not None
            else measured_decode_bytes_per_s()
        )
        self.default_level = default_level
        self.allow_text = allow_text
        self.adapt = adapt
        self.fixed_level = fixed_level
        self.hedge_after_s = hedge_after_s
        self.final_step_s = final_step_s
        self.max_run_tokens = max_run_tokens
        self.validate_blobs = validate_blobs
        # None -> legacy behavior: any fetch failure raises straight through
        # the caller's run loop (pinned by tests).  A RetryPolicy arms the
        # full fault machinery: classify -> bounded retries with backoff
        # charged to the StreamClock -> degrade to coarser levels / TEXT ->
        # clean failure status, never an uncaught exception.
        self.retry_policy = retry_policy
        # byte-range resume (needs retry_policy + a range-capable
        # transport).  resume_fetch=False keeps whole-blob retries
        # (the benchmark baseline) while still measuring the wire ledger.
        # replan_factor arms §C.1 mid-chunk re-planning on virtual-clock
        # transports: an in-flight fetch whose realized duration exceeds
        # replan_factor × the live-estimate prediction is cancelled at that
        # instant, its verified prefix salvaged, and the remainder
        # re-decided (at most once per chunk).  None = off (bit-identical
        # to the pre-resume timing).
        self.resume_fetch = resume_fetch
        self.replan_factor = replan_factor

    # ------------------------------------------------------------------

    def run(
        self,
        context_id: str,
        tokens: Tokens,  # (B, T) full context tokens (for TEXT chunks)
        network: NetworkModel,
        *,
        batch: int = 1,
        prior_throughput_gbps: Optional[float] = None,
        start_t: float = 0.0,
        transport: Optional[Transport] = None,
    ) -> SessionResult:
        caches = self.engine.empty_caches(batch)
        task = SessionTask(
            self,
            context_id,
            tokens,
            network,
            prior_throughput_gbps=prior_throughput_gbps,
            start_t=start_t,
            transport=transport,
        )
        state = _ExecState()
        wall0 = time.perf_counter()
        while not task.done:
            for work in task.step():
                caches = self._execute_one(work, caches, state)
        if caches.kv_k.device.type == "cuda":
            # wall_total_s is end-to-end only once queued device work is done
            torch.cuda.synchronize(caches.kv_k.device)
        wall_total = time.perf_counter() - wall0
        return task.result(
            caches,
            wall_decode_s=state.decode_s,
            wall_recompute_s=state.recompute_s,
            wall_total_s=wall_total,
            n_runs=state.runs,
        )

    # ------------------------------------------------------------------

    def _execute_one(
        self, work, caches: Caches, state: "_ExecState"
    ) -> Caches:
        """Single-request execution of one work item (a scheduler's
        cross-request batched executors are the N>1 counterpart)."""
        if isinstance(work, TextWork):
            t0 = time.perf_counter()
            # prefill_extend clones the cache and returns the extended copy
            _, caches = self.engine.prefill_extend(
                torch.as_tensor(work.tokens, device=self.engine.device).to(torch.int32),
                caches,
            )
            state.recompute_s += time.perf_counter() - t0
        else:
            t0 = time.perf_counter()
            kv_run = kvcodec.decode_chunks(
                work.blobs, work.tables, out_dtype=caches.kv_k.dtype
            )
            # decode_to_cache writes into the cache's tensors in place
            caches = self.engine.decode_to_cache(caches, kv_run, work.start)
            state.decode_s += time.perf_counter() - t0
            state.runs += 1
        return caches


@dataclasses.dataclass
class _ExecState:
    """Mutable per-run execution state: wall-clock accumulators."""

    decode_s: float = 0.0
    recompute_s: float = 0.0
    runs: int = 0
