"""Async fetch transports for KV bitstreams: the read path as real I/O.

The fetch layer split:

  * :class:`~repro_torch.streaming.storage.StorageBackend` — where blobs
    live (memory, directory);
  * :class:`Transport` — how blobs travel: ``fetch_run(context_id,
    [(chunk, level), ...]) -> FetchHandle``.  A handle is a cancellable,
    in-flight fetch whose :meth:`~FetchHandle.result` carries the realized
    bytes *and* timing (:class:`FetchResult`); :func:`as_completed` yields
    handles in completion order;
  * ``NetworkModel`` (streaming/network.py) — the virtual-clock link model,
    used by the offline simulator and by :class:`SimTransport`'s pacing.

Three transports:

  * :class:`LocalTransport` — direct storage read, no link.  Timing is
    host wall time; the offline ``materialize`` default.
  * :class:`SimTransport` — *real* asynchronous reads (one worker thread
    per attempt, bytes read from the backing store and paced in cancellable
    slices against the ``BandwidthTrace``), with completion timing taken
    from ``NetworkModel.fetch_outcome`` — the identical arithmetic the
    virtual-clock simulator runs.  A SimTransport-backed session therefore
    makes exactly the simulator's per-chunk decisions while its fetches,
    hedges and cancellations are genuinely concurrent I/O.
  * :class:`TcpTransport` — a real socket link to a
    :class:`TcpStoreServer` fronting a ``KVStore`` (length-prefixed frames,
    optional server-side pacing + keyed straggler stalls).  Timing is
    measured off the wire, so the session's throughput estimator sees an
    actual link.

Hedging is transport-level I/O, not clock arithmetic: pass
``hedge_after_s`` to :meth:`Transport.fetch_run` and the transport issues
a duplicate attempt after that delay, uses the winner's bytes,
*cancels* the loser (sim: its paced read stops; tcp: its socket is closed
mid-stream), and reports the loser's transferred bytes as
``duplicate_bytes``.

Worker threads (and the TCP server's threads) only read, slice, send and
checksum ``bytes``; no CUDA tensor crosses a thread — decodes and cache
writes stay on the caller's thread.

Failure model.  A fetch can fail five ways, and each maps to one
:func:`classify_failure` kind a retry loop acts on:

  * ``"missing"`` (``KeyError``) — the store has no such ``(context, chunk,
    level)``.  Permanent at that level.
  * ``"integrity"`` (``bitstream.IntegrityError`` / plan-mismatch
    ``ValueError``) — bytes arrived but are corrupt or are the wrong blob.
    Retryable.
  * ``"timeout"`` (``TimeoutError``) — the attempt out-waited its budget.
    Retryable; the in-flight handle is cancelled first.
  * ``"io"`` (:class:`FetchError`, ``ConnectionError``, ``OSError``) — the
    link died.  Retryable.
  * ``"fatal"`` (anything else) — a programming error; never masked.

Retryable kinds are retried up to :class:`RetryPolicy` bounds with
exponential backoff; detection latency + backoff are charged to the
session's ``StreamClock`` so Algorithm-1 re-planning sees the lost time.
Once the per-level budget is exhausted the chunk is re-decided with that
level (and everything finer) excluded — coarser levels, ultimately TEXT
recompute.

Byte-range resume.  ``fetch_run(..., byte_range=(offset, length_or_None),
resumable=True)`` fetches a slice of a single chunk's blob and/or asks for
the blob's :class:`~repro_torch.core.bitstream.SegmentIndex` as fetch
metadata (``FetchResult.seg_index``).  A cancelled attempt returns a
:class:`Salvage` — the raw realized payload prefix, its absolute blob
offset, and the index — which ``SegmentIndex.verified_prefix`` resolves
into complete CRC-verified segments plus a resume offset.  Transports
advertise the capability with a ``supports_range`` class attribute.

Versioned range-request frame (tcp).  Request: one msgpack frame
``{cid, chunks, straggle, attempt[, hashes][, range: [offset, length|0]]
[, want_idx: true]}``; ``length 0`` means to-end.  Response header:
``{ok, sizes[, total, idx]}`` (or ``{ok: false, error}``) — ``total`` (the
full blob length) and ``idx`` (the segment index, wire form) are present
only when the request carried ``range``/``want_idx``.  Version tolerance is
by omission on both sides: an old server ignores the extra request keys and
streams the whole blob (the client detects the missing ``total`` and treats
the response as a whole-blob fetch from offset 0); an old client never
sends them.  Frames are packed and parsed by the port's own msgpack subset
(``core/_msgpack.py``), byte for byte as ``msgpack.packb`` packs them; a
frame that does not parse, or holds bytes after its object, is malformed.
"""
from __future__ import annotations

import dataclasses
import logging
import socket
import struct
import threading
import time
from typing import List, Optional, Protocol, Sequence, Tuple, runtime_checkable

from repro_torch import tracing
from repro_torch.core import _msgpack
from repro_torch.core.bitstream import IntegrityError, SegmentIndex, segment_index
from repro_torch.streaming.network import NetworkModel, keyed_straggler_delay
from repro_torch.streaming.storage import KVStore

__all__ = [
    "FetchError",
    "FetchHandle",
    "FetchResult",
    "LocalTransport",
    "RetryPolicy",
    "Salvage",
    "SimTransport",
    "TcpStoreServer",
    "TcpTransport",
    "Transport",
    "as_completed",
    "classify_failure",
]

logger = logging.getLogger(__name__)

ChunkLevels = Sequence[Tuple[int, int]]  # [(chunk_idx, level), ...]


class FetchError(RuntimeError):
    """A fetch failed or was cancelled before completing.

    Carries the context id and ``(chunk, level)`` list when the issuing
    transport knows them, so failures under concurrency are attributable;
    ``fail_t`` (when set) is the transport-clock instant the failure was
    detected — what the session charges to its ``StreamClock``.
    """

    def __init__(
        self,
        message: str,
        *,
        context_id: Optional[str] = None,
        chunk_levels: Optional[ChunkLevels] = None,
        fail_t: Optional[float] = None,
        salvage: Optional["Salvage"] = None,
    ):
        detail = ""
        if context_id is not None or chunk_levels is not None:
            parts = []
            if context_id is not None:
                parts.append(f"context {context_id!r}")
            if chunk_levels is not None:
                parts.append(f"(chunk, level)={[tuple(c) for c in chunk_levels]}")
            detail = f" [{', '.join(parts)}]"
        super().__init__(message + detail)
        self.context_id = context_id
        self.chunk_levels = list(chunk_levels) if chunk_levels is not None else None
        self.fail_t = fail_t
        self.salvage = salvage  # realized prefix delivered before the failure


@dataclasses.dataclass
class Salvage:
    """The realized remainder of a failed, cancelled, or abandoned fetch.

    ``data`` is the raw realized payload prefix — *unverified*; the caller
    resolves it into complete segments plus a resume offset via
    ``index.verified_prefix(data, offset)``.  ``offset`` is the absolute
    blob offset where ``data`` begins (0 for a whole-blob attempt, the
    requested range offset for a resume attempt); ``total`` is the full
    blob length when known (0 otherwise).  ``nbytes_wire`` is what this
    attempt actually cost on the wire — the reconciliation ledger's input
    (``salvaged + refetched == realized wire bytes``).
    """

    data: bytes
    offset: int = 0
    total: int = 0
    index: Optional[SegmentIndex] = None
    nbytes_wire: float = 0.0


def classify_failure(err: BaseException) -> str:
    """Map a fetch exception to a retry-machinery kind (see module docstring).

    Order matters: ``IntegrityError`` is a ``ValueError``, and ``FetchError``
    is a ``RuntimeError`` — most-specific first.
    """
    if isinstance(err, KeyError):
        return "missing"
    if isinstance(err, IntegrityError):
        return "integrity"
    if isinstance(err, TimeoutError):
        return "timeout"
    if isinstance(err, (FetchError, ConnectionError, OSError)):
        return "io"
    if isinstance(err, ValueError):
        return "integrity"  # plan/header mismatch: wrong blob delivered
    return "fatal"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded-retry budget for one chunk fetch at one level.

    ``max_attempts`` counts total tries (1 = no retry); ``backoff(k)`` is the
    pause charged before re-attempt ``k`` (exponential).  ``timeout_s``
    bounds a *virtual-clock* attempt (sim transport: a stall that resolves
    past it is treated as a timeout failure); ``wall_timeout_s`` bounds a
    *wall-clock* attempt on realtime transports.
    ``degrade=False`` disables the coarser-level/TEXT fallback — the session
    fails cleanly once retries are exhausted.
    """

    max_attempts: int = 3
    backoff_s: float = 0.02
    backoff_mult: float = 2.0
    timeout_s: Optional[float] = None
    wall_timeout_s: Optional[float] = None
    degrade: bool = True

    def backoff(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based: first retry = 1)."""
        return self.backoff_s * self.backoff_mult ** max(attempt - 1, 0)


@dataclasses.dataclass
class FetchResult:
    """Realized outcome of one (possibly hedged) run fetch.

    ``blobs`` are in request order.  ``end_t``/``throughput_gbps`` are on
    the transport's clock (wall-derived for :class:`LocalTransport`) and are
    exactly the fields ``StreamClock.account`` consumes.
    ``duplicate_bytes`` is what a cancelled losing hedge attempt
    transferred; ``loser_bytes_read`` is the realized byte counter of that
    attempt's reader.
    """

    blobs: List[bytes]
    nbytes: int
    start_t: float
    end_t: float
    throughput_gbps: float
    hedged: bool = False
    hedge_issued: bool = False
    duplicate_bytes: float = 0.0
    wall_s: float = 0.0
    winner: str = "primary"  # "primary" | "hedge"
    loser_cancelled: bool = False
    loser_bytes_read: int = 0
    completion_order: Tuple[int, ...] = ()  # chunk_idx in arrival order
    cold_entries: int = 0  # entries served from a cold storage tier
    seg_index: Optional[SegmentIndex] = None  # when resumable was requested
    range_offset: int = 0  # absolute blob offset blobs[0] begins at
    range_total: int = 0  # full blob length for a range fetch (0 = whole)


@runtime_checkable
class Transport(Protocol):
    """Pluggable fetch path: issue a run fetch, get a cancellable handle.

    Implementations that understand ``byte_range``/``resumable`` set a
    ``supports_range = True`` class attribute; callers gate on it.
    """

    def fetch_run(
        self,
        context_id: str,
        chunk_levels: ChunkLevels,
        *,
        start_t: float = 0.0,
        hedge_after_s: Optional[float] = None,
    ) -> "FetchHandle":
        ...

    def close(self) -> None:
        ...


class FetchHandle:
    """One in-flight run fetch: wait on it, or cancel it.

    ``result()`` blocks until the winning attempt completes and returns the
    :class:`FetchResult`; ``cancel()`` aborts every attempt (a subsequent
    ``result()`` raises :class:`FetchError`).  ``add_done_callback`` powers
    :func:`as_completed`.
    """

    def __init__(
        self,
        context_id: Optional[str] = None,
        chunk_levels: Optional[ChunkLevels] = None,
    ):
        self._done = threading.Event()
        self._result: Optional[FetchResult] = None
        self._error: Optional[BaseException] = None
        self._callbacks: List = []
        self._lock = threading.Lock()
        self.context_id = context_id
        self.chunk_levels = list(chunk_levels) if chunk_levels is not None else None

    # -- completion plumbing (transport side) ------------------------------

    def _finish(self, result: Optional[FetchResult], error=None) -> None:
        with self._lock:
            if self._done.is_set():
                return
            self._result = result
            self._error = error
            self._done.set()
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            cb(self)

    # -- consumer side -----------------------------------------------------

    def done(self) -> bool:
        return self._done.is_set()

    def add_done_callback(self, cb) -> None:
        with self._lock:
            if not self._done.is_set():
                self._callbacks.append(cb)
                return
        cb(self)

    def result(self, timeout: Optional[float] = None) -> FetchResult:
        if not self._done.wait(timeout):
            raise TimeoutError("fetch still in flight")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result

    def salvage_at(self, at_t: Optional[float] = None) -> Optional["Salvage"]:
        """Realized payload prefix of a single-chunk fetch at transport time
        ``at_t`` (None = everything realized so far / by completion).

        Base transports cannot salvage — returns None; range-capable
        transports override.  Valid whether the fetch is in flight, failed,
        or already complete (a *completed* fetch salvages its full payload,
        which is what lets a preempted session keep a finished-but-unused
        fetch across suspend/resume).
        """
        return None

    def cancel(self, at_t: Optional[float] = None) -> Optional["Salvage"]:
        """Abort all attempts; a pending ``result()`` raises FetchError.

        Returns the realized, resumable prefix (see :meth:`salvage_at`)
        instead of discarding it — ``at_t`` bounds the salvage on the
        transport's clock for virtual-time cancellation.
        """
        salvage = self.salvage_at(at_t)
        self._abort()
        self._finish(None, FetchError(
            "fetch cancelled by caller",
            context_id=self.context_id,
            chunk_levels=self.chunk_levels,
            salvage=salvage,
        ))
        return salvage

    def _abort(self) -> None:  # transport-specific teardown
        pass


def as_completed(handles: Sequence[FetchHandle], timeout: Optional[float] = None):
    """Yield handles in the order their fetches complete.

    ``timeout`` bounds the *total* wait across all handles; on expiry a
    ``TimeoutError`` is raised (matching :meth:`FetchHandle.result`).
    """
    import queue

    deadline = None if timeout is None else time.monotonic() + timeout
    q: "queue.Queue[FetchHandle]" = queue.Queue()
    for h in handles:
        h.add_done_callback(q.put)
    for _ in range(len(handles)):
        try:
            if deadline is None:
                yield q.get()
            else:
                yield q.get(timeout=max(deadline - time.monotonic(), 0.0))
        except queue.Empty:
            raise TimeoutError(
                "fetches still in flight past as_completed timeout"
            ) from None


def _clamp_range(
    byte_range: Tuple[int, Optional[int]], blob_len: int
) -> Tuple[int, int]:
    """Resolve a ``(offset, length_or_None)`` request against a blob length.

    ``length`` of None (or <= 0) means to-end; offsets are clamped so a
    stale request (e.g. a resume offset past a shrunken blob) degrades to
    an empty slice rather than an exception.
    """
    off, ln = byte_range
    off = max(0, min(int(off), blob_len))
    if ln is None or int(ln) <= 0:
        return off, blob_len
    return off, min(off + int(ln), blob_len)


def _probe_cold(store, context_id: str, chunk_levels: ChunkLevels) -> int:
    """How many of a run's entries would be served cold right now (0 for a
    flat store — only a tiered store exposes ``tier_penalty``)."""
    penalty = getattr(store, "tier_penalty", None)
    if not callable(penalty):
        return 0
    try:
        return penalty(context_id, chunk_levels)[1]
    except Exception:
        return 0


# ---------------------------------------------------------------------------
# LocalTransport: direct store read
# ---------------------------------------------------------------------------


class LocalTransport:
    """Direct storage reads — no link between the store and the consumer.

    Fetches still run on a worker thread (handles are uniformly async and
    cancellable), but there is nothing to pace: ``end_t`` advances by the
    realized host read time.  The worker only reads and checksums bytes;
    every CUDA call stays on the caller's thread.
    """

    realtime = False  # resolving a handle costs ~no wall time
    supports_range = True

    def __init__(self, store: KVStore):
        self.store = store

    def fetch_run(
        self,
        context_id: str,
        chunk_levels: ChunkLevels,
        *,
        start_t: float = 0.0,
        hedge_after_s: Optional[float] = None,  # no link -> nothing to hedge
        byte_range: Optional[Tuple[int, Optional[int]]] = None,
        resumable: bool = False,
    ) -> FetchHandle:
        chunk_levels = list(chunk_levels)
        if byte_range is not None and len(chunk_levels) != 1:
            raise ValueError("byte-range fetch is single-chunk only")
        handle = FetchHandle(context_id, chunk_levels)

        def work():
            # tier probe before the reads promote everything hot; wall
            # timing below then includes the cold tier's actual read cost
            cold_entries = _probe_cold(self.store, context_id, chunk_levels)
            t0 = time.perf_counter()
            try:
                with tracing.span("transport.fetch", ctx=context_id, chunks=len(chunk_levels)):
                    blobs = [
                        self.store.get_kv(context_id, ci, lvl)
                        for ci, lvl in chunk_levels
                    ]
            except BaseException as e:  # surfaced at result()
                handle._finish(None, e)
                return
            seg_idx = None
            range_offset = range_total = 0
            if len(blobs) == 1 and (resumable or byte_range is not None):
                full = blobs[0]
                if resumable:
                    seg_idx = segment_index(full)
                if byte_range is not None:
                    off, end = _clamp_range(byte_range, len(full))
                    blobs = [full[off:end]]
                    range_offset, range_total = off, len(full)
            wall = time.perf_counter() - t0
            nbytes = sum(len(b) for b in blobs)
            handle._finish(FetchResult(
                blobs=blobs,
                nbytes=nbytes,
                start_t=start_t,
                end_t=start_t + wall,
                throughput_gbps=nbytes * 8.0 / max(wall, 1e-9) / 1e9,
                wall_s=wall,
                completion_order=tuple(ci for ci, _ in chunk_levels),
                cold_entries=cold_entries,
                seg_index=seg_idx,
                range_offset=range_offset,
                range_total=range_total,
            ))

        threading.Thread(target=work, daemon=True).start()
        return handle

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# SimTransport: paced async reads against a BandwidthTrace
# ---------------------------------------------------------------------------


class _Attempt:
    """One attempt's paced read: real bytes off the store, real slices,
    really cancellable.  ``time_scale`` maps virtual seconds to host sleep
    (0 = read at host speed, timing stays purely virtual)."""

    def __init__(self, nbytes: int, duration_s: float, time_scale: float):
        self.nbytes = nbytes
        self.duration_s = max(float(duration_s), 0.0)
        self.time_scale = time_scale
        self.bytes_read = 0
        self.error: Optional[BaseException] = None
        self.cancelled = threading.Event()
        self.finished = threading.Event()

    def run(self, read_blobs) -> None:
        try:
            blobs = read_blobs()
        except BaseException as e:
            self.error = e
            self.finished.set()
            return
        # pace the payload in cancellable slices proportional to the
        # attempt's share of its (virtual) transfer window
        n_slices = 16 if self.time_scale > 0 else 1
        sleep_per = self.duration_s * self.time_scale / n_slices
        total = sum(len(b) for b in blobs)
        for s in range(n_slices):
            if self.cancelled.is_set():
                self.finished.set()
                return
            if sleep_per > 0:
                time.sleep(sleep_per)
            self.bytes_read = min(total, (total * (s + 1)) // n_slices)
        self.bytes_read = total
        self.blobs = blobs
        self.finished.set()


class _SimHandle(FetchHandle):
    def __init__(self, attempts: List[_Attempt], context_id=None, chunk_levels=None):
        super().__init__(context_id, chunk_levels)
        self._attempts = attempts
        self._salvage_fn = None  # set by the transport when salvageable

    def salvage_at(self, at_t: Optional[float] = None) -> Optional[Salvage]:
        if self._salvage_fn is None:
            return None
        return self._salvage_fn(at_t)

    def _abort(self) -> None:
        for a in self._attempts:
            a.cancelled.set()


class SimTransport:
    """Trace-paced asynchronous reads over a :class:`KVStore`.

    Completion timing comes from ``NetworkModel.fetch_outcome`` — the exact
    arithmetic the virtual-clock simulator uses, straggler draws keyed per
    (chunk_idx, attempt) — so sessions fetching through this transport make
    the simulator's decisions on the same trace, while the bytes genuinely
    move on worker threads: the primary attempt reads and paces, a hedge
    attempt (when ``hedge_after_s`` fires) races it, and the virtual loser's
    read is cancelled mid-pace.  ``time_scale`` scales virtual seconds into
    real host sleep (default 0: no sleeping, timing stays virtual).
    """

    def __init__(
        self,
        store: KVStore,
        network: NetworkModel,
        *,
        time_scale: float = 0.0,
    ):
        self.store = store
        self.network = network
        self.time_scale = float(time_scale)
        # paced reads take real wall time; unpaced handles resolve ~instantly
        self.realtime = self.time_scale > 0

    supports_range = True

    def fetch_run(
        self,
        context_id: str,
        chunk_levels: ChunkLevels,
        *,
        start_t: float = 0.0,
        hedge_after_s: Optional[float] = None,
        byte_range: Optional[Tuple[int, Optional[int]]] = None,
        resumable: bool = False,
    ) -> FetchHandle:
        chunk_levels = list(chunk_levels)
        if byte_range is not None and len(chunk_levels) != 1:
            raise ValueError("byte-range fetch is single-chunk only")
        if byte_range is not None:
            hedge_after_s = None  # a resumed suffix is never hedged
        salvageable = resumable and len(chunk_levels) == 1
        read_full = lambda: [  # noqa: E731
            self.store.get_kv(context_id, ci, lvl) for ci, lvl in chunk_levels
        ]
        # one cell per concern, filled when the worker's read realizes the
        # blob: the segment index (metadata, unpriced) and the range span
        idx_cell: List[Optional[SegmentIndex]] = [None]
        span_cell: List[Tuple[int, int]] = [(0, 0)]  # (range_offset, total)

        def read():
            blobs = read_full()
            if len(blobs) == 1 and (resumable or byte_range is not None):
                full = blobs[0]
                if resumable:
                    idx_cell[0] = segment_index(full)
                if byte_range is not None:
                    off, end = _clamp_range(byte_range, len(full))
                    span_cell[0] = (off, len(full))
                    blobs = [full[off:end]]
            return blobs

        # sizes are needed up front to price the transfer; metadata is the
        # frontend's job, the blob bytes still travel through the attempts
        try:
            try:
                metas = self.store.meta(context_id)
                full_nbytes = sum(
                    metas[ci].sizes[lvl] for ci, lvl in chunk_levels
                )
            except (KeyError, IndexError):
                full_nbytes = sum(len(b) for b in read_full())
        except KeyError as e:
            # 404 after one round trip on the virtual clock
            e.fail_t = start_t + float(getattr(self.network, "rtt_s", 0.0))
            failed = FetchHandle(context_id, chunk_levels)
            failed._finish(None, e)
            return failed
        if byte_range is not None:
            # the link only carries the requested slice
            off, end = _clamp_range(byte_range, int(full_nbytes))
            nbytes = end - off
        else:
            nbytes = full_nbytes
        key_chunk = chunk_levels[0][0] if chunk_levels else 0

        # a tiered store's entries that are not hot pay its cold tier's
        # modeled read surcharge, folded into the fetch's virtual timing
        # *before* the reads below promote them; a flat store has no
        # tier_penalty and pays nothing
        tier_penalty = getattr(self.store, "tier_penalty", None)
        tier_extra_s, cold_entries = (
            tier_penalty(context_id, chunk_levels)
            if callable(tier_penalty)
            else (0.0, 0)
        )

        # virtual truth, computed once at issue: who wins, and when
        outcome = self.network.fetch_outcome(
            float(nbytes), start_t, chunk_idx=key_chunk,
            hedge_after_s=hedge_after_s,
        )
        if tier_extra_s > 0:
            end_t = outcome.end_t + tier_extra_s
            dur = max(end_t - start_t, 1e-9)
            outcome = dataclasses.replace(
                outcome,
                end_t=end_t,
                throughput_gbps=float(nbytes) * 8.0 / dur / 1e9,
            )
        primary_dur = self.network.fetch_time(
            float(nbytes), start_t, chunk_idx=key_chunk, attempt=0
        ) + tier_extra_s
        hedge_issued = outcome.hedge_issued
        attempts = [_Attempt(nbytes, primary_dur, self.time_scale)]
        if hedge_issued:
            hedge_dur = self.network.fetch_time(
                float(nbytes), start_t + (hedge_after_s or 0.0),
                chunk_idx=key_chunk, attempt=1, straggle=False,
            )
            attempts.append(_Attempt(nbytes, hedge_dur, self.time_scale))
        handle = _SimHandle(attempts, context_id, chunk_levels)
        winner_i = 1 if outcome.hedged else 0

        if salvageable or byte_range is not None:
            # bytes start flowing one RTT (plus any up-front stall and cold
            # surcharge) after issue; what has crossed the link by virtual
            # time t is the trace's byte integral over [flow_start, t) —
            # the same arithmetic fetch_outcome charges for a hedge loser
            flow_start = (
                start_t
                + float(getattr(self.network, "rtt_s", 0.0))
                + self.network.straggler_delay(key_chunk, attempt=0)
                + tier_extra_s
            )

            def salvage_fn(at_t: Optional[float]) -> Optional[Salvage]:
                a = attempts[0]
                if not a.finished.is_set():
                    a.finished.wait(timeout=5.0)
                if a.error is not None or not hasattr(a, "blobs"):
                    return None  # the read itself failed: nothing realized
                payload = b"".join(a.blobs)
                if at_t is None:
                    realized = len(payload)
                else:
                    realized = 0 if at_t <= flow_start else min(
                        len(payload),
                        int(self.network.trace.bytes_in_window(
                            at_t - flow_start, flow_start
                        )),
                    )
                if realized <= 0:
                    return None
                off, total = span_cell[0]
                return Salvage(
                    data=payload[:realized],
                    offset=off,
                    total=total or (len(payload) if byte_range is None else 0),
                    index=idx_cell[0],
                    nbytes_wire=float(realized),
                )

            handle._salvage_fn = salvage_fn

        def coordinate():
            threads = []
            for i, a in enumerate(attempts):
                th = threading.Thread(target=a.run, args=(read,), daemon=True)
                threads.append(th)
                if i == 0:
                    th.start()
            if hedge_issued:
                # the duplicate is issued hedge_after_s after the primary
                # (scaled into host time when pacing is on)
                if self.time_scale > 0 and hedge_after_s:
                    attempts[0].finished.wait(hedge_after_s * self.time_scale)
                threads[1].start()
            winner = attempts[winner_i]
            winner.finished.wait()
            # cancel the loser(s) at the winner's completion instant
            for i, a in enumerate(attempts):
                if i != winner_i:
                    a.cancelled.set()
            if winner.error is not None:
                # bytes travelled (or the read failed) on the virtual window;
                # the failure is detected at the transfer's modeled end
                if getattr(winner.error, "fail_t", None) is None:
                    try:
                        winner.error.fail_t = outcome.end_t
                    except AttributeError:
                        pass  # exception type with __slots__
                handle._finish(None, winner.error)
                return
            if winner.cancelled.is_set() or not hasattr(winner, "blobs"):
                handle._finish(None, FetchError(
                    "fetch was cancelled",
                    context_id=context_id,
                    chunk_levels=chunk_levels,
                    fail_t=outcome.end_t,
                ))
                return
            loser = attempts[1 - winner_i] if hedge_issued else None
            handle._finish(FetchResult(
                blobs=winner.blobs,
                nbytes=nbytes,
                start_t=start_t,
                end_t=outcome.end_t,
                throughput_gbps=outcome.throughput_gbps,
                hedged=outcome.hedged,
                hedge_issued=hedge_issued,
                duplicate_bytes=outcome.duplicate_bytes,
                wall_s=0.0,
                winner="hedge" if outcome.hedged else "primary",
                loser_cancelled=loser.cancelled.is_set() if loser else False,
                loser_bytes_read=loser.bytes_read if loser else 0,
                completion_order=tuple(ci for ci, _ in chunk_levels),
                cold_entries=cold_entries,
                seg_index=idx_cell[0],
                range_offset=span_cell[0][0],
                range_total=span_cell[0][1],
            ))

        threading.Thread(target=coordinate, daemon=True).start()
        return handle

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# TcpTransport: a real socket link
# ---------------------------------------------------------------------------

_LEN = struct.Struct(">I")


def _recv_exact(sock: socket.socket, n: int, counter=None) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        part = sock.recv(min(65536, n - len(buf)))
        if not part:
            raise ConnectionError("peer closed mid-frame")
        buf += part
        if counter is not None:
            counter[0] += len(part)
    return bytes(buf)


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_frame(sock: socket.socket, counter=None) -> bytes:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size, counter))
    return _recv_exact(sock, n, counter)


def _recv_frame_into(sock: socket.socket, counter, buf: bytearray) -> bytes:
    """Receive one frame, appending payload bytes to ``buf`` *as they
    arrive* — a stream severed mid-frame leaves its realized prefix in
    ``buf`` for salvage instead of losing it inside the exception."""
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size, counter))
    start = len(buf)
    while len(buf) - start < n:
        part = sock.recv(min(65536, n - (len(buf) - start)))
        if not part:
            raise ConnectionError("peer closed mid-frame")
        buf += part
        if counter is not None:
            counter[0] += len(part)
    return bytes(buf[start:start + n])


class TcpStoreServer:
    """Length-prefixed socket server fronting a :class:`KVStore`.

    Request: one msgpack frame ``{cid, chunks: [[ci, lvl], ...], straggle,
    attempt}``, optionally carrying ``hashes: [key | nil, ...]`` aligned
    with ``chunks`` — when the fronted store is content-addressed
    (``TieredKVStore``), a non-nil hash key is served directly via
    ``get_by_hash`` (two tenants sharing a document prefix hit the same
    blob without the server consulting either tenant's catalog); nil
    entries and flat stores fall back to the ``(cid, chunk, level)`` path.
    Optional ``range: [offset, length|0]`` and ``want_idx: true`` request
    keys (see the module docstring) slice the single blob and attach its
    segment index + full length to the response header — old clients never
    send them, old servers ignore them.  Connections are persistent: the
    server loops serving requests until the client closes at a frame
    boundary (clean goodbye, not a dropped connection).
    Response: one msgpack header frame ``{ok, sizes[, total, idx] | error}``
    followed by each blob as a raw frame.  ``tier_stats()`` snapshots the
    fronted store's per-tier hit/miss/demotion counters (empty for a flat
    store) — the multi-tenant deployment's observability surface.  ``pace_gbps`` throttles the blob
    stream into timed slices (an actual paced link, not a sleep-at-the-end
    model); ``straggler_p`` injects a keyed Pareto stall per
    ``(chunk_idx, attempt)`` before the payload — the same
    ``keyed_straggler_delay`` the virtual-clock model draws from, so a
    hedged client (attempt 1, ``straggle=False``) escapes exactly the
    stalls the simulator's hedge escapes.

    Connection-failure accounting: every accepted connection increments
    ``n_connections``; a connection that dies mid-exchange (client gone,
    socket error) increments ``n_dropped_connections``; a request frame that
    does not parse increments ``n_malformed``.  The most recent reasons are
    kept in ``last_errors`` (bounded) and logged at debug level — a flaky
    peer is observable on the server object, not silently swallowed.

    ``fault_plan`` (``streaming/faults.FaultPlan``) injects server-side
    chaos per request: a "drop" severs the stream mid-frame (header + half
    the first blob, then close), a "stall" sleeps past the client's timeout,
    a "corrupt" flips payload bytes before sending, a "truncate" delivers a
    valid payload prefix then severs (the salvageable partial delivery the
    resume path exists for).  ``n_injected_faults`` counts them.
    """

    def __init__(
        self,
        store: KVStore,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        pace_gbps: Optional[float] = None,
        straggler_p: float = 0.0,
        straggler_scale_s: float = 0.1,
        straggler_alpha: float = 1.5,
        seed: int = 0,
        fault_plan=None,
    ):
        self.store = store
        self.pace_gbps = pace_gbps
        self.straggler_p = straggler_p
        self.straggler_scale_s = straggler_scale_s
        self.straggler_alpha = straggler_alpha
        self.seed = seed
        self.fault_plan = fault_plan
        self.n_connections = 0
        self.n_dropped_connections = 0
        self.n_malformed = 0
        self.n_injected_faults = 0
        self.last_errors: List[str] = []  # bounded, most recent last
        self._attempt_counts: dict = {}  # (cid, chunk, level) -> tries seen
        self._stats_lock = threading.Lock()
        self._live_conns: set = set()  # persistent conns to sever on close()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.address: Tuple[str, int] = self._sock.getsockname()[:2]
        self._closing = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    # -- server internals --------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closing.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener closed
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _note_error(self, reason: str) -> None:
        with self._stats_lock:
            self.last_errors.append(reason)
            del self.last_errors[:-16]
        logger.debug("tcp store server: %s", reason)

    def _draw_fault(self, cid, chunks):
        """One injected fault decision per request (first chunk keys it)."""
        if self.fault_plan is None or not chunks:
            return None, 0
        ci, lvl = chunks[0]
        with self._stats_lock:
            attempt = self._attempt_counts.get((cid, ci, lvl), 0)
            self._attempt_counts[(cid, ci, lvl)] = attempt + 1
        return self.fault_plan.draw(cid, ci, lvl, attempt), attempt

    def _serve_conn(self, conn: socket.socket) -> None:
        with self._stats_lock:
            self.n_connections += 1
            self._live_conns.add(conn)
        try:
            with conn:
                # persistent connection: serve requests until the client
                # closes cleanly at a frame boundary (connection reuse —
                # a retrying session does not re-pay connection setup)
                while self._serve_one(conn):
                    pass
        except (ConnectionError, OSError, ValueError) as e:
            if self._closing.is_set():
                return  # shutdown severed us, not the peer
            # client gone (a cancelled hedge loser, a dropped peer) — the
            # request is over, but the event is counted and attributable
            with self._stats_lock:
                self.n_dropped_connections += 1
            self._note_error(f"connection dropped mid-exchange: {e!r}")
            return
        finally:
            with self._stats_lock:
                self._live_conns.discard(conn)

    def _serve_one(self, conn: socket.socket) -> bool:
        """Serve one request; False ends the connection (cleanly or after
        an injected sever fault)."""
        # clean EOF at a frame boundary is the reuse protocol's goodbye,
        # not a dropped connection
        first = conn.recv(1)
        if not first:
            return False
        try:
            n = _LEN.unpack(first + _recv_exact(conn, _LEN.size - 1))[0]
            req = _msgpack.unpackb(_recv_exact(conn, n))
            cid = req["cid"]
            chunks = [(int(c), int(lv)) for c, lv in req["chunks"]]
            hashes = req.get("hashes")
            if hashes is not None and len(hashes) != len(chunks):
                raise ValueError(
                    f"hashes length {len(hashes)} != chunks "
                    f"length {len(chunks)}"
                )
            rng = req.get("range")
            want_idx = bool(req.get("want_idx"))
            if rng is not None and len(chunks) != 1:
                raise ValueError("range request must name exactly one chunk")
        except ConnectionError:
            raise  # peer vanished mid-request frame
        except Exception as e:
            with self._stats_lock:
                self.n_malformed += 1
            self._note_error(f"malformed request frame: {e!r}")
            return False
        get_by_hash = getattr(self.store, "get_by_hash", None)
        if hashes is None or not callable(get_by_hash):
            hashes = [None] * len(chunks)
        try:
            blobs = [
                get_by_hash(h, lvl)
                if h is not None
                else self.store.get_kv(cid, ci, lvl)
                for h, (ci, lvl) in zip(hashes, chunks)
            ]
        except KeyError as e:
            _send_frame(conn, _msgpack.packb(
                {"ok": False, "error": str(e.args[0])}
            ))
            return True
        # range/index view of the (single) blob — computed before fault
        # injection so a corrupt fault damages the *delivered* bytes while
        # the index still describes the canonical blob (the client's
        # verified_prefix then catches the corruption segment-by-segment)
        header: dict = {"ok": True}
        if rng is not None or want_idx:
            header["total"] = len(blobs[0]) if len(blobs) == 1 else 0
            if want_idx and len(blobs) == 1:
                header["idx"] = segment_index(blobs[0]).to_wire()
            if rng is not None:
                off, end = _clamp_range(
                    (int(rng[0]), int(rng[1]) if len(rng) > 1 else None),
                    len(blobs[0]),
                )
                blobs = [blobs[0][off:end]]
        fault, attempt = self._draw_fault(cid, chunks)
        if fault is not None:
            with self._stats_lock:
                self.n_injected_faults += 1
            self._note_error(
                f"injected {fault.kind} fault for {cid!r} chunks {chunks}"
            )
            if fault.kind == "stall":
                time.sleep(fault.delay_s)
            elif fault.kind == "corrupt":
                blobs = [
                    self.fault_plan.corrupt_bytes(b, cid, ci, lvl, attempt)
                    for b, (ci, lvl) in zip(blobs, chunks)
                ]
        header["sizes"] = [len(b) for b in blobs]
        _send_frame(conn, _msgpack.packb(header))
        if fault is not None and fault.kind == "drop":
            # sever mid-frame: length prefix + half the payload, then the
            # connection closes — the client sees ConnectionError
            half = blobs[0][: max(len(blobs[0]) // 2, 1)]
            conn.sendall(_LEN.pack(len(blobs[0])) + half)
            return False
        if fault is not None and fault.kind == "truncate":
            # deliver a *valid prefix* then sever: the adversarial input
            # the resume path must salvage (drop's bytes are mid-frame
            # garbage to the framing layer; truncate's parse as segments)
            frac = self.fault_plan.truncate_fraction(
                cid, chunks[0][0], chunks[0][1], attempt
            )
            k = max(1, int(len(blobs[0]) * frac))
            conn.sendall(_LEN.pack(len(blobs[0])) + blobs[0][:k])
            return False
        if req.get("straggle", True) and self.straggler_p > 0:
            key_chunk = chunks[0][0] if chunks else 0
            stall = keyed_straggler_delay(
                self.seed, key_chunk, int(req.get("attempt", 0)),
                p=self.straggler_p, scale_s=self.straggler_scale_s,
                alpha=self.straggler_alpha,
            )
            if stall > 0:
                time.sleep(stall)
        for blob in blobs:
            self._send_paced(conn, blob)
        return True

    def _send_paced(self, conn: socket.socket, blob: bytes) -> None:
        conn.sendall(_LEN.pack(len(blob)))
        if not self.pace_gbps:
            conn.sendall(blob)
            return
        # timed slices: ~5 ms of link time each, so cancellation (client
        # closing its socket) lands mid-stream, not between blobs
        bytes_per_s = self.pace_gbps * 1e9 / 8.0
        slice_bytes = max(1, int(bytes_per_s * 0.005))
        sent = 0
        t0 = time.perf_counter()
        while sent < len(blob):
            part = blob[sent : sent + slice_bytes]
            conn.sendall(part)
            sent += len(part)
            target = sent / bytes_per_s
            lag = target - (time.perf_counter() - t0)
            if lag > 0:
                time.sleep(lag)

    def tier_stats(self) -> dict:
        """Per-tier hit/miss/demotion counters of the fronted store
        (``{}`` when the store is flat — no tiers, nothing to report)."""
        counters = getattr(self.store, "tier_counters", None)
        return dict(counters()) if callable(counters) else {}

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        self._closing.set()
        try:
            self._sock.close()
        except OSError:
            pass
        # persistent connections would otherwise outlive the server — a
        # pooled client socket must go stale when its server goes away
        with self._stats_lock:
            live = list(self._live_conns)
        for conn in live:
            try:
                conn.close()
            except OSError:
                pass

    def __enter__(self) -> "TcpStoreServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _TcpAttempt:
    def __init__(self):
        self.sock: Optional[socket.socket] = None
        self.counter = [0]  # bytes received (mutable cell for _recv_exact)
        self.blobs: Optional[List[bytes]] = None
        self.error: Optional[BaseException] = None
        self.finished = threading.Event()
        self.cancelled = False
        self.pooled = False  # sock was checked out of the reuse pool
        # salvage state: payload bytes of a single-chunk fetch accumulate
        # here as frames drain, so a severed stream leaves its realized
        # prefix behind instead of vanishing with the exception
        self.blob_buf = bytearray()
        self.seg_index: Optional[SegmentIndex] = None
        self.range_offset = 0
        self.range_total = 0

    @property
    def bytes_read(self) -> int:
        return self.counter[0]

    def cancel(self) -> None:
        self.cancelled = True
        if self.sock is not None:
            try:
                self.sock.close()  # real cancellation: the stream dies now
            except OSError:
                pass


class _TcpHandle(FetchHandle):
    def __init__(self, attempts: List[_TcpAttempt], context_id=None, chunk_levels=None):
        super().__init__(context_id, chunk_levels)
        self._attempts = attempts

    def salvage_at(self, at_t: Optional[float] = None) -> Optional[Salvage]:
        # wall-clock transport: "now" is the only observable instant, so
        # at_t is advisory — the realized prefix is whatever has actually
        # drained off the socket into the primary attempt's buffer
        a = self._attempts[0]
        if not a.blob_buf:
            return None
        return Salvage(
            data=bytes(a.blob_buf),
            offset=a.range_offset,
            total=a.range_total,
            index=a.seg_index,
            nbytes_wire=float(len(a.blob_buf)),
        )

    def _abort(self) -> None:
        for a in self._attempts:
            a.cancel()


class TcpTransport:
    """Client for :class:`TcpStoreServer` with a connection-reuse pool.

    Each attempt runs on its own socket, but sockets whose exchange ends
    cleanly (frame-aligned) return to a pool and serve the next attempt —
    a retrying session no longer re-pays TCP setup per retry.  A pooled
    socket that went stale while idle is replaced by a fresh dial and the
    request replayed once (``n_reconnects``); sockets severed mid-stream
    (faults, cancellation, hedging losers) are closed, never pooled.
    ``tier_stats()`` reports the dial/reuse/reconnect counters.

    Timing is measured on the wire — ``end_t = start_t + wall`` and the
    observed throughput is realized bytes over realized seconds, so a
    session running over this transport estimates bandwidth from an actual
    link.  Hedging is an actual race: a second connection is opened
    ``hedge_after_s`` (real seconds) after the first if it hasn't finished,
    the first completion wins, and the loser's socket is closed mid-stream
    (``duplicate_bytes`` = the loser's realized byte counter).

    ``hash_lookup`` (optional, ``(context_id, chunk_idx) -> key | None``) is
    the client-side manifest for a content-addressed server: when it yields
    keys, the request frame carries them as ``hashes`` and the server reads
    by ``(hash, level)`` instead of the per-context catalog.  A lookup that
    answers None (or raises) for a chunk falls back to the context-keyed
    path for that entry — old servers ignore the extra field entirely.
    """

    realtime = True  # handles resolve on actual link time
    supports_range = True

    def __init__(
        self,
        host: str,
        port: int,
        *,
        connect_timeout_s: float = 5.0,
        io_timeout_s: float = 30.0,
        hash_lookup=None,
    ):
        self.host = host
        self.port = port
        self.connect_timeout_s = connect_timeout_s
        self.io_timeout_s = io_timeout_s
        self.hash_lookup = hash_lookup
        # connection reuse: sockets whose exchange completed cleanly are
        # pooled for the next attempt instead of re-paying TCP setup
        self._pool: List[socket.socket] = []
        self._pool_lock = threading.Lock()
        self.n_connects = 0  # fresh sockets dialed
        self.n_reconnects = 0  # stale pooled socket -> fresh dial + replay
        self.n_pool_reuses = 0  # attempts served on a pooled socket

    # -- connection pool ---------------------------------------------------

    def _checkout(self) -> Tuple[socket.socket, bool]:
        """A socket to run one request on: pooled if available, else a
        fresh dial.  Returns ``(sock, was_pooled)``."""
        with self._pool_lock:
            if self._pool:
                self.n_pool_reuses += 1
                return self._pool.pop(), True
            self.n_connects += 1
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.connect_timeout_s
        )
        sock.settimeout(self.io_timeout_s)
        return sock, False

    def _checkin(self, sock: socket.socket) -> None:
        with self._pool_lock:
            self._pool.append(sock)

    def tier_stats(self) -> dict:
        """Client-side connection counters (mirrors the server's
        observability surface): fresh dials, pooled reuses, and reconnects
        forced by a stale pooled socket."""
        with self._pool_lock:
            return {
                "n_connects": self.n_connects,
                "n_reconnects": self.n_reconnects,
                "n_pool_reuses": self.n_pool_reuses,
            }

    def _hashes_for(
        self, context_id: str, chunk_levels: List[Tuple[int, int]]
    ) -> Optional[List[Optional[str]]]:
        if self.hash_lookup is None:
            return None
        hashes: List[Optional[str]] = []
        for ci, _lvl in chunk_levels:
            try:
                hashes.append(self.hash_lookup(context_id, ci))
            except Exception:
                hashes.append(None)
        return hashes if any(h is not None for h in hashes) else None

    @staticmethod
    def for_server(server: TcpStoreServer, **kw) -> "TcpTransport":
        return TcpTransport(server.address[0], server.address[1], **kw)

    def _run_attempt(
        self,
        attempt: _TcpAttempt,
        context_id: str,
        chunk_levels: List[Tuple[int, int]],
        attempt_idx: int,
        notify: Optional[threading.Event] = None,
        byte_range: Optional[Tuple[int, Optional[int]]] = None,
        resumable: bool = False,
    ) -> None:
        clean = False
        try:
            try:
                self._exchange(
                    attempt, context_id, chunk_levels, attempt_idx,
                    byte_range, resumable,
                )
            except (ConnectionError, OSError):
                # a pooled socket may have gone stale while idle (server
                # restarted, keepalive lapsed): if the failure hit before
                # any response bytes arrived, dial fresh and replay once
                if not (attempt.pooled and attempt.counter[0] == 0
                        and not attempt.cancelled):
                    raise
                with self._pool_lock:
                    self.n_reconnects += 1
                try:
                    attempt.sock.close()
                except OSError:
                    pass
                attempt.sock = None
                attempt.pooled = False
                self._exchange(
                    attempt, context_id, chunk_levels, attempt_idx,
                    byte_range, resumable,
                )
            clean = True
        except BaseException as e:
            attempt.error = e
        finally:
            if attempt.sock is not None:
                if clean and not attempt.cancelled:
                    self._checkin(attempt.sock)  # reusable: frame-aligned
                else:
                    try:
                        attempt.sock.close()
                    except OSError:
                        pass
            attempt.finished.set()
            if notify is not None:
                notify.set()

    def _exchange(
        self,
        attempt: _TcpAttempt,
        context_id: str,
        chunk_levels: List[Tuple[int, int]],
        attempt_idx: int,
        byte_range: Optional[Tuple[int, Optional[int]]],
        resumable: bool,
    ) -> None:
        sock, pooled = self._checkout()
        attempt.sock = sock
        attempt.pooled = pooled
        if attempt.cancelled:
            # cancel() landed while we were connecting (sock was None,
            # nothing to close then) — abort before requesting anything,
            # or the "cancelled" loser would stream the whole payload
            raise FetchError("attempt cancelled before request")
        req = {
            "cid": context_id,
            "chunks": [list(c) for c in chunk_levels],
            "straggle": attempt_idx == 0,
            "attempt": attempt_idx,
        }
        hashes = self._hashes_for(context_id, chunk_levels)
        if hashes is not None:
            req["hashes"] = hashes
        single = len(chunk_levels) == 1
        if byte_range is not None and single:
            off, ln = byte_range
            req["range"] = [int(off), int(ln) if ln else 0]
        if (resumable or byte_range is not None) and single:
            req["want_idx"] = True
        _send_frame(sock, _msgpack.packb(req))
        header = _msgpack.unpackb(_recv_frame(sock, attempt.counter))
        if not header.get("ok"):
            raise KeyError(header.get("error", "storage error"))
        if "idx" in header:
            attempt.seg_index = SegmentIndex.from_wire(header["idx"])
        if "total" in header:
            attempt.range_total = int(header["total"])
            if byte_range is not None:
                attempt.range_offset = int(byte_range[0])
        # a pre-range server ignored the request keys and is streaming the
        # whole blob: "total" absent -> the payload starts at offset 0
        if single:
            blobs = [
                _recv_frame_into(sock, attempt.counter, attempt.blob_buf)
                for _ in header["sizes"]
            ]
        else:
            blobs = [
                _recv_frame(sock, attempt.counter) for _ in header["sizes"]
            ]
        attempt.blobs = blobs

    def fetch_run(
        self,
        context_id: str,
        chunk_levels: ChunkLevels,
        *,
        start_t: float = 0.0,
        hedge_after_s: Optional[float] = None,
        byte_range: Optional[Tuple[int, Optional[int]]] = None,
        resumable: bool = False,
    ) -> FetchHandle:
        chunk_levels = list(chunk_levels)
        if byte_range is not None and len(chunk_levels) != 1:
            raise ValueError("byte-range fetch is single-chunk only")
        if byte_range is not None:
            hedge_after_s = None  # a resumed suffix is never hedged
        primary = _TcpAttempt()
        attempts = [primary]
        handle = _TcpHandle(attempts, context_id, chunk_levels)

        def coordinate():
            t0 = time.perf_counter()
            any_finished = threading.Event()
            threading.Thread(
                target=self._run_attempt,
                args=(primary, context_id, chunk_levels, 0, any_finished,
                      byte_range, resumable),
                daemon=True,
            ).start()
            hedge: Optional[_TcpAttempt] = None
            if hedge_after_s is not None:
                if not primary.finished.wait(hedge_after_s):
                    if handle.done():  # cancelled while primary connected
                        primary.cancel()
                        return
                    hedge = _TcpAttempt()
                    attempts.append(hedge)
                    threading.Thread(
                        target=self._run_attempt,
                        args=(hedge, context_id, chunk_levels, 1, any_finished,
                              byte_range, resumable),
                        daemon=True,
                    ).start()
                    if handle.done():  # cancel() raced the hedge spawn
                        hedge.cancel()
            # race: first attempt to finish with blobs wins
            contenders = [a for a in attempts]
            winner: Optional[_TcpAttempt] = None
            while winner is None:
                winner = next(
                    (a for a in contenders
                     if a.finished.is_set() and a.blobs is not None),
                    None,
                )
                if winner is not None:
                    break
                if all(a.finished.is_set() for a in contenders):  # all failed
                    err = next(
                        (a.error for a in contenders if a.error is not None),
                        FetchError(
                            "all fetch attempts failed",
                            context_id=context_id,
                            chunk_levels=chunk_levels,
                        ),
                    )
                    handle._finish(None, err)
                    return
                any_finished.wait()
                any_finished.clear()
            wall = time.perf_counter() - t0
            loser = next((a for a in attempts if a is not winner), None)
            if loser is not None and not loser.finished.is_set():
                loser.cancel()
            nbytes = sum(len(b) for b in winner.blobs)
            # single snapshot of the loser's live counter: its recv loop may
            # still be draining buffered data as the socket dies
            loser_read = loser.bytes_read if loser is not None else 0
            handle._finish(FetchResult(
                blobs=winner.blobs,
                nbytes=nbytes,
                start_t=start_t,
                end_t=start_t + wall,
                throughput_gbps=nbytes * 8.0 / max(wall, 1e-9) / 1e9,
                hedged=winner is not primary,
                hedge_issued=hedge is not None,
                duplicate_bytes=float(loser_read),
                wall_s=wall,
                winner="primary" if winner is primary else "hedge",
                loser_cancelled=loser.cancelled if loser is not None else False,
                loser_bytes_read=loser_read,
                completion_order=tuple(ci for ci, _ in chunk_levels),
                seg_index=winner.seg_index,
                range_offset=winner.range_offset,
                range_total=winner.range_total,
            ))

        threading.Thread(target=coordinate, daemon=True).start()
        return handle

    def close(self) -> None:
        with self._pool_lock:
            pool, self._pool = self._pool, []
        for sock in pool:
            try:
                sock.close()
            except OSError:
                pass
