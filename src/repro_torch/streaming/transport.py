"""Async fetch transports for KV bitstreams: the read path as real I/O.

The fetch layer split:

  * :class:`~repro_torch.streaming.storage.StorageBackend` — where blobs
    live (memory, directory);
  * :class:`Transport` — how blobs travel: ``fetch_run(context_id,
    [(chunk, level), ...]) -> FetchHandle``.  A handle is a cancellable,
    in-flight fetch whose :meth:`~FetchHandle.result` carries the realized
    bytes *and* timing (:class:`FetchResult`); :func:`as_completed` yields
    handles in completion order;
  * ``NetworkModel`` (streaming/network.py) — the virtual-clock link model
    of the offline simulator.

:class:`LocalTransport` reads the store directly, with no link; its timing
is host wall time.  It is the offline ``materialize`` default.

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
exponential backoff.

Byte-range resume.  ``fetch_run(..., byte_range=(offset, length_or_None),
resumable=True)`` fetches a slice of a single chunk's blob and/or asks for
the blob's :class:`~repro_torch.core.bitstream.SegmentIndex` as fetch
metadata (``FetchResult.seg_index``).  A cancelled attempt returns a
:class:`Salvage` — the raw realized payload prefix, its absolute blob
offset, and the index — which ``SegmentIndex.verified_prefix`` resolves
into complete CRC-verified segments plus a resume offset.  Transports
advertise the capability with a ``supports_range`` class attribute.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional, Protocol, Sequence, Tuple, runtime_checkable

from repro_torch.core.bitstream import IntegrityError, SegmentIndex, segment_index
from repro_torch.streaming.storage import KVStore

__all__ = [
    "FetchError",
    "FetchHandle",
    "FetchResult",
    "LocalTransport",
    "RetryPolicy",
    "Salvage",
    "Transport",
    "as_completed",
    "classify_failure",
]

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
            t0 = time.perf_counter()
            try:
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
                seg_index=seg_idx,
                range_offset=range_offset,
                range_total=range_total,
            ))

        threading.Thread(target=work, daemon=True).start()
        return handle

    def close(self) -> None:
        pass
