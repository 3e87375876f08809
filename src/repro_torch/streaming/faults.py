"""Deterministic fault injection for the fetch path.

A :class:`FaultPlan` is a seeded description of chaos: per fetch *attempt*
it may drop the fetch, stall it past a timeout, corrupt the payload bytes,
or truncate the stream (deliver a valid prefix, then sever — the
salvageable partial delivery the session's byte-range resume exists for);
per stored *entry* it may delete the blob or corrupt it at rest.  Every
decision is drawn from an RNG keyed on ``(seed, context, chunk, level,
attempt, salt)`` — the ``keyed_straggler_delay`` idiom — so the same plan
replays identically regardless of scheduling order, and draws the same
faults as the JAX reference's ``FaultPlan`` for the same key.

Two injection points compose with the pluggable fetch path:

  * :class:`FaultyTransport` wraps any ``Transport`` and perturbs in-flight
    fetches (transient faults — a retry re-draws at the next attempt
    index, so a fault can clear);
  * :class:`FaultyBackend` wraps any ``StorageBackend`` and perturbs reads
    (persistent faults — a missing or rotten entry stays that way, which
    is why the retry machinery treats ``KeyError`` as permanent-at-level).

A zero-probability plan injects nothing and leaves every path bit-identical
to the unwrapped transport/backend.  Faults act on ``bytes`` only; no
tensor is touched.
"""
from __future__ import annotations

import copy
import dataclasses
import threading
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.streaming.storage import KVStore, StorageBackend, TieredKVStore, _missing
from repro_torch.streaming.transport import (
    ChunkLevels,
    FetchError,
    FetchHandle,
    FetchResult,
    Salvage,
    Transport,
)

__all__ = [
    "Fault",
    "FaultPlan",
    "FaultyBackend",
    "FaultyTransport",
    "with_faulty_backend",
]


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected in-flight fault: what happens, and how late it lands."""

    kind: str  # "drop" | "stall" | "corrupt" | "truncate"
    delay_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded, order-independent fault schedule.

    Per-attempt (transient, transport layer): ``drop_p`` + ``stall_p`` +
    ``corrupt_p`` + ``truncate_p`` must not exceed 1 — they partition the
    unit draw, so at most one fault fires per attempt.  Per-entry
    (persistent, storage layer): ``missing_p`` deletes, ``store_corrupt_p``
    rots at rest.

    ``drop_detect_s`` bounds how long a dropped fetch takes to be *noticed*
    (connection-reset latency on the virtual clock); ``stall_scale_s`` /
    ``stall_alpha`` shape the Pareto stall; ``wall_cap_s`` bounds the real
    sleep any single injected fault may cost on a realtime transport, so
    chaos tests stay fast.
    """

    seed: int = 0
    drop_p: float = 0.0
    stall_p: float = 0.0
    corrupt_p: float = 0.0
    truncate_p: float = 0.0
    missing_p: float = 0.0
    store_corrupt_p: float = 0.0
    stall_scale_s: float = 0.2
    stall_alpha: float = 1.5
    drop_detect_s: float = 0.02
    wall_cap_s: float = 2.0

    def __post_init__(self):
        total = self.drop_p + self.stall_p + self.corrupt_p + self.truncate_p
        if total > 1.0 + 1e-9:
            raise ValueError(
                f"drop_p + stall_p + corrupt_p + truncate_p = {total} exceeds 1"
            )

    # -- keyed determinism --------------------------------------------------

    def _rng(
        self, cid: str, chunk: int, level: int, attempt: int, salt: int
    ) -> np.random.Generator:
        return np.random.default_rng((
            self.seed & 0xFFFFFFFF,
            zlib.crc32(str(cid).encode()) & 0xFFFFFFFF,
            chunk & 0xFFFFFFFF,
            (level + 8) & 0xFF,  # levels start at TEXT = -1
            attempt & 0xFFFF,
            salt,
        ))

    # -- per-attempt (transport) -------------------------------------------

    def draw(
        self, cid: str, chunk: int, level: int, attempt: int
    ) -> Optional[Fault]:
        """The in-flight fault for one fetch attempt, or None."""
        if (self.drop_p <= 0 and self.stall_p <= 0 and self.corrupt_p <= 0
                and self.truncate_p <= 0):
            return None
        rng = self._rng(cid, chunk, level, attempt, salt=0)
        u = float(rng.random())
        if u < self.drop_p:
            return Fault("drop", delay_s=float(rng.uniform(0.0, self.drop_detect_s)))
        if u < self.drop_p + self.stall_p:
            stall = self.stall_scale_s * (1.0 + float(rng.pareto(self.stall_alpha)))
            return Fault("stall", delay_s=stall)
        if u < self.drop_p + self.stall_p + self.corrupt_p:
            return Fault("corrupt")
        if u < self.drop_p + self.stall_p + self.corrupt_p + self.truncate_p:
            return Fault("truncate")
        return None

    def truncate_fraction(
        self, cid: str, chunk: int, level: int, attempt: int
    ) -> float:
        """How much of the payload a truncate fault delivers before the
        sever — keyed like every other draw, U(0.25, 0.9) so the prefix is
        always substantial enough to exercise salvage but never complete."""
        return float(self._rng(cid, chunk, level, attempt, salt=4).uniform(0.25, 0.9))

    # -- per-entry (storage) ------------------------------------------------

    def missing(self, cid: str, chunk: int, level: int) -> bool:
        """True if this entry is persistently gone from the store."""
        if self.missing_p <= 0:
            return False
        return float(self._rng(cid, chunk, level, 0, salt=1).random()) < self.missing_p

    def corrupt_at_rest(self, cid: str, chunk: int, level: int) -> bool:
        """True if this entry's bytes are persistently rotten."""
        if self.store_corrupt_p <= 0:
            return False
        return (
            float(self._rng(cid, chunk, level, 0, salt=2).random())
            < self.store_corrupt_p
        )

    # -- byte corruption ----------------------------------------------------

    def corrupt_bytes(
        self, blob: bytes, cid: str, chunk: int, level: int, attempt: int = 0
    ) -> bytes:
        """XOR-flip a few keyed positions (distinct, so flips can't cancel)."""
        if not blob:
            return blob
        rng = self._rng(cid, chunk, level, attempt, salt=3)
        out = bytearray(blob)
        positions = rng.choice(len(out), size=min(4, len(out)), replace=False)
        for pos in positions:
            out[int(pos)] ^= 0xFF
        return bytes(out)


# ---------------------------------------------------------------------------
# FaultyBackend: persistent storage faults
# ---------------------------------------------------------------------------


class FaultyBackend:
    """Wrap a :class:`StorageBackend`, injecting persistent read faults.

    Writes pass through untouched; a read of a plan-``missing`` entry raises
    the same descriptive ``KeyError`` a real deletion would, a read of a
    plan-rotten entry returns flipped bytes (the checksum gate upstream
    turns that into an ``IntegrityError``).  ``n_missing_reads`` /
    ``n_corrupt_reads`` count every faulted read for reconciliation.
    """

    def __init__(self, inner: StorageBackend, plan: FaultPlan):
        self.inner = inner
        self.plan = plan
        self.n_missing_reads = 0
        self.n_corrupt_reads = 0
        self._lock = threading.Lock()

    def put(self, context_id: str, chunk_idx: int, level: int, blob: bytes) -> None:
        self.inner.put(context_id, chunk_idx, level, blob)

    def get(self, context_id: str, chunk_idx: int, level: int) -> bytes:
        if self.plan.missing(context_id, chunk_idx, level):
            with self._lock:
                self.n_missing_reads += 1
            raise _missing(context_id, chunk_idx, level, "entry deleted by fault plan")
        blob = self.inner.get(context_id, chunk_idx, level)
        if self.plan.corrupt_at_rest(context_id, chunk_idx, level):
            with self._lock:
                self.n_corrupt_reads += 1
            return self.plan.corrupt_bytes(blob, context_id, chunk_idx, level)
        return blob

    def contains(self, context_id: str, chunk_idx: int, level: int) -> bool:
        if self.plan.missing(context_id, chunk_idx, level):
            return False
        return self.inner.contains(context_id, chunk_idx, level)

    def delete(self, context_id: str, chunk_idx: int, level: int) -> bool:
        return self.inner.delete(context_id, chunk_idx, level)


def with_faulty_backend(store: KVStore, plan: FaultPlan) -> KVStore:
    """A read view of ``store`` whose backend injects ``plan``'s storage
    faults.  Chunk metadata (and therefore fetch pricing) is shared with the
    clean store — faults corrupt bytes, not the catalog.  The view's
    ``backend`` is the :class:`FaultyBackend` (injection counters).

    Tiered stores (``TieredKVStore``) get their *cold* tier wrapped: the
    plan models durable-storage rot, and the in-process hot tier masks it —
    a fault only reaches a reader whose entry is not (or no longer) hot,
    which is exactly the eviction x faults surface.  The view shares the
    clean store's index state (metadata, refcounts, LRU), so reads/evictions
    through either object see one store; use the view's ``cold`` attribute
    (the :class:`FaultyBackend`) for injection counters.  Note the plan's
    keys are *hash* strings here, not context ids — draws stay deterministic
    per (hash, level), independent of which context reads the blob."""
    if isinstance(store, TieredKVStore):
        out = copy.copy(store)  # shares _meta/_refcount/_hash_levels/_hot_lru
        out.cold = out.backend = FaultyBackend(store.cold, plan)
        return out
    out = KVStore(store.tables, backend=FaultyBackend(store.backend, plan))
    out._meta = store._meta
    return out


# ---------------------------------------------------------------------------
# FaultyTransport: transient in-flight faults
# ---------------------------------------------------------------------------


class _TransformedHandle(FetchHandle):
    """Proxy a wrapped transport's handle, applying ``transform`` to the
    successful result (stall re-timing, payload corruption).  Errors pass
    through untouched; cancelling the proxy cancels the inner fetch.
    ``extra_wall_s`` delays delivery by real seconds (realtime transports),
    so an injected stall actually out-waits a wall timeout."""

    def __init__(
        self,
        inner: FetchHandle,
        transform,
        *,
        context_id=None,
        chunk_levels=None,
        extra_wall_s: float = 0.0,
        salvage_shift_t: float = 0.0,
        salvageable: bool = True,
    ):
        super().__init__(context_id, chunk_levels)
        self._inner = inner
        self._transform = transform
        self._extra_wall_s = extra_wall_s
        self._salvage_shift_t = salvage_shift_t
        self._salvageable = salvageable
        inner.add_done_callback(self._on_inner_done)

    def salvage_at(self, at_t=None):
        # a stall shifts when bytes land on the virtual clock; a corrupt
        # fault poisons the wire, so its partial bytes are not salvage
        if not self._salvageable:
            return None
        if at_t is not None:
            at_t = at_t - self._salvage_shift_t
        return self._inner.salvage_at(at_t)

    def _abort(self) -> None:
        self._inner.cancel()  # its cancellation error propagates via callback

    def _on_inner_done(self, inner: FetchHandle) -> None:
        def deliver():
            try:
                res = inner.result(timeout=0)
            except BaseException as e:
                self._finish(None, e)
                return
            try:
                self._finish(self._transform(res), None)
            except BaseException as e:  # transform bug — never hang the waiter
                self._finish(None, e)

        if self._extra_wall_s > 0:
            threading.Timer(self._extra_wall_s, deliver).start()
        else:
            deliver()


class FaultyTransport:
    """Wrap any :class:`Transport`, injecting ``plan``'s transient faults.

    Per fetched ``(context, chunk, level)`` key an attempt counter advances
    on every ``fetch_run`` — independent of scheduling order across
    sessions — and keys the plan's draw, so a retry of a dropped fetch
    re-draws at the next attempt index and can succeed.  ``n_injected``
    counts faults by kind for reconciliation against session counters.

    Injected faults apply to the fetch as a whole (a hedged fetch's two
    attempts share the injected fate — the plan models the *request*
    failing, not one socket).
    """

    def __init__(self, inner: Transport, plan: FaultPlan):
        self.inner = inner
        self.plan = plan
        self.n_injected: Dict[str, int] = {
            "drop": 0, "stall": 0, "corrupt": 0, "truncate": 0,
        }
        self._counts: Dict[Tuple[str, int, int], int] = {}
        self._lock = threading.Lock()

    @property
    def realtime(self) -> bool:
        return bool(getattr(self.inner, "realtime", False))

    @property
    def supports_range(self) -> bool:
        return bool(getattr(self.inner, "supports_range", False))

    def _next_attempt(self, cid: str, ci: int, lvl: int) -> int:
        with self._lock:
            n = self._counts.get((cid, ci, lvl), 0)
            self._counts[(cid, ci, lvl)] = n + 1
            return n

    def _count(self, kind: str) -> None:
        with self._lock:
            self.n_injected[kind] += 1

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
        kw = dict(start_t=start_t, hedge_after_s=hedge_after_s)
        if byte_range is not None or resumable:
            # only forwarded when requested, so wrapping a pre-range
            # transport stays signature-compatible until a caller opts in
            kw.update(byte_range=byte_range, resumable=resumable)
        if not chunk_levels:
            return self.inner.fetch_run(context_id, chunk_levels, **kw)
        ci, lvl = chunk_levels[0]
        attempt = self._next_attempt(context_id, ci, lvl)
        fault = self.plan.draw(context_id, ci, lvl, attempt)

        if fault is not None and fault.kind == "drop":
            self._count("drop")
            handle = FetchHandle(context_id, chunk_levels)
            err = FetchError(
                f"fetch dropped by fault plan (attempt {attempt})",
                context_id=context_id,
                chunk_levels=chunk_levels,
                fail_t=start_t + fault.delay_s,
            )
            if self.realtime and fault.delay_s > 0:
                threading.Timer(
                    min(fault.delay_s, self.plan.wall_cap_s),
                    lambda: handle._finish(None, err),
                ).start()
            else:
                handle._finish(None, err)
            return handle

        inner = self.inner.fetch_run(context_id, chunk_levels, **kw)
        if fault is None:
            return inner

        if fault.kind == "stall":
            self._count("stall")
            delay = fault.delay_s

            def retime(res: FetchResult) -> FetchResult:
                end_t = res.end_t + delay
                dur = max(end_t - res.start_t, 1e-9)
                return dataclasses.replace(
                    res,
                    end_t=end_t,
                    throughput_gbps=res.nbytes * 8.0 / dur / 1e9,
                    wall_s=res.wall_s + delay,
                )

            return _TransformedHandle(
                inner, retime,
                context_id=context_id, chunk_levels=chunk_levels,
                extra_wall_s=(
                    min(delay, self.plan.wall_cap_s) if self.realtime else 0.0
                ),
                salvage_shift_t=delay,
            )

        if fault.kind == "truncate":
            # deliver a valid payload prefix, then sever: the completed
            # inner result becomes a FetchError *carrying* the prefix as
            # salvage — resumable callers keep it, legacy callers see the
            # same io failure a real mid-stream sever produces
            self._count("truncate")
            frac = self.plan.truncate_fraction(context_id, ci, lvl, attempt)

            def truncate(res: FetchResult) -> FetchResult:
                payload = res.blobs[0]
                k = max(1, int(len(payload) * frac))
                fail_t = res.start_t + frac * max(res.end_t - res.start_t, 0.0)
                raise FetchError(
                    f"stream truncated by fault plan at {k}/{len(payload)} "
                    f"bytes (attempt {attempt})",
                    context_id=context_id,
                    chunk_levels=chunk_levels,
                    fail_t=fail_t,
                    salvage=Salvage(
                        data=payload[:k],
                        offset=res.range_offset,
                        total=res.range_total or len(payload),
                        index=res.seg_index,
                        nbytes_wire=float(k),
                    ),
                )

            return _TransformedHandle(
                inner, truncate,
                context_id=context_id, chunk_levels=chunk_levels,
                salvageable=False,  # the truncate error itself carries it
            )

        # corrupt: flip payload bytes after the (clean) transfer completes
        self._count("corrupt")

        def corrupt(res: FetchResult) -> FetchResult:
            blobs = [
                self.plan.corrupt_bytes(b, context_id, c, l, attempt)
                for b, (c, l) in zip(res.blobs, chunk_levels)
            ]
            return dataclasses.replace(res, blobs=blobs)

        return _TransformedHandle(
            inner, corrupt,
            context_id=context_id, chunk_levels=chunk_levels,
            salvageable=False,  # poisoned wire: partial bytes untrustworthy
        )

    def close(self) -> None:
        self.inner.close()
