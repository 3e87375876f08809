"""Multi-session serving on one shared Engine: closed waves and the
continuous-admission event loop over the full load→generate session
lifecycle.

A session's life on the engine has two phases.  **Loading** (the paper's
scope): the context KV streams in — decode, insert, TEXT recompute — until
the row holds the realized prefix and TTFT is measured.  **Generating**: if
the request carries a :class:`~repro_torch.serving.generation.
GenerationSpec`, the session keeps its row and emits output tokens on the
*same* shared Engine, its decode steps stacked with every other generating
session's into one ``Engine.decode_step_rows`` call per step (continuous
batching: sessions join and leave the decode batch at step boundaries),
interleaved with other sessions' context loads on the virtual clock.

Two schedulers share one execution substrate:

* :class:`ConcurrentScheduler` — the closed wave: N requests are all
  admitted at once and the wave drains to empty.  It is the continuous
  scheduler's differential oracle; the N=1 oracle is ``ServeSession``
  itself (and ``Engine.generate_with_kv`` for generation).
* :class:`ContinuousScheduler` — the open loop: requests *arrive* over
  virtual time (``SessionRequest.start_t``), an admission queue — FIFO, or
  earliest SLO deadline first with ``admission="edf"`` — feeds a
  fixed-capacity :class:`RowPool` over one batch-of-requests cache, rows
  are recycled (``Engine.reset_rows``) the moment a session finishes, and
  an optional :class:`PreemptionPolicy` lets a tight-deadline waiter evict
  a session whose in-flight fetch is known to blow its SLO (or, with
  ``victim="least_work"`` / ``gen_slo``, a generating row): the victim's
  realized prefix suspends into a ``kv_layout.RowSnapshot``
  (``Engine.save_row``) and is restored bit-exactly, possibly into another
  row, when a row next frees.

Either way, *decisions* are per-request — every load owns its
``StreamClock``, Algorithm 1 policy, bandwidth trace and segmenter, exactly
as in the single-session loop — while the resolved work of all live loads
drains into cross-request batched execution:

  * **decode** — ready runs from different requests are stacked into one
    ``codec.decode_chunk_runs`` call (one pair of lane-stacked rANS decodes
    and one launch each of K1/K2 for every request's chunks);
  * **insert** — the decoded concat lands in the batch-of-requests cache
    through ``Engine.insert_runs``;
  * **recompute** — TEXT chunks with a common token count coalesce into one
    padded width-masked ``Engine.prefill_extend_rows`` forward, or a
    gather→compact→scatter ``prefill_extend_gather`` for small subsets;
  * **generation** — one ``Engine.decode_step_rows`` per stacked step (K3
    over every pool row at its own length; inactive rows bit-preserved).

Contention feedback runs off the live-session count (loading and
generating): decisions sample ``ContentionModel.factor_sharded`` for decode
and ``text_factor_sharded`` for TEXT recompute, and a stacked generation
step of M rows lasts ``gen_step_s × gen_factor(M)`` virtual seconds.

Device and ownership.  Everything runs on the engine's device; tokens for
the batched calls are built there.  The pool cache is the scheduler's own
and is written in place.  The wave hands each request a *view* of its row
of the final ``SchedulerResult.caches``; the continuous loop *copies* a
request's row when its load finishes (``extract_row(...).clone()``), since
the row then goes on generating in place or is reset for the next tenant,
and the request's ``SessionResult`` must keep the cache its load realized.
The end of a run synchronizes the card before the wall total is read.

Mesh sharding (shard-aware row addressing) is kept as in the reference —
``Engine.cache_rows``, :class:`ShardedRowPool`, the per-shard contention
readings and ``shard_transports`` — and each reduces exactly to the
unsharded behaviour on a one-shard ``Engine``.  On a
``serving.mesh_engine.ShardedEngine`` the pool cache is a
``kv_layout.ShardedCaches``, read here only through ``kv_layout``'s
helpers (``cache_batch``, ``cache_dtype``, ``has_kv``, ``synchronize``,
``extract_row``) and the engine's row primitives.

Failure isolation: a request whose session carries a ``retry_policy``
absorbs its fetch faults inside its own ``SessionTask`` and finishes with
``status == "failed"``; its row is released like any other finish and no
cross-request batch is poisoned.  Without a policy a fetch error raises out
of ``run()``.

Differential invariants (held by tests/test_torch_scheduler.py,
test_torch_continuous.py and test_torch_generation.py against the
reference): with every arrival at t=0, preemption off and ``rows=None`` the
continuous loop degenerates to exactly the wave scheduler — same rounds,
same batched dispatches, equal caches and decisions — and at N=1 both
degenerate to ``ServeSession``; a request with ``generation=None`` (or a
zero-token spec) takes the load-only path, and N=1 continuous generation is
token-identical to ``Engine.generate_with_kv``.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import codec as kvcodec
from repro_torch.models.lm import Caches
from repro_torch.serving.engine import Engine
from repro_torch.serving.generation import GenerationSpec, GenerationTask
from repro_torch.serving import kv_layout
from repro_torch.serving.kv_layout import extract_row
from repro_torch.serving.session import (
    RunWork,
    ServeSession,
    SessionResult,
    SessionTask,
    TextWork,
)
from repro_torch.streaming.network import NetworkModel
from repro_torch.streaming.pipeline import ContentionModel

__all__ = [
    "SessionRequest",
    "SchedulerResult",
    "ConcurrentScheduler",
    "RowPool",
    "ShardedRowPool",
    "PreemptionPolicy",
    "RequestTimeline",
    "ContinuousResult",
    "ContinuousScheduler",
]


@dataclasses.dataclass
class SessionRequest:
    """One context load: a session's knobs bound to a request's inputs.

    ``session`` carries the per-request configuration (SLO, cost model,
    adaptation knobs, streamer/store) and must share the scheduler's Engine;
    ``tokens`` is the (1, T) context for TEXT recomputes.  ``start_t`` is
    the request's *arrival* instant on the virtual clock: the wave scheduler
    starts the clock there outright; the continuous scheduler anchors the
    SLO there and admits the request when a row frees (TTFT then includes
    queueing delay).
    """

    session: ServeSession
    context_id: str
    tokens: np.ndarray
    network: NetworkModel
    prior_throughput_gbps: Optional[float] = None
    start_t: float = 0.0
    # any Transport (Local/Sim/Tcp) for this request's fetches; None falls
    # back to the session's transport, else to a per-request SimTransport
    # over ``network`` (see SessionTask.__init__)
    transport: Optional[object] = None
    # what to generate once the load completes (continuous scheduler only);
    # None or a zero-token spec = load-only
    generation: Optional[GenerationSpec] = None


@dataclasses.dataclass
class SchedulerResult:
    """N per-request results plus scheduler-level batching counters.

    ``sessions[r].caches`` is request ``r``'s batch-1 view of the shared
    batch-of-requests cache (``caches`` holds the full batch).  Virtual
    times (``ttft_s``) are per-request and contention-aware; ``wall_*`` on
    the scheduler are realized host seconds for the whole batch run, and
    each session's ``wall_*`` is its token-weighted share of the batched
    dispatches it participated in.
    """

    sessions: List[SessionResult]
    caches: Caches
    wall_total_s: float
    wall_decode_s: float
    wall_recompute_s: float
    n_rounds: int
    n_decode_batches: int
    n_text_batches: int
    n_runs: int

    @property
    def n_failed(self) -> int:
        """Requests that finished with a failure status (isolated, not
        raised): their rows were recycled and no batch was poisoned."""
        return sum(1 for s in self.sessions if s.status != "ok")


# ---------------------------------------------------------------------------
# Shared batched executors (wave + continuous)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _SessionAccount:
    """Per-session share of the batched dispatch times."""

    decode_s: float = 0.0
    recompute_s: float = 0.0
    runs: int = 0


@dataclasses.dataclass
class _BatchStats:
    decode_s: float = 0.0
    recompute_s: float = 0.0
    gen_s: float = 0.0  # wall seconds in stacked generation steps
    n_rounds: int = 0
    n_decode_batches: int = 0
    n_text_batches: int = 0
    n_runs: int = 0
    n_gen_steps: int = 0
    n_gen_tokens: int = 0


def _execute_runs(
    engine: Engine,
    runs: List[RunWork],
    caches: Caches,
    acct_by_row: Mapping[int, _SessionAccount],
    stats: _BatchStats,
) -> Caches:
    """Cross-request stacked decode + one batched insert per table set."""
    if not runs:
        return caches
    groups: Dict[int, List[RunWork]] = {}
    for w in runs:
        groups.setdefault(id(w.tables), []).append(w)
    for group in groups.values():
        total = sum(w.n_tokens for w in group)
        with tracing.span("sched.decode", rows=len(group), tokens=total):
            t0 = time.perf_counter()
            # token counts come from the plan (validated against every
            # fetched blob's header at fetch time); decode_chunk_runs
            # cross-checks the decoded total against them
            kv, spans = kvcodec.decode_chunk_runs(
                [w.blobs for w in group],
                group[0].tables,
                out_dtype=kv_layout.cache_dtype(caches),
                run_tokens=[w.n_tokens for w in group],
            )
            caches = engine.insert_runs(
                caches,
                kv,
                rows=[w.row for w in group],
                starts=[w.start for w in group],
                run_tokens=[n for _, n in spans],
            )
            dt = time.perf_counter() - t0
        stats.decode_s += dt
        stats.n_decode_batches += 1
        stats.n_runs += len(group)
        for w in group:
            acct_by_row[w.row].decode_s += dt * w.n_tokens / total
            acct_by_row[w.row].runs += 1
    return caches


def _execute_texts(
    engine: Engine,
    texts: List[TextWork],
    caches: Caches,
    acct_by_row: Mapping[int, _SessionAccount],
    stats: _BatchStats,
) -> Caches:
    """Coalesced TEXT recompute: one padded masked forward per chunk width
    (rows whose request has no TEXT chunk this round are masked out with
    width 0)."""
    if not texts:
        return caches
    n = kv_layout.cache_batch(caches)
    dev = engine.device
    by_tc: Dict[int, List[TextWork]] = {}
    for w in texts:
        by_tc.setdefault(w.n_tokens, []).append(w)
    for tc, group in sorted(by_tc.items()):
        t0 = time.perf_counter()
        if 2 * len(group) >= n:
            # most (or all) rows recompute: width-masked full-batch
            # forward — non-participating rows ride along with width 0,
            # no gather/scatter traffic
            toks = torch.zeros((n, tc), dtype=torch.long, device=dev)
            widths = np.zeros((n,), np.int32)
            for w in group:
                toks[w.row] = torch.as_tensor(w.tokens[0], device=dev)
                widths[w.row] = tc
            _, caches = engine.prefill_extend_rows(toks, caches, widths)
        else:
            # a small subset: gather the participating rows into a
            # compact sub-batch so compute scales with them, not the
            # full batch
            toks = torch.stack(
                [torch.as_tensor(w.tokens[0], device=dev).to(torch.long) for w in group]
            )
            _, caches = engine.prefill_extend_gather(
                toks, caches, [w.row for w in group]
            )
        dt = time.perf_counter() - t0
        stats.recompute_s += dt
        stats.n_text_batches += 1
        # token-weighted share, mirroring the decode accounting (groups are
        # same-width today, so this equals an even split — but the share
        # rule must not silently change if grouping ever mixes widths)
        total = sum(w.n_tokens for w in group)
        for w in group:
            acct_by_row[w.row].recompute_s += dt * w.n_tokens / total
    return caches


def _validate_requests(engine: Engine, requests: List[SessionRequest]) -> None:
    for r in requests:
        if r.session.engine is not engine:
            raise ValueError(
                "every request's session must share the scheduler's Engine"
            )
        if r.tokens.ndim != 2 or r.tokens.shape[0] != 1:
            raise ValueError(
                f"scheduler requests are single-row: tokens must be (1, T), "
                f"got {r.tokens.shape}"
            )


def _req_label(idx: int, r: SessionRequest) -> str:
    return f"req{idx}:{r.context_id}"


# ---------------------------------------------------------------------------
# Closed waves — the continuous scheduler's differential oracle
# ---------------------------------------------------------------------------


class ConcurrentScheduler:
    """Run N adaptive context loads concurrently against one shared Engine,
    as one closed wave: all requests admitted up front, the wave drains to
    empty.

    ``contention=None`` calibrates from this host's measured stacked-decode
    throughput (``ContentionModel.measured()``); pass an explicit
    :class:`~repro_torch.streaming.pipeline.ContentionModel` to pin the factors
    (e.g. ``ContentionModel({})`` for the conservative fully-serialized
    model, or ``ContentionModel({1: 1.0, 8: 1.0})`` for an idealized
    perfectly-batching engine).

    On a mesh-sharded engine (``engine.n_shards > 1``) the wave prices
    contention per shard — N live loads spread over S row shards read the
    measured curve at ``ceil(N/S)`` — and ``shard_transports`` (one
    Transport per shard) gives each shard its own fetch bandwidth domain:
    a request without its own transport fetches through its row's shard
    transport.  On an unsharded engine both are exact no-ops.
    """

    def __init__(
        self,
        engine: Engine,
        *,
        contention: Optional[ContentionModel] = None,
        shard_transports: Optional[Sequence[object]] = None,
    ):
        self.engine = engine
        self.contention = (
            contention if contention is not None else ContentionModel.measured()
        )
        self.shard_transports = (
            list(shard_transports) if shard_transports is not None else None
        )
        n_shards = max(int(getattr(engine, "n_shards", 1)), 1)
        if self.shard_transports is not None and len(self.shard_transports) != n_shards:
            raise ValueError(
                f"shard_transports carries {len(self.shard_transports)} "
                f"transports for a {n_shards}-shard engine — one per shard"
            )
        self._n_active = 1

    # ------------------------------------------------------------------

    def run(self, requests: List[SessionRequest]) -> SchedulerResult:
        with tracing.span("sched.run", requests=len(requests)):
            return self._run(requests)

    def _run(self, requests: List[SessionRequest]) -> SchedulerResult:
        if not requests:
            raise ValueError("ConcurrentScheduler.run needs at least one request")
        _validate_requests(self.engine, requests)
        n = len(requests)
        # a sharded engine's cache rounds up to whole row shards; the extra
        # rows stay inactive (width 0 / never decoded) for the whole wave
        n_cache = self.engine.cache_rows(n)
        caches = self.engine.empty_caches(n_cache)
        if not kv_layout.has_kv(caches):
            raise ValueError(
                f"scheduler needs a KV-cache family, got {self.engine.cfg.family}"
            )
        n_shards = max(int(getattr(self.engine, "n_shards", 1)), 1)
        rows_per_shard = n_cache // n_shards
        scale = lambda: self.contention.factor_sharded(  # noqa: E731
            self._n_active, n_shards
        )
        tscale = lambda: self.contention.text_factor_sharded(  # noqa: E731
            self._n_active, n_shards
        )

        def _transport(i: int, r: SessionRequest):
            if r.transport is not None or self.shard_transports is None:
                return r.transport
            return self.shard_transports[i // rows_per_shard]

        tasks = [
            SessionTask(
                r.session,
                r.context_id,
                r.tokens,
                r.network,
                row=i,
                prior_throughput_gbps=r.prior_throughput_gbps,
                start_t=r.start_t,
                compute_scale=scale,
                text_scale=tscale,
                transport=_transport(i, r),
                label=_req_label(i, r),
            )
            for i, r in enumerate(requests)
        ]
        acct = [_SessionAccount() for _ in tasks]
        acct_by_row = {i: a for i, a in enumerate(acct)}
        stats = _BatchStats()
        self._n_active = n
        wall0 = time.perf_counter()
        while True:
            live = [t for t in tasks if not t.done]
            if not live:
                break
            stats.n_rounds += 1
            # step in virtual-time order: the session whose next fetch
            # completes first resolves its chunk first (matches how a real
            # shared frontend would see arrivals).  Over wall-real
            # transports (tcp / paced sim), a task whose in-flight fetch
            # hasn't landed yet is deferred to a later round rather than
            # blocked on — one straggling socket must not convoy the other
            # sessions' ready work; when nothing is ready, block on the
            # virtual-earliest fetch (the round has no other work to do).
            live.sort(key=lambda t: t.next_fetch_t)
            ready = [t for t in live if t.fetch_ready]
            round_runs: List[RunWork] = []
            round_texts: List[TextWork] = []
            for t in ready if ready else live[:1]:
                self._n_active = sum(1 for x in tasks if not x.done)
                for w in t.step():
                    (round_runs if isinstance(w, RunWork) else round_texts).append(w)
            # drain: decodes/inserts land before recomputes — a task emits
            # at most [run, text] per round, so this preserves its order
            caches = _execute_runs(self.engine, round_runs, caches, acct_by_row, stats)
            caches = _execute_texts(self.engine, round_texts, caches, acct_by_row, stats)
        with tracing.span("sched.sync"):
            kv_layout.synchronize(caches)  # the wall total is end-to-end only then
        wall_total = time.perf_counter() - wall0

        sessions = [
            t.result(
                extract_row(caches, i),
                wall_decode_s=acct[i].decode_s,
                wall_recompute_s=acct[i].recompute_s,
                wall_total_s=wall_total,
                n_runs=acct[i].runs,
            )
            for i, t in enumerate(tasks)
        ]
        return SchedulerResult(
            sessions=sessions,
            caches=caches,
            wall_total_s=wall_total,
            wall_decode_s=stats.decode_s,
            wall_recompute_s=stats.recompute_s,
            n_rounds=stats.n_rounds,
            n_decode_batches=stats.n_decode_batches,
            n_text_batches=stats.n_text_batches,
            n_runs=stats.n_runs,
        )


# ---------------------------------------------------------------------------
# Row pool
# ---------------------------------------------------------------------------


class RowPool:
    """Fixed-capacity free-list over the batch-of-requests cache's rows.

    Lowest free row first (deterministic recycling), with per-row
    bookkeeping the continuous scheduler needs: since when a row has been
    free (so a backdated admission charges no phantom queueing) and whether
    it carries a previous tenant's data (so recycled rows — and only those —
    are zeroed).  Misuse raises with the request id and the pool state
    named: double allocation beyond capacity, releasing an unallocated row,
    releasing another request's row.

    Shard-aware row addressing: the base pool is one shard — every row maps
    to shard 0.  :class:`ShardedRowPool` partitions the row space into
    blocked per-shard ranges matching the sharded engine's cache layout and
    balances allocation across them.
    """

    n_shards: int = 1

    def __init__(self, n_rows: int):
        if n_rows < 1:
            raise ValueError(f"RowPool needs at least one row, got {n_rows}")
        self.n_rows = int(n_rows)
        self.rows_per_shard = self.n_rows
        self._free = list(range(self.n_rows))  # heap, ascending
        self._owner: Dict[int, str] = {}
        self._free_since = {r: 0.0 for r in range(self.n_rows)}
        self._dirty: set = set()

    def shard_of(self, row: int) -> int:
        """Shard owning ``row`` under the blocked layout (always 0 here)."""
        return 0

    def _peek_next(self) -> int:
        """The row :meth:`allocate` would hand out next (lowest free)."""
        return self._free[0]

    def _pop_next(self) -> int:
        return heapq.heappop(self._free)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def next_free_since(self) -> float:
        """Free instant of the row :meth:`allocate` would hand out next —
        the admission-policy frontier when nothing is live: every waiter
        arrived by then is an EDF candidate."""
        if not self._free:
            raise RuntimeError(f"no free rows ({self.describe()})")
        return self._free_since[self._peek_next()]

    def describe(self) -> str:
        occupied = ", ".join(
            f"row {r} -> {o!r}" for r, o in sorted(self._owner.items())
        )
        return (
            f"{self.n_free}/{self.n_rows} rows free"
            + (f"; occupied: {occupied}" if occupied else "")
        )

    def allocate(self, owner: str) -> Tuple[int, float, bool]:
        """Take the next free row (lowest; sharded pools balance shard load
        first) for ``owner``.

        Returns ``(row, free_since_t, needs_reset)``; the caller must zero
        the row (``Engine.reset_rows``) when ``needs_reset`` — it carries a
        previous tenant's KV and length.
        """
        if not self._free:
            raise RuntimeError(
                f"admitting request {owner!r} beyond row-pool capacity: "
                f"{self.describe()}"
            )
        row = self._pop_next()
        if row in self._owner:  # internal invariant, should be unreachable
            raise RuntimeError(
                f"row pool corrupt: free row {row} already owned by "
                f"{self._owner[row]!r} ({self.describe()})"
            )
        self._owner[row] = owner
        dirty = row in self._dirty
        self._dirty.discard(row)
        return row, self._free_since[row], dirty

    def release(self, row: int, owner: str, now_t: float) -> None:
        """Return ``owner``'s row to the free list at virtual instant
        ``now_t`` (session finished or was preempted)."""
        if row not in self._owner:
            raise RuntimeError(
                f"releasing row {row} for request {owner!r}: row is not "
                f"allocated ({self.describe()})"
            )
        if self._owner[row] != owner:
            raise RuntimeError(
                f"releasing row {row} for request {owner!r}: row is owned "
                f"by {self._owner[row]!r} ({self.describe()})"
            )
        del self._owner[row]
        self._free_since[row] = float(now_t)
        self._dirty.add(row)
        heapq.heappush(self._free, row)


class ShardedRowPool(RowPool):
    """Row pool over a mesh-sharded cache: rows map to shards in blocked
    ranges (row ``r`` → shard ``r // rows_per_shard``, the layout of
    ``serving.mesh_engine.ShardedEngine``), and allocation balances *load*
    across shards — the free row on the least-occupied shard, lowest row
    breaking ties — so stacked decode steps and per-shard transports see
    even per-shard widths instead of piling the first arrivals onto
    shard 0.  On one shard this degenerates to the base pool's
    lowest-free-row order exactly."""

    def __init__(self, n_rows: int, *, n_shards: int):
        if n_shards < 1:
            raise ValueError(
                f"ShardedRowPool needs n_shards >= 1, got {n_shards}"
            )
        if n_rows % n_shards:
            raise ValueError(
                f"ShardedRowPool: {n_rows} rows do not split over "
                f"{n_shards} shards (whole shards required — size the cache "
                f"with Engine.cache_rows)"
            )
        super().__init__(n_rows)
        self.n_shards = int(n_shards)
        self.rows_per_shard = self.n_rows // self.n_shards

    def shard_of(self, row: int) -> int:
        return int(row) // self.rows_per_shard

    def _peek_next(self) -> int:
        load = [0] * self.n_shards
        for r in self._owner:
            load[self.shard_of(r)] += 1
        return min(self._free, key=lambda r: (load[self.shard_of(r)], r))

    def _pop_next(self) -> int:
        row = self._peek_next()
        self._free.remove(row)
        heapq.heapify(self._free)
        return row


# ---------------------------------------------------------------------------
# Continuous admission
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PreemptionPolicy:
    """When may a waiting request evict a live session, and which one?

    A live *loading* session is preemptible when its in-flight fetch's
    completion is knowable (peeked from the handle / the virtual clock) and
    lands more than ``margin_s`` past the session's own SLO deadline — it
    will blow its SLO regardless, so holding the row only convoys the
    queue.  With ``require_waiting_headroom`` (default) the waiter must
    still have SLO headroom at the preemption instant; a waiter that has
    already blown its own deadline gains nothing from thrashing another
    session's row.

    ``victim`` picks among the eligible candidates:

    * ``"straggler"`` (default) — evict the latest-landing
      doomed fetch; only doomed loaders are candidates.
    * ``"least_work"`` — cost-aware: evict the candidate with the least
      *realized* work (tokens materialized in its row), so the cheapest
      state to re-establish leaves first.  Generating sessions join the
      candidate set here — their TTFT is already served and their residual
      state suspends losslessly (bit-exact row snapshot + host-side next
      token) — but since their realized work includes the whole context
      plus emitted tokens, they are evicted only when no cheaper doomed
      loader exists.  Under either rule a generating candidate must have
      emitted at least one token since it (re)started — a freshly resumed
      (or just-transitioned) generation is not instantly re-evictable,
      which is what keeps two generating rows from livelocking by swapping
      one row back and forth at a single virtual instant (the multi-row
      pools of the mesh-sharded engine make this case the norm).

    Likewise a *loading* session that took its row by preempting another is
    not evictable at the instant it took the row, only once its clock has
    moved past it.  Without this guard two doomed loads evict each other at
    one virtual instant without end, each waiter still inside its SLO and
    each resumed fetch still landing past it.  The reference scheduler has
    no such guard (it runs into ``MAX_PREEMPTIONS`` there, and evicts such
    a load at once in chains that do end): a deliberate divergence.

    ``gen_slo`` additionally makes a *generating* session eligible (under
    either victim rule) once it has already missed its per-token SLO
    (``GenerationSpec.gen_slo_s``, realized TPOT over the limit) on a token
    emitted since its last resume — it is demonstrably not meeting its
    latency target, so a ready waiter may take its row rather than convoy.
    The since-resume gate stops a freshly restored task from being
    re-evicted for pre-suspension misses before it takes a single step.
    Such rows carry an infinite ``end_t``, so the straggler rule prefers
    them over any doomed loader (a fetch that lands late still lands; a
    missed gen-SLO never un-misses).
    """

    margin_s: float = 0.0
    require_waiting_headroom: bool = True
    victim: str = "straggler"
    gen_slo: bool = False

    def __post_init__(self):
        if self.victim not in ("straggler", "least_work"):
            raise ValueError(
                f"PreemptionPolicy.victim must be 'straggler' or "
                f"'least_work', got {self.victim!r}"
            )


@dataclasses.dataclass(frozen=True)
class _VictimCandidate:
    """One preemption-eligible session (eligibility already filtered)."""

    obj: object  # SessionTask (loading) or GenerationTask (generating)
    is_gen: bool
    end_t: float  # doomed fetch's landing instant (inf for generating rows)
    preempt_t: float  # the instant the eviction would take effect
    work: int  # realized tokens in the row (context + emitted for gen)


def _select_victim(
    policy: PreemptionPolicy, candidates: List[_VictimCandidate]
) -> Optional[_VictimCandidate]:
    """Pick the eviction victim among eligible candidates.

    ``straggler`` takes the latest-landing fetch, ``least_work`` the least
    realized work; both break ties in candidate order (which the caller
    builds in live-list order).
    """
    if not candidates:
        return None
    best = candidates[0]
    if policy.victim == "least_work":
        for c in candidates[1:]:
            if c.work < best.work:
                best = c
        return best
    for c in candidates[1:]:
        if c.end_t > best.end_t:
            best = c
    return best


@dataclasses.dataclass
class RequestTimeline:
    """Admission-level life of one request on the virtual clock.

    ``finish_t`` is the *load*'s completion (the TTFT instant).  When the
    request generates, ``tokens_out`` / ``token_ts`` record each emitted
    token and its virtual emission instant, and ``gen_finish_t`` the last
    token's — so TPOT and end-to-end latency both read off the timeline.
    ``gen_slo_miss`` counts emitted tokens whose realized TPOT exceeded the
    request's ``GenerationSpec.gen_slo_s`` (0 when no per-token SLO was
    set).
    """

    index: int
    arrival_t: float
    admit_t: float = float("nan")
    finish_t: float = float("nan")
    rows_used: List[int] = dataclasses.field(default_factory=list)
    preempt_ts: List[float] = dataclasses.field(default_factory=list)
    resume_ts: List[float] = dataclasses.field(default_factory=list)
    tokens_out: List[int] = dataclasses.field(default_factory=list)
    token_ts: List[float] = dataclasses.field(default_factory=list)
    gen_finish_t: float = float("nan")
    gen_slo_miss: int = 0

    @property
    def queue_wait_s(self) -> float:
        return self.admit_t - self.arrival_t

    @property
    def n_preemptions(self) -> int:
        return len(self.preempt_ts)

    @property
    def n_tokens_out(self) -> int:
        return len(self.tokens_out)

    @property
    def tpot_s(self) -> List[float]:
        """Per-output-token latencies: the first token is measured from the
        load's finish (the TTFT instant), each later token from the
        previous one — suspension time between tokens is included."""
        if not self.token_ts:
            return []
        prev = [self.finish_t] + self.token_ts[:-1]
        return [t - p for t, p in zip(self.token_ts, prev)]

    @property
    def mean_tpot_s(self) -> float:
        tp = self.tpot_s
        return sum(tp) / len(tp) if tp else float("nan")


@dataclasses.dataclass
class ContinuousResult:
    """Per-request results (request order) plus open-loop counters.

    ``sessions[i].ttft_s`` is measured from request ``i``'s *arrival* —
    queueing and suspension time included.  ``occupancy`` samples the live
    loading-row count per round ``(virtual_t, n_live)`` and
    ``gen_occupancy`` the stacked-step width per generation step
    ``(virtual_t, n_generating)``; preemption/resume counts aggregate the
    per-request ``timeline`` entries.  ``wall_gen_s`` is realized host
    seconds inside stacked ``decode_step_rows`` dispatches (per-step token
    sync included), so ``n_gen_tokens / wall_gen_s`` is the engine's
    realized aggregate generation throughput.
    """

    sessions: List[SessionResult]
    timeline: List[RequestTimeline]
    occupancy: List[Tuple[float, int]]
    n_rows: int
    wall_total_s: float
    wall_decode_s: float
    wall_recompute_s: float
    n_rounds: int
    n_decode_batches: int
    n_text_batches: int
    n_runs: int
    n_preemptions: int
    n_resumes: int
    gen_occupancy: List[Tuple[float, int]] = dataclasses.field(default_factory=list)
    wall_gen_s: float = 0.0
    n_gen_steps: int = 0
    n_gen_tokens: int = 0

    @property
    def n_failed(self) -> int:
        """Requests that finished with a failure status (isolated, not
        raised): their rows were recycled and no batch was poisoned."""
        return sum(1 for s in self.sessions if s.status != "ok")

    @property
    def n_gen_slo_miss(self) -> int:
        """Emitted tokens (across all requests) whose realized TPOT missed
        the request's per-token generation SLO."""
        return sum(t.gen_slo_miss for t in self.timeline)


class ContinuousScheduler:
    """Open-loop serving: arrivals feed a row pool; rows recycle on finish.

    ``rows=None`` sizes the pool to the request count (pure continuous
    batching with no queueing — and, with every arrival at t=0 and
    preemption off, exact wave-scheduler degeneration).  ``preemption=None``
    disables preemption; pass a :class:`PreemptionPolicy` to let
    tight-deadline waiters evict sessions whose in-flight fetches straggle
    past their SLO (``victim="least_work"`` for cost-aware selection with
    generating rows eligible).  ``admission`` orders the ready waiters:
    ``"fifo"`` (default) by ``(ready_t, index)``, ``"edf"`` by SLO deadline
    (``start_t + slo_s``) — earliest deadline takes the next free row.
    ``contention`` as in :class:`ConcurrentScheduler`, driven here by the
    time-varying live-session count (loading + generating).  ``gen_step_s``
    is the virtual duration of one uncontended generation decode step;
    stacked steps of M rows charge ``gen_step_s ×
    contention.gen_factor(M)``.

    On a mesh-sharded engine (``engine.n_shards > 1``) the pool rounds up
    to whole row shards and balances admissions across them
    (:class:`ShardedRowPool`), contention prices per shard (the measured
    curves read at the even-spread per-shard width, and a stacked step at
    the *busiest shard's* participant count — shards step in lockstep, so
    the widest shard sets the step's duration), and ``shard_transports``
    (one Transport per shard) fans fetch bandwidth out per shard: a request
    without its own transport fetches through whichever shard its current
    row lives on, re-bound on every resume.  At one shard every one of
    these degenerates exactly to the unsharded behavior.
    """

    # hard backstop against a pathological preempt/resume livelock: any
    # legitimate workload preempts orders of magnitude less than this
    MAX_PREEMPTIONS = 100_000

    def __init__(
        self,
        engine: Engine,
        *,
        rows: Optional[int] = None,
        contention: Optional[ContentionModel] = None,
        preemption: Optional[PreemptionPolicy] = None,
        admission: str = "fifo",
        gen_step_s: float = 2e-3,
        shard_transports: Optional[Sequence[object]] = None,
    ):
        if rows is not None and rows < 1:
            raise ValueError(f"ContinuousScheduler needs rows >= 1, got {rows}")
        if admission not in ("fifo", "edf"):
            raise ValueError(
                f"ContinuousScheduler admission must be 'fifo' or 'edf', "
                f"got {admission!r}"
            )
        if gen_step_s <= 0:
            raise ValueError(
                f"ContinuousScheduler needs gen_step_s > 0, got {gen_step_s}"
            )
        self.engine = engine
        self.rows = rows
        self.contention = (
            contention if contention is not None else ContentionModel.measured()
        )
        self.preemption = preemption
        self.admission = admission
        self.gen_step_s = float(gen_step_s)
        self.shard_transports = (
            list(shard_transports) if shard_transports is not None else None
        )
        n_shards = max(int(getattr(engine, "n_shards", 1)), 1)
        if self.shard_transports is not None and len(self.shard_transports) != n_shards:
            raise ValueError(
                f"shard_transports carries {len(self.shard_transports)} "
                f"transports for a {n_shards}-shard engine — one per shard"
            )
        self._n_active = 1

    # ------------------------------------------------------------------

    def run(self, requests: List[SessionRequest]) -> ContinuousResult:
        if not requests:
            raise ValueError("ContinuousScheduler.run needs at least one request")
        _validate_requests(self.engine, requests)
        n_shards = max(int(getattr(self.engine, "n_shards", 1)), 1)
        n_rows = self.rows if self.rows is not None else len(requests)
        # sharded caches allocate whole row shards; the rounded-up rows are
        # real pool capacity (admittable), not dead padding
        n_rows = self.engine.cache_rows(n_rows)
        caches = self.engine.empty_caches(n_rows)
        if not kv_layout.has_kv(caches):
            raise ValueError(
                f"scheduler needs a KV-cache family, got {self.engine.cfg.family}"
            )
        pool = (
            ShardedRowPool(n_rows, n_shards=n_shards)
            if n_shards > 1
            else RowPool(n_rows)
        )
        scale = lambda: self.contention.factor_sharded(  # noqa: E731
            self._n_active, n_shards
        )
        tscale = lambda: self.contention.text_factor_sharded(  # noqa: E731
            self._n_active, n_shards
        )

        tasks: List[Optional[SessionTask]] = [None] * len(requests)
        snaps: Dict[int, object] = {}  # request idx -> RowSnapshot
        # request idx -> the instant its load took a row by preemption: it
        # is not evictable at that instant
        took_by_preemption: Dict[int, float] = {}
        acct = [_SessionAccount() for _ in requests]
        timeline = [
            RequestTimeline(index=i, arrival_t=float(r.start_t))
            for i, r in enumerate(requests)
        ]
        results: List[Optional[SessionResult]] = [None] * len(requests)
        stats = _BatchStats()
        occupancy: List[Tuple[float, int]] = []
        n_preempt = n_resume = 0

        # admission queue: arrivals up front, suspended sessions re-enter
        # at their suspension instant; (ready_t, index) heap order
        waiting: List[Tuple[float, int]] = [
            (float(r.start_t), i) for i, r in enumerate(requests)
        ]
        heapq.heapify(waiting)
        live: List[SessionTask] = []
        acct_by_row: Dict[int, _SessionAccount] = {}
        row_owner: Dict[int, int] = {}  # row -> request idx

        # generation phase: sessions that finished loading and now emit
        # output tokens on their row; suspended generations park here and
        # re-enter through the same waiting queue as suspended loads
        generating: List[GenerationTask] = []
        parked_gen: Dict[int, GenerationTask] = {}
        gen_occupancy: List[Tuple[float, int]] = []
        gen_busy_t = 0.0  # the engine's generation-step frontier

        def _slo_deadline(idx: int) -> float:
            return float(requests[idx].start_t) + requests[idx].session.slo_s

        def peek_next_waiter(frontier: float) -> Tuple[float, int]:
            """The waiter the admission policy would admit next among those
            ready by ``frontier`` (FIFO: earliest ready; EDF: earliest SLO
            deadline, FIFO order breaking ties)."""
            if self.admission == "edf":
                ready = [w for w in waiting if w[0] <= frontier]
                return min(ready, key=lambda w: (_slo_deadline(w[1]), w))
            return waiting[0]

        def pop_next_waiter(frontier: float) -> Tuple[float, int]:
            if self.admission == "edf":
                best = peek_next_waiter(frontier)
                waiting.remove(best)
                heapq.heapify(waiting)
                return best
            return heapq.heappop(waiting)

        def row_transport(row: int, r: SessionRequest):
            """The transport a session on ``row`` fetches through: its own
            if the request pinned one, else its row shard's transport (the
            per-shard fetch-bandwidth domain), else the session fallback."""
            if r.transport is not None or self.shard_transports is None:
                return r.transport
            return self.shard_transports[pool.shard_of(row)]

        def admit(idx: int, ready_t: float) -> None:
            nonlocal caches, n_resume
            r = requests[idx]
            row, free_since, dirty = pool.allocate(_req_label(idx, r))
            if dirty:
                caches = self.engine.reset_rows(caches, [row])
            # a row free since before the request was ready charges no
            # phantom queueing: admission is backdated to ready_t itself
            admit_t = max(ready_t, free_since)
            g = parked_gen.pop(idx, None)
            if g is not None:
                # a suspended *generation* resumes: restore the snapshot
                # (context + emitted KV, bit-exact) and rejoin the decode
                # batch at the next step boundary
                caches = self.engine.restore_row(caches, snaps.pop(idx), row)
                g.resume(row, admit_t)
                generating.append(g)
                timeline[idx].resume_ts.append(admit_t)
                n_resume += 1
                timeline[idx].rows_used.append(row)
                row_owner[row] = idx
                acct_by_row[row] = acct[idx]
                return
            t = tasks[idx]
            if t is None:
                t = SessionTask(
                    r.session,
                    r.context_id,
                    r.tokens,
                    r.network,
                    row=row,
                    prior_throughput_gbps=r.prior_throughput_gbps,
                    start_t=r.start_t,
                    compute_scale=scale,
                    text_scale=tscale,
                    transport=row_transport(row, r),
                    label=_req_label(idx, r),
                )
                t.begin_at(admit_t)
                tasks[idx] = t
                timeline[idx].admit_t = admit_t
            else:
                t.resume(row, admit_t)
                if r.transport is None and self.shard_transports is not None:
                    # the resumed row may live on a different shard: fetches
                    # from here on go through that shard's transport
                    t.transport = self.shard_transports[pool.shard_of(row)]
                caches = self.engine.restore_row(caches, snaps.pop(idx), row)
                timeline[idx].resume_ts.append(admit_t)
                n_resume += 1
            timeline[idx].rows_used.append(row)
            row_owner[row] = idx
            acct_by_row[row] = acct[idx]
            live.append(t)

        def preempt(victim: SessionTask, now_t: float) -> None:
            nonlocal caches, n_preempt
            idx = row_owner[victim.row]
            row = victim.row
            snaps[idx] = self.engine.save_row(caches, row, victim.realized_tokens)
            victim.suspend(now_t)  # cancels the in-flight fetch handle
            live.remove(victim)
            del row_owner[row]
            del acct_by_row[row]
            pool.release(row, victim.label, now_t)
            timeline[idx].preempt_ts.append(now_t)
            n_preempt += 1
            if n_preempt > self.MAX_PREEMPTIONS:
                raise RuntimeError(
                    f"preemption runaway: {n_preempt} preemptions "
                    f"({pool.describe()})"
                )
            heapq.heappush(waiting, (now_t, idx))

        def preempt_gen(g: GenerationTask, now_t: float) -> None:
            nonlocal caches, n_preempt
            idx = g.index
            row = g.row
            # the snapshot spans context + emitted tokens; current_token
            # rides host-side, so the resumed decode is bit-exact
            snaps[idx] = self.engine.save_row(caches, row, g.realized_tokens)
            g.suspend(now_t)
            # surface the running miss count while parked (the completion
            # handler writes the final one)
            timeline[idx].gen_slo_miss = g.slo_misses
            generating.remove(g)
            parked_gen[idx] = g
            del row_owner[row]
            del acct_by_row[row]
            pool.release(row, g.label, now_t)
            timeline[idx].preempt_ts.append(now_t)
            n_preempt += 1
            if n_preempt > self.MAX_PREEMPTIONS:
                raise RuntimeError(
                    f"preemption runaway: {n_preempt} preemptions "
                    f"({pool.describe()})"
                )
            heapq.heappush(waiting, (now_t, idx))

        def start_generation(idx: int, t: SessionTask, finish_t: float) -> bool:
            """Transition a finished load into the generating phase on its
            row.  False (no transition) for load-only or failed requests."""
            spec = requests[idx].generation
            if spec is None or spec.n_tokens <= 0 or t.failed:
                return False
            generating.append(
                GenerationTask(
                    spec,
                    index=idx,
                    label=t.label,
                    row=t.row,
                    start_t=finish_t,
                    context_tokens=t.realized_tokens,
                    capacity=self.engine.capacity,
                )
            )
            return True

        def gen_next_t() -> float:
            """Virtual instant of the next stacked generation step: the
            engine frontier, or the earliest ready row if later."""
            return max(gen_busy_t, min(g.ready_t for g in generating))

        def gen_step() -> None:
            """One stacked decode step: every generating row that is ready
            at the step instant advances one token in a single
            ``decode_step_rows`` dispatch; rows mid-resume join the next
            step (continuous batching at step boundaries)."""
            nonlocal caches, gen_busy_t
            step_t = gen_next_t()
            part = [g for g in generating if g.ready_t <= step_t]
            tokens = np.zeros((n_rows, 1), np.int32)
            active = np.zeros((n_rows,), bool)
            for g in part:
                tokens[g.row, 0] = g.current_token
                active[g.row] = True
            t0 = time.perf_counter()
            logits, caches = self.engine.decode_step_rows(tokens, caches, active)
            # host sync per step: the sampled tokens are the next inputs
            last = logits[:, -1].float().cpu().numpy()
            dt = time.perf_counter() - t0
            m = len(part)
            # the shards step in lockstep, so the step's virtual duration is
            # the busiest shard's stacked width (== m on one shard)
            if n_shards > 1:
                per_shard = [0] * n_shards
                for g in part:
                    per_shard[pool.shard_of(g.row)] += 1
                width = max(per_shard)
            else:
                width = m
            end_t = step_t + self.gen_step_s * self.contention.gen_factor(width)
            stats.gen_s += dt
            stats.n_gen_steps += 1
            stats.n_gen_tokens += m
            gen_occupancy.append((step_t, m))
            for g in part:
                g.record(g.next_token(last[g.row]), end_t)
            gen_busy_t = end_t
            for g in [x for x in part if x.done]:
                idx = g.index
                timeline[idx].tokens_out = list(g.tokens_out)
                timeline[idx].token_ts = list(g.token_ts)
                timeline[idx].gen_finish_t = end_t
                timeline[idx].gen_slo_miss = g.slo_misses
                generating.remove(g)
                del row_owner[g.row]
                del acct_by_row[g.row]
                pool.release(g.row, g.label, end_t)

        wall0 = time.perf_counter()
        while live or waiting or generating:
            # --- admission + preemption at the virtual frontier ------------
            if waiting:
                if live or generating:
                    horizons = [t.horizon_t() for t in live]
                    if generating:
                        horizons.append(gen_next_t())
                    frontier = min(horizons)
                else:
                    # nothing live: the next admission happens at the freed
                    # row's release instant (or the earliest arrival if the
                    # row freed before anyone arrived), so every waiter
                    # arrived by then is an admission candidate — EDF must
                    # rank them all, not just the earliest arrival
                    frontier = max(waiting[0][0], pool.next_free_since)
                while waiting and waiting[0][0] <= frontier and pool.n_free > 0:
                    ready_t, idx = pop_next_waiter(frontier)
                    admit(idx, ready_t)
                while (
                    self.preemption is not None
                    and waiting
                    and pool.n_free == 0
                    and waiting[0][0] <= frontier
                ):
                    policy = self.preemption
                    head_ready, head_idx = peek_next_waiter(frontier)
                    head_deadline = _slo_deadline(head_idx)
                    cands: List[_VictimCandidate] = []
                    for t in live:
                        end = t.peek_pending_end_t()
                        if end is None:
                            continue
                        # a candidate's eviction instant: when the waiter
                        # became ready, but never before the candidate's
                        # in-flight fetch started (the engine cannot cancel
                        # in the past)
                        preempt_t = max(head_ready, t.next_fetch_t)
                        if end <= t.deadline_t + policy.margin_s:
                            continue  # fetch lands within the SLO: keep it
                        if preempt_t <= took_by_preemption.get(row_owner[t.row], float("-inf")):
                            continue  # took its row by preemption at this instant
                        if (
                            policy.require_waiting_headroom
                            and preempt_t >= head_deadline
                        ):
                            continue  # waiter would start already expired
                        cands.append(_VictimCandidate(
                            obj=t, is_gen=False, end_t=end,
                            preempt_t=preempt_t, work=t.realized_tokens,
                        ))
                    # generating rows are eligible under the cost-aware rule
                    # (TTFT already served, residual work suspends
                    # losslessly — no doomed-fetch test applies), and under
                    # either rule with ``gen_slo`` once they have missed
                    # their per-token SLO on a post-resume token
                    for g in generating:
                        # anti-thrash guard: a generation that has not
                        # emitted a token since it (re)started is not
                        # evictable — without this, two generating rows
                        # under ``least_work`` livelock (the evicted task
                        # re-enters as head waiter and evicts the other at
                        # the same virtual instant, forever)
                        if g.tokens_since_resume <= 0:
                            continue
                        slo_doomed = policy.gen_slo and g.slo_missed
                        if policy.victim != "least_work" and not slo_doomed:
                            continue
                        preempt_t = max(head_ready, g.ready_t)
                        if (
                            policy.require_waiting_headroom
                            and preempt_t >= head_deadline
                        ):
                            continue
                        cands.append(_VictimCandidate(
                            obj=g, is_gen=True, end_t=float("inf"),
                            preempt_t=preempt_t, work=g.realized_tokens,
                        ))
                    victim = _select_victim(policy, cands)
                    if victim is None:
                        break
                    pop_next_waiter(frontier)
                    if victim.is_gen:
                        preempt_gen(victim.obj, victim.preempt_t)
                    else:
                        preempt(victim.obj, victim.preempt_t)
                    if head_idx not in parked_gen:
                        took_by_preemption[head_idx] = victim.preempt_t
                    admit(head_idx, head_ready)
            if not live and not generating:
                continue  # admission above is guaranteed to make progress

            # --- generation step vs. load round: earliest event first ------
            if generating and (
                not live or gen_next_t() <= min(t.next_fetch_t for t in live)
            ):
                gen_step()
                continue

            # --- one wave-identical round over the live set ----------------
            stats.n_rounds += 1
            round_t = min(t.next_fetch_t for t in live)
            ordered = sorted(live, key=lambda t: t.next_fetch_t)
            ready = [t for t in ordered if t.fetch_ready]
            round_runs: List[RunWork] = []
            round_texts: List[TextWork] = []
            for t in ready if ready else ordered[:1]:
                self._n_active = (
                    sum(1 for x in live if not x.done) + len(generating)
                )
                for w in t.step():
                    (round_runs if isinstance(w, RunWork) else round_texts).append(w)
            caches = _execute_runs(self.engine, round_runs, caches, acct_by_row, stats)
            caches = _execute_texts(self.engine, round_texts, caches, acct_by_row, stats)

            # --- completions: extract the row, then generate or recycle ----
            for t in [x for x in live if x.done]:
                idx = row_owner[t.row]
                finish_t = max(t.clock.fetch_t, t.clock.compute_t)
                # a copy: the row now generates in place or is reset for
                # the next tenant, and the result keeps what the load realized
                results[idx] = t.result(
                    extract_row(caches, t.row).clone(),
                    wall_decode_s=acct[idx].decode_s,
                    wall_recompute_s=acct[idx].recompute_s,
                    wall_total_s=0.0,  # filled with the realized total below
                    n_runs=acct[idx].runs,
                )
                timeline[idx].finish_t = finish_t
                live.remove(t)
                if start_generation(idx, t, finish_t):
                    continue  # row stays: the session now generates on it
                del row_owner[t.row]
                del acct_by_row[t.row]
                pool.release(t.row, t.label, finish_t)
            occupancy.append((round_t, len(live)))
        kv_layout.synchronize(caches)  # the wall total is end-to-end only then
        wall_total = time.perf_counter() - wall0
        assert all(r is not None for r in results)
        for r in results:
            r.wall_total_s = wall_total
        return ContinuousResult(
            sessions=list(results),
            timeline=timeline,
            occupancy=occupancy,
            n_rows=n_rows,
            wall_total_s=wall_total,
            wall_decode_s=stats.decode_s,
            wall_recompute_s=stats.recompute_s,
            n_rounds=stats.n_rounds,
            n_decode_batches=stats.n_decode_batches,
            n_text_batches=stats.n_text_batches,
            n_runs=stats.n_runs,
            n_preemptions=n_preempt,
            n_resumes=n_resume,
            gen_occupancy=gen_occupancy,
            wall_gen_s=stats.gen_s,
            n_gen_steps=stats.n_gen_steps,
            n_gen_tokens=stats.n_gen_tokens,
        )
