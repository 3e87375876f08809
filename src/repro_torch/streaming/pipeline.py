"""Discrete-event simulation of chunked KV streaming with decode pipelining.

Models the paper's §6 "speed optimization": transmission of chunk *i* is
pipelined with the decode of chunk *i-1*; decode (rANS + dequant) and
text-chunk prefill recompute share the accelerator, so they serialize on a
single compute resource.  Per-chunk configuration comes from the
AdaptationPolicy (Algorithm 1); throughput estimates update per completed
chunk from the trace ("measured throughput when sending the previous
chunk").

Straggler mitigation: a hedged duplicate fetch is issued if a chunk's fetch
exceeds ``hedge_after_s``; the effective arrival is the min of the two.  The
hedging arithmetic lives in ``NetworkModel.fetch_outcome``.  ``StreamClock``
is split into ``decide`` (Algorithm 1 choice at the current virtual
instant) and ``account`` (charge a resolved fetch + its compute window);
``step`` composes the two through the virtual-clock fetch.

Compute contention (multi-session serving): when N sessions share one
engine, each session's decode/recompute seconds stretch by a *measured*
factor — :class:`ContentionModel`, calibrated from the port's benchmark
report (``calibration``).  ``StreamClock`` takes optional ``compute_scale``
/ ``text_scale`` callables; with none (or a factor of exactly 1.0, the
single-session case) the clock charges the uncontended rates.

Everything here is plain Python and numpy floats, no torch, so a plan is
equal — configs, TTFT and every timeline field — to the reference
package's for the same inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Mapping, Optional

from repro_torch.streaming.adaptation import TEXT, AdaptationPolicy
from repro_torch.streaming.calibration import (
    measured_contention_factors,
    measured_decode_bytes_per_s,
    measured_generation_contention_factors,
    measured_text_contention_factors,
)
from repro_torch.streaming.network import FetchOutcome, NetworkModel
from repro_torch.streaming.storage import ChunkMeta

__all__ = [
    "ChunkTimeline",
    "ContentionModel",
    "StreamResult",
    "StreamClock",
    "remaining_work",
    "simulate_stream",
]


@dataclasses.dataclass(frozen=True)
class ContentionModel:
    """Per-session compute slowdown as a function of concurrently active
    sessions sharing the engine.

    ``factors`` maps measured concurrency points (from the microbench's
    stacked-decode section) to slowdown; between points the factor is
    interpolated linearly in N, beyond the last point it extrapolates the
    marginal per-session cost of the last measured interval.  An empty map
    falls back to ``factor(n) = n`` — fully serialized compute, the
    conservative model when no stacked measurement exists.  ``factor(1)`` is
    exactly 1.0 by construction, so a single session under a ContentionModel
    is bit-identical to one without.

    TEXT recompute does not stack like decode (a width-masked batched
    ``prefill_extend_rows`` forward has its own concurrency curve), so the
    TEXT side carries a separate measured map: ``text_factors`` comes from
    the microbench's stacked-prefill section
    (``calibration.measured_text_contention_factors``) and is read through
    :meth:`text_factor`; when no prefill measurement exists it falls back to
    the decode curve (the pre-split behavior, bit-identical).  Generation
    decode steps stack differently again (one token per row per dispatch,
    the whole realized prefix attended over), so the stacked-step slowdown
    carries a third map: ``gen_factors`` comes from the microbench's
    stacked-decode-step section
    (``calibration.measured_generation_contention_factors``) and is read
    through :meth:`gen_factor`, with the same decode-curve fallback.

    ``n_active`` is the number of sessions holding a cache row when a
    decision is made.
    """

    factors: Mapping[int, float] = dataclasses.field(default_factory=dict)
    text_factors: Mapping[int, float] = dataclasses.field(default_factory=dict)
    gen_factors: Mapping[int, float] = dataclasses.field(default_factory=dict)

    @staticmethod
    def measured(path: Optional[str] = None) -> "ContentionModel":
        """Calibrated from the port's codec report's stacked sections."""
        return ContentionModel(
            measured_contention_factors(path),
            measured_text_contention_factors(path),
            measured_generation_contention_factors(path),
        )

    @staticmethod
    def _interp(factors: Mapping[int, float], n: int) -> Optional[float]:
        """Linear interpolation over measured points; None when unmeasured."""
        pts = sorted((int(k), float(v)) for k, v in factors.items())
        pts = [(k, v) for k, v in pts if k >= 1]
        if not pts:
            return None
        if pts[0][0] != 1:
            pts.insert(0, (1, 1.0))
        for (n0, f0), (n1, f1) in zip(pts, pts[1:]):
            if n <= n1:
                if n <= n0:
                    return f0
                w = (n - n0) / (n1 - n0)
                return f0 + w * (f1 - f0)
        # beyond the last measurement: extend the last marginal slope
        if len(pts) >= 2:
            (n0, f0), (n1, f1) = pts[-2], pts[-1]
            slope = (f1 - f0) / (n1 - n0)
        else:
            (n1, f1), slope = pts[-1], 0.0
        return max(1.0, f1 + slope * (n - n1))

    def factor(self, n_active: int) -> float:
        n = max(int(n_active), 1)
        if n == 1:
            return 1.0
        v = self._interp(self.factors, n)
        # fully serialized: no batching benefit assumed when unmeasured
        return float(n) if v is None else v

    def text_factor(self, n_active: int) -> float:
        """TEXT-recompute slowdown at ``n_active`` sessions; falls back to
        the decode curve when no prefill-concurrency measurement exists."""
        n = max(int(n_active), 1)
        if n == 1:
            return 1.0
        v = self._interp(self.text_factors, n)
        return self.factor(n) if v is None else v

    def gen_factor(self, n_active: int) -> float:
        """Stacked generation-step slowdown at ``n_active`` generating rows
        (one ``decode_step_rows`` dispatch of that width vs. width 1); falls
        back to the decode curve when no stacked-step measurement exists."""
        n = max(int(n_active), 1)
        if n == 1:
            return 1.0
        v = self._interp(self.gen_factors, n)
        return self.factor(n) if v is None else v

    # -- per-shard variants ------------------------------------------------
    #
    # With the batch-of-requests cache's rows split over S shards, the N
    # live sessions contend only *within* their shard, so the per-session
    # slowdown reads the measured curve at the even-spread per-shard width
    # ceil(N / S).  The schedulers call these on every engine; at S = 1
    # (the port's only engine so far) each reduces exactly to its
    # unsharded reading.

    @staticmethod
    def _per_shard(n_active: int, n_shards: int) -> int:
        s = max(int(n_shards), 1)
        return -(-max(int(n_active), 1) // s)

    def factor_sharded(self, n_active: int, n_shards: int) -> float:
        """Decode slowdown with ``n_active`` sessions spread evenly over
        ``n_shards`` row shards."""
        return self.factor(self._per_shard(n_active, n_shards))

    def text_factor_sharded(self, n_active: int, n_shards: int) -> float:
        return self.text_factor(self._per_shard(n_active, n_shards))

    def gen_factor_sharded(self, n_active: int, n_shards: int) -> float:
        return self.gen_factor(self._per_shard(n_active, n_shards))


@dataclasses.dataclass
class ChunkTimeline:
    chunk_idx: int
    config: int  # TEXT or level
    nbytes: float
    fetch_start: float
    fetch_end: float
    compute_start: float  # decode or recompute
    compute_end: float
    hedged: bool = False
    duplicate_bytes: float = 0.0  # bytes the cancelled hedge loser moved
    n_retries: int = 0  # failed fetch attempts retried before this one landed
    fault_fallback: bool = False  # config was re-decided after fetch failures
    cold_hit: bool = False  # any entry of this fetch was served cold (tiered)
    # byte-range resume; defaults keep simulator output unchanged.
    # wire_bytes stays 0.0 for an untroubled chunk (its wire cost is just
    # ``nbytes``) — it is filled only when partial deliveries made the
    # realized wire cost differ, and then salvaged + refetched == wire.
    salvaged_bytes: float = 0.0  # verified prefix bytes reused, not refetched
    wire_bytes: float = 0.0  # realized wire bytes across every attempt
    refetched_bytes: float = 0.0  # wire bytes paid beyond the salvage credit
    resumed: bool = False  # landed via a byte-range continuation
    replanned: bool = False  # a mid-chunk cancel→re-plan preceded the landing


@dataclasses.dataclass
class StreamResult:
    timelines: List[ChunkTimeline]
    ttft_s: float
    configs: List[int]
    slo_s: float

    @property
    def slo_violated(self) -> bool:
        return self.ttft_s > self.slo_s

    @property
    def total_bytes(self) -> float:
        return sum(t.nbytes for t in self.timelines)

    @property
    def duplicate_bytes(self) -> float:
        """Wire bytes paid for by hedging (losing fetches, cancelled)."""
        return sum(t.duplicate_bytes for t in self.timelines)


def remaining_work(
    metas: List[ChunkMeta],
    i: int,
    prefix_tokens: int,
    recompute_s: Callable[[int, int], float],
) -> tuple:
    """Algorithm 1 decision inputs for chunk ``i``: (per-level remaining
    bytes, remaining text bytes, remaining recompute seconds)."""
    levels = list(metas[0].sizes.keys()) if metas else []
    remaining = metas[i:]
    remaining_sizes = {
        lvl: float(sum(r.sizes[lvl] for r in remaining)) for lvl in levels
    }
    remaining_text = float(sum(r.text_bytes for r in remaining))
    rem_recompute = 0.0
    ptoks = prefix_tokens
    for r in remaining:
        rem_recompute += recompute_s(r.n_tokens, ptoks)
        ptoks += r.n_tokens
    return remaining_sizes, remaining_text, rem_recompute


@dataclasses.dataclass
class StreamClock:
    """The Algorithm 1 per-chunk loop body on the virtual clock: decide →
    fetch (with hedging) → charge the compute window → observe throughput.
    """

    policy: AdaptationPolicy
    network: NetworkModel
    decode_bytes_per_s: float
    recompute_s: Callable[[int, int], float]  # (chunk_tokens, prefix) -> s
    hedge_after_s: Optional[float] = None
    start_t: float = 0.0
    # live compute-pressure hook: returns the current per-session slowdown
    # (ContentionModel.factor(n_active)); None == 1.0 == uncontended
    compute_scale: Optional[Callable[[], float]] = None
    # TEXT-recompute counterpart (ContentionModel.text_factor(n_active));
    # None falls back to compute_scale — the decode curve priced TEXT too
    # before the prefill-concurrency measurement existed
    text_scale: Optional[Callable[[], float]] = None

    def __post_init__(self):
        self.fetch_t = self.start_t  # network busy-until
        self.compute_t = self.start_t  # accelerator busy-until
        self.prefix_tokens = 0

    def decide(
        self, metas: List[ChunkMeta], i: int, exclude=(), credit=None
    ) -> tuple:
        """Algorithm 1 choice for chunk ``i`` at the current virtual instant.

        ``exclude`` removes configurations that already failed past their
        retry budget for this chunk (the failure-fallback ladder).
        ``credit`` (``adaptation.salvage_credit`` output) is a
        per-level byte credit for the current chunk's verified partial
        bytes — subtracted from ``remaining_sizes`` so the projection
        prices only the bytes still to be moved; ``None`` (the default)
        leaves the decision bit-identical to the simulator's.

        Returns ``(config, nbytes, scale)``; ``scale`` is the contention
        factor sampled *now* (decision time) for the chosen config's compute
        category — the TEXT factor for a TEXT chunk, the decode factor
        otherwise — and must be passed back to :meth:`account` so the
        charged compute window uses the same value even when the fetch
        resolves later (async transports).
        """
        m = metas[i]
        scale = 1.0 if self.compute_scale is None else float(self.compute_scale())
        tscale = scale if self.text_scale is None else float(self.text_scale())
        remaining_sizes, remaining_text, rem_recompute = remaining_work(
            metas, i, self.prefix_tokens, self.recompute_s
        )
        if credit:
            remaining_sizes = {
                lvl: max(sz - float(credit.get(lvl, 0.0)), 0.0)
                for lvl, sz in remaining_sizes.items()
            }
        cfg = self.policy.next_config(
            elapsed_s=self.fetch_t - self.start_t,
            remaining_sizes=remaining_sizes,
            remaining_text_bytes=remaining_text,
            remaining_recompute_s=rem_recompute * tscale,
            exclude=exclude,
        )
        nbytes = float(m.text_bytes if cfg.config == TEXT else m.sizes[cfg.config])
        return cfg.config, nbytes, (tscale if cfg.config == TEXT else scale)

    def charge_failure(self, lost_s: float) -> None:
        """Advance the network clock past a failed fetch attempt plus its
        retry backoff, *without* observing throughput — the next Algorithm-1
        decision then sees the lost time in ``elapsed_s`` and can re-plan
        (e.g. pick a coarser level to still make the SLO)."""
        self.fetch_t += max(float(lost_s), 0.0)

    def virtual_fetch(self, nbytes: float, chunk_idx: int) -> FetchOutcome:
        """The decided chunk's fetch, resolved purely on the virtual clock."""
        return self.network.fetch_outcome(
            nbytes,
            self.fetch_t,
            chunk_idx=chunk_idx,
            hedge_after_s=self.hedge_after_s,
        )

    def account(
        self,
        m: ChunkMeta,
        config: int,
        nbytes: float,
        outcome: FetchOutcome,
        scale: float = 1.0,
    ) -> ChunkTimeline:
        """Charge a resolved fetch plus its compute window; observe
        throughput for the next decision.  ``outcome`` may come from
        :meth:`virtual_fetch` or from a transport's realized I/O — anything
        with ``end_t`` / ``hedged`` / ``duplicate_bytes`` /
        ``throughput_gbps``."""
        fetch_start = self.fetch_t
        fetch_end = outcome.end_t
        self.fetch_t = fetch_end

        # --- compute (decode or recompute), pipelined with next fetch ------
        # contention: N active sessions stretch this session's compute window
        if config == TEXT:
            dur = self.recompute_s(m.n_tokens, self.prefix_tokens) * scale
        else:
            dur = nbytes / self.decode_bytes_per_s * scale
        compute_start = max(fetch_end, self.compute_t)
        compute_end = compute_start + dur
        self.compute_t = compute_end

        timeline = ChunkTimeline(
            chunk_idx=m.chunk_idx,
            config=config,
            nbytes=nbytes,
            fetch_start=fetch_start,
            fetch_end=fetch_end,
            compute_start=compute_start,
            compute_end=compute_end,
            hedged=outcome.hedged,
            duplicate_bytes=outcome.duplicate_bytes,
        )
        self.prefix_tokens += m.n_tokens
        self.policy.observe_throughput(outcome.throughput_gbps)
        return timeline

    def step(self, metas: List[ChunkMeta], i: int) -> ChunkTimeline:
        config, nbytes, scale = self.decide(metas, i)
        outcome = self.virtual_fetch(nbytes, metas[i].chunk_idx)
        return self.account(metas[i], config, nbytes, outcome, scale)

    def ttft_s(self, timelines: List[ChunkTimeline], final_step_s: float) -> float:
        last = timelines[-1].compute_end if timelines else self.start_t
        return last + final_step_s - self.start_t


def simulate_stream(
    metas: List[ChunkMeta],
    policy: AdaptationPolicy,
    network: NetworkModel,
    *,
    decode_bytes_per_s: Optional[float] = None,
    recompute_s: Callable[[int, int], float],  # (chunk_tokens, prefix_tokens) -> s
    final_step_s: float = 0.0,
    hedge_after_s: Optional[float] = None,
    start_t: float = 0.0,
) -> StreamResult:
    # default: the port's measured fused-decode throughput on this host
    # (calibration), else its placeholder
    if decode_bytes_per_s is None:
        decode_bytes_per_s = measured_decode_bytes_per_s()
    clock = StreamClock(
        policy=policy,
        network=network,
        decode_bytes_per_s=decode_bytes_per_s,
        recompute_s=recompute_s,
        hedge_after_s=hedge_after_s,
        start_t=start_t,
    )
    timelines = [clock.step(metas, i) for i in range(len(metas))]
    return StreamResult(
        timelines=timelines,
        ttft_s=clock.ttft_s(timelines, final_step_s),
        configs=[t.config for t in timelines],
        slo_s=policy.slo_s,
    )
