"""CacheGen streaming adaptation (paper §5.3 + Algorithm 1, §C.1).

Per chunk, choose the *streaming configuration* — text-recompute or one of
the encoding levels — that has the least compression loss among those whose
projected completion time (assuming the throughput measured on the previous
chunk persists and the same configuration is applied to all remaining
chunks) still meets the TTFT SLO.

Quality ordering (least loss first): TEXT (no loss, but costs GPU prefill
compute) > level 0 (lossless-after-8bit) > level 1 > ... > level n (coarsest).
If nothing fits the SLO, the smallest representation is chosen (best effort).

Failure fallback: the serving layer generalizes §C.1's bandwidth
fallback into a *failure* fallback by re-deciding a chunk with the
configurations that already failed (and everything finer) ``exclude``-d.
When every candidate is excluded there is nothing left to try —
:class:`NoFeasibleConfigError` — and the session reports a clean failure.
"""
from __future__ import annotations

import dataclasses
from typing import Collection, Dict, List, Optional, Sequence

__all__ = [
    "StreamConfig",
    "TEXT",
    "NoFeasibleConfigError",
    "choose_config",
    "salvage_credit",
    "AdaptationPolicy",
    "make_policy",
]

TEXT = -1  # sentinel streaming configuration: send text + recompute


class NoFeasibleConfigError(RuntimeError):
    """Every streaming configuration (all levels and TEXT) is excluded."""


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Resolved choice for one chunk."""

    config: int  # TEXT or encoding level
    projected_s: float  # projected completion for all remaining chunks


def _projected_delay(
    remaining_bytes: float,
    throughput_gbps: float,
    recompute_s: float = 0.0,
) -> float:
    return recompute_s + remaining_bytes * 8.0 / (throughput_gbps * 1e9)


def choose_config(
    *,
    remaining_sizes: Dict[int, float],  # level -> total bytes of remaining chunks
    remaining_text_bytes: float,
    remaining_recompute_s: float,  # GPU time to recompute all remaining chunks
    throughput_gbps: float,
    time_left_s: float,
    levels_quality_order: Sequence[int],
    allow_text: bool = True,
    exclude: Collection[int] = (),
) -> StreamConfig:
    """Algorithm 1 step: pick the best-quality feasible configuration.

    ``exclude`` removes configurations (levels or TEXT) that already failed
    past their retry budget for this chunk — the failure-fallback ladder.
    """
    candidates: List[StreamConfig] = []
    if allow_text and TEXT not in exclude:
        proj = _projected_delay(
            remaining_text_bytes, throughput_gbps, remaining_recompute_s
        )
        candidates.append(StreamConfig(TEXT, proj))
    for lvl in levels_quality_order:
        if lvl in exclude:
            continue
        proj = _projected_delay(remaining_sizes[lvl], throughput_gbps)
        candidates.append(StreamConfig(lvl, proj))
    if not candidates:
        raise NoFeasibleConfigError(
            f"all streaming configurations excluded "
            f"(levels {list(levels_quality_order)}, allow_text={allow_text}, "
            f"exclude={sorted(exclude)})"
        )
    for c in candidates:  # quality order: first feasible wins
        if c.projected_s <= time_left_s:
            return c
    return min(candidates, key=lambda c: c.projected_s)  # best effort


def salvage_credit(
    sizes: Dict[int, float],
    salvage_level: int,
    verified_end: int,
    head_end: int,
    anchor_end: int,
    *,
    lossless_level: int = 0,
) -> Dict[int, float]:
    """Per-level byte credit of a verified partial chunk.

    A failed/cancelled fetch leaves a checksum-verified byte prefix behind
    (``bitstream.SegmentIndex.verified_prefix``).  When the chunk is
    re-decided, that prefix is worth different amounts at different levels:

    - at ``salvage_level`` itself, every verified byte resumes for free
      (byte-range refetch of only the suffix);
    - at any *other lossy* level, the level-invariant anchor segment — the
      bytes in ``[head_end, anchor_end)`` — composes bit-exactly with that
      level's delta suffix, provided the prefix covers the whole anchor;
    - the lossless level's anchor is encoded with different tables, so a
      lossy prefix is worth nothing there (and vice versa); TEXT recompute
      cannot reuse bitstream bytes at all (rANS lanes span the full token
      axis), so it gets no entry.

    ``choose_config`` subtracts these credits from the current chunk's
    contribution to ``remaining_sizes`` so Algorithm 1 prices only the
    bytes still to be moved.
    """
    anchor_bytes = float(max(int(anchor_end) - int(head_end), 0))
    covers_anchor = int(verified_end) >= int(anchor_end) and anchor_bytes > 0
    credit: Dict[int, float] = {}
    for lvl, size in sizes.items():
        if lvl == salvage_level:
            credit[lvl] = min(float(verified_end), float(size))
        elif (
            covers_anchor
            and salvage_level != lossless_level
            and lvl != lossless_level
        ):
            credit[lvl] = min(anchor_bytes, float(size))
        else:
            credit[lvl] = 0.0
    return credit


@dataclasses.dataclass
class AdaptationPolicy:
    """Stateful per-stream adaptation: carries the throughput estimate.

    ``default_level`` is used for the first chunk when no prior bandwidth
    knowledge exists (paper: "starts with a default medium encoding level").
    """

    levels_quality_order: Sequence[int]
    slo_s: float
    default_level: int
    prior_throughput_gbps: Optional[float] = None
    allow_text: bool = True

    def __post_init__(self):
        self._throughput = self.prior_throughput_gbps

    def next_config(
        self,
        *,
        elapsed_s: float,
        remaining_sizes: Dict[int, float],
        remaining_text_bytes: float,
        remaining_recompute_s: float,
        exclude: Collection[int] = (),
    ) -> StreamConfig:
        if self._throughput is None:
            # no bandwidth estimate yet: default level, else the finest
            # non-excluded level, else TEXT — quality order still applies
            if not exclude:
                return StreamConfig(self.default_level, float("nan"))
            if self.default_level not in exclude:
                return StreamConfig(self.default_level, float("nan"))
            for lvl in self.levels_quality_order:
                if lvl not in exclude:
                    return StreamConfig(lvl, float("nan"))
            if self.allow_text and TEXT not in exclude:
                return StreamConfig(TEXT, float("nan"))
            raise NoFeasibleConfigError(
                f"all streaming configurations excluded "
                f"(levels {list(self.levels_quality_order)}, "
                f"allow_text={self.allow_text}, exclude={sorted(exclude)})"
            )
        return choose_config(
            remaining_sizes=remaining_sizes,
            remaining_text_bytes=remaining_text_bytes,
            remaining_recompute_s=remaining_recompute_s,
            throughput_gbps=self._throughput,
            time_left_s=self.slo_s - elapsed_s,
            levels_quality_order=self.levels_quality_order,
            allow_text=self.allow_text,
            exclude=exclude,
        )

    def observe_throughput(self, gbps: float) -> None:
        self._throughput = gbps

    @property
    def throughput_gbps(self) -> Optional[float]:
        """Current live estimate (None until the first observation)."""
        return self._throughput


def make_policy(
    n_levels: int,
    *,
    slo_s: float,
    default_level: Optional[int] = None,
    prior_throughput_gbps: Optional[float] = None,
    allow_text: bool = True,
    adapt: bool = True,
    fixed_level: Optional[int] = None,
) -> AdaptationPolicy:
    """Canonical policy construction for the offline simulator entry point
    (``CacheGenStreamer.stream``).

    ``fixed_level`` (or ``adapt=False``) pins a single representation with no
    text fallback — the "no adaptation" baseline; otherwise all levels are
    candidates in quality order (0 = least loss).
    """
    if fixed_level is not None or not adapt:
        lvl = fixed_level if fixed_level is not None else (
            default_level if default_level is not None else 1
        )
        if not 0 <= lvl < n_levels:
            raise ValueError(
                f"pinned level {lvl} out of range for {n_levels} levels"
            )
        return AdaptationPolicy(
            levels_quality_order=[lvl],
            slo_s=slo_s,
            default_level=lvl,
            prior_throughput_gbps=prior_throughput_gbps,
            allow_text=False,
        )
    return AdaptationPolicy(
        levels_quality_order=list(range(n_levels)),
        slo_s=slo_s,
        default_level=default_level
        if default_level is not None
        else min(1, n_levels - 1),
        prior_throughput_gbps=prior_throughput_gbps,
        allow_text=allow_text,
    )
