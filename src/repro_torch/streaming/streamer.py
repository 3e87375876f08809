"""CacheGen streamer facade: store_kv / stream / materialize.

Ties together the codec (core/), the bitstream store, the bandwidth-adaptive
scheduler (Algorithm 1) and the serving engine:

  offline:  caches --store_kv--> per-chunk multi-level bitstreams (K5)
  online:   stream()      — simulate fetch under a bandwidth trace, choosing
                            per-chunk configs against the TTFT SLO;
            materialize() — actually decode the chosen bitstreams (and
                            recompute TEXT chunks via the engine) into a
                            serving KV cache, ready for generate_with_kv.

materialize() default is the *fused batched* decode-to-cache pipeline:
consecutive bitstream chunks form a run, each run is decoded in one batched
``codec.decode_chunks`` call (stacked rANS scans + the fused kernels K1/K2,
mixed levels welcome) and written into the serving cache in place with one
``Engine.decode_to_cache`` per run; TEXT chunks are recomputed with
``Engine.prefill_extend`` (plain attention over the cache,
``lm._extend_mha``; no kernel).  ``fused=False`` keeps the per-chunk path
as the correctness oracle: ``KVStore.decode`` → ``codec.decode_chunk`` (K6)
→ :func:`_insert_codec_kv`.

Run grouping lives in :class:`RunSegmenter`, an incremental double-buffered
segmenter; the offline ``materialize`` drives it through
:func:`segment_plan` (maximal runs).

``materialize`` reads through the :class:`~repro_torch.streaming.transport.
Transport` handle API: every run segment's fetch is issued ahead
(cancellable handles, reads on worker threads) and resolved in plan order,
so fetches stream concurrently with the decodes consuming them; the decodes
and cache writes stay on the caller's thread.  Default is
:class:`~repro_torch.streaming.transport.LocalTransport` over the plan's
store.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import codec as kvcodec
from repro_torch.models.lm import Caches
from repro_torch.serving.engine import Engine
from repro_torch.serving.kv_layout import caches_to_codec_kv
from repro_torch.streaming.adaptation import TEXT, make_policy
from repro_torch.streaming.network import NetworkModel
from repro_torch.streaming.pipeline import StreamResult, simulate_stream
from repro_torch.streaming.storage import DEFAULT_CHUNK_TOKENS, ChunkMeta, KVStore
from repro_torch.streaming.transport import LocalTransport

__all__ = ["CacheGenStreamer", "FetchPlan", "PlanSegment", "RunSegmenter", "segment_plan"]


@dataclasses.dataclass
class FetchPlan:
    context_id: str
    result: StreamResult
    metas: List[ChunkMeta]


@dataclasses.dataclass
class PlanSegment:
    """One executable unit of a (partially) resolved plan: either a run of
    consecutive bitstream chunks (one batched decode + one cache insertion)
    or a single TEXT chunk (one ``prefill_extend`` recompute)."""

    kind: str  # "run" | "text"
    indices: List[int]  # chunk indices, stream order
    configs: List[int]  # per chunk: encoding level, or TEXT
    start: int  # first token covered
    end: int  # one past the last token covered
    blobs: Optional[List[bytes]] = None  # fetched bitstreams (online path)

    @property
    def n_tokens(self) -> int:
        return self.end - self.start


class RunSegmenter:
    """Incremental, double-buffered plan segmenter.

    Chunks are pushed in stream order as their fetches complete.  Bitstream
    chunks accumulate in a pending buffer; a "run" segment is emitted when

      * a TEXT chunk arrives — its recompute reads the cache at its own
        token offset, so all buffered chunks must land in the cache first
        (positional bookkeeping), or
      * the buffer reaches ``max_run_tokens`` — the double-buffer
        granularity: the emitted run's decode can proceed (asynchronously on
        the card, where a launch does not block the host) while subsequent
        fetches fill the next buffer, or
      * the plan ends (:meth:`flush`).

    ``max_run_tokens=None`` segments only at TEXT boundaries and plan end —
    maximal runs, the offline ``materialize`` default (fewest, largest
    batched decodes; no fetch/decode overlap to exploit offline).
    """

    def __init__(self, max_run_tokens: Optional[int] = None):
        if max_run_tokens is not None and max_run_tokens <= 0:
            raise ValueError("max_run_tokens must be positive or None")
        self.max_run_tokens = max_run_tokens
        self._buf: List[Tuple[ChunkMeta, int, Optional[bytes]]] = []

    def _buffered_tokens(self) -> int:
        return sum(m.n_tokens for m, _, _ in self._buf)

    def push(
        self, meta: ChunkMeta, config: int, blob: Optional[bytes] = None
    ) -> List[PlanSegment]:
        """Feed one resolved chunk; returns the segments now ready to execute."""
        if config == TEXT:
            out = self.flush()
            out.append(
                PlanSegment(
                    kind="text",
                    indices=[meta.chunk_idx],
                    configs=[TEXT],
                    start=meta.start,
                    end=meta.end,
                )
            )
            return out
        self._buf.append((meta, config, blob))
        if (
            self.max_run_tokens is not None
            and self._buffered_tokens() >= self.max_run_tokens
        ):
            return self.flush()
        return []

    def flush(self) -> List[PlanSegment]:
        """Emit the pending run (if any) regardless of buffer fill."""
        if not self._buf:
            return []
        metas = [m for m, _, _ in self._buf]
        blobs = [b for _, _, b in self._buf]
        seg = PlanSegment(
            kind="run",
            indices=[m.chunk_idx for m in metas],
            configs=[c for _, c, _ in self._buf],
            start=metas[0].start,
            end=metas[-1].end,
            blobs=None if any(b is None for b in blobs) else blobs,
        )
        self._buf = []
        return [seg]


def segment_plan(
    metas: Sequence[ChunkMeta],
    configs: Sequence[int],
    max_run_tokens: Optional[int] = None,
) -> List[PlanSegment]:
    """Offline segmentation of a fully resolved plan (metas + chosen configs)."""
    seg = RunSegmenter(max_run_tokens)
    out: List[PlanSegment] = []
    for meta, config in zip(metas, configs):
        out.extend(seg.push(meta, config))
    out.extend(seg.flush())
    return out


class CacheGenStreamer:
    def __init__(self, store: KVStore, cfg: ArchConfig):
        self.store = store
        self.cfg = cfg

    # -- offline -------------------------------------------------------------

    def store_from_caches(
        self,
        context_id: str,
        caches: Caches,
        n_tokens: int,
        *,
        batch_index: int = 0,
        chunk_tokens: int = DEFAULT_CHUNK_TOKENS,
    ) -> List[ChunkMeta]:
        kv = caches_to_codec_kv(caches, batch_index, n_tokens)
        return self.store.store_kv(context_id, kv, chunk_tokens=chunk_tokens)

    # -- online --------------------------------------------------------------

    def stream(
        self,
        context_id: str,
        network: NetworkModel,
        *,
        slo_s: float,
        decode_bytes_per_s: Optional[float] = None,
        recompute_s,
        default_level: Optional[int] = None,
        prior_throughput_gbps: Optional[float] = None,
        allow_text: bool = True,
        adapt: bool = True,
        fixed_level: Optional[int] = None,
        hedge_after_s: Optional[float] = None,
        final_step_s: float = 0.0,
    ) -> FetchPlan:
        metas = self.store.meta(context_id)
        policy = make_policy(
            self.store.tables.config.n_levels,
            slo_s=slo_s,
            default_level=default_level,
            prior_throughput_gbps=prior_throughput_gbps,
            allow_text=allow_text,
            adapt=adapt,
            fixed_level=fixed_level,
        )
        result = simulate_stream(
            metas,
            policy,
            network,
            decode_bytes_per_s=decode_bytes_per_s,
            recompute_s=recompute_s,
            final_step_s=final_step_s,
            hedge_after_s=hedge_after_s,
        )
        return FetchPlan(context_id=context_id, result=result, metas=metas)

    # -- materialization (real decode) ----------------------------------------

    def materialize(
        self,
        plan: FetchPlan,
        engine: Engine,
        tokens,  # (B, T) full context token ids (for TEXT chunks)
        *,
        batch: int = 1,
        fused: bool = True,
        transport=None,
    ) -> Caches:
        """Build the serving cache by decoding each chunk at its chosen config.

        ``fused=True`` (default): consecutive bitstream chunks are decoded as
        one batched run (``codec.decode_chunks``) and written with one
        in-place cache update per run; TEXT chunks are recomputed in stream
        order in between.  Run fetches go through ``transport`` (default:
        direct :class:`LocalTransport` reads), issued ``fetch_lookahead``
        segments ahead of the decode consuming them and released as soon as
        they are decoded.  ``fused=False``: the per-chunk reference path
        (decode each blob, insert one by one).
        """
        caches = engine.empty_caches(batch)
        if not fused:
            return self._materialize_reference(plan, engine, tokens, caches)
        if transport is None:
            transport = LocalTransport(self.store)
        fetch_lookahead = 2
        segs = segment_plan(plan.metas, plan.result.configs)
        handles = {}
        issued = 0

        def issue_until(j_limit):
            nonlocal issued
            while issued <= min(j_limit, len(segs) - 1):
                s = segs[issued]
                if s.kind == "run":
                    handles[issued] = transport.fetch_run(
                        plan.context_id, list(zip(s.indices, s.configs))
                    )
                issued += 1

        for j, seg in enumerate(segs):
            issue_until(j + fetch_lookahead)
            if seg.kind == "text":
                _, caches = engine.prefill_extend(tokens[:, seg.start : seg.end], caches)
                continue
            # run of consecutive bitstream chunks -> one batched decode +
            # one cache insertion
            blobs = handles.pop(j).result().blobs
            kv_run = kvcodec.decode_chunks(
                blobs, self.store.tables, out_dtype=caches.kv_k.dtype
            )
            caches = engine.decode_to_cache(caches, kv_run, seg.start)
        return caches

    def _materialize_reference(
        self,
        plan: FetchPlan,
        engine: Engine,
        tokens,
        caches: Caches,
    ) -> Caches:
        """Per-chunk path: the fused pipeline's correctness oracle."""
        for meta, config in zip(plan.metas, plan.result.configs):
            s, e = meta.start, meta.end
            if config == TEXT:
                _, caches = engine.prefill_extend(tokens[:, s:e], caches)
            else:
                blob = self.store.get_kv(plan.context_id, meta.chunk_idx, config)
                kv = self.store.decode(blob)  # (L, 2, Tc, C) f32, on the tables' device
                caches = _insert_codec_kv(self.cfg, caches, kv, s)
        return caches


def _insert_codec_kv(cfg: ArchConfig, caches: Caches, kv: torch.Tensor, start: int) -> Caches:
    """Write one decoded chunk (L, 2, Tc, C) into every row of the cache at
    ``[start, start + Tc)``, in place."""
    L, two, Tc, C = kv.shape
    Hkv, Dh = cfg.n_kv_heads, cfg.d_head
    caches.kv_k[:, :, start:start + Tc] = kv[:, 0].reshape(L, 1, Tc, Hkv, Dh).to(caches.kv_k.dtype)
    caches.kv_v[:, :, start:start + Tc] = kv[:, 1].reshape(L, 1, Tc, Hkv, Dh).to(caches.kv_v.dtype)
    # monotone: out-of-order / interleaved chunk insertion must never shrink
    # the valid cache length
    return caches._replace(length=torch.clamp_min(caches.length, start + Tc))
