"""Serving engine: the paper's two LLM interfaces plus chunked prefill.

Implements (paper §6):
  * ``calculate_kv(context) -> KVCache``  — prefill without generation;
  * ``generate_with_kv(KVCache) -> text`` — generation that skips context
    prefill entirely;
plus ``prefill_extend`` — compute a text chunk's KV on top of already-loaded
chunk KV (the streamer's recompute fallback, paper §5.3 fn. 6) — and the
cache insertions that land decoded codec runs (``decode_to_cache`` for one
request, ``insert_runs`` for several requests' rows in one call).

One Engine serves many concurrent context loads and generations: the
schedulers in ``serving.scheduler`` allocate a batch-of-requests cache (one
row per live session) and drive the batched entry points — ``insert_runs``,
``prefill_extend_rows`` (different requests' TEXT recomputes in one
width-masked forward), ``prefill_extend_gather`` (the same for a few rows,
gathered), ``decode_step_rows`` (every generating row's next token in one
forward, inactive rows bit-preserved) — and the row-pool primitives
``save_row``, ``restore_row`` and ``reset_rows``.

The engine runs on one device, the CUDA card unless ``device`` names
another; the model's attention and the codec's reconstruction go through
the hand-written kernels there.

Families.  ``calculate_kv``, ``generate_with_kv`` and ``logits_with_kv``
run every family the port builds (``lm.FAMILIES``: the ssm and hybrid
families carry Mamba-2 states, the hybrid also its shared blocks' K/V).
The chunked prefill and the row programs exist for the attention families
only (``lm.ATTENTION_FAMILIES``), as the reference builds them
(``src/repro/serving/engine.py``): for the others they raise its
messages.

Cache ownership.  ``decode_to_cache`` and ``insert_runs`` write into the
caller's cache tensors *in place* (the reference donates those buffers, so
its callers already cannot reuse them).  So do the batch-of-requests
methods ``restore_row``, ``reset_rows``, ``prefill_extend_rows``,
``prefill_extend_gather`` and ``decode_step_rows``: their caller is a
scheduler that owns its pool cache.  Each returns the caches with a new
``length`` tensor.  ``save_row`` returns a copy (``kv_layout.RowSnapshot``).
``generate_with_kv``, ``logits_with_kv`` and ``prefill_extend`` leave the
caller's cache as it was — the reference computes them functionally and
callers reuse a prefill cache across calls — by cloning it once at entry
and updating the clone in place.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.models.lm import Caches
from repro_torch.serving import kv_layout

__all__ = ["Engine"]


class Engine:
    # Shard-aware row addressing: this engine is a single shard, so the
    # global row space and the local one coincide.  The schedulers consult
    # these to size caches (``cache_rows``) and to place rows into per-shard
    # contention and transport domains.
    n_shards: int = 1

    def cache_rows(self, n: int) -> int:
        """Smallest cache batch >= ``n`` this engine can allocate (rounded
        up to a whole number of row shards)."""
        return -(-int(n) // self.n_shards) * self.n_shards

    def __init__(self, cfg: ArchConfig, params, cache_capacity: int = 4096, device=None):
        self.cfg = cfg
        self.params = params
        self.capacity = cache_capacity
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"parameters live on {params['embed'].device}, the engine on {self.device}"
            )

    # ------------------------------------------------------------------
    # Paper interfaces
    # ------------------------------------------------------------------

    def calculate_kv(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Caches]:
        """Prefill the context; returns (last logits, caches of capacity
        ``cache_capacity``)."""
        return lm.prefill(self.cfg, self.params, batch, pad_to=self.capacity)

    def generate_with_kv(self, caches: Caches, first_token, n_tokens: int) -> np.ndarray:
        """Greedy generation from a (possibly codec-decoded) KV cache.

        first_token: (B,) int.  Returns (B, n_tokens) generated ids.  The
        caller's ``caches`` are left unchanged.
        """
        caches = caches.clone()
        tok = torch.as_tensor(first_token, device=self.device).to(torch.long)[:, None]
        out = []
        for _ in range(n_tokens):
            logits, caches = lm.decode_step(self.cfg, self.params, tok, caches)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            out.append(tok[:, 0])
        if not out:
            return np.zeros((tok.shape[0], 0), np.int32)
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()

    def logits_with_kv(self, caches: Caches, tokens: np.ndarray) -> Tuple[np.ndarray, Caches]:
        """Teacher-forced stepping: returns per-step logits (B, T, V) as f32
        and the advanced caches (a copy; the caller's are left unchanged)."""
        caches = caches.clone()
        toks = torch.as_tensor(np.asarray(tokens), device=self.device).to(torch.long)
        outs = []
        for t in range(toks.shape[1]):
            logits, caches = lm.decode_step(self.cfg, self.params, toks[:, t:t + 1], caches)
            outs.append(logits[:, 0].to(torch.float32))
        return torch.stack(outs, dim=1).cpu().numpy(), caches

    # ------------------------------------------------------------------
    # Streamer support
    # ------------------------------------------------------------------

    def prefill_extend(self, tokens, caches: Caches) -> Tuple[torch.Tensor, Caches]:
        """Text-chunk recompute on top of loaded KV (fallback config).
        Returns (last logits, new caches); the caller's are left unchanged."""
        self._check_extend()
        return lm.prefill_extend(self.cfg, self.params, tokens, caches.clone())

    def _check_extend(self) -> None:
        if self.cfg.family not in lm.ATTENTION_FAMILIES:
            raise ValueError(f"no chunked prefill for family {self.cfg.family}")

    def empty_caches(self, batch: int) -> Caches:
        return kv_layout.alloc_caches(self.cfg, batch, self.capacity, device=self.device)

    def decode_to_cache(self, caches: Caches, kv_new, start: int) -> Caches:
        """Write a decoded codec run ``(L, 2, T, C)`` into every row of the
        serving cache at ``start``, in place (``kv_layout.insert_codec_run``)."""
        k, v, ln = kv_layout.insert_codec_run(
            caches.kv_k, caches.kv_v, caches.length,
            torch.as_tensor(kv_new, device=self.device), int(start),
        )
        return caches._replace(kv_k=k, kv_v=v, length=ln)

    # ------------------------------------------------------------------
    # Concurrent-scheduler support (batch-of-requests cache)
    # ------------------------------------------------------------------

    def insert_runs(
        self,
        caches: Caches,
        kv_new,  # (L, 2, sum_T, C): all runs' decoded tokens, concat order
        rows: Sequence[int],  # cache row per run (distinct)
        starts: Sequence[int],  # token offset per run
        run_tokens: Sequence[int],  # token count per run
    ) -> Caches:
        """Land several requests' decoded runs in one call, in place.

        ``kv_new`` is the cross-request concat from
        ``codec.decode_chunk_runs``; run ``i`` (spanning ``run_tokens[i]``
        tokens of it) is written into cache row ``rows[i]`` at token offset
        ``starts[i]``.  Rows not named keep their contents byte-identically.
        """
        self._check_runs(caches.kv_k.shape[1], rows, starts, run_tokens)
        with tracing.span("engine.insert", rows=len(rows)):
            k, v, ln = kv_layout.insert_codec_runs(
                caches.kv_k, caches.kv_v, caches.length,
                torch.as_tensor(kv_new, device=self.device),
                [int(r) for r in rows], [int(s) for s in starts], [int(t) for t in run_tokens],
            )
        return caches._replace(kv_k=k, kv_v=v, length=ln)

    def _check_runs(self, n_rows: int, rows, starts, run_tokens) -> None:
        """``insert_runs``'s arguments: one row, start and count a run,
        distinct rows of the cache, every run inside the capacity."""
        if not (len(rows) == len(starts) == len(run_tokens)):
            raise ValueError(
                f"insert_runs: {len(rows)} rows, {len(starts)} starts, "
                f"{len(run_tokens)} runs — one of each per run required"
            )
        if len(set(rows)) != len(rows):
            raise ValueError(f"insert_runs: duplicate cache rows in {rows}")
        if any(not 0 <= int(r) < n_rows for r in rows):
            raise ValueError(
                f"insert_runs: rows {list(rows)} out of range for a "
                f"{n_rows}-row cache"
            )
        t_max = max(run_tokens)
        if t_max > self.capacity:
            raise ValueError(
                f"run of {t_max} tokens exceeds cache capacity {self.capacity}"
            )
        for s, t in zip(starts, run_tokens):
            # the shifted-window merge masks out-of-capacity positions rather
            # than writing them, so an overhanging run would silently drop
            # tokens while still advancing length
            if int(s) + int(t) > self.capacity:
                raise ValueError(
                    f"run of {t} tokens at offset {s} overhangs cache "
                    f"capacity {self.capacity}"
                )

    # ------------------------------------------------------------------
    # Row-pool support (continuous admission / preemption)
    # ------------------------------------------------------------------

    def save_row(self, caches: Caches, row: int, n_tokens: int) -> kv_layout.RowSnapshot:
        """Snapshot the first ``n_tokens`` realized tokens of one cache row
        (suspending a preempted session).  The snapshot owns copies, so the
        pool cache may be recycled freely afterwards."""
        self._check_save(caches.kv_k.shape[1], row, n_tokens)
        return kv_layout.save_row(caches, int(row), int(n_tokens))

    def _check_save(self, n_rows: int, row: int, n_tokens: int) -> None:
        if not 0 <= int(row) < n_rows:
            raise ValueError(
                f"save_row: row {row} out of range for a {n_rows}-row cache"
            )
        if not 0 <= int(n_tokens) <= self.capacity:
            raise ValueError(
                f"save_row: {n_tokens} tokens out of range for capacity "
                f"{self.capacity}"
            )

    def restore_row(self, caches: Caches, snapshot: kv_layout.RowSnapshot, row: int) -> Caches:
        """Write a suspended session's snapshot into (possibly another)
        ``row`` of the pool cache, in place; the row then reads exactly as
        it did at suspension (length included)."""
        self._check_restore(caches.kv_k.shape[1], snapshot, row)
        k, v, ln = kv_layout.restore_row(
            caches.kv_k, caches.kv_v, caches.length, snapshot.kv_k, snapshot.kv_v, int(row)
        )
        return caches._replace(kv_k=k, kv_v=v, length=ln)

    def _check_restore(self, n_rows: int, snapshot: kv_layout.RowSnapshot, row: int) -> None:
        if not 0 <= int(row) < n_rows:
            raise ValueError(
                f"restore_row: row {row} out of range for a {n_rows}-row cache"
            )
        if snapshot.n_tokens > self.capacity:
            raise ValueError(
                f"restore_row: snapshot of {snapshot.n_tokens} tokens exceeds "
                f"cache capacity {self.capacity}"
            )

    def reset_rows(self, caches: Caches, rows: Sequence[int]) -> Caches:
        """Zero recycled rows (K/V and length) in place before new tenants
        take them — a recycled row must be indistinguishable from a fresh
        cache's row."""
        self._check_rows("reset_rows", caches.kv_k.shape[1], rows)
        k, v, ln = kv_layout.reset_rows(caches.kv_k, caches.kv_v, caches.length, rows)
        return caches._replace(kv_k=k, kv_v=v, length=ln)

    @staticmethod
    def _check_rows(what: str, n_rows: int, rows) -> None:
        if any(not 0 <= int(r) < n_rows for r in rows):
            raise ValueError(
                f"{what}: rows {list(rows)} out of range for a "
                f"{n_rows}-row cache"
            )

    def prefill_extend_rows(self, tokens, caches: Caches, widths) -> Tuple[torch.Tensor, Caches]:
        """Coalesced TEXT recompute: one padded, width-masked batched
        ``prefill_extend`` over the batch-of-requests cache, in place.

        ``tokens`` is (B, Tc) with each participating row's text chunk (rows
        with ``widths[b] == 0`` carry padding and are untouched — garbage
        logits, no cache write, no length advance).  Each row writes at its
        *own* ``caches.length[b]`` offset.
        """
        self._check_extend()
        with tracing.span("engine.question", rows=caches.kv_k.shape[1]):
            return lm.prefill_extend(self.cfg, self.params, tokens, caches, widths=widths)

    def prefill_extend_gather(self, tokens, caches: Caches, rows) -> Tuple[torch.Tensor, Caches]:
        """Compact coalesced TEXT recompute for a *subset* of cache rows.

        Gathers rows ``rows`` of the batch-of-requests cache into a
        sub-batch (a copy), runs the full-width ``prefill_extend`` on it
        (``tokens`` is (len(rows), Tc), one text chunk per gathered row) and
        writes the updated rows back in place.  Same semantics as
        :meth:`prefill_extend_rows`, but compute scales with the
        participating rows instead of the full batch.
        """
        self._check_extend()
        self._check_rows("prefill_extend_gather", caches.kv_k.shape[1], rows)
        idx = torch.as_tensor([int(r) for r in rows], dtype=torch.long, device=self.device)
        sub = Caches(kv_k=caches.kv_k[:, idx], kv_v=caches.kv_v[:, idx], length=caches.length[idx])
        logits, sub = lm.prefill_extend(self.cfg, self.params, tokens, sub)
        caches.kv_k[:, idx] = sub.kv_k
        caches.kv_v[:, idx] = sub.kv_v
        length = caches.length.clone()
        length[idx] = sub.length
        return logits, caches._replace(length=length)

    def decode_step_rows(self, tokens, caches: Caches, active) -> Tuple[torch.Tensor, Caches]:
        """Stacked generation step: all generating rows' next token in one
        forward over the batch-of-requests cache, in place.

        ``tokens`` is (B, 1) with each generating row's current token (rows
        with ``active[b] == False`` carry padding); ``active`` is (B,) bool.
        Each active row attends over its own realized prefix (per-row
        ``caches.length[b]`` offsets), writes its token's K/V at that offset
        and advances its length by one; inactive rows' K/V and length stay
        bit for bit as they were.  Returns (logits (B, 1, V), caches) —
        inactive rows' logits are garbage.

        ``lm.decode_step`` writes every row's token at its length, clamped
        onto the last slot of a full row, so the slot each row would be
        written at is saved before the step and put back for the inactive
        rows after it (B slots a layer; no host sync).  Active rows must
        have ``length < capacity`` before the step; callers validate this
        when scheduling generation.
        """
        if self.cfg.family not in lm.ATTENTION_FAMILIES:
            raise ValueError(f"no cached generation for family {self.cfg.family}")
        with tracing.span("engine.step", rows=caches.kv_k.shape[1]):
            return self._decode_step_rows(tokens, caches, active)

    def _decode_step_rows(self, tokens, caches: Caches, active) -> Tuple[torch.Tensor, Caches]:
        n_rows = caches.kv_k.shape[1]
        tokens = torch.as_tensor(tokens, device=self.device).to(torch.long)
        active = torch.as_tensor(active, device=self.device).to(torch.bool)
        self._check_step(n_rows, tokens, active)
        rows = torch.arange(n_rows, device=self.device)
        slot = caches.length.to(torch.long).clamp(0, caches.kv_k.shape[2] - 1)
        saved_k = caches.kv_k[:, rows, slot]
        saved_v = caches.kv_v[:, rows, slot]
        logits, new = lm.decode_step(self.cfg, self.params, tokens, caches)
        keep = ~active[None, :, None, None]
        new.kv_k[:, rows, slot] = torch.where(keep, saved_k, new.kv_k[:, rows, slot])
        new.kv_v[:, rows, slot] = torch.where(keep, saved_v, new.kv_v[:, rows, slot])
        return logits, new._replace(length=torch.where(active, new.length, caches.length))

    @staticmethod
    def _check_step(n_rows: int, tokens: torch.Tensor, active: torch.Tensor) -> None:
        if tuple(tokens.shape) != (n_rows, 1):
            raise ValueError(
                f"decode_step_rows: tokens shape {tuple(tokens.shape)} != "
                f"({n_rows}, 1) for a {n_rows}-row cache"
            )
        if tuple(active.shape) != (n_rows,):
            raise ValueError(
                f"decode_step_rows: active shape {tuple(active.shape)} != "
                f"({n_rows},) for a {n_rows}-row cache"
            )

    # ------------------------------------------------------------------
    # Cost model hooks (used by the streaming simulator)
    # ------------------------------------------------------------------

    def prefill_flops(self, n_tokens: int, kv_prefix: int = 0) -> float:
        """Approximate forward FLOPs to prefill ``n_tokens`` given a prefix."""
        cfg = self.cfg
        L = cfg.dec_layers if cfg.family == "encdec" else cfg.n_layers
        d, ff = cfg.d_model, cfg.d_ff
        if cfg.family == "moe":
            ff_eff = ff * (cfg.moe_topk + cfg.n_shared_experts)
        else:
            ff_eff = ff
        per_tok = 2 * (
            d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.d_head  # qkv
            + cfg.n_heads * cfg.d_head * d  # out proj
            + 3 * d * ff_eff  # gated mlp
        )
        attn = 2 * 2 * cfg.n_heads * cfg.d_head * (
            n_tokens * kv_prefix + n_tokens * (n_tokens + 1) // 2
        )
        return float(L) * (per_tok * n_tokens + attn) + 2.0 * n_tokens * d * cfg.vocab_size
