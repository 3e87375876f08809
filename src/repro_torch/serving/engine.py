"""Serving engine: the paper's two LLM interfaces plus chunked prefill.

Implements (paper §6):
  * ``calculate_kv(context) -> KVCache``  — prefill without generation;
  * ``generate_with_kv(KVCache) -> text`` — generation that skips context
    prefill entirely;
plus ``prefill_extend`` — compute a text chunk's KV on top of already-loaded
chunk KV (the streamer's recompute fallback, paper §5.3 fn. 6) — and the
cache insertions that land decoded codec runs (``decode_to_cache`` for one
request, ``insert_runs`` for several requests' rows in one call).

The engine runs on one device, the CUDA card unless ``device`` names
another; the model's attention and the codec's reconstruction go through
the hand-written kernels there.

Cache ownership.  ``decode_to_cache`` and ``insert_runs`` write into the
caller's cache tensors *in place* (the reference donates those buffers, so
its callers already cannot reuse them).  ``generate_with_kv``,
``logits_with_kv`` and ``prefill_extend`` leave the caller's cache as it
was — the reference computes them functionally and callers reuse a prefill
cache across calls — by cloning it once at entry and updating the clone in
place.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.models.lm import Caches
from repro_torch.serving import kv_layout

__all__ = ["Engine"]


class Engine:
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
        return lm.prefill_extend(self.cfg, self.params, tokens, caches.clone())

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
        if not (len(rows) == len(starts) == len(run_tokens)):
            raise ValueError(
                f"insert_runs: {len(rows)} rows, {len(starts)} starts, "
                f"{len(run_tokens)} runs — one of each per run required"
            )
        if len(set(rows)) != len(rows):
            raise ValueError(f"insert_runs: duplicate cache rows in {rows}")
        n_rows = caches.kv_k.shape[1]
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
        k, v, ln = kv_layout.insert_codec_runs(
            caches.kv_k, caches.kv_v, caches.length,
            torch.as_tensor(kv_new, device=self.device),
            [int(r) for r in rows], [int(s) for s in starts], [int(t) for t in run_tokens],
        )
        return caches._replace(kv_k=k, kv_v=v, length=ln)

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
