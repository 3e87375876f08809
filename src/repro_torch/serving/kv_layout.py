"""Bridges between the serving engine's KV cache and the codec's
(L, 2, T, C) tensor layout, the row-pool primitives of the schedulers, and
cache allocation helpers.

The reference writes through ``dynamic_update_slice`` into donated buffers;
here the insertions update the cache tensors *in place* (slice assignment),
with the same clamping: a window whose start overhangs the capacity is
shifted back inside it rather than raising or being dropped.

Views and copies.  The reference's arrays are immutable, so its slices are
snapshots; here the pool cache is written in place, so each function states
what it returns:

  * ``insert_codec_run``, ``insert_codec_runs``, ``restore_row`` and
    ``reset_rows`` write the given ``kv_k``/``kv_v`` in place and return a
    *new* ``length`` tensor (the caller's is left as it was);
  * ``save_row`` returns a :class:`RowSnapshot` that owns copies — later
    writes to the pool cache cannot change it;
  * ``extract_row`` returns *views* of one row: a later in-place write to
    that row of the pool cache shows through, so a caller that keeps the
    row past such a write takes ``.clone()`` of it (the continuous
    scheduler does, when a load finishes and its row goes on generating
    or to the next tenant);
  * ``caches_to_codec_kv`` returns a new f32 tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import Caches, masked_window_update

__all__ = [
    "caches_to_codec_kv",
    "codec_kv_to_caches",
    "insert_codec_run",
    "insert_codec_runs",
    "RowSnapshot",
    "save_row",
    "restore_row",
    "reset_rows",
    "extract_row",
    "alloc_caches",
    "kv_cache_bytes",
]


def insert_codec_run(
    kv_k: torch.Tensor,  # (L, B, cap, Hkv, Dh) serving cache, updated in place
    kv_v: torch.Tensor,
    length: torch.Tensor,  # (B,) int32
    kv_new: torch.Tensor,  # (L, 2, T, C) decoded run (codec.decode_chunks)
    start: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Write a decoded codec run into every batch row at ``[start, start+T)``.

    In place: the reshape to the attention layout ``(L, T, Hkv, Dh)`` is a
    view and the batch broadcast happens in the slice assignment.  The start
    is placed as ``dynamic_update_slice`` places it: a negative start counts
    from the end, then it clamps to ``[0, cap - T]``.
    ``length`` advances monotonically (``maximum`` with the *unclamped*
    ``start + T``, as in the reference) so interleaved TEXT/bitstream chunk
    orders can never shrink the cache.
    """
    L, B, cap, Hkv, Dh = kv_k.shape
    T = kv_new.shape[2]
    if T > cap:
        raise ValueError(f"run of {T} tokens exceeds cache capacity {cap}")
    s0 = int(start)
    s0 = min(max(s0 + cap if s0 < 0 else s0, 0), cap - T)
    kv_k[:, :, s0:s0 + T] = kv_new[:, 0].reshape(L, 1, T, Hkv, Dh).to(kv_k.dtype)
    kv_v[:, :, s0:s0 + T] = kv_new[:, 1].reshape(L, 1, T, Hkv, Dh).to(kv_v.dtype)
    length = torch.clamp_min(length, int(start) + T)
    return kv_k, kv_v, length


def insert_codec_runs(
    kv_k: torch.Tensor,  # (L, B, cap, Hkv, Dh) batch-of-requests cache, in place
    kv_v: torch.Tensor,
    length: torch.Tensor,  # (B,) int32
    kv_new: torch.Tensor,  # (L, 2, sum_T, C) decoded concat of all runs
    rows: Sequence[int],  # cache row per run (distinct)
    starts: Sequence[int],  # token offset per run
    run_tokens: Sequence[int],  # token count per run, concat order
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Write R decoded runs — one per *request* — into their cache rows.

    Run ``i`` lands in row ``rows[i]`` at token offset ``starts[i]``; rows
    not named keep their contents byte for byte.  Each write is the
    reference's shifted window of ``max(run_tokens)`` tokens
    (``lm.masked_window_update``), so a run whose window would overhang the
    capacity is placed exactly as the reference places it.
    """
    L, B, cap, Hkv, Dh = kv_k.shape
    t_max = max(run_tokens)
    length = length.clone()
    off = 0
    for row, start, T in zip(rows, starts, run_tokens):
        piece = kv_new[:, :, off:off + T].reshape(L, 2, T, Hkv, Dh)
        off += T
        # token axis leading: (cap, L, Hkv, Dh) views of the row
        masked_window_update(kv_k[:, row].transpose(0, 1), piece[:, 0].transpose(0, 1),
                             start, T, window=t_max)
        masked_window_update(kv_v[:, row].transpose(0, 1), piece[:, 1].transpose(0, 1),
                             start, T, window=t_max)
        length[row] = torch.clamp_min(length[row], int(start) + T)
    return kv_k, kv_v, length


@dataclasses.dataclass
class RowSnapshot:
    """A suspended session's realized KV: the first ``n_tokens`` tokens of
    its cache row, copied out (the snapshot owns its tensors, so later
    in-place writes to the pool cache cannot change it).  Restored —
    possibly into a *different* row — by :func:`restore_row`."""

    kv_k: torch.Tensor  # (L, T, Hkv, Dh)
    kv_v: torch.Tensor  # (L, T, Hkv, Dh)
    n_tokens: int


def save_row(caches: Caches, row: int, n_tokens: int) -> RowSnapshot:
    """Snapshot (copy) the realized prefix of one request's cache row; the
    exact bytes come back through :func:`restore_row`."""
    n = int(n_tokens)
    return RowSnapshot(
        kv_k=caches.kv_k[:, row, :n].clone(),
        kv_v=caches.kv_v[:, row, :n].clone(),
        n_tokens=n,
    )


def restore_row(
    kv_k: torch.Tensor,  # (L, B, cap, Hkv, Dh) pool cache, updated in place
    kv_v: torch.Tensor,
    length: torch.Tensor,  # (B,) int32
    k_row: torch.Tensor,  # (L, T, Hkv, Dh) saved tokens (RowSnapshot.kv_k)
    v_row: torch.Tensor,
    row: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Write a suspended session's saved tokens at ``[0, T)`` of ``row``
    and set its length to ``T``.  The row must have been reset (length 0)
    before: the pool hands out recycled rows zeroed."""
    T = k_row.shape[1]
    kv_k[:, row, :T] = k_row.to(kv_k.dtype)
    kv_v[:, row, :T] = v_row.to(kv_v.dtype)
    length = length.clone()
    length[row] = T
    return kv_k, kv_v, length


def reset_rows(
    kv_k: torch.Tensor,  # (L, B, cap, Hkv, Dh) pool cache, updated in place
    kv_v: torch.Tensor,
    length: torch.Tensor,  # (B,) int32
    rows: Sequence[int],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Zero recycled rows (K/V and length) before a new session takes them.

    A recycled row must look exactly like a row of a fresh
    :func:`alloc_caches` cache — the length reset matters doubly because
    run insertion advances length monotonically, so a stale tenant's length
    would corrupt the new tenant's offsets.
    """
    rows = [int(r) for r in rows]
    kv_k[:, rows] = 0
    kv_v[:, rows] = 0
    length = length.clone()
    length[rows] = 0
    return kv_k, kv_v, length


def extract_row(caches: Caches, row: int) -> Caches:
    """One request's batch-1 *view* of a batch-of-requests cache (no copy;
    see the module docstring): every field the family carries, the
    Mamba-2 states and the shared blocks' K/V included."""
    sl = slice(row, row + 1)
    return Caches(*(None if t is None else t[sl] if name == "length" else t[:, sl]
                    for name, t in zip(Caches._fields, caches)))


def caches_to_codec_kv(caches: Caches, batch_index: int, n_tokens: int) -> torch.Tensor:
    """Extract one request's KV as (L, 2, T, C) float32, on the cache's device."""
    k = caches.kv_k[:, batch_index, :n_tokens].to(torch.float32)
    v = caches.kv_v[:, batch_index, :n_tokens].to(torch.float32)
    L, T, Hkv, Dh = k.shape
    return torch.stack([k.reshape(L, T, Hkv * Dh), v.reshape(L, T, Hkv * Dh)], dim=1)


def codec_kv_to_caches(
    kv,  # (L, 2, T, C)
    cfg: ArchConfig,
    *,
    batch: int = 1,
    capacity: Optional[int] = None,
    dtype=torch.bfloat16,
    device=None,
) -> Caches:
    """Materialize decoded KV into a serving cache (single request, replicated
    across ``batch`` rows for batched generation experiments)."""
    dev = resolve_device(device)
    kv = torch.as_tensor(kv, device=dev)
    L, two, T, C = kv.shape
    Hkv, Dh = cfg.n_kv_heads, cfg.d_head
    if C != Hkv * Dh:
        raise ValueError(f"C={C} != {Hkv}x{Dh}")
    caches = alloc_caches(cfg, batch, capacity or T, dtype=dtype, device=dev)
    caches.kv_k[:, :, :T] = kv[:, 0].reshape(L, 1, T, Hkv, Dh).to(dtype)
    caches.kv_v[:, :, :T] = kv[:, 1].reshape(L, 1, T, Hkv, Dh).to(dtype)
    return caches._replace(length=torch.full((batch,), T, dtype=torch.int32, device=dev))


def alloc_caches(cfg: ArchConfig, batch: int, capacity: int, dtype=torch.bfloat16,
                 device=None) -> Caches:
    """Empty caches for attention families."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, capacity, cfg.n_kv_heads, cfg.d_head)
    return Caches(
        kv_k=torch.zeros(shape, dtype=dtype, device=dev),
        kv_v=torch.zeros(shape, dtype=dtype, device=dev),
        length=torch.zeros((batch,), dtype=torch.int32, device=dev),
    )


def kv_cache_bytes(cfg: ArchConfig, n_tokens: int, dtype_bytes: int = 2) -> int:
    """Raw KV cache size for one request (the paper's '25 GB for 16K' figure)."""
    if cfg.family == "hybrid":
        n_apps = cfg.n_layers // max(cfg.shared_block_every, 1)
        return n_apps * 2 * n_tokens * cfg.kv_channels * dtype_bytes
    if not cfg.has_kv_cache:
        return 0
    L = cfg.dec_layers if cfg.family == "encdec" else cfg.n_layers
    return L * 2 * n_tokens * cfg.kv_channels * dtype_bytes
