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

Row-sharded caches.  ``serving.mesh_engine.ShardedEngine`` splits a
batch-of-requests cache's rows over a mesh's shards in blocked ranges
(global row ``r`` on shard ``r // (B/S)`` at local row ``r % (B/S)``) and
holds it as a :class:`ShardedCaches`, one plain :class:`Caches` a shard on
the shard's device.  The ``*_local`` functions are the per-shard bodies of
the row primitives: each takes *global* rows and its shard's index, and acts
on the rows that shard owns.  The schedulers read a cache of either kind
through :func:`cache_batch`, :func:`cache_dtype`, :func:`has_kv`,
:func:`synchronize` and :func:`extract_row`.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import Caches, masked_window_update

__all__ = [
    "caches_to_codec_kv",
    "codec_kv_to_caches",
    "insert_codec_run",
    "insert_codec_runs",
    "insert_codec_runs_local",
    "restore_row_local",
    "reset_rows_local",
    "ShardedCaches",
    "cache_batch",
    "cache_dtype",
    "has_kv",
    "synchronize",
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


def _local_rows(rows: Sequence[int], b_loc: int, shard: int) -> Tuple[List[int], List[bool]]:
    """Map global row ids to shard ``shard``'s local indices.

    Returns ``(local, mine)``: foreign rows get the out-of-range local index
    ``b_loc`` (a scratch slot whose writes are dropped — never a wrapped
    negative index, which tensor indexing would read Python-style)."""
    local = [int(r) - shard * b_loc for r in rows]
    mine = [0 <= i < b_loc for i in local]
    return [i if m else b_loc for i, m in zip(local, mine)], mine


def insert_codec_runs_local(
    kv_k: torch.Tensor,  # (L, B/S, cap, Hkv, Dh) this shard's cache slice, in place
    kv_v: torch.Tensor,
    length: torch.Tensor,  # (B/S,) int32 this shard's lengths
    kv_new: torch.Tensor,  # (L, 2, sum_T, C) decoded concat of the runs
    rows: Sequence[int],  # *global* cache row per run
    starts: Sequence[int],  # token offset per run
    run_tokens: Sequence[int],  # token count per run, concat order
    shard: int,  # this shard's index along the row axis
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-shard body of :func:`insert_codec_runs`.

    The same shifted-window merge as the unsharded function, restricted to
    this shard's rows: runs addressed to other shards land in the scratch
    row ``B/S`` and are dropped, so local rows they would otherwise alias
    keep their bytes.  ``kv_new`` may carry every run (the reference
    replicates them to all shards) or only this shard's."""
    L, b_loc, cap, Hkv, Dh = kv_k.shape
    t_max = max(run_tokens)
    local, _ = _local_rows(rows, b_loc, shard)
    length = length.clone()
    off = 0
    for row, start, T in zip(local, starts, run_tokens):
        if row < b_loc:
            piece = kv_new[:, :, off:off + T].reshape(L, 2, T, Hkv, Dh)
            masked_window_update(kv_k[:, row].transpose(0, 1), piece[:, 0].transpose(0, 1),
                                 start, T, window=t_max)
            masked_window_update(kv_v[:, row].transpose(0, 1), piece[:, 1].transpose(0, 1),
                                 start, T, window=t_max)
            length[row] = torch.clamp_min(length[row], int(start) + T)
        off += T
    return kv_k, kv_v, length


def restore_row_local(
    kv_k: torch.Tensor,  # (L, B/S, cap, Hkv, Dh) this shard's cache slice, in place
    kv_v: torch.Tensor,
    length: torch.Tensor,  # (B/S,) int32
    k_row: torch.Tensor,  # (L, T, Hkv, Dh) saved tokens
    v_row: torch.Tensor,
    row: int,  # *global* target row
    shard: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-shard body of :func:`restore_row`: the shard owning the global
    row writes the snapshot at its local index; every other shard writes
    the addressed slot's own bytes back (the reference's masked
    read-merge-write, which leaves them as they were; it never reads the
    snapshot, so the snapshot need only be on its owner's device)."""
    b_loc = kv_k.shape[1]
    T = k_row.shape[1]
    (local,), (own,) = _local_rows([row], b_loc, shard)
    li = min(local, b_loc - 1)  # clamp the foreign scratch index
    kv_k[:, li, :T] = k_row.to(kv_k.dtype) if own else kv_k[:, li, :T]
    kv_v[:, li, :T] = v_row.to(kv_v.dtype) if own else kv_v[:, li, :T]
    length = length.clone()
    if own:
        length[li] = T
    return kv_k, kv_v, length


def reset_rows_local(
    kv_k: torch.Tensor,  # (L, B/S, cap, Hkv, Dh) this shard's cache slice, in place
    kv_v: torch.Tensor,
    length: torch.Tensor,  # (B/S,) int32
    rows: Sequence[int],  # *global* rows to recycle
    shard: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-shard body of :func:`reset_rows`: each shard zeroes the recycled
    rows it owns; foreign rows map to the scratch index and are dropped."""
    b_loc = kv_k.shape[1]
    local, mine = _local_rows(rows, b_loc, shard)
    own = [i for i, m in zip(local, mine) if m]
    kv_k[:, own] = 0
    kv_v[:, own] = 0
    length = length.clone()
    length[own] = 0
    return kv_k, kv_v, length


class ShardedCaches(NamedTuple):
    """A batch-of-requests cache split by rows over a mesh's shards: one
    plain :class:`Caches` of ``B/S`` rows a shard, on the shard's device,
    shard ``s`` holding global rows ``[s * B/S, (s + 1) * B/S)``."""

    shards: Tuple[Caches, ...]

    @property
    def rows_per_shard(self) -> int:
        return int(self.shards[0].length.shape[0])

    def locate(self, row: int) -> Tuple[int, int]:
        """(shard, local row) of global ``row``."""
        return divmod(int(row), self.rows_per_shard)

    def clone(self) -> "ShardedCaches":
        return ShardedCaches(tuple(c.clone() for c in self.shards))

    def gather(self) -> Caches:
        """One plain cache of all rows in global order (a copy), on the
        first shard's device."""
        dev = self.shards[0].length.device
        return Caches(*(None if ts[0] is None else torch.cat([t.to(dev) for t in ts], dim=0 if name == "length" else 1)
                        for name, ts in zip(Caches._fields, zip(*self.shards))))


def cache_batch(caches) -> int:
    """Rows of a batch-of-requests cache, sharded or not."""
    if isinstance(caches, ShardedCaches):
        return sum(int(c.length.shape[0]) for c in caches.shards)
    return int(caches.length.shape[0])


def cache_dtype(caches) -> torch.dtype:
    """The K/V dtype of a cache, sharded or not."""
    first = caches.shards[0] if isinstance(caches, ShardedCaches) else caches
    return first.kv_k.dtype


def has_kv(caches) -> bool:
    """Whether the cache carries per-layer K/V (the attention families)."""
    first = caches.shards[0] if isinstance(caches, ShardedCaches) else caches
    return first.kv_k is not None


def synchronize(caches) -> None:
    """Wait for the queued device work on every device the cache lives on;
    nothing to wait for on the CPU."""
    parts = caches.shards if isinstance(caches, ShardedCaches) else (caches,)
    for dev in dict.fromkeys(c.length.device for c in parts):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


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


def extract_row(caches, row: int) -> Caches:
    """One request's batch-1 *view* of a batch-of-requests cache (no copy;
    see the module docstring): every field the family carries, the
    Mamba-2 states and the shared blocks' K/V included.  Of a
    :class:`ShardedCaches`, the owning shard's row, on its device."""
    if isinstance(caches, ShardedCaches):
        shard, row = caches.locate(row)
        caches = caches.shards[shard]
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
