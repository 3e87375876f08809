"""Offline probability-table profiling for the KV codec (paper Insight 3).

CacheGen profiles a separate symbol distribution for every (layer, K/V,
channel) combination of delta tensors — and another set for anchor tensors —
once per model, and reuses them for every context served by that model.
This module builds those tables from calibration KV caches and converts them
to rANS-ready quantized frequency tables.

Channel bucketing: per-channel tables are exact for small models; for very
wide models the tables can be hashed into ``channel_buckets`` buckets with
negligible compression loss (measured in benchmarks/ablation.py).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.rans import CoderTables

__all__ = [
    "normalize_freqs",
    "build_coder_tables",
    "histogram_symbols",
    "entropy_bits_per_symbol",
    "lane_table_index",
]


def normalize_freqs(counts: np.ndarray, precision: int) -> np.ndarray:
    """Quantize per-table histograms to frequencies summing to 2**precision.

    counts: (n_tables, A) nonneg ints/floats.  Every output frequency is >= 1
    (Laplace smoothing) so any symbol stays codable, and <= 2**precision - 1
    so the rANS renormalization bound holds.

    The result is the reference's, table for table: a row short of
    2**precision gets +1 per symbol in order of falling remainder, cycling
    through the alphabet; a row over it gets -1 per symbol above 1 in order
    of falling frequency, cycling until the row sums exactly.  Both fix-ups
    walk each row's order (the same ``argsort`` call as the reference's) in
    whole passes computed at once, not one step per unit, which at full
    width is the difference between seconds and minutes.
    """
    counts = np.asarray(counts, dtype=np.float64) + 1.0  # Laplace
    n_tables, A = counts.shape
    M = 1 << precision
    if A < 2:
        raise ValueError("alphabet must have >= 2 symbols")
    if A > M:
        raise ValueError(f"alphabet {A} larger than 2**precision {M}")
    target = counts / counts.sum(axis=1, keepdims=True) * M
    f = np.maximum(np.floor(target), 1.0).astype(np.int64)
    # largest-remainder style fixup to make each row sum exactly to M
    deficit = M - f.sum(axis=1)
    rem = target - np.floor(target)
    ranks = np.arange(A)
    for i in np.flatnonzero(deficit):
        d = int(deficit[i])
        if d > 0:
            # unit j goes to rank j % A: whole passes, then the first d % A
            order = np.argsort(-rem[i])
            f[i, order] += d // A + (ranks < d % A)
        else:
            # pass p takes one unit from each rank whose room (f - 1)
            # exceeds p, in rank order, until -d units are taken: find the
            # last whole pass, then the first ranks of the partial one
            order = np.argsort(-f[i])
            room = f[i, order] - 1
            need = -d
            lo, hi = 0, int(room.max())  # the largest P with sum(min(room, P)) <= need
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if np.minimum(room, mid).sum() <= need:
                    lo = mid
                else:
                    hi = mid - 1
            take = np.minimum(room, lo)
            left = need - int(take.sum())
            more = room > lo
            take[more] += np.cumsum(more)[more] <= left
            f[i, order] -= take
    assert (f.sum(axis=1) == M).all()
    assert (f >= 1).all() and (f < M).all()
    return f.astype(np.uint32)


def build_coder_tables(
    freqs: np.ndarray, precision: int, device: torch.device | str
) -> CoderTables:
    """freqs (n_tables, A) summing to 2**precision -> rANS tables on ``device``."""
    freqs = np.asarray(freqs, dtype=np.uint32)
    n_tables, A = freqs.shape
    M = 1 << precision
    cums = np.zeros((n_tables, A + 1), dtype=np.int64)
    np.cumsum(freqs, axis=1, out=cums[:, 1:])
    assert (cums[:, -1] == M).all()
    slot2sym = np.zeros((n_tables, M), dtype=np.int16)
    sym_ids = np.arange(A, dtype=np.int16)
    for i in range(n_tables):
        slot2sym[i] = np.repeat(sym_ids, freqs[i])
    return CoderTables(
        freqs=torch.as_tensor(freqs.astype(np.int64), device=device),
        cums=torch.as_tensor(cums, device=device),
        slot2sym=torch.as_tensor(slot2sym, device=device),
        precision=precision,
    )


def histogram_symbols(
    symbols: np.ndarray, table_idx: np.ndarray, n_tables: int, alphabet: int
) -> np.ndarray:
    """Accumulate per-table symbol counts.

    symbols: (n_lanes, n_sym) ints; table_idx: (n_lanes,).
    Returns (n_tables, alphabet) int64.
    """
    symbols = np.asarray(symbols, dtype=np.int64)
    table_idx = np.asarray(table_idx, dtype=np.int64)
    flat = (table_idx[:, None] * alphabet + symbols).ravel()
    counts = np.bincount(flat, minlength=n_tables * alphabet)
    return counts.reshape(n_tables, alphabet)


def entropy_bits_per_symbol(counts: np.ndarray) -> float:
    """Empirical entropy (bits/symbol) of pooled per-table distributions.

    Each table contributes its own entropy weighted by its symbol mass —
    i.e. the achievable bits/symbol of an ideal coder using per-table
    static distributions (the quantity plotted in paper Fig. 5).
    """
    counts = np.asarray(counts, dtype=np.float64)
    totals = counts.sum(axis=-1, keepdims=True)
    mass = totals.squeeze(-1) / max(counts.sum(), 1.0)
    p = counts / np.maximum(totals, 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        h = -np.where(p > 0, p * np.log2(p), 0.0).sum(axis=-1)
    return float((h * mass).sum())


def lane_table_index(
    n_layers: int,
    n_channels: int,
    channel_buckets: Optional[int] = None,
) -> np.ndarray:
    """Map lane (layer, kv, channel) -> table index.

    Lanes are ordered ``lane = (l * 2 + kv) * C + c``.  With bucketing, the
    channel id is folded modulo ``channel_buckets``.
    """
    L, C = n_layers, n_channels
    lanes = np.arange(L * 2 * C)
    c = lanes % C
    lkv = lanes // C
    if channel_buckets is None or channel_buckets >= C:
        return (lkv * C + c).astype(np.int32)
    b = c % channel_buckets
    return (lkv * channel_buckets + b).astype(np.int32)


def n_tables_for(
    n_layers: int, n_channels: int, channel_buckets: Optional[int] = None
) -> int:
    eff = n_channels if (channel_buckets is None or channel_buckets >= n_channels) else channel_buckets
    return n_layers * 2 * eff
