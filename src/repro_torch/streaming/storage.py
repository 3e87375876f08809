"""KV bitstream store: content-addressed chunks under a tiered read path.

``store_kv`` splits a context's KV along the token axis into chunks (default
1.5K tokens, paper §5.3), pre-encodes every chunk at every level via the
codec (``codec.encode_all_levels``, whose lossy delta symbols come from the
kernel K5), and records per-(chunk, level) sizes in :class:`ChunkMeta`;
``get_kv`` returns the checksum-verified bitstream for a (chunk, level) and
``decode`` rebuilds it (``codec.decode_chunk``, kernel K6) as a tensor on
the codec tables' device.

Blob I/O goes through a :class:`StorageBackend`: :class:`MemoryBackend` (a
dict, the default) or :class:`DirectoryBackend` (one file per entry).

Chunks of a :class:`TieredKVStore` are keyed by a **versioned chain hash**
over the token prefix (the vLLM prefix-caching idiom), so identical document
prefixes across contexts dedup to the same blobs:

    root  = sha256(b"cachegen-" + VERSION + b"\\0" + namespace)
    h_i   = sha256(h_{i-1} || payload_i)          (raw 32-byte digests)
    key_i = VERSION + "-" + hex(h_i)[:40]

where ``payload_i`` is the chunk's token ids as little-endian ``uint32``
bytes when the caller passes ``tokens=`` to ``store_kv`` (the canonical
spelling, :func:`token_payloads`), else the chunk's raw KV bytes
(dtype-tagged).  Because ``h_i`` covers the *entire* prefix, equal keys
imply equal token prefixes at equal positions, so the codec header's
baked-in ``chunk_idx`` always matches and dedup stays bit-correct.
``namespace`` defaults to the codec-table config, so stores with different
codecs never alias.  The ``VERSION`` prefix ("kvh1") makes any future
layout change detectable at the key level.

Tiers.  :class:`TieredKVStore` runs a capacity-bounded **hot tier** over a
durable **cold tier** (any :class:`StorageBackend`).  Writes land hot when
they fit and spill cold otherwise.  Eviction is per ``(hash, level)`` LRU
and level-aware (lowest keep-priority first); demotion writes through to
cold before the hot copy is dropped whenever a context still references the
hash.  Reads try hot, then cold (and promote), and ``tier_penalty`` prices a
run's cold entries in virtual seconds so ``SimTransport`` can report the
slower fetch to the session's throughput estimator.  The flat
:class:`KVStore` is the differential oracle: a never-evict tiered store
serves the same bytes through a full serving session.

Everything here is host-side bytes; only ``decode`` touches the device.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import codec as kvcodec

__all__ = [
    "ChunkMeta",
    "DirectoryBackend",
    "HASH_CHAIN_VERSION",
    "KVStore",
    "MemoryBackend",
    "StorageBackend",
    "TieredKVStore",
    "chain_hashes",
    "split_chunks",
    "token_payloads",
    "DEFAULT_CHUNK_TOKENS",
]

DEFAULT_CHUNK_TOKENS = 1536  # paper: ~1.5K tokens

#: Version tag baked into the chain root *and* every key string — bump it
#: and every old key becomes unreachable-by-construction instead of
#: silently misread under a new layout.
HASH_CHAIN_VERSION = "kvh1"


def split_chunks(n_tokens: int, chunk_tokens: int) -> List[Tuple[int, int]]:
    """[(start, end)) chunk boundaries."""
    out = []
    s = 0
    while s < n_tokens:
        out.append((s, min(s + chunk_tokens, n_tokens)))
        s += chunk_tokens
    return out


def chain_hashes(payloads: Iterable[bytes], namespace: str = "") -> List[str]:
    """Chain-hash keys ``[key_1, ..., key_n]`` for a sequence of chunk
    payloads (see module docstring for the exact construction)."""
    h = hashlib.sha256(
        b"cachegen-" + HASH_CHAIN_VERSION.encode() + b"\0" + namespace.encode()
    ).digest()
    keys = []
    for p in payloads:
        h = hashlib.sha256(h + p).digest()
        keys.append(f"{HASH_CHAIN_VERSION}-{h.hex()[:40]}")
    return keys


def token_payloads(
    tokens: Sequence[int], bounds: Sequence[Tuple[int, int]]
) -> List[bytes]:
    """Canonical chain payloads: each chunk's token ids as LE uint32."""
    arr = np.asarray(tokens, dtype=np.uint32)
    return [arr[s:e].astype("<u4").tobytes() for s, e in bounds]


@dataclasses.dataclass
class ChunkMeta:
    context_id: str
    chunk_idx: int
    start: int
    end: int
    sizes: Dict[int, int]  # level -> encoded bytes
    text_bytes: int  # raw text fallback size (~4 B/token)
    chunk_hash: Optional[str] = None  # chain-hash key (content-addressed stores)

    @property
    def n_tokens(self) -> int:
        return self.end - self.start


def _missing(cid: str, ci: int, lvl: int, detail: str = "") -> KeyError:
    extra = f" ({detail})" if detail else ""
    return KeyError(
        f"no stored bitstream for context {cid!r} chunk {ci} level {lvl}{extra}"
    )


@runtime_checkable
class StorageBackend(Protocol):
    """Byte-addressed KV-bitstream map: ``(context, chunk, level) -> blob``.

    ``get`` must raise a ``KeyError`` whose message names the missing
    context/chunk/level (not a bare tuple or an opaque file path).  The
    tiered store reuses the same triple interface for content-addressed
    blobs, keyed ``(hash, 0, level)``: any backend works as either tier.
    """

    def put(self, context_id: str, chunk_idx: int, level: int, blob: bytes) -> None:
        ...

    def get(self, context_id: str, chunk_idx: int, level: int) -> bytes:
        ...

    def contains(self, context_id: str, chunk_idx: int, level: int) -> bool:
        ...

    def delete(self, context_id: str, chunk_idx: int, level: int) -> bool:
        """Remove one entry; True if it existed (no error when absent)."""
        ...


class MemoryBackend:
    """In-process dict backend — the default."""

    def __init__(self):
        self._mem: Dict[Tuple[str, int, int], bytes] = {}

    def put(self, context_id: str, chunk_idx: int, level: int, blob: bytes) -> None:
        self._mem[(context_id, chunk_idx, level)] = blob

    def get(self, context_id: str, chunk_idx: int, level: int) -> bytes:
        try:
            return self._mem[(context_id, chunk_idx, level)]
        except KeyError:
            raise _missing(context_id, chunk_idx, level, "memory backend") from None

    def contains(self, context_id: str, chunk_idx: int, level: int) -> bool:
        return (context_id, chunk_idx, level) in self._mem

    def delete(self, context_id: str, chunk_idx: int, level: int) -> bool:
        return self._mem.pop((context_id, chunk_idx, level), None) is not None


class DirectoryBackend:
    """One file per (context, chunk, level) under ``directory``.

    ``put`` is atomic: bytes land in a same-directory temp file first and
    are published with ``os.replace``, so a writer killed mid-write leaves
    the previous blob (or a clean absence) — never a truncated file that
    only surfaces later as a read-time ``IntegrityError``.
    """

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, cid: str, ci: int, lvl: int) -> str:
        return os.path.join(self.directory, f"{cid}.c{ci:04d}.l{lvl}.kvbs")

    def put(self, context_id: str, chunk_idx: int, level: int, blob: bytes) -> None:
        path = self._path(context_id, chunk_idx, level)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise

    def get(self, context_id: str, chunk_idx: int, level: int) -> bytes:
        path = self._path(context_id, chunk_idx, level)
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise _missing(
                context_id, chunk_idx, level, f"no file {path}"
            ) from None

    def contains(self, context_id: str, chunk_idx: int, level: int) -> bool:
        return os.path.exists(self._path(context_id, chunk_idx, level))

    def delete(self, context_id: str, chunk_idx: int, level: int) -> bool:
        try:
            os.remove(self._path(context_id, chunk_idx, level))
            return True
        except FileNotFoundError:
            return False


class KVStore:
    """Write/metadata frontend for encoded KV bitstreams over a backend.

    The *flat* store: context-keyed, no sharing, no eviction; the
    differential oracle for :class:`TieredKVStore`.  The frontend
    owns the codec tables, the chunk split, the pre-encoding of every level,
    and the per-context :class:`ChunkMeta` index; all blob I/O goes through
    ``self.backend`` (a :class:`StorageBackend`).  ``directory=`` is a
    convenience spelling of ``backend=DirectoryBackend(directory)``.
    """

    def __init__(
        self,
        tables: kvcodec.CodecTables,
        directory: Optional[str] = None,
        *,
        backend: Optional[StorageBackend] = None,
    ):
        # one-time upgrade: hand-built / unpickled tables may lack the
        # pre-stacked sets the batched coder calls need on the hot path
        self.tables = kvcodec.ensure_stacks(tables)
        if backend is not None and directory is not None:
            raise ValueError("pass either directory or backend, not both")
        if backend is None:
            backend = DirectoryBackend(directory) if directory else MemoryBackend()
        self.backend = backend
        self._meta: Dict[str, List[ChunkMeta]] = {}

    # -- write path (offline) ------------------------------------------------

    def store_kv(
        self,
        context_id: str,
        kv,  # (L, 2, T, C) tensor or array
        *,
        chunk_tokens: int = DEFAULT_CHUNK_TOKENS,
        levels: Optional[List[int]] = None,
        bytes_per_token_text: int = 4,
        tokens: Optional[Sequence[int]] = None,  # accepted for API parity
    ) -> List[ChunkMeta]:
        all_levels = list(range(self.tables.config.n_levels))
        levels = all_levels if levels is None else levels
        batch_all = levels == all_levels
        T = kv.shape[2]
        metas = []
        for ci, (s, e) in enumerate(split_chunks(T, chunk_tokens)):
            if batch_all:
                # batched: anchors symbolized/coded once, delta levels in one
                # stacked rANS call (byte-identical to per-level encoding)
                blobs = kvcodec.encode_all_levels(kv[:, :, s:e], self.tables, ci)
            else:
                blobs = {
                    lvl: kvcodec.encode_chunk(kv[:, :, s:e], self.tables, lvl, ci)
                    for lvl in levels
                }
            sizes = {}
            for lvl in levels:
                blob = blobs[lvl]
                self._put(context_id, ci, lvl, blob)
                sizes[lvl] = len(blob)
            metas.append(
                ChunkMeta(
                    context_id=context_id,
                    chunk_idx=ci,
                    start=s,
                    end=e,
                    sizes=sizes,
                    text_bytes=(e - s) * bytes_per_token_text,
                )
            )
        self._meta[context_id] = metas
        return metas

    def _put(self, cid: str, ci: int, lvl: int, blob: bytes) -> None:
        self.backend.put(cid, ci, lvl, blob)

    # -- read path (online) --------------------------------------------------

    def get_kv(self, context_id: str, chunk_idx: int, level: int) -> bytes:
        """Blob for one (chunk, level); raises a descriptive ``KeyError``
        naming context/chunk/level when missing (either backend), and a
        ``bitstream.IntegrityError`` naming the same when the blob's
        checksum trailer does not match — corruption at rest is caught at
        the store boundary, before any bytes cross a link."""
        with tracing.span("store.get", ctx=context_id, chunk=chunk_idx, level=level):
            blob = self.backend.get(context_id, chunk_idx, level)
            try:
                kvcodec.verify_chunk(blob)
            except ValueError as e:  # IntegrityError is a ValueError
                raise type(e)(
                    f"stored bitstream for context {context_id!r} chunk "
                    f"{chunk_idx} level {level} failed integrity check: {e}"
                ) from e
            return blob

    def delete_kv(self, context_id: str, chunk_idx: int, level: int) -> bool:
        """Remove one (chunk, level) blob; True if it existed.  Metadata is
        left intact — a reader then sees the descriptive ``KeyError`` of a
        missing entry, which is exactly the fault the retry machinery
        classifies as permanent-at-level."""
        return self.backend.delete(context_id, chunk_idx, level)

    def get_run(
        self, context_id: str, chunk_levels: List[Tuple[int, int]]
    ) -> List[bytes]:
        """Fetch the bitstreams of one decode run: [(chunk_idx, level), ...]."""
        return [self.get_kv(context_id, ci, lvl) for ci, lvl in chunk_levels]

    def meta(self, context_id: str) -> List[ChunkMeta]:
        try:
            return self._meta[context_id]
        except KeyError:
            raise KeyError(
                f"no chunk metadata for context {context_id!r} "
                f"(known: {sorted(self._meta)})"
            ) from None

    def decode(self, blob: bytes) -> torch.Tensor:
        """One chunk's KV (L, 2, T, C) f32 on the tables' device."""
        return kvcodec.decode_chunk(blob, self.tables)

    def total_bytes(self, context_id: str, level: int) -> int:
        return sum(m.sizes[level] for m in self.meta(context_id))

    def storage_bytes(self, context_id: str) -> int:
        """Total storage across all pre-encoded levels (paper Fig. 15d)."""
        return sum(sum(m.sizes.values()) for m in self.meta(context_id))


# ---------------------------------------------------------------------------
# TieredKVStore: content-addressed blobs, hot tier over cold
# ---------------------------------------------------------------------------


def _kv_chunk_bytes(kv, s: int, e: int) -> Tuple[str, bytes]:
    """(numpy dtype string, C-order bytes) of ``kv[:, :, s:e]``, spelled as
    numpy spells them for an array of the same values (bf16: ``"<V2"``)."""
    if isinstance(kv, torch.Tensor):
        part = kv[:, :, s:e].detach().contiguous().cpu()
        if part.dtype == torch.bfloat16:
            return "<V2", part.view(torch.int16).numpy().tobytes()
        arr = part.numpy()
    else:
        arr = np.ascontiguousarray(np.asarray(kv)[:, :, s:e])
    return arr.dtype.str, arr.tobytes()


class TieredKVStore(KVStore):
    """Content-addressed, prefix-sharing store with a hot tier over cold.

    Blobs live under ``(chunk_hash, 0, level)`` in two
    :class:`StorageBackend` tiers; per-context metadata is a list of hash
    references and per-hash refcounts track cross-context sharing.  See the
    module docstring for the hash-chain format and tier semantics.

    ``hot_bytes`` bounds the hot tier (0 = everything cold, ``None``/huge =
    never evict).  ``level_priorities`` maps level -> keep-priority (higher
    stays hot longer).  When omitted it is seeded from the port's own
    session report, ``BENCH_torch_session.json``, via
    ``calibration.measured_level_priorities`` (levels with no measurement get
    priority 0.0 and evict first).  The reference seeds it from its
    ``BENCH_session.json``; the port never reads a JAX measurement, and no
    port benchmark writes its report yet, so by default every level has
    priority 0.0 here and eviction is plain LRU, where the reference's
    follows its measured pick fractions.  Pass ``level_priorities`` (or
    point both packages at one report) to make the two evict alike.
    ``cold_latency_s`` / ``cold_gbps`` price a cold read for
    :meth:`tier_penalty`, the virtual surcharge ``SimTransport`` folds into
    a fetch's modeled timing; wall-real transports (local/tcp) pay the cold
    tier's actual read time instead.

    ``probation`` (2Q-style read-path admission) gates promotion: a cold
    read is admitted hot only on its *second* cold touch within the last
    ``probation`` cold reads; the first touch records a ghost entry (key
    only, no bytes), so one-shot scans cannot flush the hot tier's re-read
    working set.  ``None`` (default) promotes on the first read.
    """

    def __init__(
        self,
        tables: kvcodec.CodecTables,
        *,
        hot_bytes: Optional[int] = None,
        cold: Optional[StorageBackend] = None,
        hot: Optional[StorageBackend] = None,
        level_priorities: Optional[Dict[int, float]] = None,
        cold_latency_s: float = 0.002,
        cold_gbps: float = 2.0,
        promote_on_read: bool = True,
        probation: Optional[int] = None,
        namespace: Optional[str] = None,
    ):
        if probation is not None and probation < 1:
            raise ValueError(
                f"TieredKVStore probation window must be >= 1 cold reads "
                f"(or None to disable), got {probation}"
            )
        cold = cold if cold is not None else MemoryBackend()
        super().__init__(tables, backend=cold)
        self.cold = cold  # self.backend aliases the durable tier
        self.hot = hot if hot is not None else MemoryBackend()
        self.hot_bytes = int(hot_bytes) if hot_bytes is not None else (1 << 62)
        self.cold_latency_s = float(cold_latency_s)
        self.cold_gbps = float(cold_gbps)
        self.promote_on_read = bool(promote_on_read)
        self.namespace = (
            namespace if namespace is not None else repr(self.tables.config)
        )
        if level_priorities is None:
            from repro_torch.streaming import calibration

            level_priorities = calibration.measured_level_priorities()
        self.level_priorities = dict(level_priorities)
        # (hash, level) -> blob size; insertion order = recency (end newest)
        self._hot_lru: "OrderedDict[Tuple[str, int], int]" = OrderedDict()
        self._hot_used = 0
        self._refcount: Dict[str, int] = {}  # hash -> contexts referencing
        self._hash_levels: Dict[str, Dict[int, int]] = {}  # hash -> {lvl: size}
        self._lock = threading.RLock()
        self.n_hot_hits = 0
        self.n_cold_hits = 0
        self.n_misses = 0
        self.n_promotions = 0
        self.n_demotions = 0
        self.n_evictions = 0
        self.n_dedup_chunks = 0
        self.n_encoded_chunks = 0
        # 2Q probation ghost table: (hash, level) -> cold-read sequence of
        # the first touch; entries older than the window expire unpromoted
        self.probation = int(probation) if probation is not None else None
        self._probation: "OrderedDict[Tuple[str, int], int]" = OrderedDict()
        self._cold_read_seq = 0
        self.n_probation_adds = 0
        self.n_probation_promotes = 0
        self.n_probation_expired = 0

    # -- hashing -------------------------------------------------------------

    def chunk_hashes(
        self,
        kv,
        bounds: Sequence[Tuple[int, int]],
        tokens: Optional[Sequence[int]] = None,
    ) -> List[str]:
        """Chain-hash keys for one context's chunks: over token ids when
        ``tokens`` is given (canonical), else over the raw KV bytes."""
        if tokens is not None:
            if len(tokens) != kv.shape[2]:
                raise ValueError(
                    f"tokens length {len(tokens)} != KV token axis {kv.shape[2]}"
                )
            payloads = token_payloads(tokens, bounds)
        else:
            payloads = []
            for s, e in bounds:
                dtype, raw = _kv_chunk_bytes(kv, s, e)
                payloads.append(f"kvbytes:{dtype}:".encode() + raw)
        return chain_hashes(payloads, namespace=self.namespace)

    def hash_for(self, context_id: str, chunk_idx: int) -> str:
        metas = self.meta(context_id)
        try:
            h = metas[chunk_idx].chunk_hash
        except IndexError:
            raise _missing(
                context_id, chunk_idx, -1,
                f"chunk index out of range (context has {len(metas)} chunks)",
            ) from None
        assert h is not None
        return h

    def try_hash(self, context_id: str, chunk_idx: int) -> Optional[str]:
        """``hash_for`` that answers None instead of raising (transports)."""
        try:
            return self.hash_for(context_id, chunk_idx)
        except KeyError:
            return None

    # -- write path ----------------------------------------------------------

    def store_kv(
        self,
        context_id: str,
        kv,  # (L, 2, T, C) tensor or array
        *,
        chunk_tokens: int = DEFAULT_CHUNK_TOKENS,
        levels: Optional[List[int]] = None,
        bytes_per_token_text: int = 4,
        tokens: Optional[Sequence[int]] = None,
    ) -> List[ChunkMeta]:
        all_levels = list(range(self.tables.config.n_levels))
        levels = all_levels if levels is None else levels
        batch_all = levels == all_levels
        T = kv.shape[2]
        bounds = split_chunks(T, chunk_tokens)
        hashes = self.chunk_hashes(kv, bounds, tokens)
        with self._lock:
            if context_id in self._meta:
                self._release_context(context_id)
        metas = []
        for ci, (s, e) in enumerate(bounds):
            h = hashes[ci]
            with self._lock:
                have = self._hash_levels.get(h, {})
                dedup = all(lvl in have for lvl in levels)
                if dedup:
                    sizes = {lvl: have[lvl] for lvl in levels}
                    self.n_dedup_chunks += 1
            if not dedup:
                # encoding is deterministic (batched == per-level, byte for
                # byte), so re-encoding a shared chunk would give the same
                # bytes: skipping it above is pure savings
                if batch_all:
                    blobs = kvcodec.encode_all_levels(kv[:, :, s:e], self.tables, ci)
                else:
                    blobs = {
                        lvl: kvcodec.encode_chunk(kv[:, :, s:e], self.tables, lvl, ci)
                        for lvl in levels
                    }
                sizes = {}
                with self._lock:
                    slot = self._hash_levels.setdefault(h, {})
                    for lvl in levels:
                        blob = blobs[lvl]
                        sizes[lvl] = len(blob)
                        if lvl not in slot:
                            slot[lvl] = len(blob)
                            self._write_blob(h, lvl, blob)
                    self.n_encoded_chunks += 1
            with self._lock:
                self._refcount[h] = self._refcount.get(h, 0) + 1
            metas.append(
                ChunkMeta(
                    context_id=context_id,
                    chunk_idx=ci,
                    start=s,
                    end=e,
                    sizes=sizes,
                    text_bytes=(e - s) * bytes_per_token_text,
                    chunk_hash=h,
                )
            )
        self._meta[context_id] = metas
        return metas

    def _write_blob(self, h: str, lvl: int, blob: bytes) -> None:
        """Write-back admission: hot when it fits, else spill to cold."""
        if not self._admit_hot(h, lvl, blob):
            if not self.cold.contains(h, 0, lvl):
                self.cold.put(h, 0, lvl, blob)

    # -- hot-tier mechanics (call with self._lock held) ----------------------

    def _level_priority(self, lvl: int) -> float:
        return float(self.level_priorities.get(lvl, 0.0))

    def _pick_victim(self) -> Tuple[str, int]:
        """Lowest keep-priority first; oldest within a priority (the LRU
        iterates oldest -> newest, so the first minimum wins)."""
        best = None
        best_pri = None
        for key in self._hot_lru:
            pri = self._level_priority(key[1])
            if best is None or pri < best_pri:
                best, best_pri = key, pri
                if pri <= 0.0:
                    break
        assert best is not None
        return best

    def _evict_one(self) -> None:
        h, lvl = self._pick_victim()
        size = self._hot_lru.pop((h, lvl))
        self._hot_used -= size
        # a (hash, level) still in the index must stay readable: a context
        # references it now, or its store_kv is mid-flight and will
        # reference it momentarily (the refcount lands after the writes)
        referenced = lvl in self._hash_levels.get(h, {})
        if referenced and not self.cold.contains(h, 0, lvl):
            # demotion writes through: never drop the last replica of a
            # hash some context still references
            self.cold.put(h, 0, lvl, self.hot.get(h, 0, lvl))
            self.n_demotions += 1
        self.hot.delete(h, 0, lvl)
        self.n_evictions += 1

    def _admit_hot(self, h: str, lvl: int, blob: bytes) -> bool:
        key = (h, lvl)
        size = len(blob)
        if key in self._hot_lru:
            self._hot_lru.move_to_end(key)
            return True
        if size > self.hot_bytes:
            return False
        while self._hot_used + size > self.hot_bytes and self._hot_lru:
            self._evict_one()
        if self._hot_used + size > self.hot_bytes:
            return False
        self.hot.put(h, 0, lvl, blob)
        self._hot_lru[key] = size
        self._hot_used += size
        return True

    def evict_hot(self, n: int = 1) -> int:
        """Force-evict up to ``n`` LRU victims (demoting as needed); the
        number actually evicted.  Capacity pressure does this implicitly;
        this is the explicit hammer for tests and operational drains."""
        done = 0
        with self._lock:
            while done < n and self._hot_lru:
                self._evict_one()
                done += 1
        return done

    # -- read path -----------------------------------------------------------

    def _probation_pass(self, h: str, lvl: int) -> bool:
        """2Q admission gate for one cold read (lock held by the caller).

        True when the blob may be promoted hot: probation is off, or this
        is the key's second cold touch within the last ``probation`` cold
        reads.  A first touch records a ghost entry and answers False;
        ghosts untouched for a full window expire unpromoted.
        """
        if self.probation is None:
            return True
        self._cold_read_seq += 1
        seq = self._cold_read_seq
        while self._probation:  # expire ghosts that fell out of the window
            _, first_seq = next(iter(self._probation.items()))
            if seq - first_seq <= self.probation:
                break
            self._probation.popitem(last=False)
            self.n_probation_expired += 1
        key = (h, lvl)
        if key in self._probation:
            del self._probation[key]
            self.n_probation_promotes += 1
            return True
        self._probation[key] = seq
        self.n_probation_adds += 1
        return False

    def _read_blob(self, h: str, lvl: int, cid: str, ci: int) -> bytes:
        with self._lock:
            try:
                blob = self.hot.get(h, 0, lvl)
                self.n_hot_hits += 1
                self._hot_lru.move_to_end((h, lvl), last=True)
                from_cold = False
            except KeyError:
                try:
                    blob = self.cold.get(h, 0, lvl)
                except KeyError:
                    self.n_misses += 1
                    raise _missing(
                        cid, ci, lvl, f"hash {h} absent from hot and cold tiers"
                    ) from None
                self.n_cold_hits += 1
                from_cold = True
        try:
            kvcodec.verify_chunk(blob)
        except ValueError as e:  # IntegrityError is a ValueError
            raise type(e)(
                f"stored bitstream for context {cid!r} chunk {ci} level "
                f"{lvl} (hash {h}) failed integrity check: {e}"
            ) from e
        if from_cold and self.promote_on_read:
            # verify-before-promote: a rotten cold blob must never become
            # a hot replica that re-serves the corruption
            with self._lock:
                if self._probation_pass(h, lvl) and self._admit_hot(h, lvl, blob):
                    self.n_promotions += 1
        return blob

    def get_kv(self, context_id: str, chunk_idx: int, level: int) -> bytes:
        return self._read_blob(
            self.hash_for(context_id, chunk_idx), level, context_id, chunk_idx
        )

    def get_by_hash(self, chunk_hash: str, level: int) -> bytes:
        """Content-addressed read: the TCP protocol's hash-keyed path."""
        return self._read_blob(chunk_hash, level, f"<hash {chunk_hash}>", -1)

    # -- deletion ------------------------------------------------------------

    def _release_context(self, context_id: str) -> None:
        for m in self._meta.pop(context_id, []):
            h = m.chunk_hash
            if h is None:
                continue
            left = self._refcount.get(h, 0) - 1
            if left > 0:
                self._refcount[h] = left
                continue
            self._refcount.pop(h, None)
            for lvl in list(self._hash_levels.pop(h, {})):
                self._drop_blob(h, lvl)

    def _drop_blob(self, h: str, lvl: int) -> None:
        size = self._hot_lru.pop((h, lvl), None)
        if size is not None:
            self._hot_used -= size
        self._probation.pop((h, lvl), None)
        self.hot.delete(h, 0, lvl)
        self.cold.delete(h, 0, lvl)

    def delete_context(self, context_id: str) -> bool:
        """Drop one context's references; blobs whose refcount reaches zero
        are removed from both tiers.  True if the context existed."""
        with self._lock:
            if context_id not in self._meta:
                return False
            self._release_context(context_id)
            return True

    def delete_kv(self, context_id: str, chunk_idx: int, level: int) -> bool:
        """*Physically* remove the blob backing this context's (chunk,
        level) from both tiers, regardless of sharing.  The fault hammer:
        as in the flat store, metadata stays and every reader of the hash
        then sees the descriptive missing-``KeyError``."""
        with self._lock:
            h = self.try_hash(context_id, chunk_idx)
            if h is None:
                return False
            existed = self._hot_lru.get((h, level)) is not None or self.cold.contains(
                h, 0, level
            )
            self._drop_blob(h, level)
            self._hash_levels.get(h, {}).pop(level, None)
            return existed

    # -- tier accounting -----------------------------------------------------

    def tier_penalty(
        self, context_id: str, chunk_levels: Sequence[Tuple[int, int]]
    ) -> Tuple[float, int]:
        """(extra virtual seconds, cold-entry count) a run fetch pays for
        entries not currently hot: what ``SimTransport`` folds into the
        modeled fetch so the throughput estimator sees the slower read."""
        extra = 0.0
        n_cold = 0
        with self._lock:
            metas = self._meta.get(context_id)
            for ci, lvl in chunk_levels:
                if lvl < 0 or metas is None or not (0 <= ci < len(metas)):
                    continue
                h = metas[ci].chunk_hash
                if h is None or (h, lvl) in self._hot_lru:
                    continue
                n_cold += 1
                size = self._hash_levels.get(h, {}).get(lvl, 0)
                extra += self.cold_latency_s + size * 8.0 / (self.cold_gbps * 1e9)
        return extra, n_cold

    def unique_storage_bytes(self) -> int:
        """Bytes across unique (hash, level) blobs: what disk actually holds."""
        with self._lock:
            return sum(
                size
                for levels in self._hash_levels.values()
                for size in levels.values()
            )

    def logical_storage_bytes(self) -> int:
        """Sum of per-context storage (what a flat store would hold)."""
        with self._lock:
            return sum(
                sum(m.sizes.values()) for ms in self._meta.values() for m in ms
            )

    def refcount(self, chunk_hash: str) -> int:
        with self._lock:
            return self._refcount.get(chunk_hash, 0)

    def tier_counters(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hot_hits": self.n_hot_hits,
                "cold_hits": self.n_cold_hits,
                "misses": self.n_misses,
                "promotions": self.n_promotions,
                "demotions": self.n_demotions,
                "evictions": self.n_evictions,
                "dedup_chunks": self.n_dedup_chunks,
                "encoded_chunks": self.n_encoded_chunks,
                "hot_used_bytes": self._hot_used,
                "hot_capacity_bytes": self.hot_bytes,
                "unique_bytes": self.unique_storage_bytes(),
                "probation_adds": self.n_probation_adds,
                "probation_promotes": self.n_probation_promotes,
                "probation_expired": self.n_probation_expired,
                "probation_pending": len(self._probation),
            }
