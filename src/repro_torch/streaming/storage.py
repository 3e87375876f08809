"""KV bitstream store: every level of every chunk of a context, encoded once.

``store_kv`` splits a context's KV along the token axis into chunks (default
1.5K tokens, paper §5.3), pre-encodes every chunk at every level via the
codec (``codec.encode_all_levels``, whose lossy delta symbols come from the
kernel K5), and records per-(chunk, level) sizes in :class:`ChunkMeta`;
``get_kv`` returns the checksum-verified bitstream for a (chunk, level) and
``decode`` rebuilds it (``codec.decode_chunk``, kernel K6) as a tensor on
the codec tables' device.

Blob I/O goes through a :class:`StorageBackend`: :class:`MemoryBackend` (a
dict, the default) or :class:`DirectoryBackend` (one file per entry).

Chain hashes (the content-addressed key of a chunk) follow the vLLM
prefix-caching idiom, so identical document prefixes key to the same
blobs:

    root  = sha256(b"cachegen-" + VERSION + b"\\0" + namespace)
    h_i   = sha256(h_{i-1} || payload_i)          (raw 32-byte digests)
    key_i = VERSION + "-" + hex(h_i)[:40]

where ``payload_i`` is the chunk's token ids as little-endian ``uint32``
bytes (:func:`token_payloads`).  The ``VERSION`` prefix ("kvh1") makes any
future layout change detectable at the key level.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
from typing import Dict, Iterable, List, Optional, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch.core import codec as kvcodec

__all__ = [
    "ChunkMeta",
    "DirectoryBackend",
    "HASH_CHAIN_VERSION",
    "KVStore",
    "MemoryBackend",
    "StorageBackend",
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
    context/chunk/level (not a bare tuple or an opaque file path).
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

    The *flat* store: context-keyed, no sharing, no eviction.  The frontend
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
                self.backend.put(context_id, ci, lvl, blob)
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

    # -- read path (online) --------------------------------------------------

    def get_kv(self, context_id: str, chunk_idx: int, level: int) -> bytes:
        """Blob for one (chunk, level); raises a descriptive ``KeyError``
        naming context/chunk/level when missing (either backend), and a
        ``bitstream.IntegrityError`` naming the same when the blob's
        checksum trailer does not match — corruption at rest is caught at
        the store boundary, before any bytes cross a link."""
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
