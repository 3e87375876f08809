"""Wire format for encoded KV chunks.

A chunk payload is a msgpack map: a small header plus named binary arrays.
rANS streams are stored *packed* — only the valid words of every lane are
concatenated — because the padded per-lane buffers used during encoding are
not the wire representation.  The decoder reads the packed payload as it is
(``rans.decode_payload``); ``unpack_stream`` re-pads it into the padded
matrix the reference's vectorized decoder takes.

Integrity: every :func:`pack`-ed blob carries an 8-byte trailer —
a 4-byte magic plus the CRC32 of the msgpack payload — so a blob corrupted
in storage or in transit is *detected* (:class:`IntegrityError`, a
``ValueError`` the serving layer treats as a retryable fetch failure)
instead of crashing the rANS decoder or silently materializing garbage KV.
:func:`verify_checksum` is the O(blob) gate run at store read and again
before decode; :func:`unpack` verifies by default.  Blobs without the
trailer (foreign producers, pre-checksum writers) still parse — there is
simply nothing to verify — and any msgpack-level parse failure is reported
as an :class:`IntegrityError` too, since it is indistinguishable from
corruption that happened to hit the framing bytes.

Resumable segment layout.  A packed chunk additionally parses as
a sequence of self-delimiting *segments* — byte ranges of the canonical
blob, each with its own length + CRC32 sub-trailer carried out-of-band in a
:class:`SegmentIndex` (so the blob bytes themselves are unchanged and every
legacy whole-blob trailer still verifies):

  * ``head`` — the msgpack framing plus the chunk header (level-specific,
    but byte-synthesizable from the header fields alone via
    :func:`synthesize_head`);
  * ``anchor`` — the contiguous run of level-invariant arrays (``a.*`` and
    ``scales``; the lossy levels share these bytes exactly, which is what
    lets a fine-level anchor prefix compose with a coarser delta suffix);
  * ``delta`` runs — fixed-size slices of the remaining bytes (delta
    streams + the whole-blob trailer).

Any byte prefix of the blob then resolves — via
:meth:`SegmentIndex.verified_prefix` — into a set of complete, CRC-verified
segments plus a resume offset; a truncation mid-segment yields a shorter
verified prefix, and a corrupted complete segment raises
:class:`IntegrityError` (never silently short bytes).  The index is
computed by :func:`segment_index` on whoever holds the full blob (the
storage server / transport) and travels as fetch metadata.
"""
from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Dict, Tuple

import numpy as np

from repro_torch import tracing
from repro_torch.core._msgpack import IntegrityError, Reader, packb

__all__ = [
    "DELTA_RUN_BYTES",
    "IntegrityError",
    "Segment",
    "SegmentIndex",
    "has_checksum",
    "pack",
    "peek_header",
    "pack_stream",
    "stream_arrays",
    "segment_index",
    "synthesize_head",
    "unpack",
    "unpack_stream",
    "verify_checksum",
]

# trailer: 4-byte magic + CRC32 (big-endian) of the msgpack payload bytes
_CRC_MAGIC = b"KVC1"
_CRC_TAIL = struct.Struct(">I")
_TRAILER_LEN = len(_CRC_MAGIC) + _CRC_TAIL.size


def _arr_to_wire(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {"d": a.dtype.str, "s": list(a.shape), "b": a.tobytes()}


def _arr_from_wire(w: dict) -> np.ndarray:
    return np.frombuffer(w["b"], dtype=np.dtype(w["d"])).reshape(w["s"])


def pack(header: dict, arrays: Dict[str, np.ndarray]) -> bytes:
    payload = {
        "h": header,
        "a": {name: _arr_to_wire(np.asarray(a)) for name, a in arrays.items()},
    }
    body = packb(payload)
    return body + _CRC_MAGIC + _CRC_TAIL.pack(zlib.crc32(body) & 0xFFFFFFFF)


def has_checksum(blob: bytes) -> bool:
    """True if ``blob`` ends with this module's integrity trailer."""
    return len(blob) >= _TRAILER_LEN and blob[-_TRAILER_LEN:-_CRC_TAIL.size] == _CRC_MAGIC


def verify_checksum(blob: bytes) -> bool:
    """Check the integrity trailer without parsing the payload.

    Returns ``True`` when a trailer is present and the CRC matches, ``False``
    when no trailer is present (legacy / foreign blob: nothing to verify).
    Raises :class:`IntegrityError` on a mismatch.
    """
    if not has_checksum(blob):
        return False
    (expected,) = _CRC_TAIL.unpack(blob[-_CRC_TAIL.size:])
    tracing.count("crc_bytes", len(blob))
    with tracing.span("crc", bytes=len(blob)):
        actual = zlib.crc32(blob[:-_TRAILER_LEN]) & 0xFFFFFFFF
    if actual != expected:
        raise IntegrityError(
            f"chunk checksum mismatch: crc32 {actual:#010x} != stored "
            f"{expected:#010x} over {len(blob) - _TRAILER_LEN} payload bytes"
        )
    return True


def unpack(blob: bytes, *, verify: bool = True) -> Tuple[dict, Dict[str, np.ndarray]]:
    with tracing.span("codec.unpack", bytes=len(blob)):
        return _unpack(blob, verify)


def _unpack(blob: bytes, verify: bool) -> Tuple[dict, Dict[str, np.ndarray]]:
    if verify:
        verify_checksum(blob)
    body = blob[:-_TRAILER_LEN] if has_checksum(blob) else blob
    try:
        reader = Reader(body)
        payload = reader.read()
        if reader.tell() != len(body):
            raise ValueError(f"{len(body) - reader.tell()} bytes after the wire object")
        if not isinstance(payload, dict):
            raise ValueError(f"top-level wire object is {type(payload).__name__}, not a map")
        header = dict(payload["h"])
        arrays = {str(k): _arr_from_wire(v) for k, v in payload["a"].items()}
    except IntegrityError:
        raise
    except (KeyError, TypeError, ValueError, AttributeError) as e:
        # a trailer-less blob whose framing bytes were hit by corruption
        # fails here rather than at verify_checksum — same diagnosis
        raise IntegrityError(
            f"chunk payload is corrupt, truncated, or from a foreign producer: {e}"
        ) from e
    return header, arrays


def peek_header(blob: bytes) -> dict:
    """Read only the header map of a packed chunk, without materializing the
    array payload.

    :func:`pack` writes ``{"h": ..., "a": ...}`` in insertion order, so a
    sequential reader can stop right after the header object — O(header)
    parse instead of O(blob) (serving-layer validation runs this per fetched
    chunk).  Falls back to a full :func:`unpack` if the first key is not
    ``"h"`` (foreign producer).
    """
    reader = Reader(blob)
    try:
        reader.read_map_header()
        if reader.read() == "h":
            header = reader.read()
            if isinstance(header, dict):
                return header
    except IntegrityError:
        pass
    return unpack(blob)[0]


def pack_stream(
    words: np.ndarray, n_words: np.ndarray, state: np.ndarray, prefix: str
) -> Dict[str, np.ndarray]:
    """Compact a padded rANS buffer into wire arrays under ``prefix``."""
    words = np.asarray(words)
    n_words = np.asarray(n_words, dtype=np.int32)
    n_lanes, cap = words.shape
    mask = np.arange(cap)[None, :] < n_words[:, None]
    return stream_arrays(words[mask], n_words, state, prefix)


def stream_arrays(
    payload: np.ndarray, n_words: np.ndarray, state: np.ndarray, prefix: str
) -> Dict[str, np.ndarray]:
    """Wire arrays under ``prefix`` from a stream's valid words, already
    concatenated lane-major (what :func:`pack_stream` compacts)."""
    return {
        f"{prefix}.payload": np.asarray(payload).astype(np.uint16),
        f"{prefix}.n_words": np.asarray(n_words, dtype=np.int32),
        f"{prefix}.state": np.asarray(state, dtype=np.uint32),
    }


def unpack_stream(
    arrays: Dict[str, np.ndarray], prefix: str
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Inverse of :func:`pack_stream`: returns (padded_words, n_words, state)."""
    payload = arrays[f"{prefix}.payload"]
    n_words = arrays[f"{prefix}.n_words"].astype(np.int32)
    state = arrays[f"{prefix}.state"].astype(np.uint32)
    n_lanes = n_words.shape[0]
    cap = max(int(n_words.max()) if n_lanes else 0, 1)
    words = np.zeros((n_lanes, cap), dtype=np.uint16)
    mask = np.arange(cap)[None, :] < n_words[:, None]
    words[mask] = payload
    return words, n_words, state


def stream_wire_bytes(arrays: Dict[str, np.ndarray], prefix: str) -> int:
    return (
        arrays[f"{prefix}.payload"].nbytes
        + arrays[f"{prefix}.n_words"].nbytes
        + arrays[f"{prefix}.state"].nbytes
    )


# ---------------------------------------------------------------------------
# Resumable segment layout
# ---------------------------------------------------------------------------

# target size of one delta run segment: the resume/salvage granularity for
# the delta region.  Must agree between whoever computes an index and
# whoever requests an offset derived from it — clients always interpret the
# *received* index (absolute offsets), so a mismatch degrades resume
# granularity, never correctness.
DELTA_RUN_BYTES = 8192

# names whose wire bytes are identical across the lossy levels (anchors are
# symbolized and entropy-coded once per chunk; scales are shared with them)
_INVARIANT_PREFIXES = ("a.",)
_INVARIANT_NAMES = (b"scales",)


def _is_invariant(name: bytes) -> bool:
    return name in _INVARIANT_NAMES or any(
        name.startswith(p.encode()) for p in _INVARIANT_PREFIXES
    )


@dataclasses.dataclass(frozen=True)
class Segment:
    """One self-delimiting byte range of a packed chunk."""

    kind: str  # "head" | "anchor" | "delta"
    start: int
    end: int
    crc: int

    @property
    def length(self) -> int:
        return self.end - self.start


@dataclasses.dataclass(frozen=True)
class SegmentIndex:
    """Derived segment view of one canonical packed chunk.

    ``segments`` tile ``[0, total)`` in order: head, anchor (possibly
    zero-length for a foreign layout), then one or more delta runs — the
    last delta run includes the whole-blob integrity trailer.  ``n_arrays``
    is the array-map entry count (what :func:`synthesize_head` needs to
    rebuild a level's head bytes without the level's blob).
    """

    segments: Tuple[Segment, ...]
    total: int
    n_arrays: int

    @property
    def head(self) -> Segment:
        return self.segments[0]

    @property
    def anchor(self) -> Segment:
        return self.segments[1]

    @property
    def anchor_end(self) -> int:
        return self.segments[1].end

    def verified_prefix(self, data: bytes, offset: int = 0) -> int:
        """Largest segment boundary ``<= offset + len(data)`` such that every
        complete segment inside ``[offset, boundary)`` passes its CRC.

        ``data`` are blob bytes starting at absolute ``offset`` (0 for a
        whole-blob prefix, a resume offset for a suffix fetch).  A segment
        that is fully present but fails its CRC raises
        :class:`IntegrityError`; a segment cut short by the end of ``data``
        simply bounds the verified range — truncation is a resume point,
        corruption is an error.
        """
        end = offset + len(data)
        verified = offset
        for seg in self.segments:
            if seg.start < offset:
                continue  # not covered by this fetch
            if seg.start > verified:
                break  # gap: segments beyond the contiguous range
            if seg.end > end:
                break  # cut mid-segment: everything before it stands
            tracing.count("crc_bytes", seg.end - seg.start)
            actual = zlib.crc32(data[seg.start - offset : seg.end - offset]) & 0xFFFFFFFF
            if actual != seg.crc:
                raise IntegrityError(
                    f"segment [{seg.start}, {seg.end}) ({seg.kind}) failed its "
                    f"sub-trailer: crc32 {actual:#010x} != indexed {seg.crc:#010x}"
                )
            verified = seg.end
        return verified

    # -- wire form (travels as fetch metadata, not inside the blob) --------

    _KINDS = ("head", "anchor", "delta")

    def to_wire(self) -> dict:
        return {
            "v": 1,
            "total": self.total,
            "na": self.n_arrays,
            "segs": [
                [self._KINDS.index(s.kind), s.start, s.end, s.crc]
                for s in self.segments
            ],
        }

    @staticmethod
    def from_wire(w: dict) -> "SegmentIndex":
        try:
            segs = tuple(
                Segment(SegmentIndex._KINDS[int(k)], int(a), int(b), int(c))
                for k, a, b, c in w["segs"]
            )
            return SegmentIndex(
                segments=segs, total=int(w["total"]), n_arrays=int(w["na"])
            )
        except (KeyError, TypeError, ValueError, IndexError) as e:
            raise IntegrityError(f"malformed segment index: {e}") from e


def _entry_spans(blob: bytes):
    """Byte spans of the array-map entries of a canonical packed blob.

    Returns ``(entries, head_end, body_end)`` where ``entries`` is a list of
    ``(name, start, end)`` — the span of each ``name: wire-dict`` entry —
    and ``head_end`` is where the first entry begins (end of the msgpack
    framing + header).  Raises :class:`IntegrityError` for anything that is
    not this module's ``{"h": ..., "a": {...}}`` layout.
    """
    body = blob[:-_TRAILER_LEN] if has_checksum(blob) else blob
    reader = Reader(body)
    try:
        if reader.read_map_header() != 2:
            raise ValueError("top-level map is not {h, a}")
        if reader.read() != "h":
            raise ValueError("first key is not 'h'")
        reader.skip()  # header value
        if reader.read() != "a":
            raise ValueError("second key is not 'a'")
        n_arrays = reader.read_map_header()
        entries = []
        for _ in range(n_arrays):
            start = reader.tell()
            name = reader.read()
            reader.skip()  # the array wire dict
            entries.append(
                (name.encode() if isinstance(name, str) else str(name).encode(),
                 start, reader.tell())
            )
        body_end = reader.tell()
    except IntegrityError:
        raise
    except ValueError as e:
        raise IntegrityError(
            f"blob does not parse as a segmentable packed chunk: {e}"
        ) from e
    head_end = entries[0][1] if entries else body_end
    return entries, head_end, body_end


def segment_index(
    blob: bytes, *, delta_run_bytes: int = DELTA_RUN_BYTES
) -> SegmentIndex:
    """Compute the segment view of one canonical packed chunk.

    The anchor segment covers the *leading contiguous run* of
    level-invariant entries (``a.*`` / ``scales``); everything after it —
    the delta streams plus the whole-blob trailer — is sliced into
    near-equal delta runs of about ``delta_run_bytes`` each.  Pure function
    of the blob bytes: every holder of the blob derives the same index.
    """
    try:
        entries, head_end, _body_end = _entry_spans(blob)
        anchor_end = head_end
        for name, _start, end in entries:
            if _is_invariant(name):
                anchor_end = end
            else:
                break
        n_arrays = len(entries)
    except IntegrityError:
        # foreign layout: no compose, but delta-run slicing still gives
        # byte-range resume with per-run verification
        head_end = anchor_end = 0
        n_arrays = 0
    total = len(blob)

    def crc(a: int, b: int) -> int:
        tracing.count("crc_bytes", b - a)
        return zlib.crc32(blob[a:b]) & 0xFFFFFFFF

    segs = [
        Segment("head", 0, head_end, crc(0, head_end)),
        Segment("anchor", head_end, anchor_end, crc(head_end, anchor_end)),
    ]
    region = total - anchor_end
    n_runs = max(1, -(-region // max(int(delta_run_bytes), 1)))
    for k in range(n_runs):
        a = anchor_end + (region * k) // n_runs
        b = anchor_end + (region * (k + 1)) // n_runs
        segs.append(Segment("delta", a, b, crc(a, b)))
    return SegmentIndex(segments=tuple(segs), total=total, n_arrays=n_arrays)


def _mp_map_header(n: int) -> bytes:
    if n < 16:
        return bytes([0x80 | n])
    if n < 1 << 16:
        return b"\xde" + struct.pack(">H", n)
    return b"\xdf" + struct.pack(">I", n)


def synthesize_head(header: dict, n_arrays: int) -> bytes:
    """Rebuild a packed chunk's head segment from its header fields alone.

    Byte-identical to ``blob[:head_end]`` of :func:`pack` output for the
    same header (msgpack encoding is deterministic given key order) — the
    degrade-compose path uses this to stand in the *coarser* level's head
    in front of a salvaged fine-level anchor segment without ever fetching
    the coarse head bytes.
    """
    return (
        _mp_map_header(2)
        + packb("h")
        + packb(header)
        + packb("a")
        + _mp_map_header(int(n_arrays))
    )
