"""Lane-parallel static-table rANS entropy coder, as a PyTorch program.

Every *lane* carries its own 32-bit coder state and its own static symbol
distribution; lanes map to (layer, K/V, channel) streams (paper Insight 3:
per-channel-per-layer distributions).  The reference runs the coder as a
vectorized ``lax.scan`` a direction.  Here :func:`encode` and
:func:`decode_payload` run it on the tables' device through ``kernels.ops``:
with the tables on a CUDA card, the hand-written kernels K8
(``rans_encode``) and K7 (``rans_decode``) of ``kernels/csrc/rans.cu`` run,
one thread a lane with its table's cum row in shared memory (the GPU coder
design the paper describes); with the tables on the CPU, their plain
versions do (``kernels.rans``: a Python loop with one step per symbol, each
step a handful of elementwise tensor ops over all lanes).
There is no switch and no fallback: the device decides.

Variant: 32-bit state, 16-bit word renormalization (ryg_rans "rans_word").
With precision ``k <= 14`` and all frequencies >= 1 (< 2^k), each symbol
emits/consumes at most one 16-bit word, so every step does fixed work.

The wire's words and states travel to the device at their own width: the
``uint16`` words as ``int16`` bits and the ``uint32`` states as ``int32``
bits (views on the host, no widening before the copy), which both routes
read as unsigned.  The plain versions hold the state in ``int64`` (PyTorch
has no ``+``/``-`` on ``uint16`` and no shifts on ``uint32``); it stays below
2^32 throughout (``x < 2^32`` before the encoder's ``(q << k) + r + c``,
``f * (x >> k) < 2^32`` in the decoder), so nothing wraps.

Wire format per call: the encoder returns ``words (n_lanes, n_sym)`` of
which the first ``n_words[lane]`` entries are valid, plus the final state
per lane; the wire keeps only the valid words, concatenated lane-major (the
payload), and :func:`decode_payload` reads that payload as it is.  The
decoder reads words in reverse emission order (rANS is LIFO).
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.rans import RANS_L

__all__ = ["CoderTables", "encode", "decode", "decode_payload", "encoded_bytes", "stack_tables", "wire_bits"]


class CoderTables(NamedTuple):
    """Static rANS tables for ``n_tables`` distributions over alphabet A.

    freqs: (n_tables, A) int64, each row sums to 2**precision, all >= 1
    cums:  (n_tables, A + 1) int64 exclusive prefix sums
    slot2sym: (n_tables, 2**precision) int16
    precision: int
    """

    freqs: torch.Tensor
    cums: torch.Tensor
    slot2sym: torch.Tensor
    precision: int

    @property
    def alphabet(self) -> int:
        return self.freqs.shape[-1]

    @property
    def n_tables(self) -> int:
        return self.freqs.shape[0]

    @property
    def device(self) -> torch.device:
        return self.freqs.device


def _int32(a, device) -> torch.Tensor:
    """Host arrays or tensors -> int32 on ``device`` (numpy converted on the
    host, before the copy)."""
    if isinstance(a, np.ndarray):
        a = np.array(a, dtype=np.int32)  # a copy: the lane vectors are small
    return torch.as_tensor(a, device=device).to(torch.int32).contiguous()


def wire_bits(a, width: int, device) -> torch.Tensor:
    """Unsigned ``width``-bit values (the wire's ``uint16`` words or
    ``uint32`` states, or wider integers holding them) -> their bits as
    int16/int32 on ``device``, converted on the host before the copy."""
    unsigned, np_signed, signed = {16: (np.uint16, np.int16, torch.int16),
                                   32: (np.uint32, np.int32, torch.int32)}[width]
    if isinstance(a, np.ndarray):
        a = np.ascontiguousarray(a).astype(unsigned, copy=False).view(np_signed)
        if a.flags.writeable or torch.device(device).type == "cpu":
            return torch.from_numpy(a if a.flags.writeable else a.copy()).to(device)
        with warnings.catch_warnings():  # a read-only view of the wire, only copied to the card
            warnings.simplefilter("ignore", UserWarning)
            return torch.from_numpy(a).to(device)
    a = torch.as_tensor(a)
    if a.element_size() * 8 != width:  # wider integers: their low bits
        a = a.to(torch.int64) & ((1 << width) - 1)
        a = torch.where(a >= 1 << (width - 1), a - (1 << width), a).to(signed)
    return a.view(signed).to(device).contiguous()


def encode(
    symbols, table_idx, tables: CoderTables
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Encode ``symbols[(lane, t)]`` -> (words, n_words, final_state).

    ``words`` is (n_lanes, n_sym) int32 holding 16-bit values, ``n_words``
    (n_lanes,) int32, ``final_state`` (n_lanes,) int64 below 2^32.  The
    unused tail of ``words`` holds exactly what the reference's buffer
    holds, so the two are identical element for element.  K8 on a card,
    its plain version on the CPU (``kernels.ops.rans_encode``).
    """
    dev = tables.device
    symbols = _int32(symbols, dev)
    if symbols.ndim != 2:
        raise ValueError(f"symbols must be (n_lanes, n_sym), got {tuple(symbols.shape)}")
    return ops.rans_encode(symbols, _int32(table_idx, dev), tables)


def decode_payload(
    payload,
    n_words,
    state,
    table_idx,
    tables: CoderTables,
    n_sym: int,
    check: bool = False,
) -> torch.Tensor:
    """Decode ``n_sym`` symbols per lane from the wire's compact stream ->
    (n_lanes, n_sym) int32.  Exact inverse of :func:`encode`.  ``payload``
    holds all lanes' valid words, lane-major (the wire's ``<prefix>.payload``,
    or several streams' payloads joined), ``n_words`` and ``state`` the
    lanes' word counts and final states.  Inputs may be numpy arrays (the
    wire's ``uint16``/``uint32``) or tensors; they are moved to the tables'
    device at their own width, where each lane's offset into ``payload`` is
    made (the exclusive cumsum of ``n_words``).  K7 on a card, its plain
    version on the CPU (``kernels.ops.rans_decode``).  A payload shorter
    than the lanes' words raises, whatever the inputs' kind and device.
    ``check`` raises unless every lane ends at the encoder's initial state
    with all its words consumed."""
    dev = tables.device
    counts = n_words.clip(0) if isinstance(n_words, np.ndarray) else torch.as_tensor(n_words).clamp_min(0)
    total, n_payload = int(counts.sum()), int(np.prod(payload.shape))
    if n_payload < total:
        raise ValueError(f"rANS stream corrupt: {total} words claimed, the payload holds {n_payload}")
    n_words = _int32(n_words, dev)
    held = n_words.clamp_min(0).to(torch.int64)
    syms, x, ptr = ops.rans_decode(
        wire_bits(payload, 16, dev).reshape(-1), n_words, torch.cumsum(held, 0) - held,
        wire_bits(state, 32, dev), _int32(table_idx, dev), tables, n_sym,
    )
    if check and (not bool((x == RANS_L).all()) or not bool((ptr == -1).all())):
        raise ValueError("rANS stream corrupt: decoder did not return to initial state")
    return syms  # (n_lanes, n_sym) in forward order


def decode(
    words,
    n_words,
    state,
    table_idx,
    tables: CoderTables,
    n_sym: int,
    check: bool = False,
) -> torch.Tensor:
    """Decode ``n_sym`` symbols per lane from a padded word matrix ``words
    (n_lanes, cap)`` (``bitstream.unpack_stream``'s form) -> (n_lanes, n_sym)
    int32.  Exact inverse of :func:`encode`.  The matrix is compacted on the
    tables' device (each lane's first ``n_words`` words, lane-major) and
    decoded by :func:`decode_payload`.  A lane that claims more words than
    ``words`` has columns raises, whatever the inputs' kind and device."""
    dev = tables.device
    if len(n_words) and int(n_words.max()) > words.shape[1]:
        raise ValueError(f"rANS stream corrupt: {int(n_words.max())} words in a lane of {words.shape[1]}")
    words = wire_bits(words, 16, dev)
    n_words = _int32(n_words, dev)
    payload = words[torch.arange(words.shape[1], device=dev)[None, :] < n_words[:, None]]
    return decode_payload(payload, n_words, state, table_idx, tables, n_sym, check=check)


def encoded_bytes(n_words) -> int:
    """Wire size: valid 16-bit words + 4-byte final state per lane."""
    n_words = torch.as_tensor(n_words)
    return int(n_words.sum()) * 2 + 4 * int(n_words.shape[0])


def stack_tables(
    tabs: Sequence[CoderTables],
    pad_alphabet: bool = False,
) -> CoderTables:
    """Concatenate several table sets into one along the table axis.

    This is what makes *batched* multi-stream (de)coding possible: streams
    that use different table sets (e.g. different lossy levels, or lossless
    vs lossy anchors) are stacked along the lane axis into one ``encode`` /
    ``decode`` call, with each lane's ``table_idx`` offset by the cumulative
    table count of the sets before it.  Requires identical precision; by
    default also identical alphabets.

    ``pad_alphabet=True`` additionally merges sets with *different*
    alphabets by zero-padding each ``freqs`` row (and edge-padding ``cums``)
    to the widest alphabet.  This is sound for **decoding only**: the
    decoder reads ``freqs[s]``/``cums[s]`` exclusively for symbols ``s``
    produced by ``slot2sym`` (always < the set's true alphabet), so the
    padding is never touched.  Padded tables must not be used to encode —
    a padded symbol id would emit a zero-frequency state transition.
    """
    if not tabs:
        raise ValueError("need at least one CoderTables to stack")
    precision = tabs[0].precision
    A = max(t.alphabet for t in tabs)
    for t in tabs:
        if t.precision != precision:
            raise ValueError(
                f"stack_tables requires identical precision, got "
                f"{[t.precision for t in tabs]}"
            )
        if t.alphabet != A and not pad_alphabet:
            raise ValueError(
                "stack_tables requires identical alphabets (or "
                f"pad_alphabet=True), got {[t.alphabet for t in tabs]}"
            )
    if len(tabs) == 1:
        return tabs[0]

    def _padded(t: CoderTables):
        if t.alphabet == A:
            return t.freqs, t.cums
        pad = A - t.alphabet
        freqs = F.pad(t.freqs, (0, pad))
        cums = torch.cat([t.cums, t.cums[:, -1:].expand(-1, pad)], dim=1)
        return freqs, cums

    parts = [_padded(t) for t in tabs]
    return CoderTables(
        freqs=torch.cat([f for f, _ in parts], dim=0),
        cums=torch.cat([c for _, c in parts], dim=0),
        slot2sym=torch.cat([t.slot2sym for t in tabs], dim=0),
        precision=precision,
    )
