"""Lane-parallel static-table rANS entropy coder, as a PyTorch program.

Every *lane* carries its own 32-bit coder state and its own static symbol
distribution; lanes map to (layer, K/V, channel) streams (paper Insight 3:
per-channel-per-layer distributions).  The reference runs the coder as a
vectorized ``lax.scan``; here it is a Python loop with one step per symbol,
each step a handful of elementwise tensor ops over all lanes, on the
tensors' device.  A CUDA kernel with one thread per lane (the GPU coder
design the paper describes) is future work; the loop launches about a dozen
ops per symbol step.

Variant: 32-bit state, 16-bit word renormalization (ryg_rans "rans_word").
With precision ``k <= 14`` and all frequencies >= 1 (< 2^k), each symbol
emits/consumes at most one 16-bit word, so every step does fixed work.

PyTorch has no ``+``/``-`` on ``uint16`` and no shifts on ``uint32``, so the
coder state is held in ``int64`` and symbols and words in ``int32``/``int64``.
The state stays below 2^32 throughout (``x < 2^32`` before the encoder's
``(q << k) + r + c``, ``f * (x >> k) < 2^32`` in the decoder), so nothing
wraps; ``uint16`` appears only at the wire (``bitstream.pack_stream``).

Wire format per call: ``words (n_lanes, n_sym)`` of which the first
``n_words[lane]`` entries are valid, plus the final state per lane.  The
decoder reads words in reverse emission order (rANS is LIFO).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["CoderTables", "encode", "decode", "stack_tables"]

RANS_L = 1 << 16  # lower bound of the normalized state interval


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


def _int64(a, device) -> torch.Tensor:
    """Host arrays (the wire's unsigned types included) or tensors -> int64 on
    ``device``."""
    if isinstance(a, np.ndarray):
        a = a.astype(np.int64)
    return torch.as_tensor(a, device=device).to(torch.int64)


def encode(
    symbols, table_idx, tables: CoderTables
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Encode ``symbols[(lane, t)]`` -> (words, n_words, final_state).

    ``words`` is (n_lanes, n_sym) int32 holding 16-bit values, ``n_words``
    (n_lanes,) int32, ``final_state`` (n_lanes,) int64 below 2^32.  The
    unused tail of ``words`` holds exactly what the reference's buffer
    holds, so the two are identical element for element.
    """
    dev = tables.device
    symbols = _int64(symbols, dev)
    if symbols.ndim != 2:
        raise ValueError(f"symbols must be (n_lanes, n_sym), got {tuple(symbols.shape)}")
    n_lanes, n_sym = symbols.shape
    A = tables.alphabet
    k = tables.precision
    freqs_flat = tables.freqs.reshape(-1)
    cums_flat = tables.cums.reshape(-1)
    t_idx = _int64(table_idx, dev)
    t_base_f = t_idx * A
    t_base_c = t_idx * (A + 1)
    # rANS encodes in reverse symbol order so the decoder runs forward.
    xs = torch.flip(symbols.T, dims=(0,)).contiguous()  # (n_sym, n_lanes)
    x_bound = (RANS_L >> k) << 16

    x = torch.full((n_lanes,), RANS_L, dtype=torch.int64, device=dev)
    ptr = torch.zeros((n_lanes, 1), dtype=torch.int64, device=dev)
    buf = torch.zeros((n_lanes, max(n_sym, 1)), dtype=torch.int32, device=dev)
    for i in range(n_sym):
        s = xs[i]
        f = freqs_flat[t_base_f + s]
        c = cums_flat[t_base_c + s]
        # renormalize: emit one 16-bit word if x would overflow; the word is
        # written at ptr either way (the reference's buffer does the same)
        emit = x >= x_bound * f
        buf.scatter_(1, ptr, (x & 0xFFFF).to(torch.int32)[:, None])
        ptr += emit[:, None]
        x = torch.where(emit, x >> 16, x)
        # C(s, x) = (x // f) << k + (x % f) + c
        q = torch.div(x, f, rounding_mode="floor")
        x = (q << k) + (x - q * f) + c
    return buf[:, :n_sym], ptr[:, 0].to(torch.int32), x


def decode(
    words,
    n_words,
    state,
    table_idx,
    tables: CoderTables,
    n_sym: int,
    check: bool = False,
) -> torch.Tensor:
    """Decode ``n_sym`` symbols per lane -> (n_lanes, n_sym) int32.  Exact
    inverse of :func:`encode`.  Inputs may be numpy arrays (the wire's
    ``uint16``/``uint32``) or tensors; they are moved to the tables' device."""
    dev = tables.device
    words = _int64(words, dev)
    n_lanes = words.shape[0]
    x = _int64(state, dev)
    ptr = _int64(n_words, dev) - 1
    A = tables.alphabet
    k = tables.precision
    M = 1 << k
    freqs_flat = tables.freqs.reshape(-1)
    cums_flat = tables.cums.reshape(-1)
    s2s_flat = tables.slot2sym.reshape(-1)
    t_idx = _int64(table_idx, dev)
    t_base_f = t_idx * A
    t_base_c = t_idx * (A + 1)
    t_base_m = t_idx * M
    words = words if words.shape[1] else words.new_zeros((n_lanes, 1))

    out = torch.empty((n_sym, n_lanes), dtype=torch.int32, device=dev)
    for i in range(n_sym):
        slot = x & (M - 1)
        s = s2s_flat[t_base_m + slot].to(torch.int64)
        f = freqs_flat[t_base_f + s]
        c = cums_flat[t_base_c + s]
        x = f * (x >> k) + slot - c
        need = x < RANS_L
        word = torch.gather(words, 1, ptr.clamp_min(0)[:, None])[:, 0]
        x = torch.where(need, (x << 16) | word, x)
        ptr -= need.to(torch.int64)
        out[i] = s.to(torch.int32)
    if check and (not bool((x == RANS_L).all()) or not bool((ptr == -1).all())):
        raise ValueError("rANS stream corrupt: decoder did not return to initial state")
    return out.T  # symbols (n_lanes, n_sym) in forward order


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
