"""Exact integer arithmetic coder (Witten–Neal–Cleary), a pure-Python oracle.

The ground-truth entropy coder that the paper's design names (§5.2
"arithmetic coding"), used only to size the codec's output: the production
coder is the lane-parallel rANS of :mod:`repro_torch.core.rans`, held
within a few percent of this oracle's compressed size.  Its bytes equal the
reference's ``repro.core.ac_ref`` output byte for byte.

Static model: a frequency table ``freqs`` (all >= 1) summing to ``total``.
32-bit registers, carry handling by pending-bit counting.
"""
from __future__ import annotations

import itertools
from typing import List, Sequence

__all__ = ["ac_encode", "ac_decode", "ac_encoded_bits"]

_CODE_BITS = 32
_TOP = (1 << _CODE_BITS) - 1
_HALF = 1 << (_CODE_BITS - 1)
_QUARTER = 1 << (_CODE_BITS - 2)
_THREE_Q = _HALF + _QUARTER


class _BitWriter:
    def __init__(self) -> None:
        self.bits: List[int] = []
        self.pending = 0

    def write(self, bit: int) -> None:
        self.bits.append(bit)
        self.bits.extend([1 - bit] * self.pending)
        self.pending = 0

    def to_bytes(self) -> bytes:
        bits = self.bits + [0] * (-len(self.bits) % 8)
        out = bytearray()
        for i in range(0, len(bits), 8):
            byte = 0
            for b in bits[i:i + 8]:
                byte = (byte << 1) | b
            out.append(byte)
        return bytes(out)


class _BitReader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def read(self) -> int:
        byte_i, bit_i = divmod(self.pos, 8)
        self.pos += 1
        if byte_i >= len(self.data):
            return 0
        return (self.data[byte_i] >> (7 - bit_i)) & 1


def _cums(freqs: Sequence[int]) -> List[int]:
    return [0] + list(itertools.accumulate(int(f) for f in freqs))


def ac_encode(symbols: Sequence[int], freqs: Sequence[int]) -> bytes:
    cums = _cums(freqs)
    total = cums[-1]
    low, high = 0, _TOP
    w = _BitWriter()
    for s in symbols:
        s = int(s)
        span = high - low + 1
        high = low + span * cums[s + 1] // total - 1
        low = low + span * cums[s] // total
        while True:
            if high < _HALF:
                w.write(0)
            elif low >= _HALF:
                w.write(1)
                low -= _HALF
                high -= _HALF
            elif low >= _QUARTER and high < _THREE_Q:
                w.pending += 1
                low -= _QUARTER
                high -= _QUARTER
            else:
                break
            low = low * 2
            high = high * 2 + 1
    # flush
    w.pending += 1
    w.write(0 if low < _QUARTER else 1)
    return w.to_bytes()


def ac_decode(data: bytes, n_sym: int, freqs: Sequence[int]) -> List[int]:
    cums = _cums(freqs)
    total = cums[-1]
    r = _BitReader(data)
    value = 0
    for _ in range(_CODE_BITS):
        value = (value << 1) | r.read()
    low, high = 0, _TOP
    out: List[int] = []
    for _ in range(n_sym):
        span = high - low + 1
        scaled = ((value - low + 1) * total - 1) // span
        # binary search for the symbol with cums[s] <= scaled < cums[s + 1]
        lo, hi = 0, len(cums) - 2
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if cums[mid] <= scaled:
                lo = mid
            else:
                hi = mid - 1
        s = lo
        out.append(s)
        high = low + span * cums[s + 1] // total - 1
        low = low + span * cums[s] // total
        while True:
            if high < _HALF:
                pass
            elif low >= _HALF:
                value -= _HALF
                low -= _HALF
                high -= _HALF
            elif low >= _QUARTER and high < _THREE_Q:
                value -= _QUARTER
                low -= _QUARTER
                high -= _QUARTER
            else:
                break
            low = low * 2
            high = high * 2 + 1
            value = (value << 1) | r.read()
    return out


def ac_encoded_bits(symbols: Sequence[int], freqs: Sequence[int]) -> int:
    return len(ac_encode(symbols, freqs)) * 8
