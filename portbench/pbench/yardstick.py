"""The benchmark's yardstick, frozen here so that no change to the program
can move it: the H100's published peaks, the least time of a kernel call
from its shapes, the model FLOPs of a token, percentiles and spreads.

Peaks and the kernel-name rule are copies of ``repro_torch/kernels/
timing.py``; the K7 bound is a copy of ``chip_smoke.rans_bound`` (decode
branch); the FLOP count is the benchmark's own and not
``Engine.prefill_flops``.
"""
from __future__ import annotations

import bisect
import math
import re
import statistics
from typing import Iterable, List, Mapping, Sequence

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, 80 GB HBM3
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
# 32-bit integer instructions: 132 SMs x 64 INT32 lanes x 1.98 GHz, the rANS
# kernels' type
INT32_OPS = 16.7e12

# the first identifier followed by template arguments (without parentheses)
# and then its parameter list or the end: ``void (anonymous namespace)::
# quant_kernel<8>(float const*, ...)`` -> ``quant_kernel``
_NAME = re.compile(r"(\w+)(?:<[^()]*>)?(?:\(|$)")

K7_KERNELS = ("rans_decode_kernel", "rans_decode_wide_kernel")
K3_KERNELS = ("decode_split_kernel", "decode_combine_kernel", "decode_wide_kernel")


def kernel_name(key: str) -> str:
    """The function name of a profiler event's (demangled) kernel name."""
    m = _NAME.search(key)
    return m.group(1) if m else key


def bound_s(nbytes: float, ops: float, peak: float) -> float:
    """The least time of a call: max(bytes / HBM rate, ops / ``peak``)."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)


def k7_bound_s(n_lanes: int, n_sym: int, n_words: int, pairs: int = 0) -> float:
    """One K7 launch: ``n_lanes`` lanes of ``n_sym`` symbols each from
    ``n_words`` 16-bit payload words.  Bytes, each input read once and each
    output written once: the words, the int32 symbols written, each lane's
    word count, state, table index, 8-byte offset, final state and word
    pointer, and ``pairs`` distinct (table, symbol) entries (2-byte
    slot-to-symbol, 8-byte freq and cum).  The benchmark passes ``pairs = 0``
    (it does not read the decoded symbols back), so the bound is lower than
    the kernel's true least time, never higher.  About 12 int32 operations
    a symbol."""
    steps = n_lanes * n_sym
    nbytes = n_words * 2 + steps * 4 + n_lanes * (4 + 4 + 4 + 8 + 8) + pairs * (2 + 8 + 8)
    return bound_s(nbytes, 12 * steps, INT32_OPS)


def k3_bound_s(kv_lens: Sequence[int], n_heads: int, n_kv_heads: int, d_head: int, itemsize: int = 2) -> float:
    """One K3 call (split and merge launches together) over rows that attend
    to ``kv_lens`` cached positions: each row's K and V positions read once,
    its query read and its output written once, its length read; 4 FLOPs a
    query head, head channel and position (Q.K and P.V)."""
    kv = sum(int(n) for n in kv_lens)
    rows = len(kv_lens)
    nbytes = 2 * kv * n_kv_heads * d_head * itemsize + 2 * rows * n_heads * d_head * itemsize + 4 * rows
    return bound_s(nbytes, 4.0 * n_heads * d_head * kv, PEAK_BF16_FLOPS)


def padded_vocab(vocab_size: int) -> int:
    return -(-int(vocab_size) // 256) * 256


def token_flops(arch: Mapping, n_keys: int, head: bool) -> float:
    """Model FLOPs of one token through the decoder: 2 x the weights it
    multiplies (Q, K, V and output projections; the SwiGLU FFN, or the
    router, its top-k experts and the shared experts), attention over
    ``n_keys`` positions (its own included) in every layer, and with
    ``head`` the final projection onto the (padded) vocabulary."""
    d, hq, hkv, dh = arch["d_model"], arch["n_heads"], arch["n_kv_heads"], arch["d_head"]
    proj = d * (hq + 2 * hkv) * dh + hq * dh * d
    ff = arch["d_ff"]
    if arch.get("family") == "moe":
        ffn = 3 * d * ff * (arch["moe_topk"] + arch.get("n_shared_experts", 0)) + d * arch["n_experts"]
    else:
        ffn = 3 * d * ff
    per_layer = 2.0 * (proj + ffn) + 4.0 * hq * dh * n_keys
    total = arch["n_layers"] * per_layer
    if head:
        total += 2.0 * d * padded_vocab(arch["vocab_size"])
    return total


def question_flops(arch: Mapping, ctx_len: int, n_question: int) -> float:
    """A question of ``n_question`` tokens after ``ctx_len`` loaded
    positions; the logits of its last token only."""
    return sum(token_flops(arch, ctx_len + i + 1, head=(i == n_question - 1)) for i in range(n_question))


def percentile(values: Iterable[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``q``
    percent of the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[k - 1]


def spread(values: Sequence[float]) -> float:
    """(third quartile - first quartile) / median, the quartiles as
    ``statistics.quantiles(values, n=4)`` gives them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def merge_intervals(intervals: Iterable[Sequence[int]]) -> List[List[int]]:
    """The union of [start, end) intervals, sorted and disjoint."""
    out: List[List[int]] = []
    for a, b in sorted((int(a), int(b)) for a, b in intervals if b > a):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(merged: Sequence[Sequence[int]], a: int, b: int) -> int:
    """How much of [a, b) the disjoint sorted ``merged`` intervals cover.
    Their ends are sorted too, so the first that ends after ``a`` is found
    by bisection and only those that overlap are visited."""
    total = 0
    for j in range(bisect.bisect_right(merged, a, key=lambda iv: iv[1]), len(merged)):
        s, e = merged[j]
        if s >= b:
            break
        total += max(0, min(e, b) - max(s, a))
    return total


def gaps(merged: Sequence[Sequence[int]], a: int, b: int) -> List[List[int]]:
    """The parts of [a, b) that ``merged`` leaves uncovered."""
    out, t = [], a
    for s, e in merged:
        if e <= t:
            continue
        if s >= b:
            break
        if s > t:
            out.append([t, s])
        t = max(t, e)
    if t < b:
        out.append([t, b])
    return out
