"""What the metric readers under ``portbench/metrics/`` share: each takes
the run's record (``cell.RunRecord``) and returns a number, or None where
there is nothing to read (no device trace, no such call in the window)."""
from __future__ import annotations

import sys
from typing import List, Optional, Tuple

from pbench import yardstick


def token_gaps_ms(record) -> List[float]:
    """Every gap between two consecutive tokens of a request."""
    out = []
    for w in record.waves:
        times = [w.t_first] + w.t_steps
        gaps = [(b - a) / 1e6 for a, b in zip(times, times[1:])]
        out.extend(gaps * len(w.requests))
    return out


def ctx_tokens(record) -> int:
    return sum(n for w in record.waves for n, ok in zip(w.ctx_lens, w.ok) if ok)


def output_tokens(record) -> int:
    return sum(len(w.requests) * w.n_answer for w in record.waves)


def span_ms(record, label: str) -> Optional[float]:
    spans = record.spans.of(label)
    return sum(b - a for a, b in spans) / len(spans) / 1e6 if spans else None


def model_flops(record) -> float:
    """Model FLOPs of the window's questions and decode steps."""
    arch, t = record.arch, record.traffic
    total = 0.0
    for w in record.waves:
        for T in w.ctx_lens:
            total += yardstick.question_flops(arch, T, t.question_tokens)
            for s in range(len(w.t_steps)):
                total += yardstick.token_flops(arch, T + t.question_tokens + s + 1, head=True)
    return total


def mfu_pct(record) -> float:
    return 100.0 * model_flops(record) / (record.window_s * yardstick.PEAK_BF16_FLOPS)


def _merged(record):
    return yardstick.merge_intervals((s, e) for _, s, e in record.device)


def idle_pct(record) -> Optional[float]:
    if not record.device:
        return None
    a, b = record.window
    return 100.0 * (1.0 - yardstick.covered(_merged(record), a, b) / (b - a))


def step_device_ms(record) -> Optional[float]:
    """Device time (any operation) inside the step spans, a step."""
    steps = record.spans.of("step")
    if not record.device or not steps:
        return None
    merged = _merged(record)
    return sum(yardstick.covered(merged, a, b) for a, b in steps) / len(steps) / 1e6


def kernel_time_s(record, names) -> Tuple[float, int]:
    ev = [(e - s) for n, s, e in (record.device or []) if yardstick.kernel_name(n) in names]
    return sum(ev) / 1e9, len(ev)


def k7_roofline_pct(record) -> Optional[float]:
    t, n = kernel_time_s(record, yardstick.K7_KERNELS)
    if not n or not record.k7_calls:
        return None
    bound = sum(yardstick.k7_bound_s(*c) for c in record.k7_calls)
    if n != len(record.k7_calls):
        # a trace that dropped launches: mean bound a call over mean time a launch
        print(f"k7_roofline: {n} K7 launches traced of {len(record.k7_calls)} calls", file=sys.stderr)
        return 100.0 * (bound / len(record.k7_calls)) / (t / n)
    return 100.0 * bound / t


def k3_roofline_pct(record) -> Optional[float]:
    """K3's calls: one a layer a decode step, each row attending to its
    context, question and the tokens before."""
    t, n = kernel_time_s(record, yardstick.K3_KERNELS)
    if not n:
        return None
    a, tr = record.arch, record.traffic
    bound = 0.0
    for w in record.waves:
        for s in range(len(w.t_steps)):
            lens = [T + tr.question_tokens + s + 1 for T in w.ctx_lens]
            bound += a["n_layers"] * yardstick.k3_bound_s(lens, a["n_heads"], a["n_kv_heads"], a["d_head"])
    return 100.0 * bound / t if bound else None
