"""Timing the port's kernels on the card.

``time_ms`` is the CUDA-event mean over back-to-back calls; ``device_ms`` is
the named kernels' own time from ``torch.profiler``'s CUDA trace, matched by
each kernel's exact function name (``kernel_name``), so that a kernel whose
name holds another's (``quant_kernel`` in ``dequant_kernel``) is never
counted for it.  ``bound_ms`` is the least time the card could take.
"""
from __future__ import annotations

import re
import sys
from typing import Callable, Optional, Tuple

import torch

__all__ = ["HBM_BYTES_PER_S", "INT32_OPS", "PEAK_FLOPS", "bound_ms", "device_ms", "kernel_name", "time_ms"]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = 989e12  # H100 SXM dense bf16
# H100 SXM 32-bit integer instructions: 132 SMs x 64 INT32 lanes x 1.98 GHz
# (half the lanes of its 67 TFLOP/s float32 rate); the rANS kernels' type
INT32_OPS = 16.7e12

# the first identifier followed by template arguments (without parentheses)
# and then its parameter list or the end: ``void (anonymous namespace)::
# quant_kernel<8>(float const*, ...)`` -> ``quant_kernel``
_NAME = re.compile(r"(\w+)(?:<[^()]*>)?(?:\(|$)")


def kernel_name(key: str) -> str:
    """The function name of a profiler event's (demangled) kernel name."""
    m = _NAME.search(key)
    return m.group(1) if m else key


def time_ms(fn: Callable[[], object], iters: int = 10, warmup: int = 2) -> float:
    """Mean wall time per call on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn: Callable[[], object], *kernel_names: str, iters: int = 5,
              attempts: int = 6) -> Optional[float]:
    """Device time per call of ``fn``, whose kernels named exactly
    ``kernel_names`` each launch once a call: the sum of their mean times
    per launch in the profiler's CUDA trace of ``iters`` calls (a mean per
    recorded launch, so a trace that drops launches does not shrink it).
    CUPTI now and then hands back a trace without a call's kernels, and
    then sometimes several in a row, so a trace that holds none of them is
    taken again, up to ``attempts`` traces in all, every other one with the
    CPU activity as well; each such trace is reported on stderr with the
    kernels it did hold.  None if no trace holds them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if attempt % 2 else [])
        with profile(activities=activities) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.count and e.device_time_total]
        us = sum(e.device_time_total / e.count for e in events if kernel_name(e.key) in kernel_names)
        if us:
            return us / 1e3
        held = sorted({kernel_name(e.key) for e in events})
        print(f"device_ms: trace {attempt + 1} of {attempts} holds none of {list(kernel_names)}; "
              f"its device events: {held[:8]}{' ...' if len(held) > 8 else ''}", file=sys.stderr, flush=True)
    return None


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_FLOPS) -> Tuple[float, str]:
    """max(bytes / memory rate, operations / peak rate) in ms, and which one;
    ``peak`` is the rate of the operations' type (bf16 by default)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
