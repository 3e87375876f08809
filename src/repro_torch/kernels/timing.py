"""Timing the port's kernels on the card.

``time_ms`` is the CUDA-event mean over back-to-back calls; ``device_ms`` is
the named kernels' own time from ``torch.profiler``'s CUDA trace, matched by
each kernel's exact function name (``kernel_name``), so that a kernel whose
name holds another's (``quant_kernel`` in ``dequant_kernel``) is never
counted for it.  ``bound_ms`` is the least time the card could take.
"""
from __future__ import annotations

import re
from typing import Callable, Optional, Tuple

import torch

__all__ = ["HBM_BYTES_PER_S", "PEAK_FLOPS", "bound_ms", "device_ms", "kernel_name", "time_ms"]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = 989e12  # H100 SXM dense bf16

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


def device_ms(fn: Callable[[], object], *kernel_names: str, iters: int = 5) -> Optional[float]:
    """Device time per call of ``fn``, whose kernels named exactly
    ``kernel_names`` each launch once a call: the sum of their mean times
    per launch in the profiler's CUDA trace of ``iters`` calls (a mean per
    recorded launch, so a trace that drops launches does not shrink it);
    None where the trace holds none of them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total / e.count for e in prof.key_averages()
             if kernel_name(e.key) in kernel_names and e.count)
    return us / 1e3 if us else None


def bound_ms(nbytes: float, flops: float) -> Tuple[float, str]:
    """max(bytes / memory rate, operations / peak rate) in ms, and which one."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
