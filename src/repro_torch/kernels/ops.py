"""Public wrappers of the port's kernels, dispatched on the tensors' device.

A CUDA tensor always goes through the hand-written Hopper kernel (or the
wrapper raises — there is no fallback); a CPU tensor goes through the
kernel's plain PyTorch version.  There is no implementation switch as in the
reference's ``kernels/ops.py``: the device decides.

``launch_counts`` / ``reset_launch_counts`` read and zero the kernels'
launch counters, so a run can show that its path went through them.
``bf16_ulp_excess`` with ``BF16_TOL`` is the one rule by which a kernel with
bf16 output is held against its plain version (K2, K5 and K6 are held bit
for bit).

K3 and K4 have no backward: their kernels write into fresh buffers outside
autograd, so on the card a call with grad enabled and an input that
requires grad raises instead of returning a result whose gradient would
silently be zero.  Their plain versions differentiate as any PyTorch code.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
from repro_torch.kernels.kvquant import (
    kv_dequant_cuda,
    kv_dequant_plain,
    kv_dequant_tokens_cuda,
    kv_dequant_tokens_plain,
    kv_lossless_tokens_cuda,
    kv_lossless_tokens_plain,
    kv_quant_cuda,
    kv_quant_plain,
)

__all__ = [
    "BF16_TOL",
    "KERNELS",
    "bf16_ulp_excess",
    "decode_attention",
    "flash_attention",
    "kv_dequant",
    "kv_dequant_tokens",
    "kv_lossless_tokens",
    "kv_quant",
    "launch_counts",
    "reset_launch_counts",
]

# kernel name -> its launching wrapper (which carries ``.launches``)
KERNELS = {
    "kv_dequant_tokens": kv_dequant_tokens_cuda,
    "kv_lossless_tokens": kv_lossless_tokens_cuda,
    "decode_attention": decode_attention_cuda,
    "flash_attention": flash_attention_cuda,
    "kv_quant": kv_quant_cuda,
    "kv_dequant": kv_dequant_cuda,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


# kernel name -> (bf16 ulps, atol[, rel]) of its bf16 output against its
# plain version: K1 is one rounding of the f32 sum (a contracted
# multiply-add may round a sum that cancels near zero across a bf16 step,
# hence the f32 atol); K6's kernel equals its plain version bit for bit
# (one cast of the same f32 value), so its rule holds the plain version to
# the reference's, which may contract, and rejects a wrong anchor; K3
# against the plain version in f32 from the same bf16 inputs differs by the
# output's rounding and f32 summation order only (its weights stay f32).
# K4 runs its value product on the tensor cores, so it rounds each
# unnormalized weight to bf16 (relative error at most u = 2^-8) before
# multiplying, as the reference's chunked_mha rounds its weights to v's
# dtype at bf16; that moves an output by at most u * sum_t w_t |v_t|, which
# ``rel`` admits on top of the output's rounding (``scale`` =
# ``flash_attention_magnitude``).  K3's and K4's rules are the same at every
# head dim their kernels take (``_build.HEAD_DIMS``, 32 to 256): a score's
# f32 sum over D products moves by summation order only, far below a bf16
# step of the output.
BF16_TOL = {
    "kv_dequant_tokens": {"ulps": 1, "atol": 2e-5},
    "kv_dequant": {"ulps": 1, "atol": 2e-5},
    "decode_attention": {"ulps": 2, "atol": 1e-4},
    "flash_attention": {"ulps": 2, "atol": 1e-4, "rel": 2.0 ** -8},
}


def bf16_ulp_excess(got: torch.Tensor, want: torch.Tensor, *, ulps: float, atol: float,
                    rel: float = 0.0, scale: Optional[torch.Tensor] = None) -> float:
    """``max |got - want| / (ulps * ulp + atol + rel * |scale|)``, with ``ulp``
    the bf16 spacing at the larger of ``|got|`` and ``|want|``: at most 1
    where ``got`` is within the tolerance of ``want``.  A rule with ``rel``
    needs the ``scale`` it is relative to (of ``want``'s shape)."""
    g, w = got.float(), want.float()
    if g.numel() == 0:
        return 0.0
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
    ulp = torch.pow(2.0, torch.floor(torch.log2(mag)) - 7)
    tol = ulps * ulp + atol
    if rel:
        if scale is None:
            raise ValueError("bf16_ulp_excess: a rule with rel needs its scale")
        tol = tol + rel * scale.float().abs().to(tol.device)
    return float(((g - w).abs() / tol).max())


def _on_card(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {t.device}")


def kv_dequant_tokens(d_sym, anchors, bins, *, qmax: int, out_dtype=torch.bfloat16):
    """K1: lossy-level token groups (B, G, g, C); see ``kernels.kvquant``."""
    fn = kv_dequant_tokens_cuda if _on_card(d_sym) else kv_dequant_tokens_plain
    return fn(d_sym, anchors, bins, qmax=qmax, out_dtype=out_dtype)


def kv_lossless_tokens(d_sym, a_sym, scales, *, out_dtype=torch.float32):
    """K2: level-0 token groups (B, G, g, C); see ``kernels.kvquant``."""
    fn = kv_lossless_tokens_cuda if _on_card(d_sym) else kv_lossless_tokens_plain
    return fn(d_sym, a_sym, scales, out_dtype=out_dtype)


def kv_quant(kv_grouped, bins, *, qmax: int):
    """K5: (B, G, g, C) f32 grouped tokens -> (B, G, g-1, C) uint16 delta
    symbols; see ``kernels.kvquant``."""
    fn = kv_quant_cuda if _on_card(kv_grouped) else kv_quant_plain
    return fn(kv_grouped, bins, qmax=qmax)


def kv_dequant(d_sym, anchors, bins, *, qmax: int, out_dtype=torch.bfloat16):
    """K6: (B, G, g-1, C) delta symbols -> dequantized delta tokens plus
    their anchors, (B, G, g-1, C); see ``kernels.kvquant``."""
    fn = kv_dequant_cuda if _on_card(d_sym) else kv_dequant_plain
    return fn(d_sym, anchors, bins, qmax=qmax, out_dtype=out_dtype)


def _no_backward(name: str, *inputs: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; call it with grad disabled "
                           "(torch.no_grad()) or on inputs that do not require grad")


def decode_attention(q, k, v, kv_len, *, scale=None):
    """K3: q (B, Hq, D) vs cache k/v (B, S, Hkv, D); see ``kernels.decode_attention``."""
    if not _on_card(q):
        return decode_attention_plain(q, k, v, kv_len, scale=scale)
    _no_backward("decode_attention", q, k, v)
    return decode_attention_cuda(q, k, v, kv_len, scale=scale)


def flash_attention(q, k, v, prefix_len: Optional[torch.Tensor] = None, *,
                    causal: bool = True, scale=None):
    """K4: q (B, Tq, Hq, D) vs k/v (B, Tk, Hkv, D); see ``kernels.flash_attention``."""
    if not _on_card(q):
        return flash_attention_plain(q, k, v, prefix_len, causal=causal, scale=scale)
    _no_backward("flash_attention", q, k, v)
    return flash_attention_cuda(q, k, v, prefix_len, causal=causal, scale=scale)
