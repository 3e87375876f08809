"""Public wrappers of the port's kernels, dispatched on the tensors' device.

A CUDA tensor always goes through the hand-written Hopper kernel (or the
wrapper raises — there is no fallback); a CPU tensor goes through the
kernel's plain PyTorch version.  There is no implementation switch as in the
reference's ``kernels/ops.py``: the device decides.

``launch_counts`` / ``reset_launch_counts`` read and zero the kernels'
launch counters, so a run can show that its path went through them.
``bf16_ulp_excess`` with ``BF16_TOL`` is the one rule by which a kernel with
bf16 output is held against its plain version (K2, K5 and K6 are held bit
for bit, and the rANS coder's K7 and K8 symbol for symbol and word for
word).  K7 and K8 are picked by the device of their tables, and on the
card by their alphabet: the staged kernel while a block's staged rows fit,
else the wide one (``kernels.rans.decode_kernel`` / ``encode_kernel``),
each with its own launch count.

Under autograd (grad enabled and an input that requires grad) K4 on the
card goes through ``_FlashAttention``, a ``torch.autograd.Function``: its
forward launches K4 and its backward is the plain version's VJP
(``flash_attention_vjp``, a query chunk at a time).  That is the design,
not a fallback: the reference has no backward kernel either (no
``custom_vjp``), and trains through autodiff of its plain ``chunked_mha``;
a hand-written Hopper backward would be a feature the reference lacks.
Without grad the wrapper launches K4 alone.  K3 has no backward and no
training path decodes, so on the card a K3 call with grad enabled and an
input that requires grad raises instead of returning a result whose
gradient would silently be zero.  On the CPU both plain versions
differentiate as any PyTorch code.

A tensor on ``meta`` (the dry run's abstract inputs, ``launch.dryrun``)
takes the card's route with the plain version in the kernel's place and
counts no launch: abstract evaluation of what the card runs, as XLA lowers
a program without running it.  So K4 under autograd on meta is
``_FlashAttention`` too (its backward the same VJP as on the card), and K3
under grad raises there as it does on the card.  Any other device type
raises.

While a dry run's FLOP counter is active (:data:`FLOP_COUNTERS`), each K3
and K4 call adds its plain version's product FLOPs to it explicitly
(:func:`attention_flops`) and whatever the counter saw inside the call is
dropped: the kernels launch through ``ctypes``, where no dispatch mode sees
them, so one rule counts each attention call exactly once on every route.
The backward's plain VJP is counted op by op.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain, flash_attention_vjp
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
from repro_torch.kernels.rans import (
    decode_kernel,
    encode_kernel,
    rans_decode_cuda,
    rans_decode_plain,
    rans_decode_wide_cuda,
    rans_encode_cuda,
    rans_encode_plain,
    rans_encode_wide_cuda,
)

__all__ = [
    "BF16_TOL",
    "FLOP_COUNTERS",
    "KERNELS",
    "attention_flops",
    "bf16_ulp_excess",
    "decode_attention",
    "flash_attention",
    "kv_dequant",
    "kv_dequant_tokens",
    "kv_lossless_tokens",
    "kv_quant",
    "launch_counts",
    "rans_decode",
    "rans_encode",
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
    "rans_decode": rans_decode_cuda,
    "rans_encode": rans_encode_cuda,
    "rans_decode_wide": rans_decode_wide_cuda,
    "rans_encode_wide": rans_encode_wide_cuda,
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
# head dim their kernels take (any D >= 1: up to 256 on the plans of
# ``_build.HEAD_DIMS``, the columns past D zeros, past it on the wide path's
# output panels) and every group size: a score's f32 sum over D products
# moves by summation order only, far below a bf16 step of the output.
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
    """Whether ``t`` takes the card's route: a CUDA tensor (the kernel) or a
    meta tensor (abstract evaluation: the plain version, no launch)."""
    if t.is_cuda or t.device.type == "meta":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {t.device}")


def _pick(t: torch.Tensor, kernel, plain):
    """The kernel for a CUDA tensor, the plain version for a CPU or meta one."""
    return kernel if _on_card(t) and t.is_cuda else plain


# the dry run's active FLOP counters (objects with an int ``flops``):
# ``launch.hlo_stats.FlopCounter`` adds itself while it is entered
FLOP_COUNTERS: List = []


def attention_flops(kind: str, q: torch.Tensor, k: torch.Tensor) -> int:
    """The product FLOPs of K3's or K4's plain version on these shapes, two
    per multiply-add: K4 (``"flash"``) scores every query against all Tk
    keys and weights all Tk values (the plain version's full-Tk query
    chunks, the causal mask applied after the product), ``4 B Hq Tq Tk D``;
    K3 (``"decode"``) the one query against all S slots, ``4 B Hq S D``."""
    if kind == "flash":
        B, Tq, Hq, D = q.shape
        return 4 * B * Hq * Tq * k.shape[1] * D
    B, Hq, D = q.shape
    return 4 * B * Hq * k.shape[1] * D


def _counted(flops: int, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, with each active FLOP counter set to what it
    held before the call plus ``flops``."""
    if not FLOP_COUNTERS:
        return fn(*args, **kwargs)
    before = [c.flops for c in FLOP_COUNTERS]
    out = fn(*args, **kwargs)
    for c, n in zip(FLOP_COUNTERS, before):
        c.flops = n + flops
    return out


def kv_dequant_tokens(d_sym, anchors, bins, *, qmax: int, out_dtype=torch.bfloat16):
    """K1: lossy-level token groups (B, G, g, C); see ``kernels.kvquant``."""
    fn = _pick(d_sym, kv_dequant_tokens_cuda, kv_dequant_tokens_plain)
    return fn(d_sym, anchors, bins, qmax=qmax, out_dtype=out_dtype)


def kv_lossless_tokens(d_sym, a_sym, scales, *, out_dtype=torch.float32):
    """K2: level-0 token groups (B, G, g, C); see ``kernels.kvquant``."""
    fn = _pick(d_sym, kv_lossless_tokens_cuda, kv_lossless_tokens_plain)
    return fn(d_sym, a_sym, scales, out_dtype=out_dtype)


def kv_quant(kv_grouped, bins, *, qmax: int):
    """K5: (B, G, g, C) f32 grouped tokens -> (B, G, g-1, C) uint16 delta
    symbols; see ``kernels.kvquant``."""
    fn = _pick(kv_grouped, kv_quant_cuda, kv_quant_plain)
    return fn(kv_grouped, bins, qmax=qmax)


def kv_dequant(d_sym, anchors, bins, *, qmax: int, out_dtype=torch.bfloat16):
    """K6: (B, G, g-1, C) delta symbols -> dequantized delta tokens plus
    their anchors, (B, G, g-1, C); see ``kernels.kvquant``."""
    fn = _pick(d_sym, kv_dequant_cuda, kv_dequant_plain)
    return fn(d_sym, anchors, bins, qmax=qmax, out_dtype=out_dtype)


def rans_decode(payload, n_words, offsets, state, table_idx, tables, n_sym: int):
    """K7: ``n_sym`` symbols a lane from the wire's compact rANS stream ->
    (symbols, final state, final word pointer); see ``kernels.rans``."""
    fn = _pick(tables.freqs, decode_kernel(tables.freqs.shape[-1]), rans_decode_plain)
    return fn(payload, n_words, offsets, state, table_idx, tables, n_sym)


def rans_encode(symbols, table_idx, tables):
    """K8: (n_lanes, n_sym) symbols -> (words, n_words, final state); see
    ``kernels.rans``."""
    fn = _pick(tables.freqs, encode_kernel(tables.freqs.shape[-1]), rans_encode_plain)
    return fn(symbols, table_idx, tables)


def _no_backward(name: str, *inputs: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; call it with grad disabled "
                           "(torch.no_grad()) or on inputs that do not require grad")


def decode_attention(q, k, v, kv_len, *, scale=None):
    """K3: q (B, Hq, D) vs cache k/v (B, S, Hkv, D); see ``kernels.decode_attention``."""
    if _on_card(q):
        _no_backward("decode_attention", q, k, v)
    fn = _pick(q, decode_attention_cuda, decode_attention_plain)
    return _counted(attention_flops("decode", q, k), fn, q, k, v, kv_len, scale=scale)


class _FlashAttention(torch.autograd.Function):
    """K4 under autograd: the forward launches K4, the backward computes the
    plain version's VJP from the saved inputs (see the module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, prefix_len, causal, scale):
        ctx.save_for_backward(q, k, v, prefix_len)
        ctx.causal, ctx.scale = causal, scale
        fn = _pick(q, flash_attention_cuda, flash_attention_plain)
        return fn(q, k, v, prefix_len, causal=causal, scale=scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v, prefix_len = ctx.saved_tensors
        dq, dk, dv = flash_attention_vjp(q, k, v, prefix_len, do, causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, prefix_len: Optional[torch.Tensor] = None, *,
                    causal: bool = True, scale=None):
    """K4: q (B, Tq, Hq, D) vs k/v (B, Tk, Hkv, D); see ``kernels.flash_attention``."""
    flops = attention_flops("flash", q, k)
    if _on_card(q) and torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _counted(flops, _FlashAttention.apply, q, k, v, prefix_len, causal, scale)
    fn = _pick(q, flash_attention_cuda, flash_attention_plain)
    return _counted(flops, fn, q, k, v, prefix_len, causal=causal, scale=scale)
