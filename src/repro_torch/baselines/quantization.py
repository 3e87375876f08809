"""'Default quantization' baseline (paper §7.1, from FlexGen [102]):
uniform per-group 8-bit (or k-bit) quantization of the KV cache with the
same level for every layer — no deltas, no entropy coding.  Wire size is the
packed symbols + scales; reconstruction is the dequantized tensor.

Runs on the tensor's device and equals the reference's numpy computation
bit for bit in f32: the scale takes its f16 round trip, ``torch.round``
rounds half to even as ``np.round`` does, and every division divides by a
tensor on the device (a CUDA division by a host number multiplies by its
reciprocal, which rounds differently).
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["uniform_quantize_kv", "int8_wire_bytes"]


def uniform_quantize_kv(kv, bits: int = 8, group: int = 64) -> Tuple[torch.Tensor, int]:
    """kv (L, 2, T, C) -> (dequantized kv in f32, wire_bytes).

    Symmetric per-(L, 2, T, group-of-channels) absmax quantization.
    """
    kv = torch.as_tensor(kv)
    L, two, T, C = kv.shape
    qmax = 2 ** (bits - 1) - 1
    G = max(C // group, 1)
    x = kv.reshape(L, two, T, G, -1).to(torch.float32)
    dev = x.device
    q_max = torch.tensor(float(qmax), dtype=torch.float32, device=dev)
    floor = torch.tensor(1e-12, dtype=torch.float32, device=dev)
    scale = torch.maximum(x.abs().amax(dim=-1, keepdim=True) / q_max, floor)
    scale = scale.to(torch.float16).to(torch.float32)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax)
    deq = (q * scale).reshape(L, two, T, C)
    n_sym = L * two * T * C
    wire = n_sym * bits // 8 + L * two * T * G * 2  # packed symbols + f16 scales
    return deq, wire


def int8_wire_bytes(L: int, T: int, C: int, group: int = 64, bits: int = 8) -> int:
    G = max(C // group, 1)
    return L * 2 * T * C * bits // 8 + L * 2 * T * G * 2
