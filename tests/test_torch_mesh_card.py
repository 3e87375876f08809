"""Card tests of slice 11 (``-m gpu``; they skip without a card): the
ctypes wrappers launch on their tensors' card whatever card is current
(two cards), and ``baselines.uniform_quantize_kv`` on the card equals the
CPU's bit for bit.  This file imports no JAX: the card's machine has none.
"""
import numpy as np
import pytest
import torch

from repro_torch.baselines import quantization as q


@pytest.mark.gpu
def test_wrappers_launch_on_the_tensors_card():
    """K1, K2 and K3 on ``cuda:1`` with ``cuda:0`` current: each launch
    must run on its tensors' card (a stream of one card under another's
    current device is an invalid handle)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_attention_plain
    from repro_torch.kernels.kvquant import (
        kv_dequant_tokens_cuda,
        kv_dequant_tokens_plain,
        kv_lossless_tokens_cuda,
        kv_lossless_tokens_plain,
    )

    dev = torch.device("cuda", 1)
    g = torch.Generator().manual_seed(0)
    d_sym = torch.randint(0, 255, (4, 6, 9, 40), generator=g, dtype=torch.int32).to(torch.uint16)
    anchors = torch.randn((4, 6, 40), generator=g)
    bins = torch.rand((4,), generator=g) + 0.1
    a_sym = torch.randint(1, 256, (4, 6, 40), generator=g, dtype=torch.int32).to(torch.uint16)
    scales = torch.rand((4, 6), generator=g) * 0.05
    q = torch.randn((2, 8, 64), generator=g)
    k = torch.randn((2, 96, 2, 64), generator=g)
    v = torch.randn((2, 96, 2, 64), generator=g)
    kv_len = torch.tensor([96, 40], dtype=torch.int32)
    with torch.cuda.device(0):
        got1 = kv_dequant_tokens_cuda(d_sym.to(dev), anchors.to(dev), bins.to(dev), qmax=127, out_dtype=torch.float32)
        got2 = kv_lossless_tokens_cuda(d_sym.to(dev), a_sym.to(dev), scales.to(dev))
        got3 = decode_attention_cuda(q.to(dev), k.to(dev), v.to(dev), kv_len.to(dev))
        torch.cuda.synchronize(dev)
    assert got1.device == got2.device == got3.device == dev
    torch.testing.assert_close(got1.cpu(), kv_dequant_tokens_plain(d_sym, anchors, bins, qmax=127,
                                                                   out_dtype=torch.float32), atol=2e-5, rtol=2e-5)
    assert torch.equal(got2.cpu(), kv_lossless_tokens_plain(d_sym, a_sym, scales))
    want3 = decode_attention_plain(q, k, v, kv_len)
    assert ops.bf16_ulp_excess(got3.cpu(), want3, **ops.BF16_TOL["decode_attention"]) <= 1


@pytest.mark.gpu
def test_uniform_quantize_kv_on_the_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = np.random.default_rng(3)
    kv = r.standard_normal((4, 2, 257, 320)) * r.uniform(0.01, 5.0, (4, 2, 257, 1))
    kv = torch.as_tensor(kv.astype(np.float32))
    for bits in (8, 4):
        want, wire = q.uniform_quantize_kv(kv, bits=bits)
        got, wire_c = q.uniform_quantize_kv(kv.cuda(), bits=bits)
        assert wire_c == wire and got.is_cuda
        assert torch.equal(got.cpu(), want)
