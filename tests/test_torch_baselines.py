"""The port's size oracle and baselines against the reference's.

``core/ac_ref.py`` (the Witten–Neal–Cleary arithmetic coder) must give the
reference's bytes and round-trip; the port's rANS stays within 3% + 16 B
of it and near the entropy bound (the port's versions of
``tests/test_codec.py``'s oracle cases); ``rans.encoded_bytes``,
``codec.kv_nbytes_int8`` and ``baselines.int8_wire_bytes`` equal the
reference's formulas.  ``baselines.uniform_quantize_kv`` equals the
reference's numpy computation bit for bit in f32 (ties at .5 of a step,
``group > C``, 4-bit), ``attention_scores_for_h2o`` agrees within 1e-12
relative in f64, and both selections pick the reference's indices with
ties.  ``tests/test_torch_mesh_card.py`` holds the quantize baseline on
the card to the CPU.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro import baselines as jbaselines
from repro.baselines import context_compression as jcc
from repro.baselines import quantization as jq
from repro.core import ac_ref as jac
from repro.core import codec as jcodec
from repro.core import rans as jrans

from repro_torch import baselines
from repro_torch.baselines import context_compression as cc
from repro_torch.baselines import quantization as q
from repro_torch.core import ac_ref, codec, rans, tables

torch.set_num_threads(1)


def _freqs(rng, A, k):
    return tables.normalize_freqs(rng.integers(0, 1000, size=(1, A)), k)


def test_baselines_export_the_reference_names():
    names = ("int8_wire_bytes", "uniform_quantize_kv", "h2o_select", "llmlingua_select")
    for name in names:
        assert hasattr(jbaselines, name) and callable(getattr(baselines, name))


@pytest.mark.parametrize("seed,A,n_sym", [(0, 64, 500), (1, 2, 300), (2, 300, 200), (3, 17, 1)])
def test_ac_encode_bytes_equal_reference_and_round_trip(seed, A, n_sym):
    rng = np.random.default_rng(seed)
    freqs = _freqs(rng, A, 12)[0]
    p = freqs / freqs.sum()
    syms = rng.choice(A, size=n_sym, p=p)
    got = ac_ref.ac_encode(syms, freqs)
    assert got == jac.ac_encode(syms, freqs)
    assert ac_ref.ac_decode(got, n_sym, freqs) == list(syms)
    assert ac_ref.ac_encoded_bits(syms, freqs) == jac.ac_encoded_bits(syms, freqs)


def test_rans_matches_ac_oracle_size():
    """rANS compressed size within ~3% + constant of the exact AC oracle."""
    rng = np.random.default_rng(0)
    A, k = 64, 12
    freqs = _freqs(rng, A, k)
    ct = tables.build_coder_tables(freqs, k, "cpu")
    n_sym = 4000
    syms = rng.choice(A, size=n_sym, p=freqs[0] / freqs[0].sum()).astype(np.uint16)
    _, nw, _ = rans.encode(syms[None], np.zeros(1, np.int32), ct)
    rans_bytes = rans.encoded_bytes(nw)
    ac = ac_ref.ac_encode(syms, freqs[0])
    assert ac_ref.ac_decode(ac, n_sym, freqs[0]) == list(syms)
    assert rans_bytes <= len(ac) * 1.03 + 16, (rans_bytes, len(ac))


def test_rans_near_entropy_bound():
    rng = np.random.default_rng(1)
    A, k = 32, 12
    freqs = _freqs(rng, A, k)
    ct = tables.build_coder_tables(freqs, k, "cpu")
    p = freqs[0] / freqs[0].sum()
    H = -(p * np.log2(p)).sum()
    n_sym = 8000
    syms = rng.choice(A, size=n_sym, p=p).astype(np.uint16)
    _, nw, _ = rans.encode(syms[None], np.zeros(1, np.int32), ct)
    bits = rans.encoded_bytes(nw) * 8
    assert bits <= H * n_sym * 1.05 + 64, (bits, H * n_sym)


def test_size_formulas_equal_reference():
    nw = np.array([3, 0, 17, 5], np.int32)
    assert rans.encoded_bytes(torch.as_tensor(nw)) == rans.encoded_bytes(nw) == jrans.encoded_bytes(jnp.asarray(nw))
    for L, T, C, g in ((32, 1536, 320, 10), (2, 7, 5, 3), (24, 768, 2048, 64)):
        assert codec.kv_nbytes_int8(L, T, C, g) == jcodec.kv_nbytes_int8(L, T, C, g)
        assert codec.kv_nbytes_int8(L, T, C) == jcodec.kv_nbytes_int8(L, T, C)
        for bits in (8, 4):
            assert q.int8_wire_bytes(L, T, C, g, bits) == jq.int8_wire_bytes(L, T, C, g, bits)


def _kv(seed, shape):
    rng = np.random.default_rng(seed)
    kv = rng.standard_normal(shape).astype(np.float32) * rng.uniform(0.01, 5.0, size=shape[:-1] + (1,))
    return kv.astype(np.float32)


@pytest.mark.parametrize("shape,bits,group", [
    ((2, 2, 7, 128), 8, 64), ((2, 2, 7, 128), 4, 64), ((1, 2, 5, 40), 8, 64),  # group > C
    ((3, 2, 4, 96), 8, 32), ((1, 2, 3, 6), 3, 2),
])
def test_uniform_quantize_kv_bit_equal_to_reference(shape, bits, group):
    kv = _kv(sum(shape) + bits, shape)
    want, jwire = jq.uniform_quantize_kv(kv, bits=bits, group=group)
    got, wire = q.uniform_quantize_kv(torch.as_tensor(kv), bits=bits, group=group)
    assert got.dtype == torch.float32 and wire == jwire
    np.testing.assert_array_equal(got.numpy(), want)


def test_uniform_quantize_kv_ties_round_half_to_even():
    # each group's absmax is 127 steps of 0.5, so x / scale hits every .5
    # tie between -63.5 and 63.5
    C, qmax = 64, 127
    x = (np.arange(C, dtype=np.float32) - 32) * 0.5 + 0.25
    x = np.concatenate([x[:-1], [qmax * 0.5]]).astype(np.float32)
    kv = np.stack([x, -x])[None, :, None, :]  # (1, 2, 1, 64)
    want, _ = jq.uniform_quantize_kv(kv, bits=8, group=64)
    got, _ = q.uniform_quantize_kv(kv, bits=8, group=64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.any(np.abs(np.round(x / 0.5) - x / 0.5) == 0.5)


def test_attention_scores_for_h2o_within_1e12():
    rng = np.random.default_rng(5)
    L, T, H, D = 3, 37, 2, 16
    k = rng.standard_normal((L, T, H, D))
    qa = rng.standard_normal((L, T, H, D))
    want = jcc.attention_scores_for_h2o(k, qa)
    got = cc.attention_scores_for_h2o(torch.as_tensor(k), torch.as_tensor(qa))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    # keys as queries, f32 inputs: the port computes in f64 throughout
    got32 = cc.attention_scores_for_h2o(torch.as_tensor(k.astype(np.float32)), torch.as_tensor(k.astype(np.float32)))
    want32 = jcc.attention_scores_for_h2o(k.astype(np.float32).astype(np.float64), k.astype(np.float32).astype(np.float64))
    np.testing.assert_allclose(got32.numpy(), want32, rtol=1e-12, atol=0)


@pytest.mark.parametrize("keep,window", [(0.5, 32), (0.3, 4), (0.9, 0), (0.1, 100)])
def test_selections_with_ties_equal_reference(keep, window):
    rng = np.random.default_rng(7)
    T = 64
    scores = rng.integers(0, 5, size=T).astype(np.float64)  # many ties
    logprobs = -rng.integers(0, 4, size=T).astype(np.float64)
    np.testing.assert_array_equal(cc.h2o_select(torch.as_tensor(scores), keep, window),
                                  jcc.h2o_select(scores, keep, window))
    np.testing.assert_array_equal(cc.llmlingua_select(logprobs, keep, window),
                                  jcc.llmlingua_select(logprobs, keep, window))
