"""The port's codec against the reference's: rANS, profiling, bitstreams
(byte for byte under shared tables) and the fused batched decode."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.core import gop as jgop
from repro.core import quant as jquant
from repro.core import rans as jrans
from repro.core import tables as jtables

from repro_torch.core import codec, gop, rans, tables

torch.set_num_threads(1)

L, C = 4, 64  # smollm-360m.tiny(): 4 layers, 2 KV heads x 32
CFG = dict(precision=11)


def _kv(seed, T):
    """Token-correlated KV (a random walk per channel), as real caches are."""
    r = np.random.default_rng(seed)
    steps = r.normal(scale=0.3, size=(L, 2, T, C)).astype(np.float32)
    return (np.cumsum(steps, axis=2) + r.normal(size=(L, 2, 1, C))).astype(np.float32)


def _counts(kind, rng, T, A):
    if kind == "uniform":
        return rng.integers(0, 1000, size=(T, A))
    if kind == "peaked":  # one symbol holds the mass: rows far over 2**k
        c = np.zeros((T, A), np.int64)
        c[:, 0] = rng.integers(0, 10**7, size=T)
        return c
    if kind == "ties":  # equal remainders: the argsort order decides
        return rng.integers(0, 3, size=(T, A)) * 100
    if kind == "heavy-tail":
        return (rng.pareto(1.2, size=(T, A)) * 50).astype(np.int64)
    return np.zeros((T, A), np.int64)


@pytest.mark.parametrize("kind", ["uniform", "peaked", "ties", "heavy-tail", "empty"])
@pytest.mark.parametrize("A,k", [(2, 1), (17, 5), (256, 8), (256, 11), (256, 12), (511, 10), (511, 12)])
def test_normalize_freqs_equals_reference(kind, A, k):
    """The fix-up computed in whole passes gives the reference loop's
    tables exactly, rows short of and over 2**k alike, ties included."""
    rng = np.random.default_rng(A * 100 + k)
    for T in (1, 5, 16):
        counts = _counts(kind, rng, T, A)
        want = jtables.normalize_freqs(counts, k)
        got = tables.normalize_freqs(counts, k)
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rans_matches_reference_and_inverts(seed):
    r = np.random.default_rng(seed)
    A, k, n_lanes, n_sym = [(40, 10, 8, 50), (300, 12, 16, 33), (509, 11, 5, 1)][seed]
    freqs = jtables.normalize_freqs(r.integers(0, 1000, size=(3, A)), k)
    t_idx = r.integers(0, 3, n_lanes).astype(np.int32)
    syms = r.integers(0, A, size=(n_lanes, n_sym)).astype(np.uint16)
    jw, jn, jx = jrans.encode(jnp.asarray(syms), jnp.asarray(t_idx), jtables.build_coder_tables(freqs, k))
    ct = tables.build_coder_tables(freqs, k, "cpu")
    w, n, x = rans.encode(syms, t_idx, ct)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw).astype(np.int32))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx).astype(np.int64))
    dec = rans.decode(np.asarray(jw), np.asarray(jn), np.asarray(jx), t_idx, ct, n_sym, check=True)
    np.testing.assert_array_equal(dec.numpy(), syms.astype(np.int32))


@pytest.fixture(scope="module")
def samples():
    return [_kv(10, 40), _kv(11, 37)]


@pytest.fixture(scope="module")
def shared(samples):
    """Reference-profiled tables and the same tables in the port."""
    jct = jcodec.profile(samples, jcodec.CodecConfig(**CFG))
    ct = codec.tables_from_numpy(
        anchor=np.asarray(jct.anchor.freqs),
        deltas={l: np.asarray(t.freqs) for l, t in jct.deltas.items()},
        ll_anchor=np.asarray(jct.ll_anchor.freqs),
        ll_delta=np.asarray(jct.ll_delta.freqs),
        table_idx=jct.table_idx, delta_scale=jct.delta_scale,
        config=codec.CodecConfig(**dataclasses.asdict(jct.config)),
        n_layers=jct.n_layers, n_channels=jct.n_channels, device="cpu",
    )
    return jct, ct


def test_profile_matches_reference(samples, shared):
    jct, _ = shared
    ct = codec.profile(samples, codec.CodecConfig(**CFG), device="cpu")
    # delta_scale is a f32 mean whose reduction order may differ by an ulp
    np.testing.assert_allclose(ct.delta_scale, jct.delta_scale, rtol=1e-6)
    for mine, ref in [(ct.anchor, jct.anchor), (ct.ll_anchor, jct.ll_anchor), (ct.ll_delta, jct.ll_delta)] + [
        (ct.deltas[l], jct.deltas[l]) for l in jct.deltas
    ]:
        np.testing.assert_array_equal(mine.freqs.numpy(), np.asarray(ref.freqs))
        np.testing.assert_array_equal(mine.cums.numpy(), np.asarray(ref.cums))
        np.testing.assert_array_equal(mine.slot2sym.numpy(), np.asarray(ref.slot2sym))
    np.testing.assert_array_equal(ct.table_idx, jct.table_idx)


@pytest.mark.parametrize("T", [40, 37, 1, 7, 10, 11])
def test_encode_byte_identical_to_reference(shared, T):
    jct, ct = shared
    kv = _kv(20 + T, T)
    mine = codec.encode_all_levels(kv, ct, chunk_idx=3)
    ref = jcodec.encode_all_levels(kv, jct, chunk_idx=3)
    assert mine.keys() == ref.keys()
    for lvl in ref:
        assert mine[lvl] == ref[lvl], f"level {lvl} differs"
        assert codec.encode_chunk(kv, ct, lvl, chunk_idx=3) == ref[lvl]


@pytest.mark.parametrize("T", [1530, 1536, 7, 10, 11])
def test_delta_kernels_path_matches_reference(T):
    """K5's and K6's paths through whole groups — the partial last group
    padded with its anchor, the padded slots dropped — give the reference's
    delta symbols exactly, and its reconstruction within 2e-5."""
    kv = _kv(50 + T, T)
    layout, jlayout = gop.make_layout(T, 10), jgop.make_layout(T, 10)
    bins = np.random.default_rng(T).uniform(0.05, 0.5, size=(L, 2)).astype(np.float32)
    grouped = gop.group_tokens(torch.as_tensor(kv), layout)
    assert tuple(grouped.shape) == (L, 2, -(-T // 10), 10, C)
    sym = codec._quantize_deltas(grouped, torch.as_tensor(bins), layout, 127)
    janchors, jdeltas = jgop.split_anchors_deltas(jnp.asarray(kv), jlayout)
    jsym = jquant.quantize_deltas(jdeltas, jnp.asarray(bins), 127)
    np.testing.assert_array_equal(sym.numpy(), np.asarray(jsym))
    got = codec._reconstruct_lossy(torch.as_tensor(np.array(janchors)), sym, torch.as_tensor(bins), layout, 127)
    want = jgop.merge_anchors_deltas(janchors, jquant.dequantize_deltas(jsym, jnp.asarray(bins), 127), jlayout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def mixed_blobs(shared):
    """Four chunks at levels 0, 2, 0, 4; two are ragged (T % 10 != 0)."""
    jct, _ = shared
    spec = [(0, 40, 0), (1, 37, 2), (2, 40, 0), (3, 23, 4)]
    return [jcodec.encode_all_levels(_kv(30 + i, T), jct)[lvl] for i, T, lvl in spec], spec


def test_decode_chunk_matches_reference(shared, mixed_blobs):
    jct, ct = shared
    blobs, spec = mixed_blobs
    for blob, (_, _, lvl) in zip(blobs, spec):
        got = codec.decode_chunk(blob, ct).numpy()
        want = np.asarray(jcodec.decode_chunk(blob, jct))
        if lvl == 0:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_decode_chunks_matches_reference(shared, mixed_blobs, use_pallas):
    jct, ct = shared
    blobs, spec = mixed_blobs
    got = codec.decode_chunks(blobs, ct).numpy()
    want = np.asarray(jcodec.decode_chunks(blobs, jct, use_pallas=use_pallas, block_groups=3))
    assert got.shape == want.shape == (L, 2, sum(T for _, T, _ in spec), C)
    off = 0
    for _, T, lvl in spec:
        sl = slice(off, off + T)
        off += T
        if lvl == 0:  # bit-exact, and equal to the unfused oracle
            np.testing.assert_array_equal(got[:, :, sl], want[:, :, sl])
        else:
            np.testing.assert_allclose(got[:, :, sl], want[:, :, sl], atol=2e-5, rtol=2e-5)


def test_decode_chunks_bf16_and_oracle(shared, mixed_blobs):
    jct, ct = shared
    blobs, spec = mixed_blobs
    got = codec.decode_chunks(blobs, ct, out_dtype=torch.bfloat16)
    want = np.asarray(jcodec.decode_chunks(blobs, jct, out_dtype=jnp.bfloat16), np.float32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=1e-2)
    oracle = torch.cat([codec.decode_chunk(b, ct) for b in blobs], dim=2)
    fused = codec.decode_chunks(blobs, ct)
    np.testing.assert_array_equal(fused[:, :, :40].numpy(), oracle[:, :, :40].numpy())


def test_decode_chunk_runs_spans(shared, mixed_blobs):
    jct, ct = shared
    blobs, _ = mixed_blobs
    runs = [blobs[:2], blobs[2:3], blobs[3:]]
    kv, spans = codec.decode_chunk_runs(runs, ct)
    jkv, jspans = jcodec.decode_chunk_runs(runs, jct)
    assert spans == jspans == [(0, 77), (77, 40), (117, 23)]
    for (off, n), run in zip(spans, runs):
        np.testing.assert_array_equal(kv[:, :, off:off + n].numpy(), codec.decode_chunks(run, ct).numpy())
    with pytest.raises(ValueError):
        codec.decode_chunk_runs(runs, ct, run_tokens=[77, 40, 24])
    with pytest.raises(ValueError):
        codec.decode_chunk_runs([blobs[:1], []], ct)


def test_checksum_gate_and_header(shared, mixed_blobs):
    _, ct = shared
    blobs, _ = mixed_blobs
    assert codec.verify_chunk(blobs[1])
    assert codec.peek_chunk_header(blobs[1])["level"] == 2
    bad = bytearray(blobs[1])
    bad[100] ^= 1
    with pytest.raises(ValueError):
        codec.decode_chunks([bytes(bad)], ct)


# ---------------------------------------------------------------------------
# A wide alphabet: delta_qmax 1023 gives 2,047-symbol delta tables (the
# decode stack too), past the staged K7's and K8's caps on the card
# ---------------------------------------------------------------------------

WIDE = dict(delta_qmax=1023, precision=12)


@pytest.fixture(scope="module")
def wide_shared(samples):
    """Both packages' profiles of the samples under ``WIDE``."""
    return jcodec.profile(samples, jcodec.CodecConfig(**WIDE)), codec.profile(
        samples, codec.CodecConfig(**WIDE), device="cpu")


def test_wide_alphabet_profile_matches_reference(wide_shared):
    jct, ct = wide_shared
    assert ct.config.delta_alphabet == 2047 and ct.delta_decode_stack.freqs.shape[1] == 2047
    for mine, ref in [(ct.anchor, jct.anchor), (ct.ll_delta, jct.ll_delta)] + [
        (ct.deltas[l], jct.deltas[l]) for l in jct.deltas
    ]:
        np.testing.assert_array_equal(mine.freqs.numpy(), np.asarray(ref.freqs))
        np.testing.assert_array_equal(mine.slot2sym.numpy(), np.asarray(ref.slot2sym))


@pytest.mark.parametrize("T", [40, 23])
def test_wide_alphabet_encode_byte_identical_to_reference(wide_shared, T):
    jct, ct = wide_shared
    kv = _kv(60 + T, T)
    mine = codec.encode_all_levels(kv, ct, chunk_idx=1)
    ref = jcodec.encode_all_levels(kv, jct, chunk_idx=1)
    assert mine.keys() == ref.keys()
    for lvl in ref:
        assert mine[lvl] == ref[lvl], f"level {lvl} differs"


def test_wide_alphabet_decode_chunks_matches_reference(wide_shared):
    """Level 0 bit for bit, the lossy levels within 2e-5, from the
    reference's blobs; the port's own blobs decode to the same."""
    jct, ct = wide_shared
    spec = [(0, 40, 0), (1, 37, 1), (2, 23, 4)]
    blobs = [jcodec.encode_all_levels(_kv(70 + i, T), jct)[lvl] for i, T, lvl in spec]
    got = codec.decode_chunks(blobs, ct).numpy()
    want = np.asarray(jcodec.decode_chunks(blobs, jct))
    off = 0
    for _, T, lvl in spec:
        sl = slice(off, off + T)
        off += T
        if lvl == 0:
            np.testing.assert_array_equal(got[:, :, sl], want[:, :, sl])
        else:
            np.testing.assert_allclose(got[:, :, sl], want[:, :, sl], atol=2e-5, rtol=2e-5)
    own = [codec.encode_all_levels(_kv(70 + i, T), ct)[lvl] for i, T, lvl in spec]
    assert own == blobs
