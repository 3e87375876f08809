"""The rANS coder's two scans (K7 decode, K8 encode): the plain versions
against the reference's jitted scans (``repro.core.rans._decode_impl`` /
``_encode_impl``) on the CPU, exactly, on stacked table sets as the codec
builds them; the wire's words and states through the card route's bit views;
the ragged cases; the CPU route through ``kernels.ops``; and the CUDA kernels
against the plain versions on the card (``-m gpu``), including a lane whose
table starts past 2^31 slots, ``decode_chunks`` and ``encode_all_levels``."""
import numpy as np
import pytest
import torch

try:  # the reference; absent where only the port is installed (the card's machine)
    import jax.numpy as jnp
    from repro.core import rans as jrans
    from repro.core import tables as jtables
except ImportError:
    jnp = None

from repro_torch.core import bitstream, codec, rans, tables
from repro_torch.kernels import ops
from repro_torch.kernels.rans import (
    RANS_L,
    rans_decode_cuda,
    rans_decode_plain,
    rans_encode_cuda,
    rans_encode_plain,
)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _needs_reference(request):
    if jnp is None and "gpu" not in request.keywords:
        pytest.skip("needs the JAX reference package")


def _freqs(rng, n_tables, A, k):
    """Skewed histograms (heavy-tailed, some symbols unseen) -> frequencies
    summing to 2**k, every one >= 1."""
    counts = (rng.pareto(1.2, size=(n_tables, A)) * 50).astype(np.int64)
    return tables.normalize_freqs(counts, k)


def _world(seed, k, alphabets, n_tables, n_lanes, n_sym, device="cpu"):
    """Table sets of ``alphabets`` stacked as the codec stacks them (padded
    when their alphabets differ, as ``decode_chunks``' delta stack is), each
    lane on a random table of a random set, and symbols drawn from its
    table's distribution (so every symbol lies within its set's alphabet)."""
    rng = np.random.default_rng(seed)
    sets = [_freqs(rng, n_tables, A, k) for A in alphabets]
    pad = len(set(alphabets)) > 1
    stack = rans.stack_tables([tables.build_coder_tables(f, k, device) for f in sets], pad_alphabet=pad)
    t_idx = (rng.integers(0, len(sets), n_lanes) * n_tables + rng.integers(0, n_tables, n_lanes)).astype(np.int32)
    s2s = stack.slot2sym.cpu().numpy()
    syms = s2s[t_idx[:, None], rng.integers(0, 1 << k, size=(n_lanes, n_sym))].astype(np.int32)
    return sets, pad, stack, t_idx, syms


def _reference(sets, pad, k):
    return jrans.stack_tables([jtables.build_coder_tables(f, k) for f in sets], pad_alphabet=pad)


# (seed, precision, alphabets of the stacked sets, tables a set, lanes, symbols a lane)
CASES = {
    "one set": (0, 12, (256,), 8, 37, 50),
    "lossy delta stack": (1, 11, (255, 255, 255, 255), 6, 48, 33),
    "decode stack, padded": (2, 12, (255, 255, 255, 255, 509), 5, 70, 41),
    "anchor stack": (3, 12, (256, 256), 4, 24, 7),
    "n_sym 1": (4, 10, (40,), 3, 9, 1),
    "k 14": (5, 14, (509,), 2, 5, 64),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_scans_match_reference(case):
    """Both plain scans equal the reference's element for element: the
    encoder's words (the unused tail included), word counts and states; the
    decoder's symbols and its final state and word pointer, from the wire's
    words and states as the card route hands them over (int16 / int32 bits)."""
    seed, k, alphabets, n_t, n_lanes, n_sym = CASES[case]
    sets, pad, stack, t_idx, syms = _world(seed, k, alphabets, n_t, n_lanes, n_sym)
    jstack = _reference(sets, pad, k)
    jw, jn, jx = jrans._encode_impl(jnp.asarray(syms), jnp.asarray(t_idx), jstack.freqs, jstack.cums, precision=k)
    jw, jn, jx = np.array(jw), np.array(jn), np.array(jx)  # writable: torch.from_numpy views them
    w, n, x = rans_encode_plain(torch.from_numpy(syms), torch.from_numpy(t_idx), stack)
    np.testing.assert_array_equal(w.numpy(), jw.astype(np.int32))
    np.testing.assert_array_equal(n.numpy(), jn)
    np.testing.assert_array_equal(x.numpy(), jx.astype(np.int64))

    js, jxd, jpd = jrans._decode_impl(jnp.asarray(jw), jnp.asarray(jn), jnp.asarray(jx), jnp.asarray(t_idx),
                                      jstack.freqs, jstack.cums, jstack.slot2sym, precision=k, n_sym=n_sym)
    s, xd, pd = rans_decode_plain(torch.from_numpy(jw.view(np.int16)), torch.from_numpy(jn),
                                  torch.from_numpy(jx.view(np.int32)), torch.from_numpy(t_idx), stack, n_sym)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js).astype(np.int32))
    np.testing.assert_array_equal(s.numpy(), syms)
    np.testing.assert_array_equal(xd.numpy(), np.asarray(jxd).astype(np.int64))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jpd).astype(np.int64))
    assert (xd == RANS_L).all() and (pd == -1).all()
    if case == "decode stack, padded":  # the bit views carry values past the signed range
        assert (jw >= 1 << 15).any() and (jx >= 1 << 31).any()
    if case == "n_sym 1":  # one symbol never fills the state: no lane emits a word
        assert not jn.any()


def _wire(w, n, x):
    return bitstream.unpack_stream(bitstream.pack_stream(w.numpy(), n.numpy(), x.numpy(), "d"), "d")


# how ``rans.decode``'s callers hand over a stream: the wire's padded uint16 /
# uint32 arrays (``bitstream.unpack_stream``), the encoder's own tensors
# (int32 words, int64 states), and host int64 arrays
INPUTS = {
    "wire": lambda w, n, x: _wire(w, n, x),
    "encoder tensors": lambda w, n, x: (w, n, x),
    "int64 arrays": lambda w, n, x: (w.numpy().astype(np.int64), n.numpy().astype(np.int64),
                                     x.numpy().astype(np.int64)),
}


@pytest.mark.parametrize("kind", list(INPUTS))
def test_entry_points_round_trip_every_input_kind(kind):
    """``rans.encode`` / ``rans.decode`` (through ``kernels.ops``) invert each
    other from every kind of input, ``check=True`` passing, and decode the
    reference's own stream to the same symbols."""
    seed, k, alphabets, n_t, n_lanes, n_sym = CASES["decode stack, padded"]
    sets, pad, stack, t_idx, syms = _world(seed, k, alphabets, n_t, n_lanes, n_sym)
    w, n, x = rans.encode(syms.astype(np.uint16), t_idx, stack)
    dec = rans.decode(*INPUTS[kind](w, n, x), t_idx, stack, n_sym, check=True)
    np.testing.assert_array_equal(dec.numpy(), syms)
    jstack = _reference(sets, pad, k)
    jw, jn, jx = jrans.encode(jnp.asarray(syms), jnp.asarray(t_idx), jstack)
    dec = rans.decode(np.asarray(jw), np.asarray(jn), np.asarray(jx), t_idx, stack, n_sym, check=True)
    np.testing.assert_array_equal(dec.numpy(), syms)


def test_zero_width_words_and_empty_lanes():
    """A stream with no words at all (``n_sym`` = 1: no lane emits) decodes
    from a zero-width word matrix as the reference decodes it from one zero
    column."""
    seed, k, alphabets, n_t, n_lanes, n_sym = CASES["n_sym 1"]
    sets, pad, stack, t_idx, syms = _world(seed, k, alphabets, n_t, n_lanes, n_sym)
    _, n, x = rans.encode(syms, t_idx, stack)
    assert not n.any()
    words = np.zeros((n_lanes, 0), np.uint16)
    dec = rans.decode(words, n.numpy(), x.numpy().astype(np.uint32), t_idx, stack, n_sym, check=True)
    jstack = _reference(sets, pad, k)
    js, _, _ = jrans._decode_impl(jnp.zeros((n_lanes, 1), jnp.uint16), jnp.asarray(n.numpy()),
                                  jnp.asarray(x.numpy().astype(np.uint32)), jnp.asarray(t_idx), jstack.freqs,
                                  jstack.cums, jstack.slot2sym, precision=k, n_sym=n_sym)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(js).astype(np.int32))
    np.testing.assert_array_equal(dec.numpy(), syms)


def test_check_catches_a_corrupt_stream():
    """``check=True`` raises on one flipped word and on a lane that claims
    more words than its row holds."""
    seed, k, alphabets, n_t, n_lanes, n_sym = CASES["one set"]
    _, _, stack, t_idx, syms = _world(seed, k, alphabets, n_t, n_lanes, n_sym)
    words, n_words, state = _wire(*rans.encode(syms, t_idx, stack))
    lane = int(np.argmax(n_words))
    bad = words.copy()
    bad[lane, n_words[lane] // 2] ^= 0x5A5A
    with pytest.raises(ValueError, match="corrupt"):
        rans.decode(bad, n_words, state, t_idx, stack, n_sym, check=True)
    long = n_words.copy()
    long[lane] = words.shape[1] + 1
    with pytest.raises(ValueError, match="corrupt"):
        rans.decode(words, long, state, t_idx, stack, n_sym)


@pytest.mark.parametrize("kind", list(INPUTS))
def test_decode_refuses_more_words_than_a_row_holds(kind):
    """A lane that claims more words than the word matrix has columns raises
    before the decode, from host arrays and from tensors alike (the card's
    route would clamp its reads into the row instead of failing)."""
    seed, k, alphabets, n_t, n_lanes, n_sym = CASES["one set"]
    _, _, stack, t_idx, syms = _world(seed, k, alphabets, n_t, n_lanes, n_sym)
    words, n_words, state = INPUTS[kind](*rans.encode(syms, t_idx, stack))
    long = n_words.copy() if isinstance(n_words, np.ndarray) else n_words.clone()
    long[int(long.argmax())] = words.shape[1] + 1
    with pytest.raises(ValueError, match="corrupt"):
        rans.decode(words, long, state, t_idx, stack, n_sym)


def test_ops_take_the_plain_route_on_the_cpu():
    """CPU tables take the plain versions through ``kernels.ops`` and count
    no launch."""
    seed, k, alphabets, n_t, n_lanes, n_sym = CASES["anchor stack"]
    _, _, stack, t_idx, syms = _world(seed, k, alphabets, n_t, n_lanes, n_sym)
    ops.reset_launch_counts()
    sym_t, t_t = torch.from_numpy(syms), torch.from_numpy(t_idx)
    w, n, x = ops.rans_encode(sym_t, t_t, stack)
    for got, want in zip((w, n, x), rans_encode_plain(sym_t, t_t, stack)):
        assert torch.equal(got, want)
    s, xd, pd = ops.rans_decode(rans.wire_bits(w, 16, "cpu"), n, rans.wire_bits(x, 32, "cpu"), t_t, stack, n_sym)
    assert torch.equal(s, sym_t) and bool((xd == RANS_L).all()) and bool((pd == -1).all())
    assert ops.launch_counts()["rans_decode"] == ops.launch_counts()["rans_encode"] == 0


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers raise on CPU tensors instead of falling back to
    the loops, and count nothing."""
    seed, k, alphabets, n_t, n_lanes, n_sym = CASES["one set"]
    _, _, stack, t_idx, syms = _world(seed, k, alphabets, n_t, n_lanes, n_sym)
    sym_t, t_t = torch.from_numpy(syms), torch.from_numpy(t_idx)
    before = (rans_decode_cuda.launches, rans_encode_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        rans_encode_cuda(sym_t, t_t, stack)
    words = torch.zeros((n_lanes, 4), dtype=torch.int16)
    with pytest.raises(ValueError, match="CUDA"):
        rans_decode_cuda(words, torch.zeros(n_lanes, dtype=torch.int32), torch.full((n_lanes,), RANS_L,
                         dtype=torch.int32), t_t, stack, n_sym)
    with pytest.raises(TypeError):  # words wider than the wire's 16 bits
        rans_decode_cuda(words.to(torch.int32), torch.zeros(n_lanes, dtype=torch.int32),
                         torch.full((n_lanes,), RANS_L, dtype=torch.int32), t_t, stack, n_sym)
    assert (rans_decode_cuda.launches, rans_encode_cuda.launches) == before


# ---------------------------------------------------------------------------
# K7 and K8 against the plain versions (on the card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _held(cuda, stack, t_idx, syms):
    """K8 and then K7 on the card equal their plain versions there, word for
    word and symbol for symbol, and K7 inverts K8."""
    t_t = torch.as_tensor(t_idx, device=cuda)
    sym_t = torch.as_tensor(syms, device=cuda)
    got, want = rans_encode_cuda(sym_t, t_t, stack), rans_encode_plain(sym_t, t_t, stack)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    w, n, x = got
    args = (rans.wire_bits(w, 16, w.device), n, rans.wire_bits(x, 32, x.device), t_t, stack, syms.shape[1])
    got, want = rans_decode_cuda(*args), rans_decode_plain(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(got[0], sym_t) and bool((got[1] == RANS_L).all()) and bool((got[2] == -1).all())


# (seed, precision, alphabets, tables a set, lanes, symbols a lane): the CPU
# cases, a lane count that is no multiple of the block, and a padded decode
# stack at a chunk's delta length
CUDA_CASES = list(CASES.values()) + [(6, 12, (256,), 64, 20_481, 154), (7, 12, (255,) * 4 + (509,), 32, 4_160, 1_382)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_rans_matches_plain(cuda, case):
    seed, k, alphabets, n_t, n_lanes, n_sym = case
    _, _, stack, t_idx, syms = _world(seed, k, alphabets, n_t, n_lanes, n_sym, device=cuda)
    _held(cuda, stack, t_idx, syms)


@pytest.mark.gpu
def test_cuda_rans_zero_width_words(cuda):
    seed, k, alphabets, n_t, n_lanes, n_sym = CASES["n_sym 1"]
    _, _, stack, t_idx, syms = _world(seed, k, alphabets, n_t, n_lanes, n_sym, device=cuda)
    _, n, x = rans.encode(syms, t_idx, stack)
    dec = rans.decode(torch.zeros((n_lanes, 0), dtype=torch.int16), n, x, t_idx, stack, n_sym, check=True)
    assert torch.equal(dec.cpu(), torch.from_numpy(syms))


@pytest.mark.gpu
def test_cuda_decode_refuses_more_words_than_a_row_holds(cuda):
    seed, k, alphabets, n_t, n_lanes, n_sym = CASES["one set"]
    _, _, stack, t_idx, syms = _world(seed, k, alphabets, n_t, n_lanes, n_sym, device=cuda)
    words, n_words, state = rans.encode(syms, t_idx, stack)
    n_words[0] = words.shape[1] + 1
    before = rans_decode_cuda.launches
    with pytest.raises(ValueError, match="corrupt"):
        rans.decode(words, n_words, state, t_idx, stack, n_sym)
    assert rans_decode_cuda.launches == before


@pytest.mark.gpu
def test_cuda_rans_table_past_2_31_slots(cuda):
    """Lanes whose tables start at or past 2^31 slots of a 4096-slot stack
    (524,289 tables: 4.3 GB of slot2sym) and lanes at its start: the kernels index the
    tables in 64 bits, as the plain versions do."""
    k, A, n_t, real = 12, 64, (1 << 19) + 1, 16
    rng = np.random.default_rng(8)
    small = tables.build_coder_tables(_freqs(rng, 2 * real, A, k), k, cuda)
    freqs = torch.zeros((n_t, A), dtype=torch.int64, device=cuda)
    cums = torch.zeros((n_t, A + 1), dtype=torch.int64, device=cuda)
    s2s = torch.zeros((n_t, 1 << k), dtype=torch.int16, device=cuda)
    for rows, src in ((slice(0, real), slice(0, real)), (slice(n_t - real, n_t), slice(real, 2 * real))):
        freqs[rows], cums[rows], s2s[rows] = small.freqs[src], small.cums[src], small.slot2sym[src]
    stack = rans.CoderTables(freqs, cums, s2s, k)
    n_lanes, n_sym = 256, 300
    t_idx = np.where(np.arange(n_lanes) % 2, n_t - real + rng.integers(0, real, n_lanes),
                     rng.integers(0, real, n_lanes)).astype(np.int32)
    t_idx[1] = n_t - 1  # its slots lie at [2^31, 2^31 + 4096): past any int32 offset
    assert int(t_idx.max()) << k >= 1 << 31
    local = np.where(t_idx >= n_t - real, t_idx - (n_t - real) + real, t_idx)  # row of ``small``
    syms = small.slot2sym.cpu().numpy()[local[:, None], rng.integers(0, 1 << k, size=(n_lanes, n_sym))].astype(np.int32)
    _held(cuda, stack, t_idx, syms)


def _tiny_codec(device):
    """A profiled codec for a 2-layer, 16-channel cache on the CPU and the
    same tables on ``device``."""
    rng = np.random.default_rng(9)
    L, C, T = 2, 16, 45
    kv = [np.cumsum(rng.normal(scale=0.3, size=(L, 2, T, C)), axis=2).astype(np.float32) for _ in range(2)]
    ct_cpu = codec.profile(kv, codec.CodecConfig(precision=11), device="cpu")
    ct = codec.tables_from_numpy(
        anchor=ct_cpu.anchor.freqs.numpy(), deltas={l: t.freqs.numpy() for l, t in ct_cpu.deltas.items()},
        ll_anchor=ct_cpu.ll_anchor.freqs.numpy(), ll_delta=ct_cpu.ll_delta.freqs.numpy(),
        table_idx=ct_cpu.table_idx, delta_scale=ct_cpu.delta_scale, config=ct_cpu.config,
        n_layers=L, n_channels=C, device=device)
    return kv, ct_cpu, ct


@pytest.mark.gpu
def test_cuda_encode_all_levels_byte_identical(cuda):
    kv, ct_cpu, ct = _tiny_codec(cuda)
    ops.reset_launch_counts()
    got = codec.encode_all_levels(kv[0], ct)
    assert ops.launch_counts()["rans_encode"] > 0
    assert got == codec.encode_all_levels(kv[0], ct_cpu)


@pytest.mark.gpu
def test_cuda_decode_chunks_matches_cpu(cuda):
    """Two K7 launches a call; level 0 bit for bit in f32, lossy levels
    within K1's f32 rule (2e-5)."""
    kv, ct_cpu, ct = _tiny_codec(cuda)
    blobs = codec.encode_all_levels(kv[1], ct_cpu)
    for levels in ([0], [0, 1, 3], [2, 4]):
        ops.reset_launch_counts()
        got = codec.decode_chunks([blobs[l] for l in levels], ct).cpu()
        assert ops.launch_counts()["rans_decode"] == 2
        want = codec.decode_chunks([blobs[l] for l in levels], ct_cpu)
        if levels == [0]:
            assert torch.equal(got, want)
        else:
            assert (got - want).abs().max() <= 2e-5
