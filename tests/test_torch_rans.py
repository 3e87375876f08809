"""The rANS coder's two scans (K7 decode, K8 encode): the plain versions
against the reference's jitted scans (``repro.core.rans._decode_impl`` /
``_encode_impl``) on the CPU, exactly, on stacked table sets as the codec
builds them; the wire's words and states through the card route's bit views;
the ragged cases; the CPU route through ``kernels.ops``; and the CUDA kernels
against the plain versions on the card (``-m gpu``), including a lane whose
cum row starts past 2^31 bytes, ``decode_chunks`` and ``encode_all_levels``."""
import numpy as np
import pytest
import torch

try:  # the reference; absent where only the port is installed (the card's machine)
    import jax.numpy as jnp
    from repro.core import bitstream as jbitstream
    from repro.core import rans as jrans
    from repro.core import tables as jtables
except ImportError:
    jnp = None

from repro_torch.core import bitstream, codec, rans, tables
from repro_torch.kernels import ops
from repro_torch.kernels import rans as krans
from repro_torch.kernels.rans import (
    MAX_ALPHABET,
    RANS_L,
    bitmap_symbol,
    guided_symbol,
    rans_decode_cuda,
    rans_decode_plain,
    rans_decode_wide_cuda,
    rans_encode_cuda,
    rans_encode_plain,
    rans_encode_wide_cuda,
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


def _compact(words, n_words):
    """A padded word matrix's valid words, lane-major (the wire's payload)."""
    return words[torch.arange(words.shape[1])[None, :] < n_words[:, None].to(torch.int64)], n_words


def _offsets(n_words):
    """Each lane's offset into the payload, as ``rans.decode_payload`` makes them."""
    held = n_words.to(torch.int64).clamp_min(0)
    return torch.cumsum(held, 0) - held


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
    # alphabets past K7's staged cap (1,743), as the card's wide kernels
    # take them: one past it, the codec's delta decode stack at delta_qmax
    # 1023 (padded, beside the lossless 509), 4,096 = 2**12 and 16,384 =
    # 2**14 (every symbol one slot)
    "A 1744": (10, 12, (1744,), 3, 20, 45),
    "A 2047, padded": (11, 12, (2047, 2047, 509), 2, 24, 40),
    "A 4096": (12, 12, (4096,), 2, 12, 33),
    "A 16384, k 14": (13, 14, (16384,), 2, 9, 30),
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
    payload, jn_t = _compact(torch.from_numpy(jw.view(np.int16)), torch.from_numpy(jn))
    s, xd, pd = rans_decode_plain(payload, jn_t, _offsets(jn_t), torch.from_numpy(jx.view(np.int32)),
                                  torch.from_numpy(t_idx), stack, n_sym)
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
    payload, _ = _compact(rans.wire_bits(w, 16, "cpu"), n)
    s, xd, pd = ops.rans_decode(payload, n, _offsets(n), rans.wire_bits(x, 32, "cpu"), t_t, stack, n_sym)
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
    payload = torch.zeros((4 * n_lanes,), dtype=torch.int16)
    n_words = torch.full((n_lanes,), 4, dtype=torch.int32)
    state = torch.full((n_lanes,), RANS_L, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        rans_decode_cuda(payload, n_words, _offsets(n_words), state, t_t, stack, n_sym)
    with pytest.raises(TypeError):  # words wider than the wire's 16 bits
        rans_decode_cuda(payload.to(torch.int32), n_words, _offsets(n_words), state, t_t, stack, n_sym)
    with pytest.raises(TypeError):  # a padded matrix, not the compact payload
        rans_decode_cuda(payload.reshape(n_lanes, 4), n_words, _offsets(n_words), state, t_t, stack, n_sym)
    assert (rans_decode_cuda.launches, rans_encode_cuda.launches) == before


def _joined_wire(seed, k, alphabets, n_t, lane_syms):
    """The wire arrays of several streams joined lane-major, as
    ``codec.decode_chunks`` joins a wave's chunks: one stream a ``(lanes,
    n_sym)`` entry of ``lane_syms``, all on one stacked table set.  Returns
    the stack, the joined ``payload``/``n_words``/``state``, the table index
    and the symbols a lane (its own ``n_sym``)."""
    rng = np.random.default_rng(seed)
    sets = [_freqs(rng, n_t, A, k) for A in alphabets]
    stack = rans.stack_tables([tables.build_coder_tables(f, k, "cpu") for f in sets],
                              pad_alphabet=len(set(alphabets)) > 1)
    arrays, t_all, syms = [], [], []
    for j, (n_lanes, n_sym) in enumerate(lane_syms):
        A_set = j % len(alphabets)
        t_idx = (A_set * n_t + rng.integers(0, n_t, n_lanes)).astype(np.int32)
        sym = stack.slot2sym.numpy()[t_idx[:, None], rng.integers(0, 1 << k, size=(n_lanes, n_sym))].astype(np.int32)
        w, n, x = rans.encode(sym, t_idx, stack)
        arrays.append(bitstream.pack_stream(w.numpy(), n.numpy(), x.numpy(), "d"))
        t_all.append(t_idx)
        syms.append(sym)
    joined = {key: np.concatenate([a[key] for a in arrays]) for key in arrays[0]}
    return sets, stack, joined, np.concatenate(t_all), syms


def _reference_decode(sets, stack, arrays, t_idx, n_sym, k, pad):
    """The reference's ``_decode_impl`` on its own ``unpack_stream``'s padded
    matrix of the wire arrays."""
    words, n_words, state = jbitstream.unpack_stream(arrays, "d")
    js = _reference(sets, pad, k)
    out = jrans._decode_impl(jnp.asarray(words), jnp.asarray(n_words), jnp.asarray(state), jnp.asarray(t_idx),
                             js.freqs, js.cums, js.slot2sym, precision=k, n_sym=n_sym)
    return [np.asarray(a).astype(np.int64) for a in out]


def _plain_compact(arrays, t_idx, stack, n_sym):
    payload = torch.from_numpy(arrays["d.payload"].view(np.int16).copy())
    n_words = torch.from_numpy(arrays["d.n_words"].astype(np.int32))
    state = torch.from_numpy(arrays["d.state"].astype(np.uint32).view(np.int32))
    return rans_decode_plain(payload, n_words, _offsets(n_words), state, torch.from_numpy(t_idx), stack, n_sym)


# joined streams: (seed, precision, alphabets, tables a set, ((lanes, symbols a lane) a stream))
COMPACT_CASES = {
    # lanes of one symbol emit no word: they decode on past their stream
    # through the padded matrix's column 0 (a 0), beside lanes with words
    "lanes with no word": (10, 12, (255,), 6, ((9, 1), (11, 40))),
    # a wave of chunks of three lengths on the padded decode stack: the short
    # chunks' lanes run out of words (their first word, then on)
    "chunks of different lengths": (11, 12, (255, 255, 509), 5, ((13, 77), (7, 154), (10, 21))),
    "k 14, one stream": (12, 14, (509,), 3, ((8, 64),)),
}


@pytest.mark.parametrize("case", list(COMPACT_CASES))
def test_compact_decode_matches_reference_on_padded_matrix(case):
    """The compact-payload plain decode (and ``rans.decode_payload``) equals
    the reference's ``_decode_impl`` on ``unpack_stream``'s padded matrix of
    the same wire arrays: symbols, final states and pointers."""
    seed, k, alphabets, n_t, lane_syms = COMPACT_CASES[case]
    sets, stack, arrays, t_idx, syms = _joined_wire(seed, k, alphabets, n_t, lane_syms)
    n_sym = max(n for _, n in lane_syms)
    js, jx, jp = _reference_decode(sets, stack, arrays, t_idx, n_sym, k, len(set(alphabets)) > 1)
    s, x, p = _plain_compact(arrays, t_idx, stack, n_sym)
    np.testing.assert_array_equal(s.numpy(), js)
    np.testing.assert_array_equal(x.numpy(), jx)
    np.testing.assert_array_equal(p.numpy(), jp)
    got = rans.decode_payload(arrays["d.payload"], arrays["d.n_words"], arrays["d.state"], t_idx, stack, n_sym)
    np.testing.assert_array_equal(got.numpy(), js)
    lo = 0
    for (n_lanes, n), sym in zip(lane_syms, syms):  # each stream's own symbols come back
        np.testing.assert_array_equal(s.numpy()[lo:lo + n_lanes, :n], sym)
        lo += n_lanes
    if case == "lanes with no word":
        assert not arrays["d.n_words"][:9].any() and arrays["d.n_words"][9:].all()
    if case == "chunks of different lengths":
        assert (p.numpy() < -1).any()  # pointers ran out


def test_compact_decode_of_a_flipped_word_matches_reference():
    """A corrupt stream (one word flipped) decodes to the reference's
    symbols, states and pointers all the same, and ``check`` raises."""
    seed, k, alphabets, n_t, lane_syms = COMPACT_CASES["chunks of different lengths"]
    sets, stack, arrays, t_idx, _ = _joined_wire(seed, k, alphabets, n_t, lane_syms)
    arrays = dict(arrays, **{"d.payload": arrays["d.payload"].copy()})
    arrays["d.payload"][len(arrays["d.payload"]) // 3] ^= 0x5A5A
    js, jx, jp = _reference_decode(sets, stack, arrays, t_idx, 154, k, True)
    s, x, p = _plain_compact(arrays, t_idx, stack, 154)
    np.testing.assert_array_equal(s.numpy(), js)
    np.testing.assert_array_equal(x.numpy(), jx)
    np.testing.assert_array_equal(p.numpy(), jp)
    with pytest.raises(ValueError, match="corrupt"):
        rans.decode_payload(arrays["d.payload"], arrays["d.n_words"], arrays["d.state"], t_idx, stack, 154,
                            check=True)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_decode_payload_refuses_a_short_payload(kind):
    """``n_words`` claiming more words than the payload holds raises before
    the decode, from host arrays and from tensors alike."""
    seed, k, alphabets, n_t, lane_syms = COMPACT_CASES["lanes with no word"]
    _, stack, arrays, t_idx, _ = _joined_wire(seed, k, alphabets, n_t, lane_syms)
    payload, n_words, state = arrays["d.payload"], arrays["d.n_words"].copy(), arrays["d.state"]
    n_words[-1] += 1
    if kind == "tensor":
        payload, n_words, state = (torch.from_numpy(payload.view(np.int16).copy()), torch.from_numpy(n_words),
                                   torch.from_numpy(state.view(np.int32).copy()))
    with pytest.raises(ValueError, match="corrupt"):
        rans.decode_payload(payload, n_words, state, t_idx, stack, 40)


def _one_symbol_tables(k, A, sym):
    """Tables whose one symbol ``sym`` holds all 2**k slots (the others have
    frequency 0), as ``np.repeat`` builds slot2sym."""
    freqs = np.zeros((2, A), np.int64)
    freqs[:, sym] = 1 << k
    cums = np.concatenate([np.zeros((2, 1), np.int64), np.cumsum(freqs, 1)], 1)
    s2s = np.stack([np.repeat(np.arange(A), f) for f in freqs]).astype(np.int16)
    return rans.CoderTables(torch.from_numpy(freqs), torch.from_numpy(cums), torch.from_numpy(s2s), k)


GUIDE_CASES = {
    "k 12, padded decode stack": (20, 12, (255, 255, 509)),
    "k 14, padded decode stack": (21, 14, (255, 509)),
    "k 12, anchors": (22, 12, (256,)),
    "k 10, small alphabet": (23, 10, (40,)),
}


@pytest.mark.parametrize("case", list(GUIDE_CASES) + ["one symbol of one", "one symbol of eight"])
def test_guided_search_matches_slot2sym_on_every_slot(case):
    """K7's search on the cum row (``guided_symbol``: guide, 16-entry window,
    moving on) gives slot2sym's symbol on every slot of every table, the
    alphabet padding's zero-frequency symbols included."""
    if case.startswith("one symbol"):
        k = 12
        stack = _one_symbol_tables(k, 1, 0) if case == "one symbol of one" else _one_symbol_tables(k, 8, 5)
    else:
        seed, k, alphabets = GUIDE_CASES[case]
        rng = np.random.default_rng(seed)
        stack = rans.stack_tables([tables.build_coder_tables(_freqs(rng, 6, A, k), k, "cpu") for A in alphabets],
                                  pad_alphabet=len(set(alphabets)) > 1)
        if len(set(alphabets)) > 1:  # the padding repeats c: zero-frequency symbols past each set's alphabet
            assert (stack.freqs == 0).any()
    slots = torch.arange(1 << k).expand(stack.n_tables, -1).contiguous()
    np.testing.assert_array_equal(guided_symbol(stack.cums, slots, k).numpy(), stack.slot2sym.to(torch.int64).numpy())


def _zero_gap_tables(rng, n_tables, A, k, device="cpu"):
    """Tables whose every other row has zero-frequency symbols between
    symbols that hold slots (their mass moved onto symbol 0): rows the wide
    K7 searches on the cum row instead of its bitmap."""
    f = _freqs(rng, n_tables, A, k)
    gaps = np.arange(1, A - 1, 3)
    for r in range(0, n_tables, 2):
        f[r, 0] += f[r, gaps].sum()
        f[r, gaps] = 0
    assert (f <= (1 << k) - 1).all()
    return tables.build_coder_tables(f, k, device)


# (seed, precision, alphabets of the stacked sets): the wide K7's alphabets
# (past K7's staged cap: the codec's 2,047-symbol decode stack at delta_qmax
# 1023, padded beside the lossless 509; 4,096 = 2**12; 16,384 = 2**14, every
# symbol one slot, so every bit of a word is a start), one below it, and a
# precision below one 64-slot word
BITMAP_CASES = {
    "A 2047, padded": (30, 12, (2047, 2047, 509)),
    "A 4096": (31, 12, (4096,)),
    "A 16384, k 14": (32, 14, (16384,)),
    "A 509, k 13": (33, 13, (509,)),
    "A 20, k 5": (34, 5, (20,)),
}


@pytest.mark.parametrize("case", list(BITMAP_CASES) + ["one symbol of one", "one symbol of eight",
                                                     "zero-frequency gaps"])
def test_bitmap_search_matches_slot2sym_on_every_slot(case):
    """The wide K7's search (``bitmap_symbol``: a bitmap of the symbols'
    starts, ranks and the starts around each 64-slot word) gives slot2sym's
    symbol and its c[s], c[s + 1] on every slot of every table; rows with a
    zero-frequency symbol before a start are searched on the cum row, and
    equal too."""
    if case.startswith("one symbol"):
        k = 12
        stack = _one_symbol_tables(k, 1, 0) if case == "one symbol of one" else _one_symbol_tables(k, 8, 5)
    elif case == "zero-frequency gaps":
        k = 12
        stack = _zero_gap_tables(np.random.default_rng(35), 6, 2047, k)
    else:
        seed, k, alphabets = BITMAP_CASES[case]
        rng = np.random.default_rng(seed)
        stack = rans.stack_tables([tables.build_coder_tables(_freqs(rng, 4, A, k), k, "cpu") for A in alphabets],
                                  pad_alphabet=len(set(alphabets)) > 1)
    slots = torch.arange(1 << k).expand(stack.n_tables, -1).contiguous()
    s, cs, cn = bitmap_symbol(stack.cums, slots, k)
    want = stack.slot2sym.to(torch.int64)
    np.testing.assert_array_equal(s.numpy(), want.numpy())
    np.testing.assert_array_equal(cs.numpy(), torch.gather(stack.cums, 1, want).numpy())
    np.testing.assert_array_equal(cn.numpy(), torch.gather(stack.cums, 1, want + 1).numpy())


def _emitted_plus_tail(symbols, t_idx, tables_, n_sym):
    """K8's rule for its word buffer, in torch: a zero buffer that holds each
    emitted word at its ptr and, after the loop, the last step's word at the
    final ptr when that step did not emit."""
    n_lanes = symbols.shape[0]
    k = tables_.precision
    A = tables_.alphabet
    t = torch.from_numpy(t_idx).to(torch.int64)
    x = torch.full((n_lanes,), RANS_L, dtype=torch.int64)
    ptr = torch.zeros(n_lanes, dtype=torch.int64)
    buf = torch.zeros((n_lanes, n_sym), dtype=torch.int64)
    lanes = torch.arange(n_lanes)
    emit = torch.ones(n_lanes, dtype=torch.bool)
    word = torch.zeros(n_lanes, dtype=torch.int64)
    for i in reversed(range(n_sym)):
        s = torch.from_numpy(symbols[:, i]).to(torch.int64)
        c = tables_.cums.reshape(-1)[t * (A + 1) + s]
        f = tables_.cums.reshape(-1)[t * (A + 1) + s + 1] - c
        word = x & 0xFFFF
        emit = (x >> (32 - k)) >= f
        buf[lanes[emit], ptr[emit]] = word[emit]
        ptr += emit
        x = torch.where(emit, x >> 16, x)
        q = x // f
        x = (q << k) + (x - q * f) + c
    tail = ~emit if n_sym else torch.zeros(n_lanes, dtype=torch.bool)
    buf[lanes[tail], ptr[tail]] = word[tail]
    return buf, ptr, x


@pytest.mark.parametrize("case", ["one set", "decode stack, padded", "n_sym 1", "k 14"])
def test_emitted_words_plus_tail_equal_reference_buffer(case):
    """K8 writes only the emitted words and the last step's word at the
    final ptr when that step did not emit; that rule gives the reference's
    buffer element for element, its unused tail included."""
    seed, k, alphabets, n_t, n_lanes, n_sym = CASES[case]
    sets, pad, stack, t_idx, syms = _world(seed, k, alphabets, n_t, n_lanes, n_sym)
    if pad:  # encode on the unpadded sets' own tables, as the store path does
        stack = tables.build_coder_tables(sets[-1], k, "cpu")
        sets, pad = sets[-1:], False
        t_idx = t_idx % n_t
        syms = stack.slot2sym.numpy()[t_idx[:, None], np.random.default_rng(seed).integers(0, 1 << k, size=syms.shape)]
        syms = syms.astype(np.int32)
    jstack = _reference(sets, pad, k)
    jw, jn, jx = jrans._encode_impl(jnp.asarray(syms), jnp.asarray(t_idx), jstack.freqs, jstack.cums, precision=k)
    buf, ptr, x = _emitted_plus_tail(syms, t_idx, stack, n_sym)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jw).astype(np.int64))
    np.testing.assert_array_equal(ptr.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx).astype(np.int64))


def _tiny_codec_cpu():
    rng = np.random.default_rng(9)
    L, C, T = 2, 16, 45
    kv = [np.cumsum(rng.normal(scale=0.3, size=(L, 2, T, C)), axis=2).astype(np.float32) for _ in range(2)]
    return kv, codec.profile(kv, codec.CodecConfig(precision=11), device="cpu")


def test_decode_paths_read_the_compact_payload(monkeypatch):
    """``decode_chunks`` and ``decode_chunk`` hand the coder the wire's
    payload as it is: ``unpack_stream`` is never called, every K7 call gets a
    1-d payload (no ``(n_lanes, cap)`` matrix), and ``decode_chunks`` makes
    exactly two calls; the results are those of before."""
    kv, ct = _tiny_codec_cpu()
    blobs = codec.encode_all_levels(kv[1], ct)
    levels = [0, 2, 4, 1]
    want_many = codec.decode_chunks([blobs[l] for l in levels], ct)
    want_one = [codec.decode_chunk(blobs[l], ct) for l in levels]

    def refuse(*args, **kwargs):
        raise AssertionError("the decode path built a padded word matrix")

    calls = []
    real = ops.rans_decode

    def spy(payload, n_words, offsets, *args):
        assert payload.ndim == 1 and offsets.dtype == torch.int64
        calls.append(payload.numel())
        return real(payload, n_words, offsets, *args)

    monkeypatch.setattr(bitstream, "unpack_stream", refuse)
    monkeypatch.setattr(codec.bitstream, "unpack_stream", refuse)
    monkeypatch.setattr(ops, "rans_decode", spy)
    got = codec.decode_chunks([blobs[l] for l in levels], ct)
    assert len(calls) == 2 and torch.equal(got, want_many)
    for l, want in zip(levels, want_one):
        assert torch.equal(codec.decode_chunk(blobs[l], ct), want)
    assert len(calls) == 2 + 2 * len(levels)


# ---------------------------------------------------------------------------
# K7 and K8 against the plain versions (on the card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _held(cuda, stack, t_idx, syms, wide=None):
    """K8 and then K7 on the card equal their plain versions there, word for
    word and symbol for symbol, and K7 inverts K8: each the kernel that
    ``kernels.ops`` picks for the alphabet, or the wide ones (``wide``)."""
    A = stack.freqs.shape[1]
    encode = rans_encode_wide_cuda if wide else krans.encode_kernel(A)
    decode = rans_decode_wide_cuda if wide else krans.decode_kernel(A)
    t_t = torch.as_tensor(t_idx, device=cuda)
    sym_t = torch.as_tensor(syms, device=cuda)
    before = (encode.launches, decode.launches)
    got, want = encode(sym_t, t_t, stack), rans_encode_plain(sym_t, t_t, stack)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    w, n, x = got
    assert w.is_contiguous()  # lane-major, as the plain version's
    payload = rans.wire_bits(w, 16, w.device)[torch.arange(w.shape[1], device=cuda)[None, :] < n[:, None]]
    args = (payload, n, _offsets(n), rans.wire_bits(x, 32, x.device), t_t, stack, syms.shape[1])
    got, want = decode(*args), rans_decode_plain(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(got[0], sym_t) and bool((got[1] == RANS_L).all()) and bool((got[2] == -1).all())
    assert (encode.launches, decode.launches) == (before[0] + 1, before[1] + 1)


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
@pytest.mark.parametrize("case", CUDA_CASES + [(14, 12, (2047,), 16, 20_481, 154), (15, 14, (16384,), 4, 4_160, 300)])
def test_cuda_wide_rans_matches_plain(cuda, case):
    """The wide kernels at every case, below the staged cap too, and at the
    wide alphabets over many lanes."""
    seed, k, alphabets, n_t, n_lanes, n_sym = case
    _, _, stack, t_idx, syms = _world(seed, k, alphabets, n_t, n_lanes, n_sym, device=cuda)
    _held(cuda, stack, t_idx, syms, wide=True)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(COMPACT_CASES) + ["a flipped word"])
def test_cuda_compact_decode_matches_plain(cuda, case):
    """K7 on the wire's joined compact payloads (lanes without words, chunks
    of different lengths whose lanes run out of words, a flipped word) equals
    its plain version symbol for symbol, state for state."""
    seed, k, alphabets, n_t, lane_syms = COMPACT_CASES["chunks of different lengths" if case == "a flipped word"
                                                       else case]
    _, stack, arrays, t_idx, _ = _joined_wire(seed, k, alphabets, n_t, lane_syms)
    if case == "a flipped word":
        arrays = dict(arrays, **{"d.payload": arrays["d.payload"].copy()})
        arrays["d.payload"][len(arrays["d.payload"]) // 3] ^= 0x5A5A
    stack = rans.CoderTables(*(t.to(cuda) for t in stack[:3]), k)
    n_sym = max(n for _, n in lane_syms)
    payload = rans.wire_bits(arrays["d.payload"], 16, cuda)
    n_words = torch.as_tensor(arrays["d.n_words"], device=cuda)
    args = (payload, n_words, _offsets(n_words), rans.wire_bits(arrays["d.state"], 32, cuda),
            torch.as_tensor(t_idx, device=cuda), stack, n_sym)
    for g, w in zip(rans_decode_cuda(*args), rans_decode_plain(*args)):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(COMPACT_CASES) + ["a flipped word"])
def test_cuda_wide_compact_decode_matches_plain(cuda, case):
    """The wide K7 on the wire's joined compact payloads (lanes with no
    word, chunks whose lanes run out of words, precision 14, a flipped
    word) equals its plain version symbol for symbol, state for state."""
    seed, k, alphabets, n_t, lane_syms = COMPACT_CASES["chunks of different lengths" if case == "a flipped word"
                                                       else case]
    _, stack, arrays, t_idx, _ = _joined_wire(seed, k, alphabets, n_t, lane_syms)
    if case == "a flipped word":
        arrays = dict(arrays, **{"d.payload": arrays["d.payload"].copy()})
        arrays["d.payload"][len(arrays["d.payload"]) // 3] ^= 0x5A5A
    stack = rans.CoderTables(*(t.to(cuda) for t in stack[:3]), k)
    n_sym = max(n for _, n in lane_syms)
    payload = rans.wire_bits(arrays["d.payload"], 16, cuda)
    n_words = torch.as_tensor(arrays["d.n_words"], device=cuda)
    args = (payload, n_words, _offsets(n_words), rans.wire_bits(arrays["d.state"], 32, cuda),
            torch.as_tensor(t_idx, device=cuda), stack, n_sym)
    before = rans_decode_wide_cuda.launches
    for g, w in zip(rans_decode_wide_cuda(*args), rans_decode_plain(*args)):
        assert torch.equal(g, w)
    assert rans_decode_wide_cuda.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("A", [1, 8, 2047])
def test_cuda_wide_decode_searches_zero_frequency_rows(cuda, A):
    """Rows with a zero-frequency symbol before a start (one symbol holding
    every slot past zero-frequency ones; 2,047-symbol rows with gaps, every
    other row, beside rows without) take the wide K7's search on the cum
    row, and the kernels still equal their plain versions and invert each
    other."""
    if A == 2047:
        stack = _zero_gap_tables(np.random.default_rng(36), 8, A, 12, cuda)
        rng = np.random.default_rng(37)
        t_idx = rng.integers(0, 8, 300).astype(np.int32)
        syms = stack.slot2sym.cpu().numpy()[t_idx[:, None], rng.integers(0, 1 << 12, size=(300, 200))]
        syms = syms.astype(np.int32)
    else:
        sym = A - 3 if A > 1 else 0
        stack = rans.CoderTables(*(t.to(cuda) for t in _one_symbol_tables(12, A, sym)[:3]), 12)
        t_idx = np.arange(70, dtype=np.int32) % 2
        syms = np.full((70, 33), sym, np.int32)
    _held(cuda, stack, t_idx, syms, wide=True)


@pytest.mark.gpu
@pytest.mark.parametrize("A, sym", [(1, 0), (8, 5)])
def test_cuda_rans_one_symbol_holds_every_slot(cuda, A, sym):
    """Tables whose one symbol holds all 2^k slots: K8 never emits (its
    overflow bound is 2^32), K7's search lands on that symbol past the
    zero-frequency ones."""
    stack = rans.CoderTables(*(t.to(cuda) for t in _one_symbol_tables(12, A, sym)[:3]), 12)
    t_idx = np.arange(70, dtype=np.int32) % 2
    _held(cuda, stack, t_idx, np.full((70, 33), sym, np.int32))


@pytest.mark.gpu
def test_cuda_staged_cum_entry_off_by_one_breaks_equality(cuda):
    """The kernels read the cum rows they stage: one entry off by one in one
    table changes K7's symbols and K8's words against the plain versions on
    the true tables."""
    seed, k, alphabets, n_t, n_lanes, n_sym = CUDA_CASES[-2]
    _, _, stack, t_idx, syms = _world(seed, k, alphabets, n_t, n_lanes, n_sym, device=cuda)
    t_t, sym_t = torch.as_tensor(t_idx, device=cuda), torch.as_tensor(syms, device=cuda)
    t0 = int(t_idx[0])
    s_hot = int(stack.freqs[t0].argmax())
    bad_cums = stack.cums.clone()
    bad_cums[t0, max(s_hot, 1)] += 1
    bad = rans.CoderTables(stack.freqs, bad_cums, stack.slot2sym, k)
    w, n, x = rans_encode_plain(sym_t, t_t, stack)
    assert not torch.equal(rans_encode_cuda(sym_t, t_t, bad)[0], w)
    payload = rans.wire_bits(w, 16, cuda)[torch.arange(w.shape[1], device=cuda)[None, :] < n[:, None]]
    args = (payload, n, _offsets(n), rans.wire_bits(x, 32, cuda), t_t)
    assert not torch.equal(rans_decode_cuda(*args, bad, n_sym)[0], rans_decode_plain(*args, stack, n_sym)[0])


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


def test_alphabet_cap_is_one_block_of_staged_rows():
    """The shape rule that picks K7's and K8's kernel: the staged one up to
    the widest alphabet whose rows fill a block's 227 KB (one symbol more
    does not fit), the wide one past it, up to 2**14.  The codec's default
    delta stacks stay staged; at ``delta_qmax`` 1023 its 2,047-symbol
    stacks take the wide kernels, its anchors the staged ones."""
    assert MAX_ALPHABET == {"decode": 1743, "encode": 1807}
    for kind, A in MAX_ALPHABET.items():
        assert krans._smem_bytes(kind, A) <= 232448 < krans._smem_bytes(kind, A + 1)
    for A in (1, 256, 509, 1743):
        assert krans.decode_kernel(A) is rans_decode_cuda
    for A in (1744, 2047, 4096, 16384):
        assert krans.decode_kernel(A) is rans_decode_wide_cuda
    for A in (1, 1743, 1807):
        assert krans.encode_kernel(A) is rans_encode_cuda
    for A in (1808, 2047, 16384):
        assert krans.encode_kernel(A) is rans_encode_wide_cuda
    assert {ops.KERNELS[n] for n in ("rans_decode", "rans_decode_wide", "rans_encode", "rans_encode_wide")} == {
        rans_decode_cuda, rans_decode_wide_cuda, rans_encode_cuda, rans_encode_wide_cuda}
    assert krans.decode_kernel(codec.CodecConfig().delta_alphabet) is rans_decode_cuda
    assert krans.encode_kernel(codec.CodecConfig().delta_alphabet) is rans_encode_cuda
    wide = codec.CodecConfig(delta_qmax=1023)
    assert wide.delta_alphabet == 2047
    assert krans.decode_kernel(wide.delta_alphabet) is rans_decode_wide_cuda
    assert krans.encode_kernel(wide.delta_alphabet) is rans_encode_wide_cuda
    assert krans.decode_kernel(256) is rans_decode_cuda  # the anchors


@pytest.mark.gpu
def test_cuda_rans_at_the_widest_alphabet(cuda):
    """At K7's widest staged alphabet (its block's rows fill 227 KB) both
    staged kernels equal their plain versions; one symbol wider,
    ``kernels.ops`` runs the wide K7 (and the staged K8), equal to the plain
    versions, and the staged K7 raises without a launch."""
    A = MAX_ALPHABET["decode"]
    _, _, stack, t_idx, syms = _world(13, 12, (A,), 4, 200, 64, device=cuda)
    _held(cuda, stack, t_idx, syms)
    _, _, wide, t_w, s_w = _world(14, 12, (A + 1,), 2, 8, 16, device=cuda)
    t_t, s_t = torch.as_tensor(t_w, device=cuda), torch.as_tensor(s_w, device=cuda)
    before = ops.launch_counts()
    w, n, x = ops.rans_encode(s_t, t_t, wide)
    for g, want in zip((w, n, x), rans_encode_plain(s_t, t_t, wide)):
        assert torch.equal(g, want)
    payload = rans.wire_bits(w, 16, cuda)[torch.arange(w.shape[1], device=cuda)[None, :] < n[:, None]]
    args = (payload, n, _offsets(n), rans.wire_bits(x, 32, cuda), t_t, wide, 16)
    got = ops.rans_decode(*args)
    for g, want in zip(got, rans_decode_plain(*args)):
        assert torch.equal(g, want)
    assert torch.equal(got[0], s_t)
    after = ops.launch_counts()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == {
        "rans_encode": 1, "rans_decode_wide": 1}
    with pytest.raises(ValueError, match="alphabet"):
        rans_decode_cuda(*args)
    assert ops.launch_counts() == after


@pytest.mark.gpu
def test_cuda_rans_table_past_2_31_slots(cuda):
    """Lanes whose cum row starts past 2^31 bytes, the only table offset the
    kernels compute, and lanes at the stack's start: an alphabet-padded stack
    (509 symbols, 510 int64 cums a row) of 526,346 tables, full-alphabet
    tables at its start and padded 255-symbol ones at its end.  The kernels
    index the tables in 64 bits, as the plain versions do."""
    k, real = 12, 16
    A = 509
    n_t = -(-(1 << 31) // ((A + 1) * 8)) + 1
    rng = np.random.default_rng(8)
    small = rans.stack_tables([tables.build_coder_tables(_freqs(rng, real, a, k), k, cuda) for a in (A, 255)],
                              pad_alphabet=True)
    freqs = torch.zeros((n_t, A), dtype=torch.int64, device=cuda)
    cums = torch.zeros((n_t, A + 1), dtype=torch.int64, device=cuda)
    s2s = torch.zeros((n_t, 1 << k), dtype=torch.int16, device=cuda)
    for rows, src in ((slice(0, real), slice(0, real)), (slice(n_t - real, n_t), slice(real, 2 * real))):
        freqs[rows], cums[rows], s2s[rows] = small.freqs[src], small.cums[src], small.slot2sym[src]
    stack = rans.CoderTables(freqs, cums, s2s, k)
    n_lanes, n_sym = 256, 300
    t_idx = np.where(np.arange(n_lanes) % 2, n_t - real + rng.integers(0, real, n_lanes),
                     rng.integers(0, real, n_lanes)).astype(np.int32)
    t_idx[1] = n_t - 1  # its cum row starts past 2^31 bytes: past any int32 byte offset
    assert int(t_idx.max()) * (A + 1) * 8 >= 1 << 31
    local = np.where(t_idx >= n_t - real, t_idx - (n_t - real) + real, t_idx)  # row of ``small``
    syms = small.slot2sym.cpu().numpy()[local[:, None], rng.integers(0, 1 << k, size=(n_lanes, n_sym))].astype(np.int32)
    _held(cuda, stack, t_idx, syms)


@pytest.mark.gpu
def test_cuda_wide_rans_table_past_2_31_bytes(cuda):
    """The wide kernels index the tables in 64 bits: lanes whose cum row
    starts past 2^31 bytes in a stack of 2,047-symbol tables (2,048 int64
    cums a row, 131,073 tables; their slot2sym rows past 2^30 bytes), and
    lanes at its start."""
    k, real, A = 12, 16, 2047
    n_t = -(-(1 << 31) // ((A + 1) * 8)) + 1
    rng = np.random.default_rng(16)
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
    t_idx[1] = n_t - 1
    assert int(t_idx.max()) * (A + 1) * 8 >= 1 << 31
    local = np.where(t_idx >= n_t - real, t_idx - (n_t - real) + real, t_idx)
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
