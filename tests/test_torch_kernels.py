"""The port's kernels: plain versions against the reference's Pallas kernels
(interpret mode) and ``kernels/ref.py`` oracles on the CPU, and the CUDA
kernels against the plain versions on the card (``-m gpu``)."""
import numpy as np
import pytest
import torch

try:  # the reference; absent where only the port is installed (the card's machine)
    import jax.numpy as jnp
    from repro.kernels import ref
    from repro.kernels.decode_attention import decode_attention_pallas
    from repro.kernels.flash_attention import flash_attention_pallas
    from repro.kernels.kvquant import (
        kv_dequant_pallas,
        kv_dequant_tokens_pallas,
        kv_lossless_tokens_pallas,
        kv_quant_pallas,
    )
except ImportError:
    jnp = None

from repro_torch.kernels import ops, timing
from repro_torch.kernels.decode_attention import (
    TILE,
    decode_attention_cuda,
    decode_attention_plain,
    split_size,
)
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda,
    flash_attention_magnitude,
    flash_attention_plain,
)
from repro_torch.kernels.kvquant import (
    kv_dequant_cuda,
    kv_dequant_plain,
    kv_dequant_tokens_cuda,
    kv_dequant_tokens_plain,
    kv_lossless_tokens_cuda,
    kv_lossless_tokens_plain,
    kv_quant_cuda,
    kv_quant_plain,
    vector_width,
)

torch.set_num_threads(1)

TOL = 2e-5  # f32, as tests/test_kernels.py


@pytest.fixture(autouse=True)
def _needs_reference(request):
    if jnp is None and "gpu" not in request.keywords:
        pytest.skip("needs the JAX reference package")


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a, dtype=None):
    t = torch.as_tensor(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32))


# ---------------------------------------------------------------------------
# K1 / K2 (CPU: plain vs Pallas interpret vs ref)
# ---------------------------------------------------------------------------

# (B, G, g-1, C, block_groups): G=5 and G=7 are not multiples of the block
KV_CASES = [(3, 5, 9, 64, 4), (2, 7, 3, 32, 8), (1, 1, 9, 16, 8)]


def _dequant_inputs(seed, B, G, gm1, C, qmax=127):
    r = _rng(seed)
    d = r.integers(0, 2 * qmax + 1, size=(B, G, gm1, C)).astype(np.uint16)
    a = r.normal(size=(B, G, C)).astype(np.float32)
    bins = r.uniform(0.01, 0.2, size=(B,)).astype(np.float32)
    return d, a, bins


@pytest.mark.parametrize("case", KV_CASES)
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_dequant_tokens_plain_matches_pallas(case, out_dtype):
    B, G, gm1, C, bg = case
    d, a, bins = _dequant_inputs(sum(case), B, G, gm1, C)
    jdt, tdt = (jnp.float32, torch.float32) if out_dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    got = ops.kv_dequant_tokens(_t(d), _t(a), _t(bins), qmax=127, out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == (B, G, gm1 + 1, C)
    pal = kv_dequant_tokens_pallas(jnp.asarray(d), jnp.asarray(a), jnp.asarray(bins), qmax=127,
                                   out_dtype=jdt, block_groups=bg, interpret=True)
    oracle = ref.kv_dequant_tokens_ref(jnp.asarray(d), jnp.asarray(a), jnp.asarray(bins), qmax=127,
                                       out_dtype=jdt)
    tol = TOL if out_dtype == "float32" else 2e-2
    for want in (pal, oracle):
        np.testing.assert_allclose(_f32(got), np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", KV_CASES)
def test_lossless_tokens_plain_bit_exact_with_pallas(case):
    B, G, gm1, C, bg = case
    r = _rng(10 + sum(case))
    d = r.integers(0, 509, size=(B, G, gm1, C)).astype(np.uint16)
    a = r.integers(1, 256, size=(B, G, C)).astype(np.uint16)
    s = (r.uniform(1e-3, 0.05, size=(B, G)).astype(np.float16)).astype(np.float32)
    got = ops.kv_lossless_tokens(_t(d), _t(a), _t(s), out_dtype=torch.float32)
    pal = kv_lossless_tokens_pallas(jnp.asarray(d), jnp.asarray(a), jnp.asarray(s),
                                    out_dtype=jnp.float32, block_groups=bg, interpret=True)
    oracle = ref.kv_lossless_tokens_ref(jnp.asarray(d), jnp.asarray(a), jnp.asarray(s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pal))
    np.testing.assert_array_equal(got.numpy(), np.asarray(oracle))


# ---------------------------------------------------------------------------
# K5 / K6 (CPU: plain vs Pallas interpret vs ref)
# ---------------------------------------------------------------------------


def _quant_inputs(seed, B, G, g, C, qmax=127):
    """Token-correlated groups, plus planted exact half-bin deltas (which
    round half to even) and deltas past +-qmax bins (which clip)."""
    r = _rng(seed)
    kv = np.cumsum(r.normal(size=(B, G, g, C)), axis=2).astype(np.float32)
    bins = r.uniform(0.05, 0.5, size=(B,)).astype(np.float32)
    bins[0] = 0.25  # row 0: every planted value and delta is exact in f32
    ties = (np.arange(C) % 16 - 8 + 0.5) * 0.25  # k + 1/2 bins
    kv[0, :, 1:] = kv[0, :, :1] + ties
    if g > 2:
        kv[0, 0, 2] = kv[0, 0, 0] + np.where(np.arange(C) % 2, 1.0, -1.0) * (qmax + 30) * 0.25
    return kv, bins


# (B, G, g, C, block_groups): G = 7 and 5 fit no block; g = 1 has no deltas
QUANT_CASES = [(3, 7, 10, 64, 4), (2, 5, 4, 32, 8), (1, 1, 10, 16, 8), (2, 3, 1, 16, 2)]


@pytest.mark.parametrize("case", QUANT_CASES)
def test_quant_plain_bit_exact_with_pallas(case):
    B, G, g, C, bg = case
    kv, bins = _quant_inputs(sum(case), B, G, g, C)
    got = ops.kv_quant(_t(kv), _t(bins), qmax=127)
    assert got.dtype == torch.uint16 and tuple(got.shape) == (B, G, g - 1, C)
    got = got.to(torch.int32).numpy()
    if g > 1:  # the Pallas kernel takes no empty block
        pal = kv_quant_pallas(jnp.asarray(kv), jnp.asarray(bins), qmax=127, block_groups=bg, interpret=True)
        np.testing.assert_array_equal(got, np.asarray(pal).astype(np.int32))
    np.testing.assert_array_equal(got, np.asarray(ref.kv_quant_ref(jnp.asarray(kv), jnp.asarray(bins), qmax=127)))
    if g > 2:  # ties went to even (0.5 -> 0, -0.5 -> 0, 1.5 -> 2), clips to the ends
        want = np.clip(np.round((kv[0, :, 1:] - kv[0, :, :1]) / np.float32(0.25)), -127, 127) + 127
        np.testing.assert_array_equal(got[0], want.astype(np.int32))
        assert {0, 254} <= set(got[0, 0, 1].tolist())


@pytest.mark.parametrize("case", KV_CASES)
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_dequant_plain_matches_pallas(case, out_dtype):
    B, G, gm1, C, bg = case
    d, a, bins = _dequant_inputs(3 + sum(case), B, G, gm1, C)
    jdt, tdt = (jnp.float32, torch.float32) if out_dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    got = ops.kv_dequant(_t(d), _t(a), _t(bins), qmax=127, out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == (B, G, gm1, C)
    pal = kv_dequant_pallas(jnp.asarray(d), jnp.asarray(a), jnp.asarray(bins), qmax=127,
                            out_dtype=jdt, block_groups=bg, interpret=True)
    oracle = ref.kv_dequant_ref(jnp.asarray(d), jnp.asarray(a), jnp.asarray(bins), qmax=127, out_dtype=jdt)
    for want in (pal, oracle):
        want = torch.as_tensor(np.array(want, np.float32))
        if out_dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)
        else:
            assert ops.bf16_ulp_excess(got, want, **ops.BF16_TOL["kv_dequant"]) <= 1


@pytest.mark.parametrize("fault", ["anchor off by one bin", "channels 2 and 3 swapped"])
def test_dequant_tokens_rule_catches_planted_faults(fault):
    """K1's rule at the main path's shape rejects the faults a vectorized
    kernel can make: a wrong anchor, two channels of one vector exchanged."""
    d, a, bins = _dequant_inputs(6, 4, 154, 9, 320)
    want = ops.kv_dequant_tokens(_t(d), _t(a), _t(bins), qmax=127)
    if fault == "anchor off by one bin":
        a[2, 7] += bins[2]
        bad = ops.kv_dequant_tokens(_t(d), _t(a), _t(bins), qmax=127)
    else:
        bad = want.clone()
        bad[..., [2, 3]] = want[..., [3, 2]]
    tol = ops.BF16_TOL["kv_dequant_tokens"]
    assert ops.bf16_ulp_excess(want, want.float(), **tol) <= 0.5
    assert ops.bf16_ulp_excess(bad, want, **tol) > 1


def _at_offset(t, offset):
    """A contiguous copy of ``t`` starting ``offset`` elements into its buffer."""
    if not offset:
        return t
    return torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)[offset:].view(t.shape).copy_(t)


@pytest.mark.parametrize("C,offset,itemsize,want", [
    (320, 0, 4, 8), (320, 0, 2, 8), (64, 0, 4, 8), (16, 0, 2, 8),
    (36, 0, 4, 4), (10, 0, 4, 2), (5, 0, 4, 1), (5, 0, 2, 1),
    (320, 1, 4, 1), (320, 2, 4, 2), (320, 4, 4, 8),  # f32 views 4, 8 and 16 bytes in
    (320, 1, 2, 1), (320, 2, 2, 2), (320, 4, 2, 4), (320, 8, 2, 8),  # uint16 views
])
def test_vector_width_follows_channels_and_alignment(C, offset, itemsize, want):
    """K1/K5 move V = 8 channels an access (16 bytes) where C and every
    pointer allow, else the widest narrower V; an aligned tensor beside a
    misaligned one does not widen it."""
    dtype = torch.float32 if itemsize == 4 else torch.uint16
    aligned = torch.zeros(2, 3, C)
    assert aligned.data_ptr() % 16 == 0
    view = _at_offset(torch.zeros(2, 3, C, dtype=dtype), offset)
    assert view.is_contiguous() and view.data_ptr() % 16 == offset * itemsize % 16
    assert vector_width(C, view) == want
    assert vector_width(C, aligned, view) == want


@pytest.mark.parametrize("out_dtype,offset,want", [
    (torch.float32, 0, 4), (torch.bfloat16, 0, 8),  # one 16-byte store a slot
    (torch.float32, 1, 1), (torch.bfloat16, 1, 1),
    (torch.float32, 2, 2), (torch.bfloat16, 2, 2),
    (torch.float32, 4, 4), (torch.bfloat16, 4, 4),
])
def test_vector_width_of_lossless_tokens_mix(out_dtype, offset, want):
    """K2 reads two uint16 inputs and writes f32 or bf16: the symbols'
    offset narrows V, and an f32 output stores at most 4 channels (16
    bytes) an access."""
    B, G, gm1, C = 2, 3, 9, 320
    d = _at_offset(torch.zeros(B, G, gm1, C, dtype=torch.uint16), offset)
    a = _at_offset(torch.zeros(B, G, C, dtype=torch.uint16), offset)
    out = torch.empty(B, G, gm1 + 1, C, dtype=out_dtype)
    assert out.data_ptr() % 16 == 0
    assert vector_width(C, d, a, out=out) == want
    assert vector_width(C, d, a) == (8 if offset == 0 else want)


def test_dequant_rule_catches_an_anchor_off_by_one_bin():
    d, a, bins = _dequant_inputs(5, 4, 154, 9, 320)
    want = ops.kv_dequant(_t(d), _t(a), _t(bins), qmax=127)
    a[2, 7] += bins[2]
    bad = ops.kv_dequant(_t(d), _t(a), _t(bins), qmax=127)
    tol = ops.BF16_TOL["kv_dequant"]
    assert ops.bf16_ulp_excess(want, want.float(), **tol) <= 0.5
    assert ops.bf16_ulp_excess(bad, want, **tol) > 1


# ---------------------------------------------------------------------------
# K3 (CPU)
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, S, D, kv_len, block_s)
DECODE_CASES = [
    (3, 4, 2, 64, 32, [0, 17, 64], 32),  # GQA, an empty row, a full row
    (2, 6, 2, 96, 32, [1, 95], 32),  # rep 3, as smollm-360m
    (1, 4, 4, 32, 64, [30], 32),  # MHA
    (2, 8, 1, 64, 256, [0, 41], 32),  # paligemma-3b: MQA 8:1, head dim 256
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_plain_matches_pallas(case):
    B, Hq, Hkv, S, D, kv_len, bs = case
    r = _rng(S + Hq)
    q = r.normal(size=(B, Hq, D)).astype(np.float32)
    k = r.normal(size=(B, S, Hkv, D)).astype(np.float32)  # the port's cache layout
    v = r.normal(size=(B, S, Hkv, D)).astype(np.float32)
    lens = np.asarray(kv_len, np.int32)
    got = ops.decode_attention(_t(q), _t(k), _t(v), _t(lens)).numpy()
    kh, vh = jnp.asarray(k.transpose(0, 2, 1, 3)), jnp.asarray(v.transpose(0, 2, 1, 3))
    pal = np.asarray(decode_attention_pallas(jnp.asarray(q), kh, vh, jnp.asarray(lens),
                                             block_s=bs, interpret=True))
    np.testing.assert_allclose(got, pal, atol=TOL, rtol=TOL)
    live = lens > 0  # the oracle's softmax over an empty row is NaN
    oracle = np.asarray(ref.decode_attention_ref(jnp.asarray(q), kh, vh, kv_len=jnp.asarray(lens)))
    np.testing.assert_allclose(got[live], oracle[live], atol=TOL, rtol=TOL)
    assert not got[~live].any()


# ---------------------------------------------------------------------------
# K4 (CPU)
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, Tq, Tk, D, causal, prefix, block)
FLASH_CASES = [
    (2, 4, 2, 64, 64, 32, True, None, 16),  # GQA causal
    (1, 6, 2, 32, 64, 32, True, None, 16),  # Tq < Tk: decoder offset
    (2, 2, 1, 64, 64, 64, True, [10, 50], 16),  # prefix-LM
    (1, 2, 2, 48, 48, 32, False, None, 16),  # bidirectional
    (1, 8, 1, 48, 48, 256, True, [16], 16),  # paligemma-3b: MQA 8:1, head dim 256, prefix-LM
    (1, 4, 1, 32, 32, 256, True, None, 16),  # head dim 256, causal
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_plain_matches_pallas(case):
    B, Hq, Hkv, Tq, Tk, D, causal, prefix, blk = case
    r = _rng(Tq + Tk + Hq)
    q = r.normal(size=(B, Tq, Hq, D)).astype(np.float32)  # the port's token-major layout
    k = r.normal(size=(B, Tk, Hkv, D)).astype(np.float32)
    v = r.normal(size=(B, Tk, Hkv, D)).astype(np.float32)
    plen = None if prefix is None else np.asarray(prefix, np.int32)
    got = ops.flash_attention(_t(q), _t(k), _t(v), None if plen is None else _t(plen), causal=causal)
    got = got.numpy().transpose(0, 2, 1, 3)
    qh, kh, vh = (jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v))
    jplen = None if plen is None else jnp.asarray(plen)
    pal = flash_attention_pallas(qh, kh, vh, jplen, causal=causal, block_q=blk, block_k=blk,
                                 interpret=True)
    oracle = ref.mha_ref(qh, kh, vh, causal=causal, prefix_len=jplen)
    for want in (pal, oracle):
        np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


def test_flash_attention_plain_ragged_length_matches_ref():
    """T=37 fits no block of the Pallas kernel: the plain version (like the
    CUDA kernel) needs none."""
    r = _rng(37)
    q, k, v = (r.normal(size=(1, 37, h, 32)).astype(np.float32) for h in (4, 2, 2))
    got = flash_attention_plain(_t(q), _t(k), _t(v)).numpy().transpose(0, 2, 1, 3)
    qh, kh, vh = (jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v))
    np.testing.assert_allclose(got, np.asarray(ref.mha_ref(qh, kh, vh, causal=True)), atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# The bf16 rule the CUDA kernels are held to (ops.BF16_TOL) admits the
# output's rounding (and K4's tensor-core rounding of its weights) and
# rejects planted faults of the kinds a split-KV or tiled kernel can make,
# at the smollm-360m shapes
# ---------------------------------------------------------------------------


def _decode_fault(fault):
    r = _rng(11)
    B, Hq, Hkv, S, D = 4, 15, 5, 4096, 64
    q, k, v = (_t(r.normal(size=s).astype(np.float32)).bfloat16().float()
               for s in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    lens = torch.tensor([3073, 3001, 2049, 1537], dtype=torch.int32)
    want = decode_attention_plain(q, k, v, lens)
    if fault == "split skipped":  # the split at 1024, as the kernel cuts S on an H100 (132 SMs)
        split = split_size(S, B, Hkv, 132)
        cut = lambda x: torch.cat([x[:, :1024], x[:, 1024 + split:]], dim=1)  # noqa: E731
        return want, decode_attention_plain(q, cut(k), cut(v), lens - split), None
    if fault == "last tile dropped":  # kv_len rounded down to the tile
        return want, decode_attention_plain(q, k, v, lens // TILE * TILE), None
    return want, decode_attention_plain(q, k, v, lens - 1), None  # one key masked off


def _flash_inputs(seed, T, Hq, Hkv, D=64):
    r = _rng(seed)
    return tuple(_t(r.normal(size=(1, T, h, D)).astype(np.float32)).bfloat16().float() for h in (Hq, Hkv, Hkv))


def _flash_fault(fault):
    T = 1024
    q, k, v = _flash_inputs(12, T, 3, 1)
    want = flash_attention_plain(q, k, v)
    if fault == "tile skipped":  # the last 64 query rows skip the 32-key tile at 512
        bad = want.clone()
        cut = lambda x: torch.cat([x[:, :512], x[:, 512 + 32:]], dim=1)  # noqa: E731
        bad[:, T - 64:] = flash_attention_plain(q[:, T - 64:], cut(k), cut(v))
    else:  # the diagonal tiles' mask off by one: every query also sees its next key
        nxt = lambda x: torch.cat([x, x[:, :1]], dim=1)  # noqa: E731  (key T: seen by no row below)
        bad = flash_attention_plain(q, nxt(k), nxt(v))  # query t at position t + 1
        bad[:, T - 1] = want[:, T - 1]  # the last query has no next key
    return want, bad, flash_attention_magnitude(q, k, v)


@pytest.mark.parametrize("kernel,fault", [
    ("decode_attention", "split skipped"),
    ("decode_attention", "kv_len - 1"),
    ("decode_attention", "last tile dropped"),
    ("flash_attention", "tile skipped"),
    ("flash_attention", "diagonal off by one"),
])
def test_bf16_rule_admits_rounding_and_catches_planted_faults(kernel, fault):
    want, bad, scale = (_decode_fault if kernel == "decode_attention" else _flash_fault)(fault)
    tol = ops.BF16_TOL[kernel]
    assert ops.bf16_ulp_excess(want.bfloat16(), want, scale=scale, **tol) <= 0.5
    assert ops.bf16_ulp_excess(bad.bfloat16(), want, scale=scale, **tol) > 1


def _tensor_core_flash(q, k, v, tile=64):
    """K4's bf16 arithmetic, causal, in PyTorch: f32 scores of bf16 inputs,
    an online softmax in log2 units over tiles of ``tile`` keys, each
    unnormalized weight rounded to bf16 for the value product, f32 sums."""
    _, T, Hq, D = q.shape
    rep = Hq // k.shape[2]
    qh = q[0].transpose(0, 1)  # (Hq, T, D)
    kh, vh = (x[0].transpose(0, 1).repeat_interleave(rep, 0) for x in (k, v))
    m = torch.full((Hq, T, 1), float("-inf"))
    l, o = torch.zeros((Hq, T, 1)), torch.zeros((Hq, T, D))
    pos = torch.arange(T)[:, None]
    for k0 in range(0, T, tile):
        s = qh @ kh[:, k0:k0 + tile].transpose(1, 2) * (D ** -0.5 * 1.4426950408889634)
        s = s.masked_fill(torch.arange(k0, min(k0 + tile, T))[None] > pos, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        a = torch.exp2(m - m_new)  # m_new is finite: key 0 is in every row's first tile
        p = torch.exp2(s - m_new)
        l = l * a + p.sum(-1, keepdim=True)
        o = o * a + p.bfloat16().float() @ vh[:, k0:k0 + tile]
        m = m_new
    return (o / l).transpose(0, 1)[None].bfloat16()


def test_flash_rule_admits_a_tensor_core_result_at_the_smollm_shape():
    """q (1, 3072, 15, 64) against k/v (1, 3072, 5, 64), causal: the weights'
    bf16 rounding breaks the plain two-ulp rule but stays inside K4's."""
    q, k, v = _flash_inputs(13, 3072, 15, 5)
    got = _tensor_core_flash(q, k, v)
    want = flash_attention_plain(q, k, v)
    tol = ops.BF16_TOL["flash_attention"]
    assert ops.bf16_ulp_excess(got, want, scale=flash_attention_magnitude(q, k, v), **tol) <= 1
    assert ops.bf16_ulp_excess(got, want, ulps=tol["ulps"], atol=tol["atol"]) > 1
    with pytest.raises(ValueError, match="scale"):
        ops.bf16_ulp_excess(got, want, **tol)


@pytest.mark.parametrize("key,name", [
    ("void (anonymous namespace)::quant_kernel<8>(float const*, float const*, unsigned short*, "
     "long long, int, int, int, float)", "quant_kernel"),
    ("void (anonymous namespace)::dequant_kernel<float>(unsigned short const*, float const*, "
     "float const*, float*, long long, int, int, int, float)", "dequant_kernel"),
    ("void (anonymous namespace)::dequant_tokens_kernel<__nv_bfloat16, 4>(unsigned short const*, "
     "float const*, float const*, __nv_bfloat16*, long long, int, int, int, float)", "dequant_tokens_kernel"),
    ("dequant_tokens_kernel<__nv_bfloat16, 8>", "dequant_tokens_kernel"),
    ("decode_combine_kernel", "decode_combine_kernel"),
    ("lossless_tokens_kernel<__nv_bfloat16, 8>", "lossless_tokens_kernel"),
    ("void (anonymous namespace)::lossless_tokens_kernel<float, 1>(unsigned short const*, "
     "unsigned short const*, float const*, float*, long long, int, int, int)", "lossless_tokens_kernel"),
    ("void (anonymous namespace)::dequant_kernel<float, 8>(unsigned short const*, float const*, "
     "float const*, float*, long long, int, int, int, float)", "dequant_kernel"),
])
def test_profiler_keys_match_kernels_by_exact_name(key, name):
    """``quant_kernel`` is a substring of ``dequant_kernel``: device times are
    matched by the function name itself."""
    assert timing.kernel_name(key) == name


def _expand_heads(t, rep):
    return t.repeat_interleave(rep, dim=2).transpose(1, 2)


def test_attention_plain_paths_differentiate():
    """On CPU tensors the wrappers run the plain versions, which autograd
    differentiates: K4's (bidirectional, and causal at Tq < Tk) and K3's
    gradients equal those of ``scaled_dot_product_attention`` on the same
    f32 inputs (GQA expanded)."""
    r = _rng(5)

    def leaf(*shape):
        return torch.tensor(r.normal(size=shape).astype(np.float32), requires_grad=True)

    q, k, v = leaf(2, 5, 4, 16), leaf(2, 7, 2, 16), leaf(2, 7, 2, 16)
    up = torch.tensor(r.normal(size=(2, 5, 4, 16)).astype(np.float32))
    for causal in (False, True):
        got = torch.autograd.grad((ops.flash_attention(q, k, v, causal=causal) * up).sum(), (q, k, v))
        mask = torch.arange(7)[None, :] <= torch.arange(5)[:, None] + 2 if causal else None
        want = torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), _expand_heads(k, 2), _expand_heads(v, 2), attn_mask=mask).transpose(1, 2)
        want = torch.autograd.grad((want * up).sum(), (q, k, v))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    qd, lens = leaf(2, 4, 16), torch.tensor([7, 3], dtype=torch.int32)
    got = torch.autograd.grad((ops.decode_attention(qd, k, v, lens) * up[:, 0]).sum(), (qd, k, v))
    mask = (torch.arange(7)[None, :] < lens[:, None])[:, None, None, :]
    want = torch.nn.functional.scaled_dot_product_attention(
        qd[:, :, None], _expand_heads(k, 2), _expand_heads(v, 2), attn_mask=mask)[:, :, 0]
    want = torch.autograd.grad((want * up[:, 0]).sum(), (qd, k, v))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_wrappers_count_only_kernel_launches():
    """On the CPU the plain versions run and no launch is counted."""
    ops.reset_launch_counts()
    d, a, bins = _dequant_inputs(0, 1, 2, 3, 8)
    ops.kv_dequant_tokens(_t(d), _t(a), _t(bins), qmax=127)
    ops.kv_dequant(_t(d), _t(a), _t(bins), qmax=127)
    kv, qbins = _quant_inputs(0, 1, 2, 4, 8)
    ops.kv_quant(_t(kv), _t(qbins), qmax=127)
    assert set(ops.KERNELS) >= {"kv_quant", "kv_dequant"}
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


# ---------------------------------------------------------------------------
# CUDA kernels against the plain versions (on the card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (B, G, g-1, C, offset): the CPU cases, the main path's shapes, C = 36, 10
# and 5 (V = 4, 2, 1), g-1 = 1 and 15, G = 1, more rows than a grid's y
# extent (65,535), and inputs that are contiguous views `offset` elements
# into their buffer (1: misaligned for any vector access; 2: V = 2 at most)
CUDA_KV_CASES = [c[:4] + (0,) for c in KV_CASES] + [
    (64, 154, 9, 320, 0), (256, 154, 9, 320, 0), (8, 147, 9, 320, 0), (4, 154, 15, 36, 0),
    (6, 1, 1, 10, 0), (3, 147, 9, 5, 0), (70000, 1, 1, 8, 0), (4, 154, 9, 320, 1), (2, 147, 9, 320, 2),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CUDA_KV_CASES)
def test_cuda_kvquant_matches_plain(cuda, case):
    B, G, gm1, C, offset = case
    d, a, bins = _dequant_inputs(sum(case), B, G, gm1, C)
    d, a, bins = _at_offset(_t(d).to(cuda), offset), _at_offset(_t(a).to(cuda), offset), _t(bins).to(cuda)
    if offset:
        assert vector_width(C, d, a) < 8
    for dt in (torch.float32, torch.bfloat16):
        got = kv_dequant_tokens_cuda(d, a, bins, qmax=127, out_dtype=dt)
        want = kv_dequant_tokens_plain(d, a, bins, qmax=127, out_dtype=dt)
        torch.cuda.synchronize()
        if dt == torch.float32:
            torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
        else:
            assert ops.bf16_ulp_excess(got, want, **ops.BF16_TOL["kv_dequant_tokens"]) <= 1
    r = _rng(1)
    a_sym = _at_offset(_t(r.integers(1, 256, size=(B, G, C)).astype(np.uint16)).to(cuda), offset)
    d_sym = _at_offset(_t(r.integers(0, 509, size=(B, G, gm1, C)).astype(np.uint16)).to(cuda), offset)
    s = _t(r.uniform(1e-3, 0.05, size=(B, G)).astype(np.float32)).to(cuda)
    if offset:
        assert vector_width(C, d_sym, a_sym) < 8
    for dt in (torch.float32, torch.bfloat16):
        before = kv_lossless_tokens_cuda.launches
        got = kv_lossless_tokens_cuda(d_sym, a_sym, s, out_dtype=dt)
        want = kv_lossless_tokens_plain(d_sym, a_sym, s, out_dtype=dt)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert kv_lossless_tokens_cuda.launches == before + 1


# (B, G, g, C, offset), as CUDA_KV_CASES: g = 2 and 16 (g-1 = 1 and 15)
CUDA_QUANT_CASES = [c[:4] + (0,) for c in QUANT_CASES] + [
    (64, 154, 10, 320, 0), (64, 147, 10, 320, 0), (4, 154, 16, 36, 0), (6, 1, 2, 10, 0),
    (3, 147, 10, 5, 0), (70000, 1, 2, 8, 0), (4, 154, 10, 320, 1), (2, 147, 10, 320, 2),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CUDA_QUANT_CASES)
def test_cuda_quant_dequant_match_plain(cuda, case):
    B, G, g, C, offset = case
    kv, bins = _quant_inputs(sum(case), B, G, g, C)
    kv, bins = _at_offset(_t(kv).to(cuda), offset), _t(bins).to(cuda)
    if offset:
        assert vector_width(C, kv) < 8
    before = kv_quant_cuda.launches
    got = kv_quant_cuda(kv, bins, qmax=127)
    torch.cuda.synchronize()
    assert torch.equal(got, kv_quant_plain(kv, bins, qmax=127))
    assert kv_quant_cuda.launches == before + 1
    d, a, dbins = _dequant_inputs(sum(case), B, G, g - 1, C)
    d, a, dbins = _at_offset(_t(d).to(cuda), offset), _at_offset(_t(a).to(cuda), offset), _t(dbins).to(cuda)
    if offset:
        assert vector_width(C, d, a) < 8
    for dt in (torch.float32, torch.bfloat16):  # bf16: one cast of the same f32 value
        before = kv_dequant_cuda.launches
        got = kv_dequant_cuda(d, a, dbins, qmax=127, out_dtype=dt)
        want = kv_dequant_plain(d, a, dbins, qmax=127, out_dtype=dt)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert kv_dequant_cuda.launches == before + 1


def _decode_case(cuda, seed, B, Hq, Hkv, S, D, q_dtype, kv_dtype):
    r = _rng(seed)
    q = _t(r.normal(size=(B, Hq, D)).astype(np.float32)).to(cuda, q_dtype)
    k = _t(r.normal(size=(B, S, Hkv, D)).astype(np.float32)).to(cuda, kv_dtype)
    v = _t(r.normal(size=(B, S, Hkv, D)).astype(np.float32)).to(cuda, kv_dtype)
    return q, k, v


def _check_decode(q, k, v, lens):
    before = decode_attention_cuda.launches
    got = decode_attention_cuda(q, k, v, lens)
    want = decode_attention_plain(q.float(), k.float(), v.float(), lens)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches == before + 1  # the merge launch is not counted apart
    assert got.dtype == q.dtype and got.shape == q.shape
    if q.dtype == torch.bfloat16:
        assert ops.bf16_ulp_excess(got, want, **ops.BF16_TOL["decode_attention"]) <= 1
    else:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert not got[lens == 0].float().any()


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16),  # an f32 model over the engine's bf16 cache
    (torch.bfloat16, torch.float32),
])
def test_cuda_decode_attention_matches_plain(cuda, q_dtype, kv_dtype):
    """kv_len at the tile's and the split's edges, past S (clamped) and 0."""
    B, Hq, Hkv, S, D = 11, 15, 5, 4096, 64
    split = split_size(S, B, Hkv, torch.cuda.get_device_properties(cuda).multi_processor_count)
    q, k, v = _decode_case(cuda, 3, B, Hq, Hkv, S, D, q_dtype, kv_dtype)
    lens = [0, 1, TILE - 1, TILE, TILE + 1, split - 1, split, split + 1, S - 1, S, S + 100]
    _check_decode(q, k, v, torch.tensor(lens, dtype=torch.int32, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("Hq,Hkv,D,kv_dtype", [
    (16, 1, 32, torch.bfloat16),  # group of 16
    (4, 4, 128, torch.bfloat16),  # MHA, D = 128
    (8, 1, 128, torch.float32),  # the largest tile ring
    (6, 2, 32, torch.float32),
    (8, 1, 256, torch.bfloat16),  # paligemma-3b: its own 3-stage ring at D = 256
    (8, 1, 256, torch.float32),  # the 1-stage ring
    (32, 32, 80, torch.bfloat16),  # zamba2-2.7b's shared attention: MHA, D = 80 (column pairs a lane)
    (32, 32, 80, torch.float32),
    (6, 2, 80, torch.bfloat16),  # GQA at D = 80
])
def test_cuda_decode_attention_geometries(cuda, Hq, Hkv, D, kv_dtype):
    q, k, v = _decode_case(cuda, Hq + D, 3, Hq, Hkv, 700, D, torch.bfloat16, kv_dtype)
    lens = torch.tensor([700, 65, 0], dtype=torch.int32, device=cuda)
    _check_decode(q, k, v, lens)
    # the cache read in place through strides: one layer of a (L, B, S, H, D)
    # cache, and a head slice of a wider one
    wide = torch.cat([k, k], dim=2)
    _check_decode(q, torch.stack([k, k])[1], wide[:, :, Hkv:], lens)
    # rows misaligned for 16-byte copies: the wrapper copies them
    flat = torch.empty(k.numel() + 1, dtype=k.dtype, device=cuda)
    odd = flat[1:].view(k.shape)
    odd.copy_(v)
    _check_decode(q, k, odd, lens)


@pytest.mark.gpu
def test_cuda_attention_refuses_grad(cuda):
    """K3 and K4 have no backward: with grad enabled and any input that
    requires grad, the wrappers raise on the card; without grad they run."""
    r = _rng(9)

    def t(*shape, grad=False):
        return _t(r.normal(size=shape).astype(np.float32)).to(cuda, torch.bfloat16).requires_grad_(grad)

    q, k, v = t(1, 64, 4, 64), t(1, 64, 4, 64), t(1, 64, 4, 64)
    qd, kc, vc = t(1, 4, 64), t(1, 128, 4, 64), t(1, 128, 4, 64)
    lens = torch.tensor([100], dtype=torch.int32, device=cuda)
    for grad in ("q", "k", "v"):
        args = [x.detach().requires_grad_(name == grad) for name, x in (("q", q), ("k", k), ("v", v))]
        with pytest.raises(RuntimeError, match="no backward"):
            ops.flash_attention(*args, causal=False)
        dargs = [x.detach().requires_grad_(name == grad) for name, x in (("q", qd), ("k", kc), ("v", vc))]
        with pytest.raises(RuntimeError, match="no backward"):
            ops.decode_attention(*dargs, lens)
    q.requires_grad_(True)
    qd.requires_grad_(True)
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).shape == q.shape
        assert ops.decode_attention(qd, kc, vc, lens).shape == qd.shape
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_decode_attention_encdec_geometry(cuda):
    """seamless-m4t-large-v2's decoder self-attention: MHA, 16 heads of 64
    (one query head a KV head), a cache of 1,056 slots (a 1,024-token prompt
    and 32 generated tokens) at the first and the last generated token's
    lengths, a ragged row and an empty one."""
    q, k, v = _decode_case(cuda, 64, 4, 16, 16, 1056, 64, torch.bfloat16, torch.bfloat16)
    _check_decode(q, k, v, torch.tensor([1025, 1056, TILE + 1, 0], dtype=torch.int32, device=cuda))


@pytest.mark.gpu
def test_cuda_decode_attention_moe_geometry(cuda):
    """qwen2-moe-a2.7b's decode: MHA, 16 heads of 128, a cache of 3,105
    slots (a 3,072-token context and 32 generated tokens) at the first and
    the last generated token's lengths, and a ragged row."""
    q, k, v = _decode_case(cuda, 16, 3, 16, 16, 3105, 128, torch.bfloat16, torch.bfloat16)
    _check_decode(q, k, v, torch.tensor([3073, 3104, 1000], dtype=torch.int32, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float32])
def test_cuda_decode_attention_vlm_geometry(cuda, kv_dtype):
    """paligemma-3b's decode: MQA 8:1, head dim 256, a cache of 3,361
    slots (256 image rows, a 3,072-token context and 32 generated tokens)
    at the first and the last generated token's lengths, a ragged row and
    an empty one: many splits of one KV head, merged at D + 2 floats a
    split."""
    q, k, v = _decode_case(cuda, 256, 4, 8, 1, 3361, 256, torch.bfloat16, kv_dtype)
    _check_decode(q, k, v, torch.tensor([3329, 3360, 1000, 0], dtype=torch.int32, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float32])
def test_cuda_decode_attention_hybrid_geometry(cuda, kv_dtype):
    """zamba2-2.7b's shared-block decode: MHA, 32 heads of 80, a cache of
    3,104 slots (a 3,072-token context and 32 generated tokens) at the
    first and the last generated token's lengths, a ragged row and an empty
    one; the merge at 80 columns runs 96 threads."""
    q, k, v = _decode_case(cuda, 80, 4, 32, 32, 3104, 80, torch.bfloat16, kv_dtype)
    _check_decode(q, k, v, torch.tensor([3073, 3104, TILE + 1, 0], dtype=torch.int32, device=cuda))


# (B, Hq, Hkv, Tq, Tk, D, causal, prefix)
CUDA_FLASH_CASES = [
    (1, 15, 5, 3072, 3072, 64, True, None),  # the serve phase's prefill
    (1, 15, 5, 6144, 6144, 64, True, None),  # the store's prefill
    (1, 15, 5, 1, 1, 64, True, None),
    (1, 15, 5, 65, 65, 64, True, None),
    (2, 15, 5, 3000, 3000, 64, True, None),
    (1, 15, 5, 300, 300, 64, True, None),
    (2, 6, 2, 77, 200, 64, True, [0, 150]),  # prefix-LM, Tq < Tk
    (2, 15, 5, 1024, 1024, 64, True, [100, 700]),
    (1, 4, 4, 130, 130, 64, False, None),  # bidirectional
    (1, 15, 5, 1000, 3072, 64, True, None),  # the decoder offset
    (1, 8, 2, 300, 300, 128, True, None),
    (1, 16, 16, 3072, 3072, 128, True, None),  # qwen2-moe-a2.7b's prefill
    (1, 4, 2, 200, 333, 32, True, None),
    (1, 8, 1, 3328, 3328, 256, True, [256]),  # paligemma-3b's prefill: 256 image rows, 3072 tokens
    (2, 8, 1, 1000, 1000, 256, True, [256, 0]),  # its prefix beside a causal row
    (1, 8, 1, 300, 300, 256, True, None),
    (1, 4, 2, 130, 200, 256, False, None),  # bidirectional, Tq < Tk
    (1, 32, 32, 3072, 3072, 80, True, None),  # zamba2-2.7b's shared-block prefill (D padded to 128)
    (2, 32, 32, 1000, 1000, 80, True, None),
    (1, 32, 32, 300, 300, 80, True, None),
    (2, 6, 2, 77, 200, 80, True, [0, 150]),  # GQA, prefix-LM, Tq < Tk at D = 80
    (1, 4, 4, 130, 130, 80, False, None),  # bidirectional
    (2, 16, 16, 3072, 3072, 64, False, None),  # seamless-m4t-large-v2's encoder: bidirectional over 3,072 frames
    (2, 16, 16, 3000, 3000, 64, False, None),  # ragged: the last key tile masked at key >= Tk
    (2, 16, 16, 1024, 1024, 64, True, None),  # its decoder prompt, causal
]


def _flash_case(cuda, case, dtype):
    B, Hq, Hkv, Tq, Tk, D, causal, prefix = case
    r = _rng(Tq + D)
    q = _t(r.normal(size=(B, Tq, Hq, D)).astype(np.float32)).to(cuda, dtype)
    k = _t(r.normal(size=(B, Tk, Hkv, D)).astype(np.float32)).to(cuda, dtype)
    v = _t(r.normal(size=(B, Tk, Hkv, D)).astype(np.float32)).to(cuda, dtype)
    plen = None if prefix is None else torch.tensor(prefix, dtype=torch.int32, device=cuda)
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, plen, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    return got, flash_attention_plain(q.float(), k.float(), v.float(), plen, causal=causal), (q, k, v, plen)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CUDA_FLASH_CASES)
def test_cuda_flash_attention_matches_plain(cuda, case):
    got, want, (q, k, v, plen) = _flash_case(cuda, case, torch.bfloat16)
    mag = flash_attention_magnitude(q, k, v, plen, causal=case[6])
    assert ops.bf16_ulp_excess(got, want, scale=mag, **ops.BF16_TOL["flash_attention"]) <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", [c for c in CUDA_FLASH_CASES if c[3] <= 300 or c[7] is not None])
def test_cuda_flash_attention_f32_matches_plain(cuda, case):
    got, want, _ = _flash_case(cuda, case, torch.float32)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
