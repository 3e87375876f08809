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
    from repro.kernels.kvquant import kv_dequant_tokens_pallas, kv_lossless_tokens_pallas
except ImportError:
    jnp = None

from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import SPLIT_SIZE, decode_attention_cuda, decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
from repro_torch.kernels.kvquant import (
    kv_dequant_tokens_cuda,
    kv_dequant_tokens_plain,
    kv_lossless_tokens_cuda,
    kv_lossless_tokens_plain,
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
# K3 (CPU)
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, S, D, kv_len, block_s)
DECODE_CASES = [
    (3, 4, 2, 64, 32, [0, 17, 64], 32),  # GQA, an empty row, a full row
    (2, 6, 2, 96, 32, [1, 95], 32),  # rep 3, as smollm-360m
    (1, 4, 4, 32, 64, [30], 32),  # MHA
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
# output's rounding and rejects planted faults of the kinds a split-KV or
# tiled kernel can make, at the smollm-360m decode shapes
# ---------------------------------------------------------------------------


def _decode_fault(fault):
    r = _rng(11)
    B, Hq, Hkv, S, D = 4, 15, 5, 4096, 64
    q, k, v = (_t(r.normal(size=s).astype(np.float32)).bfloat16().float()
               for s in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    lens = torch.tensor([3073, 3001, 2049, 1537], dtype=torch.int32)
    want = decode_attention_plain(q, k, v, lens)
    if fault == "split skipped":
        cut = lambda x: torch.cat([x[:, :1024], x[:, 1024 + SPLIT_SIZE:]], dim=1)  # noqa: E731
        return want, decode_attention_plain(q, cut(k), cut(v), lens - SPLIT_SIZE)
    return want, decode_attention_plain(q, k, v, lens - 1)  # one key masked off


def _flash_fault(fault):
    r = _rng(12)
    T, Hq, Hkv, D = 1024, 3, 1, 64
    q, k, v = (_t(r.normal(size=(1, T, h, D)).astype(np.float32)).bfloat16().float() for h in (Hq, Hkv, Hkv))
    want = flash_attention_plain(q, k, v)
    bad = want.clone()  # the last 64 query rows skip the 32-key tile at 512
    cut = lambda x: torch.cat([x[:, :512], x[:, 512 + 32:]], dim=1)  # noqa: E731
    bad[:, T - 64:] = flash_attention_plain(q[:, T - 64:], cut(k), cut(v))
    return want, bad


@pytest.mark.parametrize("kernel,fault", [
    ("decode_attention", "split skipped"),
    ("decode_attention", "kv_len - 1"),
    ("flash_attention", "tile skipped"),
])
def test_bf16_rule_admits_rounding_and_catches_planted_faults(kernel, fault):
    want, bad = (_decode_fault if kernel == "decode_attention" else _flash_fault)(fault)
    tol = ops.BF16_TOL[kernel]
    assert ops.bf16_ulp_excess(want.bfloat16(), want, **tol) <= 0.5
    assert ops.bf16_ulp_excess(bad.bfloat16(), want, **tol) > 1


def test_wrappers_count_only_kernel_launches():
    """On the CPU the plain versions run and no launch is counted."""
    ops.reset_launch_counts()
    d, a, bins = _dequant_inputs(0, 1, 2, 3, 8)
    ops.kv_dequant_tokens(_t(d), _t(a), _t(bins), qmax=127)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


# ---------------------------------------------------------------------------
# CUDA kernels against the plain versions (on the card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", KV_CASES + [(64, 154, 9, 320, 8)])
def test_cuda_kvquant_matches_plain(cuda, case):
    B, G, gm1, C, _ = case
    d, a, bins = _dequant_inputs(sum(case), B, G, gm1, C)
    d, a, bins = _t(d).to(cuda), _t(a).to(cuda), _t(bins).to(cuda)
    for dt in (torch.float32, torch.bfloat16):
        got = kv_dequant_tokens_cuda(d, a, bins, qmax=127, out_dtype=dt)
        want = kv_dequant_tokens_plain(d, a, bins, qmax=127, out_dtype=dt)
        torch.cuda.synchronize()
        if dt == torch.float32:
            torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
        else:
            assert ops.bf16_ulp_excess(got, want, **ops.BF16_TOL["kv_dequant_tokens"]) <= 1
    r = _rng(1)
    a_sym = _t(r.integers(1, 256, size=(B, G, C)).astype(np.uint16)).to(cuda)
    d_sym = _t(r.integers(0, 509, size=(B, G, gm1, C)).astype(np.uint16)).to(cuda)
    s = _t(r.uniform(1e-3, 0.05, size=(B, G)).astype(np.float32)).to(cuda)
    for dt in (torch.float32, torch.bfloat16):
        got = kv_lossless_tokens_cuda(d_sym, a_sym, s, out_dtype=dt)
        want = kv_lossless_tokens_plain(d_sym, a_sym, s, out_dtype=dt)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16),  # an f32 model over the engine's bf16 cache
    (torch.bfloat16, torch.float32),
])
def test_cuda_decode_attention_matches_plain(cuda, q_dtype, kv_dtype):
    r = _rng(3)
    B, Hq, Hkv, S, D = 4, 15, 5, 1000, 64
    q = _t(r.normal(size=(B, Hq, D)).astype(np.float32)).to(cuda, q_dtype)
    k = _t(r.normal(size=(B, S, Hkv, D)).astype(np.float32)).to(cuda, kv_dtype)
    v = _t(r.normal(size=(B, S, Hkv, D)).astype(np.float32)).to(cuda, kv_dtype)
    lens = torch.tensor([0, 1, 999, 1000], dtype=torch.int32, device=cuda)
    got = decode_attention_cuda(q, k, v, lens)
    want = decode_attention_plain(q.float(), k.float(), v.float(), lens)
    torch.cuda.synchronize()
    assert got.dtype == q_dtype
    if q_dtype == torch.bfloat16:
        assert ops.bf16_ulp_excess(got, want, **ops.BF16_TOL["decode_attention"]) <= 1
    else:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert not got[0].float().any()


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    (1, 15, 5, 300, 300, True, None),
    (2, 6, 2, 77, 200, True, [0, 150]),
    (1, 4, 4, 130, 130, False, None),
])
def test_cuda_flash_attention_matches_plain(cuda, case):
    B, Hq, Hkv, Tq, Tk, causal, prefix = case
    r = _rng(Tq)
    q = _t(r.normal(size=(B, Tq, Hq, 64)).astype(np.float32)).to(cuda, torch.bfloat16)
    k = _t(r.normal(size=(B, Tk, Hkv, 64)).astype(np.float32)).to(cuda, torch.bfloat16)
    v = _t(r.normal(size=(B, Tk, Hkv, 64)).astype(np.float32)).to(cuda, torch.bfloat16)
    plen = None if prefix is None else torch.tensor(prefix, dtype=torch.int32, device=cuda)
    got = flash_attention_cuda(q, k, v, plen, causal=causal)
    want = flash_attention_plain(q.float(), k.float(), v.float(), plen, causal=causal)
    torch.cuda.synchronize()
    assert ops.bf16_ulp_excess(got, want, **ops.BF16_TOL["flash_attention"]) <= 1
