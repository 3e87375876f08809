"""The hybrid family (zamba2-2.7b) of the port against the reference.

``zamba2-2.7b.tiny()`` has 7 Mamba-2 layers and a weight-shared attention
+ MLP block after every 3: two segments and a remainder of one layer (the
published config runs 9 segments of 6 and no remainder).  Its prefill
(logits, both Mamba-2 states, the two shared-block applications' K/V),
decode steps, engine (greedy tokens, teacher-forced logits, the refusals of
the chunked prefill and the row programs), ``extract_row`` and
``params_from_numpy`` (``shared_block`` included) are held to the
reference, in f32 and bf16, and in f32 also with the published head dim
of 80 (tiny widths otherwise).  The plain versions of K3 and K4, the CPU
path of the shared block's attention, are held at head dim 80 to the
reference's Pallas kernels (interpret mode) and its oracles, since
``.tiny()`` never reaches 80.  Tolerances: ``tests/_torch_ssm_world.py``;
the attention cases 2e-5 as ``tests/test_torch_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas

import _torch_ssm_world as world_lib
from repro_torch.configs import registry
from repro_torch.kernels import ops
from repro_torch.models import lm

torch.set_num_threads(1)

B, T, CAP = 2, 40, 64
TOL = 2e-5
# (dtype, shared-block head dim): the tiny config's 32, and the published 80
VARIANTS = [("float32", None), ("bfloat16", None), ("float32", 80)]


@pytest.fixture(scope="module", params=VARIANTS, ids=["f32", "bf16", "f32-d80"])
def world(request):
    dtype, d_head = request.param
    return world_lib.make_world("zamba2-2.7b", dtype, B=B, T=T, cap=CAP, seed=11, d_head=d_head)


def test_segments_of_the_tiny_and_the_published_config():
    tiny = registry.get("zamba2-2.7b").tiny()
    assert (tiny.n_layers, tiny.shared_block_every) == (7, 3)
    assert list(lm._segments(tiny)) == [(0, 3, 0), (3, 6, 1), (6, 7, None)]
    full = registry.get("zamba2-2.7b")
    assert list(lm._segments(full)) == [(6 * s, 6 * s + 6, s) for s in range(9)]
    assert full.d_head == 80 and full.n_heads == full.n_kv_heads == 32


def test_prefill_matches_reference(world):
    if world["cfg"].d_head == 80:
        assert world["c"].shared_k.shape[-1] == 80
    world_lib.check_prefill(world)


def test_prefill_layer_by_layer_matches_reference(world):
    world_lib.check_layer_by_layer(world)


def test_decode_steps_match_reference(world):
    """Three steps: each writes its K/V into both applications' shared
    caches at the row's length, in place."""
    world_lib.check_decode_steps(world)


def test_decode_step_writes_the_shared_caches_in_place(world):
    caches = world_lib.torch_caches(world["jc"], world["dtype"])
    shared_k = caches.shared_k
    tok = torch.zeros((B, 1), dtype=torch.long)
    _, out = lm.decode_step(world["cfg"], world["params"], tok, caches)
    assert out.shared_k is shared_k
    assert shared_k[:, :, T].float().abs().sum(-1).sum(-1).all()  # every application, every row
    assert not shared_k[:, :, T + 1:].float().any()


def test_engine_generates_the_references_tokens(world):
    world_lib.check_engine(world)


def test_engine_refuses_chunked_prefill_and_row_programs(world):
    world_lib.check_refusals(world)


def test_extract_row_carries_the_states(world):
    world_lib.check_extract_row(world)


def test_params_from_numpy_round_trips_the_plan(world):
    plan = lm.param_plan(world["cfg"])
    assert set(plan) == {"embed", "final_norm", "head", "layers", "shared_block"}
    assert set(plan["shared_block"]) == {"ln1", "attn", "ln2", "mlp"}
    world_lib.check_params(world, [("shared_block", "ln2", "gamma"), ("layers", "mamba", "a_log"),
                                   ("shared_block", "attn", "wo")])


# ---------------------------------------------------------------------------
# K3 and K4's plain versions at head dim 80
# ---------------------------------------------------------------------------


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


@pytest.mark.parametrize("case", [
    (2, 4, 4, 64, [0, 41], 32),  # MHA as zamba2, an empty row
    (3, 32, 32, 48, [48, 1, 17], 16),  # zamba2's 32 heads, a full row
    (1, 6, 2, 32, [30], 32),  # GQA
])
def test_decode_attention_plain_at_d80_matches_reference(case):
    Bq, Hq, Hkv, S, kv_len, bs = case
    D = 80
    r = np.random.default_rng(S + Hq)
    q = r.normal(size=(Bq, Hq, D)).astype(np.float32)
    k = r.normal(size=(Bq, S, Hkv, D)).astype(np.float32)
    v = r.normal(size=(Bq, S, Hkv, D)).astype(np.float32)
    lens = np.asarray(kv_len, np.int32)
    got = ops.decode_attention(_t(q), _t(k), _t(v), _t(lens)).numpy()
    kh, vh = jnp.asarray(k.transpose(0, 2, 1, 3)), jnp.asarray(v.transpose(0, 2, 1, 3))
    pal = np.asarray(decode_attention_pallas(jnp.asarray(q), kh, vh, jnp.asarray(lens), block_s=bs, interpret=True))
    np.testing.assert_allclose(got, pal, atol=TOL, rtol=TOL)
    live = lens > 0
    oracle = np.asarray(ref.decode_attention_ref(jnp.asarray(q), kh, vh, kv_len=jnp.asarray(lens)))
    np.testing.assert_allclose(got[live], oracle[live], atol=TOL, rtol=TOL)
    assert not got[~live].any()


@pytest.mark.parametrize("case", [
    (1, 4, 4, 64, 64, True, 16),  # causal MHA, as zamba2's shared block
    (2, 32, 32, 32, 32, True, 16),  # zamba2's 32 heads
    (1, 6, 2, 32, 64, True, 16),  # GQA, Tq < Tk: the decoder offset
    (1, 2, 2, 48, 48, False, 16),  # bidirectional
])
def test_flash_attention_plain_at_d80_matches_reference(case):
    Bq, Hq, Hkv, Tq, Tk, causal, blk = case
    D = 80
    r = np.random.default_rng(Tq + Tk + Hq)
    q = r.normal(size=(Bq, Tq, Hq, D)).astype(np.float32)
    k = r.normal(size=(Bq, Tk, Hkv, D)).astype(np.float32)
    v = r.normal(size=(Bq, Tk, Hkv, D)).astype(np.float32)
    got = ops.flash_attention(_t(q), _t(k), _t(v), None, causal=causal).numpy().transpose(0, 2, 1, 3)
    qh, kh, vh = (jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v))
    pal = flash_attention_pallas(qh, kh, vh, None, causal=causal, block_q=blk, block_k=blk, interpret=True)
    oracle = ref.mha_ref(qh, kh, vh, causal=causal)
    for want in (pal, oracle):
        np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)
