"""K3 and K4 across the reference's whole domain: head dims off the
compiled plans (16, 48, 96, 100, 160) and past them (288, 300, 512, 576:
the kernels' wide path) and groups past 16 query heads a KV head (32:1),
the plain versions against the reference's Pallas kernels in
interpret mode and its ``kernels/ref.py`` oracles on the CPU (f32 within
2e-5, as ``tests/test_kernels.py``); two models derived from smollm-360m's
``.tiny()`` at such shapes (head dim 48; 32 query heads on one KV head)
through both packages' ``build`` in f32, prefill and decode logits and
caches within 2e-5 (``tests/test_torch_model.py``'s rule); and on the card
(``-m gpu``) K4 inside ``local_map`` under autograd at head dim 96.
"""
import dataclasses

import numpy as np
import pytest
import torch

try:  # the reference; absent where only the port is installed (the card's machine)
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as jregistry
    from repro.kernels import ref
    from repro.kernels.decode_attention import decode_attention_pallas
    from repro.kernels.flash_attention import flash_attention_pallas
    from repro.models import build as jbuild
except ImportError:
    jnp = None

from repro_torch.configs import registry
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain, flash_attention_vjp
from repro_torch.models import build
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)

TOL = 2e-5


@pytest.fixture(autouse=True)
def _needs_reference(request):
    if jnp is None and "gpu" not in request.keywords:
        pytest.skip("needs the JAX reference package")


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


# (B, Hq, Hkv, S, D, kv_len, block_s): every new head dim at one query head
# a KV head and at 32, and head dims past 256
DECODE_CASES = [
    (2, 32, 1, 64, 16, [0, 50], 32),
    (1, 4, 4, 64, 48, [33], 32),
    (2, 32, 1, 64, 96, [64, 7], 32),
    (1, 2, 2, 32, 100, [30], 32),
    (1, 32, 1, 32, 160, [31], 32),
    (1, 4, 4, 32, 96, [32], 32),
    (1, 32, 1, 32, 48, [20], 32),
    (1, 4, 2, 32, 288, [30], 32),
    (2, 2, 1, 32, 300, [32, 5], 32),
    (1, 8, 2, 32, 512, [17], 32),
    (1, 2, 2, 32, 576, [32], 32),
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_plain_matches_pallas_at_new_shapes(case):
    B, Hq, Hkv, S, D, kv_len, bs = case
    r = np.random.default_rng(S + Hq + D)
    q = r.normal(size=(B, Hq, D)).astype(np.float32)
    k = r.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = r.normal(size=(B, S, Hkv, D)).astype(np.float32)
    lens = np.asarray(kv_len, np.int32)
    got = ops.decode_attention(_t(q), _t(k), _t(v), _t(lens)).numpy()
    kh, vh = jnp.asarray(k.transpose(0, 2, 1, 3)), jnp.asarray(v.transpose(0, 2, 1, 3))
    pal = np.asarray(decode_attention_pallas(jnp.asarray(q), kh, vh, jnp.asarray(lens), block_s=bs, interpret=True))
    np.testing.assert_allclose(got, pal, atol=TOL, rtol=TOL)
    live = lens > 0
    oracle = np.asarray(ref.decode_attention_ref(jnp.asarray(q), kh, vh, kv_len=jnp.asarray(lens)))
    np.testing.assert_allclose(got[live], oracle[live], atol=TOL, rtol=TOL)
    assert not got[~live].any()


# (B, Hq, Hkv, Tq, Tk, D, causal, prefix, block)
FLASH_CASES = [
    (1, 32, 1, 32, 32, 16, True, None, 16),
    (1, 2, 2, 32, 32, 48, True, None, 16),
    (1, 32, 1, 16, 32, 96, True, None, 16),
    (1, 2, 1, 32, 32, 100, True, [8], 16),
    (1, 2, 2, 32, 32, 160, False, None, 16),
    (1, 4, 4, 32, 32, 96, True, None, 16),
    (1, 2, 1, 32, 32, 288, True, None, 16),
    (1, 2, 2, 16, 32, 300, True, [8], 16),
    (1, 4, 2, 32, 32, 512, False, None, 16),
    (1, 2, 1, 32, 32, 576, True, None, 16),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_plain_matches_pallas_at_new_shapes(case):
    B, Hq, Hkv, Tq, Tk, D, causal, prefix, blk = case
    r = np.random.default_rng(Tq + Tk + Hq + D)
    q = r.normal(size=(B, Tq, Hq, D)).astype(np.float32)
    k = r.normal(size=(B, Tk, Hkv, D)).astype(np.float32)
    v = r.normal(size=(B, Tk, Hkv, D)).astype(np.float32)
    plen = None if prefix is None else np.asarray(prefix, np.int32)
    got = ops.flash_attention(_t(q), _t(k), _t(v), None if plen is None else _t(plen), causal=causal)
    got = got.numpy().transpose(0, 2, 1, 3)
    qh, kh, vh = (jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v))
    jplen = None if plen is None else jnp.asarray(plen)
    pal = flash_attention_pallas(qh, kh, vh, jplen, causal=causal, block_q=blk, block_k=blk, interpret=True)
    oracle = ref.mha_ref(qh, kh, vh, causal=causal, prefix_len=jplen)
    for want in (pal, oracle):
        np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


# smollm-360m's .tiny() (4 layers, d 128, 4/2 heads x 32) at a head dim off
# the plans, and at 32 query heads on one KV head (Falcon-7B's layout)
SHAPED = {"d_head 48": dict(d_head=48), "32 heads on 1": dict(n_heads=32, n_kv_heads=1)}
B, T, CAP = 2, 24, 40


@pytest.mark.parametrize("shape", list(SHAPED))
def test_model_at_new_shapes_matches_reference(shape):
    """Prefill (K4's plain version) and one decode step (K3's) of the
    derived model through both packages' ``build`` on the reference's
    weights, in f32: logits and every cache element within 2e-5."""
    jcfg, cfg = (dataclasses.replace(get("smollm-360m").tiny(), dtype="float32", **SHAPED[shape])
                 for get in (jregistry.get, registry.get))
    jmodel, model = jbuild(jcfg), build(cfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)

    def held(got, want, what):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=TOL, rtol=TOL,
                                   err_msg=what)

    logits, c = model.prefill(params, {"tokens": torch.as_tensor(tokens)}, pad_to=CAP)
    jlogits, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)}, pad_to=CAP)
    held(logits, jlogits, "prefill logits")
    held(c.kv_k, jc.kv_k, "prefill K")
    held(c.kv_v, jc.kv_v, "prefill V")
    assert c.kv_k.shape[-2:] == (cfg.n_kv_heads, cfg.d_head)
    tok = np.asarray(jnp.argmax(jlogits[:, -1], -1)).astype(np.int32)[:, None]
    jl2, jc2 = jmodel.decode_step(jparams, jnp.asarray(tok), jc)
    l2, c2 = model.decode_step(params, torch.as_tensor(tok), c)
    held(l2, jl2, "step logits")
    held(c2.kv_k, jc2.kv_k, "K after the step")
    assert c2.length.tolist() == [T + 1] * B


# ---------------------------------------------------------------------------
# On the card: K4 inside local_map, under autograd, at head dim 96
# ---------------------------------------------------------------------------


def local_map_rank(rank, dm, seed):
    """One rank of a (1, 1) mesh: K4 at (2, 130, 8, 96) over (2, 130, 2, 96)
    through ``attention._flash_attention_sharded`` (``local_map``) on
    DTensors split by batch and heads, under autograd; returns the output,
    the gradients, the plain version's and K4's launches, on the CPU."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.models import attention

    dev = torch.device("cuda", torch.cuda.current_device())
    r = np.random.default_rng(seed)

    def t(*shape):
        return torch.as_tensor(r.normal(size=shape).astype(np.float32)).to(dev, torch.bfloat16)

    q, k, v, do = t(2, 130, 8, 96), t(2, 130, 2, 96), t(2, 130, 2, 96), t(2, 130, 8, 96)
    pl = [Shard(0), Shard(2)]
    leaves = [distribute_tensor(x, dm, pl).requires_grad_() for x in (q, k, v)]
    ops.reset_launch_counts()
    out = attention._flash_attention_sharded(*leaves, None, True)
    grads = torch.autograd.grad(out, leaves, distribute_tensor(do, dm, pl))
    launches = ops.launch_counts()["flash_attention"]
    want = flash_attention_plain(q.float(), k.float(), v.float())
    plain_grads = flash_attention_vjp(q, k, v, None, do)
    return {"out": out.full_tensor().cpu(), "want": want.cpu(), "grads": [g.full_tensor().cpu() for g in grads],
            "plain_grads": [g.cpu() for g in plain_grads], "launches": launches}


@pytest.mark.gpu
def test_cuda_flash_attention_in_local_map_at_head_dim_96():
    """K4 in each rank's ``local_map`` (the collectives' path) at a head dim
    off the plans, under autograd: one launch, the output within K4's rule
    of the f32 plain version, and the gradients equal to the plain VJP's
    on the same inputs (K4's backward is that VJP)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import flash_attention_magnitude
    from repro_torch.launch.mesh import Mesh, run_ranks

    mesh = Mesh(np.array([[torch.device("cuda", 0)]], dtype=object), ("data", "model"))
    got = run_ranks(local_map_rank, mesh, (7,), timeout_s=300.0)[0]
    assert got["launches"] == 1
    r = np.random.default_rng(7)
    q, k, v = (torch.as_tensor(r.normal(size=s).astype(np.float32)).to(torch.bfloat16)
               for s in ((2, 130, 8, 96), (2, 130, 2, 96), (2, 130, 2, 96)))
    mag = flash_attention_magnitude(q, k, v)
    assert ops.bf16_ulp_excess(got["out"], got["want"], scale=mag, **ops.BF16_TOL["flash_attention"]) <= 1
    for g, p in zip(got["grads"], got["plain_grads"]):
        assert torch.equal(g, p)
