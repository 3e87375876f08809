"""The port's MoE family (``repro_torch.models.moe`` and its hooks in
``models.lm``) against the reference's, on the f32 ``.tiny()`` of
qwen2-moe-a2.7b (8 experts, top-2, 2 shared) and granite-moe-3b-a800m (8
experts, top-2, GQA, no shared experts), with the reference's weights.

Routed indices must be equal, exactly, before anything else is compared;
``moe_apply``'s output and load-balancing loss are then held to 1e-5 (f32
products summed in another order), the model's forward passes to the
engine tests' 1e-4.  The reference's capacity rule drops slots; the drop
counts below restate its arithmetic (``src/repro/models/moe.py:73-85,150``)
in numpy on its own routed indices.
"""
import dataclasses

import numpy as np
import pytest
import torch

try:  # the reference; absent where only the port is installed (the card's machine)
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as jregistry
    from repro.models import lm as jlm
    from repro.models import moe as jmoe
except ImportError:
    jax = None

from repro_torch.configs import registry
from repro_torch.models import lm, moe
from repro_torch.models.common import init_from_plan
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)

ARCHS = {"qwen2-moe": "qwen2-moe-a2.7b", "granite-moe": "granite-moe-3b-a800m"}
TOL = dict(atol=1e-5, rtol=1e-5)
LM_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _needs_reference(request):
    if jax is None and "gpu" not in request.keywords:
        pytest.skip("needs the JAX reference package")


def _cfgs(arch, **kw):
    name = ARCHS[arch]
    return (dataclasses.replace(jregistry.get(name).tiny(), dtype="float32", **kw),
            dataclasses.replace(registry.get(name).tiny(), dtype="float32", **kw))


@pytest.fixture(scope="module", params=sorted(ARCHS))
def model(request):
    """Both packages' configs and the reference's weights of one arch."""
    jcfg, cfg = _cfgs(request.param)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _layer(tree, l=0):
    return jax.tree_util.tree_map(lambda a: a[l], tree)


def _torch_layer(tree, l=0):
    return {k: _torch_layer(v, l) if isinstance(v, dict) else v[l] for k, v in tree.items()}


def _x(seed, shape, shift=0.0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) + np.float32(shift)


def _ref_topi(jcfg, jp, x):
    """The reference's routed indices (``moe.py:62-64``) for tokens x (N, d)."""
    gates = jax.nn.softmax((jnp.asarray(x) @ jp["router"]).astype(jnp.float32), axis=-1)
    return np.asarray(jax.lax.top_k(gates, jcfg.moe_topk)[1])


def _ref_drops(jcfg, topi):
    """Slots the reference drops, from its routed indices (N, k), by its
    capacity rule and sorted, searchsorted positions (``moe.py:73-85`` for
    global dispatch, ``:136-168`` per group for grouped)."""
    N, k = topi.shape
    E, cf = jcfg.n_experts, jcfg.capacity_factor
    if jcfg.moe_dispatch == "grouped":
        G = min(jcfg.moe_groups, N)
        while N % G:
            G //= 2
        n = N // G
        cap = int(max(8, -(-int(n * k / E * cf) // 8) * 8))
    else:
        G, n = 1, N
        cap = -(-int(max(1, round(N * k / E * cf))) // 128) * 128
    drops = 0
    for g in range(G):
        counts = np.bincount(topi[g * n:(g + 1) * n].reshape(-1), minlength=E)
        drops += int(np.maximum(counts - cap, 0).sum())
    return drops


def _both_moe(jcfg, cfg, jparams, params, x):
    jp, p = _layer(jparams["layers"]["moe"]), _torch_layer(params["layers"]["moe"])
    d = x.shape[-1]
    np.testing.assert_array_equal(moe.route(cfg, p, torch.as_tensor(x)).topi.reshape(-1, cfg.moe_topk).numpy(),
                                  _ref_topi(jcfg, jp, x.reshape(-1, d)))
    jout, jaux = jmoe.moe_apply(jcfg, jp, jnp.asarray(x))
    out, aux = moe.moe_apply(cfg, p, torch.as_tensor(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    return jp, p


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dispatch", ["global", "grouped"])
def test_moe_apply_matches_reference(model, dispatch):
    jcfg, cfg, jparams, params = model
    jcfg, cfg = (dataclasses.replace(c, moe_dispatch=dispatch) for c in (jcfg, cfg))
    _both_moe(jcfg, cfg, jparams, params, _x(0, (3, 40, cfg.d_model)))


@pytest.mark.parametrize("dispatch", ["global", "grouped"])
@pytest.mark.parametrize("kind", ["skewed", "crowded"])
def test_dropped_slots_match_reference(model, dispatch, kind):
    """Capacity binds: every token routed to expert 0 (a router column
    aligned with inputs shifted off zero), or 640 random tokens at a
    capacity factor of 0.5.  Both packages drop the same slots."""
    jcfg, cfg, jparams, params = model
    if kind == "skewed":
        kw, x = {}, _x(1, (2, 160, cfg.d_model), shift=1.0)
        router = np.array(jparams["layers"]["moe"]["router"])
        router[:, :, 0] = 0.5
        jparams = {**jparams, "layers": {**jparams["layers"], "moe": {
            **jparams["layers"]["moe"], "router": jnp.asarray(router)}}}
        params = {**params, "layers": {**params["layers"], "moe": {
            **params["layers"]["moe"], "router": torch.as_tensor(router)}}}
    else:
        kw, x = dict(capacity_factor=0.5), _x(2, (4, 160, cfg.d_model))
    jcfg, cfg = (dataclasses.replace(c, moe_dispatch=dispatch, **kw) for c in (jcfg, cfg))
    jp, p = _both_moe(jcfg, cfg, jparams, params, x)
    want = _ref_drops(jcfg, _ref_topi(jcfg, jp, x.reshape(-1, cfg.d_model)))
    assert want > 0
    assert int(moe.dropped_slots(cfg, p, torch.as_tensor(x))) == want


@pytest.mark.parametrize("ties", ["all", "pairs"])
def test_gate_ties_go_to_the_lower_index(ties):
    """Equal router columns give bit-equal gates; ``jax.lax.top_k`` picks
    the lower expert index first, and so must the port."""
    jcfg, cfg = _cfgs("qwen2-moe")
    r = np.random.default_rng(3).normal(size=(cfg.d_model, cfg.n_experts)).astype(np.float32) * 0.02
    if ties == "all":
        r[:] = r[:, :1]
    else:
        r[:, 1::2] = r[:, 0::2]
    x = _x(4, (64, cfg.d_model))
    topi = moe.route(cfg, {"router": torch.as_tensor(r)}, torch.as_tensor(x)).topi.numpy()
    want = _ref_topi(jcfg, {"router": jnp.asarray(r)}, x)
    np.testing.assert_array_equal(topi, want)
    if ties == "all":
        assert (topi == np.arange(cfg.moe_topk)).all()
    else:  # the top pair, lower index first
        assert (topi[:, 0] % 2 == 0).all() and (topi[:, 1] == topi[:, 0] + 1).all()


# ---------------------------------------------------------------------------
# the model: prefill, prefill_extend (with and without widths), decode_step
# ---------------------------------------------------------------------------

CAP = 80
T0, TC = 32, 16


@pytest.fixture(scope="module")
def prefilled(model):
    jcfg, cfg, jparams, params = model
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(3, T0)).astype(np.int32)
    jl, jc = jlm.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, pad_to=CAP)
    pl, c = lm.prefill(cfg, params, {"tokens": torch.as_tensor(toks)}, pad_to=CAP)
    return (jl, jc), (pl, c)


def _caches(jc):
    return lm.Caches(torch.as_tensor(np.array(jc.kv_k)), torch.as_tensor(np.array(jc.kv_v)),
                     torch.as_tensor(np.array(jc.length)))


def _assert_caches(c, jc, tol=LM_TOL):
    np.testing.assert_allclose(c.kv_k.numpy(), np.asarray(jc.kv_k), **tol)
    np.testing.assert_allclose(c.kv_v.numpy(), np.asarray(jc.kv_v), **tol)
    np.testing.assert_array_equal(c.length.numpy(), np.asarray(jc.length))


def test_prefill_matches_reference(prefilled):
    (jl, jc), (pl, c) = prefilled
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LM_TOL)
    _assert_caches(c, jc)


@pytest.mark.parametrize("widths", [None, (TC, 0, 5)], ids=["full", "widths"])
def test_prefill_extend_matches_reference(model, prefilled, widths):
    """On the reference's prefill cache; a width-0 row keeps its cache
    bit for bit while its tokens still take routing capacity."""
    jcfg, cfg, jparams, params = model
    (_, jc), _ = prefilled
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, size=(3, TC)).astype(np.int32)
    jw = None if widths is None else jnp.asarray(widths, jnp.int32)
    jl, jc2 = jlm.prefill_extend(jcfg, jparams, jnp.asarray(toks), jc, widths=jw)
    pl, c2 = lm.prefill_extend(cfg, params, torch.as_tensor(toks), _caches(jc), widths=widths)
    _assert_caches(c2, jc2)
    if widths is None:
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LM_TOL)
    else:
        for b, w in enumerate(widths):
            if w:
                np.testing.assert_allclose(pl[b].numpy(), np.asarray(jl[b]), **LM_TOL)
        np.testing.assert_array_equal(c2.kv_k[:, 1].numpy(), np.asarray(jc.kv_k[:, 1]))


def test_decode_step_matches_reference(model, prefilled):
    jcfg, cfg, jparams, params = model
    (jl, jc), _ = prefilled
    tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    for _ in range(3):  # each step from the reference's cache
        pl, c = lm.decode_step(cfg, params, torch.as_tensor(tok), _caches(jc))
        jl, jc = jlm.decode_step(jcfg, jparams, jnp.asarray(tok), jc)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LM_TOL)
        _assert_caches(c, jc)
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]


def test_text_batch_depends_on_its_batch_when_capacity_binds():
    """Capacity is set per call (``moe.py:73-76``), so a token's output
    depends on the other tokens of its call, padding and width-0 rows
    included: at a capacity factor of 0.5 a batch-4 ``prefill_extend`` with
    widths fills each expert's slots in token order, so its last row (after
    a width-0 row of padding) loses slots that the same row's batch-1
    recompute keeps.  The two differ in both packages, and the port equals
    the reference in each."""
    jcfg, cfg = _cfgs("qwen2-moe", capacity_factor=0.5)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(1))
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(7)
    ctx = rng.integers(0, cfg.vocab_size, size=(4, 16)).astype(np.int32)
    text = rng.integers(0, cfg.vocab_size, size=(4, 256)).astype(np.int32)
    widths = (256, 256, 0, 256)
    _, jc = jlm.prefill(jcfg, jparams, {"tokens": jnp.asarray(ctx)}, pad_to=16 + 256)
    _, jbatch = jlm.prefill_extend(jcfg, jparams, jnp.asarray(text), jc, widths=jnp.asarray(widths, jnp.int32))
    _, batch = lm.prefill_extend(cfg, params, torch.as_tensor(text), _caches(jc), widths=widths)
    _assert_caches(batch, jbatch)
    jc3 = jc._replace(kv_k=jc.kv_k[:, 3:], kv_v=jc.kv_v[:, 3:], length=jc.length[3:])
    _, jsolo = jlm.prefill_extend(jcfg, jparams, jnp.asarray(text[3:]), jc3)
    _, solo = lm.prefill_extend(cfg, params, torch.as_tensor(text[3:]), _caches(jc3))
    _assert_caches(solo, jsolo)
    new = slice(16, 16 + 256)
    assert np.abs(np.asarray(jbatch.kv_k[:, 3, new]) - np.asarray(jsolo.kv_k[:, 0, new])).max() > 1e-2
    assert (batch.kv_k[:, 3, new] - solo.kv_k[:, 0, new]).abs().max() > 1e-2


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def test_params_from_numpy_carries_the_moe_tree(model):
    """The stacked (L, E, d, ff) expert leaves and the router come across
    leaf for leaf; a tree with a leaf missing or mis-shaped is refused."""
    jcfg, cfg, jparams, params = model
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    e = tree["layers"]["moe"]["w_gate"]
    assert params["layers"]["moe"]["w_gate"].shape == e.shape == (cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)
    for name in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(params["layers"]["moe"][name].numpy(), tree["layers"]["moe"][name])
    assert ("shared" in params["layers"]["moe"]) == bool(cfg.n_shared_experts)
    bad = {**tree, "layers": {**tree["layers"], "moe": {**tree["layers"]["moe"], "w_up": e[:, :-1]}}}
    with pytest.raises(ValueError, match="w_up"):
        params_from_numpy(cfg, bad, "cpu")
    missing = {**tree, "layers": {**tree["layers"], "moe": {
        k: v for k, v in tree["layers"]["moe"].items() if k != "router"}}}
    with pytest.raises(ValueError, match="does not match the plan"):
        params_from_numpy(cfg, missing, "cpu")


def test_init_draws_expert_leaves_by_layer_and_dense_leaves_whole():
    """``init_params``: every leaf of the MoE plan at its shape, dtype and
    std; a dense config's leaves are each one draw from the generator, in
    sorted order, so its weights are as they were before the expert rule."""
    _, cfg = _cfgs("qwen2-moe")
    params = lm.init_params(dataclasses.replace(cfg, dtype="bfloat16"), torch.Generator().manual_seed(0), "cpu")
    w = params["layers"]["moe"]["w_gate"]
    assert w.dtype == torch.bfloat16 and w.shape == (cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)
    assert abs(float(w.float().std()) * np.sqrt(cfg.d_model) - 1) < 0.05
    assert abs(float(params["layers"]["moe"]["router"].float().std()) / 0.02 - 1) < 0.05
    assert not torch.equal(w[0], w[1])

    dense = registry.get("smollm-360m").tiny()
    gen = torch.Generator().manual_seed(0)
    got = lm.init_params(dense, gen, "cpu")
    gen.manual_seed(0)

    def whole(plan):  # the rule before expert leaves: one f32 draw a leaf
        out = {}
        for name in sorted(plan):
            leaf = plan[name]
            if isinstance(leaf, dict):
                out[name] = whole(leaf)
            elif leaf.init != "normal":
                out[name] = init_from_plan({name: leaf}, gen, "cpu", torch.bfloat16)[name]
            else:
                std = leaf.scale if leaf.scale is not None else 1.0 / np.sqrt(leaf.shape[-2])
                out[name] = (torch.randn(leaf.shape, generator=gen) * std).to(torch.bfloat16)
        return out

    want = whole(lm.param_plan(dense))
    flat = jax.tree_util.tree_leaves
    assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(want)))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dispatch", ["global", "grouped"])
def test_cuda_moe_apply_matches_cpu_and_repeats_bit_for_bit(cuda, dispatch):
    """f32 on the card against the CPU (the router's ties decided alike,
    products within 1e-4 as the matmuls sum in another order); bf16 twice
    on the card, bit-identical (no atomics in the combine)."""
    cfg = dataclasses.replace(registry.get(ARCHS["qwen2-moe"]).tiny(), dtype="float32", moe_dispatch=dispatch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p = _torch_layer(params["layers"]["moe"])
    x = torch.as_tensor(_x(8, (4, 96, cfg.d_model)))
    want, want_aux = moe.moe_apply(cfg, p, x)
    pc = {k: ({kk: vv.to(cuda) for kk, vv in v.items()} if isinstance(v, dict) else v.to(cuda)) for k, v in p.items()}
    got, aux = moe.moe_apply(cfg, pc, x.to(cuda))
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=1e-5, rtol=1e-5)
    pb = {k: ({kk: vv.bfloat16() for kk, vv in v.items()} if isinstance(v, dict) else v.bfloat16())
          for k, v in pc.items()}
    xb = x.to(cuda, torch.bfloat16)
    a, b = moe.moe_apply(cfg, pb, xb)[0], moe.moe_apply(cfg, pb, xb)[0]
    assert torch.equal(a, b)
