"""The port's collectives on ``torch.distributed`` against the reference.

One 4-rank gloo group on ``make_test_mesh(2, 2, device="cpu")``
(``tests/_torch_dist_world.py``) runs every spawned scenario of this file:

* olmo-1b ``.tiny()`` under ``{"embed": None, "kv_seq_decode": "model"}``:
  the port's ``prefill(pad_to=32)`` (K4's plain version on each rank's rows
  and heads, caches allocated split over S) and one ``decode_step`` on the
  reference's caches with lengths (24, 10), so row 1's ``kv_len`` of 11
  lies in shard 0's 16 slots only: logits and the updated caches
  (``full_tensor()``) against the reference's plain ``decode_step``, in
  f32 and bf16; the same step under ``{"embed": None, "kv_seq_decode":
  None}`` (each rank's rows whole, the plain decode);
* qwen2-moe-a2.7b ``.tiny()``, grouped (groups split over ``"data"``, ff
  over ``"model"``) and global dispatch, capacity factor 0.5 so slots
  drop: out and aux against the reference's single-device ``moe_apply``,
  the dropped slots against the port's single-process count;
* one qwen2-moe-a2.7b ``.tiny()`` f32 train step, grouped dispatch, under
  ``{"embed": None}``: the MoE layers' sharded combine under autograd (ff
  split over ``"model"``, the groups over ``"data"``) against the
  reference's single-device ``make_train_step``: the loss, ``grad_norm``
  and ``lr`` within 1e-5 relative, the step's gradients within 2e-5 of
  each leaf's largest |value|, and the state under
  ``tests/_torch_train_rule``'s rule;
* ``compressed_psum`` over ``"data"``: int8 symbols equal to the
  reference's under ``jax.vmap(axis_name="data")``, the mean within 1e-6
  of ``|x|max`` of the reference's and within one bin of the exact mean
  (the reference test's rule);
* ``constrain`` on DTensors (15 heads on the 2-way axis stay whole, 16
  split) and the staged all-gather's arithmetic.

The rest runs in process: ``param_specs`` of every registry config,
spec -> placements, the divisibility drop, the backend rule and the
world-size check.  Tolerances: f32 within 2e-5 of each tensor's largest
|value|, bf16 within 2e-2.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_train_rule import hold_trajectory, ref_leaves
from torch.distributed.tensor import Replicate, Shard

import _torch_dist_world as world
from repro.configs import registry as jregistry
from repro.models import build as jbuild
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.training import AdamWConfig as JAdamWConfig
from repro.training import optimizer as jopt
from repro.training import trainer as jtrainer
from repro.training.grad_compress import compressed_psum as jcompressed_psum
from repro.training.trainer import TrainState as JTrainState

from repro_torch.configs import registry
from repro_torch.launch import mesh as pmesh
from repro_torch.launch.mesh import Mesh, make_test_mesh
from repro_torch.models import build, lm, sharding
from repro_torch.training import AdamWConfig

B, T, CAP = 2, 24, 32
LENGTHS = (24, 10)  # row 1's kv_len 11 lies in the first of the two 16-slot shards
TOL = {"f32": 2e-5, "bf16": 2e-2}
PSUM_SHAPE = (8, 16)
TRAIN_OPT = dict(warmup_steps=1, lr=1e-3)
TRAIN_B, TRAIN_T = 4, 32


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, (err, tol * scale)


def _decode_inputs():
    """(inputs, the reference's outputs later): the reference's weights,
    prefill caches and first token; its decode step runs while the ranks do."""
    inputs, later = {}, {}
    for name, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        jcfg = dataclasses.replace(jregistry.get(world.DECODE_ARCH).tiny(), dtype=dtype)
        jmodel = jbuild(jcfg)
        jparams = jmodel.init_params(jax.random.PRNGKey(0))
        tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
        logits, caches = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, pad_to=CAP))(jparams, tokens)
        tok = np.asarray(jnp.argmax(logits[:, -1], -1)).astype(np.int32)[:, None]
        caches = caches._replace(length=jnp.asarray(LENGTHS, jnp.int32))
        inputs[name] = {"dtype": dtype, "params": _f32(jparams), "tokens": tokens, "cap": CAP, "tok": tok,
                        "kv_k": np.asarray(caches.kv_k, np.float32), "kv_v": np.asarray(caches.kv_v, np.float32),
                        "length": np.asarray(LENGTHS, np.int32)}

        def step(jmodel=jmodel, jparams=jparams, tok=tok, caches=caches, logits=logits):
            l1, c1 = jax.jit(jmodel.decode_step)(jparams, jnp.asarray(tok), caches)
            return {"prefill_logits": logits, "prefill_k": caches.kv_k, "prefill_v": caches.kv_v,
                    "sp_logits": l1, "sp_k": c1.kv_k, "sp_v": c1.kv_v, "length": c1.length}

        later[name] = step
    return inputs, later


def _moe_inputs():
    inputs, later = {}, {}
    for dispatch in ("grouped", "global"):
        kw = dict(moe_dispatch=dispatch, capacity_factor=0.5)
        jcfg = dataclasses.replace(jregistry.get(world.MOE_ARCH).tiny(), dtype="float32", **kw)
        jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
        x = np.random.default_rng(2).normal(size=(4, 160, jcfg.d_model)).astype(np.float32)
        inputs[dispatch] = {"cfg": kw, "params": _f32(jparams), "x": x}

        def layer(jcfg=jcfg, jparams=jparams, x=x):
            jp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"]["moe"])
            out, aux = jax.jit(lambda p, x: jmoe.moe_apply(jcfg, p, x))(jp, x)
            return {"out": np.asarray(out), "aux": float(aux)}

        later[dispatch] = layer
    return inputs, later


def _moe_train_inputs():
    """(inputs, the reference's step later): the grouped qwen2-moe-a2.7b
    ``.tiny()``'s weights drawn by the port (the reference's per-layer
    expert draw takes seconds) and handed to the reference as they are, and
    one batch."""
    kw = dict(dtype="float32", moe_dispatch="grouped")
    jmodel = jbuild(dataclasses.replace(jregistry.get(world.MOE_ARCH).tiny(), **kw))
    cfg = dataclasses.replace(registry.get(world.MOE_ARCH).tiny(), **kw)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    s0 = JTrainState(params=jparams, opt=jopt.init_opt_state(jparams), ef_error=None, step=jnp.zeros((), jnp.int32))
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_T)).astype(np.int32) for k in ("tokens", "labels")}

    def step():
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        s1, m1 = jax.jit(jtrainer.make_train_step(jmodel, JAdamWConfig(**TRAIN_OPT)))(s0, jbatch)
        grads = jax.jit(jax.grad(lambda p: jmodel.loss_fn(p, jbatch)[0]))(s0.params)
        return {"s0": s0, "s1": s1, "metrics": {k: float(v) for k, v in m1.items()},
                "grads": [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]}

    return {"params": _f32(jparams), "batch": batch, "opt": TRAIN_OPT}, step


def _psum_inputs():
    return [np.random.default_rng(100 + r).normal(size=PSUM_SHAPE).astype(np.float32) * (1 + r)
            for r in range(4)]


def _ref_symbols(x):
    """The reference's quantization lines of ``compressed_psum``
    (``grad_compress.py:59-61``) inside ``vmap``: (int8 symbols, scale)."""
    absmax = jax.lax.pmax(jnp.max(jnp.abs(x.astype(jnp.float32))), "data")
    scale = jnp.maximum(absmax / 127.0, 1e-12)
    return jnp.clip(jnp.round(x.astype(jnp.float32) / scale), -127, 127).astype(jnp.int8), scale


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    decode_in, decode_later = _decode_inputs()
    moe_in, moe_later = _moe_inputs()
    train_in, train_later = _moe_train_inputs()
    psum_in = _psum_inputs()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # the reference computes while the ranks run
        ranks = pool.submit(world.spawn, world.serve_scenarios, tmp_path_factory.mktemp("dist"),
                            {"decode": decode_in, "moe": moe_in, "moe_train": train_in, "psum": psum_in})
        ref = {"decode": {k: f() for k, f in decode_later.items()}, "moe": {k: f() for k, f in moe_later.items()},
               "moe_train": train_later(), "psum": psum_in}
        results, per_rank = ranks.result()
    return results, per_rank, ref


# ---------------------------------------------------------------------------
# spawned: the sequence-parallel decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_sharded_prefill_matches_reference(spawned, name):
    results, _, ref = spawned
    got, want = results[f"decode_{name}"], ref["decode"][name]
    for key in ("prefill_logits", "prefill_k", "prefill_v"):
        _close(got[key].float(), want[key], TOL[name])
    # the caches are split as ("layers", "batch", "kv_seq_decode", ...): rows over data, S over model
    assert got["placements"] == ("Shard(1)", "Shard(2)")


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_sequence_parallel_decode_matches_plain_decode(spawned, name):
    results, _, ref = spawned
    got, want = results[f"decode_{name}"], ref["decode"][name]
    _close(got["sp_logits"].float(), want["sp_logits"], TOL[name])
    for key in ("sp_k", "sp_v"):  # the new token's K/V landed on the shard that holds its slot
        _close(got[key].float(), want[key], TOL[name])
    np.testing.assert_array_equal(got["length"].numpy(), np.asarray(want["length"]))


def test_sequence_parallel_decode_writes_row_in_first_shard_only(spawned):
    """Row 1 writes slot 10 (shard 0); slot 10 + 16 of shard 1 keeps the
    prefill's K, so nothing was written twice or on the wrong shard."""
    results, _, ref = spawned
    got = results["decode_f32"]
    np.testing.assert_array_equal(got["sp_k"][:, 1, 26].numpy(), np.asarray(ref["decode"]["f32"]["prefill_k"])[:, 1, 26])
    assert not np.array_equal(got["sp_k"][:, 1, 10].numpy(), np.asarray(ref["decode"]["f32"]["prefill_k"])[:, 1, 10])


def test_decode_without_sequence_axis_runs_plain_decode_on_rows(spawned):
    results, _, ref = spawned
    _close(results["rows_logits"], ref["decode"]["f32"]["sp_logits"], TOL["f32"])
    _close(results["rows_k"], ref["decode"]["f32"]["sp_k"], TOL["f32"])
    assert results["rows_placements"] == ("Shard(1)", "Replicate")


# ---------------------------------------------------------------------------
# spawned: MoE's tensor-parallel expert combine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dispatch", ["grouped", "global"])
def test_sharded_moe_matches_reference(spawned, dispatch):
    results, _, ref = spawned
    got, want = results[f"moe_{dispatch}"], ref["moe"][dispatch]
    _close(got["out"], want["out"], TOL["f32"])
    assert abs(got["aux"] - want["aux"]) <= TOL["f32"] * abs(want["aux"])
    assert got["drops"] == got["drops_one"] > 0


def test_grouped_moe_splits_its_groups_over_data(spawned):
    results, _, _ = spawned
    assert results["moe_grouped"]["groups"] == (32, 16)  # each rank dispatches half of the 32 groups
    assert results["moe_global"]["groups"] == (1, 1)  # one group: every rank dispatches it


def test_sharded_moe_train_step_matches_reference(spawned):
    """One train step through the grouped MoE's sharded combine under
    autograd (its experts' ff split over ``"model"``, the groups over
    ``"data"``): the loss, ``grad_norm`` and ``lr`` within 1e-5 relative;
    the step's gradients, read off its first moments (``mu_1 = (1 - b1) c
    g`` from zero moments, ``c`` the clip factor), every leaf within 2e-5
    of the reference's gradient's largest |value| (the experts', the
    router's through the load-balancing loss too, and the layers' below);
    and the state after the step under the trajectory rule."""
    results, _, ref = spawned
    got, want = results["moe_train"], ref["moe_train"]
    for k in ("loss", "grad_norm", "lr"):
        assert abs(got["metrics"][k] - want["metrics"][k]) <= 1e-5 * abs(want["metrics"][k]), k
    assert got["metrics"]["aux"] > 0 and got["step"] == 1
    opt = AdamWConfig(**TRAIN_OPT)
    clip = min(1.0, opt.grad_clip / got["metrics"]["grad_norm"])
    grads = [mu.double().numpy() / ((1 - opt.b1) * clip) for mu in got["state"]["mu"]]
    assert len(grads) == len(want["grads"])
    for i, (g, w) in enumerate(zip(grads, want["grads"])):
        _close(g, w, TOL["f32"])
    port1 = {k: [x.double().numpy() for x in v] for k, v in got["state"].items()}
    port1["e"] = None
    held = hold_trajectory([ref_leaves(want["s0"]), port1], [ref_leaves(want["s0"]), ref_leaves(want["s1"])],
                           [grads], [[np.asarray(g, np.float64) for g in want["grads"]]],
                           [want["metrics"]["grad_norm"]], [want["metrics"]["lr"]], opt)
    assert held["flipped"] == 0.0


def test_sharded_moe_experts_split_over_ff(spawned):
    results, _, _ = spawned
    pl = results["moe_train"]["param_placements"]
    assert pl["layers/moe/w_gate"] == ("Replicate", "Shard(3)")  # ("layers", "experts", "embed", "mlp")
    assert pl["layers/moe/w_down"] == ("Replicate", "Shard(2)")  # ("layers", "experts", "mlp", "embed")


# ---------------------------------------------------------------------------
# spawned: compressed_psum
# ---------------------------------------------------------------------------


def _data_groups(per_rank):
    """{model coordinate: [rank at data 0, rank at data 1]}."""
    groups = {}
    for r, mine in enumerate(per_rank):
        groups.setdefault(mine["coord"][1], [None, None])[mine["coord"][0]] = r
    return groups


def test_compressed_psum_matches_reference(spawned):
    _, per_rank, ref = spawned
    for ranks in _data_groups(per_rank).values():
        xs = jnp.stack([jnp.asarray(ref["psum"][r]) for r in ranks])
        want = np.asarray(jax.vmap(lambda x: jcompressed_psum(x, "data"), axis_name="data")(xs))
        q, scale = jax.vmap(_ref_symbols, axis_name="data")(xs)
        for i, r in enumerate(ranks):
            np.testing.assert_array_equal(per_rank[r]["psum_q"].numpy(), np.asarray(q[i]))
            assert float(per_rank[r]["psum_scale"]) == float(scale[i])
            err = np.abs(per_rank[r]["psum"].numpy() - want[i]).max()
            assert err <= 1e-6 * float(np.abs(xs).max()), err


def test_compressed_psum_within_one_bin_of_exact_mean(spawned):
    _, per_rank, ref = spawned
    for ranks in _data_groups(per_rank).values():
        xs = np.stack([ref["psum"][r] for r in ranks])
        exact, bin_ = xs.mean(axis=0), float(np.abs(xs).max() / 127.0)
        for r in ranks:
            assert np.abs(per_rank[r]["psum"].numpy() - exact).max() <= bin_ * 1.01 + 1e-7
            got = per_rank[r]["psum_bf16"]
            assert got.dtype == torch.bfloat16
            # bf16 in: the symbols of the rounded input, the mean rounded once more
            assert np.abs(got.float().numpy() - exact).max() <= bin_ * 1.01 + 2 ** -8 * np.abs(exact).max() + 1e-7


# ---------------------------------------------------------------------------
# spawned: constrain on DTensors, the staged gather
# ---------------------------------------------------------------------------


def test_constrain_redistributes_dtensors(spawned):
    results, _, _ = spawned
    got = results["constrain"]
    assert got["heads15"] == ("Shard(0)", "Replicate")  # smollm's 15 heads stay whole on 2 ways
    assert got["heads16"] == ("Shard(0)", "Shard(2)")
    assert got["same"] and got["values"]


def test_staged_all_gather_equals_the_collective(spawned):
    results, _, _ = spawned
    assert torch.equal(results["staged"], results["staged_want"])


# ---------------------------------------------------------------------------
# in process: specs, placements, the backend rule, the world size
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", ["full", "tiny"])
@pytest.mark.parametrize("arch", registry.names())
def test_param_specs_match_reference(arch, size):
    cfg, jcfg = registry.get(arch), jregistry.get(arch)
    if size == "tiny":
        cfg, jcfg = cfg.tiny(), jcfg.tiny()
    assert build(cfg).param_specs() == jbuild(jcfg).param_specs()


def test_placements_of_specs():
    mesh = make_test_mesh(2, 2, device="cpu")
    assert sharding.placements((None, "model"), mesh) == [Replicate(), Shard(1)]
    assert sharding.placements(("model", "data"), mesh) == [Shard(1), Shard(0)]
    assert sharding.placements((("data", "model"), None), mesh) == [Shard(0), Shard(0)]
    assert sharding.placements((None, None), mesh) == [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="axis order"):
        sharding.placements((("model", "data"),), mesh)
    with pytest.raises(ValueError, match="two dimensions"):
        sharding.placements(("model", "model"), mesh)


def test_divisibility_drop_replicates_smollm_heads():
    mesh = make_test_mesh(2, 2, device="cpu")
    cfg = registry.get("smollm-360m")
    with sharding.use_rules(mesh, {"embed": None}):
        spec = sharding.logical_to_spec(("batch", "seq", "act_heads", "head_dim"))
        assert spec == ("data", None, "model", None)
        assert sharding.divisible(spec, (4, 8, cfg.n_heads, cfg.d_head), mesh) == ["data", None, None, None]
        assert sharding.divisible(spec, (4, 8, 16, cfg.d_head), mesh) == ["data", None, "model", None]
        assert sharding.divisible(spec, (3, 8, 16, cfg.d_head), mesh) == [None, None, "model", None]


def test_constrain_is_identity_on_plain_tensors():
    x = torch.randn(2, 3, 4)
    assert sharding.constrain(x, "batch", "seq", "act_embed") is x  # no rules
    with sharding.use_rules(make_test_mesh(2, 2, device="cpu")):
        assert sharding.constrain(x, "batch", "seq", "act_embed") is x
        assert sharding.distribute(x, ("batch", "seq", "act_embed")) is x  # not a process-group mesh
        with pytest.raises(ValueError, match="rank-3"):
            sharding.constrain(x, "batch", "seq")


def test_backend_rule():
    assert pmesh.backend_for(make_test_mesh(2, 2, device="cpu")) == "gloo"
    cards = [torch.device("cuda", i) for i in range(4)]
    assert pmesh.backend_for(Mesh(np.array(cards, dtype=object).reshape(2, 2), ("data", "model"))) == "nccl"
    assert pmesh.backend_for(Mesh([cards[0], cards[0]], ("data",))) == "gloo"  # a shared card
    assert pmesh.backend_for(Mesh([cards[0], cards[1], cards[0], cards[1]], ("data",))) == "gloo"


def test_world_size_must_equal_mesh_size(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="1 ranks cannot hold mesh"):
            pmesh.device_mesh(make_test_mesh(2, 2, device="cpu"))
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="outside a mesh"):
        pmesh.init_rank(make_test_mesh(2, 2, device="cpu"), 4, str(tmp_path / "other"))
