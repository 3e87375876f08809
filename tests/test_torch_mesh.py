"""The port's mesh, logical-axis rules and per-shard row functions against
the reference's.

``launch.mesh``: the census and remedy when a mesh does not fit the visible
cards, ``make_serving_mesh(0)``, logical shards of the host with
``device="cpu"``, a mesh that names one device twice, and the arguments
``torch.distributed.device_mesh.init_device_mesh`` takes.
``models.sharding``: ``use_rules`` / ``logical_to_spec`` give the
reference's ``PartitionSpec`` entries on ``("data",)`` and ``("data",
"model")`` meshes (a one-device JAX mesh carries those names), with rule
overlays, and restore the previous rules on exit.
``calibration.sharded_contention_factors`` equals the reference's for 1-8
shards over one report.  ``kv_layout``'s ``insert_codec_runs_local``,
``restore_row_local`` and ``reset_rows_local`` equal the reference's at 1,
2 and 4 shards, the reference's run under ``jax.vmap(..., axis_name=
"data")`` over a stacked shard axis, where ``axis_index`` gives the shard
on one CPU device.  ``ShardedEngine`` refuses non-attention families and a
``cache_rows`` rule over two axes with the reference's messages.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.models import sharding as jsharding
from repro.serving import kv_layout as jkv_layout
from repro.serving.mesh_engine import ShardedEngine as JShardedEngine
from repro.streaming import calibration as jcalibration

from repro_torch.configs import registry
from repro_torch.launch import mesh as pmesh
from repro_torch.launch.mesh import Mesh, make_production_mesh, make_serving_mesh, make_test_mesh
from repro_torch.models import lm, sharding
from repro_torch.serving import kv_layout
from repro_torch.serving.mesh_engine import ShardedEngine
from repro_torch.streaming import calibration

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# launch/mesh.py
# ---------------------------------------------------------------------------


def test_make_serving_mesh_rejects_nonpositive():
    with pytest.raises(ValueError, match="data >= 1"):
        make_serving_mesh(0)
    with pytest.raises(ValueError, match="data >= 1"):
        make_serving_mesh(0, device="cpu")


def _visible():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def test_mesh_error_names_census_and_remedy():
    want = _visible() + 1
    with pytest.raises(RuntimeError) as e:
        make_serving_mesh(want)
    msg = str(e.value)
    assert f"need {want} devices for mesh ({want},) with axes ('data',)" in msg
    assert f"have {_visible()} visible (" in msg
    assert "Remediation" in msg and "CUDA_VISIBLE_DEVICES" in msg and "device='cpu'" in msg


def test_test_mesh_error_names_shape_and_axes():
    n = _visible()
    with pytest.raises(RuntimeError) as e:
        make_test_mesh(data=n + 1, model=2)
    msg = str(e.value)
    assert f"({n + 1}, 2)" in msg and "'data'" in msg and "'model'" in msg
    with pytest.raises(RuntimeError, match=r"\(2, 16, 16\) with axes \('pod', 'data', 'model'\)"):
        make_production_mesh(multi_pod=True)


def test_census_counts_cards_by_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "NVIDIA H100 80GB HBM3")
    assert pmesh._census() == "1 visible (1x cuda: NVIDIA H100 80GB HBM3)"
    with pytest.raises(RuntimeError, match=r"have 1 visible \(1x cuda: NVIDIA H100 80GB HBM3\)"):
        make_serving_mesh(2)
    m = make_serving_mesh(1)
    assert list(m.devices) == [torch.device("cuda", 0)]


def test_cpu_meshes_are_logical_shards_of_the_host():
    m = make_serving_mesh(4, device="cpu")
    assert m.shape == {"data": 4} and m.axis_names == ("data",)
    assert all(d == torch.device("cpu") for d in m.devices)
    t = make_test_mesh(2, 3, device="cpu")
    assert t.devices.shape == (2, 3) and t.shape == {"data": 2, "model": 3}
    # what torch.distributed.device_mesh.init_device_mesh takes
    assert (t.device_type, t.mesh_shape, t.mesh_dim_names) == ("cpu", (2, 3), ("data", "model"))


def test_mesh_built_directly_may_repeat_a_device():
    m = Mesh(["cpu", torch.device("cpu")], ("data",))
    assert m.shape == {"data": 2} and m.device_type == "cpu"
    with pytest.raises(ValueError, match="axis names"):
        Mesh(["cpu", "cpu"], ("data", "model"))
    with pytest.raises(ValueError, match="one device type"):
        Mesh(["cpu", "meta"], ("data",))


# ---------------------------------------------------------------------------
# models/sharding.py
# ---------------------------------------------------------------------------

LOGICAL = [(name,) for name in jsharding.DEFAULT_RULES] + [
    ("layers", "cache_rows", "kv_seq", "kv_heads", "head_dim"), ("batch", None, "act_heads"), (None,), ("unknown",),
]


def _jmesh(axes):
    return JMesh(np.asarray(jax.devices()[:1]).reshape((1,) * len(axes)), axes)


def _jspec(logical):
    return tuple(jsharding.logical_to_spec(logical))


@pytest.mark.parametrize("axes", [("data",), ("data", "model"), ("pod", "data", "model")])
@pytest.mark.parametrize("rules", [None, {"cache_rows": "data", "embed": None}, {"cache_rows": ("data", "model")}])
def test_logical_to_spec_equals_reference(axes, rules):
    assert sharding.DEFAULT_RULES == jsharding.DEFAULT_RULES
    assert sharding.DEFAULT_RULES is not jsharding.DEFAULT_RULES
    pm = Mesh(["cpu"] * 1, ("data",)) if axes == ("data",) else make_test_mesh(1, 1, device="cpu")
    if axes == ("pod", "data", "model"):
        pm = Mesh(np.asarray([torch.device("cpu")], dtype=object).reshape(1, 1, 1), axes)
    jm = _jmesh(axes)
    with sharding.use_rules(pm, rules), jsharding.use_rules(jm, rules):
        assert sharding.current_mesh() is pm
        for logical in LOGICAL:
            assert sharding.logical_to_spec(logical) == _jspec(logical), logical
        ns = sharding.named_sharding(("cache_rows", None))
        assert ns.mesh is pm and ns.spec == tuple(jsharding.named_sharding(("cache_rows", None)).spec)
    assert sharding.current_mesh() is None and sharding.named_sharding(("batch",)) is None
    assert sharding.logical_to_spec(("batch", "heads")) == (None, None) == _jspec(("batch", "heads"))


def test_use_rules_restores_the_previous_rules_on_exit():
    outer, inner = make_serving_mesh(2, device="cpu"), make_test_mesh(1, 1, device="cpu")
    with sharding.use_rules(outer, {"cache_rows": None}):
        with sharding.use_rules(inner):
            assert sharding.current_mesh() is inner and sharding.logical_to_spec(("heads",)) == ("model",)
        assert sharding.current_mesh() is outer
        assert sharding.logical_to_spec(("cache_rows", "heads")) == (None, None)
        with pytest.raises(KeyError):
            with sharding.use_rules(inner):
                raise KeyError("inside")
        assert sharding.current_mesh() is outer
    assert sharding.current_mesh() is None


# ---------------------------------------------------------------------------
# streaming/calibration.py
# ---------------------------------------------------------------------------


def test_sharded_contention_factors_equal_reference(tmp_path):
    report = {"host_backend": "cpu", "stacked": {
        str(m): {"stacked": {"bytes_per_s": r}} for m, r in ((1, 1e8), (2, 1.5e8), (4, 2.2e8), (8, 2.5e8))}}
    path = str(tmp_path / "bench.json")
    with open(path, "w") as f:
        json.dump(report, f)
    for n in range(1, 9):
        got = calibration.sharded_contention_factors(n, path)
        assert got == jcalibration.sharded_contention_factors(n, path), n
    assert calibration.sharded_contention_factors(1, path) == calibration.measured_contention_factors(path)
    assert calibration.sharded_contention_factors(3, str(tmp_path / "missing.json")) == {}
    for mod in (calibration, jcalibration):
        with pytest.raises(ValueError, match="n_shards >= 1"):
            mod.sharded_contention_factors(0, path)


# ---------------------------------------------------------------------------
# serving/kv_layout.py: the per-shard row functions
# ---------------------------------------------------------------------------

L, B, CAP, HKV, DH = 2, 8, 24, 2, 4
C = HKV * DH


def _pool(seed):
    r = np.random.default_rng(seed)
    k = r.standard_normal((L, B, CAP, HKV, DH)).astype(np.float32)
    v = r.standard_normal((L, B, CAP, HKV, DH)).astype(np.float32)
    length = r.integers(0, CAP, size=B).astype(np.int32)
    return k, v, length


def _stack(x, S):
    """(L, B, ...) -> (S, L, B/S, ...): the shard axis leading."""
    return np.stack(np.split(x, S, axis=1))


def _stack_len(length, S):
    return length.reshape(S, -1)


def _ref_local(fn, S, args, shard_args):
    """The reference's per-shard body under ``vmap`` over S shards."""
    body = jax.vmap(functools.partial(fn, axis="data"), in_axes=(0, 0, 0) + (None,) * len(args), axis_name="data")
    out = body(*(jnp.asarray(a) for a in shard_args), *args)
    return [np.asarray(o) for o in out]


def _port_local(fn, S, args, k, v, length):
    outs = [[], [], []]
    for s, (ks, vs, ls) in enumerate(zip(np.split(k, S, axis=1), np.split(v, S, axis=1), length.reshape(S, -1))):
        kt, vt, lt = torch.tensor(ks), torch.tensor(vs), torch.tensor(ls)
        ko, vo, lo = fn(kt, vt, lt, *args, shard=s)
        assert ko is kt and vo is vt  # in place
        for o, x in zip(outs, (ko, vo, lo)):
            o.append(x.numpy())
    return [np.stack(o) for o in outs]


@pytest.mark.parametrize("S", [1, 2, 4])
def test_insert_codec_runs_local_equals_reference(S):
    k, v, length = _pool(S)
    runs, rows, starts = (5, 3, 7, 2), (1, 6, 3, 7), (0, 4, CAP - 7, CAP - 2)  # two at the capacity edge
    kv_new = np.random.default_rng(9).standard_normal((L, 2, sum(runs), C)).astype(np.float32)
    want = _ref_local(
        lambda kk, vv, ll, kn, rw, st, axis: jkv_layout.insert_codec_runs_local(
            kk, vv, ll, kn, rw, st, run_tokens=runs, axis=axis),
        S, (jnp.asarray(kv_new), jnp.asarray(rows, jnp.int32), jnp.asarray(starts, jnp.int32)),
        (_stack(k, S), _stack(v, S), _stack_len(length, S)))
    got = _port_local(kv_layout.insert_codec_runs_local, S, (torch.tensor(kv_new), rows, starts, runs), k, v, length)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("row", [0, 3, 5, 7])
def test_restore_row_local_equals_reference(S, row):
    k, v, length = _pool(10 + S)
    T = 6
    r = np.random.default_rng(row)
    k_row = r.standard_normal((L, T, HKV, DH)).astype(np.float32)
    v_row = r.standard_normal((L, T, HKV, DH)).astype(np.float32)
    want = _ref_local(jkv_layout.restore_row_local, S,
                      (jnp.asarray(k_row), jnp.asarray(v_row), jnp.int32(row)),
                      (_stack(k, S), _stack(v, S), _stack_len(length, S)))
    got = _port_local(kv_layout.restore_row_local, S, (torch.tensor(k_row), torch.tensor(v_row), row), k, v, length)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("rows", [(0,), (7, 2), (1, 3, 4, 6)])
def test_reset_rows_local_equals_reference(S, rows):
    k, v, length = _pool(20 + S)
    want = _ref_local(jkv_layout.reset_rows_local, S, (jnp.asarray(rows, jnp.int32),),
                      (_stack(k, S), _stack(v, S), _stack_len(length, S)))
    got = _port_local(kv_layout.reset_rows_local, S, (list(rows),), k, v, length)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_local_rows_never_wrap_negative():
    local, mine = kv_layout._local_rows([0, 3, 4, 9], 2, 1)
    assert local == [2, 1, 2, 2] and mine == [False, True, False, False]


# ---------------------------------------------------------------------------
# serving/mesh_engine.py: what it refuses
# ---------------------------------------------------------------------------


def test_sharded_engine_refuses_non_attention_families():
    cfg = registry.get("mamba2-370m").tiny()
    jcfg = jregistry.get("mamba2-370m").tiny()
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as want:
        JShardedEngine(jcfg, jparams, cache_capacity=16, mesh=_jmesh(("data",)))
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError) as got:
        ShardedEngine(cfg, params, cache_capacity=16, mesh=make_serving_mesh(2, device="cpu"))
    assert str(got.value) == str(want.value)


def test_sharded_engine_rules_pick_the_row_axis():
    cfg = dataclasses.replace(registry.get("smollm-360m").tiny(), n_layers=1)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = make_test_mesh(2, 2, device="cpu")
    jcfg = dataclasses.replace(jregistry.get("smollm-360m").tiny(), n_layers=1)
    jmesh = _jmesh(("data", "model"))
    with pytest.raises(ValueError) as got:
        ShardedEngine(cfg, params, cache_capacity=16, mesh=mesh, rules={"cache_rows": ("data", "model")})
    with pytest.raises(ValueError) as want:
        JShardedEngine(jcfg, jlm.init_params(jcfg, jax.random.PRNGKey(0)), cache_capacity=16, mesh=jmesh,
                       rules={"cache_rows": ("data", "model")})
    assert str(got.value) == str(want.value)
    se = ShardedEngine(cfg, params, cache_capacity=16, mesh=mesh)
    assert (se.row_axis, se.n_shards, se.cache_rows(3)) == ("data", 2, 4)
    assert se._cache_spec == (None, "data", None, None, None)
    flat = ShardedEngine(cfg, params, cache_capacity=16, mesh=mesh, rules={"cache_rows": None})
    assert (flat.row_axis, flat.n_shards) == (None, 1)
    assert isinstance(flat.empty_caches(4), lm.Caches)
    with pytest.raises(ValueError, match="device type"):
        ShardedEngine(cfg, params, cache_capacity=16, mesh=mesh, device="meta")
