"""The port's row-sharded serving engine (``serving.mesh_engine``) against
the plain port ``Engine`` and the reference, on ``smollm-360m.tiny()`` in
f32 with the reference's weights and the same stored bytes
(``_torch_session_world``).

At one shard ``ShardedEngine`` is bit-identical to the port's ``Engine``
through every row primitive, ``ServeSession`` and both schedulers.  At 2
and 4 logical CPU shards the schedulers' per-request decisions, every
``RequestTimeline`` field, the batching counters and the greedy tokens
equal the reference's, and the caches lie within ``assert_same``'s
tolerances: the reference side is its unsharded engine told the shard
count (``JShardOracle``), whose per-request results the reference's own
mesh tests hold bit-identical to its ``ShardedEngine``; one subprocess runs
that ``ShardedEngine`` itself on two forced host devices.  A batch-1
``ServeSession`` on a 2-shard engine is served by the inherited methods; a
generation suspended on one shard resumes on the other and continues
token-exactly; each shard's tensors lie on its shard's device.
"""
import dataclasses
import math
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_session_world import (
    T_CTX,
    assert_caches_equal,
    assert_same,
    assert_same_scheduled,
    assert_same_timeline,
    build_world,
    continuous_both,
    ideal,
    mesh_scenario,
    mesh_sides,
    run_both,
)

from repro_torch.serving import kv_layout
from repro_torch.serving.kv_layout import ShardedCaches

torch.set_num_threads(1)

_TESTS = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_TESTS), "src")


@pytest.fixture(scope="module")
def world():
    return build_world()


def _port(world, n_shards):
    return mesh_sides(world, n_shards)[0]


def _serialized(side):
    return side.pipeline.ContentionModel({})


def _assert_bit_identical(a, b):
    """Two port scheduler results, request for request, bit for bit."""
    for name in ("n_rounds", "n_decode_batches", "n_text_batches", "n_runs"):
        assert getattr(a, name) == getattr(b, name), name
    for x, y in zip(a.sessions, b.sessions):
        assert x.ttft_s == y.ttft_s
        assert [dataclasses.asdict(t) for t in x.timelines] == [dataclasses.asdict(t) for t in y.timelines]
        assert_caches_equal(x, y)
    for ta, tb in zip(getattr(a, "timeline", ()), getattr(b, "timeline", ())):
        assert_same_timeline(ta, tb)


# ---------------------------------------------------------------------------
# one shard: bit-identical to the plain Engine
# ---------------------------------------------------------------------------


def test_mesh1_primitives_bit_identical(world):
    """Every row primitive on an 8-row cache: the same caches and the same
    logits of the rows that take part, bit for bit."""
    plain, sharded = world["sides"][0].eng, _port(world, 1).eng
    assert sharded.n_shards == 1 and sharded.row_axis == "data" and sharded.cache_rows(5) == 5
    cfg = plain.cfg
    rng = np.random.default_rng(3)
    kv = torch.as_tensor(world["kv"])
    runs, rows, starts = (10, 14, 8), (1, 4, 6), (0, 0, 0)
    texts = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(8, 6)))
    widths = np.array([0, 6, 0, 0, 6, 0, 6, 0])
    toks = rng.integers(0, cfg.vocab_size, size=(8, 1)).astype(np.int32)
    active = widths > 0
    outs = []
    for e in (plain, sharded):
        c = e.empty_caches(8)
        assert isinstance(c, type(plain.empty_caches(1)))
        c = e.insert_runs(c, kv[:, :, :sum(runs)], rows, starts, runs)
        lx, c = e.prefill_extend_rows(texts, c, widths)
        lg, c = e.prefill_extend_gather(texts[[6, 1]], c, [6, 1])
        ld, c = e.decode_step_rows(toks, c, active)
        snap = e.save_row(c, 4, int(c.length[4]))
        c = e.reset_rows(c, [4])
        c = e.restore_row(c, snap, 2)
        outs.append((c, lx[active], lg, ld[active]))
    (ca, *la), (cb, *lb) = outs
    for x, y in zip(ca[:3], cb[:3]):
        assert torch.equal(x, y)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def test_mesh1_serve_session_bit_identical(world):
    u = world["u"]
    trace = ("steps", (0.2, [1.0 * u, 0.55 * u]))
    a, b = [dataclasses.replace(world["sides"][0], eng=e).sched_session().run(
        "ctx", world["tokens"], world["sides"][0].network(trace)) for e in (world["sides"][0].eng, _port(world, 1).eng)]
    assert a.configs == b.configs and a.ttft_s == b.ttft_s
    assert_caches_equal(a, b)


def test_mesh1_schedulers_bit_identical(world):
    """The wave, then continuous admission with queueing and generation
    under serialized contention, on one shard and on the plain Engine."""
    u, first = world["u"], int(world["first"][0])
    traces = [("constant", (3 * u,)), ("steps", (0.2, [1.0 * u, 0.55 * u])), ("constant", (50 * u,))]
    specs = [6, None, 4]
    arrivals = [0.0, 0.05, 0.3]
    sides = (world["sides"][0], _port(world, 1))

    def wave(side):
        return side.sched.ConcurrentScheduler(side.eng, contention=_serialized(side)).run(
            [side.request(world["tokens"], tr) for tr in traces])

    def cont(side):
        return side.sched.ContinuousScheduler(side.eng, rows=2, contention=_serialized(side), gen_step_s=0.01).run(
            [side.request(world["tokens"], tr, start_t=a,
                          generation=None if n is None else side.gen.GenerationSpec(n, first))
             for tr, a, n in zip(traces, arrivals, specs)])

    _assert_bit_identical(*run_both(world, wave, sides))
    a, b = run_both(world, cont, sides)
    _assert_bit_identical(a, b)
    assert a.gen_occupancy == b.gen_occupancy and a.occupancy == b.occupancy
    assert a.n_gen_tokens == 10 and any(t.queue_wait_s > 0 for t in a.timeline)


# ---------------------------------------------------------------------------
# 2 and 4 shards: the reference's results
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [2, 4])
def test_meshN_schedulers_match_reference(world, n_shards):
    """2S staggered requests (half generating) through both schedulers on S
    shards, the reference's mesh test: every request's decisions, timeline
    and tokens equal the reference's, and admissions land on every
    shard."""
    u = world["u"]
    sides = mesh_sides(world, n_shards)
    assert sides[0].eng.n_shards == n_shards and sides[0].eng.cache_rows(n_shards + 1) == 2 * n_shards
    n = 2 * n_shards
    traces = [("constant", ((3 + (i % 3)) * u,)) for i in range(n)]
    kws = [dict(fixed_level=0) for _ in range(n)]

    def wave(side):
        return side.sched.ConcurrentScheduler(side.eng, contention=ideal(side)).run(
            [side.request(world["tokens"], tr, **kw) for tr, kw in zip(traces, kws)])

    out, jout = run_both(world, wave, sides)
    assert isinstance(out.caches, ShardedCaches) and len(out.caches.shards) == n_shards
    assert_same_scheduled(world, out, jout)
    shard = continuous_both(world, traces, kws=kws, arrivals=[0.02 * i for i in range(n)],
                            specs=[dict(n_tokens=5) if i % 2 else None for i in range(n)],
                            gen_step_s=0.01, sides=sides)
    rows_per_shard = shard.n_rows // n_shards
    assert {r // rows_per_shard for t in shard.timeline for r in t.rows_used} == set(range(n_shards))
    assert shard.n_gen_tokens == 5 * n_shards


def test_mesh2_adaptive_scenario_matches_reference(world):
    """Lossy levels and TEXT recompute through the sharded primitives: the
    shared scenario (``mesh_scenario``) on 2 shards against the reference."""
    outs, jouts = run_both(world, lambda side: mesh_scenario(world, side), mesh_sides(world, 2))
    configs = {c for out in outs for s in out.sessions for c in s.configs}
    assert len(configs) >= 2 and outs[0].n_text_batches >= 1
    for out, jout in zip(outs, jouts):
        assert_same_scheduled(world, out, jout)


def test_mesh2_serve_session_is_served_unsharded(world):
    """A batch-1 ``ServeSession`` cache does not divide over 2 shards: the
    inherited methods serve it, equal to the plain Engine's bit for bit and
    to the reference's session."""
    u = world["u"]
    trace = ("steps", (0.15, [2.0 * u, 0.4 * u]))
    port, ref = mesh_sides(world, 2)
    assert isinstance(port.eng.empty_caches(1), type(world["sides"][0].eng.empty_caches(1)))
    res, jres = run_both(world, lambda side: side.sched_session().run("ctx", world["tokens"], side.network(trace)),
                         (port, ref))
    assert_same(world, res, jres)
    plain = world["sides"][0].sched_session().run("ctx", world["tokens"], world["sides"][0].network(trace))
    assert res.configs == plain.configs and res.ttft_s == plain.ttft_s
    assert_caches_equal(res, plain)


def test_mesh2_suspend_resume_crosses_shards(world):
    """Rows = 2 (one a shard), both generating when a tight-deadline load
    arrives: the least-work victim suspends mid-stream, takes the other
    shard's row when it resumes, and both token streams equal the greedy
    oracle's from their caches (and the reference's run)."""
    u, first = world["u"], world["first"]
    sides = mesh_sides(world, 2)
    out = continuous_both(
        world, [("constant", (3 * u,)), ("constant", (6 * u,)), ("constant", (50 * u,))],
        kws=[dict(fixed_level=0), dict(fixed_level=0), dict(fixed_level=0, slo_s=0.6)],
        arrivals=[0.0, 0.0, 0.55], specs=[dict(n_tokens=10), dict(n_tokens=12), None],
        rows=2, gen_step_s=0.05, policy=dict(victim="least_work"), sides=sides)
    assert out.n_preemptions >= 1 and out.n_resumes >= 1
    victim = out.timeline[0]
    assert victim.preempt_ts and victim.preempt_ts[0] > victim.finish_t
    assert 0 < sum(1 for ts in victim.token_ts if ts <= victim.preempt_ts[0]) < 10
    assert {r // (out.n_rows // 2) for r in victim.rows_used} == {0, 1}
    eng = sides[0].eng
    for i, n in ((0, 10), (1, 12)):
        want = eng.generate_with_kv(out.sessions[i].caches, torch.as_tensor(first), n)[0]
        assert out.timeline[i].tokens_out == want.tolist(), i
    assert out.sessions[2].ttft_s < 0.6 and all(s.status == "ok" for s in out.sessions)


def test_shard_tensors_report_their_shards_device(world):
    port = _port(world, 2)
    eng = port.eng
    out = port.sched.ConcurrentScheduler(eng, contention=ideal(port)).run(
        [port.request(world["tokens"], ("constant", (4 * world["u"],)), fixed_level=0) for _ in range(3)])
    pool = out.caches
    assert isinstance(pool, ShardedCaches) and kv_layout.cache_batch(pool) == 4
    assert eng.shard_devices == list(eng.mesh.devices)
    for s, part in enumerate(pool.shards):
        for t in (part.kv_k, part.kv_v, part.length):
            assert t.device == eng.shard_devices[s]
        assert part.length.shape == (2,)
    for row in range(4):
        s, local = pool.locate(row)
        assert kv_layout.extract_row(pool, row).kv_k.device == eng.shard_devices[s]
        assert torch.equal(kv_layout.extract_row(pool, row).kv_k, pool.shards[s].kv_k[:, local:local + 1])
    snap = eng.save_row(pool, 3, T_CTX)
    assert snap.kv_k.device == eng.shard_devices[1]
    assert kv_layout.cache_dtype(pool) == torch.float32 and kv_layout.has_kv(pool)
    assert torch.equal(pool.gather().length, torch.tensor([T_CTX, T_CTX, T_CTX, 0], dtype=torch.int32))


# ---------------------------------------------------------------------------
# the reference's own ShardedEngine, on two forced host devices
# ---------------------------------------------------------------------------

_REFERENCE_SHARDED = r"""
import dataclasses, pickle, sys
sys.path[:0] = [{tests!r}, {src!r}]
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding
from _torch_session_world import build_world, mesh_scenario
from repro.launch.mesh import make_serving_mesh
from repro.models.lm import Caches
from repro.serving import kv_layout
from repro.serving.mesh_engine import ShardedEngine

assert len(jax.devices()) == 2, jax.devices()


class F32Sharded(ShardedEngine):
    def empty_caches(self, batch):
        c = kv_layout.alloc_caches(self.cfg, batch, self.capacity, dtype=jnp.float32)
        if self.n_shards == 1 or batch % self.n_shards:
            return c
        sc, sr = NamedSharding(self.mesh, self._cache_spec), NamedSharding(self.mesh, self._rows_spec)
        return c._replace(kv_k=jax.device_put(c.kv_k, sc), kv_v=jax.device_put(c.kv_v, sc),
                          length=jax.device_put(c.length, sr))


world = build_world()
ref = world["sides"][1]
eng = F32Sharded(ref.eng.cfg, ref.eng.params, cache_capacity=ref.eng.capacity, mesh=make_serving_mesh(2))
outs = mesh_scenario(world, dataclasses.replace(ref, eng=eng))


def host(res):
    return dataclasses.replace(res, caches=Caches(*(None if x is None else np.asarray(x) for x in res.caches)))


outs = [dataclasses.replace(o, sessions=[host(s) for s in o.sessions],
                            **({{"caches": None}} if hasattr(o, "caches") else {{}})) for o in outs]
with open({out!r}, "wb") as f:
    pickle.dump(outs, f)
print("shards", eng.n_shards, [s.configs for o in outs for s in o.sessions])
"""


def test_reference_sharded_engine_on_two_host_devices(world, tmp_path):
    path = str(tmp_path / "reference.pkl")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2", JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join([_SRC, env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_SHARDED.format(tests=_TESTS, src=_SRC, out=path)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr[-4000:]}"
    assert proc.stdout.startswith("shards 2")
    with open(path, "rb") as f:
        jouts = pickle.load(f)
    outs = mesh_scenario(world, _port(world, 2))
    for out, jout in zip(outs, jouts):
        assert_same_scheduled(world, out, jout)
    assert math.isclose(outs[1].n_gen_tokens, 9)
