"""Shared set-up of the live-session and scheduler parity tests
(``tests/test_torch_session.py``, ``test_torch_faults.py``,
``test_torch_scheduler.py``, ``test_torch_continuous.py`` and
``test_torch_generation.py``): one tiny model, one store of encoded chunks
and one serving engine per package, built from the same weights and the
same bytes, and the checks that hold a port ``SessionResult`` to the
reference's.

Each package is a :class:`Side`: its modules and its objects.  A scenario
is a function of a side, so the same code builds the port's and the
reference's run, and :func:`run_both` gives the two results side by side.
"""
import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jregistry
from repro.core import codec as jcodec
from repro.models import lm as jlm
from repro.serving import generation as jgeneration
from repro.serving import kv_layout as jkv_layout
from repro.serving import scheduler as jscheduler
from repro.serving import session as jsession
from repro.serving.engine import Engine as JEngine
from repro.streaming import faults as jfaults
from repro.streaming import network as jnet
from repro.streaming import pipeline as jpipeline
from repro.streaming import storage as jst
from repro.streaming import streamer as jsm
from repro.streaming import transport as jtr

from repro_torch.configs import registry
from repro_torch.core import codec
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import generation
from repro_torch.serving import kv_layout
from repro_torch.serving import scheduler
from repro_torch.serving import session
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.serving.engine import Engine
from repro_torch.serving.mesh_engine import ShardedEngine
from repro_torch.streaming import adaptation as ad
from repro_torch.streaming import faults
from repro_torch.streaming import network as net
from repro_torch.streaming import pipeline
from repro_torch.streaming import storage as st
from repro_torch.streaming import streamer as sm
from repro_torch.streaming import transport as tr

TEXT = ad.TEXT
T_CTX, CHUNK = 100, 20  # five chunks, as the reference's session tests
GEN = 8  # greedy tokens generated from each result cache
R_SLOW = lambda t, p: 100.0  # noqa: E731  (recompute never fits: chunks ride the fetch path)
R_SCHED = lambda t, p: 0.15 * 1.25 * t / CHUNK  # noqa: E731  (the scheduler tests' recompute price)
COUNTERS = ("status", "n_retries", "n_degrades", "n_fault_text", "n_failed_attempts", "fault_counts",
            "salvaged_bytes", "refetched_bytes", "wire_bytes", "n_resumes", "n_mid_chunk_replans",
            "n_runs", "duplicate_bytes", "n_hedged", "n_cold_hits", "total_bytes", "slo_violated")


class F32Engine(Engine):
    """The port's engine over an f32 serving cache, so decoded lossy chunks
    are compared at f32 resolution (the default cache is bf16)."""

    def empty_caches(self, batch):
        return kv_layout.alloc_caches(self.cfg, batch, self.capacity, dtype=torch.float32, device=self.device)


class JF32Engine(JEngine):
    def empty_caches(self, batch):
        return jkv_layout.alloc_caches(self.cfg, batch, self.capacity, dtype=jnp.float32)


class F32ShardedEngine(ShardedEngine, F32Engine):
    """The port's row-sharded engine over an f32 serving cache (its shards
    allocate the dtype ``F32Engine`` allocates)."""


class JShardOracle(JF32Engine):
    """The reference's unsharded engine told it has ``n_shards`` row shards.
    The schedulers then size, balance and price its pool as on a mesh
    (``ShardedRowPool``, per-shard contention), and its per-request results
    are those of the reference's own ``ShardedEngine``
    (``tests/test_mesh_serving.py`` holds the two bit-identical)."""

    def __init__(self, *args, n_shards, **kw):
        super().__init__(*args, **kw)
        self.n_shards = n_shards


@dataclasses.dataclass
class Side:
    """One package's modules and objects for the same scenario."""

    net: types.ModuleType
    tr: types.ModuleType
    faults: types.ModuleType
    session: types.ModuleType
    st: types.ModuleType
    store: object
    streamer: object
    eng: object  # f32 serving cache
    eng_bf16: object  # the default (bf16) serving cache
    tables: object
    sched: types.ModuleType
    gen: types.ModuleType
    kv_layout: types.ModuleType
    pipeline: types.ModuleType

    def serve(self, *, bf16=False, rc=R_SLOW, slo_s=1.0, **kw):
        """A ``ServeSession`` of this package over its store and engine."""
        return self.session.ServeSession(
            self.streamer, self.eng_bf16 if bf16 else self.eng, slo_s=slo_s, recompute_s=rc,
            decode_bytes_per_s=1e9, **kw)

    def sched_session(self, **kw):
        """A ``ServeSession`` with the reference scheduler tests' knobs
        (``tests/test_scheduler.py::_mk_session``) over the f32 engine."""
        kw.setdefault("slo_s", 1.25)
        kw.setdefault("recompute_s", R_SCHED)
        kw.setdefault("decode_bytes_per_s", 1e9)
        kw.setdefault("max_run_tokens", 2 * CHUNK)
        return self.session.ServeSession(self.streamer, self.eng, **kw)

    def request(self, tokens, trace, *, start_t=0.0, prior=True, generation=None, **kw):
        """A ``SessionRequest`` for ``"ctx"`` over ``trace`` (``(name, args)``
        of ``BandwidthTrace``) with :meth:`sched_session`'s knobs; ``prior``
        seeds the estimate with the trace's first rate."""
        network = self.network(trace)
        return self.sched.SessionRequest(
            self.sched_session(**kw), "ctx", tokens, network,
            prior_throughput_gbps=float(network.trace.gbps[0]) if prior else None,
            start_t=start_t, generation=generation)

    def network(self, trace, **kw):
        """``trace`` is ``(constructor name, args)`` of ``BandwidthTrace``."""
        name, args = trace
        return self.net.NetworkModel(getattr(self.net.BandwidthTrace, name)(*args), **kw)

    def copy_store(self):
        """A store over a copy of this store's blobs (metadata shared), for
        scenarios that delete or overwrite entries."""
        out = self.st.KVStore(self.tables, backend=self.st.MemoryBackend())
        out.backend._mem = dict(self.store.backend._mem)
        out._meta = self.store._meta
        return out

    def copy_streamer(self, store):
        return type(self.streamer)(store, self.streamer.cfg)


def build_world(arch="smollm-360m"):
    """Both packages' sides on ``arch``'s f32 ``.tiny()`` and the
    reference's weight draw."""
    jcfg = dataclasses.replace(jregistry.get(arch).tiny(), dtype="float32")
    cfg = dataclasses.replace(registry.get(arch).tiny(), dtype="float32")
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    cap = T_CTX + GEN + 4
    jeng = JF32Engine(jcfg, jparams, cache_capacity=cap)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(1, T_CTX)).astype(np.int32)
    jlogits, jc = jeng.calculate_kv({"tokens": jnp.asarray(tokens)})
    kv = np.asarray(jkv_layout.caches_to_codec_kv(jc, 0, T_CTX), np.float32)
    jct = jcodec.profile([kv], jcodec.CodecConfig(precision=10))
    ct = codec.tables_from_numpy(
        anchor=np.asarray(jct.anchor.freqs),
        deltas={lvl: np.asarray(t.freqs) for lvl, t in jct.deltas.items()},
        ll_anchor=np.asarray(jct.ll_anchor.freqs),
        ll_delta=np.asarray(jct.ll_delta.freqs),
        table_idx=jct.table_idx, delta_scale=jct.delta_scale,
        config=codec.CodecConfig(**dataclasses.asdict(jct.config)),
        n_layers=jct.n_layers, n_channels=jct.n_channels, device="cpu",
    )
    jstore, store = jst.KVStore(jct), st.KVStore(ct)
    jmetas = jstore.store_kv("ctx", kv, chunk_tokens=CHUNK)
    metas = store.store_kv("ctx", kv, chunk_tokens=CHUNK)
    assert [dataclasses.asdict(m) for m in metas] == [dataclasses.asdict(m) for m in jmetas]
    sides = (
        Side(net, tr, faults, session, st, store, sm.CacheGenStreamer(store, cfg),
             F32Engine(cfg, params, cache_capacity=cap, device="cpu"),
             Engine(cfg, params, cache_capacity=cap, device="cpu"), ct,
             scheduler, generation, kv_layout, pipeline),
        Side(jnet, jtr, jfaults, jsession, jst, jstore, jsm.CacheGenStreamer(jstore, jcfg),
             jeng, JEngine(jcfg, jparams, cache_capacity=cap), jct,
             jscheduler, jgeneration, jkv_layout, jpipeline),
    )
    return dict(
        sides=sides, tokens=tokens, metas=metas, kv=kv,
        first=np.array(jnp.argmax(jlogits[:, -1], -1), np.int32),
        u=sum(m.sizes[1] for m in metas) * 8 / 1e9,  # level-1 context in one second
    )


def run_both(world, scenario, sides=None):
    """``scenario(side)`` for the port, then for the reference (``sides``,
    default the world's)."""
    return tuple(scenario(side) for side in (sides or world["sides"]))


def mesh_sides(world, n_shards):
    """The port's side on an f32 ``ShardedEngine`` over ``n_shards`` logical
    CPU shards, and the reference's on a :class:`JShardOracle` of as many
    shards (one pair per shard count, kept in the world)."""
    cache = world.setdefault("mesh_sides", {})
    if n_shards not in cache:
        port, ref = world["sides"]
        eng = F32ShardedEngine(port.eng.cfg, port.eng.params, cache_capacity=port.eng.capacity,
                               mesh=make_serving_mesh(n_shards, device="cpu"))
        jeng = JShardOracle(ref.eng.cfg, ref.eng.params, cache_capacity=ref.eng.capacity, n_shards=n_shards)
        cache[n_shards] = (dataclasses.replace(port, eng=eng), dataclasses.replace(ref, eng=jeng))
    return cache[n_shards]


def to_numpy(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def assert_same(world, res, jres):
    """Hold a port ``SessionResult`` to the reference's: decisions, virtual
    timelines, TTFT and every fault and salvage counter equal; the cache
    bit-exact on level-0 chunks, within 2e-5 on lossy chunks and within
    1e-4 on TEXT chunks (recomputed with f32 matrix products on top of the
    lossy prefix; ``tests/test_torch_engine.py``'s tolerance for
    ``prefill_extend``), with the same length; the same greedy tokens from it."""
    assert res.configs == jres.configs
    assert [dataclasses.asdict(t) for t in res.timelines] == [dataclasses.asdict(t) for t in jres.timelines]
    assert res.ttft_s == jres.ttft_s and res.slo_s == jres.slo_s
    for name in COUNTERS:
        assert getattr(res, name) == getattr(jres, name), name
    assert (res.failure is None) == (jres.failure is None)
    if res.failure is not None:
        assert res.failure.split(":")[0] == jres.failure.split(":")[0]
    n = int(res.caches.length[0])
    assert n == int(np.asarray(jres.caches.length)[0])
    bf16 = res.caches.kv_k.dtype == torch.bfloat16
    for m, config in zip(world["metas"], res.configs):
        if m.end > n:
            break
        sl = slice(m.start, m.end)
        for got, want in ((res.caches.kv_k, jres.caches.kv_k), (res.caches.kv_v, jres.caches.kv_v)):
            got, want = to_numpy(got[:, :, sl]), np.asarray(want[:, :, sl], np.float32)
            if config == 0:
                np.testing.assert_array_equal(got, want)
            elif bf16:  # one bf16 rounding of values within 2e-5
                np.testing.assert_allclose(got, want, atol=2e-2, rtol=1e-2)
            elif config == TEXT:
                np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
            else:
                np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    if res.status == "ok":
        port, ref = world["sides"]
        got = (port.eng_bf16 if bf16 else port.eng).generate_with_kv(
            res.caches, torch.as_tensor(world["first"]), GEN)
        want = (ref.eng_bf16 if bf16 else ref.eng).generate_with_kv(jres.caches, jnp.asarray(world["first"]), GEN)
        np.testing.assert_array_equal(got, np.asarray(want))


def reconcile(res):
    """Per-chunk and per-task wire ledger: salvaged + refetched == wire."""
    for tl in res.timelines:
        if tl.wire_bytes > 0:
            assert abs(tl.salvaged_bytes + tl.refetched_bytes - tl.wire_bytes) < 1e-6, tl
    assert abs(res.salvaged_bytes + res.refetched_bytes - res.wire_bytes) < 1e-6


def assert_same_timeline(tl, jtl):
    """Every field of a port ``RequestTimeline`` equals the reference's
    (an unset instant is NaN in both)."""
    for f in dataclasses.fields(jtl):
        a, b = getattr(tl, f.name), getattr(jtl, f.name)
        both_nan = isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b)
        assert both_nan or a == b, (f.name, a, b)


SCHED_COUNTERS = ("n_rounds", "n_decode_batches", "n_text_batches", "n_runs", "n_failed")
CONTINUOUS_COUNTERS = SCHED_COUNTERS + ("n_rows", "n_preemptions", "n_resumes", "n_gen_steps",
                                        "n_gen_tokens", "n_gen_slo_miss", "occupancy", "gen_occupancy")


def assert_same_scheduled(world, out, jout):
    """A port ``SchedulerResult``/``ContinuousResult`` against the
    reference's: every request's result (``assert_same``), the batching
    counters and, for the continuous loop, every ``RequestTimeline`` field,
    the occupancy samples and the preemption and generation counts."""
    names = CONTINUOUS_COUNTERS if hasattr(jout, "timeline") else SCHED_COUNTERS
    for name in names:
        assert getattr(out, name) == getattr(jout, name), name
    assert len(out.sessions) == len(jout.sessions)
    for res, jres in zip(out.sessions, jout.sessions):
        assert_same(world, res, jres)
    for tl, jtl in zip(getattr(out, "timeline", ()), getattr(jout, "timeline", ())):
        assert_same_timeline(tl, jtl)


def assert_caches_equal(a, b):
    """Two result caches equal bit for bit over the realized context."""
    assert a.configs == b.configs
    n = int(a.caches.length[0])
    assert n == int(b.caches.length[0])
    for x, y in ((a.caches.kv_k, b.caches.kv_k), (a.caches.kv_v, b.caches.kv_v)):
        assert torch.equal(x[:, :, :n], y[:, :, :n])


def is_port(side):
    return isinstance(side.eng.params["embed"], torch.Tensor)


def ideal(side):
    """A contention model under which stacking costs nothing (factor 1 at
    any width): the reference scheduler tests' ``IDEAL``."""
    return side.pipeline.ContentionModel({1: 1.0, 2: 1.0})


def continuous_both(world, traces, *, kws=None, arrivals=None, specs=None, priors=True, contention=ideal,
                    policy=None, sides=None, **sched_kw):
    """The same ``ContinuousScheduler`` run in both packages, held equal
    (``assert_same_scheduled``); returns the port's result.  ``traces`` are
    ``(name, args)`` of ``BandwidthTrace``, ``kws`` per-request session
    knobs, ``specs`` per-request ``GenerationSpec`` keywords (or None; the
    first token defaults to the context's own), ``policy`` the
    ``PreemptionPolicy`` keywords (None: no preemption), ``sides`` the
    port's and the reference's side (default the world's)."""
    kws = kws or [{} for _ in traces]
    arrivals = arrivals or [0.0] * len(traces)
    specs = specs or [None] * len(traces)

    def scenario(side):
        reqs = [side.request(world["tokens"], tr, start_t=a, prior=priors, **kw,
                             generation=None if sp is None else side.gen.GenerationSpec(
                                 **{"first_token": int(world["first"][0]), **sp}))
                for tr, kw, a, sp in zip(traces, kws, arrivals, specs)]
        pre = None if policy is None else side.sched.PreemptionPolicy(**policy)
        return side.sched.ContinuousScheduler(side.eng, contention=contention(side), preemption=pre,
                                              **sched_kw).run(reqs)

    out, jout = run_both(world, scenario, sides)
    assert_same_scheduled(world, out, jout)
    return out


def mesh_scenario(world, side):
    """A wave and an open loop of four requests on ``side``'s engine, both
    under ideal contention: two pinned to level 0 and generating, two
    adaptive (the falling trace plans lossy and TEXT chunks), arrivals
    staggered.  ``tests/test_torch_mesh_serving.py`` runs it on the port's
    sharded engine, the reference's oracle and, in a subprocess with two
    host devices, the reference's own ``ShardedEngine``."""
    u, first = world["u"], int(world["first"][0])
    traces = [("constant", (3 * u,)), ("steps", (0.2, [1.0 * u, 0.55 * u])),
              ("steps", (0.15, [2.0 * u, 0.4 * u])), ("constant", (4 * u,))]
    kws = [dict(fixed_level=0), {}, {}, dict(fixed_level=0)]
    specs = [5, None, 4, None]

    def requests(arrivals=(0.0,) * 4, gen=False):
        return [side.request(world["tokens"], tr, start_t=a, **kw,
                             generation=side.gen.GenerationSpec(n, first) if gen and n else None)
                for tr, kw, a, n in zip(traces, kws, arrivals, specs)]

    wave = side.sched.ConcurrentScheduler(side.eng, contention=ideal(side)).run(requests())
    loop = side.sched.ContinuousScheduler(side.eng, contention=ideal(side), gen_step_s=0.01).run(
        requests(arrivals=(0.0, 0.02, 0.04, 0.06), gen=True))
    return wave, loop
