"""The port's continuous batched generation (``GenerationSpec``,
``GenerationTask``, ``Engine.decode_step_rows`` and the generation phase of
``ContinuousScheduler``) against the reference's, on ``smollm-360m.tiny()``
in f32 with the reference's weights and the same stored bytes.

The cases are those of ``tests/test_generation.py``: ``decode_step_rows``
equals the greedy oracle and keeps inactive rows bit for bit (a full row
among them); N = 1 generation is token-identical to ``generate_with_kv``; a
zero-token spec is the load-only path; a mixed wave stacks steps and is
deterministic; generation charges contention; a generating row suspends
and resumes bit-exactly; seeded sampling draws the reference's token ids;
the per-token SLO is accounted and lets the straggler policy preempt
generation.  Every scheduled run must equal the reference's: tokens, their
virtual emission times and every other ``RequestTimeline`` field, the
occupancy samples and the counters (``_torch_session_world.
assert_same_scheduled``).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_session_world import T_CTX, build_world, continuous_both, ideal, is_port, run_both

torch.set_num_threads(1)

GEN = 8


@pytest.fixture(scope="module")
def world():
    return build_world()


def _generate(world, traces, specs, **kw):
    """``continuous_both`` with generation ``specs``, each request pinned
    to level 0 unless ``kws`` says otherwise."""
    kw.setdefault("kws", [dict(fixed_level=0) for _ in traces])
    return continuous_both(world, traces, specs=specs, **kw)


def _oracle(world, caches, n):
    """Greedy reference: the port's ``generate_with_kv`` on a result cache."""
    port = world["sides"][0]
    return port.eng.generate_with_kv(caches, torch.as_tensor([world["first"][0]]), n)[0].tolist()


def _spec(n, **kw):
    """``GenerationSpec`` keywords for ``n`` tokens (from the context's own
    first token: the argmax of its prefill's last logits)."""
    return dict(n_tokens=n, **kw)


# ---------------------------------------------------------------------------
# engine: decode_step_rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("full_row", [False, True], ids=["ragged", "inactive_row_full"])
def test_decode_step_rows_matches_oracle_and_preserves_inactive(world, full_row):
    """Six stacked steps with only row 1 active: row 1's argmax chain equals
    ``generate_with_kv`` on its own cache, rows 0 and 2 keep their K/V and
    lengths bit for bit — row 2 also when it sits at ``length ==
    capacity`` (``lm.decode_step`` would clamp its write onto its last
    slot) — and the port's tokens and logits equal the reference's."""
    rng = np.random.default_rng(3)
    toks = rng.integers(0, world["sides"][0].eng.cfg.vocab_size, size=(3, 32)).astype(np.int32)

    def scenario(side):
        eng = side.eng
        port = is_port(side)
        logits, caches = eng.prefill_extend_rows(torch.as_tensor(toks) if port else jnp.asarray(toks),
                                                 eng.empty_caches(3), np.full(3, 32))
        lengths = [32, 32, eng.capacity if full_row else 32]
        if full_row:  # row 2 filled to capacity with its own 32 tokens' K/V, repeated
            reps = -(-eng.capacity // 32)
            if port:
                caches.kv_k[:, 2] = caches.kv_k[:, 2, :32].repeat(1, reps, 1, 1)[:, :eng.capacity]
                caches.kv_v[:, 2] = caches.kv_v[:, 2, :32].repeat(1, reps, 1, 1)[:, :eng.capacity]
                caches = caches._replace(length=torch.tensor(lengths, dtype=torch.int32))
            else:
                tile = lambda x: jnp.tile(x[:, 2, :32], (1, reps, 1, 1))[:, :eng.capacity]  # noqa: E731
                caches = caches._replace(kv_k=caches.kv_k.at[:, 2].set(tile(caches.kv_k)),
                                         kv_v=caches.kv_v.at[:, 2].set(tile(caches.kv_v)),
                                         length=jnp.asarray(lengths, jnp.int32))
        row1 = side.kv_layout.extract_row(caches, 1)
        first = int(np.argmax(np.asarray(logits[1, -1], np.float32) if not port else logits[1, -1].numpy()))
        want = eng.generate_with_kv(row1, torch.tensor([first]) if port else jnp.asarray([first], jnp.int32), 6)
        before = [np.array(np.asarray(x[:, r], np.float32) if not port else x[:, r].float().numpy())
                  for x in (caches.kv_k, caches.kv_v) for r in (0, 2)]
        tok = np.array([[0], [first], [0]], np.int32)
        active = np.array([False, True, False])
        got, step_logits = [], []
        for _ in range(6):
            lg, caches = eng.decode_step_rows(tok if port else jnp.asarray(tok), caches,
                                              active if port else jnp.asarray(active))
            lg = lg.numpy() if port else np.asarray(lg, np.float32)
            tok[1, 0] = int(np.argmax(lg[1, -1]))
            got.append(int(tok[1, 0]))
            step_logits.append(lg[1, -1])
        assert got == np.asarray(want)[0].tolist()
        after = [np.asarray(x[:, r], np.float32) if not port else x[:, r].float().numpy()
                 for x in (caches.kv_k, caches.kv_v) for r in (0, 2)]
        for b, a in zip(before, after):
            assert np.array_equal(a, b)
        assert [int(x) for x in caches.length] == [32, 38, lengths[2]]
        return got, np.stack(step_logits)

    (got, lg), (jgot, jlg) = run_both(world, scenario)
    assert got == jgot
    np.testing.assert_allclose(lg, jlg, atol=1e-4, rtol=1e-4)


def test_decode_step_rows_validates_shapes(world):
    for side in world["sides"]:
        eng = side.eng
        caches = eng.empty_caches(2)
        with pytest.raises(ValueError, match="tokens"):
            eng.decode_step_rows(np.zeros((2, 3), np.int32), caches, np.ones(2, bool))
        with pytest.raises(ValueError, match="active"):
            eng.decode_step_rows(np.zeros((2, 1), np.int32), caches, np.ones(3, bool))


# ---------------------------------------------------------------------------
# scheduler: N = 1 oracle identity, load-only degeneration
# ---------------------------------------------------------------------------


def test_generation_n1_matches_greedy_oracle(world):
    u = world["u"]
    out = _generate(world, [("constant", (3 * u,))], [_spec(GEN)])
    tl = out.timeline[0]
    res = out.sessions[0].caches
    assert tl.tokens_out == _oracle(world, res, GEN)
    assert tl.n_tokens_out == GEN and out.n_gen_tokens == GEN and out.n_gen_steps == GEN
    assert all(b > a for a, b in zip(tl.token_ts, tl.token_ts[1:]))
    assert tl.token_ts[0] > tl.finish_t and tl.gen_finish_t == tl.token_ts[-1]
    assert tl.mean_tpot_s == pytest.approx(2e-3)
    assert max(n for _, n in out.gen_occupancy) == 1
    # the result holds the cache the load realized: a copy taken at load
    # finish, untouched by the eight tokens generated on the pool row after
    assert int(res.length[0]) == T_CTX and not res.kv_k[:, :, T_CTX:].any() and not res.kv_v[:, :, T_CTX:].any()


def test_zero_token_spec_bit_identical_to_load_only(world):
    u = world["u"]
    traces = [("constant", (3 * u,)), ("steps", (0.2, [1.0 * u, 0.55 * u]))]
    none = _generate(world, traces, [None, None], kws=[{}, {}])
    zero = _generate(world, traces, [_spec(0)] * 2, kws=[{}, {}])
    assert none.n_rounds == zero.n_rounds and none.n_gen_steps == zero.n_gen_steps == 0
    assert none.gen_occupancy == zero.gen_occupancy == []
    for x, y in zip(none.sessions, zero.sessions):
        assert x.configs == y.configs and x.ttft_s == y.ttft_s
        assert torch.equal(x.caches.kv_k, y.caches.kv_k) and torch.equal(x.caches.kv_v, y.caches.kv_v)
    for tl in zero.timeline:
        assert tl.tokens_out == [] and np.isnan(tl.gen_finish_t)


# ---------------------------------------------------------------------------
# continuous batching: interleaving, stacking, determinism, contention
# ---------------------------------------------------------------------------


def test_mixed_wave_stacks_generation_and_is_deterministic(world):
    """Four staggered arrivals on two rows, three generating: steps
    interleave with loads, ready rows stack (width 2), each generating
    request matches its own oracle, and a second run repeats the first."""
    u = world["u"]
    traces = [("constant", (3 * u,)), ("constant", (2.5 * u,)), ("constant", (2 * u,)), ("constant", (3 * u,))]
    specs = [_spec(12), _spec(10), _spec(8), None]

    def run():
        return _generate(world, traces, specs, arrivals=[0.0, 0.02, 0.35, 0.4], rows=2, gen_step_s=0.02)

    a, b = run(), run()
    assert [t.tokens_out for t in a.timeline] == [t.tokens_out for t in b.timeline]
    assert [t.token_ts for t in a.timeline] == [t.token_ts for t in b.timeline]
    assert a.gen_occupancy == b.gen_occupancy
    assert max(n for _, n in a.gen_occupancy) == 2
    assert min(t for t, _ in a.gen_occupancy) < max(t.finish_t for t in a.timeline)
    for i, n in enumerate([12, 10, 8]):
        assert a.timeline[i].tokens_out == _oracle(world, a.sessions[i].caches, n)
    assert a.timeline[3].tokens_out == []
    assert sorted(a.timeline[2].rows_used + a.timeline[3].rows_used) == [0, 1]  # recycled rows


@pytest.mark.parametrize("serialized", [False, True], ids=["ideal", "serialized"])
def test_generation_charges_contention(world, serialized):
    u = world["u"]
    contention = (lambda side: side.pipeline.ContentionModel({})) if serialized else ideal
    out = _generate(world, [("constant", (3 * u,))] * 2, [_spec(6)] * 2,
                    contention=contention, rows=2, gen_step_s=0.01)
    assert max(n for _, n in out.gen_occupancy) == 2
    assert out.timeline[0].mean_tpot_s == pytest.approx(0.02 if serialized else 0.01)


# ---------------------------------------------------------------------------
# suspend/resume mid-generation, gen-SLO
# ---------------------------------------------------------------------------


def test_suspend_resume_mid_generation_bit_exact(world):
    u = world["u"]
    spec = _spec(10)
    solo = _generate(world, [("constant", (3 * u,))], [spec], rows=1, gen_step_s=0.05)
    want = solo.timeline[0].tokens_out
    assert want == _oracle(world, solo.sessions[0].caches, 10)
    out = _generate(world, [("constant", (3 * u,)), ("constant", (50 * u,))], [spec, None],
                    arrivals=[0.0, solo.timeline[0].finish_t + 0.13], rows=1, gen_step_s=0.05,
                    policy=dict(victim="least_work"))
    t0, t1 = out.timeline
    assert out.n_preemptions >= 1 and out.n_resumes >= 1
    assert t0.preempt_ts[0] > t0.finish_t
    assert 0 < sum(1 for ts in t0.token_ts if ts <= t0.preempt_ts[0]) < 10
    assert out.sessions[1].ttft_s < 1.25
    assert t0.tokens_out == want and t0.gen_finish_t > t1.finish_t


@pytest.mark.parametrize("gen_slo", [False, True], ids=["straggler", "straggler_gen_slo"])
def test_gen_slo_makes_straggler_policy_preempt_generation(world, gen_slo):
    u = world["u"]
    out = _generate(world, [("constant", (3 * u,)), ("constant", (50 * u,))],
                    [_spec(10, gen_slo_s=1e-3), None], arrivals=[0.0, 0.55], rows=1,
                    gen_step_s=0.05, policy=dict(gen_slo=gen_slo))
    if not gen_slo:
        assert out.n_preemptions == 0
        return
    t0 = out.timeline[0]
    assert out.n_preemptions >= 1 and out.n_resumes >= 1 and t0.preempt_ts[0] > t0.finish_t
    assert t0.gen_slo_miss == 10
    assert t0.tokens_out == _oracle(world, out.sessions[0].caches, 10)
    assert out.sessions[1].ttft_s < 1.25


@pytest.mark.parametrize("slo,misses", [(1.5e-3, GEN), (1.0, 0)])
def test_gen_slo_misses_surface_on_timeline(world, slo, misses):
    out = _generate(world, [("constant", (3 * world["u"],))], [_spec(GEN, gen_slo_s=slo)])
    assert out.timeline[0].gen_slo_miss == misses and out.n_gen_slo_miss == misses
    assert out.timeline[0].n_tokens_out == GEN


# ---------------------------------------------------------------------------
# sampling, specs and tasks, victim selection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [123, 7])
def test_seeded_sampling_draws_the_reference_tokens(world, seed):
    """Seeded softmax sampling over the step's logits: the port draws the
    reference's token ids draw for draw (``assert_same_scheduled`` holds the
    tokens equal), repeats itself, and differs from greedy."""
    trace = [("constant", (3 * world["u"],))]
    sampled = _generate(world, trace, [_spec(GEN, sample_seed=seed)])
    assert sampled.timeline[0].tokens_out == _generate(
        world, trace, [_spec(GEN, sample_seed=seed)]).timeline[0].tokens_out
    greedy = _generate(world, trace, [_spec(GEN)])
    assert sampled.timeline[0].tokens_out != greedy.timeline[0].tokens_out


def test_generation_task_draws_like_reference(world):
    """``GenerationTask.next_token`` over the same logits: greedy and seeded
    picks equal the reference's, index-seeded per request."""
    rng = np.random.default_rng(11)
    logits = rng.normal(size=(20, 97)).astype(np.float32) * 3
    picks = []
    for side in world["sides"]:
        tasks = [side.gen.GenerationTask(side.gen.GenerationSpec(20, 0, sample_seed=s), index=i, label="g", row=0,
                                         start_t=0.0, context_tokens=0, capacity=64)
                 for i, s in enumerate([None, 5, 5])]
        picks.append([[t.next_token(lg) for lg in logits] for t in tasks])
    assert picks[0] == picks[1]
    assert picks[0][1] != picks[0][2]  # seed + index: two requests, two streams


def test_generation_spec_and_task_validate(world):
    for side in world["sides"]:
        gen = side.gen
        with pytest.raises(ValueError, match="n_tokens"):
            gen.GenerationSpec(-1, 0)
        with pytest.raises(ValueError, match="gen_slo_s"):
            gen.GenerationSpec(4, 0, gen_slo_s=0.0)
        with pytest.raises(ValueError, match="capacity"):
            gen.GenerationTask(gen.GenerationSpec(64, 0), index=0, label="req0:ctx", row=0, start_t=0.0,
                               context_tokens=100, capacity=128)
        t = gen.GenerationTask(gen.GenerationSpec(2, 7), index=0, label="req0:ctx", row=0, start_t=0.0,
                               context_tokens=100, capacity=128)
        t.record(5, 0.1)
        t.record(9, 0.2)
        assert t.done and t.realized_tokens == 102
        with pytest.raises(ValueError, match="already emitted"):
            t.suspend(0.3)


def test_generation_task_gen_slo_accounting(world):
    states = []
    for side in world["sides"]:
        g = side.gen.GenerationTask(side.gen.GenerationSpec(5, 7, gen_slo_s=0.1), index=0, label="g", row=0,
                                    start_t=1.0, context_tokens=10, capacity=64)
        seen = []
        for tok, ts in ((3, 1.05), (4, 1.30)):
            g.record(tok, ts)
            seen.append((g.slo_misses, g.slo_missed, g.tokens_since_resume))
        g.suspend(1.3)
        g.resume(1, 2.0)
        seen.append((g.tokens_since_resume, g.slo_misses, g.row, g.ready_t))
        g.record(5, 2.75)
        seen.append((g.slo_misses, g.tokens_since_resume, g.current_token, g.tokens_out, g.token_ts))
        states.append(seen)
    assert states[0] == states[1]
    assert states[0][:2] == [(0, False, 1), (1, True, 2)] and states[0][3][:2] == (2, 1)


def test_select_victim_policies(world):
    for side in world["sides"]:
        s = side.sched

        def mk(end_t, work, is_gen=False):
            return s._VictimCandidate(obj=object(), is_gen=is_gen, end_t=end_t, preempt_t=0.0, work=work)

        a, b, c = mk(5.0, 300), mk(9.0, 100), mk(9.0, 200, is_gen=True)
        assert s._select_victim(s.PreemptionPolicy(), [a, b, c]) is b
        least = s.PreemptionPolicy(victim="least_work")
        assert s._select_victim(least, [a, b, c]) is b
        assert s._select_victim(least, [a, c]) is c
        assert s._select_victim(least, []) is None
        with pytest.raises(ValueError, match="victim"):
            s.PreemptionPolicy(victim="coin_flip")
