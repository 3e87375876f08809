"""The traffic generator: every input from the seed, the same work on every seed."""
import numpy as np
import pytest

from _tiny import MANIFEST
from pbench.traffic import Draw, Traffic

TRAFFIC = sorted({w["traffic"] for w in MANIFEST.data["workloads"]})


def _load(name):
    return Traffic.load(MANIFEST.traffic_path(name))


@pytest.mark.parametrize("name", TRAFFIC)
def test_pool_lengths_cover_the_range_in_steps(name):
    t = _load(name)
    lens = t.pool_lengths
    assert len(lens) == t.pool and lens[0] == t.ctx_min and lens[-1] == t.ctx_max
    assert all((n - t.ctx_min) % t.ctx_step == 0 for n in lens) and lens == sorted(lens)
    assert t.capacity() >= t.ctx_max + t.question_tokens + t.answer_tokens


@pytest.mark.parametrize("name", TRAFFIC)
def test_same_seed_same_inputs(name):
    t = _load(name)
    a, b = Draw(t, 1000, 2**31 + 12345), Draw(t, 1000, 2**31 + 12345)
    assert all(np.array_equal(x, y) for x, y in zip(a.pool_tokens, b.pool_tokens))
    for i in (0, 7):
        for ra, rb in zip(a.wave(i), b.wave(i)):
            assert (ra.ctx, ra.level) == (rb.ctx, rb.level) and np.array_equal(ra.question, rb.question)


@pytest.mark.parametrize("name", TRAFFIC)
def test_every_seed_same_work_in_another_order(name):
    t = _load(name)
    a, b = Draw(t, 1000, 1), Draw(t, 1000, 2)
    assert [len(x) for x in a.pool_tokens] == [len(x) for x in b.pool_tokens]
    assert not all(np.array_equal(x, y) for x, y in zip(a.pool_tokens, b.pool_tokens))
    for i in range(3):
        wa, wb = a.wave(i), b.wave(i)
        assert len(wa) == t.clients
        # each wave: every pool context clients/pool times, the levels' counts as the mix says
        for w in (wa, wb):
            assert sorted(r.ctx for r in w) == sorted(list(range(t.pool)) * (t.clients // t.pool))
            assert sorted(r.level for r in w) == t.level_list
            assert all(len(r.question) == t.question_tokens for r in w)


def test_tokens_in_vocabulary_and_waves_differ():
    t = _load(TRAFFIC[0])
    d = Draw(t, 777, 5)
    assert all(((x >= 0) & (x < 777)).all() for x in d.pool_tokens)
    w0, w1 = d.wave(0), d.wave(1)
    assert [(r.ctx, r.level) for r in w0] != [(r.ctx, r.level) for r in w1]


def test_bad_mix_refused():
    with pytest.raises(ValueError):
        Traffic.from_dict({"name": "x", "clients": 3, "pool": 2, "context_tokens": {"min": 64, "max": 128, "step": 64},
                           "chunk_tokens": 32, "levels": {"0": 3}, "question_tokens": 4, "answer_tokens": 2,
                           "calibration_tokens": 32})
