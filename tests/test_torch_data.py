"""The port's synthetic data (``repro_torch.data``) against the reference's
(``repro.data``): the same seeds give the same tokens, contexts, batches
and lengths."""
import itertools

import numpy as np
import pytest

import repro.data as jdata
import repro_torch.data as data


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("stickiness", [0.0, 0.3])
def test_markov_lm_equals_reference(seed, stickiness):
    kw = dict(vocab_size=512, branching=6, stickiness=stickiness, seed=seed)
    lm, jlm = data.MarkovLM(**kw), jdata.MarkovLM(**kw)
    np.testing.assert_array_equal(lm.successors, jlm.successors)
    np.testing.assert_array_equal(lm.probs, jlm.probs)
    for start in (None, 5):
        got = lm.sample(np.random.default_rng(seed + 10), 300, start=start)
        want = jlm.sample(np.random.default_rng(seed + 10), 300, start=start)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    got = list(itertools.islice(lm.batches(np.random.default_rng(seed), 3, 16), 2))
    want = list(itertools.islice(jlm.batches(np.random.default_rng(seed), 3, 16), 2))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


def test_launcher_context_equals_reference():
    """The launcher's context: ``MarkovLM(vocab, seed=0).sample(default_rng(0), T)``."""
    for vocab, T in ((512, 128), (49152, 3072)):
        got = data.MarkovLM(vocab_size=vocab, seed=0).sample(np.random.default_rng(0), T)
        want = jdata.MarkovLM(vocab_size=vocab, seed=0).sample(np.random.default_rng(0), T)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 3])
def test_topic_retrieval_equals_reference(seed):
    task = data.TopicRetrievalTask(data.MarkovLM(vocab_size=256, seed=seed), n_topics=5)
    jtask = jdata.TopicRetrievalTask(jdata.MarkovLM(vocab_size=256, seed=seed), n_topics=5)
    np.testing.assert_array_equal(task.topic_ids, jtask.topic_ids)
    for n in (40, 97):
        ctx, topic = task.make_context(np.random.default_rng(seed), n)
        jctx, jtopic = jtask.make_context(np.random.default_rng(seed), n)
        np.testing.assert_array_equal(ctx, jctx)
        assert topic == jtopic == task.answer_of(ctx) and ctx.shape == (n,)
    got = next(task.training_batches(np.random.default_rng(seed), 2, 48))
    want = next(jtask.training_batches(np.random.default_rng(seed), 2, 48))
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("preset", sorted(jdata.synthetic.TABLE2_PRESETS))
def test_sample_lengths_equal_reference(preset):
    assert data.synthetic.TABLE2_PRESETS[preset] == jdata.synthetic.TABLE2_PRESETS[preset]
    for seed, scale in ((0, 1.0), (5, 0.01)):
        got = data.sample_lengths(np.random.default_rng(seed), preset, 50, scale=scale)
        want = jdata.sample_lengths(np.random.default_rng(seed), preset, 50, scale=scale)
        np.testing.assert_array_equal(got, want)
        assert got.min() >= 16
