"""The port's ``CheckpointManager`` against the reference's: the protocol
(identity, retention, partial writes, shape checks), the on-disk format in
both directions (the same file names, an equal ``metadata.json``, leaves
bit for bit), and a trainer's resume.

Resume: the port's ``Trainer`` stopped after step 6 and restarted from its
checkpoint ends at step 10 bit-equal to an uninterrupted run on the CPU; a
reference checkpoint at step 6 continued by the port to step 10 lies within
the f32 rule of the reference's own continuation: losses within 1e-5
relative, and every state under ``tests/_torch_train_rule.py``'s rule.
"""
import contextlib
import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_train_rule import hold_trajectory, port_leaves, ref_leaves

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import registry as jregistry
from repro.models import build as jbuild
from repro.training import AdamWConfig as JAdamWConfig
from repro.training import Trainer as JTrainer
from repro.training import trainer as jtrainer

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data import MarkovLM
from repro_torch.models import build
from repro_torch.training import AdamWConfig, Trainer, TrainState
from repro_torch.training.grad_compress import ef_init
from repro_torch.training.optimizer import OptState, init_opt_state
from repro_torch.training.trainer import init_train_state, loss_and_grads

torch.set_num_threads(1)


def _tree(rng):
    return {
        "a": torch.tensor(rng.normal(size=(8, 4)), dtype=torch.float32),
        "nested": {
            "b": torch.tensor(rng.normal(size=(3,)), dtype=torch.float32).to(torch.bfloat16),
            "c": torch.tensor(rng.integers(0, 100, size=(5,)), dtype=torch.int32),
        },
    }


def _same(got, want):
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py's protocol, on the port
# ---------------------------------------------------------------------------


def test_save_restore_identity(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=2)
    t = _tree(np.random.default_rng(0))
    ck.save(7, t)
    assert ck.latest_step() == 7
    _same(ck.restore(7, t), t)


def test_retention_keeps_newest(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=2)
    t = _tree(np.random.default_rng(0))
    for s in (1, 2, 3, 4):
        ck.save(s, t)
    assert ck.all_steps() == [3, 4]


def test_partial_write_is_invisible(tmp_path):
    """A .tmp- directory (simulated crash mid-write) is never restored."""
    ck = CheckpointManager(str(tmp_path), keep=3)
    ck.save(1, _tree(np.random.default_rng(0)))
    os.makedirs(os.path.join(str(tmp_path), "step_0000000002.tmp-dead"), exist_ok=True)
    assert ck.latest_step() == 1
    assert ck.all_steps() == [1]


def test_shape_mismatch_rejected(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    t = _tree(np.random.default_rng(0))
    ck.save(1, t)
    with pytest.raises(ValueError, match="shape mismatch for a"):
        ck.restore(1, dict(t, a=torch.zeros((2, 2))))


def test_restore_casts_to_the_target(tmp_path):
    """Each leaf takes the target leaf's dtype (the stored values cast)."""
    ck = CheckpointManager(str(tmp_path))
    t = _tree(np.random.default_rng(0))
    ck.save(1, t)
    like = {"a": torch.zeros((8, 4), dtype=torch.bfloat16),
            "nested": {"b": torch.zeros(3), "c": torch.zeros(5, dtype=torch.int64)}}
    r = ck.restore(1, like)
    assert torch.equal(r["a"], t["a"].to(torch.bfloat16))
    assert torch.equal(r["nested"]["b"], t["nested"]["b"].float())
    assert r["nested"]["c"].dtype == torch.int64 and torch.equal(r["nested"]["c"], t["nested"]["c"].long())


# ---------------------------------------------------------------------------
# the on-disk format, both directions
# ---------------------------------------------------------------------------


def _states(grad_compression):
    """The same TrainState in both packages: smollm-360m ``.tiny()``'s bf16
    parameters (the reference's draw), f32 moments and errors of numpy
    noise, an int32 step."""
    jcfg = jregistry.get("smollm-360m").tiny()
    jstate = jtrainer.init_train_state(jbuild(jcfg), jax.random.PRNGKey(0), grad_compression=grad_compression)
    rng = np.random.default_rng(1)
    noise = lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32)  # noqa: E731
    jopt = jstate.opt._replace(mu=jax.tree_util.tree_map(noise, jstate.opt.mu),
                               nu=jax.tree_util.tree_map(noise, jstate.opt.nu), step=jnp.asarray(6, jnp.int32))
    jef = None if jstate.ef_error is None else jax.tree_util.tree_map(noise, jstate.ef_error)
    jstate = jstate._replace(opt=jopt, ef_error=jef, step=jnp.asarray(6, jnp.int32))

    def port(tree):
        return jax.tree_util.tree_map(
            lambda a: torch.from_numpy(np.asarray(a).view(np.uint16).copy()).view(torch.bfloat16)
            if a.dtype == jnp.bfloat16 else torch.from_numpy(np.asarray(a).copy()), tree)

    state = TrainState(params=port(jstate.params),
                       opt=OptState(mu=port(jstate.opt.mu), nu=port(jstate.opt.nu), step=port(jstate.opt.step)),
                       ef_error=None if jef is None else port(jef), step=port(jstate.step))
    return jstate, state


def _same_bits(port_state, ref_state):
    got, want = tree_leaves(port_state), jax.tree_util.tree_leaves(ref_state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name and tuple(g.shape) == w.shape
        raw = g.view(torch.int16) if g.dtype == torch.bfloat16 else g  # numpy has no bf16
        assert raw.numpy().tobytes() == w.tobytes()


@pytest.mark.parametrize("grad_compression", [False, True])
def test_reference_checkpoint_restores_in_the_port(tmp_path, grad_compression):
    jstate, state = _states(grad_compression)
    _same_bits(state, jstate)  # the two states are one
    JCheckpointManager(str(tmp_path)).save(6, jstate)
    got = CheckpointManager(str(tmp_path)).restore(6, tree_map(torch.zeros_like, state))
    _same_bits(got, jstate)
    assert (got.ef_error is None) == (not grad_compression)


@pytest.mark.parametrize("grad_compression", [False, True])
def test_port_checkpoint_restores_in_the_reference(tmp_path, grad_compression):
    jstate, state = _states(grad_compression)
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    CheckpointManager(str(port_dir)).save(6, state)
    JCheckpointManager(str(ref_dir)).save(6, jstate)
    step_dir = "step_0000000006"
    assert sorted(os.listdir(port_dir / step_dir)) == sorted(os.listdir(ref_dir / step_dir))
    meta = json.loads((port_dir / step_dir / "metadata.json").read_text())
    assert meta == json.loads((ref_dir / step_dir / "metadata.json").read_text())
    assert list(meta["leaves"]) == list(json.loads((ref_dir / step_dir / "metadata.json").read_text())["leaves"])
    keys = list(meta["leaves"])
    assert keys[0] == ".params/embed" and keys[-1] == ".step" and ".opt/.mu/layers/attn/wq" in keys
    assert any(k.startswith(".ef_error/") for k in keys) == grad_compression
    for name in os.listdir(port_dir / step_dir):  # the same bytes, file by file
        assert (port_dir / step_dir / name).read_bytes() == (ref_dir / step_dir / name).read_bytes(), name
    assert (port_dir / "LATEST").read_text() == (ref_dir / "LATEST").read_text() == step_dir
    got = JCheckpointManager(str(port_dir)).restore(6, jstate)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jstate)):
        assert g.dtype == w.dtype and g.shape == w.shape and np.asarray(g).tobytes() == np.asarray(w).tobytes()


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------


def _batch_fn(vocab):
    lm = MarkovLM(vocab_size=vocab, seed=2, stickiness=0.6)

    def batch_fn(step):
        rng = np.random.default_rng(500 + step)
        toks = np.stack([lm.sample(rng, 33) for _ in range(4)])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    return batch_fn


def _trainer(cfg, ck, log, **kw):
    return Trainer(model=build(cfg), opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=3), batch_fn=_batch_fn(cfg.vocab_size),
                   ckpt=ck, ckpt_every=3, log_every=1, log_fn=log.append, device="cpu", **kw)


@pytest.mark.parametrize("grad_compression", [False, True])
def test_killed_and_restarted_trainer_equals_an_uninterrupted_run(tmp_path, grad_compression):
    cfg = registry.get("smollm-360m").tiny()
    log = []
    tr = _trainer(cfg, CheckpointManager(str(tmp_path / "whole"), keep=2), log, grad_compression=grad_compression)
    whole, hist = tr.run(tr.init_or_restore(0), 10)
    first = _trainer(cfg, CheckpointManager(str(tmp_path / "cut"), keep=2), log, grad_compression=grad_compression)
    _, h1 = first.run(first.init_or_restore(0), 6)
    assert first.ckpt.all_steps() == [3, 6]
    log.clear()
    again = _trainer(cfg, CheckpointManager(str(tmp_path / "cut"), keep=2), log, grad_compression=grad_compression)
    state = again.init_or_restore(0)
    assert log == ["[trainer] resumed from step 6"] and int(state.step) == 6
    state, h2 = again.run(state, 10)
    assert h1["loss"] + h2["loss"] == hist["loss"] and h1["step"] + h2["step"] == hist["step"] == list(range(1, 11))
    _same(state, whole)
    assert again.ckpt.all_steps() == [9, 10] and tr.ckpt.all_steps() == [9, 10]


def test_port_continues_a_reference_checkpoint(tmp_path):
    """Both continuations save every step, so each state of the two is held
    by ``tests/_torch_train_rule.py``'s rule, with each side's gradients
    recomputed at its own saved states."""
    jcfg = dataclasses.replace(jregistry.get("smollm-360m").tiny(), dtype="float32")
    cfg = dataclasses.replace(registry.get("smollm-360m").tiny(), dtype="float32")
    kw = dict(lr=1e-3, warmup_steps=3)
    batch_fn = _batch_fn(cfg.vocab_size)
    jmodel, model = jbuild(jcfg), build(cfg)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jtr = JTrainer(model=jmodel, opt_cfg=JAdamWConfig(**kw), batch_fn=batch_fn,
                       ckpt=JCheckpointManager(str(tmp_path / "run"), keep=5), ckpt_every=6, log_every=1)
        jstate, _ = jtr.run(jtr.init_or_restore(0), 6)
        jtr.ckpt, jtr.ckpt_every = JCheckpointManager(str(tmp_path / "ref"), keep=5), 1  # the reference's own
        jstate, jhist = jtr.run(jstate, 10)
    log = []
    tr = Trainer(model=model, opt_cfg=AdamWConfig(**kw), batch_fn=batch_fn,
                 ckpt=CheckpointManager(str(tmp_path / "run"), keep=5), ckpt_every=1, log_every=1, log_fn=log.append,
                 device="cpu")
    state = tr.init_or_restore(0)
    assert log == ["[trainer] resumed from step 6"]
    state, hist = tr.run(state, 10)
    assert hist["step"] == jhist["step"] == [7, 8, 9, 10]
    for got, want in zip(hist["loss"], jhist["loss"]):
        assert abs(got - want) <= 1e-5 * abs(want)
    jgrad = jax.jit(jax.grad(lambda p, b: jmodel.loss_fn(p, b)[0]))
    port, ref, port_g, ref_g, gnorms, lrs = [], [], [], [], [], []
    for s in range(6, 11):
        ps = tr.ckpt.restore(s, state)
        js = JCheckpointManager(str(tmp_path / ("run" if s == 6 else "ref"))).restore(s, jstate)
        port.append(port_leaves(ps))
        ref.append(ref_leaves(js))
        if s < 10:
            batch = batch_fn(s)
            port_g.append([t.double().numpy() for t in tree_leaves(
                loss_and_grads(model, ps.params, {k: torch.as_tensor(v) for k, v in batch.items()})[2])])
            ref_g.append([np.asarray(t, np.float64) for t in jax.tree_util.tree_leaves(
                jgrad(js.params, {k: jnp.asarray(v) for k, v in batch.items()}))])
            gnorms.append(float(np.sqrt(sum(np.sum(g * g) for g in ref_g[-1]))))
            lrs.append(min(1.0, (s + 1) / 3) * 1e-3)
    assert port[0]["p"] and all(np.array_equal(a, b) for a, b in zip(port[0]["p"], ref[0]["p"]))
    got = hold_trajectory(port, ref, port_g, ref_g, gnorms, lrs, AdamWConfig(**kw))
    print(got)


def test_init_train_state_layout():
    """Zero moments in f32 beside the parameters, ``ef_error`` only with
    compression, an int32 step: the reference's ``TrainState``."""
    cfg = registry.get("smollm-360m").tiny()
    state = init_train_state(build(cfg), torch.Generator().manual_seed(0), "cpu", grad_compression=True)
    assert state._fields == jtrainer.TrainState._fields
    assert state.step.dtype == torch.int32 and int(state.step) == 0
    for p, mu, nu, e in zip(*(tree_leaves(t) for t in (state.params, state.opt.mu, state.opt.nu, state.ef_error))):
        assert p.dtype == torch.bfloat16 and mu.dtype == nu.dtype == e.dtype == torch.float32
        assert not mu.any() and not nu.any() and not e.any() and mu.shape == p.shape
    assert init_train_state(build(cfg), torch.Generator().manual_seed(0), "cpu").ef_error is None
    assert ef_init(state.params).keys() == init_opt_state(state.params).mu.keys()
