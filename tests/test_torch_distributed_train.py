"""The port's sharded train step and sharded restore against the reference.

One 4-rank gloo group on ``make_test_mesh(2, 2, device="cpu")``
(``tests/_torch_dist_world.py``) runs both scenarios:

* one olmo-1b ``.tiny()`` f32 train step under ``{"embed": None}``
  (``trainer.distribute_state`` by ``param_specs``, the batch split over
  ``"data"``, the loss, its backward and AdamW on DTensors) against the
  reference's single-device ``make_train_step``: the loss, ``grad_norm``
  and ``lr`` within 1e-5 relative, the gradients within 2e-5 of each
  leaf's largest |value|, and the state under ``tests/_torch_train_rule``'s
  rule (every element as far from the reference's as the gradients'
  differences allow);
* the reference's ``CheckpointManager`` checkpoint of the state after that
  step, restored by the port with ``shardings=`` (a ``NamedSharding`` a
  leaf under ``{"embed": None, "vocab": ("data", "model")}``, so the
  embedding's vocab splits four ways over a tuple entry): every
  ``full_tensor()`` bit-equal to the saved leaf, and each rank's local
  block equal to the numpy slice its mesh coordinates select.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_train_rule import hold_trajectory, ref_leaves

import _torch_dist_world as world
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import registry as jregistry
from repro.models import build as jbuild
from repro.training import AdamWConfig as JAdamWConfig
from repro.training import trainer as jtrainer

from repro_torch.training import AdamWConfig

OPT = dict(warmup_steps=1, lr=1e-3)
B, T = 4, 32
REL = 1e-5


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_train")
    jcfg = dataclasses.replace(jregistry.get(world.DECODE_ARCH).tiny(), dtype="float32")
    jmodel = jbuild(jcfg)
    s0 = jtrainer.init_train_state(jmodel, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    s1, m1 = jax.jit(jtrainer.make_train_step(jmodel, JAdamWConfig(**OPT)))(s0, jbatch)
    JCheckpointManager(str(tmp / "ckpt")).save(1, s1)
    inputs = {"train": {"params": _f32(s0.params), "batch": batch, "opt": OPT},
              "restore": {"dir": str(tmp / "ckpt"), "step": 1}}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # the reference's gradients while the ranks run
        ranks = pool.submit(world.spawn, world.train_scenarios, tmp, inputs)
        grads = jax.jit(jax.grad(lambda p: jmodel.loss_fn(p, jbatch)[0]))(s0.params)
        results, per_rank = ranks.result()
    ref = {"s0": s0, "s1": s1, "metrics": {k: float(v) for k, v in m1.items()},
           "grads": [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]}
    return results, per_rank, ref


def test_sharded_train_step_loss_matches_reference(spawned):
    results, _, ref = spawned
    for k in ("loss", "grad_norm", "lr"):
        assert abs(results["metrics"][k] - ref["metrics"][k]) <= REL * abs(ref["metrics"][k]), k
    assert results["step"] == 1


def test_sharded_gradients_match_reference(spawned):
    results, _, ref = spawned
    assert len(results["grads"]) == len(ref["grads"])
    for got, want in zip(results["grads"], ref["grads"]):
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got.numpy() - want).max() <= 2e-5 * scale


def test_sharded_train_step_state_matches_reference(spawned):
    results, _, ref = spawned
    port1 = {k: [x.double().numpy() for x in v] for k, v in results["state"].items()}
    port1["e"] = None
    got = hold_trajectory([ref_leaves(ref["s0"]), port1], [ref_leaves(ref["s0"]), ref_leaves(ref["s1"])],
                          [[g.double().numpy() for g in results["grads"]]],
                          [[np.asarray(g, np.float64) for g in ref["grads"]]],
                          [ref["metrics"]["grad_norm"]], [ref["metrics"]["lr"]], AdamWConfig(**OPT))
    assert got["flipped"] == 0.0


def test_parameters_are_placed_by_their_specs(spawned):
    results, _, _ = spawned
    pl = results["param_placements"]
    assert pl["layers/attn/wq"] == ("Replicate", "Shard(2)")  # ("layers", "embed", "heads"), embed unsplit
    assert pl["layers/attn/wo"] == ("Replicate", "Shard(1)")  # ("layers", "heads", "embed")
    assert pl["layers/mlp/w_down"] == ("Replicate", "Shard(1)")  # ("layers", "mlp", "embed")
    assert pl["embed"] == ("Replicate", "Shard(0)")  # ("vocab", "embed")


def test_sharded_restore_full_tensors_bit_equal(spawned):
    results, _, ref = spawned
    saved = {"/".join(k): np.asarray(v) for k, v in _keyed(ref["s1"])}
    assert set(results["restored"]) == set(saved)
    for key, got in results["restored"].items():
        np.testing.assert_array_equal(got.numpy(), saved[key], err_msg=key)


def _keyed(jstate):
    from repro.checkpoint.manager import _path_str

    flat, _ = jax.tree_util.tree_flatten_with_path(jstate)
    return [(tuple(_path_str(p) for p in path), leaf) for path, leaf in flat]


def _block(arr, spec, coord, sizes):
    """The numpy slice of ``arr`` that mesh coordinate ``coord`` holds under ``spec``."""
    index = []
    for dim, part in enumerate(spec):
        if part is None:
            index.append(slice(None))
            continue
        axes = (part,) if isinstance(part, str) else part
        i, n = 0, 1
        for a in axes:
            i, n = i * sizes[a] + coord[a], n * sizes[a]
        step = arr.shape[dim] // n
        index.append(slice(i * step, (i + 1) * step))
    return arr[tuple(index)]


def test_sharded_restore_local_blocks_are_the_spec_slices(spawned):
    _, per_rank, ref = spawned
    saved = {"/".join(k): np.asarray(v) for k, v in _keyed(ref["s1"])}
    sizes = {"data": 2, "model": 2}
    seen_tuple = False
    for mine in per_rank:
        coord = dict(zip(("data", "model"), mine["coord"]))
        for key, local in mine["local"].items():
            spec = mine["spec"][key]
            seen_tuple |= any(isinstance(p, tuple) for p in spec)
            np.testing.assert_array_equal(local.numpy(), _block(saved[key], spec, coord, sizes), err_msg=key)
    assert seen_tuple
    assert per_rank[0]["spec"][".params/embed"] == (("data", "model"), None)
