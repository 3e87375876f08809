"""The port's family facade (``repro_torch.models.build``) against the
reference's (``repro.models.build``) on every registry architecture.

For each arch's ``.tiny()``, as ``tests/test_models.py`` drives the
reference: ``loss_fn``, ``prefill(pad_to=40)`` and one ``decode_step`` on
two rows of 24 tokens (the vlm family with its image rows, the encdec
family with 24 source frames), through both packages' ``build`` on the
reference's weight draw (``PRNGKey(0)``, converted by ``params_from_numpy``)
and the same inputs from a numpy seed.

Tolerances: in f32 every output (loss, ce, aux, logits, every cache field)
element by element within 2e-5 (absolute and relative).  In bf16, the
registry's ``.tiny()`` as it is: the port's prefill and step with the
shapes and finiteness the reference's test holds, and the loss, a mean
over 48 positions computed in f32, within 1e-3 of the reference's (the MoE
aux within 2e-2).  bf16 logits and
caches are held per family by their own files (``test_torch_vlm.py``,
``test_torch_moe.py``, ``test_torch_mamba2.py``, ``test_torch_hybrid.py``,
``test_torch_encdec.py``): a routed token whose expert flips between the
frameworks moves a row's logits by more than any per-element bf16 rule.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import build as jbuild

from repro_torch.configs import registry
from repro_torch.models import Model, build, encdec, lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Engine

torch.set_num_threads(1)

ARCHS = registry.names()
B, T, CAP = 2, 24, 40


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _batch(cfg, r):
    batch = {}
    if cfg.family == "encdec":
        batch["src_embeds"] = r.normal(size=(B, T, cfg.frontend_dim)).astype(np.float32)
    elif cfg.family == "vlm":
        batch["patch_embeds"] = r.normal(size=(B, cfg.n_prefix_tokens, cfg.frontend_dim)).astype(np.float32)
    batch["tokens"] = r.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    batch["labels"] = r.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    return batch


def _cache_fields(caches):
    return {f: t for f, t in caches._asdict().items() if t is not None}


def test_registry_names_agree():
    assert registry.names() == jregistry.names()


def registry_pair(arch, dtype):
    return tuple(dataclasses.replace(get(arch).tiny(), dtype=dtype) for get in (jregistry.get, registry.get))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_build_matches_reference(arch, dtype):
    jcfg, cfg = registry_pair(arch, dtype)
    jmodel, model = jbuild(jcfg), build(cfg)
    assert isinstance(model, Model) and model.cfg is cfg
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    batch = _batch(cfg, np.random.default_rng(0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    V = cfg.padded_vocab_size

    jloss, jm = jmodel.loss_fn(jparams, jb)
    loss, m = model.loss_fn(params, tb)
    assert loss.shape == () and loss.dtype == torch.float32 and np.isfinite(float(loss))
    assert set(m) == set(jm) == {"ce", "aux"}
    rule = dict(rtol=2e-5, atol=2e-5) if dtype == "float32" else dict(rtol=1e-3)
    np.testing.assert_allclose(float(loss), float(jloss), **rule)
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]), **rule)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), **(rule if dtype == "float32" else dict(rtol=2e-2)))

    logits, c = model.prefill(params, tb, pad_to=CAP)
    assert logits.shape == (B, 1, V) and torch.isfinite(logits.float()).all()
    fields = _cache_fields(c)
    if dtype == "bfloat16":  # the step as the reference's test runs it; bf16 values are held per family
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        l2, c2 = model.decode_step(params, tok, c)
        assert l2.shape == (B, 1, V) and torch.isfinite(l2.float()).all()
        assert c2.length.tolist() == [int(c.length[0]) + 1] * B
        return

    def held(got, want, what):
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5, err_msg=what)

    # prefill: its caches are compared before the step writes into them
    jlogits, jc = jmodel.prefill(jparams, jb, pad_to=CAP)
    held(logits, jlogits, "prefill logits")
    jfields = _cache_fields(jc)
    assert set(fields) == set(jfields)
    for f, t in fields.items():
        assert tuple(t.shape) == tuple(jfields[f].shape), f
        held(t, jfields[f], f)
    tok = np.asarray(jnp.argmax(jlogits[:, -1], -1)).astype(np.int32)[:, None]
    jl2, jc2 = jmodel.decode_step(jparams, jnp.asarray(tok), jc)
    l2, c2 = model.decode_step(params, torch.as_tensor(tok), c)
    assert l2.shape == (B, 1, V) and torch.isfinite(l2.float()).all()
    assert c2.length.tolist() == np.asarray(jc2.length).tolist() == [int(c.length[0]) + 1] * B
    held(l2, jl2, "step logits")
    for f, t in _cache_fields(c2).items():
        held(t, getattr(jc2, f), f"{f} after the step")


def test_moe_loss_carries_the_load_balancing_loss():
    """The MoE family's loss is ce + 0.01 * aux, aux summed over its layers
    (one layer's aux is at least 1 for any routing); the dense family's aux
    is 0."""
    for arch, moe in (("qwen2-moe-a2.7b", True), ("smollm-360m", False)):
        cfg = dataclasses.replace(registry.get(arch).tiny(), dtype="float32")
        params = lm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
        batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, np.random.default_rng(1)).items()}
        loss, m = build(cfg).loss_fn(params, batch)
        torch.testing.assert_close(loss, m["ce"] + 0.01 * m["aux"])
        assert (float(m["aux"]) >= cfg.n_layers * (1 - 1e-5)) if moe else float(m["aux"]) == 0.0


def test_params_from_numpy_round_trips_the_encdec_plan():
    """The reference's encdec weight tree comes over leaf for leaf through the
    family's plan (``build(cfg).param_plan()``): every leaf equal in f32, the
    plan's shapes the reference's, and a tree missing a leaf refused."""
    jcfg, cfg = registry_pair("seamless-m4t-large-v2", "float32")
    jparams = jbuild(jcfg).init_params(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = params_from_numpy(cfg, tree, "cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(tree)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in leaves] == [p for p, _ in jleaves] and len(leaves) > 30
    for (path, got), (_, want) in zip(leaves, jleaves):
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want), path
    plan = jax.tree_util.tree_leaves(build(cfg).param_plan(), is_leaf=lambda x: hasattr(x, "shape"))
    jplan = jax.tree_util.tree_leaves(jbuild(jcfg).param_plan(), is_leaf=lambda x: hasattr(x, "shape"))
    assert [tuple(a.shape) for a in plan] == [tuple(a.shape) for a in jplan]
    del tree["dec_layers"]["cross_attn"]["bq"]
    with pytest.raises(ValueError, match="does not match the plan"):
        params_from_numpy(cfg, tree, "cpu")
    with pytest.raises(ValueError, match="does not match the plan"):  # not the lm family's plan
        params_from_numpy(registry.get("smollm-360m").tiny(), jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def test_engine_and_lm_refuse_encdec():
    """The serving engine runs the lm families only, as the reference's: an
    encdec config raises before any layer runs, and ``lm`` refuses it."""
    cfg = dataclasses.replace(registry.get("seamless-m4t-large-v2").tiny(), dtype="float32")
    params = encdec.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, np.random.default_rng(0)).items()}
    engine = Engine(cfg, params, cache_capacity=CAP, device="cpu")
    with pytest.raises(ValueError, match="not encdec"):
        engine.calculate_kv(batch)
    for fn in (lambda: lm.param_plan(cfg), lambda: lm.prefill(cfg, params, batch), lambda: lm.loss_fn(cfg, params, batch)):
        with pytest.raises(ValueError, match="not encdec"):
            fn()
    with pytest.raises(ValueError, match="encdec family only"):
        encdec.param_plan(registry.get("smollm-360m").tiny())
