"""Gradients of every registry architecture's loss against the reference's.

The port of ``tests/test_models.py::test_arch_grads_finite`` with values
held, not only finiteness: for each arch's ``.tiny()`` in f32, the port's
``torch.autograd.grad`` of ``loss_fn`` (``training.trainer.loss_and_grads``)
against ``jax.grad`` of the reference's on the same converted weights
(``PRNGKey(1)``, through ``params_from_numpy``) and the same batch, each
leaf within 1e-4 of its largest |value|: the forward agrees within 2e-5
(``tests/test_torch_model.py``), and a backward through four layers
compounds that by a few times.  A leaf whose gradient vanishes in exact
arithmetic holds rounding noise in both packages: seamless-m4t's
cross-attention key bias (a bias shared by every key shifts every score
of a query alike, which no softmax sees) comes out ~3e-9 of the tree's
largest |gradient|.  Where the reference's leaf lies below 1e-6 of the
tree's largest |value|, the port's must too.  In bf16 (the registry's ``.tiny()`` as it
is) every gradient is finite and not all zero, as the reference requires.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import build as jbuild

from repro_torch._tree import tree_leaves
from repro_torch.configs import registry
from repro_torch.models import build
from repro_torch.models.convert import params_from_numpy
from repro_torch.training.trainer import loss_and_grads

torch.set_num_threads(1)

ARCHS = registry.names()
B, T = 1, 16


def _batch(cfg, r):
    batch = {}
    if cfg.family == "encdec":
        batch["src_embeds"] = r.normal(size=(B, T, cfg.frontend_dim)).astype(np.float32)
    elif cfg.family == "vlm":
        batch["patch_embeds"] = r.normal(size=(B, cfg.n_prefix_tokens, cfg.frontend_dim)).astype(np.float32)
    batch["tokens"] = r.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    batch["labels"] = r.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    return batch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(arch, dtype):
    jcfg, cfg = (dataclasses.replace(get(arch).tiny(), dtype=dtype) for get in (jregistry.get, registry.get))
    jmodel, model = jbuild(jcfg), build(cfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(1))
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    batch = _batch(cfg, np.random.default_rng(0))
    loss, _, grads = loss_and_grads(model, params, {k: torch.as_tensor(v) for k, v in batch.items()})
    leaves = tree_leaves(grads)
    assert len(leaves) == len(tree_leaves(params))
    for g, p in zip(leaves, tree_leaves(params)):
        assert g.dtype == p.dtype and g.shape == p.shape
        assert bool(torch.isfinite(g).all()), f"{arch}: non-finite grad"
    assert sum(float(g.float().abs().sum()) for g in leaves) > 0, f"{arch}: all-zero grads"
    if dtype == "bfloat16":
        return
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jmodel.loss_fn(p, jb)[0]))(jparams)
    assert abs(float(loss) - float(jloss)) <= 2e-5 * abs(float(jloss))
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    tree_scale = max(float(np.abs(np.asarray(w)).max()) for _, w in flat)
    for (path, want), got in zip(flat, leaves):
        want = np.asarray(want, np.float32)
        scale = np.abs(want).max()
        if scale < 1e-6 * tree_scale:  # zero up to rounding in the reference
            assert float(got.abs().max()) < 1e-6 * tree_scale, (arch, jax.tree_util.keystr(path))
            continue
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-4 * scale, (arch, jax.tree_util.keystr(path), err / scale)
