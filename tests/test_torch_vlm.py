"""The vlm family (paligemma-3b) of the port's model against the reference's.

Both packages get the reference's weight draw (``PRNGKey(0)``, converted
leaf for leaf by ``params_from_numpy``, ``frontend_proj`` included) and
the same inputs from a numpy seed: two rows of text tokens and, for the
stubbed vision tower, f32 patch embeddings.  ``paligemma-3b.tiny()`` (4
layers, d 128, 4 query heads and 1 KV head of 32, 8 image rows) and a
variant with the published head dim of 256 run in f32 and in bf16: the
prefill's logits and caches, image rows included, one ``decode_step`` and
``prefill_extend`` with and without per-row widths, each from the
reference's own caches.

Tolerances: f32 element by element within 2e-5 (absolute and relative).
bf16 within 2e-2 of the largest |value| of each compared layer (logits: of
the row's logits): the two frameworks round bf16 intermediates at other
places (XLA may keep an elementwise chain in f32, torch rounds each op's
output), so from the first layer's FFN on the residual stream differs by
bf16 steps of its own magnitude, and that difference reaches every later
K/V element at the stream's scale, not the element's (layer 0's K/V are
bit-equal).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.serving.engine import Engine as JEngine

from repro_torch.configs import registry
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Engine

torch.set_num_threads(1)

B, T, TC, CAP = 2, 24, 6, 48
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# (head dim, dtype): the tiny config's 32 and the published 256
VARIANTS = [(32, "float32"), (32, "bfloat16"), (256, "float32"), (256, "bfloat16")]


def _cfg(get, d_head, dtype):
    cfg = get("paligemma-3b").tiny()
    return dataclasses.replace(cfg, d_head=d_head, dtype=dtype)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32))


def _close(got, want, tol):
    """f32 (tol 2e-5): element by element; bf16 (tol 2e-2): per leading
    index (a cache's layer, a logits row), of its largest |value|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if tol < 1e-3:
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
        return
    for i, (g, w) in enumerate(zip(got, want)):
        err, scale = np.abs(g - w).max(), np.abs(w).max()
        assert err <= tol * scale, f"[{i}]: {err} off, {tol} of {scale} allowed"


def _torch_caches(jc, dtype):
    return lm.Caches(torch.tensor(_np(jc.kv_k)).to(dtype), torch.tensor(_np(jc.kv_v)).to(dtype),
                     torch.tensor(np.asarray(jc.length)))


@pytest.fixture(scope="module", params=VARIANTS, ids=[f"d{d}-{dt}" for d, dt in VARIANTS])
def world(request):
    d_head, dtype = request.param
    jcfg, cfg = _cfg(jregistry.get, d_head, dtype), _cfg(registry.get, d_head, dtype)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    r = np.random.default_rng(d_head)
    tokens = r.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    patches = r.normal(size=(B, cfg.n_prefix_tokens, cfg.frontend_dim)).astype(np.float32)
    jlogits, jc = jlm.prefill(jcfg, jparams, {"tokens": jnp.asarray(tokens), "patch_embeds": jnp.asarray(patches)},
                              pad_to=CAP)
    logits, c = lm.prefill(cfg, params, {"tokens": torch.as_tensor(tokens), "patch_embeds": torch.as_tensor(patches)},
                           pad_to=CAP)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params, tol=TOL[dtype], dtype=lm.DTYPES[dtype],
                r=r, tokens=tokens, patches=patches, jlogits=jlogits, jc=jc, logits=logits, c=c)


def test_prefill_matches_reference(world):
    """Logits of the last text token and every cache row, the 8 image rows
    first, within the dtype's tolerance; the caches' length counts both."""
    n = world["cfg"].n_prefix_tokens + T
    assert world["c"].kv_k.shape == (world["cfg"].n_layers, B, CAP, 1, world["cfg"].d_head)
    assert world["c"].kv_k.dtype == world["dtype"] and world["c"].length.tolist() == [n] * B
    assert np.asarray(world["jc"].length).tolist() == [n] * B
    _close(world["logits"], world["jlogits"], world["tol"])
    _close(world["c"].kv_k, world["jc"].kv_k, world["tol"])
    _close(world["c"].kv_v, world["jc"].kv_v, world["tol"])
    assert not world["c"].kv_k[:, :, n:].float().any()


def test_decode_step_matches_reference(world):
    tok = world["r"].integers(0, world["cfg"].vocab_size, size=(B, 1)).astype(np.int32)
    jl, jc = jlm.decode_step(world["jcfg"], world["jparams"], jnp.asarray(tok), world["jc"])
    caches = _torch_caches(world["jc"], world["dtype"])
    got, c = lm.decode_step(world["cfg"], world["params"], torch.as_tensor(tok), caches)
    _close(got, jl, world["tol"])
    _close(c.kv_k, jc.kv_k, world["tol"])
    _close(c.kv_v, jc.kv_v, world["tol"])
    assert c.length.tolist() == np.asarray(jc.length).tolist()


@pytest.mark.parametrize("widths", [None, [TC, 2]], ids=["full", "widths"])
def test_prefill_extend_matches_reference(world, widths):
    """A TEXT chunk on top of the image rows and the context, full width and
    width-masked per row (row 1 commits 2 of its 6 tokens)."""
    tok = world["r"].integers(0, world["cfg"].vocab_size, size=(B, TC)).astype(np.int32)
    w = None if widths is None else np.asarray(widths, np.int32)
    jl, jc = jlm.prefill_extend(world["jcfg"], world["jparams"], jnp.asarray(tok), world["jc"],
                                widths=None if w is None else jnp.asarray(w))
    caches = _torch_caches(world["jc"], world["dtype"])
    got, c = lm.prefill_extend(world["cfg"], world["params"], torch.as_tensor(tok), caches,
                               widths=None if w is None else torch.as_tensor(w))
    if widths is None:
        _close(got, jl, world["tol"])
    else:
        _close(got[0], jl[0], world["tol"])  # a width-masked row's logits are garbage in both
    _close(c.kv_k, jc.kv_k, world["tol"])
    _close(c.kv_v, jc.kv_v, world["tol"])
    assert c.length.tolist() == np.asarray(jc.length).tolist()


def test_frontend_proj_is_carried(world):
    """``param_plan`` has the vlm's ``frontend_proj`` (frontend_dim, d), and
    ``params_from_numpy`` brings the reference's over exactly and refuses a
    tree without it."""
    cfg = world["cfg"]
    assert lm.param_plan(cfg)["frontend_proj"].shape == (cfg.frontend_dim, cfg.d_model)
    want = np.asarray(world["jparams"]["frontend_proj"], np.float32)
    got = world["params"]["frontend_proj"]
    assert got.dtype == world["dtype"] and np.array_equal(_np(got), want)
    tree = jax.tree_util.tree_map(np.asarray, world["jparams"])
    del tree["frontend_proj"]
    with pytest.raises(ValueError, match="does not match the plan"):
        params_from_numpy(cfg, tree, "cpu")
    assert "frontend_proj" not in lm.param_plan(registry.get("smollm-360m").tiny())


def test_image_rows_attend_bidirectionally():
    """The prefix-LM mask reaches the model: a change to the last image row
    moves the first image row's K from the second layer on (its layer-0 K
    is its own projection), and leaves no row of layer 0 but the last
    image row's; the text rows see the change from layer 1 on."""
    cfg = _cfg(registry.get, 32, "float32")
    gen = torch.Generator().manual_seed(0)
    params = lm.init_params(cfg, gen, "cpu")
    r = np.random.default_rng(1)
    tokens = torch.as_tensor(r.integers(0, cfg.vocab_size, size=(1, T)))
    patches = torch.as_tensor(r.normal(size=(1, cfg.n_prefix_tokens, cfg.frontend_dim)).astype(np.float32))
    moved = patches.clone()
    moved[:, -1] += 1.0
    a = lm.prefill(cfg, params, {"tokens": tokens, "patch_embeds": patches})[1]
    b = lm.prefill(cfg, params, {"tokens": tokens, "patch_embeds": moved})[1]
    last = cfg.n_prefix_tokens - 1
    assert torch.equal(a.kv_k[0, :, :last], b.kv_k[0, :, :last])
    assert torch.equal(a.kv_k[0, :, last + 1:], b.kv_k[0, :, last + 1:])
    assert not torch.equal(a.kv_k[1, :, 0], b.kv_k[1, :, 0])
    assert not torch.equal(a.kv_k[1, :, last + 1:], b.kv_k[1, :, last + 1:])


def test_engine_generates_like_reference():
    """``Engine.calculate_kv`` takes ``patch_embeds`` and ``generate_with_kv``
    continues after the image rows and the text: the same greedy tokens as
    the reference's engine (f32, head dim 32)."""
    jcfg, cfg = _cfg(jregistry.get, 32, "float32"), _cfg(registry.get, 32, "float32")
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    r = np.random.default_rng(2)
    tokens = r.integers(0, cfg.vocab_size, size=(1, T)).astype(np.int32)
    patches = r.normal(size=(1, cfg.n_prefix_tokens, cfg.frontend_dim)).astype(np.float32)
    jeng, eng = JEngine(jcfg, jparams, cache_capacity=CAP), Engine(cfg, params, cache_capacity=CAP, device="cpu")
    jl, jc = jeng.calculate_kv({"tokens": jnp.asarray(tokens), "patch_embeds": jnp.asarray(patches)})
    pl, c = eng.calculate_kv({"tokens": torch.as_tensor(tokens), "patch_embeds": torch.as_tensor(patches)})
    _close(pl, jl, 1e-4)
    first = np.asarray(jnp.argmax(jl[:, -1], -1))
    assert int(torch.argmax(pl[:, -1], -1)[0]) == int(first[0])
    want = jeng.generate_with_kv(jc, jnp.asarray(first, jnp.int32), 6)
    assert np.array_equal(eng.generate_with_kv(c, torch.tensor(first), 6), np.asarray(want))
