"""Shared world of the ssm and hybrid parity files
(``tests/test_torch_mamba2.py``, ``tests/test_torch_hybrid.py``).

Both packages get the reference's weight draw (``init_params`` with
``PRNGKey(0)``, converted leaf for leaf by ``params_from_numpy``) and the
same tokens from a numpy seed.  A world holds both prefills (padded to a
capacity) and, for the bf16 yardstick, the reference's f32 prefill on the
same bf16 weights.

Tolerances, stated once here:

* f32: within 2e-5 of each compared tensor's largest |value| (per layer
  for the states, per row for the logits).  The two frameworks sum the SSD
  scan's exp-cumsum and its contractions in other orders, so an element
  near zero may move by more than 2e-5 of itself, never by more than 2e-5
  of its layer's scale.
* bf16, layer by layer: each layer (Mamba-2 block, shared block) fed the
  reference's own bf16 input is within 2e-2 of its largest |value|, the
  vlm family's rule (``tests/test_torch_vlm.py``).
* bf16, end to end: the frameworks round bf16 intermediates at other
  places (XLA computes ``x * silu(z)`` and keeps elementwise chains in f32,
  torch rounds each op; one block's output already differs by one bf16 step
  in about 60% of its elements), and a stack of random-weight Mamba-2
  layers amplifies those steps: by the fourth layer the reference's own
  bf16 state lies 2-7% of its scale from the reference's f32 state on the
  same weights.  So end to end the port's bf16 result is held to that
  yardstick: its largest distance from the reference's f32 result (relative
  to each tensor's scale, over all layers) is at most twice the reference
  bf16 result's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.models import mamba2 as jm
from repro.models.common import apply_norm as japply_norm
from repro.serving import kv_layout as jkv
from repro.serving.engine import Engine as JEngine

from repro_torch.configs import registry
from repro_torch.models import lm, mamba2
from repro_torch.models.common import apply_norm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import kv_layout
from repro_torch.serving.engine import Engine

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
YARDSTICK = 2.0  # bf16 end to end: at most this many times the reference's own distance from f32
STATE_FIELDS = ("mamba_conv", "mamba_ssm", "shared_k", "shared_v")


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(np.asarray(x), np.float32)


def close_to_scale(got, want, tol, per_leading=False):
    """|got - want| <= tol * max|want|, over the whole tensor or per leading
    index (a layer, a logits row)."""
    got, want = np32(got), np32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    pairs = zip(got, want) if per_leading else [(got, want)]
    for i, (g, w) in enumerate(pairs):
        err, scale = np.abs(g - w).max(initial=0.0), np.abs(w).max(initial=0.0)
        assert err <= tol * scale, f"[{i}]: {err} off, {tol} of {scale} allowed"


def _worst(got, f32):
    """Largest |got - f32| relative to each leading index's scale."""
    got, f32 = np32(got), np32(f32)
    return max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)) for g, w in zip(got, f32))


def cfg_pair(arch, dtype, d_head=None):
    """The reference's and the port's ``.tiny()`` config in ``dtype``, with
    the attention's head dim replaced where ``d_head`` is given."""
    extra = {} if d_head is None else {"d_head": d_head}
    return (dataclasses.replace(jregistry.get(arch).tiny(), dtype=dtype, **extra),
            dataclasses.replace(registry.get(arch).tiny(), dtype=dtype, **extra))


def make_world(arch, dtype, *, B, T, cap, seed, d_head=None):
    jcfg, cfg = cfg_pair(arch, dtype, d_head)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    r = np.random.default_rng(seed)
    tokens = r.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    jlogits, jc = jlm.prefill(jcfg, jparams, {"tokens": jnp.asarray(tokens)}, pad_to=cap)
    logits, c = lm.prefill(cfg, params, {"tokens": torch.as_tensor(tokens)}, pad_to=cap)
    w = dict(arch=arch, jcfg=jcfg, cfg=cfg, jparams=jparams, params=params, dtype=lm.DTYPES[dtype],
             B=B, T=T, cap=cap, r=r, tokens=tokens, jlogits=jlogits, jc=jc, logits=logits, c=c)
    if dtype == "bfloat16":  # the reference's f32 function of the same bf16 weights
        w["jcfg32"] = dataclasses.replace(jcfg, dtype="float32")
        w["jparams32"] = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jparams)
        w["jlogits32"], w["jc32"] = jlm.prefill(w["jcfg32"], w["jparams32"], {"tokens": jnp.asarray(tokens)},
                                                pad_to=cap)
    return w


def torch_caches(jc, dtype):
    """The reference's caches as the port's, states in the model's dtype
    (the SSM state f32)."""
    def conv(a, dt):
        return None if a is None else torch.tensor(np32(a)).to(dt)

    return lm.Caches(None, None, torch.tensor(np.asarray(jc.length)), mamba_conv=conv(jc.mamba_conv, dtype),
                     mamba_ssm=conv(jc.mamba_ssm, torch.float32), shared_k=conv(jc.shared_k, dtype),
                     shared_v=conv(jc.shared_v, dtype))


def compare(world, got_logits, got_caches, jlogits, jc, jlogits32=None, jc32=None):
    """Logits (per row) and every state field, under the world's rule."""
    pairs = [("logits", got_logits[:, 0], jlogits[:, 0], None if jlogits32 is None else jlogits32[:, 0])]
    for name in STATE_FIELDS:
        got = getattr(got_caches, name)
        assert (got is None) == (getattr(jc, name) is None), name
        if got is not None:
            pairs.append((name, got, getattr(jc, name), None if jc32 is None else getattr(jc32, name)))
    if world["cfg"].dtype == "float32":
        for name, got, want, _ in pairs:
            close_to_scale(got, want, TOL["float32"], per_leading=True)
        return
    worst_port = max(_worst(got, f32) for _, got, _, f32 in pairs)
    worst_ref = max(_worst(want, f32) for _, _, want, f32 in pairs)
    for name, got, _, _ in pairs:
        assert np.isfinite(np32(got)).all(), name
    assert worst_port <= YARDSTICK * worst_ref, (worst_port, worst_ref)


# ---------------------------------------------------------------------------
# the checks both families run
# ---------------------------------------------------------------------------


def check_prefill(world):
    cfg, c, B, cap = world["cfg"], world["c"], world["B"], world["cap"]
    C = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    assert c.kv_k is None and c.kv_v is None
    assert c.mamba_conv.shape == (cfg.n_layers, B, cfg.ssm_conv - 1, C) and c.mamba_conv.dtype == world["dtype"]
    assert c.mamba_ssm.shape == (cfg.n_layers, B, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
    assert c.mamba_ssm.dtype == torch.float32
    assert c.length.tolist() == np.asarray(world["jc"].length).tolist() == [world["T"]] * B
    if cfg.family == "hybrid":
        n_apps = cfg.n_layers // cfg.shared_block_every
        assert c.shared_k.shape == (n_apps, B, cap, cfg.n_kv_heads, cfg.d_head)
        assert c.shared_k.dtype == world["dtype"]
        assert not c.shared_k[:, :, world["T"]:].float().any()
    else:
        assert c.shared_k is None and c.shared_v is None
    compare(world, world["logits"], c, world["jlogits"], world["jc"], world.get("jlogits32"), world.get("jc32"))


def check_decode_steps(world, n_steps=3):
    """Steps from the reference's own prefill caches; the port updates the
    given caches in place."""
    caches = torch_caches(world["jc"], world["dtype"])
    jc, jc32 = world["jc"], world.get("jc32")
    for _ in range(n_steps):
        tok = world["r"].integers(0, world["cfg"].vocab_size, size=(world["B"], 1)).astype(np.int32)
        jl, jc = jlm.decode_step(world["jcfg"], world["jparams"], jnp.asarray(tok), jc)
        jl32 = None
        if jc32 is not None:
            jl32, jc32 = jlm.decode_step(world["jcfg32"], world["jparams32"], jnp.asarray(tok), jc32)
        ssm_before = caches.mamba_ssm
        got, caches = lm.decode_step(world["cfg"], world["params"], torch.as_tensor(tok), caches)
        assert caches.mamba_ssm is ssm_before
        compare(world, got, caches, jl, jc, jl32, jc32)
        assert caches.length.tolist() == np.asarray(jc.length).tolist()


def check_layer_by_layer(world):
    """Each layer of the prefill fed the reference's own input (its
    residual stream there): the Mamba-2 blocks' outputs and states and the
    shared blocks' outputs and K/V within the dtype's rule of each layer's
    largest |value|."""
    jcfg, cfg, jp, p = world["jcfg"], world["cfg"], world["jparams"], world["params"]
    tol = TOL[cfg.dtype]
    tokens = world["tokens"]
    x = jlm._embed_tokens(jcfg, jp, jnp.asarray(tokens))
    T = tokens.shape[1]
    positions = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None], tokens.shape)
    apps = {l1 - 1: app for _, l1, app in lm._segments(cfg) if app is not None} if cfg.family == "hybrid" else {}
    for l in range(cfg.n_layers):
        jpl = jax.tree_util.tree_map(lambda a: a[l], jp["layers"])
        tpl = lm._layer(p, l)
        xt = torch.tensor(np32(x)).to(world["dtype"])
        jout, jst = jm.mamba2_prefill(jcfg, jpl["mamba"], japply_norm(jcfg.norm, jpl["ln1"], x))
        out, st = mamba2.mamba2_prefill(cfg, tpl["mamba"], apply_norm(cfg.norm, tpl["ln1"], xt))
        for g, w in ((out, jout), (st.conv, jst.conv), (st.ssm, jst.ssm)):
            close_to_scale(g, w, tol)
        x = x + jout
        if l in apps:
            xt = torch.tensor(np32(x)).to(world["dtype"])
            jx, (jk, jv) = jlm._shared_block_prefill(jcfg, jp["shared_block"], x, positions)
            tx, (k, v) = lm._shared_block_prefill(cfg, p["shared_block"], xt, torch.tensor(np.asarray(positions)))
            for g, w in ((tx, jx), (k, jk), (v, jv)):
                close_to_scale(g, w, tol)
            x = jx


def check_engine(world, n_tokens=16):
    """Greedy tokens from ``calculate_kv``'s caches equal the reference
    engine's (f32; in bf16 a near tie may flip, so they are held to the
    port's own teacher-forced logits), the caller's caches are left as they
    were, and ``logits_with_kv`` matches the reference's."""
    cfg, jcfg, cap, B = world["cfg"], world["jcfg"], world["cap"], world["B"]
    engine = Engine(cfg, world["params"], cache_capacity=cap, device="cpu")
    jengine = JEngine(jcfg, world["jparams"], cache_capacity=cap)
    logits, caches = engine.calculate_kv({"tokens": torch.as_tensor(world["tokens"])})
    jlogits, jcaches = jengine.calculate_kv({"tokens": jnp.asarray(world["tokens"])})
    first = torch.argmax(logits[:, -1], dim=-1)
    held = caches.clone()
    got = engine.generate_with_kv(caches, first, n_tokens)
    assert got.shape == (B, n_tokens) and ((got >= 0) & (got < cfg.padded_vocab_size)).all()
    for a, b in zip(caches, held):
        assert (a is None and b is None) or torch.equal(a, b)
    steered = np.concatenate([first.numpy()[:, None], got[:, :-1]], axis=1)
    lw, _ = engine.logits_with_kv(caches, steered)
    assert (lw.argmax(-1) == got).all()
    if cfg.dtype == "float32":
        assert (first.numpy() == np.argmax(np.asarray(jlogits[:, -1]), -1)).all()
        want = jengine.generate_with_kv(jcaches, jnp.asarray(first.numpy()), n_tokens)
        np.testing.assert_array_equal(got, want)
        jlw, _ = jengine.logits_with_kv(jcaches, steered)
        close_to_scale(lw, jlw, TOL["float32"])
    return got


def check_refusals(world):
    """The reference builds no extend or row program for these families and
    raises its messages; so does the port, before touching any cache."""
    cfg, cap, B = world["cfg"], world["cap"], world["B"]
    engine = Engine(cfg, world["params"], cache_capacity=cap, device="cpu")
    jengine = JEngine(world["jcfg"], world["jparams"], cache_capacity=cap)
    caches = torch_caches(world["jc"], world["dtype"])
    held = caches.clone()
    tok = np.zeros((B, 4), np.int32)
    calls = {
        "prefill_extend": lambda e, c: e.prefill_extend(tok, c),
        "prefill_extend_rows": lambda e, c: e.prefill_extend_rows(tok, c, [4] + [0] * (B - 1)),
        "prefill_extend_gather": lambda e, c: e.prefill_extend_gather(tok[:1], c, [0]),
        "decode_step_rows": lambda e, c: e.decode_step_rows(tok[:, :1], c, [True] + [False] * (B - 1)),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError) as mine:
            call(engine, caches)
        with pytest.raises(ValueError) as theirs:
            call(jengine, world["jc"])
        assert str(mine.value) == str(theirs.value), name
    with pytest.raises(ValueError) as mine:
        lm.prefill_extend(cfg, world["params"], torch.as_tensor(tok), caches)
    with pytest.raises(ValueError) as theirs:
        jlm.prefill_extend(world["jcfg"], world["jparams"], jnp.asarray(tok), world["jc"])
    assert str(mine.value) == str(theirs.value)
    for a, b in zip(caches, held):
        assert (a is None and b is None) or torch.equal(a, b)


def check_extract_row(world, row=1):
    c = world["c"]
    got = kv_layout.extract_row(c, row)
    want = jkv.extract_row(world["jc"], row)
    for name in lm.Caches._fields:
        g, w, full = getattr(got, name), getattr(want, name), getattr(c, name)
        assert (g is None) == (w is None) == (full is None), name
        if g is None:
            continue
        assert tuple(g.shape) == tuple(w.shape), name
        assert torch.equal(g, full[row:row + 1] if name == "length" else full[:, row:row + 1]), name
        if name != "length":
            assert g.data_ptr() == full[:, row].data_ptr(), name  # a view, as the module states


def check_params(world, leaves):
    """``params_from_numpy`` brings every leaf of the plan over exactly and
    in the plan's shape, the constant-initialized ones included; a tree
    without one of them is refused."""
    cfg, jparams, params = world["cfg"], world["jparams"], world["params"]
    plan, jplan = lm.param_plan(cfg), jlm.param_plan(world["jcfg"])
    flat = jax.tree_util.tree_flatten_with_path(jplan, is_leaf=lambda x: hasattr(x, "logical"))[0]
    for path, leaf in flat:
        keys = [k.key for k in path]
        node, mine, want = params, plan, jparams
        for k in keys:
            node, mine, want = node[k], mine[k], want[k]
        assert tuple(node.shape) == mine.shape == leaf.shape, keys
        np.testing.assert_array_equal(np32(node), np32(want), err_msg="/".join(keys))
    for path in leaves:
        tree = jax.tree_util.tree_map(np.asarray, jparams)
        node = tree
        for k in path[:-1]:
            node = node[k]
        del node[path[-1]]
        with pytest.raises(ValueError, match="does not match the plan"):
            params_from_numpy(cfg, tree, "cpu")
