"""The port's optimizer, error-feedback compression, train step, remat and
training launcher against the reference's ``repro.training``.

Tolerances, with their reasons:

* ``apply_updates`` on the same numpy trees: f32 parameters and moments
  within 1e-6 relative of each leaf's largest |value| (the elementwise
  arithmetic is the reference's op for op; the global norm's sums and
  ``pow`` may round differently in the last place); bf16 parameters within
  one bf16 step (an f32 update one ulp apart can round to the neighbouring
  bf16 value); ``grad_norm`` and ``lr`` within 1e-6 relative.
* ``ef_compress``: bit for bit (the same f32 add, max, true divisions, round
  half to even, clip and multiply).
* Five train steps of smollm-360m ``.tiny()`` in f32 from the reference's
  ``init_train_state`` weights: losses, ``grad_norm`` and ``lr`` within
  1e-5 relative each step; parameters, moments and carried errors under
  ``tests/_torch_train_rule.py``'s rule (every element within the bound the
  step's arithmetic gives from the measured gradient differences, at most
  1% of the elements sent one int8 bin apart under compression, and
  outside those at most a thousandth of the elements farther than 1e-5 of
  the leaf's largest |value|).
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st  # hypothesis, or fixed-seed fallback
from _torch_train_rule import hold_trajectory, port_leaves, ref_leaves
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import registry as jregistry
from repro.launch import train as jtrain_launch
from repro.models import build as jbuild
from repro.training import optimizer as jopt
from repro.training import trainer as jtrainer
from repro.training.grad_compress import ef_compress as j_ef_compress
from repro.training.grad_compress import ef_init as j_ef_init

from repro_torch._tree import tree_leaves, tree_unflatten
from repro_torch.configs import registry
from repro_torch.launch import train as train_launch
from repro_torch.models import build
from repro_torch.models.convert import params_from_numpy
from repro_torch.training import AdamWConfig, Trainer, TrainState, apply_updates, init_opt_state, make_train_step
from repro_torch.training import optimizer as opt
from repro_torch.training.grad_compress import ef_compress, ef_init
from repro_torch.training.optimizer import global_norm
from repro_torch.training.trainer import loss_and_grads

torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _shapes():
    return {"a": (4, 3), "nested": {"c": (2, 5, 3), "b": (7,)}, "z": (1,)}


def _tree(rng, shapes, scale=1.0):
    return {k: _tree(rng, v, scale) if isinstance(v, dict) else (rng.normal(size=v) * scale).astype(np.float32)
            for k, v in shapes.items()}


def _t(tree, dtype):
    return {k: _t(v, dtype) if isinstance(v, dict) else torch.tensor(v).to(dtype) for k, v in tree.items()}


def _j(tree, dtype):
    return {k: _j(v, dtype) if isinstance(v, dict) else jnp.asarray(v, dtype) for k, v in tree.items()}


def _close(got, want, rel, what):
    got, want = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, what
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= rel * scale, (what, np.abs(g - w).max() / scale)


# ---------------------------------------------------------------------------
# apply_updates, global_norm, clipping and warmup against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [
    dict(lr=0.1, warmup_steps=1, grad_clip=1e9),  # no clipping
    dict(lr=3e-3, warmup_steps=3, grad_clip=1.0),  # warmup, clipped
    dict(lr=1e-3, warmup_steps=100, grad_clip=0.5, weight_decay=0.0, b2=0.99),
])
def test_apply_updates_matches_reference(dtype, kw):
    """Four steps on bf16 or f32 parameters (f32 moments), each with new
    gradients, against the reference's ``apply_updates`` on the same trees."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    p0 = _tree(rng, _shapes())
    p, jp = _t(p0, tdt), _j(p0, jdt)
    cfg, jcfg = AdamWConfig(**kw), jopt.AdamWConfig(**kw)
    state, jstate = init_opt_state(p), jopt.init_opt_state(jp)
    for _ in range(4):
        g0 = _tree(rng, _shapes(), scale=0.7)
        p, state, m = apply_updates(p, _t(g0, tdt), state, cfg)
        jp, jstate, jm = jopt.apply_updates(jp, _j(g0, jdt), jstate, jcfg)
        for k in ("grad_norm", "lr"):
            assert m[k].dtype == torch.float32
            assert abs(float(m[k]) - float(jm[k])) <= 1e-6 * abs(float(jm[k])), k
        assert int(state.step) == int(jstate.step) and state.step.dtype == torch.int32
        _close(state.mu, jstate.mu, 1e-6, "mu")
        _close(state.nu, jstate.nu, 1e-6, "nu")
        for got, want in zip(tree_leaves(p), jax.tree_util.tree_leaves(jp)):
            assert got.dtype == tdt
            g, w = _np(got), _np(want)
            if dtype == "float32":
                assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max()
            else:  # one bf16 step at the larger magnitude
                step = 2.0 ** (np.floor(np.log2(np.maximum(np.maximum(np.abs(g), np.abs(w)), 1e-30))) - 7)
                assert (np.abs(g - w) <= step).all()


def test_global_norm_matches_reference():
    """Many leaves of mixed dtypes, summed in the reference's flatten order."""
    rng = np.random.default_rng(2)
    shapes = {f"k{i:02d}": (int(rng.integers(1, 40)), 3) for i in range(25)}
    t0 = _tree(rng, shapes, scale=3.0)
    for tdt, jdt in DTYPES.values():
        got, want = float(global_norm(_t(t0, tdt))), float(jopt.global_norm(_j(t0, jdt)))
        assert abs(got - want) <= 1e-6 * want


def test_schedule_and_bias_corrections_are_f32():
    """Warmup and the bias corrections in f32 tensors, as the reference's."""
    cfg = AdamWConfig(lr=3e-4, warmup_steps=7)
    jcfg = jopt.AdamWConfig(lr=3e-4, warmup_steps=7)
    for s in range(10):
        got = opt._schedule(cfg, torch.tensor(s, dtype=torch.int32))
        want = jopt._schedule(jcfg, jnp.asarray(s, jnp.int32))
        assert got.dtype == torch.float32 and np.float32(got.item()) == np.asarray(want)


# ---------------------------------------------------------------------------
# tests/test_training.py's properties, on the port
# ---------------------------------------------------------------------------


def test_adamw_matches_numpy_reference():
    rng = np.random.default_rng(0)
    p = {"w": torch.tensor(rng.normal(size=(4, 3)), dtype=torch.float32)}
    g = {"w": torch.tensor(rng.normal(size=(4, 3)), dtype=torch.float32)}
    cfg = AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.01, grad_clip=1e9, warmup_steps=1)
    new_p, st2, _ = apply_updates(p, g, init_opt_state(p), cfg)
    gw, pw = g["w"].numpy(), p["w"].numpy()
    mhat = 0.1 * gw / (1 - 0.9)
    nhat = 0.01 * gw * gw / (1 - 0.99)
    ref = pw - 0.1 * (mhat / (np.sqrt(nhat) + 1e-8) + 0.01 * pw)
    np.testing.assert_allclose(new_p["w"].numpy(), ref, rtol=1e-5, atol=1e-6)
    assert int(st2.step) == 1


def test_adamw_clipping():
    p = {"w": torch.ones(10)}
    g = {"w": torch.full((10,), 100.0)}
    cfg = AdamWConfig(lr=1.0, grad_clip=1.0, warmup_steps=1, weight_decay=0.0)
    _, _, metrics = apply_updates(p, g, init_opt_state(p), cfg)
    assert float(metrics["grad_norm"]) > 100  # reported pre-clip


def test_adamw_reduces_quadratic_loss():
    target = torch.tensor([3.0, -2.0, 0.5])
    p = {"x": torch.zeros(3)}
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=1)
    state = init_opt_state(p)
    for _ in range(300):
        g = {"x": 2 * (p["x"] - target)}
        p, state, _ = apply_updates(p, g, state, cfg)
    assert float(torch.sum((p["x"] - target) ** 2)) < 1e-2


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), bits=st.sampled_from([4, 8]))
def test_ef_compress_error_bounded_and_carried(seed, bits):
    rng = np.random.default_rng(seed)
    g = {"w": torch.tensor(rng.normal(size=(32,)), dtype=torch.float32)}
    ghat, e2 = ef_compress(g, ef_init(g), bits=bits)
    # g + 0 = ghat + e2 exactly (error feedback identity)
    np.testing.assert_allclose(g["w"].numpy(), ghat["w"].numpy() + e2["w"].numpy(), rtol=1e-5, atol=1e-6)
    scale = np.abs(g["w"].numpy()).max() / (2 ** (bits - 1) - 1)
    assert np.abs(e2["w"].numpy()).max() <= scale * 0.5 + 1e-6


def test_ef_compress_accumulates_small_signals():
    """Signals below one quantization bin still flow via error feedback."""
    g = {"w": torch.tensor([1.0, 0.001])}  # 0.001 << bin (~0.143)
    e = ef_init(g)
    acc = np.zeros(2)
    for _ in range(400):
        ghat, e = ef_compress(g, e, bits=4)
        acc += ghat["w"].numpy()
    np.testing.assert_allclose(acc / 400, g["w"].numpy(), atol=(1.0 / 7) / 400 * 2 + 1e-5)


def test_global_norm():
    assert abs(float(global_norm({"a": torch.tensor([3.0]), "b": torch.tensor([4.0])})) - 5.0) < 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [4, 8])
def test_ef_compress_matches_reference(dtype, bits):
    """Three steps with the error carried, half-bin ties included: the
    compressed gradients and the carried errors bit for bit."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(3 + bits)
    shapes = _shapes()
    g0 = _tree(rng, shapes)
    e, je = ef_init(_t(g0, tdt)), j_ef_init(_j(g0, jdt))
    for i in range(3):
        g0 = _tree(rng, shapes)
        if i == 0:  # exact half bins (scale 0.25): round half to even in both
            qmax = 2 ** (bits - 1) - 1
            g0["a"] = (np.arange(12, dtype=np.float32).reshape(4, 3) - 5.5) * 0.25
            g0["a"][0, 0] = qmax * 0.25
        ghat, e = ef_compress(_t(g0, tdt), e, bits=bits)
        jghat, je = j_ef_compress(_j(g0, jdt), je, bits=bits)
        for got, want in zip(tree_leaves(ghat) + tree_leaves(e),
                             jax.tree_util.tree_leaves(jghat) + jax.tree_util.tree_leaves(je)):
            assert got.dtype in (tdt, torch.float32)
            assert np.array_equal(_np(got), _np(want))


# ---------------------------------------------------------------------------
# make_train_step: five steps against the reference's
# ---------------------------------------------------------------------------


def _markov_batch(cfg, step, B=4, T=32):
    from repro_torch.data import MarkovLM

    lm = MarkovLM(vocab_size=cfg.vocab_size, seed=2, stickiness=0.6)
    rng = np.random.default_rng(500 + step)
    toks = np.stack([lm.sample(rng, T + 1) for _ in range(B)])
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("grad_compression", [False, True])
def test_train_steps_match_reference(grad_compression):
    """Five steps from the reference's weights, each state held to the
    reference's by ``tests/_torch_train_rule.py``'s rule."""
    jcfg = dataclasses.replace(jregistry.get("smollm-360m").tiny(), dtype="float32")
    cfg = dataclasses.replace(registry.get("smollm-360m").tiny(), dtype="float32")
    jmodel, model = jbuild(jcfg), build(cfg)
    kw = dict(lr=1e-3, warmup_steps=2)
    jstate = jtrainer.init_train_state(jmodel, jax.random.PRNGKey(0), grad_compression=grad_compression)
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jstate.params), "cpu")
    state = TrainState(params=params, opt=init_opt_state(params),
                       ef_error=ef_init(params) if grad_compression else None,
                       step=torch.zeros((), dtype=torch.int32))
    jstep = jax.jit(jtrainer.make_train_step(jmodel, jopt.AdamWConfig(**kw), grad_compression=grad_compression))
    step = make_train_step(model, AdamWConfig(**kw), grad_compression=grad_compression)
    jgrad = jax.jit(jax.grad(lambda p, b: jmodel.loss_fn(p, b)[0]))
    port, ref, gnorms, lrs = [port_leaves(state)], [ref_leaves(jstate)], [], []
    port_g, ref_g = [], []
    for s in range(5):
        batch = _markov_batch(cfg, s)
        jb, tb = {k: jnp.asarray(v) for k, v in batch.items()}, {k: torch.as_tensor(v) for k, v in batch.items()}
        port_g.append([t.double().numpy() for t in tree_leaves(loss_and_grads(model, state.params, tb)[2])])
        ref_g.append([np.asarray(t, np.float64) for t in jax.tree_util.tree_leaves(jgrad(jstate.params, jb))])
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, tb)
        for k in ("loss", "grad_norm", "lr", "ce"):
            assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), (s, k, float(m[k]), float(jm[k]))
        port.append(port_leaves(state))
        ref.append(ref_leaves(jstate))
        gnorms.append(float(jm["grad_norm"]))
        lrs.append(float(jm["lr"]))
    assert int(state.step) == int(jstate.step) == 5
    assert (state.ef_error is None) == (jstate.ef_error is None) == (not grad_compression)
    got = hold_trajectory(port, ref, port_g, ref_g, gnorms, lrs, AdamWConfig(**kw))
    print(f"compression {grad_compression}: {got}")
    if not grad_compression:
        assert got["flipped"] == 0


# ---------------------------------------------------------------------------
# remat: the policies change what is kept, not the gradients
# ---------------------------------------------------------------------------


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _grads_counting(model, params, batch):
    """(loss, grads, the aten ops the backward ran)."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    loss, _ = model.loss_fn(p, batch)
    counter = _OpCounter()
    with counter:
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return loss, grads, counter.counts


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2-moe-a2.7b", "paligemma-3b", "mamba2-370m", "zamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_remat_policies_give_the_same_grads(arch):
    """``remat`` with policy "full" and "dots" against ``remat=False`` on the
    CPU: the loss and every gradient bit for bit.  The backward recomputes
    the layer bodies under remat (softmax or the SSD's exp run again), and
    under "dots" it recomputes no 2-D weight product (``aten.mm``)."""
    base = dataclasses.replace(registry.get(arch).tiny(), dtype="float32")
    gen = torch.Generator().manual_seed(3)
    params = build(base).init_params(gen, "cpu")
    r = np.random.default_rng(4)
    B, T = 2, 20
    batch = {"tokens": torch.as_tensor(r.integers(0, base.vocab_size, (B, T))),
             "labels": torch.as_tensor(r.integers(0, base.vocab_size, (B, T)))}
    if base.family == "encdec":
        batch["src_embeds"] = torch.as_tensor(r.normal(size=(B, T, base.frontend_dim)).astype(np.float32))
    if base.family == "vlm":
        batch["patch_embeds"] = torch.as_tensor(
            r.normal(size=(B, base.n_prefix_tokens, base.frontend_dim)).astype(np.float32))
    runs = {}
    for name, kw in (("off", dict(remat=False)), ("full", dict(remat=True, remat_policy="full")),
                     ("dots", dict(remat=True, remat_policy="dots"))):
        cfg = dataclasses.replace(base, **kw)
        runs[name] = _grads_counting(build(cfg), params, batch)
    loss0, grads0, ops0 = runs["off"]
    for name in ("full", "dots"):
        loss, grads, ops = runs[name]
        assert torch.equal(loss, loss0), name
        for g, g0 in zip(grads, grads0):
            assert torch.equal(g, g0), name
    aten = torch.ops.aten
    recomputed = aten.exp.default if base.family in ("ssm", "hybrid") else aten._softmax.default
    assert ops0.get(recomputed, 0) < runs["dots"][2].get(recomputed, 0)
    assert ops0.get(recomputed, 0) < runs["full"][2].get(recomputed, 0)
    assert runs["dots"][2].get(aten.mm.default, 0) == ops0.get(aten.mm.default, 0)
    assert runs["full"][2].get(aten.mm.default, 0) > ops0.get(aten.mm.default, 0)


def test_remat_stays_out_of_serving():
    """Without grad the layer bodies run once: the registry's remat=True
    config prefills exactly as remat=False."""
    base = dataclasses.replace(registry.get("smollm-360m").tiny(), dtype="float32")
    params = build(base).init_params(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, base.vocab_size, (1, 16)))
    outs = []
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        counter = _OpCounter()
        with counter:
            logits, caches = build(cfg).prefill(params, {"tokens": tokens})
        outs.append((logits, caches.kv_k, counter.counts))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert outs[0][2] == outs[1][2]


def test_loss_and_grads_zero_for_unused_weights():
    """A weight the loss does not reach gets a zero gradient, as ``jax.grad``
    gives it."""
    cfg = registry.get("smollm-360m").tiny()
    params = build(cfg).init_params(torch.Generator().manual_seed(0), "cpu")
    params = dict(params, unused={"w": torch.ones(3, dtype=torch.bfloat16)})

    class M:
        loss_fn = staticmethod(lambda p, b: build(cfg).loss_fn({k: v for k, v in p.items() if k != "unused"}, b))

    batch = _markov_batch(cfg, 0, B=1, T=8)
    loss, metrics, grads = loss_and_grads(M, params, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert torch.equal(grads["unused"]["w"], torch.zeros(3, dtype=torch.bfloat16))
    assert grads["embed"].dtype == torch.bfloat16 and not loss.requires_grad
    assert set(metrics) == {"ce", "aux"}


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_trains_checkpoints_and_resumes(tmp_path):
    argv = ["--arch", "smollm-360m", "--steps", "6", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hist = train_launch.run(argv)
    lines = out.getvalue().splitlines()
    assert hist["step"] == [1] and len(hist["loss"]) == 1 and np.isfinite(hist["loss"][0])
    assert lines[-1] == f"[launch.train] smollm-360m-tiny: loss {hist['loss'][0]:.4f} -> {hist['loss'][-1]:.4f}"
    # ckpt_every = max(6 // 4, 1) = 1, keep = 2
    assert sorted(p.name for p in tmp_path.iterdir()) == ["LATEST", "step_0000000005", "step_0000000006"]
    assert (tmp_path / "LATEST").read_text() == "step_0000000006"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        again = train_launch.run(argv)
    assert again == {"loss": [], "step": []}
    assert out.getvalue().splitlines() == ["[trainer] resumed from step 6",
                                           "[launch.train] smollm-360m-tiny: no step to run, at step 6 of 6"]
    # --steps past the checkpoint continues from it
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        more = train_launch.run(argv[:3] + ["8"] + argv[4:])
    assert more["step"] == [7] and out.getvalue().startswith("[trainer] resumed from step 6")


def test_launcher_tiny_cannot_be_turned_off_in_either_package():
    """``--tiny`` is ``store_true`` with ``default=True`` in the reference, so
    both launchers always train ``.tiny()`` (carried by parity)."""
    args = train_launch.build_parser().parse_args(["--arch", "smollm-360m"])
    assert args.tiny is True
    src = open(jtrain_launch.__file__).read()
    assert 'ap.add_argument("--tiny", action="store_true", default=True)' in src


def test_reference_launcher_fails_where_the_port_prints_no_step(tmp_path, monkeypatch, capsys):
    """A run resumed at ``--steps``: the reference's launcher fails on its
    empty history; the port's prints a line and returns (see its docstring)."""
    argv = ["train", "--arch", "smollm-360m", "--steps", "1", "--ckpt-dir", str(tmp_path)]
    monkeypatch.setattr("sys.argv", argv)
    jtrain_launch.main()
    with pytest.raises(IndexError):
        jtrain_launch.main()
    assert "[trainer] resumed from step 1" in capsys.readouterr().out


def test_trainer_refuses_without_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.get("smollm-360m").tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model=build(cfg), opt_cfg=AdamWConfig(), batch_fn=lambda s: {})
    assert Trainer(model=build(cfg), opt_cfg=AdamWConfig(), batch_fn=lambda s: {}, device="cpu").device.type == "cpu"
