"""The ssm family (mamba2-370m) of the port against the reference.

``models.mamba2``: the chunked SSD scan against the port's sequential
oracle on the reference's ``SSD_CASES`` (atol/rtol 2e-4, the reference's
rule for the same check) and against the reference's ``ssd_chunked`` (T
not a multiple of the chunk, with and without an initial state), the
sequential oracle against the reference's ``ssd_ref``, and
``_causal_conv``, ``mamba2_prefill`` (with and without ``initial``) and
``mamba2_decode`` against the reference's on the same inputs (numpy
seeds) and the same weights (the reference's ``init_params`` through
``params_from_numpy``).  Then the model: ``lm.prefill`` and
``lm.decode_step`` of ``mamba2-370m.tiny()`` (4 layers) in f32 and bf16,
logits and both states, end to end and layer by layer; the engine's
greedy tokens and teacher-forced logits; the refusals of the chunked
prefill and the row programs; ``extract_row`` and ``params_from_numpy``.
The model checks are shared with the hybrid family
(``tests/_torch_ssm_world.py``, which states the tolerances: f32 within
2e-5 of each tensor's largest |value|, bf16 within 2e-2 layer by layer).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.kernels import ref as jref
from repro.models import mamba2 as jm

import _torch_ssm_world as world_lib
from _torch_ssm_world import TOL, close_to_scale, np32 as _np
from repro_torch.configs import registry
from repro_torch.models import mamba2

torch.set_num_threads(1)

B, T, CAP = 2, 40, 64  # T = 2.5 chunks of the tiny config's 16
SSD_CASES = [  # (B, T, H, P, G, N, chunk): tests/test_kernels.py's
    (1, 32, 2, 8, 1, 8, 8),
    (2, 64, 4, 8, 2, 16, 16),
    (1, 128, 8, 4, 2, 8, 32),
]


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _ssd_inputs(seed, B, T, H, P, G, N):
    r = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=r.normal(size=(B, T, H, P)).astype(f),
        dt=r.uniform(0.01, 0.3, size=(B, T, H)).astype(f),
        A=(-r.uniform(0.3, 2.0, size=(H,))).astype(f),
        Bm=r.normal(size=(B, T, G, N)).astype(f),
        Cm=r.normal(size=(B, T, G, N)).astype(f),
        h0=r.normal(size=(B, H, P, N)).astype(f),
    )


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_chunked_matches_sequential(case):
    B_, T_, H, P, G, N, chunk = case
    a = _ssd_inputs(sum(case), B_, T_, H, P, G, N)
    args = [_t(a[k]) for k in ("x", "dt", "A", "Bm", "Cm")]
    y, h = mamba2.ssd_chunked(*args, chunk)
    y_ref, h_ref = mamba2.ssd_sequential(*args)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(h.numpy(), h_ref.numpy(), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("initial", [False, True], ids=["zero-state", "initial-state"])
@pytest.mark.parametrize("case", [(2, 37, 4, 8, 2, 16, 16), (1, 128, 8, 4, 1, 8, 32), (1, 5, 2, 4, 1, 4, 8)])
def test_ssd_chunked_matches_reference(case, initial):
    """T = 37 and T = 5 fit no whole chunk (the padded tail), with and
    without an initial state."""
    B_, T_, H, P, G, N, chunk = case
    a = _ssd_inputs(T_ + H, B_, T_, H, P, G, N)
    h0 = a["h0"] if initial else None
    args = [a[k] for k in ("x", "dt", "A", "Bm", "Cm")]
    y, h = mamba2.ssd_chunked(*map(_t, args), chunk, None if h0 is None else _t(h0))
    jy, jh = jm.ssd_chunked(*map(jnp.asarray, args), chunk, None if h0 is None else jnp.asarray(h0))
    close_to_scale(y, jy, TOL["float32"])
    close_to_scale(h, jh, TOL["float32"])
    # both against the sequential oracle, with the skip term
    D = np.linspace(0.5, 1.5, H).astype(np.float32)
    ys, hs = mamba2.ssd_sequential(*map(_t, args), _t(D), initial_state=None if h0 is None else _t(h0))
    jys, jhs = jref.ssd_ref(*map(jnp.asarray, args), jnp.asarray(D),
                            initial_state=None if h0 is None else jnp.asarray(h0))
    close_to_scale(ys, jys, TOL["float32"])
    close_to_scale(hs, jhs, TOL["float32"])
    np.testing.assert_allclose(y.numpy() + a["x"] * D[None, None, :, None], ys.numpy(), atol=2e-4, rtol=2e-4)


def test_softplus_is_jax_softplus():
    """``logaddexp(x, 0)``, also above torch's softplus threshold of 20."""
    x = np.asarray([-80.0, -20.0, -1.0, 0.0, 0.5, 19.0, 20.5, 35.0, 90.0], np.float32)
    np.testing.assert_allclose(mamba2.softplus(_t(x)).numpy(), np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-7, atol=0)


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------


def _cfg(get, dtype="float32"):
    return dataclasses.replace(get("mamba2-370m").tiny(), dtype=dtype)


@pytest.fixture(scope="module")
def block():
    """One layer's weights of the tiny config, a_log / dt_bias / d_skip /
    norm_gamma / conv_b drawn too (the plan initializes them to constants,
    which would hide a wrong index)."""
    jcfg, cfg = _cfg(jregistry.get), _cfg(registry.get)
    r = np.random.default_rng(5)
    plan = jm.mamba2_plan(jcfg)
    jp = {}
    for name, leaf in plan.items():
        if name == "a_log":
            jp[name] = r.uniform(-1.0, 1.0, size=leaf.shape)
        elif name == "dt_bias":
            jp[name] = r.uniform(-3.0, 1.0, size=leaf.shape)
        elif name in ("d_skip", "norm_gamma"):
            jp[name] = r.uniform(0.5, 1.5, size=leaf.shape)
        else:
            jp[name] = r.normal(size=leaf.shape) * (0.5 if leaf.scale else 1.0 / np.sqrt(leaf.shape[0]))
    jp = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    assert set(jp) == set(mamba2.mamba2_plan(cfg))
    return dict(jcfg=jcfg, cfg=cfg, jp={k: jnp.asarray(v) for k, v in jp.items()},
                p={k: _t(v) for k, v in jp.items()}, r=r)


def test_causal_conv_matches_reference(block):
    cfg = block["cfg"]
    C = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    xbc = block["r"].normal(size=(B, 11, C)).astype(np.float32)
    got = mamba2._causal_conv(_t(xbc), block["p"]["conv_w"], block["p"]["conv_b"])
    want = jm._causal_conv(jnp.asarray(xbc), block["jp"]["conv_w"], block["jp"]["conv_b"])
    close_to_scale(got, want, TOL["float32"])


@pytest.mark.parametrize("initial", [False, True], ids=["fresh", "initial"])
def test_mamba2_prefill_and_decode_match_reference(block, initial):
    cfg, jcfg, r = block["cfg"], block["jcfg"], block["r"]
    C = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    x = r.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    conv0 = r.normal(size=(B, cfg.ssm_conv - 1, C)).astype(np.float32)
    ssm0 = r.normal(size=(B, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state)).astype(np.float32)
    init = mamba2.Mamba2State(_t(conv0), _t(ssm0)) if initial else None
    jinit = jm.Mamba2State(jnp.asarray(conv0), jnp.asarray(ssm0)) if initial else None
    out, st = mamba2.mamba2_prefill(cfg, block["p"], _t(x), init)
    jout, jst = jm.mamba2_prefill(jcfg, block["jp"], jnp.asarray(x), jinit)
    close_to_scale(out, jout, TOL["float32"])
    close_to_scale(st.conv, jst.conv, TOL["float32"])
    close_to_scale(st.ssm, jst.ssm, TOL["float32"])
    x1 = r.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    dout, dst = mamba2.mamba2_decode(cfg, block["p"], _t(x1), st)
    jdout, jdst = jm.mamba2_decode(jcfg, block["jp"], jnp.asarray(x1), jst)
    close_to_scale(dout, jdout, TOL["float32"])
    close_to_scale(dst.conv, jdst.conv, TOL["float32"])
    close_to_scale(dst.ssm, jdst.ssm, TOL["float32"])


def test_prefill_then_step_equals_longer_prefill(block):
    """Prefill of T tokens then one decode step is the prefill of T + 1
    tokens at its last position, with the same final state, in both
    packages (the chunked scan and the exact recurrence agree)."""
    cfg, jcfg, r = block["cfg"], block["jcfg"], block["r"]
    x = r.normal(size=(B, T + 1, cfg.d_model)).astype(np.float32)
    out, st = mamba2.mamba2_prefill(cfg, block["p"], _t(x[:, :T]))
    step, st1 = mamba2.mamba2_decode(cfg, block["p"], _t(x[:, T:]), st)
    full, stf = mamba2.mamba2_prefill(cfg, block["p"], _t(x))
    jout, jst = jm.mamba2_prefill(jcfg, block["jp"], jnp.asarray(x[:, :T]))
    jstep, jst1 = jm.mamba2_decode(jcfg, block["jp"], jnp.asarray(x[:, T:]), jst)
    jfull, jstf = jm.mamba2_prefill(jcfg, block["jp"], jnp.asarray(x))
    for s, f, s1, f1 in ((step, full, st1, stf), (jstep, jfull, jst1, jstf)):
        close_to_scale(s, _np(f)[:, -1:], 2e-4)
        close_to_scale(s1.ssm, f1.ssm, 2e-4)
        close_to_scale(s1.conv, f1.conv, TOL["float32"])  # a (B, d) and a (B, T, d) projection
    close_to_scale(out, _np(full)[:, :T], 2e-4)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def world(request):
    return world_lib.make_world("mamba2-370m", request.param, B=B, T=T, cap=CAP, seed=7)


def test_prefill_matches_reference(world):
    world_lib.check_prefill(world)


def test_prefill_layer_by_layer_matches_reference(world):
    world_lib.check_layer_by_layer(world)


def test_decode_steps_match_reference(world):
    world_lib.check_decode_steps(world)


def test_engine_generates_the_references_tokens(world):
    world_lib.check_engine(world)


def test_engine_refuses_chunked_prefill_and_row_programs(world):
    world_lib.check_refusals(world)


def test_extract_row_carries_the_states(world):
    world_lib.check_extract_row(world)


def test_params_from_numpy_round_trips_the_plan(world):
    cfg = world["cfg"]
    assert set(world_lib.lm.param_plan(cfg)) == {"embed", "final_norm", "head", "layers"}
    world_lib.check_params(world, [("layers", "mamba", name) for name in ("a_log", "dt_bias", "d_skip",
                                                                           "norm_gamma")])
