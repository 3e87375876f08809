"""The port's load-then-generate slice against the reference ``Engine``.

Both packages get the same weights (the reference's initialized parameters
as numpy arrays) and the same token ids, on ``smollm-360m.tiny()`` in f32.
"""
import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import codec as jcodec
from repro.models import lm as jlm
from repro.serving import kv_layout as jkv_layout
from repro.serving.engine import Engine as JEngine

from repro_torch.configs import registry
from repro_torch.core import codec
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import kv_layout
from repro_torch.serving.engine import Engine

torch.set_num_threads(1)

CAP = 96
CHUNK = 24
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _cfgs():
    jcfg = dataclasses.replace(jregistry.get("smollm-360m").tiny(), dtype="float32")
    cfg = dataclasses.replace(registry.get("smollm-360m").tiny(), dtype="float32")
    return jcfg, cfg


@pytest.fixture(scope="module")
def engines():
    jcfg, cfg = _cfgs()
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = params_from_numpy(cfg, tree, "cpu")
    return JEngine(jcfg, jparams, cache_capacity=CAP), Engine(cfg, params, cache_capacity=CAP, device="cpu")


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32))


def _to_torch_caches(jc):
    return lm.Caches(
        kv_k=torch.as_tensor(np.asarray(jc.kv_k, np.float32)).to(torch.float32),
        kv_v=torch.as_tensor(np.asarray(jc.kv_v, np.float32)).to(torch.float32),
        length=torch.as_tensor(np.asarray(jc.length)),
    )


@pytest.fixture(scope="module")
def prefilled(engines):
    jeng, eng = engines
    toks = _tokens(1, (2, 2 * CHUNK))
    jlogits, jc = jeng.calculate_kv({"tokens": jnp.asarray(toks)})
    logits, c = eng.calculate_kv({"tokens": torch.as_tensor(toks)})
    return toks, (jlogits, jc), (logits, c)


def test_calculate_kv_matches_reference(prefilled):
    _, (jlogits, jc), (logits, c) = prefilled
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(c.kv_k), np.asarray(jc.kv_k), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(c.kv_v), np.asarray(jc.kv_v), atol=1e-4, rtol=1e-4)
    assert c.kv_k.shape[2] == CAP and np.array_equal(c.length.numpy(), np.asarray(jc.length))


def test_generate_from_prefill_matches_and_keeps_input(engines, prefilled):
    jeng, eng = engines
    _, (jlogits, jc), (logits, c) = prefilled
    first = np.array(jnp.argmax(jlogits[:, -1], -1), np.int32)  # a writable copy for torch
    before = c.clone()
    ref = jeng.generate_with_kv(jc, jnp.asarray(first), 8)
    got = eng.generate_with_kv(c, torch.as_tensor(first), 8)
    np.testing.assert_array_equal(got, ref)
    for a, b in zip(before, c):
        if a is not None:
            assert torch.equal(a, b), "generate_with_kv changed its input caches"
    # logits_with_kv leaves its input alone too and follows the reference
    jl, _ = jeng.logits_with_kv(jc, ref[:, :3])
    pl, _ = eng.logits_with_kv(c, ref[:, :3])
    np.testing.assert_allclose(pl, jl, atol=1e-4, rtol=1e-4)
    assert torch.equal(before.kv_k, c.kv_k) and torch.equal(before.length, c.length)


@pytest.fixture(scope="module")
def shared_tables(prefilled):
    """Reference-profiled tables, shared with the port."""
    _, (_, jc), _ = prefilled
    kv0 = jkv_layout.caches_to_codec_kv(jc, 0, 2 * CHUNK)
    jct = jcodec.profile([kv0], jcodec.CodecConfig(precision=11))
    ct = codec.tables_from_numpy(
        anchor=np.asarray(jct.anchor.freqs),
        deltas={l: np.asarray(t.freqs) for l, t in jct.deltas.items()},
        ll_anchor=np.asarray(jct.ll_anchor.freqs),
        ll_delta=np.asarray(jct.ll_delta.freqs),
        table_idx=jct.table_idx, delta_scale=jct.delta_scale,
        config=codec.CodecConfig(**dataclasses.asdict(jct.config)),
        n_layers=jct.n_layers, n_channels=jct.n_channels, device="cpu",
    )
    return jct, ct


@pytest.fixture(scope="module")
def runs(prefilled, shared_tables):
    """Three requests' runs at mixed levels; the last run is ragged."""
    _, (_, jc), _ = prefilled
    jct, ct = shared_tables
    blobs = []
    for row in (0, 1):
        kv = kv_layout.caches_to_codec_kv(_to_torch_caches(jc), row, 2 * CHUNK)
        blobs.append([codec.encode_all_levels(kv[:, :, i * CHUNK:(i + 1) * CHUNK], ct, chunk_idx=i)
                      for i in range(2)])
    return [
        [blobs[0][0][0], blobs[0][1][0]],  # row 0: level 0, two chunks
        [blobs[1][0][1], blobs[1][1][3]],  # row 1: levels 1 and 3
        [blobs[0][0][4]],  # row 2: level 4, one chunk
    ]


def test_insert_runs_matches_reference(engines, runs, shared_tables):
    jeng, eng = engines
    jct, ct = shared_tables
    jkv, jspans = jcodec.decode_chunk_runs(runs, jct, out_dtype=jnp.bfloat16)
    kv, spans = codec.decode_chunk_runs(runs, ct, out_dtype=torch.bfloat16)
    assert spans == jspans
    rows, starts = [2, 0, 3], [0, 0, 5]
    tokens = [n for _, n in spans]
    jcache = jeng.insert_runs(jeng.empty_caches(4), jkv, rows, starts, tokens)
    cache = eng.insert_runs(eng.empty_caches(4), kv, rows, starts, tokens)
    np.testing.assert_array_equal(cache.length.numpy(), np.asarray(jcache.length))
    got_k, ref_k = _np(cache.kv_k), np.asarray(jcache.kv_k, np.float32)
    # level-0 run (row 2) is bit-identical, the untouched row 1 stays zero
    np.testing.assert_array_equal(got_k[:, 2], ref_k[:, 2])
    np.testing.assert_array_equal(_np(cache.kv_v)[:, 2], np.asarray(jcache.kv_v, np.float32)[:, 2])
    assert not got_k[:, 1].any()
    # lossy rows: within one bf16 rounding of the reference
    np.testing.assert_allclose(got_k, ref_k, atol=2e-2, rtol=1e-2)


def test_generate_after_insert_runs_matches_reference(engines, runs, shared_tables):
    """Ragged per-row lengths through the decode attention, 8 greedy steps."""
    jeng, eng = engines
    jct, ct = shared_tables
    jkv, spans = jcodec.decode_chunk_runs(runs, jct, out_dtype=jnp.bfloat16)
    tokens = [n for _, n in spans]
    jcache = jeng.insert_runs(jeng.empty_caches(3), jkv, [0, 1, 2], [0, 0, 0], tokens)
    # the same decoded KV on both sides isolates the model from the codec
    cache = eng.insert_runs(eng.empty_caches(3), torch.as_tensor(np.asarray(jkv, np.float32)),
                            [0, 1, 2], [0, 0, 0], tokens)
    first = np.array([3, 7, 11], np.int32)
    ref = jeng.generate_with_kv(jcache, jnp.asarray(first), 8)
    got = eng.generate_with_kv(cache, torch.as_tensor(first), 8)
    np.testing.assert_array_equal(got, ref)


def test_decode_to_cache_then_prefill_extend_matches(engines, prefilled, runs, shared_tables):
    """The materialize pattern: a decoded chunk, then a TEXT chunk on top."""
    jeng, eng = engines
    toks, _, _ = prefilled
    jct, ct = shared_tables
    chunk0 = runs[1][:1]  # a level-1 chunk of row 1
    jkv = jcodec.decode_chunks(chunk0, jct, out_dtype=jnp.bfloat16)
    kv = codec.decode_chunks(chunk0, ct, out_dtype=torch.bfloat16)
    jc = jeng.decode_to_cache(jeng.empty_caches(1), jkv, 0)
    c = eng.decode_to_cache(eng.empty_caches(1), kv, 0)
    np.testing.assert_array_equal(_np(c.kv_k), np.asarray(jc.kv_k, np.float32))
    np.testing.assert_array_equal(c.length.numpy(), np.asarray(jc.length))
    text = toks[1:2, CHUNK:]
    # f32 caches holding the same decoded KV: the recompute itself within 1e-4
    kv32 = np.asarray(jkv, np.float32)
    jc32 = jkv_layout.codec_kv_to_caches(kv32, jeng.cfg, capacity=CAP, dtype=jnp.float32)
    c32 = kv_layout.codec_kv_to_caches(kv32, eng.cfg, capacity=CAP, dtype=torch.float32, device="cpu")
    jl, jc2 = jeng.prefill_extend(jnp.asarray(text), jc32)
    before = c32.clone()
    pl, c2 = eng.prefill_extend(torch.as_tensor(text), c32)
    np.testing.assert_allclose(_np(pl), np.asarray(jl), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(c2.kv_k), np.asarray(jc2.kv_k), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(c2.kv_v), np.asarray(jc2.kv_v), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(c2.length.numpy(), np.asarray(jc2.length))
    assert torch.equal(before.kv_k, c32.kv_k), "prefill_extend changed its input caches"
    # the serving (bf16) cache: same greedy continuation
    jl, jc2 = jeng.prefill_extend(jnp.asarray(text), jc)
    pl, c2 = eng.prefill_extend(torch.as_tensor(text), c)
    ref = jeng.generate_with_kv(jc2, jnp.argmax(jl[:, -1], -1).astype(jnp.int32), 8)
    got = eng.generate_with_kv(c2, torch.argmax(pl[:, -1], -1), 8)
    np.testing.assert_array_equal(got, ref)


def test_decode_at_full_capacity_clamps_like_reference(engines, prefilled):
    """At cache_len == S the new token lands on slot S-1 (dynamic_update_slice clamps)."""
    jeng, eng = engines
    _, (_, jc), _ = prefilled
    jfull = jc._replace(length=jnp.full((2,), CAP, jnp.int32))
    full = _to_torch_caches(jfull)
    tok = np.array([[5], [9]], np.int32)
    jl, jnew = jlm.decode_step(jeng.cfg, jeng.params, jnp.asarray(tok), jfull)
    pl, new = lm.decode_step(eng.cfg, eng.params, torch.as_tensor(tok), full)
    np.testing.assert_allclose(_np(pl), np.asarray(jl), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(new.kv_k), np.asarray(jnew.kv_k), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(new.length.numpy(), np.asarray(jnew.length))


@pytest.mark.parametrize("start", [CAP - 10, -3, CAP + 4])
def test_insert_codec_run_clamps_like_reference(start):
    rng = np.random.default_rng(start + 100)
    L, B, Hkv, Dh, T = 2, 3, 2, 4, 16
    k0 = rng.normal(size=(L, B, CAP, Hkv, Dh)).astype(np.float32)
    v0 = rng.normal(size=(L, B, CAP, Hkv, Dh)).astype(np.float32)
    ln = np.array([0, 40, CAP], np.int32)
    new = rng.normal(size=(L, 2, T, Hkv * Dh)).astype(np.float32)
    jk, jv, jl = jkv_layout.insert_codec_run(
        jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(ln), jnp.asarray(new), jnp.int32(start))
    k, v, l = kv_layout.insert_codec_run(
        torch.as_tensor(k0), torch.as_tensor(v0), torch.as_tensor(ln), torch.as_tensor(new), start)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(l.numpy(), np.asarray(jl))


@pytest.mark.parametrize("starts", [[CAP - 6, 0], [3, CAP - 20]])
def test_insert_codec_runs_windows_like_reference(starts):
    """The shifted-window merge, including a window that overhangs capacity."""
    rng = np.random.default_rng(sum(starts))
    L, B, Hkv, Dh = 2, 4, 2, 4
    run_tokens = (6, 20)
    k0 = rng.normal(size=(L, B, CAP, Hkv, Dh)).astype(np.float32)
    v0 = rng.normal(size=(L, B, CAP, Hkv, Dh)).astype(np.float32)
    ln = np.array([1, 2, 3, 4], np.int32)
    new = rng.normal(size=(L, 2, sum(run_tokens), Hkv * Dh)).astype(np.float32)
    rows = [3, 1]
    jk, jv, jl = jkv_layout.insert_codec_runs(
        jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(ln), jnp.asarray(new),
        jnp.asarray(rows, jnp.int32), jnp.asarray(starts, jnp.int32), run_tokens=run_tokens)
    k, v, l = kv_layout.insert_codec_runs(
        torch.as_tensor(k0), torch.as_tensor(v0), torch.as_tensor(ln), torch.as_tensor(new),
        rows, starts, run_tokens)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(l.numpy(), np.asarray(jl))


def test_insert_runs_checks_arguments(engines):
    _, eng = engines
    cache = eng.empty_caches(2)
    kv = torch.zeros((4, 2, 8, 64))
    bad = [
        ([0], [0, 1], [8]),  # lengths disagree
        ([0, 0], [0, 0], [4, 4]),  # duplicate row
        ([2], [0], [8]),  # row out of range
        ([0], [CAP - 4], [8]),  # overhangs capacity
    ]
    for rows, starts, toks in bad:
        with pytest.raises(ValueError):
            eng.insert_runs(cache, kv, rows, starts, toks)


def test_engine_without_device_raises_without_gpu(engines):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    _, eng = engines
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(eng.cfg, eng.params, cache_capacity=CAP)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        codec.profile([np.zeros((4, 2, 20, 64), np.float32)])


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_reference_or_msgpack():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "msgpack"), f"{path} imports {name}"
