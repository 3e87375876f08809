"""The encdec family (seamless-m4t-large-v2) of the port's model against the
reference's.

Both packages get the reference's weight draw (``PRNGKey(0)``, converted
leaf for leaf by ``params_from_numpy``) and the same inputs from a numpy
seed: two rows of f32 source-frame embeddings (the stubbed speech
frontend's output) and decoder tokens.  Three variants: ``.tiny()`` (2 + 2
layers, MHA 4 x 32, ``frontend_dim`` 64) in f32 and in bf16, and the
published head geometry (MHA 16 x 64) at the tiny widths otherwise in f32,
with the query chunk at 8 in both packages (the reference's ``attn_chunk``,
the port's ``flash_attention.Q_CHUNK``) so the decoder prompt's
cross-attention runs in two query chunks.  Held: ``encode``, ``prefill``
with ``pad_to`` (its logits and all six ``EncDecCaches`` fields), three
chained ``decode_step``\\ s, ``loss_fn`` with and without a mask, and the
states after each encoder and decoder layer.

Tolerances: f32 element by element within 2e-5 (absolute and relative).
bf16 within 2e-2 of the largest |value| of each compared layer or row, the
vlm family's rule (``tests/test_torch_vlm.py``): the frameworks round bf16
intermediates at other places, so the residual stream differs by bf16 steps
of its own scale.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import attention as jattention
from repro.models import encdec as jencdec

from repro_torch.configs import registry
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels import flash_attention
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import encdec, lm
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)

B, S_SRC, T, CAP = 2, 20, 12, 24
N_STEPS = 3
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
VARIANTS = [("tiny", "float32"), ("tiny", "bfloat16"), ("d64", "float32")]
FIELDS = ("self_k", "self_v", "cross_k", "cross_v")


def _cfg(get, variant, dtype):
    cfg = get("seamless-m4t-large-v2").tiny()
    if variant == "d64":
        cfg = dataclasses.replace(cfg, n_heads=16, n_kv_heads=16, d_head=64, attn_chunk=8)
    return dataclasses.replace(cfg, dtype=dtype)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol):
    """f32 (tol 2e-5): element by element; bf16 (tol 2e-2): per leading
    index (a cache's layer, a row), of its largest |value|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if tol < 1e-3:
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
        return
    for i, (g, w) in enumerate(zip(got, want)):
        err, scale = np.abs(g - w).max(), np.abs(w).max()
        assert err <= tol * scale, f"[{i}]: {err} off, {tol} of {scale} allowed"


def _torch_caches(jc, dtype):
    return encdec.EncDecCaches(*(torch.tensor(_np(getattr(jc, f))).to(dtype) for f in FIELDS),
                               torch.tensor(np.asarray(jc.src_len)), torch.tensor(np.asarray(jc.length)))


def _first_layers(tree, stack, n):
    """The parameter tree with only the first ``n`` layers of ``stack``."""
    out = dict(tree)
    out[stack] = jax.tree_util.tree_map(lambda a: a[:n], tree[stack])
    return out


@pytest.fixture(scope="module", params=VARIANTS, ids=[f"{v}-{dt}" for v, dt in VARIANTS])
def world(request):
    variant, dtype = request.param
    jcfg, cfg = _cfg(jregistry.get, variant, dtype), _cfg(registry.get, variant, dtype)
    jparams = jencdec.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    r = np.random.default_rng(len(variant) + len(dtype))
    src = r.normal(size=(B, S_SRC, cfg.frontend_dim)).astype(np.float32)
    tokens = r.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    jlogits, jc = jencdec.prefill(jcfg, jparams, {"src_embeds": jnp.asarray(src), "tokens": jnp.asarray(tokens)},
                                  pad_to=CAP)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flash_attention, "Q_CHUNK", cfg.attn_chunk)
        logits, c = encdec.prefill(cfg, params, {"src_embeds": torch.as_tensor(src),
                                                 "tokens": torch.as_tensor(tokens)}, pad_to=CAP)
        yield dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params, tol=TOL[dtype], dtype=lm.DTYPES[dtype],
                   r=r, src=src, tokens=tokens, jlogits=jlogits, jc=jc, logits=logits, c=c)


def test_encode_matches_reference(world):
    want = jencdec.encode(world["jcfg"], world["jparams"], jnp.asarray(world["src"]))
    got = encdec.encode(world["cfg"], world["params"], torch.as_tensor(world["src"]))
    assert got.dtype == world["dtype"] and got.shape == (B, S_SRC, world["cfg"].d_model)
    _close(got, want, world["tol"])


def test_prefill_matches_reference(world):
    """The last token's logits and all six cache fields; the self K/V padded
    to ``pad_to`` with zeros, the cross K/V over every source frame."""
    cfg, c, jc = world["cfg"], world["c"], world["jc"]
    assert world["logits"].shape == (B, 1, cfg.padded_vocab_size)
    _close(world["logits"], world["jlogits"], world["tol"])
    assert c.self_k.shape == (cfg.dec_layers, B, CAP, cfg.n_kv_heads, cfg.d_head)
    assert c.cross_k.shape == (cfg.dec_layers, B, S_SRC, cfg.n_kv_heads, cfg.d_head)
    for f in FIELDS:
        assert getattr(c, f).dtype == world["dtype"]
        _close(getattr(c, f), getattr(jc, f), world["tol"])
    assert not c.self_k[:, :, T:].float().any() and not c.self_v[:, :, T:].float().any()
    assert c.src_len.dtype == c.length.dtype == torch.int32
    assert c.src_len.tolist() == np.asarray(jc.src_len).tolist() == [S_SRC] * B
    assert c.length.tolist() == np.asarray(jc.length).tolist() == [T] * B


def test_decode_steps_match_reference(world):
    """Three chained steps from the reference's prefill caches, each package
    on its own caches: the logits, the self K/V written in place, the cross
    K/V untouched and ``length`` advanced."""
    jc, caches = world["jc"], _torch_caches(world["jc"], world["dtype"])
    cross = caches.cross_k.clone()
    for _ in range(N_STEPS):
        tok = world["r"].integers(0, world["cfg"].vocab_size, size=(B, 1)).astype(np.int32)
        jl, jc = jencdec.decode_step(world["jcfg"], world["jparams"], jnp.asarray(tok), jc)
        got, caches = encdec.decode_step(world["cfg"], world["params"], torch.as_tensor(tok), caches)
        _close(got, jl, world["tol"])
        _close(caches.self_k, jc.self_k, world["tol"])
        _close(caches.self_v, jc.self_v, world["tol"])
        assert caches.length.tolist() == np.asarray(jc.length).tolist()
    assert caches.length.tolist() == [T + N_STEPS] * B
    assert torch.equal(caches.cross_k, cross)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "mask"])
def test_loss_matches_reference(world, masked):
    r = np.random.default_rng(7)
    labels = r.integers(0, world["cfg"].vocab_size, size=(B, T)).astype(np.int32)
    batch = {"src_embeds": world["src"], "tokens": world["tokens"], "labels": labels}
    if masked:
        batch["mask"] = (r.random((B, T)) < 0.6).astype(np.float32)
    jloss, jm = jencdec.loss_fn(world["jcfg"], world["jparams"], {k: jnp.asarray(v) for k, v in batch.items()})
    loss, m = encdec.loss_fn(world["cfg"], world["params"], {k: torch.as_tensor(v) for k, v in batch.items()})
    assert loss.dtype == torch.float32 and loss.shape == ()
    tol = 2e-5 if world["tol"] < 1e-3 else 1e-3  # a mean over B * T positions, in f32 from bf16 logits
    np.testing.assert_allclose(float(loss), float(jloss), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]), rtol=tol, atol=tol)
    assert float(m["aux"]) == float(jm["aux"]) == 0.0


def test_layer_states_match_reference(world):
    """The encoder memory after each of its first l layers, and the decoder's
    hidden states and caches after each of its first l layers over the
    reference's memory."""
    jcfg, cfg, jp, p = world["jcfg"], world["cfg"], world["jparams"], world["params"]
    for l in range(1, cfg.enc_layers + 1):
        want = jencdec.encode(dataclasses.replace(jcfg, enc_layers=l), _first_layers(jp, "enc_layers", l),
                              jnp.asarray(world["src"]))
        got = encdec.encode(dataclasses.replace(cfg, enc_layers=l), _first_layers(p, "enc_layers", l),
                            torch.as_tensor(world["src"]))
        _close(got, want, world["tol"])
    jmem = jencdec.encode(jcfg, jp, jnp.asarray(world["src"]))
    mem = torch.tensor(_np(jmem)).to(world["dtype"])
    tokens = world["tokens"]
    for l in range(1, cfg.dec_layers + 1):
        jcl, cl = dataclasses.replace(jcfg, dec_layers=l), dataclasses.replace(cfg, dec_layers=l)
        jx, (jsk, jsv), (jck, jcv) = jencdec._decoder_prefill(jcl, _first_layers(jp, "dec_layers", l), jmem,
                                                               jnp.asarray(tokens))
        shape = (l, B, T, cfg.n_kv_heads, cfg.d_head)
        cross = (l, B, S_SRC, cfg.n_kv_heads, cfg.d_head)
        caches = encdec.EncDecCaches(torch.zeros(shape, dtype=world["dtype"]), torch.zeros(shape, dtype=world["dtype"]),
                                     torch.empty(cross, dtype=world["dtype"]), torch.empty(cross, dtype=world["dtype"]),
                                     None, None)
        x = encdec._decoder_prefill(cl, _first_layers(p, "dec_layers", l), mem, torch.as_tensor(tokens).long(), caches)
        _close(x, jx, world["tol"])
        for got, want in zip(caches[:4], (jsk, jsv, jck, jcv)):
            _close(got, want, world["tol"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_teacher_forced_decode_matches_prefill(dtype):
    """The reference's teacher-forced check (``tests/test_models.py``) on the
    encdec family: ``decode_step`` after ``prefill`` of T - 1 tokens gives
    the last logits of ``prefill`` of T tokens, over the same memory."""
    cfg = dataclasses.replace(registry.get("seamless-m4t-large-v2").tiny(), dtype=dtype)
    params = encdec.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    r = np.random.default_rng(3)
    src = torch.as_tensor(r.normal(size=(1, S_SRC, cfg.frontend_dim)).astype(np.float32))
    tokens = torch.as_tensor(r.integers(0, cfg.vocab_size, size=(1, 20)))
    full, _ = encdec.prefill(cfg, params, {"src_embeds": src, "tokens": tokens}, pad_to=24)
    _, caches = encdec.prefill(cfg, params, {"src_embeds": src, "tokens": tokens[:, :-1]}, pad_to=24)
    step, _ = encdec.decode_step(cfg, params, tokens[:, -1:], caches)
    np.testing.assert_allclose(_np(step[:, -1]), _np(full[:, -1]), atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_reference(dtype, monkeypatch):
    """The plain cross-attention at Tq != Tk with GQA, as the decoder runs it
    on every device: K4's plain version, bidirectional at chunk 4 over 10
    queries, against the reference's ``chunked_mha`` and equal to one
    unchunked softmax; K3's plain version against the reference's
    ``_decode_mha_plain`` with a ragged ``src_len``."""
    tol = TOL[dtype]
    r = np.random.default_rng(11)
    qn, kn, vn = (r.normal(size=s).astype(np.float32) for s in ((2, 10, 4, 32), (2, 23, 2, 32), (2, 23, 2, 32)))
    jdt, dt = jnp.dtype(dtype), lm.DTYPES[dtype]
    want = jattention.chunked_mha(*(jnp.asarray(a, jdt) for a in (qn, kn, vn)), causal=False, prefix_len=None,
                                  chunk=4)
    q, k, v = (torch.tensor(a).to(dt) for a in (qn, kn, vn))
    monkeypatch.setattr(flash_attention, "Q_CHUNK", 4)
    got = flash_attention_plain(q, k, v, causal=False)
    assert got.dtype == dt
    _close(got, want, tol)
    monkeypatch.setattr(flash_attention, "Q_CHUNK", 10)
    whole = flash_attention_plain(q, k, v, causal=False)
    torch.testing.assert_close(got, whole, atol=1e-6, rtol=1e-6)
    src_len = np.array([23, 7], np.int32)
    qd = q[:, 0]
    want = jattention._decode_mha_plain(jnp.asarray(qn[:, 0], jdt), jnp.asarray(kn, jdt), jnp.asarray(vn, jdt),
                                        jnp.asarray(src_len))
    got = decode_attention_plain(qd, k, v, torch.as_tensor(src_len))
    _close(got, want, tol)
    # row 1 sees its first 7 frames only: moving the others leaves it as it was
    moved = v.clone()
    moved[:, 7:] += 1.0
    again = decode_attention_plain(qd, k, moved, torch.as_tensor(src_len))
    assert torch.equal(again[1], got[1]) and not torch.equal(again[0], got[0])
