"""Decoder LM, dense, MoE, vlm, ssm and hybrid families: plan, init,
prefill, chunked prefill, decode.

Layers run as a Python loop over the stacked per-layer weights (leading
``L`` axis, as in the reference's pytree).  The MoE family's layers differ
from the dense family's in their FFN alone (``models.moe``; its load
balancing loss is summed over the layers by ``loss_fn`` and dropped by the
serving entry points, as in the reference).  The vlm family
(paligemma-3b) is the dense decoder behind a multimodal prefix:
``prefill`` projects the batch's precomputed ``patch_embeds`` (the
stubbed vision tower's output) through ``frontend_proj``, puts those rows
before the text tokens and attends bidirectionally over them (prefix-LM,
K4's ``prefix_len``); the caches
then hold the prefix rows first, and ``prefill_extend`` and
``decode_step`` treat them as any cached rows.  The ssm family
(mamba2-370m) stacks Mamba-2 blocks (``models.mamba2``) and carries their
conv and SSM states instead of K/V; the hybrid family (zamba2-2.7b) runs
``n_layers // shared_block_every`` segments of Mamba-2 layers, each
followed by one weight-shared attention + MLP block whose K/V (one cache
per application, ``shared_k``/``shared_v``) go through K4 and K3, then
the remaining Mamba-2 layers.  Neither has a chunked prefill, as in the
reference.  Entry points:

  * ``param_plan`` / ``init_params`` / ``param_specs``
  * ``loss_fn(cfg, params, batch)`` — the training loss; under autograd
    each layer body runs under activation checkpointing when ``cfg.remat``
    is set (``_remat``, the reference's ``jax.checkpoint``), and K4 on the
    card differentiates through ``kernels.ops``' autograd Function
  * ``prefill(cfg, params, batch, pad_to=)``   — logits + caches (K4)
  * ``prefill_extend(cfg, params, tokens, caches[, widths])`` — TEXT-chunk
    recompute on top of loaded KV (plain attention, as in the reference),
    optionally width-masked per row
  * ``decode_step(cfg, params, tokens, caches)`` — one-token step (K3)

``prefill_extend`` and ``decode_step`` update ``caches`` *in place* (K/V,
shared K/V and the Mamba-2 states alike): the reference returns new caches
from pure functions, and the serving engine clones where its callers rely
on the old cache staying intact.

Under a process-group mesh (``sharding.use_rules`` with a ``DeviceMesh``)
parameters and batches are DTensors and the reference's constraints apply
(``sharding.constrain``): the embedding, the logits and the decode caches,
which are allocated split as ``("layers", "batch", "kv_seq_decode",
"kv_heads", "head_dim")`` and written in their local form
(``attention.write_at``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch import tracing
from repro_torch._tree import tree_leaves
from repro_torch.configs.base import ArchConfig
from repro_torch.models import sharding
from repro_torch.models.attention import _project_qkv, attn_decode, attn_plan, attn_prefill, write_at
from repro_torch.models.common import (
    DTYPES,
    Leaf,
    apply_norm,
    init_from_plan,
    specs_from_plan,
    mlp_apply,
    mlp_plan,
    norm_plan,
    rope,
    softmax_cross_entropy,
)
from repro_torch.models.mamba2 import Mamba2State, mamba2_decode, mamba2_plan, mamba2_prefill
from repro_torch.models.mamba2 import _dims as _mamba_dims
from repro_torch.models.moe import moe_apply, moe_plan

__all__ = [
    "FAMILIES",
    "ATTENTION_FAMILIES",
    "Caches",
    "param_plan",
    "init_params",
    "param_specs",
    "loss_fn",
    "prefill",
    "prefill_extend",
    "decode_step",
    "masked_window_update",
]


class Caches(NamedTuple):
    """Serving caches, the reference's seven fields; the fields a family
    does not use are None (the ssm family has no K/V, only the hybrid has
    shared K/V)."""

    kv_k: Optional[torch.Tensor]  # (L, B, S, Hkv, Dh)
    kv_v: Optional[torch.Tensor]
    length: torch.Tensor  # (B,) int32
    mamba_conv: Optional[torch.Tensor] = None  # (L, B, K-1, C)
    mamba_ssm: Optional[torch.Tensor] = None  # (L, B, H, P, N) f32
    shared_k: Optional[torch.Tensor] = None  # (n_apps, B, S, Hkv, Dh)  [hybrid]
    shared_v: Optional[torch.Tensor] = None

    def clone(self) -> "Caches":
        return Caches(*(None if t is None else t.clone() for t in self))


FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid")  # the families the port builds
# the families with a K/V cache in every layer: chunked prefill, the row
# programs and CacheGen's codec apply to these only (as in the reference)
ATTENTION_FAMILIES = ("dense", "moe", "vlm")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"the port builds the {', '.join(FAMILIES)} families only, not {cfg.family}")


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


def _stack_plan(plan: Dict[str, Any], n: int) -> Dict[str, Any]:
    return {
        k: Leaf((n,) + v.shape, ("layers",) + v.logical, v.init, v.scale)
        if isinstance(v, Leaf) else _stack_plan(v, n)
        for k, v in plan.items()
    }


def _dense_layer_plan(cfg: ArchConfig) -> Dict[str, Any]:
    p: Dict[str, Any] = {"ln1": norm_plan(cfg.norm, cfg.d_model), "attn": attn_plan(cfg)}
    if not cfg.parallel_block:
        p["ln2"] = norm_plan(cfg.norm, cfg.d_model)
    if cfg.family == "moe":
        p["moe"] = moe_plan(cfg)
    else:
        p["mlp"] = mlp_plan(cfg.mlp, cfg.d_model, cfg.d_ff, cfg.mlp_bias)
    return p


def _shared_block_plan(cfg: ArchConfig) -> Dict[str, Any]:
    return {
        "ln1": norm_plan("rmsnorm", cfg.d_model),
        "attn": attn_plan(cfg),
        "ln2": norm_plan("rmsnorm", cfg.d_model),
        "mlp": mlp_plan(cfg.mlp, cfg.d_model, cfg.d_ff, cfg.mlp_bias),
    }


def param_plan(cfg: ArchConfig) -> Dict[str, Any]:
    _check_family(cfg)
    d, V = cfg.d_model, cfg.padded_vocab_size
    plan: Dict[str, Any] = {
        "embed": Leaf((V, d), ("vocab", "embed"), scale=0.02),
        "final_norm": norm_plan(cfg.norm, d),
    }
    if not cfg.tie_embeddings:
        plan["head"] = Leaf((d, V), ("embed", "vocab"))
    if cfg.family in ATTENTION_FAMILIES:
        plan["layers"] = _stack_plan(_dense_layer_plan(cfg), cfg.n_layers)
    else:
        plan["layers"] = _stack_plan({"ln1": norm_plan(cfg.norm, d), "mamba": mamba2_plan(cfg)}, cfg.n_layers)
    if cfg.family == "hybrid":
        plan["shared_block"] = _shared_block_plan(cfg)
    if cfg.family == "vlm":
        plan["frontend_proj"] = Leaf((cfg.frontend_dim, d), ("frontend", "embed"))
    return plan


def init_params(cfg: ArchConfig, generator: torch.Generator, device) -> Dict[str, Any]:
    """Random weights in ``cfg.dtype`` on ``device``, drawn from ``generator``
    (which must live on the same device) with the reference's std rule."""
    return init_from_plan(param_plan(cfg), generator, device, DTYPES[cfg.dtype])


def param_specs(cfg: ArchConfig) -> Dict[str, Any]:
    """Each parameter's logical axes, in the tree of :func:`param_plan`."""
    return specs_from_plan(param_plan(cfg))


# the decode caches' logical axes (the reference's constraint on them)
CACHE_AXES = ("layers", "batch", "kv_seq_decode", "kv_heads", "head_dim")
# the Mamba-2 states' logical axes (the reference's decode cells')
CONV_AXES = ("layers", "batch", None, "ssm_inner")
SSM_AXES = ("layers", "batch", "ssm_heads", None, "state")


def _unstack(node, n: int) -> List[Dict[str, Any]]:
    """The ``n`` layers' stacked weights ``node`` as one dict of views a layer,
    by ``torch.unbind``: under autograd the layers' gradients are stacked
    once (``unbind``'s backward), where a per-layer ``select`` would add a
    zero-padded full-size gradient per layer and leaf."""
    flat = {k: _unstack(v, n) if isinstance(v, dict) else torch.unbind(v) for k, v in node.items()}
    return [{k: v[l] for k, v in flat.items()} for l in range(n)]


# remat_policy "dots" (``dots_with_no_batch_dims_saveable``): keep the
# outputs of the 2-D weight products, recompute the rest (the attention's
# batched products, the norms, the activations)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ArchConfig, fn):
    """A layer body ``fn(x, p)`` (``p`` its weights) under activation
    checkpointing (``torch.utils.checkpoint``, non-reentrant) when
    ``cfg.remat`` is set and it runs under autograd (grad enabled, ``x`` or
    a weight requiring grad), with ``cfg.remat_policy`` "full" (recompute
    the whole body in the backward) or "dots": the reference's ``_remat``.
    Without grad (every serving path) ``fn`` runs as it is."""
    if not cfg.remat:
        return fn
    context_fn = (functools.partial(create_selective_checkpoint_contexts, _dots_policy)
                  if cfg.remat_policy == "dots" else noop_context_fn)

    def body(x, p):
        if not (torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in tree_leaves(p)))):
            return fn(x, p)
        return checkpoint(fn, x, p, use_reentrant=False, context_fn=context_fn)

    return body


# ---------------------------------------------------------------------------
# Blocks, embedding, head
# ---------------------------------------------------------------------------


def _mlp_residual(cfg, p, x, h):
    """The FFN half of a block; ``x`` already holds the attention output.
    Returns (x, aux): the MoE layer's load-balancing loss, 0.0 for a dense
    FFN."""
    if cfg.parallel_block:
        return x + mlp_apply(cfg.mlp, p["mlp"], h), 0.0
    h2 = apply_norm(cfg.norm, p["ln2"], x)
    if cfg.family == "moe":
        out, aux = moe_apply(cfg, p["moe"], h2)
        return x + out, aux
    return x + mlp_apply(cfg.mlp, p["mlp"], h2), 0.0


def _shared_block_prefill(cfg, p, x, positions):
    h = apply_norm("rmsnorm", p["ln1"], x)
    attn_out, kv = attn_prefill(cfg, p["attn"], h, positions)
    x = x + attn_out
    h2 = apply_norm("rmsnorm", p["ln2"], x)
    return x + mlp_apply(cfg.mlp, p["mlp"], h2), kv


def _shared_block_decode(cfg, p, x, kc, vc, cache_len):
    """The shared block for one token; writes its K/V into ``kc``/``vc``
    (views of one application's cache) in place."""
    h = apply_norm("rmsnorm", p["ln1"], x)
    x = x + attn_decode(cfg, p["attn"], h, (kc, vc), cache_len)
    h2 = apply_norm("rmsnorm", p["ln2"], x)
    return x + mlp_apply(cfg.mlp, p["mlp"], h2)


def _mamba_layer_prefill(cfg, x, p):
    """A Mamba-2 layer (weights ``p``) over the whole context: returns (x,
    its final conv state, its final SSM state)."""
    out, st = mamba2_prefill(cfg, p["mamba"], apply_norm(cfg.norm, p["ln1"], x))
    return x + out, st.conv, st.ssm


def _mamba_layer_decode(cfg, p, l, x, caches: "Caches"):
    """Mamba-2 layer ``l`` (weights ``p``) for one token, its state updated
    in place."""
    state = Mamba2State(caches.mamba_conv[l], caches.mamba_ssm[l])
    out, st = mamba2_decode(cfg, p["mamba"], apply_norm(cfg.norm, p["ln1"], x), state)
    caches.mamba_conv[l] = st.conv
    caches.mamba_ssm[l] = st.ssm
    return x + out


def _segments(cfg):
    """The Mamba-2 layer ranges of the ssm and hybrid families: yields
    (first layer, end layer, the shared-block application that follows or
    None).  The hybrid has ``n_layers // shared_block_every`` segments,
    each followed by the shared block, then the remainder; the ssm family
    one segment of every layer."""
    if cfg.family == "ssm":
        yield 0, cfg.n_layers, None
        return
    every = cfg.shared_block_every
    n_segs, rem = divmod(cfg.n_layers, every)
    for s in range(n_segs):
        yield s * every, (s + 1) * every, s
    if rem:
        yield n_segs * every, cfg.n_layers, None


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows ``tokens`` of the embedding table.  A DTensor table runs the
    lookup in its local form: each rank looks up the tokens that fall in its
    block of the vocab (zeros elsewhere), so the rows come out as a sum over
    the vocab's shards (``Partial``), and the table's gradient stays a plain
    sum, which the tied head's gradient adds to (DTensor's own rule for the
    lookup gives a masked partial sum that cannot add to another)."""
    if not isinstance(embed, DTensor):
        return embed[tokens]
    mesh = embed.device_mesh
    w_pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in embed.placements]
    embed = embed.redistribute(mesh, w_pl)  # an embed-axis split gathered, as FSDP gathers a layer
    if isinstance(tokens, DTensor):
        t_pl = [Replicate() if isinstance(w, Shard) else p for p, w in zip(tokens.placements, w_pl)]
        tokens = tokens.redistribute(mesh, t_pl)
    else:
        t_pl = [Replicate()] * mesh.ndim
    out_pl = [Partial() if isinstance(w, Shard) else t for w, t in zip(w_pl, t_pl)]
    grad_pl = [w if isinstance(w, Shard) else (Partial() if isinstance(t, Shard) else Replicate())
               for w, t in zip(w_pl, t_pl)]
    first, rows = sharding.shard_offset(embed, 0), embed.to_local().shape[0]
    split = rows != embed.shape[0]

    def local(w, tok):
        if not split:
            return w[tok]
        hit = (tok >= first) & (tok < first + rows)
        return F.embedding(torch.where(hit, tok - first, 0), w) * hit[..., None].to(w.dtype)

    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, t_pl, run_check=False)
    return local_map(local, out_placements=out_pl, in_placements=(w_pl, t_pl), in_grad_placements=(grad_pl, t_pl),
                     device_mesh=mesh)(embed, tokens)


def _embed_tokens(cfg, params, tokens):
    x = embed_lookup(params["embed"], tokens)
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
    return sharding.constrain(x, "batch", "seq", "act_embed")


def _logits(cfg, params, x):
    x = apply_norm(cfg.norm, params["final_norm"], x)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = x @ w
    if logits.ndim == 3:
        logits = sharding.constrain(logits, "batch", "seq", "act_vocab")
    return logits


def _assemble_input(cfg, params, batch):
    """Token (+ the vlm family's image prefix) embedding: returns (x,
    prefix_len or None).

    The reference multiplies f32 patches by ``frontend_proj`` in the model's
    dtype, which JAX promotes to an f32 product, and casts the rows to the
    embedding's dtype; torch refuses mixed dtypes in a matmul, so the
    promotion is written out.
    """
    dev = params["embed"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev).to(torch.long)
    x = _embed_tokens(cfg, params, tokens)
    if cfg.family != "vlm":
        return x, None
    patches = torch.as_tensor(batch["patch_embeds"], device=dev)  # (B, n_img, frontend_dim)
    ct = torch.promote_types(patches.dtype, params["frontend_proj"].dtype)
    px = patches.to(ct) @ params["frontend_proj"].to(ct)
    x = torch.cat([px.to(x.dtype), x], dim=1)
    prefix_len = torch.full((x.shape[0],), patches.shape[1], dtype=torch.int32, device=dev)
    return x, prefix_len


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def prefill(cfg: ArchConfig, params, batch, *, pad_to: Optional[int] = None):
    """Prefill the context; returns (last-token logits (B,1,V), Caches).
    ``batch`` holds ``tokens`` (B, T) and, for the vlm family,
    ``patch_embeds`` (B, n_img, frontend_dim): the caches then hold
    ``n_img + T`` rows, the image rows first.

    ``pad_to``: allocate KV caches with this sequence capacity (>= T) so the
    serving engine can decode further tokens in place; each layer's K/V is
    written straight into it.
    """
    _check_family(cfg)
    x, prefix_len = _assemble_input(cfg, params, batch)
    B, T = x.shape[:2]
    x, caches, _ = _run_layers_prefill(cfg, params, x, prefix_len, pad_to or T)
    length = torch.full((B,), T, dtype=torch.int32, device=x.device)
    return _logits(cfg, params, x[:, -1:]), caches._replace(length=length)


def loss_fn(cfg: ArchConfig, params, batch):
    """Mean next-token cross-entropy of ``batch["labels"]`` (B, T) over the
    text positions (masked by ``batch["mask"]`` if given): returns (ce +
    0.01 * aux, {"ce": ce, "aux": aux}), ``aux`` the MoE layers'
    load-balancing losses summed (0 for the other families).  The vlm
    family's image rows are dropped before the logits.  Under autograd
    the layer bodies run under ``cfg.remat`` (``_remat``)."""
    _check_family(cfg)
    x, prefix_len = _assemble_input(cfg, params, batch)
    x, _, aux = _run_layers_prefill(cfg, params, x, prefix_len)
    n_prefix = x.shape[1] - batch["tokens"].shape[1]
    logits = _logits(cfg, params, x[:, n_prefix:])
    loss = softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}


def _run_layers_prefill(cfg, params, x, prefix_len, cap: Optional[int] = None):
    """The prefill's layers over the whole input ``x`` (B, T, d): returns
    (x, caches without length, aux).  With ``cap`` each layer's K/V is
    written straight into caches of ``cap`` slots (the rest zeros); without,
    the attention families keep no K/V (``caches`` is None).  ``aux`` sums
    the MoE layers' load-balancing losses (f32)."""
    B, T = x.shape[:2]
    dev = x.device
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    if cfg.family not in ATTENTION_FAMILIES:
        x, caches = _prefill_recurrent(cfg, params, x, positions, cap or T)
        return x, caches, aux
    caches = None
    if cap is not None:
        shape = (cfg.n_layers, B, cap, cfg.n_kv_heads, cfg.d_head)
        caches = Caches(kv_k=sharding.zeros(shape, CACHE_AXES, dtype=x.dtype, device=dev),
                        kv_v=sharding.zeros(shape, CACHE_AXES, dtype=x.dtype, device=dev), length=None)
        first = torch.zeros((B,), dtype=torch.int32, device=dev)

    def body(x, p):
        h = apply_norm(cfg.norm, p["ln1"], x)
        attn_out, (k, v) = attn_prefill(cfg, p["attn"], h, positions, prefix_len=prefix_len)
        x, aux_l = _mlp_residual(cfg, p, x + attn_out, h)
        return x, k, v, aux_l

    body = _remat(cfg, body)
    for l, p in enumerate(_unstack(params["layers"], cfg.n_layers)):
        x, k, v, aux_l = body(x, p)
        if caches is not None:
            write_at(caches.kv_k[l], k, first)
            write_at(caches.kv_v[l], v, first)
        aux = aux + aux_l
    if caches is not None:
        caches = caches._replace(kv_k=sharding.constrain(caches.kv_k, *CACHE_AXES),
                                 kv_v=sharding.constrain(caches.kv_v, *CACHE_AXES))
    return x, caches, aux


def _prefill_recurrent(cfg, params, x, positions, cap):
    """The ssm and hybrid families' layers over the context: returns (x,
    caches without length).  Each Mamba-2 layer's final (conv, ssm) state
    and each shared-block application's K/V (written into a cache of
    ``cap`` slots, the rest zeros) are stored as they come."""
    B, T = x.shape[:2]
    d_in, H, P, G, N, conv_ch = _mamba_dims(cfg)
    conv = sharding.zeros((cfg.n_layers, B, cfg.ssm_conv - 1, conv_ch), CONV_AXES, dtype=x.dtype, device=x.device)
    ssm = sharding.zeros((cfg.n_layers, B, H, P, N), SSM_AXES, dtype=torch.float32, device=x.device)
    shared_k = shared_v = None
    if cfg.family == "hybrid":
        shape = (cfg.n_layers // cfg.shared_block_every, B, cap, cfg.n_kv_heads, cfg.d_head)
        shared_k = sharding.zeros(shape, CACHE_AXES, dtype=x.dtype, device=x.device)
        shared_v = sharding.zeros(shape, CACHE_AXES, dtype=x.dtype, device=x.device)
    layers = _unstack(params["layers"], cfg.n_layers)
    body = _remat(cfg, functools.partial(_mamba_layer_prefill, cfg))
    for l0, l1, app in _segments(cfg):
        for l in range(l0, l1):
            x, conv[l], ssm[l] = body(x, layers[l])
        if app is not None:  # the shared block stays outside remat, as in the reference
            x, (k, v) = _shared_block_prefill(cfg, params["shared_block"], x, positions)
            shared_k[app, :, :T] = k
            shared_v[app, :, :T] = v
    return x, Caches(kv_k=None, kv_v=None, length=None, mamba_conv=conv, mamba_ssm=ssm,
                     shared_k=shared_k, shared_v=shared_v)


def _extend_mha(q, kc, vc, cache_len, n_new):
    """Attention of a new chunk's queries vs (cache + itself already written).

    q: (B, Tc, Hq, D); kc/vc: (B, S_cap, Hkv, D) with the chunk already
    written at [cache_len, cache_len + Tc).  Causal within the chunk,
    full attention to the cache prefix.  Plain PyTorch, as the reference
    computes it outside any kernel; dtypes promote as in JAX.
    """
    B, Tc, Hq, D = q.shape
    S, Hkv = kc.shape[1], kc.shape[2]
    rep = Hq // Hkv
    scale = 1.0 / np.sqrt(D)
    ct = torch.promote_types(q.dtype, kc.dtype)
    qg = q.reshape(B, Tc, Hkv, rep, D).to(ct)
    s = torch.einsum("bqkrd,btkd->bkrqt", qg, kc.to(ct)).to(torch.float32) * scale
    k_pos = torch.arange(S, device=q.device)[None, None, :]
    q_limit = cache_len.to(torch.int64)[:, None, None] + torch.arange(Tc, device=q.device)[None, :, None] + 1
    mask = k_pos < q_limit  # (B, Tc, S)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkrqt,btkd->bqkrd", w.to(vc.dtype), vc)
    return o.reshape(B, Tc, Hq, D)


def masked_window_update(cache, new, start: int, width: int, window: Optional[int] = None) -> None:
    """Commit ``new[:width]`` into ``cache[start : start + width]``, in place.

    ``cache`` is (S, ...), token axis leading.  Mirrors the reference's
    shifted read-merge-write window exactly, including where it clamps: the
    window of ``window`` tokens (default ``len(new)``) starts at
    ``clip(start, 0, S - window)``, token ``j`` of ``new`` lands at window
    position ``j + shift`` and only positions inside both the window and
    ``[shift, shift + width)`` are written — so a ``width == 0`` row is
    untouched and nothing outside ``[0, S)`` is ever addressed.
    """
    T = new.shape[0] if window is None else int(window)
    S = cache.shape[0]
    start_c = min(max(int(start), 0), S - T)
    shift = int(start) - start_c
    lo, hi = max(shift, 0), min(shift + int(width), T)
    if hi > lo:
        cache[start_c + lo:start_c + hi] = new[lo - shift:hi - shift].to(cache.dtype)


def prefill_extend(cfg: ArchConfig, params, tokens, caches: Caches, widths=None, starts=None):
    """Compute KV for a text chunk *given* earlier chunks' KV (paper fn. 6:
    the LLM recomputes a text-format chunk based on the previous chunks'
    received-and-decoded KV).

    tokens: (B, Tc).  Writes the chunk's K/V at each row's ``length`` (the
    start clamped as ``dynamic_update_slice`` clamps it) into ``caches`` in
    place; returns (last logits, caches with length advanced by Tc).

    ``widths`` (optional, (B,) ints in [0, Tc]) masks the per-row cache
    write: row ``b`` commits only its first ``widths[b]`` tokens, through
    :func:`masked_window_update`, and its length advances by ``widths[b]``.
    This is how the concurrent scheduler coalesces different requests' TEXT
    recomputes into one padded batched call — a row with width 0 keeps its
    K/V and length bit for bit (its logits are garbage and must be
    ignored).  The window starts are read from ``length`` once, on the host,
    unless the caller passes them as ``starts`` (``caches.length`` as host
    ints; a row-sharded engine reads every shard's before it launches any).
    ``widths=None`` keeps the full-width write path.

    The ssm and hybrid families have no chunked prefill (the reference's
    message).
    """
    _check_family(cfg)
    if cfg.family not in ATTENTION_FAMILIES:
        raise ValueError(f"prefill_extend not supported for family {cfg.family}")
    dev = caches.kv_k.device
    tokens = torch.as_tensor(tokens, device=dev).to(torch.long)
    B, Tc = tokens.shape
    cache_len = caches.length
    x = _embed_tokens(cfg, params, tokens)
    positions = cache_len[:, None] + torch.arange(Tc, dtype=torch.int32, device=dev)[None]
    if widths is None:
        def write(cache, new):
            write_at(cache, new, cache_len)
    else:
        widths = [int(w) for w in torch.as_tensor(widths).tolist()]
        starts = cache_len.tolist() if starts is None else [int(x) for x in starts]
        # staged from host memory without waiting for the device
        adv = torch.tensor(widths, dtype=cache_len.dtype).to(dev, non_blocking=True)

        def write(cache, new):
            for b, (s, w) in enumerate(zip(starts, widths)):
                masked_window_update(cache[b], new[b], s, w)
    for l, p in enumerate(_unstack(params["layers"], cfg.n_layers)):
        kc, vc = caches.kv_k[l], caches.kv_v[l]
        hn = apply_norm(cfg.norm, p["ln1"], x)
        q, k, v, k_pre = _project_qkv(cfg, p["attn"], hn, positions)
        write(kc, k_pre if cfg.prerope_kv_cache else k)
        write(vc, v)
        if cfg.prerope_kv_cache:
            S = kc.shape[1]
            pos_grid = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)
            kc_read = rope(kc, pos_grid, cfg.rope_theta)
        else:
            kc_read = kc
        o = _extend_mha(q, kc_read, vc, cache_len, Tc)
        wo = p["attn"]["wo"]
        attn_out = o.reshape(B, Tc, cfg.n_heads * cfg.d_head).to(wo.dtype) @ wo
        x = _mlp_residual(cfg, p, x + attn_out, hn)[0]
    logits = _logits(cfg, params, x[:, -1:])
    if widths is None:
        return logits, caches._replace(length=cache_len + Tc)
    return logits, caches._replace(length=cache_len + adv)


def decode_step(cfg: ArchConfig, params, tokens, caches: Caches):
    """One-token step.  tokens (B, 1) -> (logits (B, 1, V), caches), the
    caches' K/V (shared K/V, Mamba-2 states) updated in place and
    ``length`` advanced by one."""
    _check_family(cfg)
    tokens = torch.as_tensor(tokens, device=caches.length.device).to(torch.long)
    x = _embed_tokens(cfg, params, tokens)
    cache_len = caches.length
    layers = _unstack(params["layers"], cfg.n_layers)
    if cfg.family in ATTENTION_FAMILIES:
        for l, p in enumerate(layers):
            with tracing.span("step.attn"):
                h = apply_norm(cfg.norm, p["ln1"], x)
                attn_out = attn_decode(cfg, p["attn"], h, (caches.kv_k[l], caches.kv_v[l]), cache_len)
            with tracing.span("step.ffn"):
                x = _mlp_residual(cfg, p, x + attn_out, h)[0]
    else:
        for l0, l1, app in _segments(cfg):
            for l in range(l0, l1):
                x = _mamba_layer_decode(cfg, layers[l], l, x, caches)
            if app is not None:  # caches.shared_k[app] is a view: K3's write lands in the stack
                x = _shared_block_decode(cfg, params["shared_block"], x, caches.shared_k[app],
                                         caches.shared_v[app], cache_len)
    logits = _logits(cfg, params, x)
    return logits, caches._replace(length=cache_len + 1)
