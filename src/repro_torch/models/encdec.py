"""Encoder-decoder backbone (seamless-m4t-large-v2 text/unit model).

Port of ``src/repro/models/encdec.py``.  The speech frontend is a stub: the
encoder consumes precomputed frame embeddings (B, S_src, frontend_dim).
Encoder layers are pre-LN self-attention (bidirectional: K4 with
``causal=False`` on the card) + FFN; decoder layers are causal
self-attention (K4) + cross-attention to the encoder memory + FFN.

Serving: ``prefill`` runs the encoder once, projects each decoder layer's
cross K/V and prefills the decoder prompt; ``decode_step`` appends one
token: its self-attention goes through K3 and writes the self K/V in place,
its cross-attention reads the static cross K/V through K3's plain version
(the reference's plain ``_decode_mha_plain``; they differ only for a row
with no memory, which ``prefill`` never makes).  As in the reference, no
codec, engine or launcher path serves this family (the reference's
``Engine`` builds the ``lm`` families only), and the layers run as a
Python loop over the stacked weights.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.models.attention import (
    attn_decode,
    attn_plan,
    attn_prefill,
    cross_attn_prefill,
    memory_kv,
)
from repro_torch.models.common import (
    DTYPES,
    Leaf,
    apply_norm,
    init_from_plan,
    mlp_apply,
    mlp_plan,
    norm_plan,
    softmax_cross_entropy,
)
from repro_torch.models.lm import _layer, _stack_plan

__all__ = ["EncDecCaches", "param_plan", "init_params", "encode", "loss_fn", "prefill", "decode_step"]


class EncDecCaches(NamedTuple):
    self_k: torch.Tensor  # (Ld, B, S_dec, Hkv, Dh)
    self_v: torch.Tensor
    cross_k: torch.Tensor  # (Ld, B, S_src, Hkv, Dh)
    cross_v: torch.Tensor
    src_len: torch.Tensor  # (B,) int32
    length: torch.Tensor  # (B,) int32, decoder tokens so far

    def clone(self) -> "EncDecCaches":
        return EncDecCaches(*(t.clone() for t in self))


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family != "encdec":
        raise ValueError(f"models.encdec builds the encdec family only, not {cfg.family}")


def _enc_layer_plan(cfg: ArchConfig) -> Dict[str, Any]:
    return {
        "ln1": norm_plan(cfg.norm, cfg.d_model),
        "attn": attn_plan(cfg),
        "ln2": norm_plan(cfg.norm, cfg.d_model),
        "mlp": mlp_plan(cfg.mlp, cfg.d_model, cfg.d_ff, cfg.mlp_bias),
    }


def _dec_layer_plan(cfg: ArchConfig) -> Dict[str, Any]:
    return {
        "ln1": norm_plan(cfg.norm, cfg.d_model),
        "self_attn": attn_plan(cfg),
        "ln_x": norm_plan(cfg.norm, cfg.d_model),
        "cross_attn": attn_plan(cfg),
        "ln2": norm_plan(cfg.norm, cfg.d_model),
        "mlp": mlp_plan(cfg.mlp, cfg.d_model, cfg.d_ff, cfg.mlp_bias),
    }


def param_plan(cfg: ArchConfig) -> Dict[str, Any]:
    _check_family(cfg)
    d, V = cfg.d_model, cfg.padded_vocab_size
    return {
        "embed": Leaf((V, d), ("vocab", "embed"), scale=0.02),
        "frontend_proj": Leaf((cfg.frontend_dim, d), ("frontend", "embed")),
        "enc_layers": _stack_plan(_enc_layer_plan(cfg), cfg.enc_layers),
        "enc_norm": norm_plan(cfg.norm, d),
        "dec_layers": _stack_plan(_dec_layer_plan(cfg), cfg.dec_layers),
        "final_norm": norm_plan(cfg.norm, d),
        "head": Leaf((d, V), ("embed", "vocab")),
    }


def init_params(cfg: ArchConfig, generator: torch.Generator, device) -> Dict[str, Any]:
    """Random weights in ``cfg.dtype`` on ``device``, drawn from ``generator``
    (which must live on the same device) with the reference's std rule."""
    return init_from_plan(param_plan(cfg), generator, device, DTYPES[cfg.dtype])


def _positions(B: int, T: int, device) -> torch.Tensor:
    return torch.arange(T, dtype=torch.int32, device=device)[None].expand(B, T)


def encode(cfg: ArchConfig, params, src_embeds) -> torch.Tensor:
    """src_embeds (B, S, frontend_dim) -> encoder memory (B, S, d).  The
    embeddings are cast to the weights' dtype before ``frontend_proj`` (the
    reference casts, it does not promote), every query sees every frame."""
    _check_family(cfg)
    proj = params["frontend_proj"]
    x = (torch.as_tensor(src_embeds, device=proj.device).to(proj.dtype) @ proj).to(proj.dtype)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    for l in range(cfg.enc_layers):
        p = _layer(params, l, "enc_layers")
        attn_out, _ = attn_prefill(cfg, p["attn"], apply_norm(cfg.norm, p["ln1"], x), positions, causal=False)
        x = x + attn_out
        x = x + mlp_apply(cfg.mlp, p["mlp"], apply_norm(cfg.norm, p["ln2"], x))
    return apply_norm(cfg.norm, params["enc_norm"], x)


def _decoder_prefill(cfg, params, memory, tokens, caches: Optional[EncDecCaches] = None):
    """The decoder over the whole prompt ``tokens`` (B, T) against
    ``memory``; returns its last hidden states (B, T, d).  With ``caches``,
    each layer's self K/V is written into ``self_k``/``self_v[:, :, :T]``
    and its cross K/V into ``cross_k``/``cross_v``."""
    x = params["embed"][tokens]
    B, T = tokens.shape
    positions = _positions(B, T, x.device)
    for l in range(cfg.dec_layers):
        p = _layer(params, l, "dec_layers")
        attn_out, (k, v) = attn_prefill(cfg, p["self_attn"], apply_norm(cfg.norm, p["ln1"], x), positions)
        x = x + attn_out
        mem_kv = memory_kv(cfg, p["cross_attn"], memory)
        x = x + cross_attn_prefill(cfg, p["cross_attn"], apply_norm(cfg.norm, p["ln_x"], x), mem_kv)
        x = x + mlp_apply(cfg.mlp, p["mlp"], apply_norm(cfg.norm, p["ln2"], x))
        if caches is not None:
            caches.self_k[l, :, :T] = k
            caches.self_v[l, :, :T] = v
            caches.cross_k[l], caches.cross_v[l] = mem_kv
    return x


def _tokens(params, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params["embed"].device).to(torch.long)


def loss_fn(cfg: ArchConfig, params, batch):
    """Mean next-token cross-entropy of ``batch["labels"]`` (B, T) over the
    decoder's positions (masked by ``batch["mask"]`` if given), forward
    only: returns (ce, {"ce": ce, "aux": 0})."""
    memory = encode(cfg, params, batch["src_embeds"])
    x = _decoder_prefill(cfg, params, memory, _tokens(params, batch["tokens"]))
    logits = apply_norm(cfg.norm, params["final_norm"], x) @ params["head"]
    loss = softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss, {"ce": loss, "aux": torch.zeros((), dtype=torch.float32, device=loss.device)}


def prefill(cfg: ArchConfig, params, batch, *, pad_to: Optional[int] = None):
    """Encode ``batch["src_embeds"]`` and prefill the decoder prompt
    ``batch["tokens"]`` (B, T); returns (last-token logits (B, 1, V),
    EncDecCaches).  ``pad_to`` (>= T) sizes the self K/V for further
    decoding (the rest zeros); the cross K/V hold the S_src memory rows."""
    memory = encode(cfg, params, batch["src_embeds"])
    tokens = _tokens(params, batch["tokens"])
    B, T = tokens.shape
    S_src, dev, dt = memory.shape[1], memory.device, memory.dtype
    self_shape = (cfg.dec_layers, B, pad_to or T, cfg.n_kv_heads, cfg.d_head)
    cross_shape = (cfg.dec_layers, B, S_src, cfg.n_kv_heads, cfg.d_head)
    caches = EncDecCaches(
        self_k=torch.zeros(self_shape, dtype=dt, device=dev),
        self_v=torch.zeros(self_shape, dtype=dt, device=dev),
        cross_k=torch.empty(cross_shape, dtype=dt, device=dev),
        cross_v=torch.empty(cross_shape, dtype=dt, device=dev),
        src_len=torch.full((B,), S_src, dtype=torch.int32, device=dev),
        length=torch.full((B,), T, dtype=torch.int32, device=dev),
    )
    x = _decoder_prefill(cfg, params, memory, tokens, caches)
    logits = apply_norm(cfg.norm, params["final_norm"], x[:, -1:]) @ params["head"]
    return logits, caches


def decode_step(cfg: ArchConfig, params, tokens, caches: EncDecCaches):
    """One decoder token.  tokens (B, 1) -> (logits (B, 1, V), caches), the
    self K/V written in place at ``length`` (K3 reads them) and ``length``
    advanced by one; the cross-attention reads the cross K/V up to
    ``src_len``."""
    _check_family(cfg)
    x = params["embed"][torch.as_tensor(tokens, device=caches.length.device).to(torch.long)]
    B = x.shape[0]
    cache_len = caches.length
    for l in range(cfg.dec_layers):
        p = _layer(params, l, "dec_layers")
        x = x + attn_decode(cfg, p["self_attn"], apply_norm(cfg.norm, p["ln1"], x),
                            (caches.self_k[l], caches.self_v[l]), cache_len)
        cp = p["cross_attn"]
        q = apply_norm(cfg.norm, p["ln_x"], x)[:, 0] @ cp["wq"]
        if cfg.qkv_bias:
            q = q + cp["bq"]
        o = decode_attention_plain(q.reshape(B, cfg.n_heads, cfg.d_head), caches.cross_k[l], caches.cross_v[l],
                                   caches.src_len)
        x = x + o.reshape(B, 1, cfg.n_heads * cfg.d_head) @ cp["wo"]
        x = x + mlp_apply(cfg.mlp, p["mlp"], apply_norm(cfg.norm, p["ln2"], x))
    logits = apply_norm(cfg.norm, params["final_norm"], x) @ params["head"]
    return logits, caches._replace(length=cache_len + 1)
