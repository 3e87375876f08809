"""The plain reference of what a cell serves, in float32 PyTorch.

It imports neither JAX, the JAX package nor anything of the program, and
takes nothing the program made: only the configuration's numbers (the
``arch`` block of the configuration file), the weights the benchmark drew
and the tokens it sent.  It follows the program's stated model, which
departs from the published ones where each configuration file says so:

* the decoder: token embedding, per layer RMSNorm (eps 1e-6), Q/K/V
  projections (with the configuration's bias), rotary embedding on halves
  (``theta^(-i / (D/2))``), causal grouped-query attention over the cache,
  output projection, RMSNorm, a SwiGLU FFN or the MoE layer, and the final
  RMSNorm and projection onto the (padded) vocabulary, the embedding when
  tied;
* the MoE layer: router logits, softmax, the top k by a stable descending
  sort (the lower expert on ties), weights renormalized to sum to one;
  GShard capacity per call of N tokens, ``ceil128(max(1, round(N k / E *
  capacity_factor)))``, a slot kept while fewer than the capacity of the
  same expert's slots come before it in token-major order; the shared
  experts as one SwiGLU of their summed width;
* CacheGen's lossy transform of a context's KV at a level (the codec's
  stated quantization, not its entropy coding, which is lossless): chunks of
  ``chunk_tokens``, groups of ``group_size`` tokens inside a chunk, the
  first the anchor.  Level 0 quantizes every value to 8 bits with one
  float16 scale a (layer, K/V, group); the lossy levels quantize each
  anchor to 8 bits with one float16 scale over its channels and each other
  token's difference from its (unquantized) anchor in bins of
  ``layer_group_bins[group of the layer] * level_mults[level - 1] *
  delta_scale[layer, K/V]``, clipped to ``delta_qmax`` bins, and rebuild it
  on the quantized anchor.  ``delta_scale`` is the root mean square of the
  deltas of the calibration KV, worked out here again.

``precision="fp8"`` is the control: every product's operands rounded to
float8 (e4m3, one scale a tensor) before it, the rest as above.
"""
from __future__ import annotations

import math
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["Reference", "CodecSpec", "calibrate_delta_scale", "lossy_kv"]

NORM_EPS = 1e-6
_FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale over the tensor."""
    amax = x.abs().amax().clamp_min(1e-12)
    s = _FP8_MAX / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


class CodecSpec:
    """The codec's stated settings (the program's ``CodecConfig`` defaults
    with the serving launcher's precision; precision does not change
    values)."""

    def __init__(self, group_size=10, layer_group_bins=(0.5, 1.0, 1.5), level_mults=(0.5, 1.0, 2.0, 4.0),
                 delta_qmax=127):
        self.group_size = group_size
        self.layer_group_bins = tuple(layer_group_bins)
        self.level_mults = tuple(level_mults)
        self.delta_qmax = delta_qmax

    def bins(self, n_layers: int, level: int, delta_scale: np.ndarray) -> np.ndarray:
        """(L, 2) float32 bin widths of a lossy level: three equal groups of
        layers by ``linspace(0, L, 4)``."""
        edges = np.linspace(0, n_layers, 4)
        gids = np.searchsorted(edges[1:-1], np.arange(n_layers), side="right")
        base = np.asarray(self.layer_group_bins, dtype=np.float32)[gids]
        b = np.broadcast_to(base[:, None], (n_layers, 2)).astype(np.float32)
        b = b * np.float32(self.level_mults[level - 1])
        return b * np.asarray(delta_scale, dtype=np.float32)


def _f16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float16).to(torch.float32)


def calibrate_delta_scale(kv: torch.Tensor, group_size: int) -> np.ndarray:
    """(L, 2) root mean square of the deltas of the calibration KV (L, 2, T,
    C), its tokens in groups of ``group_size``."""
    L, _, T, C = kv.shape
    pos = torch.arange(T, device=kv.device)
    others = pos[pos % group_size != 0]
    deltas = kv[:, :, others] - kv[:, :, others - others % group_size]
    ms = (deltas * deltas).mean(dim=(2, 3)).cpu().numpy().astype(np.float64)
    return np.maximum(np.sqrt(ms).astype(np.float32), 1e-6)


def lossy_kv(kv: torch.Tensor, level: int, spec: CodecSpec, delta_scale: np.ndarray, chunk_tokens: int,
             layer_bins: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """What a load of ``kv`` (L', 2, T, C) f32 at ``level`` should land:
    chunks of ``chunk_tokens``, each in groups of ``spec.group_size``.
    ``layer_bins`` (L', 2) picks the rows of the bins when ``kv`` holds a
    subset of the layers (default: the bins of all ``L'`` layers).

    Returns the rebuilt KV and, broadcastable to it (L', 2, T, 1), how far
    one different symbol moves each value: level 0 its group's scale, an
    anchor its scale, any other token its bin and its anchor's scale (one
    symbol of each)."""
    L, two, T, C = kv.shape
    g = spec.group_size
    # token -> its group's anchor, groups restarting at every chunk
    t = torch.arange(T, device=kv.device)
    start = t - (t % chunk_tokens)
    anchor_of = start + ((t - start) // g) * g
    is_anchor = anchor_of == t
    if level == 0:
        # one scale a (layer, K/V, group): absmax over the group's tokens
        # and channels; the group id of a token is its anchor's position
        absmax = kv.abs().amax(dim=-1)  # (L, 2, T)
        gmax = torch.zeros_like(absmax).scatter_reduce_(-1, anchor_of.expand(L, two, T), absmax, "amax")
        scale = _f16(torch.clamp_min(gmax / 127.0, 1e-7)).index_select(-1, anchor_of)
        q = torch.clamp(torch.round(kv / scale[..., None]), -127, 127)
        return q * scale[..., None], scale[..., None]
    if layer_bins is None:
        layer_bins = torch.as_tensor(spec.bins(L, level, delta_scale), device=kv.device)
    anchors = kv.index_select(2, anchor_of)  # each token's anchor, (L, 2, T, C)
    a_absmax = anchors.abs().amax(dim=-1)
    a_scale = _f16(torch.clamp_min(a_absmax / 127.0, 1e-7))
    a_hat = torch.clamp(torch.round(anchors / a_scale[..., None]), -127, 127) * a_scale[..., None]
    qmax = spec.delta_qmax
    b = layer_bins.to(torch.float32)[:, :, None, None]
    sym = torch.clamp(torch.round((kv - anchors) / b), -qmax, qmax)
    rebuilt = sym * b + a_hat
    step = torch.where(is_anchor[None, None, :], a_scale, a_scale + b[..., 0])
    return torch.where(is_anchor[None, None, :, None], a_hat, rebuilt), step[..., None]


class Reference:
    """The configuration's decoder in float32 over the benchmark's weights.

    ``arch`` is the configuration file's ``arch`` block; ``params`` the
    weight tree the benchmark drew (any dtype, read layer by layer and
    widened to float32)."""

    def __init__(self, arch: Mapping, params: Mapping, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"reference precision {precision!r}")
        self.a = dict(arch)
        self.p = params
        self.precision = precision
        self.L = int(arch["n_layers"])
        self.H, self.Hkv, self.D = int(arch["n_heads"]), int(arch["n_kv_heads"]), int(arch["d_head"])
        self.moe = arch.get("family") == "moe"
        self.dev = params["embed"].device

    # -- pieces ----------------------------------------------------------

    def _w(self, *path, layer: Optional[int] = None) -> torch.Tensor:
        node = self.p
        for key in path:
            node = node[key]
        return (node if layer is None else node[layer]).to(torch.float32)

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            x, w = _fp8(x), _fp8(w)
        return x @ w

    def _bmm(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            x, y = _fp8(x), _fp8(y)
        return torch.matmul(x, y)

    @staticmethod
    def _norm(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + NORM_EPS) * gamma

    def _rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (..., T, H, D), pos (..., T)."""
        half = self.D // 2
        freqs = float(self.a.get("rope_theta", 10000.0)) ** (
            -torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
        ang = pos[..., None].to(torch.float32) * freqs
        cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def _qkv(self, l: int, h: torch.Tensor, pos: torch.Tensor):
        """h (B, T, d) -> q (B, T, H, D) and k, v (B, T, Hkv, D), q and k rotated."""
        B, T, _ = h.shape
        q = self._mm(h, self._w("layers", "attn", "wq", layer=l))
        k = self._mm(h, self._w("layers", "attn", "wk", layer=l))
        v = self._mm(h, self._w("layers", "attn", "wv", layer=l))
        if self.a.get("qkv_bias"):
            q = q + self._w("layers", "attn", "bq", layer=l)
            k = k + self._w("layers", "attn", "bk", layer=l)
            v = v + self._w("layers", "attn", "bv", layer=l)
        q = self._rope(q.reshape(B, T, self.H, self.D), pos)
        k = self._rope(k.reshape(B, T, self.Hkv, self.D), pos)
        return q, k, v.reshape(B, T, self.Hkv, self.D)

    def _attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
        """q (B, Tq, H, D) over k, v (B, S, Hkv, D); ``allowed`` (B, Tq, S)."""
        B, Tq = q.shape[:2]
        rep = self.H // self.Hkv
        qg = q.reshape(B, Tq, self.Hkv, rep, self.D).permute(0, 2, 3, 1, 4)  # (B, Hkv, rep, Tq, D)
        kt = k.permute(0, 2, 3, 1)[:, :, None]  # (B, Hkv, 1, D, S)
        s = self._bmm(qg, kt) / math.sqrt(self.D)
        s = s.masked_fill(~allowed[:, None, None], float("-inf"))
        w = torch.softmax(s, dim=-1)
        o = self._bmm(w, v.permute(0, 2, 1, 3)[:, :, None])  # (B, Hkv, rep, Tq, D)
        return o.permute(0, 3, 1, 2, 4).reshape(B, Tq, self.H * self.D)

    def _swiglu(self, x: torch.Tensor, wg, wu, wd) -> torch.Tensor:
        return self._mm(F.silu(self._mm(x, wg)) * self._mm(x, wu), wd)

    def _ffn(self, l: int, x: torch.Tensor, capacity_calls: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """x (N, d) -> (N, d).  For the MoE layer ``capacity_calls`` splits
        the N tokens into the program's calls, (start, count) each, whose
        capacities are reckoned apart."""
        if not self.moe:
            return self._swiglu(x, self._w("layers", "mlp", "w_gate", layer=l), self._w("layers", "mlp", "w_up", layer=l),
                                self._w("layers", "mlp", "w_down", layer=l))
        a = self.a
        E, k = int(a["n_experts"]), int(a["moe_topk"])
        gates = torch.softmax(self._mm(x, self._w("layers", "moe", "router", layer=l)), dim=-1)
        vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
        topv, topi = vals[:, :k], idx[:, :k]
        topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
        keep = torch.ones_like(topi, dtype=torch.bool)
        for start, count in capacity_calls:
            cap = max(1, round(count * k / E * float(a.get("capacity_factor", 1.25))))
            cap = -(-cap // 128) * 128
            sel = topi[start:start + count].reshape(-1)  # token-major slots
            onehot = F.one_hot(sel, E)
            before = (onehot.cumsum(0) - onehot)[torch.arange(sel.shape[0], device=sel.device), sel]
            keep[start:start + count] = (before < cap).reshape(count, k)
        out = torch.zeros_like(x)
        wg = self.p["layers"]["moe"]["w_gate"][l]
        wu = self.p["layers"]["moe"]["w_up"][l]
        wd = self.p["layers"]["moe"]["w_down"][l]
        for e in range(E):
            tok, j = torch.nonzero((topi == e) & keep, as_tuple=True)
            if tok.numel() == 0:
                continue
            y = self._swiglu(x[tok], wg[e].to(torch.float32), wu[e].to(torch.float32), wd[e].to(torch.float32))
            out.index_add_(0, tok, y * topv[tok, j][:, None])
        if a.get("n_shared_experts"):
            out = out + self._swiglu(x, self._w("layers", "moe", "shared", "w_gate", layer=l),
                                     self._w("layers", "moe", "shared", "w_up", layer=l),
                                     self._w("layers", "moe", "shared", "w_down", layer=l))
        return out

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.p["embed"][tokens.to(self.dev).long()].to(torch.float32)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = self._norm(x, self._w("final_norm", "gamma"))
        w = self._w("embed").T if self.a.get("tie_embeddings") else self._w("head")
        return self._mm(x, w)

    # -- entry points ----------------------------------------------------

    def context_kv(self, tokens: np.ndarray, q_block: int = 1024) -> torch.Tensor:
        """A context's exact KV (L, 2, T, C) float32, K rotated: one
        sequence through every layer, as one call."""
        T = len(tokens)
        x = self._embed(torch.as_tensor(tokens))[None]
        pos = torch.arange(T, device=self.dev)[None]
        kv = torch.empty((self.L, 2, T, self.Hkv * self.D), dtype=torch.float32, device=self.dev)
        key_pos = torch.arange(T, device=self.dev)
        for l in range(self.L):
            h = self._norm(x, self._w("layers", "ln1", "gamma", layer=l))
            q, k, v = self._qkv(l, h, pos)
            kv[l, 0], kv[l, 1] = k[0].reshape(T, -1), v[0].reshape(T, -1)
            o = torch.empty((1, T, self.H * self.D), dtype=torch.float32, device=self.dev)
            for s in range(0, T, q_block):
                e = min(T, s + q_block)
                allowed = (key_pos[None, :] <= torch.arange(s, e, device=self.dev)[:, None])[None]
                o[:, s:e] = self._attend(q[:, s:e], k, v, allowed)
            x = x + self._mm(o, self._w("layers", "attn", "wo", layer=l))
            h2 = self._norm(x, self._w("layers", "ln2", "gamma", layer=l))
            x = x + self._ffn(l, h2[0], [(0, T)])[None]
        return kv

    def answer_logits(self, ctx_kv: List, n_question: int, tokens: np.ndarray) -> torch.Tensor:
        """Logits of a wave's answers, teacher-forced.

        ``ctx_kv[b]`` is a callable ``layer -> (2, T_b, C)`` giving row
        ``b``'s loaded context KV of that layer; ``tokens`` (B, n) the
        question's ``n_question`` tokens followed by the answer's tokens but
        its last.  The question goes through the MoE as one call of all
        rows' question tokens, each later position as one call of every
        row's token (the program's stacked step), so capacities are the
        program's.  Returns (B, n - n_question + 1, V) float32: the logits
        of the question's last token and of each answer token fed."""
        tokens = torch.as_tensor(tokens, device=self.dev).long()
        B, n = tokens.shape
        lens = [int(ctx_kv[b](0).shape[1]) for b in range(B)]
        T_max = max(lens)
        S = T_max + n
        x = self._embed(tokens)
        lens_t = torch.as_tensor(lens, device=self.dev)
        pos = lens_t[:, None] + torch.arange(n, device=self.dev)[None]
        # row b's keys: its context at [0, T_b), then the new tokens at
        # [T_max, T_max + n); each new token sees its context and the new
        # tokens up to itself
        key = torch.arange(S, device=self.dev)
        ctx_ok = key[None, :] < lens_t[:, None]
        new_ok = (key[None, :] >= T_max) & (key[None, :] - T_max <= torch.arange(n, device=self.dev)[:, None])
        allowed = ctx_ok[:, None, :] | new_ok[None]
        calls = [(0, B * n_question)] + [(B * n_question + B * i, B) for i in range(n - n_question)]
        for l in range(self.L):
            h = self._norm(x, self._w("layers", "ln1", "gamma", layer=l))
            q, k, v = self._qkv(l, h, pos)
            K = torch.zeros((B, S, self.Hkv, self.D), dtype=torch.float32, device=self.dev)
            V = torch.zeros_like(K)
            for b in range(B):
                kvb = ctx_kv[b](l)
                K[b, :lens[b]] = kvb[0].reshape(lens[b], self.Hkv, self.D)
                V[b, :lens[b]] = kvb[1].reshape(lens[b], self.Hkv, self.D)
            K[:, T_max:], V[:, T_max:] = k, v
            x = x + self._mm(self._attend(q, K, V, allowed), self._w("layers", "attn", "wo", layer=l))
            del K, V
            h2 = self._norm(x, self._w("layers", "ln2", "gamma", layer=l))
            # the MoE's calls in the program's token order: the question
            # rows first (row-major), then each later position's rows
            d = h2.shape[-1]
            flat = torch.cat([h2[:, :n_question].reshape(B * n_question, d),
                              h2[:, n_question:].transpose(0, 1).reshape(B * (n - n_question), d)])
            y = self._ffn(l, flat, calls)
            y_q = y[:B * n_question].reshape(B, n_question, d)
            y_a = y[B * n_question:].reshape(n - n_question, B, d).transpose(0, 1)
            x = x + torch.cat([y_q, y_a], dim=1)
        return self._logits(x[:, n_question - 1:])
