"""Mamba-2 (SSD, state-space duality) block: chunked prefill scan and the
O(1)-state decode step.  [arXiv:2405.21060]

Port of ``src/repro/models/mamba2.py``.  The chunked algorithm computes,
per chunk of Q tokens:
  intra-chunk:  Y_intra[i] = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
  chunk state:  S_c        = sum_j exp(cum_end - cum_j) dt_j B_j x_j^T
  inter-chunk:  h_c = exp(cum_end) h_{c-1} + S_c   (a loop over chunks)
                Y_inter[i] = exp(cum_i) C_i . h_{c-1}
All decays are <= 1 (A < 0, dt > 0), so every exp() is stable in f32.

The SSD scan is plain PyTorch, as the reference leaves it to XLA (it is
not a Pallas kernel there).  :func:`ssd_sequential` is the exact token-by-
token recurrence (the reference's ``kernels/ref.py:ssd_ref``), the oracle
of both the chunked scan and the decode step.  Every f32 cast of the
reference is kept: the scan computes in f32 and returns x's dtype, the
causal conv runs in f32 and casts back, and decode's conv is an f32
contraction.  ``jax.nn.softplus`` is ``logaddexp(x, 0)``; so is
:func:`softplus` here (``torch.nn.functional.softplus`` switches to the
identity above its threshold).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import Leaf, rmsnorm

__all__ = [
    "Mamba2State",
    "mamba2_plan",
    "mamba2_prefill",
    "mamba2_decode",
    "ssd_chunked",
    "ssd_inputs",
    "ssd_sequential",
    "softplus",
]


class Mamba2State(NamedTuple):
    conv: torch.Tensor  # (B, conv_w - 1, d_conv_channels), the model's dtype
    ssm: torch.Tensor  # (B, H, P, N) f32


def _dims(cfg: ArchConfig):
    d_in = cfg.d_inner
    H = cfg.ssm_heads
    P = cfg.ssm_headdim
    G = cfg.ssm_groups
    N = cfg.ssm_state
    assert H * P == d_in, f"ssm_heads*ssm_headdim {H}x{P} != d_inner {d_in}"
    conv_ch = d_in + 2 * G * N
    return d_in, H, P, G, N, conv_ch


def mamba2_plan(cfg: ArchConfig) -> Dict[str, Leaf]:
    d = cfg.d_model
    d_in, H, P, G, N, conv_ch = _dims(cfg)
    return {
        "in_proj": Leaf((d, 2 * d_in + 2 * G * N + H), ("embed", "ssm_inner")),
        "conv_w": Leaf((cfg.ssm_conv, conv_ch), ("conv", "ssm_inner"), scale=0.5),
        "conv_b": Leaf((conv_ch,), ("ssm_inner",), "zeros"),
        "a_log": Leaf((H,), ("ssm_heads",), "zeros"),  # A = -exp(a_log)
        "dt_bias": Leaf((H,), ("ssm_heads",), "zeros"),
        "d_skip": Leaf((H,), ("ssm_heads",), "ones"),
        "norm_gamma": Leaf((d_in,), ("ssm_inner",), "ones"),
        "out_proj": Leaf((d_in, d), ("ssm_inner", "embed")),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_chunked(
    x: torch.Tensor,  # (B, T, H, P)
    dt: torch.Tensor,  # (B, T, H) positive
    A: torch.Tensor,  # (H,) negative
    Bm: torch.Tensor,  # (B, T, G, N)
    Cm: torch.Tensor,  # (B, T, G, N)
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan: returns (y (B, T, H, P) in x's dtype, the final
    state (B, H, P, N) f32)."""
    Bb, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = min(chunk, T)
    T_orig = T
    if T % Q:
        # pad with dt = 0 tokens: decay = exp(0) = 1 and dt * x = 0, so the
        # padding leaves the state exactly as it was; outputs are cut below
        pad = Q * (-(-T // Q)) - T
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        T = T + pad
    nc = T // Q
    f32 = torch.float32

    xf = x.to(f32).reshape(Bb, nc, Q, H, P)
    dtf = dt.to(f32).reshape(Bb, nc, Q, H)
    Bh = Bm.repeat_interleave(rep, dim=2).to(f32).reshape(Bb, nc, Q, H, N)
    Ch = Cm.repeat_interleave(rep, dim=2).to(f32).reshape(Bb, nc, Q, H, N)

    a = dtf * A.to(f32)[None, None, None, :]  # (B,nc,Q,H) negative log-decays
    cum = torch.cumsum(a, dim=2)  # inclusive
    cum_end = cum[:, :, -1, :]  # (B,nc,H)

    # intra-chunk (i >= j): scores = (C_i . B_j) * exp(cum_i - cum_j) * dt_j
    cb = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh)  # (B,nc,H,Q_i,Q_j)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Q_i,Q_j,H)
    idx = torch.arange(Q, device=x.device)
    mask = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    decay = torch.where(mask, torch.exp(torch.clamp_max(diff, 0.0)), torch.zeros((), dtype=f32, device=x.device))
    scores = cb * decay.movedim(-1, 2)  # (B,nc,H,Q_i,Q_j)
    sdt = scores * dtf.permute(0, 1, 3, 2)[:, :, :, None, :]  # x dt_j
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", sdt, xf)
    del cb, diff, decay, scores, sdt

    # chunk states: S_c = sum_j exp(cum_end - cum_j) dt_j B_j x_j^T
    w = torch.exp(cum_end[:, :, None, :] - cum) * dtf  # (B,nc,Q,H)
    S = torch.einsum("bcqhn,bcqhp->bchpn", w[..., None] * Bh, xf)

    # inter-chunk recurrence over the chunks
    cdecay = torch.exp(cum_end)  # (B,nc,H)
    h = (torch.zeros((Bb, H, P, N), dtype=f32, device=x.device) if initial_state is None
         else initial_state.to(f32))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)  # the state before chunk c
        h = h * cdecay[:, c, :, None, None] + S[:, c]
    h_prev = torch.stack(h_prevs, dim=1)  # (B,nc,H,P,N)

    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", Ch, h_prev) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bb, T, H, P)[:, :T_orig]
    return y.to(x.dtype), h


def ssd_sequential(x, dt, A, Bm, Cm, D=None, *, initial_state=None):
    """The exact SSM recurrence, one token at a time (the oracle):
      h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
      y_t = C_t^T h_t (+ D * x_t)

    x (B, T, H, P), dt (B, T, H), A (H,), B/C (B, T, G, N), D (H,) or None.
    Returns (y (B, T, H, P) in x's dtype, the final state (B, H, P, N) f32).
    """
    Bb, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    f32 = torch.float32
    Bh = Bm.repeat_interleave(rep, dim=2).to(f32)  # (B,T,H,N)
    Ch = Cm.repeat_interleave(rep, dim=2).to(f32)
    decay = torch.exp(dt * A[None, None, :]).to(f32)  # (B,T,H)
    xf, dtf = x.to(f32), dt.to(f32)
    h = (torch.zeros((Bb, H, P, N), dtype=f32, device=x.device) if initial_state is None
         else initial_state.to(f32))
    ys = []
    for t in range(T):
        h = h * decay[:, t, :, None, None] + (dtf[:, t, :, None] * xf[:, t])[..., None] * Bh[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((Bb, 0, H, P))
    if D is not None:
        y = y + xf * D[None, None, :, None]
    return y.to(x.dtype), h


def _split_proj(cfg: ArchConfig, z_x_bc_dt: torch.Tensor):
    d_in, H, P, G, N, conv_ch = _dims(cfg)
    z, xbc, dt = torch.split(z_x_bc_dt, [d_in, conv_ch, H], dim=-1)
    return z, xbc, dt  # dt: (..., H)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d of window K, in f32, then SiLU, cast back.
    xbc (B, T, C); w (K, C)."""
    K = w.shape[0]
    T = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(K):
        out = out + pad[:, i:i + T].to(torch.float32) * w[i].to(torch.float32)
    return F.silu(out + b.to(torch.float32)).to(xbc.dtype)


def ssd_inputs(cfg: ArchConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
               initial: Optional[Mamba2State] = None):
    """The block's input projection and causal conv over T tokens, as the
    prefill computes them: returns (z, x_ssd (B, T, H, P), dt (B, T, H)
    f32, A (H,) f32, B and C (B, T, G, N), the conv's input (B, T, C))."""
    B, T, d = x.shape
    d_in, H, P, G, N, conv_ch = _dims(cfg)
    z, xbc, dt = _split_proj(cfg, x @ p["in_proj"])
    if initial is not None:
        conv_ctx = torch.cat([initial.conv.to(xbc.dtype), xbc], dim=1)
        conv_out = _causal_conv(conv_ctx, p["conv_w"], p["conv_b"])[:, cfg.ssm_conv - 1:]
    else:
        conv_out = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs, Bc, Cc = torch.split(conv_out, [d_in, G * N, G * N], dim=-1)
    dtv = softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    A = -torch.exp(p["a_log"].to(torch.float32))
    return (z, xs.reshape(B, T, H, P), dtv, A, Bc.reshape(B, T, G, N), Cc.reshape(B, T, G, N), xbc)


def mamba2_prefill(
    cfg: ArchConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, T, d)
    initial: Optional[Mamba2State] = None,
) -> Tuple[torch.Tensor, Mamba2State]:
    """One Mamba-2 block over T tokens, optionally continuing from
    ``initial``; returns (out (B, T, d), the state after the last token)."""
    B, T, d = x.shape
    z, xs, dtv, A, Bc, Cc, conv_in = ssd_inputs(cfg, p, x, initial)
    y, hT = ssd_chunked(xs, dtv, A, Bc, Cc, cfg.ssm_chunk, None if initial is None else initial.ssm)
    y = y + xs.to(torch.float32).to(y.dtype) * p["d_skip"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B, T, cfg.d_inner)
    y = rmsnorm(y * F.silu(z), p["norm_gamma"])
    out = y @ p["out_proj"]
    conv_all = conv_in if initial is None else torch.cat([initial.conv.to(conv_in.dtype), conv_in], dim=1)
    return out, Mamba2State(conv=conv_all[:, -(cfg.ssm_conv - 1):], ssm=hT)


def mamba2_decode(
    cfg: ArchConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, 1, d)
    state: Mamba2State,
) -> Tuple[torch.Tensor, Mamba2State]:
    """One token through a Mamba-2 block: the exact recurrence on the
    carried (conv, ssm) state.  Returns (out (B, 1, d), the new state)."""
    B = x.shape[0]
    d_in, H, P, G, N, conv_ch = _dims(cfg)
    f32 = torch.float32
    zxd = x[:, 0] @ p["in_proj"]  # (B, ...)
    z, xbc, dt = _split_proj(cfg, zxd)
    window = torch.cat([state.conv.to(xbc.dtype), xbc[:, None, :]], dim=1)  # (B, K, C)
    conv_out = torch.einsum("bkc,kc->bc", window.to(f32), p["conv_w"].to(f32))
    conv_out = F.silu(conv_out + p["conv_b"].to(f32)).to(x.dtype)
    xs, Bc, Cc = torch.split(conv_out, [d_in, G * N, G * N], dim=-1)
    xs = xs.reshape(B, H, P)
    Bc = Bc.reshape(B, G, N).repeat_interleave(H // G, dim=1)
    Cc = Cc.reshape(B, G, N).repeat_interleave(H // G, dim=1)
    dtv = softplus(dt.to(f32) + p["dt_bias"].to(f32))
    A = -torch.exp(p["a_log"].to(f32))
    dec = torch.exp(dtv * A[None, :])  # (B,H)
    h = state.ssm * dec[:, :, None, None] + (dtv[:, :, None] * xs.to(f32))[..., None] * Bc.to(f32)[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", h, Cc.to(f32))
    y = y + xs.to(f32) * p["d_skip"].to(f32)[None, :, None]
    y = y.reshape(B, d_in).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm_gamma"])
    out = (y @ p["out_proj"])[:, None, :]
    return out, Mamba2State(conv=window[:, 1:, :], ssm=h)
