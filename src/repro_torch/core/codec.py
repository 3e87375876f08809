"""CacheGen KV-cache codec: chunk-level encode/decode at multiple levels.

Pipeline (paper §5.2):

    KV (L, 2, T, C) f32
      └─ split into token groups of ``group_size``; anchor = first token
         ├─ anchors: 8-bit vectorwise quantization            (quant.py)
         ├─ deltas: layer-group binned quantization           (quant.py)
         └─ symbols → lane-parallel rANS with per-(layer,K/V,channel)
            static distributions                              (rans.py)
      → bitstream (bitstream.py)

Encoding levels:
  * level 0: "lossless-after-8bit" — entropy coding of 8-bit quantized KV;
  * level 1..n: lossy, bins scaled by ``level_mults[level-1]``
    (level 1 finest; higher level = smaller stream, coarser KV).

Tables are profiled offline per model on calibration KV caches
(:func:`profile`) and live on one device; every coder call runs there.

The serving hot path is :func:`decode_chunks`: every fetched chunk's
bitstream is parsed once on the host, all lanes are stacked into exactly two
rANS decodes (anchors for all chunks; deltas for all chunks, lossy levels
and the lossless family sharing one alphabet-padded table stack), each one
launch of the kernel K7 on a card (``kernels.ops.rans_decode``) over the
wire's compact payloads, joined on the device with no padding, and every
chunk's tokens are rebuilt in one pass by the fused kernels K1/K2
(``kernels.ops.kv_dequant_tokens`` / ``kv_lossless_tokens``), which emit
whole token groups in the cache's dtype.  On a CUDA device the kernels run;
on the CPU their plain versions do — there is no switch.
:func:`decode_chunk` (singular) is the unfused oracle the fused path is
held to: bit-exact at level 0 (in f32), tolerance-exact at lossy levels;
its lossy reconstruction is the delta-only kernel K6
(``kernels.ops.kv_dequant``).

:func:`encode_all_levels` symbolizes and entropy-codes the level-invariant
anchors once and runs all lossy levels' delta encodes as one stacked call;
its bitstreams are byte-identical to per-level :func:`encode_chunk`, and to
the reference package's under the same tables.  The lossy delta symbols of
both come from the kernel K5 (``kernels.ops.kv_quant``), and every rANS
encode is the kernel K8 on a card (``kernels.ops.rans_encode``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch._device import resolve_device
from repro_torch.core import bitstream, gop, quant, rans, tables
from repro_torch.kernels import ops

__all__ = [
    "CodecConfig",
    "CodecTables",
    "profile",
    "tables_from_numpy",
    "encode_chunk",
    "peek_chunk_header",
    "verify_chunk",
    "decode_chunk",
    "decode_chunks",
    "decode_chunk_runs",
    "encode_all_levels",
    "ensure_stacks",
    "kv_nbytes_fp16",
    "kv_nbytes_int8",
]


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """The codec's settings, as the reference's.  Any ``delta_qmax`` runs on
    the card: the rANS kernels stage each lane's cum row in shared memory
    while it fits a block (``kernels.rans.MAX_ALPHABET``: K7 up to 1,743
    symbols, K8 up to 1,807), and ``kernels.ops`` takes their wide kernels
    for wider tables.  The delta decode stack has ``max(2 * delta_qmax + 1,
    509)`` symbols, so at ``delta_qmax`` 872 and above ``decode_chunks``'
    delta decode runs on the wide K7 (its anchors stay staged: still two K7
    launches a call)."""

    group_size: int = 10
    layer_group_bins: Tuple[float, float, float] = (0.5, 1.0, 1.5)
    level_mults: Tuple[float, ...] = (0.5, 1.0, 2.0, 4.0)
    delta_qmax: int = 127
    precision: int = 12
    channel_buckets: Optional[int] = None
    use_delta_scale: bool = True

    @property
    def n_levels(self) -> int:
        return 1 + len(self.level_mults)

    @property
    def delta_alphabet(self) -> int:
        return quant.delta_alphabet(self.delta_qmax)


class CodecTables(NamedTuple):
    """Per-model static coder tables (profiled offline), on one device."""

    anchor: rans.CoderTables  # lossy anchors, alphabet 256
    deltas: Dict[int, rans.CoderTables]  # per lossy level, alphabet 2*qmax+1
    ll_anchor: rans.CoderTables  # lossless anchors, alphabet 256
    ll_delta: rans.CoderTables  # lossless integer deltas, alphabet 509
    table_idx: np.ndarray  # lane -> table
    delta_scale: Optional[np.ndarray]  # (L, 2) or None
    config: CodecConfig
    n_layers: int
    n_channels: int
    # Pre-stacked table sets for the batched coder calls (built by
    # :func:`profile`; lazily derived when tables are constructed by hand).
    anchor_stack: Optional[rans.CoderTables] = None  # [anchor; ll_anchor]
    lossy_delta_stack: Optional[rans.CoderTables] = None  # deltas lvl 1..n
    # decode-only: all delta sets (lossy levels + lossless) alphabet-padded
    # into one stack so mixed-level runs need a single delta scan
    delta_decode_stack: Optional[rans.CoderTables] = None

    @property
    def device(self) -> torch.device:
        return self.anchor.device


def _anchor_stack(ct: CodecTables) -> rans.CoderTables:
    if ct.anchor_stack is not None:
        return ct.anchor_stack
    return rans.stack_tables([ct.anchor, ct.ll_anchor])


def _lossy_delta_stack(ct: CodecTables) -> rans.CoderTables:
    if ct.lossy_delta_stack is not None:
        return ct.lossy_delta_stack
    return rans.stack_tables([ct.deltas[l] for l in sorted(ct.deltas)])


def _delta_decode_stack(ct: CodecTables) -> rans.CoderTables:
    if ct.delta_decode_stack is not None:
        return ct.delta_decode_stack
    lossy = [ct.deltas[l] for l in sorted(ct.deltas)]
    return rans.stack_tables(lossy + [ct.ll_delta], pad_alphabet=True)


def _delta_table_base(ct: CodecTables, level: int) -> int:
    """Table offset of ``level``'s delta set inside the decode stack."""
    n_td = ct.ll_delta.n_tables
    return len(ct.deltas) * n_td if level == 0 else (level - 1) * n_td


def ensure_stacks(ct: CodecTables) -> CodecTables:
    """Fill in any missing pre-stacked table sets (one-time upgrade)."""
    return ct._replace(
        anchor_stack=_anchor_stack(ct),
        lossy_delta_stack=_lossy_delta_stack(ct) if ct.deltas else None,
        delta_decode_stack=_delta_decode_stack(ct),
    )


def _lanes(x: torch.Tensor) -> torch.Tensor:
    """(L, 2, T', C) -> (L*2*C, T') lane-major symbol matrix."""
    L, two, Tp, C = x.shape
    return x.permute(0, 1, 3, 2).reshape(L * two * C, Tp)


def _unlanes(x: torch.Tensor, L: int, C: int) -> torch.Tensor:
    n_lanes, Tp = x.shape
    return x.reshape(L, 2, C, Tp).permute(0, 1, 3, 2)


def _bins_for_level(
    cfg: CodecConfig, L: int, level: int, delta_scale: Optional[np.ndarray]
) -> np.ndarray:
    mult = cfg.level_mults[level - 1]
    ds = delta_scale if cfg.use_delta_scale else None
    return quant.effective_bins(L, cfg.layer_group_bins, mult, ds)


def _symbolize(
    kv: torch.Tensor,
    cfg: CodecConfig,
    level: int,
    delta_scale: Optional[np.ndarray],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, gop.GroupLayout]:
    """KV -> (anchor_symbols_lanes, delta_symbols_lanes, scales, layout)."""
    L, two, T, C = kv.shape
    layout = gop.make_layout(T, cfg.group_size)
    if level == 0:
        a_sym, d_sym, scales = quant.lossless_quantize(kv, layout)
    else:
        grouped = gop.group_tokens(kv, layout)
        a_sym, scales = quant.quantize_anchors(grouped[:, :, :, 0])
        bins = torch.as_tensor(_bins_for_level(cfg, L, level, delta_scale), device=kv.device)
        d_sym = _quantize_deltas(grouped, bins, layout, cfg.delta_qmax)
    return _lanes(a_sym), _lanes(d_sym), scales, layout


def _quantize_deltas(
    grouped: torch.Tensor, bins: torch.Tensor, layout: gop.GroupLayout, qmax: int
) -> torch.Tensor:
    """Whole token groups (L, 2, G, g, C) f32 + (L, 2) bins -> the lossy
    delta symbols (L, 2, T - G, C) int32 in token order, through K5."""
    L, two, G, g, C = grouped.shape
    sym = ops.kv_quant(
        grouped.reshape(L * two, G, g, C).contiguous(), bins.reshape(L * two).contiguous(), qmax=qmax
    )
    return gop.ungroup(sym.reshape(L, two, G, g - 1, C), layout.n_deltas).to(torch.int32)


def _as_kv(kv, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(kv, device=device).to(torch.float32)


def _histogram(sym: torch.Tensor, t_idx: np.ndarray, n_t: int, alphabet: int) -> np.ndarray:
    return tables.histogram_symbols(sym.cpu().numpy(), t_idx, n_t, alphabet)


def profile(
    kv_samples: Sequence,
    cfg: CodecConfig = CodecConfig(),
    *,
    device=None,
) -> CodecTables:
    """Offline table profiling from calibration KV caches (paper §5.2).

    kv_samples: list of (L, 2, T, C) arrays or tensors from representative
    contexts.  The tables land on ``device`` (the CUDA card unless given).
    """
    if not kv_samples:
        raise ValueError("need at least one calibration KV cache")
    dev = resolve_device(device)
    L, two, _, C = kv_samples[0].shape
    n_t = tables.n_tables_for(L, C, cfg.channel_buckets)
    t_idx = tables.lane_table_index(L, C, cfg.channel_buckets)

    delta_scale = None
    if cfg.use_delta_scale:
        acc = np.zeros((L, 2), np.float64)
        n = 0
        for kv in kv_samples:
            kvt = _as_kv(kv, dev)
            layout = gop.make_layout(kvt.shape[2], cfg.group_size)
            _, deltas = gop.split_anchors_deltas(kvt, layout)
            acc += (deltas * deltas).mean(dim=(2, 3)).cpu().numpy()
            n += 1
        delta_scale = np.sqrt(acc / n).astype(np.float32)
        delta_scale = np.maximum(delta_scale, 1e-6)

    a_counts = np.zeros((n_t, quant.ANCHOR_ALPHABET), np.int64)
    lla_counts = np.zeros((n_t, quant.ANCHOR_ALPHABET), np.int64)
    lld_counts = np.zeros((n_t, quant.lossless_delta_alphabet()), np.int64)
    d_counts = {
        lvl: np.zeros((n_t, cfg.delta_alphabet), np.int64)
        for lvl in range(1, cfg.n_levels)
    }
    for kv in kv_samples:
        kvt = _as_kv(kv, dev)
        a, d, _, _ = _symbolize(kvt, cfg, 0, delta_scale)
        lla_counts += _histogram(a, t_idx, n_t, quant.ANCHOR_ALPHABET)
        lld_counts += _histogram(d, t_idx, n_t, quant.lossless_delta_alphabet())
        for lvl in range(1, cfg.n_levels):
            a, d, _, _ = _symbolize(kvt, cfg, lvl, delta_scale)
            if lvl == 1:
                a_counts += _histogram(a, t_idx, n_t, quant.ANCHOR_ALPHABET)
            d_counts[lvl] += _histogram(d, t_idx, n_t, cfg.delta_alphabet)

    def _freqs(counts):
        return tables.normalize_freqs(counts, cfg.precision)

    return tables_from_numpy(
        anchor=_freqs(a_counts),
        deltas={lvl: _freqs(c) for lvl, c in d_counts.items()},
        ll_anchor=_freqs(lla_counts),
        ll_delta=_freqs(lld_counts),
        table_idx=t_idx,
        delta_scale=delta_scale,
        config=cfg,
        n_layers=L,
        n_channels=C,
        device=dev,
    )


def tables_from_numpy(
    *,
    anchor: np.ndarray,
    deltas: Dict[int, np.ndarray],
    ll_anchor: np.ndarray,
    ll_delta: np.ndarray,
    table_idx: np.ndarray,
    delta_scale: Optional[np.ndarray],
    config: CodecConfig,
    n_layers: int,
    n_channels: int,
    device=None,
) -> CodecTables:
    """Build :class:`CodecTables` from quantized frequency tables (each
    ``(n_tables, A)``, rows summing to ``2**config.precision``).

    The bridge from any other holder of profiled tables — the reference
    package's ``CodecTables`` fields as numpy arrays, or a file — so that two
    codecs share one set of tables and emit identical bitstreams.
    """
    dev = resolve_device(device)
    k = config.precision

    def _mk(freqs):
        return tables.build_coder_tables(np.asarray(freqs), k, dev)

    ct = CodecTables(
        anchor=_mk(anchor),
        deltas={int(lvl): _mk(f) for lvl, f in sorted(deltas.items())},
        ll_anchor=_mk(ll_anchor),
        ll_delta=_mk(ll_delta),
        table_idx=np.asarray(table_idx, np.int32),
        delta_scale=None if delta_scale is None else np.asarray(delta_scale, np.float32),
        config=config,
        n_layers=int(n_layers),
        n_channels=int(n_channels),
    )
    return ensure_stacks(ct)


def _chunk_header(
    cfg: CodecConfig, level: int, T: int, L: int, C: int,
    chunk_idx: Optional[int] = None,
) -> dict:
    """Single source of truth for the chunk bitstream header (wire v1).

    ``chunk_idx`` is the chunk's position in its context, omitted when
    unknown (keeping standalone encodes byte-identical).
    """
    h = {
        "v": 1,
        "level": int(level),
        "n_tokens": int(T),
        "n_layers": int(L),
        "n_channels": int(C),
        "group_size": int(cfg.group_size),
    }
    if chunk_idx is not None:
        h["chunk_idx"] = int(chunk_idx)
    return h


def peek_chunk_header(blob: bytes) -> dict:
    """Parse only a chunk bitstream's header (``bitstream.peek_header``)."""
    return bitstream.peek_header(blob)


def verify_chunk(blob: bytes) -> bool:
    """Checksum-gate a chunk bitstream before decode
    (``bitstream.verify_checksum``): ``True`` for a valid trailer, ``False``
    for a blob without one; raises ``bitstream.IntegrityError`` on
    corruption."""
    return bitstream.verify_checksum(blob)


def _check_geometry(kv: torch.Tensor, ct: CodecTables) -> None:
    L, _, _, C = kv.shape
    if L != ct.n_layers or C != ct.n_channels:
        raise ValueError(
            f"KV shape {tuple(kv.shape)} does not match profiled tables "
            f"(L={ct.n_layers}, C={ct.n_channels})"
        )


def _stream_arrays(words, n_words, state, prefix: str) -> Dict[str, np.ndarray]:
    """A coded stream's wire arrays.  On a card its valid words are picked out
    there and cross to the host at 16 bits (K8's buffer holds every step's
    word at 32)."""
    if not words.is_cuda:
        return bitstream.pack_stream(words.numpy(), n_words.numpy(), state.numpy(), prefix)
    keep = torch.arange(words.shape[1], device=words.device)[None, :] < n_words[:, None]
    payload = rans.wire_bits(words[keep], 16, words.device).cpu().numpy().view(np.uint16)
    return bitstream.stream_arrays(payload, n_words.cpu().numpy(), state.cpu().numpy(), prefix)


def encode_chunk(kv, ct: CodecTables, level: int, chunk_idx: Optional[int] = None) -> bytes:
    """Encode one chunk's KV (L, 2, T, C) at ``level`` into a bitstream."""
    cfg = ct.config
    kv = _as_kv(kv, ct.device)
    _check_geometry(kv, ct)
    L, two, T, C = kv.shape
    a_sym, d_sym, scales, layout = _symbolize(kv, cfg, level, ct.delta_scale)
    a_tab = ct.ll_anchor if level == 0 else ct.anchor
    d_tab = ct.ll_delta if level == 0 else ct.deltas[level]
    # level-invariant entries (a.*, scales) lead so they form a contiguous
    # anchor segment in the resumable layout (bitstream.segment_index)
    arrays = _stream_arrays(*rans.encode(a_sym, ct.table_idx, a_tab), "a")
    arrays["scales"] = scales.cpu().numpy().astype(np.float16)
    arrays.update(_stream_arrays(*rans.encode(d_sym, ct.table_idx, d_tab), "d"))
    return bitstream.pack(_chunk_header(cfg, level, T, L, C, chunk_idx), arrays)


def decode_chunk(blob: bytes, ct: CodecTables) -> torch.Tensor:
    """Decode a chunk bitstream back to KV (L, 2, T, C) float32 (the
    unfused oracle of :func:`decode_chunks`)."""
    cfg = ct.config
    header, arrays = bitstream.unpack(blob)
    level = int(header["level"])
    T = int(header["n_tokens"])
    L = int(header["n_layers"])
    C = int(header["n_channels"])
    layout = gop.make_layout(T, int(header["group_size"]))
    a_tab = ct.ll_anchor if level == 0 else ct.anchor
    d_tab = ct.ll_delta if level == 0 else ct.deltas[level]
    a_sym = _unlanes(rans.decode_payload(*_stream(arrays, "a"), ct.table_idx, a_tab, layout.n_anchors), L, C)
    d_sym = _unlanes(rans.decode_payload(*_stream(arrays, "d"), ct.table_idx, d_tab, layout.n_deltas), L, C)
    scales = torch.as_tensor(arrays["scales"].astype(np.float32), device=ct.device)
    if level == 0:
        return quant.lossless_reconstruct(a_sym, d_sym, scales, layout)
    anchors = quant.dequantize_anchors(a_sym, scales)
    bins = torch.as_tensor(_bins_for_level(cfg, L, level, ct.delta_scale), device=ct.device)
    return _reconstruct_lossy(anchors, d_sym, bins, layout, cfg.delta_qmax)


def _reconstruct_lossy(
    anchors: torch.Tensor, d_sym: torch.Tensor, bins: torch.Tensor, layout: gop.GroupLayout, qmax: int
) -> torch.Tensor:
    """(L, 2, G, C) f32 anchors + (L, 2, T - G, C) delta symbols + (L, 2)
    bins -> KV (L, 2, T, C) f32.  K6 rebuilds the delta tokens of whole
    groups (a partial last group's missing symbols padded, then dropped);
    the anchors go in slot 0, as ``gop.merge_anchors_deltas`` places them
    in the reference."""
    L, two, G, C = anchors.shape
    gm1 = layout.group_size - 1
    d = F.pad(d_sym, (0, 0, 0, G * gm1 - layout.n_deltas))
    others = ops.kv_dequant(
        d.reshape(L * two, G, gm1, C).to(torch.uint16).contiguous(),
        anchors.reshape(L * two, G, C).contiguous(),
        bins.reshape(L * two).contiguous(),
        qmax=qmax,
        out_dtype=torch.float32,
    )
    tokens = torch.cat([anchors.reshape(L * two, G, 1, C), others], dim=2)
    return gop.ungroup(tokens.reshape(L, two, G, gm1 + 1, C), layout.n_tokens)


# ---------------------------------------------------------------------------
# Batched fused decode (serving hot path)
# ---------------------------------------------------------------------------


def _stream(arrays: Dict[str, np.ndarray], prefix: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A coded stream's wire arrays as ``rans.decode_payload`` takes them:
    (payload, n_words, state)."""
    return tuple(arrays[f"{prefix}.{key}"] for key in ("payload", "n_words", "state"))


def _join_streams(
    parsed: List[Tuple[dict, Dict[str, np.ndarray]]], prefix: str, device: torch.device
) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Several chunks' streams as one stream of all their lanes: the wire's
    payloads, each copied to ``device`` as it is and joined there (lane-major
    across chunks is lane-major within each), and the lanes' word counts and
    states joined on the host."""
    payloads = [rans.wire_bits(arrays[f"{prefix}.payload"], 16, device) for _, arrays in parsed]
    n_words, state = (np.concatenate([arrays[f"{prefix}.{key}"] for _, arrays in parsed])
                      for key in ("n_words", "state"))
    return (payloads[0] if len(payloads) == 1 else torch.cat(payloads)), n_words, state


def _decode_streams(parsed, prefix: str, device: torch.device, table_idx, tables: rans.CoderTables,
                    n_sym: int) -> torch.Tensor:
    """One rANS decode of every chunk's ``prefix`` stream.  The joined
    payload on the device is freed on return, before the next stream's."""
    with tracing.span("codec.h2d", chunks=len(parsed)):
        stream = _join_streams(parsed, prefix, device)
    with tracing.span("codec.rans", lanes=len(stream[1])):
        return rans.decode_payload(*stream, table_idx, tables, n_sym)


def _assemble_chunks(
    a_sym: torch.Tensor,  # (N * n_lanes, Gmax) anchor symbols, all chunks
    d_sym: torch.Tensor,  # (N * n_lanes, Dmax) delta symbols, all chunks
    scales: torch.Tensor,  # (N, L, 2, Gmax) f32 anchor/group scales
    bins: torch.Tensor,  # (Nl, L, 2) f32 effective bin widths per lossy chunk
    *,
    shape_meta,  # (L, C, g, qmax, ((T, G, D, is_lossless), ...))
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Reconstruct all chunks' tokens: symbol regroup + the fused K1/K2
    kernels + token-major concat.  Returns (L, 2, sum T, C)."""
    L, C, g, qmax, chunk_meta = shape_meta
    N = len(chunk_meta)
    Gmax = max(m[1] for m in chunk_meta)
    gm1 = g - 1
    lossy_idx = [i for i, m in enumerate(chunk_meta) if not m[3]]
    ll_idx = [i for i, m in enumerate(chunk_meta) if m[3]]
    dev = a_sym.device

    # anchors for all chunks: lane-major symbols -> (N, L, 2, Gmax, C)
    a = a_sym.reshape(N, L, 2, C, Gmax).permute(0, 1, 2, 4, 3)
    d_all = d_sym.reshape(N, L, 2, C, -1)

    def regroup(subset: Sequence[int]) -> torch.Tensor:
        """Lane-major delta symbols -> (n_sub * L * 2, Gmax, g-1, C) uint16,
        the kernels' input.  Padding appends only positions >= the chunk's T
        (deltas are contiguous in token order)."""
        outs = []
        for i in subset:
            T, G, D, _ = chunk_meta[i]
            di = F.pad(d_all[i, ..., :D], (0, G * gm1 - D))
            di = di.reshape(L, 2, C, G, gm1)
            outs.append(F.pad(di, (0, 0, 0, Gmax - G)))
        d_g = torch.stack(outs).permute(0, 1, 2, 4, 5, 3)  # (n, L, 2, Gmax, g-1, C)
        return d_g.reshape(len(subset) * L * 2, Gmax, gm1, C).to(torch.uint16).contiguous()

    def sel(x: torch.Tensor, subset: Sequence[int]) -> torch.Tensor:
        return x.index_select(0, torch.as_tensor(subset, device=dev))

    tok_by_chunk: Dict[int, torch.Tensor] = {}

    if lossy_idx:
        Nl = len(lossy_idx)
        anchors_f = (sel(a, lossy_idx).to(torch.float32) - 128.0) * sel(scales, lossy_idx)[..., None]
        if gm1 == 0:
            tok = anchors_f[:, :, :, :, None, :].to(out_dtype)
        else:
            tok = ops.kv_dequant_tokens(
                regroup(lossy_idx),
                anchors_f.reshape(Nl * L * 2, Gmax, C).contiguous(),
                bins.reshape(Nl * L * 2).contiguous(),
                qmax=qmax,
                out_dtype=out_dtype,
            ).reshape(Nl, L, 2, Gmax, g, C)
        for j, i in enumerate(lossy_idx):
            tok_by_chunk[i] = tok[j]

    if ll_idx:
        N0 = len(ll_idx)
        a_ll = sel(a, ll_idx)
        s_ll = sel(scales, ll_idx)  # (N0, L, 2, Gmax)
        if gm1 == 0:
            tok = ((a_ll.to(torch.float32) - 128.0) * s_ll[..., None])[:, :, :, :, None, :].to(out_dtype)
        else:
            tok = ops.kv_lossless_tokens(
                regroup(ll_idx),
                a_ll.reshape(N0 * L * 2, Gmax, C).to(torch.uint16).contiguous(),
                s_ll.reshape(N0 * L * 2, Gmax).contiguous(),
                out_dtype=out_dtype,
            ).reshape(N0, L, 2, Gmax, g, C)
        for j, i in enumerate(ll_idx):
            tok_by_chunk[i] = tok[j]

    pieces = []
    for i, (T, G, _, _) in enumerate(chunk_meta):
        tok = tok_by_chunk[i]  # (L, 2, Gmax, g', C)
        gp = tok.shape[3]
        pieces.append(tok[:, :, :G].reshape(L, 2, G * gp, C)[:, :, :T])
    out = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=2)
    return out.to(out_dtype)


def decode_chunks(
    blobs: Sequence[bytes],
    ct: CodecTables,
    *,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Batched fused decode of several chunk bitstreams (serving hot path).

    Parses every blob once on the host, then runs exactly two lane-stacked
    rANS decodes — anchors for all chunks, deltas for all chunks (per-level
    and lossless tables merged via alphabet-padded :func:`rans.stack_tables`)
    — and one assemble step through the fused kernels K1/K2, emitting
    token-major KV for all chunks concatenated along the token axis:
    ``(L, 2, sum(T_i), C)`` in ``out_dtype`` (float32 or bfloat16), on the
    tables' device.

    Equivalent to concatenating per-chunk :func:`decode_chunk` results:
    bit-exact at level 0 (in f32), tolerance-exact at lossy levels.
    """
    if not blobs:
        raise ValueError("decode_chunks needs at least one blob")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_chunks: out_dtype must be float32 or bfloat16, got {out_dtype}")
    cfg = ct.config
    dev = ct.device
    parsed = [bitstream.unpack(b) for b in blobs]
    h0 = parsed[0][0]
    L, C, g = int(h0["n_layers"]), int(h0["n_channels"]), int(h0["group_size"])
    for h, _ in parsed:
        if (int(h["n_layers"]), int(h["n_channels"]), int(h["group_size"])) != (L, C, g):
            raise ValueError("decode_chunks requires chunks with a common geometry")
    if L != ct.n_layers or C != ct.n_channels:
        raise ValueError(
            f"chunk geometry (L={L}, C={C}) does not match profiled tables "
            f"(L={ct.n_layers}, C={ct.n_channels})"
        )

    metas = []
    for h, _ in parsed:
        lvl, T = int(h["level"]), int(h["n_tokens"])
        layout = gop.make_layout(T, g)
        metas.append((lvl, T, layout.n_anchors, layout.n_deltas))
    N = len(metas)
    n_lanes = L * 2 * C
    Gmax = max(m[2] for m in metas)
    t_idx_np = np.asarray(ct.table_idx)
    n_ta = ct.anchor.n_tables

    # --- anchors: one decode over all chunks (lossy + lossless tables stacked)
    t_idx_a = np.concatenate([t_idx_np + (n_ta if m[0] == 0 else 0) for m in metas])
    a_sym = _decode_streams(parsed, "a", dev, t_idx_a, _anchor_stack(ct), Gmax)

    # --- deltas: ONE decode for all chunks — lossy levels and the lossless
    # family (different alphabet) share it via alphabet-padded table stacking
    d_max = max(m[3] for m in metas)
    if d_max > 0:
        t_idx_d = np.concatenate([t_idx_np + _delta_table_base(ct, m[0]) for m in metas])
        d_sym = _decode_streams(parsed, "d", dev, t_idx_d, _delta_decode_stack(ct), d_max)
    else:
        d_sym = torch.zeros((N * n_lanes, 0), dtype=torch.int32, device=dev)

    # --- per-chunk side data, padded + stacked once on the host
    lossy_idx = [i for i, m in enumerate(metas) if m[0] != 0]
    scales = np.zeros((N, L, 2, Gmax), np.float32)
    for i, (_, arrays) in enumerate(parsed):
        s = arrays["scales"].astype(np.float32)
        scales[i, :, :, : s.shape[2]] = s
    bins = np.zeros((len(lossy_idx), L, 2), np.float32)
    for j, i in enumerate(lossy_idx):
        bins[j] = _bins_for_level(cfg, L, metas[i][0], ct.delta_scale)

    shape_meta = (
        L, C, g, cfg.delta_qmax,
        tuple((T, G, D, lvl == 0) for (lvl, T, G, D) in metas),
    )
    with tracing.span("codec.h2d", chunks=N):
        scales, bins = torch.as_tensor(scales, device=dev), torch.as_tensor(bins, device=dev)
    with tracing.span("codec.assemble", chunks=N):
        return _assemble_chunks(a_sym, d_sym, scales, bins, shape_meta=shape_meta, out_dtype=out_dtype)


def decode_chunk_runs(
    runs: Sequence[Sequence[bytes]],
    ct: CodecTables,
    *,
    out_dtype: torch.dtype = torch.float32,
    run_tokens: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, List[Tuple[int, int]]]:
    """Cross-request run assembly: several requests' chunk runs, one decode.

    ``runs`` is one entry per request — that request's consecutive bitstream
    chunks.  All runs are flattened into *one* :func:`decode_chunks` call, so
    N concurrent requests cost the same number of kernel launches as one.

    Returns ``(kv, spans)``: ``kv`` is the token-major concat
    ``(L, 2, sum_all_T, C)`` of every chunk of every run in order, and
    ``spans[r] = (token_offset, n_tokens)`` locates request ``r``'s run in
    it; the slice is bit-identical to the request's own ``decode_chunks``.

    ``run_tokens`` (optional) supplies each run's known token count so the
    span computation skips re-parsing headers; when given it is
    cross-checked against the decoded total.
    """
    if not runs or any(not r for r in runs):
        raise ValueError("decode_chunk_runs needs non-empty runs")
    flat: List[bytes] = [b for run in runs for b in run]
    kv = decode_chunks(flat, ct, out_dtype=out_dtype)
    if run_tokens is None:
        run_tokens = [
            sum(int(peek_chunk_header(b)["n_tokens"]) for b in run)
            for run in runs
        ]
    elif len(run_tokens) != len(runs):
        raise ValueError(
            f"run_tokens covers {len(run_tokens)} runs, got {len(runs)}"
        )
    if sum(run_tokens) != kv.shape[2]:
        raise ValueError(
            f"runs decode to {kv.shape[2]} tokens but run_tokens sums to "
            f"{sum(run_tokens)}; bitstream/plan divergence"
        )
    spans: List[Tuple[int, int]] = []
    off = 0
    for n in run_tokens:
        spans.append((off, int(n)))
        off += int(n)
    return kv, spans


def encode_all_levels(kv, ct: CodecTables, chunk_idx: Optional[int] = None) -> Dict[int, bytes]:
    """Offline pre-encoding of every streaming level (paper §5.3).

    Batched: the lossy levels share their anchor stream (anchors are
    level-invariant), so anchors are symbolized and entropy-coded exactly
    once, and all lossy levels' delta streams are encoded in one stacked
    rANS call over ``n_lossy_levels * n_lanes`` lanes.  Output bitstreams
    are byte-identical to per-level :func:`encode_chunk`.
    """
    cfg = ct.config
    kv = _as_kv(kv, ct.device)
    _check_geometry(kv, ct)
    L, two, T, C = kv.shape
    out: Dict[int, bytes] = {0: encode_chunk(kv, ct, 0, chunk_idx)}
    lossy = list(range(1, cfg.n_levels))
    if not lossy:
        return out

    layout = gop.make_layout(T, cfg.group_size)
    grouped = gop.group_tokens(kv, layout).contiguous()  # (L, 2, G, g, C)

    # anchors: level-invariant — symbolize and entropy-code once
    a_sym, scales = quant.quantize_anchors(grouped[:, :, :, 0])
    a_arrays = _stream_arrays(*rans.encode(_lanes(a_sym), ct.table_idx, ct.anchor), "a")
    scales16 = scales.cpu().numpy().astype(np.float16)

    # deltas: K5 once per lossy level over the same grouped tokens (one bin
    # per leading row; folding the levels into that row axis would need a
    # materialized n_lossy-fold copy of the KV), then entropy-code all levels
    # in one stacked rANS call (per-lane streams are independent of the
    # stacking)
    d_sym_all = torch.stack([
        _quantize_deltas(
            grouped,
            torch.as_tensor(_bins_for_level(cfg, L, lvl, ct.delta_scale), device=ct.device),
            layout,
            cfg.delta_qmax,
        )
        for lvl in lossy
    ])  # (n_lossy, L, 2, D, C)
    n_lanes = L * two * C
    d_stack = d_sym_all.permute(0, 1, 2, 4, 3).reshape(len(lossy) * n_lanes, layout.n_deltas)
    n_td = ct.deltas[lossy[0]].n_tables
    t_idx_np = np.asarray(ct.table_idx)
    t_stack = np.concatenate([t_idx_np + (lvl - 1) * n_td for lvl in lossy])
    dw, dn, dx = rans.encode(d_stack, t_stack, _lossy_delta_stack(ct))

    for j, lvl in enumerate(lossy):
        sl = slice(j * n_lanes, (j + 1) * n_lanes)
        arrays = dict(a_arrays)
        arrays["scales"] = scales16
        arrays.update(_stream_arrays(dw[sl], dn[sl], dx[sl], "d"))
        out[lvl] = bitstream.pack(_chunk_header(cfg, lvl, T, L, C, chunk_idx), arrays)
    return out


def kv_nbytes_fp16(L: int, T: int, C: int) -> int:
    """Baseline 'raw fp16 tensors' wire size for a chunk."""
    return L * 2 * T * C * 2


def kv_nbytes_int8(L: int, T: int, C: int, group_size: int = 10) -> int:
    """Baseline '8-bit uniform quantization' wire size (symbols + scales)."""
    n_groups = -(-T // group_size)
    return L * 2 * T * C + L * 2 * n_groups * 2
