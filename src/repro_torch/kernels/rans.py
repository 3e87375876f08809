"""K7/K8: the lane-parallel rANS coder's two scans, decode and encode.

``rans_decode`` (K7) replaces ``src/repro/core/rans.py:_decode_impl`` and
``rans_encode`` (K8) replaces ``src/repro/core/rans.py:_encode_impl``: the
jitted ``lax.scan`` over all lanes that the reference runs on its device
between the wire and K1/K2 (load path) and between K5 and the wire (store
path).  On the card each lane is one CUDA thread (``csrc/rans.cu``; see its
head for what bounds the kernels on the H100 and how the design answers
it).  Each ``*_plain`` function is the same scan as a Python loop of
elementwise PyTorch ops over all lanes, one step per symbol: the CPU's route
and the kernels' oracle on the card.  ``kernels.ops`` picks between them by
the tables' device; ``core.rans.encode`` / ``decode`` call it.

Contracts, the same for both routes (``tables`` is a ``core.rans.CoderTables``:
``freqs (n_tables, A)`` and ``cums (n_tables, A + 1)`` int64, ``slot2sym
(n_tables, 2**k)`` int16, ``precision`` k <= 14):

* decode: ``words (n_lanes, cap)`` int16 (the wire's ``uint16`` words'
  bits, read as unsigned; ``core.rans.wire_bits``), ``n_words (n_lanes,)``
  int32, ``state (n_lanes,)`` int32 (the ``uint32`` states' bits, read as
  unsigned), ``table_idx (n_lanes,)`` int32 -> ``(symbols (n_lanes, n_sym)
  int32, x (n_lanes,) int64, ptr (n_lanes,) int64)``: each lane's final
  state and word pointer, which a well-formed stream leaves at ``2**16``
  and -1.
* encode: ``symbols (n_lanes, n_sym)`` int32, ``table_idx (n_lanes,)`` int32
  -> ``(words (n_lanes, n_sym) int32 holding 16-bit values, n_words
  (n_lanes,) int32, x (n_lanes,) int64 below 2**32)``.  The unused tail of
  ``words`` holds exactly what the reference's buffer holds.

K7 returns its symbols and K8 its words as the transposed view of an
``(n_sym, n_lanes)`` buffer, which they write coalesced; the plain versions
keep the reference's layouts (symbols step-major, words lane-major).  Each
``*_cuda`` wrapper checks its inputs, launches on the current stream of the
tensors' card, raises on a launch error and counts its launches in
``.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import check, load_library

__all__ = [
    "RANS_L",
    "rans_decode_cuda",
    "rans_decode_plain",
    "rans_encode_cuda",
    "rans_encode_plain",
]

RANS_L = 1 << 16  # lower bound of the normalized state interval


def _table_bases(tables, table_idx: torch.Tensor):
    t = table_idx.to(torch.int64)
    A = tables.freqs.shape[-1]
    return t * A, t * (A + 1), t << tables.precision


# ---------------------------------------------------------------------------
# K7: decode
# ---------------------------------------------------------------------------


def rans_decode_plain(words, n_words, state, table_idx, tables, n_sym: int):
    """Decode ``n_sym`` symbols a lane; see the module's contract."""
    n_lanes = words.shape[0]
    words = words.to(torch.int64) & 0xFFFF
    words = words if words.shape[1] else words.new_zeros((n_lanes, 1))
    x = state.to(torch.int64) & 0xFFFFFFFF
    ptr = n_words.to(torch.int64) - 1
    k = tables.precision
    M = 1 << k
    freqs_flat = tables.freqs.reshape(-1)
    cums_flat = tables.cums.reshape(-1)
    s2s_flat = tables.slot2sym.reshape(-1)
    t_base_f, t_base_c, t_base_m = _table_bases(tables, table_idx)

    out = torch.empty((n_sym, n_lanes), dtype=torch.int32, device=words.device)
    for i in range(n_sym):
        slot = x & (M - 1)
        s = s2s_flat[t_base_m + slot].to(torch.int64)
        f = freqs_flat[t_base_f + s]
        c = cums_flat[t_base_c + s]
        x = f * (x >> k) + slot - c
        need = x < RANS_L
        word = torch.gather(words, 1, ptr.clamp_min(0)[:, None])[:, 0]
        x = torch.where(need, (x << 16) | word, x)
        ptr -= need.to(torch.int64)
        out[i] = s.to(torch.int32)
    return out.T, x, ptr  # symbols (n_lanes, n_sym) in forward order


def _check_tables(name, tables, dev, need_slot2sym):
    k = tables.precision
    if not 1 <= k <= 14:
        raise ValueError(f"{name}: precision must lie in 1..14, got {k}")
    freqs, cums, s2s = tables.freqs, tables.cums, tables.slot2sym
    if freqs.dtype != torch.int64 or cums.dtype != torch.int64 or s2s.dtype != torch.int16:
        raise TypeError(f"{name}: freqs and cums must be int64 and slot2sym int16, got "
                        f"{freqs.dtype}, {cums.dtype} and {s2s.dtype}")
    n_t, A = freqs.shape
    shapes = [(cums, (n_t, A + 1))] + ([(s2s, (n_t, 1 << k))] if need_slot2sym else [])
    for t, want in shapes:
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: table of shape {tuple(t.shape)}, want {want} beside freqs {(n_t, A)}")
    _check_device(name, dev, freqs, cums, *([s2s] if need_slot2sym else []))


def _check_device(name, dev, *tensors):
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: every input must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _check_lane_vector(name, what, t, n_lanes):
    if t.dtype != torch.int32 or tuple(t.shape) != (n_lanes,):
        raise TypeError(f"{name}: {what} must be an ({n_lanes},) int32 tensor, got {t.dtype} {tuple(t.shape)}")


def rans_decode_cuda(words, n_words, state, table_idx, tables, n_sym: int):
    """K7 on the card; same contract (symbol for symbol) as :func:`rans_decode_plain`."""
    if words.dtype != torch.int16 or words.ndim != 2:
        raise TypeError(f"rans_decode: words must be a 2-d int16 tensor, got {words.dtype} {tuple(words.shape)}")
    n_lanes, cap = words.shape
    for what, t in (("n_words", n_words), ("state", state), ("table_idx", table_idx)):
        _check_lane_vector("rans_decode", what, t, n_lanes)
    dev = words.device
    _check_device("rans_decode", dev, words, n_words, state, table_idx)
    _check_tables("rans_decode", tables, dev, need_slot2sym=True)
    if n_sym < 0:
        raise ValueError(f"rans_decode: n_sym must be >= 0, got {n_sym}")
    if cap == 0:  # the plain version's one zero column, never a valid word
        words, cap = words.new_zeros((n_lanes, 1)), 1
    out = torch.empty((n_sym, n_lanes), dtype=torch.int32, device=dev)
    x = torch.empty((n_lanes,), dtype=torch.int64, device=dev)
    ptr = torch.empty((n_lanes,), dtype=torch.int64, device=dev)
    if n_lanes == 0:
        return out.T, x, ptr
    with torch.cuda.device(dev):  # the launch runs on the tensors' card
        check(load_library().rans_decode(
            words.data_ptr(), cap, n_words.data_ptr(), state.data_ptr(), table_idx.data_ptr(),
            tables.freqs.data_ptr(), tables.cums.data_ptr(), tables.slot2sym.data_ptr(),
            tables.freqs.shape[1], tables.precision, n_lanes, n_sym,
            out.data_ptr(), x.data_ptr(), ptr.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        ), "rans_decode")
    rans_decode_cuda.launches += 1
    return out.T, x, ptr


rans_decode_cuda.launches = 0


# ---------------------------------------------------------------------------
# K8: encode
# ---------------------------------------------------------------------------


def rans_encode_plain(symbols, table_idx, tables):
    """Encode ``symbols[(lane, t)]``; see the module's contract."""
    n_lanes, n_sym = symbols.shape
    dev = symbols.device
    k = tables.precision
    freqs_flat = tables.freqs.reshape(-1)
    cums_flat = tables.cums.reshape(-1)
    t_base_f, t_base_c, _ = _table_bases(tables, table_idx)
    # rANS encodes in reverse symbol order so the decoder runs forward.
    xs = torch.flip(symbols.to(torch.int64).T, dims=(0,)).contiguous()  # (n_sym, n_lanes)
    x_bound = (RANS_L >> k) << 16

    x = torch.full((n_lanes,), RANS_L, dtype=torch.int64, device=dev)
    ptr = torch.zeros((n_lanes, 1), dtype=torch.int64, device=dev)
    buf = torch.zeros((n_lanes, max(n_sym, 1)), dtype=torch.int32, device=dev)
    for i in range(n_sym):
        s = xs[i]
        f = freqs_flat[t_base_f + s]
        c = cums_flat[t_base_c + s]
        # renormalize: emit one 16-bit word if x would overflow; the word is
        # written at ptr either way (the reference's buffer does the same)
        emit = x >= x_bound * f
        buf.scatter_(1, ptr, (x & 0xFFFF).to(torch.int32)[:, None])
        ptr += emit[:, None]
        x = torch.where(emit, x >> 16, x)
        # C(s, x) = (x // f) << k + (x % f) + c
        q = torch.div(x, f, rounding_mode="floor")
        x = (q << k) + (x - q * f) + c
    return buf[:, :n_sym], ptr[:, 0].to(torch.int32), x


def rans_encode_cuda(symbols, table_idx, tables):
    """K8 on the card; same contract (word for word) as :func:`rans_encode_plain`."""
    if symbols.dtype != torch.int32 or symbols.ndim != 2:
        raise TypeError(f"rans_encode: symbols must be a 2-d int32 tensor, got {symbols.dtype} "
                        f"{tuple(symbols.shape)}")
    n_lanes, n_sym = symbols.shape
    _check_lane_vector("rans_encode", "table_idx", table_idx, n_lanes)
    dev = symbols.device
    _check_device("rans_encode", dev, symbols, table_idx)
    _check_tables("rans_encode", tables, dev, need_slot2sym=False)
    buf = torch.zeros((max(n_sym, 1), n_lanes), dtype=torch.int32, device=dev)
    n_words = torch.empty((n_lanes,), dtype=torch.int32, device=dev)
    x = torch.empty((n_lanes,), dtype=torch.int64, device=dev)
    if n_lanes == 0:
        return buf[:n_sym].T, n_words, x
    with torch.cuda.device(dev):  # the launch runs on the tensors' card
        check(load_library().rans_encode(
            symbols.data_ptr(), table_idx.data_ptr(), tables.freqs.data_ptr(), tables.cums.data_ptr(),
            tables.freqs.shape[1], tables.precision, n_lanes, n_sym,
            buf.data_ptr(), n_words.data_ptr(), x.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        ), "rans_encode")
    rans_encode_cuda.launches += 1
    return buf[:n_sym].T, n_words, x


rans_encode_cuda.launches = 0
