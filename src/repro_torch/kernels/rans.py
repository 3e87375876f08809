"""K7/K8: the lane-parallel rANS coder's two scans, decode and encode.

``rans_decode`` (K7) replaces ``src/repro/core/rans.py:_decode_impl`` and
``rans_encode`` (K8) replaces ``src/repro/core/rans.py:_encode_impl``: the
jitted ``lax.scan`` over all lanes that the reference runs on its device
between the wire and K1/K2 (load path) and between K5 and the wire (store
path).  On the card each lane is one CUDA thread with its table's cum row
staged in shared memory (``csrc/rans.cu``; see its head for what bounds the
kernels on the H100 and how the design answers it); alphabets whose staged
rows do not fit a block run on the wide kernels: K7 stages each lane's row
as a bitmap of its symbols' starts (2**k bits whatever the alphabet;
:func:`bitmap_symbol` is its search on it), K8 reads each lane's cum row
in device memory.  Each ``*_plain``
function is the same scan as a Python loop of elementwise PyTorch ops over
all lanes, one step per symbol, with the reference's own table reads
(``slot2sym``, ``freqs``, ``cums``): the CPU's route and the kernels' oracle
on the card.  :func:`guided_symbol` is the staged K7's slot -> symbol
search on the cum row and :func:`bitmap_symbol` the wide K7's, written in
torch for the CPU tests.  ``kernels.ops`` picks between
the routes by the tables' device; ``core.rans.decode_payload`` / ``decode``
/ ``encode`` call it.

Contracts, the same for both routes (``tables`` is a ``core.rans.CoderTables``:
``freqs (n_tables, A)`` and ``cums (n_tables, A + 1)`` int64, ``slot2sym
(n_tables, 2**k)`` int16, ``precision`` k <= 14, each row a valid table:
``cums`` rises from 0 to 2**k and ``freqs`` are its differences; the
kernels read ``cums`` alone):

* decode: the wire's compact stream, ``payload (n_words_total,)`` int16
  (all lanes' valid ``uint16`` words, lane-major, as their bits;
  ``core.rans.wire_bits``), ``n_words (n_lanes,)`` int32, ``offsets
  (n_lanes,)`` int64 (where each lane's words start in ``payload``: the
  exclusive cumsum of ``n_words``, negative counts as 0), ``state
  (n_lanes,)`` int32 (the ``uint32`` states' bits, read as unsigned),
  ``table_idx (n_lanes,)`` int32 -> ``(symbols (n_lanes, n_sym) int32, x
  (n_lanes,) int64, ptr (n_lanes,) int64)``: each lane's final state and
  word pointer, which a well-formed stream leaves at ``2**16`` and -1.  A
  lane whose pointer has run out reads its first word, or 0 if it has none:
  what ``bitstream.unpack_stream``'s padded matrix holds in its column 0,
  so both routes equal the reference's ``_decode_impl`` on that matrix for
  every stream, corrupt ones included.
* encode: ``symbols (n_lanes, n_sym)`` int32 in ``[0, A)``, ``table_idx
  (n_lanes,)`` int32 -> ``(words (n_lanes, n_sym) int32 holding 16-bit
  values, n_words (n_lanes,) int32, x (n_lanes,) int64 below 2**32)``.  The
  unused tail of ``words`` holds exactly what the reference's buffer holds.

K7 returns its symbols as the transposed view of an ``(n_sym, n_lanes)``
buffer, which it writes coalesced, as the plain version does (the
reference's scan stacks them step-major too).  Each ``*_cuda`` wrapper
checks its inputs, launches on the current stream of the tensors' card
with ``BLOCK_LANES`` lanes a block, raises on a launch error and counts its
launches in ``.launches``; :func:`kernel_info` reads a kernel's registers,
shared memory and blocks an SM.

Two kernels a direction, picked by the alphabet ``A`` alone
(:func:`decode_kernel` / :func:`encode_kernel`, which ``kernels.ops``
calls): the staged ones (``rans_decode_cuda``, ``rans_encode_cuda``) while
a block's staged rows fit its shared memory, ``A <=
MAX_ALPHABET["decode"]`` (1,743) for K7 and ``MAX_ALPHABET["encode"]``
(1,807) for K8, and the wide ones (``rans_decode_wide_cuda``,
``rans_encode_wide_cuda``, each with its own launch count) for any
alphabet up to ``2**k``, as the reference's tables allow.  The staged
wrappers raise past their cap; the wide ones take any alphabet, below the
cap too.  The codec's widest alphabet, the alphabet-padded delta decode
stack, is ``max(2 * delta_qmax + 1, 509)``: 509 at the default
``delta_qmax``, 2,047 (wide) at 1023.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import check, load_library

__all__ = [
    "BLOCK_LANES",
    "MAX_ALPHABET",
    "RANS_L",
    "bitmap_symbol",
    "decode_kernel",
    "encode_kernel",
    "guided_symbol",
    "kernel_info",
    "rans_decode_cuda",
    "rans_decode_plain",
    "rans_decode_wide_cuda",
    "rans_encode_cuda",
    "rans_encode_plain",
    "rans_encode_wide_cuda",
]

RANS_L = 1 << 16  # lower bound of the normalized state interval
BLOCK_LANES = 64  # lanes (threads) a block of K7 and K8 (csrc/rans.cu kLanes)
GUIDE_BUCKETS = 64  # K7's guide: slot buckets a lane (csrc/rans.cu kBuckets)
_MAX_SMEM = 232448  # shared memory a block can use on the H100


def _row_stride(A: int) -> int:
    return (A + 1 + 7) & ~7


def _smem_bytes(kind: str, A: int) -> int:
    if kind == "decode":  # 8 entries past the row: the window's reach
        return BLOCK_LANES * (_row_stride(A) + 8 + GUIDE_BUCKETS) * 2
    return BLOCK_LANES * _row_stride(A) * 2 + BLOCK_LANES * 4


# the widest alphabet each kernel's block of staged rows fits
MAX_ALPHABET = {kind: max(A for A in range(1, 1 << 12) if _smem_bytes(kind, A) <= _MAX_SMEM)
                for kind in ("decode", "encode")}


# ---------------------------------------------------------------------------
# K7's slot -> symbol search
# ---------------------------------------------------------------------------


def guided_symbol(cums: torch.Tensor, slots: torch.Tensor, k: int) -> torch.Tensor:
    """K7's search, as the kernel runs it: for cum rows ``(n, A + 1)`` and
    slots ``(n, m)``, the largest ``s`` with ``c[s] <= slot`` -> ``(n, m)``
    int64.  The slot's bucket's guide entry ``lo`` places a window of 16
    entries at the 8-entry boundary at or before it (entries past the row
    read as 0xFFFF); the answer is the window's last entry ``<= slot``,
    unless that is the window's last entry, when the window moves 8 entries
    on."""
    n, A = cums.shape[0], cums.shape[1] - 1
    shift = max(k - 6, 0)
    # the guide: bucket b (from slot b << shift) -> the first s < A with
    # c[s + 1] past its first slot, A - 1 where the row never passes it
    starts = torch.arange((1 << k) >> shift, device=cums.device, dtype=cums.dtype) << shift
    guide = torch.searchsorted(cums[:, 1:].contiguous(), starts.expand(n, -1).contiguous(), right=True)
    R = _row_stride(A) + 8
    row = torch.cat([cums, cums.new_full((n, R - A - 1), 0xFFFF)], dim=1)
    a = torch.gather(guide.clamp(max=A - 1), 1, slots >> shift) & ~7
    window = torch.arange(16, device=cums.device)
    while True:
        e = torch.gather(row, 1, (a[..., None] + window).reshape(n, -1)).reshape(*a.shape, 16)
        j = (e <= slots[..., None]).sum(-1) - 1
        more = j == 15
        if not bool(more.any()):
            return a + j
        a = torch.where(more, a + 8, a)


def bitmap_symbol(cums: torch.Tensor, slots: torch.Tensor, k: int):
    """The wide K7's search, as the kernel runs it: for cum rows ``(n, A +
    1)`` and slots ``(n, m)`` -> ``(s, c[s], c[s + 1])``, each ``(n, m)``
    int64.  A row is a bitmap of the starts c[j] of its symbols with f > 0,
    in words of 64 slots, each with the starts before it (rank), the last
    start before it (prev) and the first start after it (next, 2**k if
    none); ``s`` is rank plus the starts <= slot in its word, less one, c[s]
    the last start <= slot (or prev), c[s + 1] the first start > slot (or
    next).  A row with a zero-frequency symbol before a start (c[j] = c[j +
    1] < 2**k) is searched on its cum row instead: the largest ``s < A``
    with ``c[s] <= slot``."""
    n, A = cums.shape[0], cums.shape[1] - 1
    M = 1 << k
    nw = max(M >> 6, 1)
    c0, c1 = cums[:, :-1], cums[:, 1:]
    starts = c0 < c1
    searched = ((c0 == c1) & (c0 < M)).any(1)
    marks = torch.zeros((n, nw * 64), dtype=torch.bool, device=cums.device)
    rows = torch.arange(n, device=cums.device)[:, None].expand(n, A)
    marks[rows[starts], c0[starts]] = True
    words = marks.view(n, nw, 64)
    counts = words.sum(-1)
    rank = counts.cumsum(1) - counts
    pos = torch.arange(nw * 64, device=cums.device).view(1, nw, 64)
    last = torch.where(words, pos, -1).amax(-1)  # (n, nw): the word's last start, -1 if none
    prev = torch.cat([last.new_zeros(n, 1), last.cummax(1).values[:, :-1]], 1).clamp_min(0)
    first = torch.where(words, pos, M).amin(-1)
    nxt = torch.cat([first.flip(1).cummin(1).values.flip(1)[:, 1:], first.new_full((n, 1), M)], 1)
    w, t = slots >> 6, slots & 63
    wb = torch.gather(words, 1, w[..., None].expand(*w.shape, 64))  # (n, m, 64)
    lane = torch.arange(64, device=cums.device)
    le = wb & (lane <= t[..., None])
    gt = wb & ~le
    s = torch.gather(rank, 1, w) + le.sum(-1) - 1
    cs = torch.where(le.any(-1), (slots & ~63) + torch.where(le, lane, -1).amax(-1), torch.gather(prev, 1, w))
    cn = torch.where(gt.any(-1), (slots & ~63) + torch.where(gt, lane, 64).amin(-1), torch.gather(nxt, 1, w))
    found = (cums[:, None, :A] <= slots[..., None]).sum(-1) - 1
    s = torch.where(searched[:, None], found, s)
    cs = torch.where(searched[:, None], torch.gather(cums, 1, found), cs)
    cn = torch.where(searched[:, None], torch.gather(cums, 1, found + 1), cn)
    return s, cs, cn


def _table_bases(tables, table_idx: torch.Tensor):
    t = table_idx.to(torch.int64)
    A = tables.freqs.shape[-1]
    return t * A, t * (A + 1), t << tables.precision


# ---------------------------------------------------------------------------
# K7: decode
# ---------------------------------------------------------------------------


def rans_decode_plain(payload, n_words, offsets, state, table_idx, tables, n_sym: int):
    """Decode ``n_sym`` symbols a lane from the compact stream; see the
    module's contract."""
    n_lanes = n_words.shape[0]
    dev = n_words.device
    # one zero past the payload: the word of a lane with none
    words = torch.cat([payload.reshape(-1).to(torch.int64) & 0xFFFF, torch.zeros(1, dtype=torch.int64, device=dev)])
    nw = n_words.to(torch.int64)
    off = offsets.to(torch.int64)
    run_out = torch.where(nw > 0, off, words.shape[0] - 1)  # the padded matrix's column 0
    x = state.to(torch.int64) & 0xFFFFFFFF
    ptr = nw - 1
    k = tables.precision
    M = 1 << k
    freqs_flat = tables.freqs.reshape(-1)
    cums_flat = tables.cums.reshape(-1)
    s2s_flat = tables.slot2sym.reshape(-1)
    t_base_f, t_base_c, t_base_m = _table_bases(tables, table_idx)

    out = torch.empty((n_sym, n_lanes), dtype=torch.int32, device=dev)
    for i in range(n_sym):
        slot = x & (M - 1)
        s = s2s_flat[t_base_m + slot].to(torch.int64)
        f = freqs_flat[t_base_f + s]
        c = cums_flat[t_base_c + s]
        x = f * (x >> k) + slot - c
        need = x < RANS_L
        word = words[torch.where(ptr >= 0, off + ptr, run_out)]
        x = torch.where(need, (x << 16) | word, x)
        ptr -= need.to(torch.int64)
        out[i] = s.to(torch.int32)
    return out.T, x, ptr  # symbols (n_lanes, n_sym) in forward order


def _check_tables(name, tables, dev, kind, wide=False):
    """Raise unless ``tables`` are what the kernel reads: int64 ``cums`` on
    ``dev``, an alphabet up to ``2**k``, and for a staged kernel up to its
    ``MAX_ALPHABET``."""
    k = tables.precision
    if not 1 <= k <= 14:
        raise ValueError(f"{name}: precision must lie in 1..14, got {k}")
    freqs, cums = tables.freqs, tables.cums
    if freqs.dtype != torch.int64 or cums.dtype != torch.int64:
        raise TypeError(f"{name}: freqs and cums must be int64, got {freqs.dtype} and {cums.dtype}")
    n_t, A = freqs.shape
    if tuple(cums.shape) != (n_t, A + 1):
        raise ValueError(f"{name}: cums of shape {tuple(cums.shape)}, want {(n_t, A + 1)} beside freqs {(n_t, A)}")
    _check_device(name, dev, cums)
    if not 1 <= A <= 1 << k:
        raise ValueError(f"{name}: alphabet {A} outside 1..2**{k}")
    if not wide and A > MAX_ALPHABET[kind]:
        raise ValueError(f"{name}: alphabet {A} is wider than the {MAX_ALPHABET[kind]} symbols whose staged rows "
                         "fit a block's shared memory (the wide kernel takes it)")


def _check_device(name, dev, *tensors):
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: every input must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _check_lane_vector(name, what, t, n_lanes, dtype=torch.int32):
    if t.dtype != dtype or tuple(t.shape) != (n_lanes,):
        raise TypeError(f"{name}: {what} must be an ({n_lanes},) {dtype} tensor, got {t.dtype} {tuple(t.shape)}")


def _decode_on_card(payload, n_words, offsets, state, table_idx, tables, n_sym: int, wide: bool):
    """Check K7's inputs and launch its staged or wide kernel."""
    name = "rans_decode_wide" if wide else "rans_decode"
    if payload.dtype != torch.int16 or payload.ndim != 1:
        raise TypeError(f"{name}: payload must be a 1-d int16 tensor, got {payload.dtype} "
                        f"{tuple(payload.shape)}")
    n_lanes = n_words.shape[0]
    for what, t in (("n_words", n_words), ("state", state), ("table_idx", table_idx)):
        _check_lane_vector(name, what, t, n_lanes)
    _check_lane_vector(name, "offsets", offsets, n_lanes, torch.int64)
    dev = n_words.device
    _check_device(name, dev, payload, n_words, offsets, state, table_idx)
    _check_tables(name, tables, dev, "decode", wide)
    if n_sym < 0:
        raise ValueError(f"{name}: n_sym must be >= 0, got {n_sym}")
    out = torch.empty((n_sym, n_lanes), dtype=torch.int32, device=dev)
    x = torch.empty((n_lanes,), dtype=torch.int64, device=dev)
    ptr = torch.empty((n_lanes,), dtype=torch.int64, device=dev)
    if n_lanes == 0:
        return out.T, x, ptr
    lib = load_library()
    with torch.cuda.device(dev):  # the launch runs on the tensors' card
        check(getattr(lib, name)(
            payload.data_ptr(), n_words.data_ptr(), offsets.data_ptr(), state.data_ptr(), table_idx.data_ptr(),
            tables.cums.data_ptr(), tables.freqs.shape[1], tables.precision, n_lanes, n_sym,
            out.data_ptr(), x.data_ptr(), ptr.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        ), name)
    (rans_decode_wide_cuda if wide else rans_decode_cuda).launches += 1
    return out.T, x, ptr


def rans_decode_cuda(payload, n_words, offsets, state, table_idx, tables, n_sym: int):
    """K7's staged kernel on the card (``A <= MAX_ALPHABET["decode"]``); same
    contract (symbol for symbol) as :func:`rans_decode_plain`."""
    return _decode_on_card(payload, n_words, offsets, state, table_idx, tables, n_sym, wide=False)


def rans_decode_wide_cuda(payload, n_words, offsets, state, table_idx, tables, n_sym: int):
    """K7's wide kernel on the card (any alphabet up to ``2**k``: each lane's
    cum row staged as a bitmap of its symbols' starts, :func:`bitmap_symbol`);
    same contract (symbol for symbol) as :func:`rans_decode_plain`."""
    return _decode_on_card(payload, n_words, offsets, state, table_idx, tables, n_sym, wide=True)


rans_decode_cuda.launches = 0
rans_decode_wide_cuda.launches = 0


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
    buf = torch.zeros((n_lanes, n_sym), dtype=torch.int32, device=dev)
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
    return buf, ptr[:, 0].to(torch.int32), x


def _encode_on_card(symbols, table_idx, tables, wide: bool):
    """Check K8's inputs and launch its staged or wide kernel."""
    name = "rans_encode_wide" if wide else "rans_encode"
    if symbols.dtype != torch.int32 or symbols.ndim != 2:
        raise TypeError(f"{name}: symbols must be a 2-d int32 tensor, got {symbols.dtype} "
                        f"{tuple(symbols.shape)}")
    n_lanes, n_sym = symbols.shape
    _check_lane_vector(name, "table_idx", table_idx, n_lanes)
    dev = symbols.device
    _check_device(name, dev, symbols, table_idx)
    _check_tables(name, tables, dev, "encode", wide)
    words = torch.empty((n_lanes, n_sym), dtype=torch.int32, device=dev)  # the kernel writes every element
    n_words = torch.empty((n_lanes,), dtype=torch.int32, device=dev)
    x = torch.empty((n_lanes,), dtype=torch.int64, device=dev)
    if n_lanes == 0:
        return words, n_words, x
    with torch.cuda.device(dev):  # the launch runs on the tensors' card
        check(getattr(load_library(), name)(
            symbols.data_ptr(), table_idx.data_ptr(), tables.cums.data_ptr(), tables.freqs.shape[1],
            tables.precision, n_lanes, n_sym, words.data_ptr(), n_words.data_ptr(), x.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        ), name)
    (rans_encode_wide_cuda if wide else rans_encode_cuda).launches += 1
    return words, n_words, x


def rans_encode_cuda(symbols, table_idx, tables):
    """K8's staged kernel on the card (``A <= MAX_ALPHABET["encode"]``); same
    contract (word for word) as :func:`rans_encode_plain`."""
    return _encode_on_card(symbols, table_idx, tables, wide=False)


def rans_encode_wide_cuda(symbols, table_idx, tables):
    """K8's wide kernel on the card (any alphabet up to ``2**k``: c[s] and
    c[s + 1] read from the lane's cum row in device memory); same contract
    (word for word) as :func:`rans_encode_plain`."""
    return _encode_on_card(symbols, table_idx, tables, wide=True)


rans_encode_cuda.launches = 0
rans_encode_wide_cuda.launches = 0


def decode_kernel(alphabet: int):
    """K7's kernel for tables of ``alphabet`` symbols: the staged one while
    its rows fit a block, else the wide one."""
    return rans_decode_cuda if alphabet <= MAX_ALPHABET["decode"] else rans_decode_wide_cuda


def encode_kernel(alphabet: int):
    """K8's kernel for tables of ``alphabet`` symbols: the staged one while
    its rows fit a block, else the wide one."""
    return rans_encode_cuda if alphabet <= MAX_ALPHABET["encode"] else rans_encode_wide_cuda


def kernel_info(kind: str, alphabet: int, device=None, wide: bool = False, precision: int = 12) -> dict:
    """K7's (``kind="decode"``) or K8's registers a thread, shared memory a
    block (bytes), blocks an SM, spilled bytes a thread and lanes a block at
    ``alphabet`` and ``precision``, staged or ``wide``, as the CUDA runtime
    reports them for the current card."""
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        check(load_library().rans_kernel_info(int(kind == "decode"), int(wide), alphabet, precision, out),
              "rans_kernel_info")
    return dict(registers=out[0], smem_bytes=out[1], blocks_per_sm=out[2], spill_bytes=out[3],
                lanes_per_block=out[4], lanes_per_sm=out[2] * out[4])
