// Lane-parallel static-table rANS coder for the CacheGen codec (Hopper, sm_90a).
//
// K7 rans_decode replaces src/repro/core/rans.py:110 _decode_impl (a jitted lax.scan)
// K8 rans_encode replaces src/repro/core/rans.py:65  _encode_impl (a jitted lax.scan)
// Each has two kernels, picked by the alphabet alone (kernels/rans.py): the
// staged one below for A <= 1,743 (K7) or 1,807 (K8), and a wide one for
// any alphabet up to 2^k (rans_decode_wide_kernel, rans_encode_wide_kernel).
//
// The reference runs each direction as one vectorized scan over all lanes; a
// lane is one (layer, K/V, channel) stream with its own static distribution.
// Here each lane is one thread, the GPU coder design CacheGen describes ("one
// CUDA thread per bitstream"): the thread walks its lane's symbols in order
// (K7) or in reverse (K8) with its 32-bit state in a register.  The variant
// is ryg_rans' "rans_word": 32-bit state, 16-bit renormalization, precision
// k <= 14, so a step emits or consumes at most one word and does fixed work.
// State arithmetic is uint32 and exact: f * (x >> k) + slot - c < 2^32 in the
// decoder, and the encoder's (q << k) + r + c < 2^32.  The encoder's overflow
// test x >= 2^(32 - k) * f is taken as (x >> (32 - k)) >= f, which is the
// same test for integers and needs no 64-bit product (a symbol holding all
// 2^k slots gives 2^32, which x never reaches).
//
// What bounds them on the H100, and the design.  A step needs only its
// lane's cum row: f[s] = c[s + 1] - c[s], and the decoder's slot -> symbol
// map is "the largest s with c[s] <= slot".  A row is A + 1 entries (257 for
// anchors, 256 for lossy deltas, 510 for the alphabet-padded decode stack),
// every one <= 2^k <= 2^14, so as uint16 it is at most 1,020 bytes.  The
// tables themselves are per lane and far larger than the 50 MB L2 (smollm-
// 360m: 20,480 tables a set; slot2sym alone is 8 KB a table at k = 12), so
// the first design, which gathered slot2sym, then freqs and cums, from them
// every step, waited on scattered HBM sectors.  Here:
//   * each block stages its lanes' cum rows once, narrowed to uint16, into
//     shared memory (stage_rows: a warp a row, 16-byte loads, eight in
//     flight a thread), and the whole scan reads c[s] and c[s + 1] there.
//     Neither kernel reads slot2sym or freqs.  Where two lanes share a
//     table, each stages its own copy.  After the load the only device
//     memory traffic is the stream itself: K7 its words and the symbols it
//     writes, K8 the symbols it reads and the words it writes.  Those bytes
//     are not what bounds the kernels now: each lane's steps are a chain of
//     dependent shared-memory reads and integer operations, so a kernel's
//     time is (lanes an SM / lanes resident) rounds of (steps x the chain's
//     latency), and the SM's issue slots and memory stay mostly idle;
//   * shared memory sets how many lanes are resident.  A block is kLanes =
//     64 lanes, chosen by measurement against 32 and 128 (PERF.md): K7's
//     block on the decode stack takes 74,752 bytes, so an SM holds three
//     (192 lanes) and a smollm-360m wave's 81,920 delta lanes run in 3.2
//     rounds; on the anchor stack five blocks, K8 on the lossy deltas six.
//     32 lanes a block hold no more lanes an SM, 128 hold fewer.  The
//     staged row caps the alphabet a launch takes: A <= 1,743 for K7 and
//     1,807 for K8 (a block's 227 KB);
//   * K7 finds the slot's symbol with two shared-memory reads on the chain:
//     a per-lane guide (kBuckets entries, built from the staged row: the
//     symbol at the start of each slot bucket) gives lo, and the 16 entries
//     from the 16-byte boundary at or before lo come in as two 16-byte
//     reads, issued together.  The window is halved in registers (compare,
//     select) down to the largest entry <= slot, which gives c[s] and c[s +
//     1] at once.  Where the answer is the window's last entry, the window
//     moves 8 entries on (a bucket holds more symbols than it covers); entries
//     past the row hold 0xFFFF, above every slot, so the search never leaves
//     the row.  Zero-frequency symbols (the decode stack's alphabet padding
//     repeats c) are never "the largest s with c[s] <= slot" unless they
//     precede the one symbol with f > 0 that holds the slot, so the rule
//     gives slot2sym's answer on every slot, as np.repeat builds it;
//   * K7 reads the wire's compact payload (all lanes' valid words,
//     lane-major) at per-lane offsets, so the host pads nothing; the word at
//     ptr is loaded at the start of a step, beside the slot's search, and
//     used at its end.  A lane whose pointer has run out (ptr < 0: only a
//     corrupt stream, or a lane decoding past its stream's symbols) reads
//     what the reference's padded matrix holds in its column 0: its first
//     word, or 0 for a lane with no word;
//   * K8's step reads its symbol and two staged entries, none of them on
//     the state's chain: the symbols come 16 bytes (four steps) at a time,
//     alternating between two registers each loaded eight steps before it
//     is coded (a copy between registers would wait on the load in flight),
//     so the chain is the compare, the shift, the 32-bit division and the
//     multiply-add.  The emit is branch-free (selects and predicated
//     stores), which lets the compiler start the division's reciprocal of f
//     before the state is known.  The division stays the hardware's `/`: no
//     trace says it sets the time;
//   * K8 writes only what the reference's buffer keeps: each emitted word at
//     its ptr and, after the loop, the last step's word at the final ptr
//     when that step did not emit (a position below the final ptr keeps
//     only its emitting step's word, and nothing writes above it).  The
//     words gather in four registers and leave as 16-byte stores into the
//     lane's own row of a lane-major (n_lanes, n_sym) buffer (the few before
//     the row's first 16-byte boundary one by one); the block then zeroes
//     each row's rest with coalesced stores, so no memset precedes the
//     launch;
//   * K7 writes its symbols step-major, (n_sym, n_lanes), so a warp's stores
//     are coalesced; its wrapper returns the transposed view.
//
// The wide kernels take the alphabets whose staged rows do not fit a block
// (the codec's delta decode stack at delta_qmax 1023 has 2,047 symbols;
// tables allow up to 2^14 at precision 14).  One thread a lane, as above.
// K7 stages each lane's row once as a bitmap of its symbols' starts: 2^k
// bits whatever the alphabet, with ranks and the neighbouring starts a
// 64-slot word (see "the wide kernels" below), and finds the slot's symbol,
// c[s] and c[s + 1] by bit counts on one entry.  K8 reads c[s] and c[s + 1]
// from the lane's cum row in device memory; on the codec's own tables,
// which many lanes share, those gathers hit the caches, and it shares its
// step and its stores with the staged kernel.  Both keep every contract of
// the staged kernels (the compact payload and per-lane offsets, a lane past
// its words reading its first word or 0, K8's words and zeroed tail, 64-bit
// table offsets).
//
// Index width: table offsets are 64-bit.  A stacked delta decode of
// qwen2-moe-a2.7b holds 491,520 tables, whose last row starts at 491,519 *
// 510 * 8 = 2.005e9 bytes of cums, near 2^31; the tests hold a stack whose
// last row starts past 2^31 bytes.
//
// The wire's bits at their own width: words arrive as int16 and states as
// int32 tensors holding the wire's uint16 and uint32 bits; the kernels read
// them as unsigned.  Tables are valid rANS tables (each row's c rises from 0
// to 2^k, f = c[s + 1] - c[s]); symbols given to K8 lie in [0, A), and a
// symbol outside it is clamped into the row rather than read out of it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kRansL = 1u << 16;
constexpr int kLanes = 64;  // lanes (threads) a block of K7 and K8
constexpr int kWarps = kLanes / 32;
constexpr int kBuckets = 64;  // K7's guide: slot buckets a lane
constexpr int kStageUnroll = 8;  // 16-byte loads a thread keeps in flight while staging a row
constexpr int kMaxSmem = 232448;  // a block's shared memory on the H100

// uint16 entries a staged row takes: A + 1 rounded up to 16 bytes
__host__ __device__ inline int row_stride(int A) { return (A + 1 + 7) & ~7; }

// K7's rows: 8 entries more, so that its 16-entry window never leaves the row
__host__ __device__ inline int decode_stride(int A) { return row_stride(A) + 8; }

// a block's shared memory: its lanes' rows (and K7's guides, K8's row ends)
__host__ __device__ inline size_t decode_smem(int A) {
  return (size_t)kLanes * (decode_stride(A) + kBuckets) * sizeof(uint16_t);
}

__host__ __device__ inline size_t encode_smem(int A) {
  return (size_t)kLanes * row_stride(A) * sizeof(uint16_t) + (size_t)kLanes * sizeof(int);
}

// Stage the cum rows of lanes [base, base + kLanes) into rows (uint16, row
// stride R): warp w stages lanes w, w + kWarps, ...  A row of n = A + 1
// int64 entries is read as 16-byte pairs from the 16-byte boundary at or
// before its start; each thread issues kStageUnroll loads before it narrows
// and stores them.  An aligned 16-byte load that holds an entry of the row
// never leaves the row's page, and entries outside the row are not stored.
__device__ __forceinline__ void stage_rows(uint16_t* rows, int R, const long long* __restrict__ cums,
                                           const int* __restrict__ table_idx, int A, long long base,
                                           long long n_lanes) {
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int n = A + 1;
  for (int j = warp; j < kLanes && base + j < n_lanes; j += kWarps) {
    const long long* src = cums + (long long)table_idx[base + j] * n;
    const int head = (int)(((uintptr_t)src >> 3) & 1);  // entries before src in its 16-byte pair
    const longlong2* pairs = (const longlong2*)(src - head);
    const int n_pairs = (head + n + 1) >> 1;
    uint16_t* dst = rows + j * R;
    if (n + l < R) dst[n + l] = 0xFFFFu;  // past the row: above every slot
    for (int q0 = 0; q0 < n_pairs; q0 += 32 * kStageUnroll) {
      longlong2 v[kStageUnroll];
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int q = q0 + u * 32 + l;
        if (q < n_pairs) v[u] = __ldg(pairs + q);
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int q = q0 + u * 32 + l;
        const int e = 2 * q - head;
        if (q < n_pairs) {
          if (e >= 0) dst[e] = (uint16_t)v[u].x;
          if (e + 1 < n) dst[e + 1] = (uint16_t)v[u].y;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kLanes) rans_decode_kernel(
    const uint16_t* __restrict__ payload, const int* __restrict__ n_words, const long long* __restrict__ offsets,
    const uint32_t* __restrict__ state, const int* __restrict__ table_idx, const long long* __restrict__ cums,
    int A, int k, long long n_lanes, int n_sym, int* __restrict__ out, long long* __restrict__ x_out,
    long long* __restrict__ ptr_out) {
  extern __shared__ __align__(16) uint16_t smem[];
  const int R = decode_stride(A);
  const long long base = (long long)blockIdx.x * kLanes;
  stage_rows(smem, R, cums, table_idx, A, base, n_lanes);
  __syncthreads();
  const long long lane = base + threadIdx.x;
  if (lane >= n_lanes) return;
  const uint16_t* c = smem + threadIdx.x * R;
  uint16_t* guide = smem + kLanes * R + threadIdx.x * kBuckets;
  // the guide: bucket b starts at slot b << shift; its entry is the first s
  // with c[s + 1] > that slot (the largest s with c[s] <= it), A - 1 where
  // the row never passes it (no valid table)
  const int shift = k > 6 ? k - 6 : 0;
  const int nb = (1 << k) >> shift;
  {
    int b = 0;
    for (int s = 0; s < A && b < nb; ++s) {
      const uint32_t c1 = c[s + 1];
      for (; b < nb && ((uint32_t)b << shift) < c1; ++b) guide[b] = (uint16_t)s;
    }
    for (; b < nb; ++b) guide[b] = (uint16_t)(A - 1);
  }
  const uint32_t mask = (1u << k) - 1u;
  uint32_t x = state[lane];
  const int nw = n_words[lane];
  int ptr = nw - 1;
  const uint16_t* w = payload + offsets[lane];
  const uint32_t first = nw > 0 ? (uint32_t)__ldg(w) : 0u;  // the padded matrix's column 0
  int* o = out + lane;
  for (int i = 0; i < n_sym; ++i) {
    const uint32_t word = ptr >= 0 ? (uint32_t)__ldg(w + ptr) : first;
    const uint32_t slot = x & mask;
    const int b = (int)(slot >> shift);
    const int lo = guide[b];
    // the 16 entries from the 16-byte boundary at or before lo: c[a] <=
    // c[lo] <= slot, so the answer is a + j for the largest j with e[j] <=
    // slot, found by halving the window in registers (pairs P[i] = e[2i] |
    // e[2i + 1] << 16; entries past the row hold 0xFFFF).  Where it is the
    // window's last entry, the next entry is unknown: the window moves 8
    // entries on and the search runs again.
    int a = lo & ~7;
    uint32_t cs, c1;
    int j;
    for (;;) {
      uint4 v0, v1;  // both halves issued before either is compared
      const uint32_t at = (uint32_t)__cvta_generic_to_shared(c + a);
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];" : "=r"(v0.x), "=r"(v0.y), "=r"(v0.z), "=r"(v0.w) : "r"(at));
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(v1.x), "=r"(v1.y), "=r"(v1.z), "=r"(v1.w) : "r"(at + 16));
      bool u = (v1.x & 0xFFFFu) <= slot;  // 8 of 16
      uint32_t after = u ? 0xFFFFFFFFu : v1.x;  // the pair after the window half kept
      j = u ? 8 : 0;
      uint32_t p0 = u ? v1.x : v0.x, p1 = u ? v1.y : v0.y, p2 = u ? v1.z : v0.z, p3 = u ? v1.w : v0.w;
      u = (p2 & 0xFFFFu) <= slot;  // 4 of 8
      after = u ? after : p2;
      j += u ? 4 : 0;
      p0 = u ? p2 : p0;
      p1 = u ? p3 : p1;
      u = (p1 & 0xFFFFu) <= slot;  // 2 of 4
      after = u ? after : p1;
      j += u ? 2 : 0;
      p0 = u ? p1 : p0;
      u = (p0 >> 16) <= slot;  // 1 of 2
      j += u ? 1 : 0;
      cs = u ? p0 >> 16 : p0 & 0xFFFFu;
      c1 = u ? after & 0xFFFFu : p0 >> 16;
      if (c1 != 0xFFFFu) break;
      a += 8;
    }
    const int s = a + j;
    const uint32_t f = c1 - cs;
    x = f * (x >> k) + slot - cs;
    o[(long long)i * n_lanes] = s;
    if (x < kRansL) {
      x = (x << 16) | word;
      --ptr;
    }
  }
  x_out[lane] = x;
  ptr_out[lane] = ptr;
}

// K8's state between steps: the coder's state and word pointer, and the
// emitted words of the current 16-byte group of the lane's row, not yet
// stored (the newest in b3).  The words before the row's first 16-byte
// boundary (head of them) are stored one by one as they come.
struct Encoder {
  uint32_t x;
  int ptr;
  uint32_t b0, b1, b2, b3;
  uint32_t last;  // the last step's word
  bool emitted;   // whether the last step emitted
};

// a cum row's entry: staged (uint16 in shared memory) or in device memory
__device__ __forceinline__ uint32_t cum_at(const uint16_t* c, int s) { return c[s]; }
__device__ __forceinline__ uint32_t cum_at(const long long* c, int s) { return (uint32_t)__ldg(c + s); }

template <typename T>
__device__ __forceinline__ void encode_step(Encoder& e, int s, const T* c, int A, int k, int* row,
                                            unsigned long long row_elem, int head) {
  s = min(max(s, 0), A - 1);
  const uint32_t cs = cum_at(c, s);
  const uint32_t f = cum_at(c, s + 1) - cs;
  const uint32_t word = e.x & 0xFFFFu;
  const bool emit = (e.x >> (32 - k)) >= f;  // x >= 2^(32 - k) * f
  const bool grouped = e.ptr >= head;
  if (emit && !grouped) row[e.ptr] = (int)word;
  if (emit && grouped) {
    e.b0 = e.b1;
    e.b1 = e.b2;
    e.b2 = e.b3;
    e.b3 = word;
  }
  if (emit && grouped && ((row_elem + (unsigned long long)e.ptr) & 3) == 3)  // the word ends a 16-byte group
    *(int4*)(row + e.ptr - 3) = make_int4((int)e.b0, (int)e.b1, (int)e.b2, (int)e.b3);
  e.ptr += emit;
  const uint32_t x = emit ? e.x >> 16 : e.x;
  e.last = word;
  e.emitted = emit;
  const uint32_t q = x / f;
  e.x = (q << k) + (x - q * f) + cs;
}

// K8's block after its rows are in reach: each lane encodes its symbols
// over its cum row c (a valid pointer for lanes below n_lanes), then the
// block zeroes the rest of its rows; zero_from holds kLanes ints of shared
// memory
template <typename T>
__device__ __forceinline__ void encode_block(const T* c, const int* __restrict__ symbols, int A, int k,
                                             long long base, long long n_lanes, int n_sym,
                                             int* __restrict__ words, int* __restrict__ n_words,
                                             long long* __restrict__ x_out, int* zero_from) {
  const long long lane = base + threadIdx.x;
  if (lane < n_lanes) {
    int* row = words + lane * n_sym;
    const unsigned long long row_elem = (uintptr_t)row >> 2;
    const int* srow = symbols + lane * n_sym;
    const unsigned long long sym_elem = (uintptr_t)srow >> 2;
    Encoder e{kRansL, 0, 0u, 0u, 0u, 0u, 0u, true};
    const int head = (int)((4 - (row_elem & 3)) & 3);
    // rANS encodes in reverse symbol order so the decoder runs forward: one
    // step at a time until the symbols left end on a 16-byte boundary, then
    // four at a time, each four loaded two fours before they are coded
    auto four = [&](const int4& v) {
      encode_step(e, v.w, c, A, k, row, row_elem, head);
      encode_step(e, v.z, c, A, k, row, row_elem, head);
      encode_step(e, v.y, c, A, k, row, row_elem, head);
      encode_step(e, v.x, c, A, k, row, row_elem, head);
    };
    auto four_at = [&](int end) { return __ldg((const int4*)(srow + end - 3)); };
    int i = n_sym - 1;
    for (; i >= 0 && ((sym_elem + (unsigned long long)i + 1) & 3) != 0; --i) encode_step(e, __ldg(srow + i), c, A, k, row, row_elem, head);
    // the fours alternate between a and b, each loaded two fours before it
    // is coded (no register copies, so no wait on a load in flight)
    int g = (i + 1) >> 2;  // whole fours left
    int4 a = make_int4(0, 0, 0, 0), bq = a;
    if (g > 0) a = four_at(i);
    if (g > 1) bq = four_at(i - 4);
    for (; g >= 2; g -= 2, i -= 8) {
      four(a);
      if (g > 2) a = four_at(i - 8);
      four(bq);
      if (g > 3) bq = four_at(i - 12);
    }
    if (g == 1) {
      four(a);
      i -= 4;
    }
    for (; i >= 0; --i) encode_step(e, __ldg(srow + i), c, A, k, row, row_elem, head);
    {  // the words of the last, unfinished group
      const int m = e.ptr >= head ? (int)((row_elem + (unsigned long long)e.ptr) & 3) : 0;
      if (m > 2) row[e.ptr - 3] = (int)e.b1;
      if (m > 1) row[e.ptr - 2] = (int)e.b2;
      if (m > 0) row[e.ptr - 1] = (int)e.b3;
    }
    // the reference's buffer keeps the last step's word at the final ptr
    // when that step did not emit
    if (!e.emitted) row[e.ptr] = (int)e.last;
    zero_from[threadIdx.x] = e.ptr + (e.emitted ? 0 : 1);
    n_words[lane] = e.ptr;
    x_out[lane] = e.x;
  }
  __syncthreads();
  // the rest of each row is zero, as in the reference's buffer: a warp a
  // row, 16-byte stores between the row's scalar ends
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  for (int j = warp; j < kLanes && base + j < n_lanes; j += kWarps) {
    int* row = words + (base + j) * n_sym;
    const int from = zero_from[j];
    const int head = min(n_sym - from, (int)((4 - (((uintptr_t)(row + from) >> 2) & 3)) & 3));
    if (l < head) row[from + l] = 0;
    const int body = from + head;
    const int n4 = (n_sym - body) >> 2;
    int4* v = (int4*)(row + body);
    for (int q = l; q < n4; q += 32) v[q] = make_int4(0, 0, 0, 0);
    const int tail = body + 4 * n4;
    if (tail + l < n_sym) row[tail + l] = 0;
  }
}

__global__ void __launch_bounds__(kLanes) rans_encode_kernel(
    const int* __restrict__ symbols, const int* __restrict__ table_idx, const long long* __restrict__ cums,
    int A, int k, long long n_lanes, int n_sym, int* __restrict__ words, int* __restrict__ n_words,
    long long* __restrict__ x_out) {
  extern __shared__ __align__(16) uint16_t smem[];
  const int R = row_stride(A);
  int* zero_from = (int*)(smem + kLanes * R);  // where each row's zeros start
  const long long base = (long long)blockIdx.x * kLanes;
  stage_rows(smem, R, cums, table_idx, A, base, n_lanes);
  __syncthreads();
  encode_block(smem + threadIdx.x * R, symbols, A, k, base, n_lanes, n_sym, words, n_words, x_out, zero_from);
}

// ------------------------------------------------------ the wide kernels
// Past the staged caps a lane's cum row does not fit a block beside 63 others
// (2,047 symbols: 4 KB as uint16).  Read in device memory, a K7 step makes two
// dependent gathers (the slot's symbol, then c[s] and c[s + 1]).  But a row is
// a set of 2^k slots cut at its symbols' starts, so it fits in 2^k bits
// whatever the alphabet.  K7 stages each lane's row once as a bitmap of the
// starts of its symbols with f > 0, 64 slots a word, each word kept as one
// 16-byte entry {bits, rank | prev << 16, next}: its rank (the starts before
// it), prev (the last start before it) and next (the first start after it,
// 2^k if none).  A step reads the slot's entry (one shared-memory load) and
// takes s = rank + popc(starts <= slot) - 1, c[s] = the last start <= slot
// and c[s + 1] = the first start > slot by bit counts.  After the stage it
// reads no table in device memory, nor slot2sym or freqs.  A block is 64
// lanes (32 at k = 14, whose 4 KB rows would not fit 64); at k = 12 it takes
// 66,816 bytes, so an SM holds three, as the staged K7 on its 509-symbol
// rows.  The ranks count only symbols with f > 0, so a table with a
// zero-frequency symbol before a start (c[j] = c[j + 1] < 2^k: none of the
// codec's tables, which pad only past their alphabet, where c = 2^k) is
// flagged while it is staged, and its lane reads its cum row in device memory
// instead (a binary search, log2(A) dependent reads a step).
//
// The wide K8 gathers c[s] and c[s + 1] from the cum row in device memory.
// Its symbols are known in advance, and on the codec's tables (few, shared by
// many lanes) the gathers hit the caches; a bitmap staged per lane, searched
// over its ranks, made it 2.5x slower there, and gathers issued a four ahead
// were no faster (PERF.md).
__host__ __device__ inline int bitmap_words(int k) { return k > 6 ? 1 << (k - 6) : 1; }

// a lane's shared memory in K7: its entries (one more, so that lanes' rows
// fall in different banks) and its flag
__host__ __device__ inline size_t wide_decode_lane_smem(int k) { return (size_t)(bitmap_words(k) + 1) * 16 + 4; }

__host__ inline int wide_lanes(size_t lane_smem) { return kLanes * lane_smem <= (size_t)kMaxSmem ? kLanes : 32; }

// Mark the bitmaps of lanes [base, base + lanes), zeroed by the caller:
// lane j's 64-slot word w is the low half of entry ents[j * R + w] (two
// 32-bit words, low first), its flag at flag[j].  Warp w marks the rows
// of lanes w, w + warps, ...; its threads read the row as 16-byte pairs (as
// stage_rows does), each with the entry after its pair, and set bit c[e] of
// symbol e where c[e] < c[e + 1].  Ends with a barrier.
__device__ __forceinline__ void stage_bitmaps(uint4* ents, int R, int* flag,
                                              const long long* __restrict__ cums, const int* __restrict__ table_idx,
                                              int A, int k, long long base, long long n_lanes) {
  const int lanes = blockDim.x, warps = lanes / 32;
  const uint32_t M = 1u << k;
  const int wid = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int n = A + 1;
  for (int j = wid; j < lanes && base + j < n_lanes; j += warps) {
    const long long* src = cums + (long long)table_idx[base + j] * n;
    const int head = (int)(((uintptr_t)src >> 3) & 1);
    const longlong2* pairs = (const longlong2*)(src - head);
    const int n_pairs = (head + n + 1) >> 1;
    uint32_t* row = reinterpret_cast<uint32_t*>(ents + j * R);
    bool zero_f = false;
    auto mark = [&](int e, uint32_t ce, uint32_t cn) {
      if (e < 0 || e >= A) return;
      if (ce < cn)
        atomicOr(row + (ce >> 6) * 4 + ((ce >> 5) & 1), 1u << (ce & 31));
      else if (ce < M)
        zero_f = true;
    };
    for (int q0 = 0; q0 < n_pairs; q0 += 32 * kStageUnroll) {
      longlong2 v[kStageUnroll];
      long long nx[kStageUnroll];
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int q = q0 + u * 32 + l;
        if (q < n_pairs) v[u] = __ldg(pairs + q);
        if (q < n_pairs && 2 * q - head + 2 <= A) nx[u] = __ldg(reinterpret_cast<const long long*>(pairs + q + 1));
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int q = q0 + u * 32 + l;
        if (q < n_pairs) {
          const int e = 2 * q - head;
          mark(e, (uint32_t)v[u].x, (uint32_t)v[u].y);
          mark(e + 1, (uint32_t)v[u].y, (uint32_t)nx[u]);
        }
      }
    }
    if (zero_f) flag[j] = 1;
  }
  __syncthreads();
}

// K7's lane: its own ranks and prevs (forward) and nexts (backward) over
// its nw entries
__device__ __forceinline__ void finish_bitmap(uint4* ent, int nw, uint32_t M) {
  uint32_t rank = 0, prev = 0;
  for (int w = 0; w < nw; ++w) {
    const uint4 E = ent[w];
    ent[w].z = rank | (prev << 16);
    const unsigned long long bits = ((unsigned long long)E.y << 32) | E.x;
    rank += __popcll(bits);
    if (bits) prev = 64 * w + 63 - __clzll(bits);
  }
  uint32_t next = M;
  for (int w = nw - 1; w >= 0; --w) {
    const uint4 E = ent[w];
    ent[w].w = next;
    const unsigned long long bits = ((unsigned long long)E.y << 32) | E.x;
    if (bits) next = 64 * w + __ffsll(bits) - 1;
  }
}

// K8 at any alphabet: the lane's cum row read in device memory
__global__ void __launch_bounds__(kLanes) rans_encode_wide_kernel(
    const int* __restrict__ symbols, const int* __restrict__ table_idx, const long long* __restrict__ cums,
    int A, int k, long long n_lanes, int n_sym, int* __restrict__ words, int* __restrict__ n_words,
    long long* __restrict__ x_out) {
  __shared__ int zero_from[kLanes];
  const long long base = (long long)blockIdx.x * kLanes;
  const long long lane = base + threadIdx.x;
  const long long* c = cums + (lane < n_lanes ? (long long)table_idx[lane] * (A + 1) : 0);
  encode_block(c, symbols, A, k, base, n_lanes, n_sym, words, n_words, x_out, zero_from);
}

// K7 at any alphabet up to 2^k: the lanes' bitmaps staged, then each step
// by bit counts on the slot's entry
__global__ void __launch_bounds__(kLanes) rans_decode_wide_kernel(
    const uint16_t* __restrict__ payload, const int* __restrict__ n_words, const long long* __restrict__ offsets,
    const uint32_t* __restrict__ state, const int* __restrict__ table_idx, const long long* __restrict__ cums,
    int A, int k, long long n_lanes, int n_sym, int* __restrict__ out, long long* __restrict__ x_out,
    long long* __restrict__ ptr_out) {
  extern __shared__ __align__(16) uint4 ents[];  // [lanes][nw + 1], then flags
  const int lanes = blockDim.x;
  const int nw = bitmap_words(k), R = nw + 1;
  const uint32_t M = 1u << k;
  int* flag = reinterpret_cast<int*>(ents + lanes * R);
  for (int e = threadIdx.x; e < lanes * R; e += lanes) ents[e] = make_uint4(0u, 0u, 0u, 0u);
  flag[threadIdx.x] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * lanes;
  stage_bitmaps(ents, R, flag, cums, table_idx, A, k, base, n_lanes);
  const long long lane = base + threadIdx.x;
  if (lane >= n_lanes) return;
  uint4* ent = ents + threadIdx.x * R;
  finish_bitmap(ent, nw, M);
  const bool search = flag[threadIdx.x] != 0;
  const long long* crow = cums + (long long)table_idx[lane] * (A + 1);
  const uint32_t mask = M - 1u;
  uint32_t x = state[lane];
  const int nwd = n_words[lane];
  int ptr = nwd - 1;
  const uint16_t* w = payload + offsets[lane];
  const uint32_t first = nwd > 0 ? (uint32_t)__ldg(w) : 0u;  // the padded matrix's column 0
  int* o = out + lane;
  for (int i = 0; i < n_sym; ++i) {
    const uint32_t word = ptr >= 0 ? (uint32_t)__ldg(w + ptr) : first;
    const uint32_t slot = x & mask;
    uint32_t s, cs, c1;
    if (!search) {
      const uint4 E = ent[slot >> 6];
      const unsigned long long bits = ((unsigned long long)E.y << 32) | E.x;
      const unsigned long long le = bits & ((2ull << (slot & 63)) - 1ull);  // the starts <= slot
      const unsigned long long gt = bits ^ le;
      s = (E.z & 0xFFFFu) + __popcll(le) - 1;
      cs = le ? (slot | 63u) - __clzll(le) : E.z >> 16;
      c1 = gt ? (slot & ~63u) + __ffsll(gt) - 1 : E.w;
    } else {  // the largest s < A with c[s] <= slot
      int lo = 0, hi = A - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if ((uint32_t)__ldg(crow + mid) <= slot)
          lo = mid;
        else
          hi = mid - 1;
      }
      s = lo;
      cs = (uint32_t)__ldg(crow + lo);
      c1 = (uint32_t)__ldg(crow + lo + 1);
    }
    x = (c1 - cs) * (x >> k) + slot - cs;
    o[(long long)i * n_lanes] = (int)s;
    if (x < kRansL) {
      x = (x << 16) | word;
      --ptr;
    }
  }
  x_out[lane] = x;
  ptr_out[lane] = ptr;
}

// allow a block more than the default 48 KB of dynamic shared memory
template <typename Kernel>
cudaError_t fit_smem(Kernel kernel, size_t smem) {
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// registers, shared memory a block (static + dynamic), blocks an SM, local
// (spill) bytes and lanes a block of a kernel launched with ``lanes``
// threads and ``smem`` bytes of dynamic shared memory
template <typename Kernel>
cudaError_t info(Kernel kernel, size_t smem, int* out, int lanes = kLanes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = fit_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, lanes, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)(attr.sharedSizeBytes + smem);
  out[2] = blocks;
  out[3] = (int)attr.localSizeBytes;
  out[4] = lanes;
  return cudaSuccess;
}

}  // namespace

extern "C" int rans_decode(const void* payload, const void* n_words, const void* offsets, const void* state,
                           const void* table_idx, const void* cums, int A, int k, long long n_lanes, int n_sym,
                           void* out, void* x_out, void* ptr_out, void* stream) {
  if (n_lanes <= 0) return (int)cudaSuccess;
  const size_t smem = decode_smem(A);
  const cudaError_t err = fit_smem(rans_decode_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n_lanes + kLanes - 1) / kLanes);
  rans_decode_kernel<<<blocks, kLanes, smem, (cudaStream_t)stream>>>(
      (const uint16_t*)payload, (const int*)n_words, (const long long*)offsets, (const uint32_t*)state,
      (const int*)table_idx, (const long long*)cums, A, k, n_lanes, n_sym, (int*)out, (long long*)x_out,
      (long long*)ptr_out);
  return (int)cudaGetLastError();
}

extern "C" int rans_encode(const void* symbols, const void* table_idx, const void* cums, int A, int k,
                           long long n_lanes, int n_sym, void* words, void* n_words, void* x_out, void* stream) {
  if (n_lanes <= 0) return (int)cudaSuccess;
  const size_t smem = encode_smem(A);
  const cudaError_t err = fit_smem(rans_encode_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n_lanes + kLanes - 1) / kLanes);
  rans_encode_kernel<<<blocks, kLanes, smem, (cudaStream_t)stream>>>(
      (const int*)symbols, (const int*)table_idx, (const long long*)cums, A, k, n_lanes, n_sym, (int*)words,
      (int*)n_words, (long long*)x_out);
  return (int)cudaGetLastError();
}

// the wide kernels: any alphabet up to 2^k, no staged rows
extern "C" int rans_decode_wide(const void* payload, const void* n_words, const void* offsets, const void* state,
                                const void* table_idx, const void* cums, int A, int k, long long n_lanes, int n_sym,
                                void* out, void* x_out, void* ptr_out, void* stream) {
  if (n_lanes <= 0) return (int)cudaSuccess;
  if (k < 1 || k > 14 || A < 1 || A > (1 << k)) return (int)cudaErrorInvalidValue;
  const int lanes = wide_lanes(wide_decode_lane_smem(k));
  const size_t smem = lanes * wide_decode_lane_smem(k);
  const cudaError_t err = fit_smem(rans_decode_wide_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n_lanes + lanes - 1) / lanes);
  rans_decode_wide_kernel<<<blocks, lanes, smem, (cudaStream_t)stream>>>(
      (const uint16_t*)payload, (const int*)n_words, (const long long*)offsets, (const uint32_t*)state,
      (const int*)table_idx, (const long long*)cums, A, k, n_lanes, n_sym, (int*)out, (long long*)x_out,
      (long long*)ptr_out);
  return (int)cudaGetLastError();
}

extern "C" int rans_encode_wide(const void* symbols, const void* table_idx, const void* cums, int A, int k,
                                long long n_lanes, int n_sym, void* words, void* n_words, void* x_out,
                                void* stream) {
  if (n_lanes <= 0) return (int)cudaSuccess;
  if (A < 1 || A > (1 << k)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n_lanes + kLanes - 1) / kLanes);
  rans_encode_wide_kernel<<<blocks, kLanes, 0, (cudaStream_t)stream>>>(
      (const int*)symbols, (const int*)table_idx, (const long long*)cums, A, k, n_lanes, n_sym, (int*)words,
      (int*)n_words, (long long*)x_out);
  return (int)cudaGetLastError();
}

// out: registers, shared memory a block, blocks an SM, spill bytes and
// lanes a block of a kernel at alphabet A and precision k: K7 (decode != 0)
// or K8, staged (wide == 0) or wide
extern "C" int rans_kernel_info(int decode, int wide, int A, int k, int* out) {
  if (k < 1 || k > 14) return (int)cudaErrorInvalidValue;
  if (wide) {
    const int lanes = wide_lanes(wide_decode_lane_smem(k));
    return decode ? (int)info(rans_decode_wide_kernel, lanes * wide_decode_lane_smem(k), out, lanes)
                  : (int)info(rans_encode_wide_kernel, 0, out);
  }
  return decode ? (int)info(rans_decode_kernel, decode_smem(A), out)
                : (int)info(rans_encode_kernel, encode_smem(A), out);
}
