// Lane-parallel static-table rANS coder for the CacheGen codec (Hopper, sm_90a).
//
// K7 rans_decode replaces src/repro/core/rans.py:110 _decode_impl (a jitted lax.scan)
// K8 rans_encode replaces src/repro/core/rans.py:65  _encode_impl (a jitted lax.scan)
//
// The reference runs each direction as one vectorized scan over all lanes; a
// lane is one (layer, K/V, channel) stream with its own static distribution.
// Here each lane is one thread, the GPU coder design CacheGen describes ("one
// CUDA thread per bitstream"): the thread walks its lane's symbols in order
// (K7) or in reverse (K8) with its 32-bit state in a register.  The variant
// is ryg_rans' "rans_word": 32-bit state, 16-bit renormalization, precision
// k <= 14, so a step emits or consumes at most one word and does fixed work.
// State arithmetic is uint32 and exact: f * (x >> k) < 2^32 in the decoder,
// and the encoder's (q << k) + r + c < 2^32.  Only the encoder's overflow test
// x >= ((2^16 >> k) << 16) * f is taken in 64 bits: with a table whose one
// symbol holds all 2^k slots the product is 2^32, which the plain version
// (int64) compares exactly.
//
// What bounds them on the H100.  Each step is a chain of dependent gathers
// into the lane's own table: K7 reads slot2sym[t][x & (M - 1)], then
// freqs[t][s] and cums[t][s] (independent of each other), and only then knows
// the next state; K8 reads freqs and cums at its symbol.  The tables are per
// lane and too big for the 50 MB L2 (smollm-360m: 20,480 tables a set, 168 MB
// of slot2sym at k = 12), so most gathers go to HBM, each a scattered 32-byte
// sector.  A smollm-360m wave's delta decode (81,920 lanes x 1,382 steps)
// must move 0.87 GB, each byte once (its symbols, the words it consumes and
// the table entries its data reads): 0.26 ms at 3.35 TB/s.  Charging one
// 32-byte sector for each gather instead gives 3.4 ms.  On an H100 80GB HBM3
// at 700 W it takes 12.5 ms (2.1% of the first, 27% of the second), about
// 9 us a step: with every lane of the wave resident at once (620 threads an
// SM), the scattered gathers queue, and each link of a step's chain waits
// several memory latencies.  What the design does about it:
//   * every lane of a wave is in one launch (codec.decode_chunks stacks all
//     chunks' lanes into one anchor and one delta launch), small blocks of
//     kThreads spread them evenly over the SMs, and nothing is synchronized,
//     so each SM keeps hundreds of independent chains in flight;
//   * K7 loads the word at ptr at the start of the step (ptr is known then),
//     beside the slot2sym gather, so the refill adds no link to the chain;
//     a lane's words are consecutive, so that load mostly hits L1;
//   * freqs and cums are gathered together, as one link;
//   * the symbols (K7) and words (K8) are written step-major, (n_sym, n_lanes),
//     so a warp's stores are coalesced (K8's lanes' ptrs differ a little, so a
//     warp's word store spans a few rows); the wrappers return the transposed
//     views, (n_lanes, n_sym) as the plain versions' contract has it.
// Left for later (noted, not done): packing (sym, freq, cum) into one entry a
// slot, so a K7 step makes one gather instead of two dependent ones;
// narrowing the int64 freqs/cums to 16 or 32 bits; reciprocal tables for
// K8's 32-bit divisions x / f and x % f (a plain `/` now).
//
// Index width: table offsets are 64-bit.  A stacked delta decode of
// qwen2-moe-a2.7b holds 491,520 tables, so t * 4096 reaches 2.0e9, and a
// registry model with 80 layers and C = 1,024 passes 2^31.
//
// The wire's bits at their own width: words arrive as int16 and states as
// int32 tensors holding the wire's uint16 and uint32 bits; the kernels read
// them as unsigned.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;  // lanes a block: 20,480 lanes make 320 blocks for 132 SMs
constexpr uint32_t kRansL = 1u << 16;

__global__ void __launch_bounds__(kThreads) rans_decode_kernel(
    const uint16_t* __restrict__ words, long long cap, const int* __restrict__ n_words,
    const uint32_t* __restrict__ state, const int* __restrict__ table_idx,
    const long long* __restrict__ freqs, const long long* __restrict__ cums,
    const int16_t* __restrict__ slot2sym, int A, int k, long long n_lanes, int n_sym,
    int* __restrict__ out, long long* __restrict__ x_out, long long* __restrict__ ptr_out) {
  const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n_lanes) return;
  const long long t = table_idx[lane];
  const int16_t* s2s = slot2sym + (t << k);
  const long long* f_row = freqs + t * A;
  const long long* c_row = cums + t * (A + 1);
  const uint16_t* w_row = words + lane * cap;
  const uint32_t mask = (1u << k) - 1u;
  uint32_t x = state[lane];
  long long ptr = (long long)n_words[lane] - 1;
  for (int i = 0; i < n_sym; ++i) {
    // the word a refill would take, loaded beside the slot's gather; ptr is
    // clamped into the row (the plain version reads words[lane, max(ptr, 0)];
    // core/rans.decode refuses n_words > cap before the launch, and the clamp
    // keeps a direct call with such a lane inside its row)
    const long long at = ptr < 0 ? 0 : (ptr < cap ? ptr : cap - 1);
    const uint32_t word = w_row[at];
    const uint32_t slot = x & mask;
    const int s = s2s[slot];
    const uint32_t f = (uint32_t)f_row[s];
    const uint32_t c = (uint32_t)c_row[s];
    x = f * (x >> k) + slot - c;
    out[(long long)i * n_lanes + lane] = s;
    if (x < kRansL) {
      x = (x << 16) | word;
      --ptr;
    }
  }
  x_out[lane] = x;
  ptr_out[lane] = ptr;
}

__global__ void __launch_bounds__(kThreads) rans_encode_kernel(
    const int* __restrict__ symbols, const int* __restrict__ table_idx,
    const long long* __restrict__ freqs, const long long* __restrict__ cums, int A, int k,
    long long n_lanes, int n_sym, int* __restrict__ words, int* __restrict__ n_words,
    long long* __restrict__ x_out) {
  const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n_lanes) return;
  const long long t = table_idx[lane];
  const long long* f_row = freqs + t * A;
  const long long* c_row = cums + t * (A + 1);
  const int* s_row = symbols + lane * n_sym;
  const uint64_t x_bound = (uint64_t)((kRansL >> k) << 16);
  uint32_t x = kRansL;
  int ptr = 0;
  // rANS encodes in reverse symbol order so the decoder runs forward
  for (int i = n_sym - 1; i >= 0; --i) {
    const int s = s_row[i];
    const uint32_t f = (uint32_t)f_row[s];
    const uint32_t c = (uint32_t)c_row[s];
    const bool emit = (uint64_t)x >= x_bound * f;
    // the word goes to ptr whether or not it is emitted, as the reference's
    // buffer has it: the unused tail holds exactly the reference's values
    words[(long long)ptr * n_lanes + lane] = (int)(x & 0xFFFFu);
    if (emit) {
      ++ptr;
      x >>= 16;
    }
    const uint32_t q = x / f;
    x = (q << k) + (x - q * f) + c;
  }
  n_words[lane] = ptr;
  x_out[lane] = x;
}

inline unsigned blocks_for(long long n_lanes) { return (unsigned)((n_lanes + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int rans_decode(const void* words, long long cap, const void* n_words, const void* state,
                           const void* table_idx, const void* freqs, const void* cums, const void* slot2sym,
                           int A, int k, long long n_lanes, int n_sym, void* out, void* x_out, void* ptr_out,
                           void* stream) {
  if (n_lanes <= 0) return (int)cudaSuccess;
  rans_decode_kernel<<<blocks_for(n_lanes), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)words, cap, (const int*)n_words, (const uint32_t*)state, (const int*)table_idx,
      (const long long*)freqs, (const long long*)cums, (const int16_t*)slot2sym, A, k, n_lanes, n_sym,
      (int*)out, (long long*)x_out, (long long*)ptr_out);
  return (int)cudaGetLastError();
}

extern "C" int rans_encode(const void* symbols, const void* table_idx, const void* freqs, const void* cums,
                           int A, int k, long long n_lanes, int n_sym, void* words, void* n_words, void* x_out,
                           void* stream) {
  if (n_lanes <= 0) return (int)cudaSuccess;
  rans_encode_kernel<<<blocks_for(n_lanes), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)symbols, (const int*)table_idx, (const long long*)freqs, (const long long*)cums, A, k,
      n_lanes, n_sym, (int*)words, (int*)n_words, (long long*)x_out);
  return (int)cudaGetLastError();
}
