// One-token GQA decode attention, tile-wise split-KV (Hopper, sm_90a).
//
// Replaces src/repro/kernels/decode_attention.py:decode_attention_pallas.
//
// q (B, Hq, D) attends over the cache K/V read in their native serving
// layout (B, S, Hkv, D) through strides (no head-major copy of the cache),
// masked to the first kv_len[b] positions (clamped to S); a row with
// kv_len == 0 outputs 0.
//
// Bound: each cached K/V byte is used for 2 * Hq/Hkv flops, about 3 flops
// per byte at Hq/Hkv = 3, so the memory rate bounds the kernel: the design
// reads every valid K/V row once, keeps enough of them in flight, and keeps
// the arithmetic per byte short.
//
// One block per (row, KV head, split of the positions) serves all the
// group's query heads: 64 threads per query head, so the registers follow
// the real group size (a thread holds one head's state whatever the group)
// and no thread computes for a padded head.  The block loads its heads' q
// first (so those loads do not queue behind the bulk copies), then fills a
// 3-stage shared-memory ring with its first three tiles of 64 positions at
// once, by 16-byte cp.async (each head's row is one contiguous run of D
// elements; rows are padded by 16 bytes in shared memory, so the score
// reads are free of bank conflicts); a stage is refilled as soon as every
// thread is done with its tile.  Per tile:
//   scores   thread (head r, position i) dots the head's query (scaled into
//            log2 units, in shared memory) with row i, in f32, four
//            independent sums;
//   softmax  each head's two warps take the tile's max and sum with warp
//            shuffles: one max, one exp2 per score and one rescale of the
//            running (m, l, acc) per tile, not per position;
//   P V      each lane owns D/32 output columns (one 4-byte load per row at
//            D = 64) over its warp's half of the tile's positions; the two
//            halves are added once, at the end of the split.  A head dim
//            that is no multiple of 32 (80, zamba2-2.7b) gives each lane
//            column pairs lane, lane + 32, ... below D / 2 instead (Cols),
//            so no lane's columns run past D.
// Every product is an f32 FMA on the CUDA cores: the work is a few flops per
// byte, and f32 weights keep the rule of kernels/ops.py (no bf16 rounding of
// P).  Splits wholly past kv_len exit at once and write nothing.  The split
// size comes from the shape (kernels/decode_attention.py), so the grid
// fills the card's SMs about twice.  The merge of the splits is a second,
// small launch (one block per (row, query head), reading only the splits
// below kv_len, their weights computed once into shared memory): folding it
// into the first launch needs a counter that outlives the call, which two
// calls on two streams would share.  Unlike the TPU kernel, S needs no
// divisor: the last tile is masked.
//
// q and the output are f32 or bf16 (a runtime flag: q is read once per
// block, the output written once); K/V f32 or bf16 (a template parameter).
//
// Any head dim up to 256 runs on one of five compiled plans (32, 64,
// 80, 128, 256): the smallest at least as wide.  The kernel takes the real
// D at run time: it loads only D columns, the rest of its panels (q in
// shared memory, the K/V rows of the ring) holds zeros, so a score over the
// padded columns adds nothing, and no column past D is written.  Where a
// K/V row is a whole number of 16-byte chunks on 16-byte boundaries the
// ring is filled by cp.async; any other row (D = 100 in bf16, a cache view
// off its alignment) takes the narrow path of the same kernel (kNarrow):
// element loads into the same zero-padded rows, so the wrapper never
// copies the cache.
//
// Any group size: a KV head's query heads are split into n_groups groups of
// at most kMaxRep (ceil(rep / n_groups) each, the last one shorter), one
// block a (split, group); each group's blocks read the head's K/V tiles
// again (Falcon-7B's 71 query heads on one KV head: 5 groups of 15, the
// last holding 11 heads and 4 idle ones).  The merge launch covers every
// (row, query head).
//
// A head dim past 256 runs on decode_wide_kernel (below): output panels
// across blocks, scores summed over column chunks, no buffer sized by D.
//
// The shared memory is sized once, for
// kMaxRep query heads; at D = 256 with bf16 K/V the 3-stage ring still fits
// (227,328 of the 232,448 bytes a block may have), with f32 K/V it would
// need 399 KB, so that case runs a 1-stage ring (Geom::kStages): each tile
// is loaded after every thread is done with the one before.  At D = 80 a
// row is 160 bytes (bf16) or 320 (f32), ten or twenty 16-byte copies, and
// its padded shared-memory row (176 or 336 bytes) keeps the score reads
// free of bank conflicts.  The merge launch runs D threads rounded up to
// whole warps (96 at D = 80), at most 8 warps.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kMaxRep = 16;  // query heads per KV head
constexpr int kTile = 64;    // cache positions per tile, and threads per query head

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; with valid false the bytes are zero-filled and
// nothing is read
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n consecutive elements of a row in shared memory -> f32
template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float (&x)[N]) {
  if constexpr (N == 1) {
    x[0] = __bfloat162float(*p);
  } else {
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      const uint32_t w = reinterpret_cast<const uint32_t*>(p)[j / 2];
      x[j] = __uint_as_float(w << 16);
      x[j + 1] = __uint_as_float(w & 0xffff0000u);
    }
  }
}
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] = p[j];
}

// 16 bytes of a K row -> f32
__device__ __forceinline__ void to_f32(const uint4& u, float (&x)[8]) {  // 8 bf16
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[2 * j] = __uint_as_float(w[j] << 16);
    x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}
__device__ __forceinline__ void to_f32(const uint4& u, float (&x)[4]) {  // 4 f32
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}

template <typename TKV, int D>
struct Geom {
  static constexpr int E = 16 / (int)sizeof(TKV);        // elements per 16-byte chunk
  static constexpr int NC = D / E;                       // chunks per row
  static constexpr int RB = D * (int)sizeof(TKV) + 16;   // padded row bytes in shared memory
  static constexpr int TILE_B = kTile * RB;              // one K (or V) tile
  // output columns per lane: D / 32 consecutive ones, or (where 32 does
  // not divide D) 2 * ceil(D / 64) in pairs 32 apart (Cols::col)
  static constexpr bool kPairs = D % 32 != 0;
  static constexpr int CPL = kPairs ? 2 * ((D + 63) / 64) : D / 32;
  // tiles in the shared-memory ring: 3, or 1 where 3 would not fit (f32 at D = 256)
  static constexpr int kStages = D * (int)sizeof(TKV) > 512 ? 1 : 3;
  static constexpr int smem(int rep) {
    return rep * D * 4 + 2 * rep * kTile * 4 + kStages * 2 * TILE_B;
  }
};

// the output column of a lane's c-th accumulator, and whether it is below D
template <int D, int CPL, bool kPairs>
__device__ __forceinline__ int lane_col(int lane, int c) {
  return kPairs ? 2 * (lane + 32 * (c / 2)) + c % 2 : lane * CPL + c;
}

// D is the plan's width, Dr <= D the real head dim; kNarrow fills the ring
// by element loads instead of 16-byte copies
template <typename TKV, int D, bool kNarrow>
__global__ void __launch_bounds__(kTile * kMaxRep)
decode_split_kernel(const void* __restrict__ q, int q_bf16, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, const int* __restrict__ kv_len,
                    float* __restrict__ part, int Hq, int rep, int n_groups, int Dr, int S,
                    int n_splits, long long n_part, long long q_sb, long long q_sh, long long k_sb,
                    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                    int split_size, float scale_log2) {
  using G = Geom<TKV, D>;
  constexpr int kStages = G::kStages;
  extern __shared__ __align__(16) uint8_t smem[];
  const int gh = blockDim.x / kTile;                // query heads a block (the group's size)
  float* q_s = (float*)smem;                        // [gh][D], scaled into log2 units
  float* s_s = q_s + gh * D;                        // [gh][kTile] scores
  float* p_s = s_s + gh * kTile;                    // [gh][kTile] weights
  uint8_t* ring = (uint8_t*)(p_s + gh * kTile);     // kStages x (K tile, V tile)

  const int split = blockIdx.x, kvh = blockIdx.y / n_groups, b = blockIdx.z;
  const int g0 = (blockIdx.y % n_groups) * gh;      // the group's first head within the KV head's
  const int nh = min(gh, rep - g0);                 // its real heads; the others compute on zeros
  const int h0 = kvh * rep + g0;                    // the query head of the block's head 0
  const int len = min(max(kv_len[b], 0), S);
  const int s0 = split * split_size;
  if (s0 >= len) return;  // the merge reads no partial of a split past kv_len
  const int s1 = min(s0 + split_size, len);
  const int n_tiles = (s1 - s0 + kTile - 1) / kTile;
  const int tid = threadIdx.x, r = tid / kTile, i = tid % kTile, lane = tid % 32, half = i / 32;

  const TKV* kg = k + b * k_sb + (long long)kvh * k_sh;
  const TKV* vg = v + b * v_sb + (long long)kvh * v_sh;
  auto load_tile = [&](int j) {
    uint8_t* st = ring + (j % kStages) * 2 * G::TILE_B;
    const int t0 = s0 + j * kTile;
    if constexpr (kNarrow) {
      // one element a copy, past Dr zeros; rows past the split are zeros
      using W = std::conditional_t<sizeof(TKV) == 2, uint16_t, uint32_t>;
      const W* kw = reinterpret_cast<const W*>(kg);
      const W* vw = reinterpret_cast<const W*>(vg);
      for (int e = tid; e < kTile * D; e += blockDim.x) {
        const int row = e / D, c = e % D;
        const bool ok = t0 + row < s1 && c < Dr;
        const long long t = t0 + row;
        W* dst = reinterpret_cast<W*>(st + row * G::RB) + c;
        dst[0] = ok ? kw[t * k_ss + c] : W(0);
        dst[G::TILE_B / (int)sizeof(W)] = ok ? vw[t * v_ss + c] : W(0);
      }
    } else {
      const uint32_t sa = smem_addr(st);
      const int nc = Dr / G::E;  // chunks that hold data; the wrapper sends whole chunks
      for (int e = tid; e < kTile * G::NC; e += blockDim.x) {
        const int row = e / G::NC, c = e % G::NC;
        const bool ok = t0 + row < s1 && c < nc;  // rows past the split, columns past Dr: zeros
        const long long t = ok ? t0 + row : s0;
        const int cc = ok ? c : 0;
        const uint32_t dst = sa + row * G::RB + c * 16;
        cp_async16(dst, kg + t * k_ss + cc * G::E, ok);
        cp_async16(dst + G::TILE_B, vg + t * v_ss + cc * G::E, ok);
      }
    }
  };
  // q first (one element per thread; its load is issued before the ring's
  // copies, so it does not queue behind them), then the whole ring at once:
  // a split of at most kStages tiles has all its loads in flight before the
  // first score.  Columns past Dr and heads past the group's are zeros.
  float qx[D / kTile + 1];  // gh * D elements over 64 * gh threads
#pragma unroll
  for (int u = 0; u < D / kTile + 1; ++u) {
    const int e = tid + u * blockDim.x;
    qx[u] = 0.f;
    if (e < gh * D && e / D < nh && e % D < Dr) {
      const long long off = b * q_sb + (long long)(h0 + e / D) * q_sh + e % D;
      qx[u] = q_bf16 ? __bfloat162float(((const __nv_bfloat16*)q)[off]) : ((const float*)q)[off];
    }
  }
#pragma unroll
  for (int j = 0; j < kStages; ++j) {
    if (j < n_tiles) load_tile(j);
    cp_async_commit();
  }
#pragma unroll
  for (int u = 0; u < D / kTile + 1; ++u) {
    const int e = tid + u * blockDim.x;
    if (e < gh * D) q_s[e] = qx[u] * scale_log2;
  }

  const float* qr = q_s + r * D;
  float* sr = s_s + r * kTile;
  float* pr = p_s + r * kTile;
  // this lane's output columns, over this warp's half of each tile
  float m = -INFINITY, l = 0.f, o[G::CPL];
#pragma unroll
  for (int c = 0; c < G::CPL; ++c) o[c] = 0.f;

  // copy groups: tile t < kStages is group t; from iteration 1 on,
  // iteration j commits one group (tile j + kStages - 1, or none), so tile j
  // is complete once at most kStages - 2 groups are pending
  for (int j = 0; j < n_tiles; ++j) {
    if constexpr (kStages == 1) {
      if (j > 0) {  // one stage: tile j goes where tile j-1 was, once every thread is done with it
        __syncthreads();
        load_tile(j);
        cp_async_commit();
      }
      cp_async_wait<0>();
      __syncthreads();
    } else {
      if (j == 0)
        cp_async_wait<kStages - 1>();
      else
        cp_async_wait<kStages - 2>();  // tile j landed for this thread's copies
      __syncthreads();                 // ... and every thread's; q_s written; tile j-1's stage free
      if (j > 0) {
        if (j + kStages - 1 < n_tiles) load_tile(j + kStages - 1);
        cp_async_commit();
      }
    }
    const uint8_t* kt = ring + (j % kStages) * 2 * G::TILE_B;
    const uint8_t* vt = kt + G::TILE_B;
    const int t0 = s0 + j * kTile;

    // score of head r against position t0 + i, in log2 units (four
    // independent sums, so the FMAs do not wait on each other)
    {
      const uint8_t* krow = kt + i * G::RB;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < G::NC; ++c) {
        float x[G::E];
        to_f32(*reinterpret_cast<const uint4*>(krow + c * 16), x);
#pragma unroll
        for (int e4 = 0; e4 < G::E; e4 += 4) {
          const float4 qq = *reinterpret_cast<const float4*>(qr + c * G::E + e4);
          s[0] = fmaf(qq.x, x[e4], s[0]);
          s[1] = fmaf(qq.y, x[e4 + 1], s[1]);
          s[2] = fmaf(qq.z, x[e4 + 2], s[2]);
          s[3] = fmaf(qq.w, x[e4 + 3], s[3]);
        }
      }
      sr[i] = t0 + i < s1 ? (s[0] + s[1]) + (s[2] + s[3]) : -INFINITY;
    }
    __syncthreads();

    // the tile's max and sum for head r, taken by both of its warps; every
    // tile holds a valid position, so m_new is finite (alpha is 0 on the
    // first tile)
    const float a0 = sr[lane], a1 = sr[lane + 32];
    float tm = fmaxf(a0, a1);
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, w));
    const float m_new = fmaxf(m, tm);
    const float alpha = exp2f(m - m_new);
    const float p0 = exp2f(a0 - m_new), p1 = exp2f(a1 - m_new);
    float ps = p0 + p1;
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, w);
    l = l * alpha + ps;
    m = m_new;
    pr[i] = i < 32 ? p0 : p1;  // each weight written once, by the warp that owns it
    __syncthreads();

    // acc = acc * alpha + P V: this lane's D/32 columns (one load of
    // D/32 elements per row) over this warp's 32 positions of the tile, in
    // two independent sums
    {
      float pv[2][G::CPL] = {};
      const float* pw = pr + half * 32;
      const uint8_t* vh = vt + half * 32 * G::RB;
#pragma unroll 2
      for (int t = 0; t < 32; t += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(pw + t);
        const float w4[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const TKV* row = reinterpret_cast<const TKV*>(vh + (t + u) * G::RB);
          float x[G::CPL];
          if constexpr (G::kPairs) {
#pragma unroll
            for (int c = 0; c < G::CPL; c += 2) {
              const int col = lane_col<D, G::CPL, true>(lane, c);
              float x2[2] = {0.f, 0.f};
              if (col < D) load_f32(row + col, x2);
              x[c] = x2[0];
              x[c + 1] = x2[1];
            }
          } else {
            load_f32(row + lane * G::CPL, x);
          }
#pragma unroll
          for (int c = 0; c < G::CPL; ++c) pv[u % 2][c] = fmaf(w4[u], x[c], pv[u % 2][c]);
        }
      }
#pragma unroll
      for (int c = 0; c < G::CPL; ++c) o[c] = o[c] * alpha + (pv[0][c] + pv[1][c]);
    }
  }
  cp_async_wait<0>();

  // this split's partial for head (h0 + r): (m, l) and the unnormalized
  // accumulator (Dr floats), the second half's sums added to the first's
  // through shared memory (q_s is free now)
  float* o_s = q_s + r * D;
  __syncthreads();
  if (half == 1) {
#pragma unroll
    for (int c = 0; c < G::CPL; ++c) {
      const int col = lane_col<D, G::CPL, G::kPairs>(lane, c);
      if (col < D) o_s[col] = o[c];
    }
  }
  __syncthreads();
  if (half == 0 && r < nh) {
    const long long ph = ((long long)b * Hq + h0 + r) * n_splits + split;
    if (lane == 0) {
      part[2 * ph] = m;
      part[2 * ph + 1] = l;
    }
    float* acc = part + 2 * n_part + ph * Dr;
#pragma unroll
    for (int c = 0; c < G::CPL; ++c) {
      const int col = lane_col<D, G::CPL, G::kPairs>(lane, c);
      if (col < Dr) acc[col] = o[c] + o_s[col];
    }
  }
}

// ------------------------------------------------------- wide head dims
// A head dim past 256: no q panel or K/V row of D columns is kept.  The
// block of a (split, group) is split again by output panel (W columns of
// V: 256 for bf16 K/V, 128 for f32, 512-byte rows either way; a grid axis,
// blockIdx.y = (KV head * n_groups + group) * n_panels + panel).  First
// the split's scores: for each chunk of W columns of Dr, the group's q
// chunk is staged (scaled into log2 units) and each tile's K chunk
// streamed through a 2-tile ring, the scores summed into shared memory
// ([gh][kWideSplit]: the wrapper caps the split at kWideSplit positions).
// Then the same online softmax and P V as decode_split_kernel, tile by
// tile, over the panel's V columns.  Every panel's block sums the same
// scores in the same order, so (m, l) agree across panels; panel 0 writes
// them, each panel its accumulator columns, and the merge is unchanged.
// Each panel's block re-reads the split's K (at D = 512 in bf16, two
// panels: twice K's bytes); the ring rows are sized by the chunk, so the
// shared memory (120,832 bytes at 16 query heads) does not grow with D.
constexpr int kWideSplit = 512;  // positions a split past 256 columns

template <typename TKV>
struct WideGeom {
  static constexpr int W = 512 / (int)sizeof(TKV);  // columns a chunk of S and a panel of V
  static constexpr int E = 16 / (int)sizeof(TKV);
  static constexpr int NC = W / E;                  // 16-byte chunks a row
  static constexpr int RB = W * (int)sizeof(TKV) + 16;
  static constexpr int TILE_B = kTile * RB;
  static constexpr int CPL = W / 32;                // output columns a lane
  static constexpr int smem(int gh) { return gh * W * 4 + gh * kWideSplit * 4 + gh * kTile * 4 + 2 * TILE_B; }
};

template <typename TKV, bool kNarrow>
__global__ void __launch_bounds__(kTile * kMaxRep)
decode_wide_kernel(const void* __restrict__ q, int q_bf16, const TKV* __restrict__ k,
                   const TKV* __restrict__ v, const int* __restrict__ kv_len, float* __restrict__ part,
                   int Hq, int rep, int n_groups, int n_panels, int Dr, int S, int n_splits, long long n_part,
                   long long q_sb, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh, int split_size, float scale_log2) {
  using G = WideGeom<TKV>;
  constexpr int W = G::W;
  extern __shared__ __align__(16) uint8_t smem[];
  const int gh = blockDim.x / kTile;
  float* q_s = (float*)smem;                      // [gh][W]: a q chunk, at the end the halves' merge
  float* s_s = q_s + gh * W;                      // [gh][kWideSplit] the split's scores
  float* p_s = s_s + gh * kWideSplit;             // [gh][kTile] weights
  uint8_t* ring = (uint8_t*)(p_s + gh * kTile);   // 2 tiles

  const int split = blockIdx.x, b = blockIdx.z;
  const int panel = blockIdx.y % n_panels, hg = blockIdx.y / n_panels;
  const int kvh = hg / n_groups, g0 = (hg % n_groups) * gh;
  const int nh = min(gh, rep - g0), h0 = kvh * rep + g0, p0 = panel * W;
  const int len = min(max(kv_len[b], 0), S);
  const int s0 = split * split_size;
  if (s0 >= len) return;
  const int s1 = min(s0 + split_size, len);
  const int n_tiles = (s1 - s0 + kTile - 1) / kTile;
  const int tid = threadIdx.x, r = tid / kTile, i = tid % kTile, lane = tid % 32, half = i / 32;

  const TKV* kg = k + b * k_sb + (long long)kvh * k_sh;
  const TKV* vg = v + b * v_sb + (long long)kvh * v_sh;
  // tile j's columns [c0, c0 + W) of K or V into ring buffer bi; rows past
  // the split and columns past Dr are zeros
  auto load_tile = [&](const TKV* g, long long ss, int j, int c0, int bi) {
    uint8_t* st = ring + bi * G::TILE_B;
    const int t0 = s0 + j * kTile;
    if constexpr (kNarrow) {
      using Wd = std::conditional_t<sizeof(TKV) == 2, uint16_t, uint32_t>;
      const Wd* gw = reinterpret_cast<const Wd*>(g);
      for (int e = tid; e < kTile * W; e += blockDim.x) {
        const int row = e / W, c = e % W;
        const bool ok = t0 + row < s1 && c0 + c < Dr;
        reinterpret_cast<Wd*>(st + row * G::RB)[c] = ok ? gw[(long long)(t0 + row) * ss + c0 + c] : Wd(0);
      }
    } else {
      const uint32_t sa = smem_addr(st);
      const int nc = min(G::NC, (Dr - c0) / G::E);  // chunks that hold data
      for (int e = tid; e < kTile * G::NC; e += blockDim.x) {
        const int row = e / G::NC, c = e % G::NC;
        const bool ok = t0 + row < s1 && c < nc;
        const long long t = ok ? t0 + row : s0;
        cp_async16(sa + row * G::RB + c * 16, g + t * ss + c0 + (ok ? c : 0) * G::E, ok);
      }
    }
  };

  // the split's scores, chunk by chunk of Dr (unit u: chunk u / n_tiles, tile u % n_tiles)
  const int n_units = (Dr + W - 1) / W * n_tiles;
  load_tile(kg, k_ss, 0, 0, 0);
  cp_async_commit();
  for (int u = 0; u < n_units; ++u) {
    const int c = u / n_tiles, j = u % n_tiles;
    cp_async_wait<0>();
    __syncthreads();  // unit u landed; every thread is done with unit u - 1's buffer and q chunk
    if (u + 1 < n_units) load_tile(kg, k_ss, (u + 1) % n_tiles, (u + 1) / n_tiles * W, (u + 1) % 2);
    cp_async_commit();
    if (j == 0) {  // the group's q chunk c; columns past Dr and heads past the group's are zeros
      for (int e = tid; e < gh * W; e += blockDim.x) {
        const int hh = e / W, col = c * W + e % W;
        float x = 0.f;
        if (hh < nh && col < Dr) {
          const long long off = b * q_sb + (long long)(h0 + hh) * q_sh + col;
          x = q_bf16 ? __bfloat162float(((const __nv_bfloat16*)q)[off]) : ((const float*)q)[off];
        }
        q_s[e] = x * scale_log2;
      }
      __syncthreads();
    }
    const uint8_t* krow = ring + (u % 2) * G::TILE_B + i * G::RB;
    const float* qr = q_s + r * W;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int cc = 0; cc < G::NC; ++cc) {
      float x[G::E];
      to_f32(*reinterpret_cast<const uint4*>(krow + cc * 16), x);
#pragma unroll
      for (int e4 = 0; e4 < G::E; e4 += 4) {
        const float4 qq = *reinterpret_cast<const float4*>(qr + cc * G::E + e4);
        s[0] = fmaf(qq.x, x[e4], s[0]);
        s[1] = fmaf(qq.y, x[e4 + 1], s[1]);
        s[2] = fmaf(qq.z, x[e4 + 2], s[2]);
        s[3] = fmaf(qq.w, x[e4 + 3], s[3]);
      }
    }
    float* sp = s_s + r * kWideSplit + j * kTile + i;  // this thread's own score
    const float sum = (s[0] + s[1]) + (s[2] + s[3]);
    *sp = c == 0 ? sum : *sp + sum;
  }

  // the panel's P V, tile by tile, with decode_split_kernel's online softmax
  __syncthreads();  // every thread is done with the ring
  load_tile(vg, v_ss, 0, p0, 0);
  cp_async_commit();
  float m = -INFINITY, l = 0.f, o[G::CPL];
#pragma unroll
  for (int cc = 0; cc < G::CPL; ++cc) o[cc] = 0.f;
  float* pr = p_s + r * kTile;
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // tile j landed; tile j - 1's buffer and weights are free
    if (j + 1 < n_tiles) load_tile(vg, v_ss, j + 1, p0, (j + 1) % 2);
    cp_async_commit();
    const int t0 = s0 + j * kTile;
    const float* sr = s_s + r * kWideSplit + j * kTile;
    const float a0 = t0 + lane < s1 ? sr[lane] : -INFINITY;
    const float a1 = t0 + lane + 32 < s1 ? sr[lane + 32] : -INFINITY;
    float tm = fmaxf(a0, a1);
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, w));
    const float m_new = fmaxf(m, tm);
    const float alpha = exp2f(m - m_new);
    const float p0w = exp2f(a0 - m_new), p1w = exp2f(a1 - m_new);
    float ps = p0w + p1w;
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, w);
    l = l * alpha + ps;
    m = m_new;
    pr[i] = i < 32 ? p0w : p1w;
    __syncthreads();
    float pv[2][G::CPL] = {};
    const float* pw = pr + half * 32;
    const uint8_t* vh = ring + (j % 2) * G::TILE_B + half * 32 * G::RB;
#pragma unroll 2
    for (int t = 0; t < 32; t += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(pw + t);
      const float w4[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int uu = 0; uu < 4; ++uu) {
        float x[G::CPL];
        load_f32(reinterpret_cast<const TKV*>(vh + (t + uu) * G::RB) + lane * G::CPL, x);
#pragma unroll
        for (int cc = 0; cc < G::CPL; ++cc) pv[uu % 2][cc] = fmaf(w4[uu], x[cc], pv[uu % 2][cc]);
      }
    }
#pragma unroll
    for (int cc = 0; cc < G::CPL; ++cc) o[cc] = o[cc] * alpha + (pv[0][cc] + pv[1][cc]);
  }
  cp_async_wait<0>();

  // this split's partial for head (h0 + r): panel 0 writes (m, l), each
  // panel its columns of the accumulator, the halves added through q_s
  float* o_s = q_s + r * W;
  __syncthreads();
  if (half == 1) {
#pragma unroll
    for (int cc = 0; cc < G::CPL; ++cc) o_s[lane * G::CPL + cc] = o[cc];
  }
  __syncthreads();
  if (half == 0 && r < nh) {
    const long long ph = ((long long)b * Hq + h0 + r) * n_splits + split;
    if (lane == 0 && panel == 0) {
      part[2 * ph] = m;
      part[2 * ph + 1] = l;
    }
    float* acc = part + 2 * n_part + ph * Dr + p0;
#pragma unroll
    for (int cc = 0; cc < G::CPL; ++cc) {
      const int col = lane * G::CPL + cc;
      if (p0 + col < Dr) acc[col] = o[cc] + o_s[col];
    }
  }
}

// over a block of whole warps (the merge rounds D up to them)
__device__ __forceinline__ float block_reduce(float x, bool is_max, float* red) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, w);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // red is free
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < (int)blockDim.x / 32; ++w) x = is_max ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

// merge the splits below kv_len of one (row, query head); D threads
// rounded up to whole warps (at most 8: past 256 each thread takes several
// columns), the threads past D only in the reductions.
// The splits' weights exp2(m_s - M) are computed once, into shared memory
__global__ void decode_combine_kernel(const float* __restrict__ part, const int* __restrict__ kv_len,
                                      void* __restrict__ out, int out_bf16, int Hq, int S,
                                      int n_splits, long long n_part, int split_size, int D) {
  extern __shared__ float w_s[];  // [n_splits]
  __shared__ float red[8];        // one slot a warp: at most 256 threads
  const long long bh = blockIdx.x;  // b * Hq + query head
  const int len = min(max(kv_len[bh / Hq], 0), S);
  const int n = (len + split_size - 1) / split_size;
  const float* ml = part + 2 * bh * n_splits;
  const float* acc = part + 2 * n_part + bh * n_splits * D;
  float M = -INFINITY;
  for (int s = threadIdx.x; s < n; s += blockDim.x) M = fmaxf(M, ml[2 * s]);
  M = block_reduce(M, true, red);
  float L = 0.f;
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const float c = exp2f(ml[2 * s] - M);
    w_s[s] = c;
    L += ml[2 * s + 1] * c;
  }
  L = block_reduce(L, false, red);  // its barriers also publish w_s
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a0 = 0.f, a1 = 0.f;
    int s = 0;
    for (; s + 1 < n; s += 2) {
      a0 += acc[(long long)s * D + d] * w_s[s];
      a1 += acc[(long long)(s + 1) * D + d] * w_s[s + 1];
    }
    if (s < n) a0 += acc[(long long)s * D + d] * w_s[s];
    const float x = L > 0.f ? (a0 + a1) / L : 0.f;
    if (out_bf16)
      ((__nv_bfloat16*)out)[bh * D + d] = __float2bfloat16_rn(x);
    else
      ((float*)out)[bh * D + d] = x;
  }
}

template <typename TKV, int D, bool kNarrow>
int launch_split(const void* q, int q_bf16, const void* k, const void* v, const int* kv_len,
                 float* part, int B, int Hq, int Hkv, int Dr, int S, int n_splits, long long q_sb,
                 long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                 long long v_ss, long long v_sh, int split_size, float scale_log2,
                 cudaStream_t stream) {
  static_assert(Geom<TKV, D>::smem(kMaxRep) <= 232448, "the ring fits a block's shared memory");
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_split_kernel<TKV, D, kNarrow>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Geom<TKV, D>::smem(kMaxRep));
  if (attr != cudaSuccess) return (int)attr;
  const int rep = Hq / Hkv;
  const int n_groups = (rep + kMaxRep - 1) / kMaxRep;
  const int gh = (rep + n_groups - 1) / n_groups;  // query heads a block
  dim3 grid(n_splits, Hkv * n_groups, B);
  decode_split_kernel<TKV, D, kNarrow><<<grid, kTile * gh, Geom<TKV, D>::smem(gh), stream>>>(
      q, q_bf16, (const TKV*)k, (const TKV*)v, kv_len, part, Hq, rep, n_groups, Dr, S, n_splits,
      (long long)B * Hq * n_splits, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, split_size,
      scale_log2);
  return (int)cudaGetLastError();
}

template <typename TKV, bool kNarrow>
int launch_wide(const void* q, int q_bf16, const void* k, const void* v, const int* kv_len, float* part,
                int B, int Hq, int Hkv, int Dr, int S, int n_splits, long long q_sb, long long q_sh,
                long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                int split_size, float scale_log2, cudaStream_t stream) {
  using G = WideGeom<TKV>;
  static_assert(G::smem(kMaxRep) <= 232448, "the plan fits a block's shared memory");
  if (split_size > kWideSplit) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_wide_kernel<TKV, kNarrow>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::smem(kMaxRep));
  if (attr != cudaSuccess) return (int)attr;
  const int rep = Hq / Hkv;
  const int n_groups = (rep + kMaxRep - 1) / kMaxRep;
  const int gh = (rep + n_groups - 1) / n_groups;
  const int n_panels = (Dr + G::W - 1) / G::W;
  dim3 grid(n_splits, Hkv * n_groups * n_panels, B);
  decode_wide_kernel<TKV, kNarrow><<<grid, kTile * gh, G::smem(gh), stream>>>(
      q, q_bf16, (const TKV*)k, (const TKV*)v, kv_len, part, Hq, rep, n_groups, n_panels, Dr, S, n_splits,
      (long long)B * Hq * n_splits, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, split_size, scale_log2);
  return (int)cudaGetLastError();
}

template <typename TKV, bool kNarrow>
int launch_plan(int D, const void* q, int q_bf16, const void* k, const void* v,
                const int* kv_len, float* part, int B, int Hq, int Hkv, int S, int n_splits,
                long long q_sb, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                long long v_sb, long long v_ss, long long v_sh, int split_size, float scale_log2,
                cudaStream_t stream) {
#define ARGS q, q_bf16, k, v, kv_len, part, B, Hq, Hkv, D, S, n_splits, q_sb, q_sh, k_sb, k_ss, \
             k_sh, v_sb, v_ss, v_sh, split_size, scale_log2, stream
  // the smallest plan at least D wide
  if (D <= 32) return launch_split<TKV, 32, kNarrow>(ARGS);
  if (D <= 64) return launch_split<TKV, 64, kNarrow>(ARGS);
  if (D <= 80) return launch_split<TKV, 80, kNarrow>(ARGS);
  if (D <= 128) return launch_split<TKV, 128, kNarrow>(ARGS);
  if (D <= 256) return launch_split<TKV, 256, kNarrow>(ARGS);
  return launch_wide<TKV, kNarrow>(ARGS);
#undef ARGS
}

template <typename TKV>
int launch_typed(int narrow, int D, const void* q, int q_bf16, const void* k, const void* v,
                 const int* kv_len, float* part, int B, int Hq, int Hkv, int S, int n_splits,
                 long long q_sb, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh, int split_size, float scale_log2,
                 cudaStream_t stream) {
  // the 16-byte copies take whole chunks only
  if (!narrow && D * (int)sizeof(TKV) % 16) return (int)cudaErrorInvalidValue;
#define ARGS D, q, q_bf16, k, v, kv_len, part, B, Hq, Hkv, S, n_splits, q_sb, q_sh, k_sb, k_ss, \
             k_sh, v_sb, v_ss, v_sh, split_size, scale_log2, stream
  return narrow ? launch_plan<TKV, true>(ARGS) : launch_plan<TKV, false>(ARGS);
#undef ARGS
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; the output has q's dtype.  part
// holds B * Hq * n_splits (m, l) pairs, then as many D-float accumulators.
// With narrow 0, K/V rows are read with 16-byte copies: the wrapper
// guarantees 16-byte aligned base pointers and row strides, and rows of
// whole 16-byte chunks; with narrow 1 any layout with a contiguous head dim.
// Any D >= 1: up to 256 on the plans, past it on decode_wide_kernel, whose
// split_size must be at most kWideSplit.
extern "C" int decode_attention(const void* q, const void* k, const void* v, const void* kv_len,
                                void* out, void* part, int B, int Hq, int Hkv, int S, int D,
                                int n_splits, long long q_sb, long long q_sh, long long k_sb,
                                long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                                long long v_sh, int split_size, float scale, int q_dtype,
                                int kv_dtype, int narrow, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv || D <= 0 || n_splits <= 0 ||
      split_size % kTile || (long long)n_splits * split_size < S)
    return (int)cudaErrorInvalidValue;
  if ((q_dtype != 0 && q_dtype != 1) || (kv_dtype != 0 && kv_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float scale_log2 = scale * 1.4426950408889634f;
#define ARGS narrow, D, q, q_dtype, k, v, (const int*)kv_len, (float*)part, B, Hq, Hkv, S, \
             n_splits, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, split_size, scale_log2, s
  const int err = kv_dtype == 1 ? launch_typed<__nv_bfloat16>(ARGS) : launch_typed<float>(ARGS);
#undef ARGS
  if (err) return err;
  const int merge_threads = D > 256 ? 256 : (D + 31) / 32 * 32;  // whole warps for block_reduce, at most 8
  decode_combine_kernel<<<B * Hq, merge_threads, n_splits * sizeof(float), s>>>((const float*)part, (const int*)kv_len, out, q_dtype,
                                             Hq, S, n_splits, (long long)B * Hq * n_splits,
                                             split_size, D);
  return (int)cudaGetLastError();
}
