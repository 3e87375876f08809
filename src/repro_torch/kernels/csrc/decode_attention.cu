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
// Head dims 32, 64, 80, 128 and 256.  The shared memory is sized once, for
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

template <typename TKV, int D>
__global__ void __launch_bounds__(kTile * kMaxRep)
decode_split_kernel(const void* __restrict__ q, int q_bf16, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, const int* __restrict__ kv_len,
                    float* __restrict__ part, int Hq, int S, int n_splits, long long n_part,
                    long long q_sb, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh, int split_size,
                    float scale_log2) {
  using G = Geom<TKV, D>;
  constexpr int kStages = G::kStages;
  extern __shared__ __align__(16) uint8_t smem[];
  const int rep = blockDim.x / kTile;
  float* q_s = (float*)smem;                        // [rep][D], scaled into log2 units
  float* s_s = q_s + rep * D;                       // [rep][kTile] scores
  float* p_s = s_s + rep * kTile;                   // [rep][kTile] weights
  uint8_t* ring = (uint8_t*)(p_s + rep * kTile);    // kStages x (K tile, V tile)

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int len = min(max(kv_len[b], 0), S);
  const int s0 = split * split_size;
  if (s0 >= len) return;  // the merge reads no partial of a split past kv_len
  const int s1 = min(s0 + split_size, len);
  const int n_tiles = (s1 - s0 + kTile - 1) / kTile;
  const int tid = threadIdx.x, r = tid / kTile, i = tid % kTile, lane = tid % 32, half = i / 32;

  const TKV* kg = k + b * k_sb + (long long)kvh * k_sh;
  const TKV* vg = v + b * v_sb + (long long)kvh * v_sh;
  auto load_tile = [&](int j) {
    const uint32_t st = smem_addr(ring + (j % kStages) * 2 * G::TILE_B);
    const int t0 = s0 + j * kTile;
    for (int e = tid; e < kTile * G::NC; e += blockDim.x) {
      const int row = e / G::NC, c = e % G::NC;
      const bool ok = t0 + row < s1;  // rows past the split are zeros: 0 * V stays 0
      const long long t = ok ? t0 + row : s0;
      const uint32_t dst = st + row * G::RB + c * 16;
      cp_async16(dst, kg + t * k_ss + c * G::E, ok);
      cp_async16(dst + G::TILE_B, vg + t * v_ss + c * G::E, ok);
    }
  };
  // q first (one element per thread; its load is issued before the ring's
  // copies, so it does not queue behind them), then the whole ring at once:
  // a split of at most kStages tiles has all its loads in flight before the
  // first score
  float qx[D / kTile + 1];  // rep * D elements over 64 * rep threads
#pragma unroll
  for (int u = 0; u < D / kTile + 1; ++u) {
    const int e = tid + u * blockDim.x;
    if (e < rep * D) {
      const long long off = b * q_sb + (long long)(kvh * rep + e / D) * q_sh + e % D;
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
    if (e < rep * D) q_s[e] = qx[u] * scale_log2;
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

  // this split's partial for head (kvh * rep + r): (m, l) and the
  // unnormalized accumulator, the second half's sums added to the first's
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
  if (half == 0) {
    const long long ph = ((long long)b * Hq + kvh * rep + r) * n_splits + split;
    if (lane == 0) {
      part[2 * ph] = m;
      part[2 * ph + 1] = l;
    }
    float* acc = part + 2 * n_part + ph * D;
#pragma unroll
    for (int c = 0; c < G::CPL; ++c) {
      const int col = lane_col<D, G::CPL, G::kPairs>(lane, c);
      if (col < D) acc[col] = o[c] + o_s[col];
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
// rounded up to whole warps, the threads past D only in the reductions.
// The splits' weights exp2(m_s - M) are computed once, into shared memory
__global__ void decode_combine_kernel(const float* __restrict__ part, const int* __restrict__ kv_len,
                                      void* __restrict__ out, int out_bf16, int Hq, int S,
                                      int n_splits, long long n_part, int split_size, int D) {
  extern __shared__ float w_s[];  // [n_splits]
  __shared__ float red[8];        // one slot a warp: D <= 256 threads
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

template <typename TKV, int D>
int launch_split(const void* q, int q_bf16, const void* k, const void* v, const int* kv_len,
                 float* part, int B, int Hq, int Hkv, int S, int n_splits, long long q_sb,
                 long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                 long long v_ss, long long v_sh, int split_size, float scale_log2,
                 cudaStream_t stream) {
  static_assert(Geom<TKV, D>::smem(kMaxRep) <= 232448, "the ring fits a block's shared memory");
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_split_kernel<TKV, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Geom<TKV, D>::smem(kMaxRep));
  if (attr != cudaSuccess) return (int)attr;
  const int rep = Hq / Hkv;
  dim3 grid(n_splits, Hkv, B);
  decode_split_kernel<TKV, D><<<grid, kTile * rep, Geom<TKV, D>::smem(rep), stream>>>(
      q, q_bf16, (const TKV*)k, (const TKV*)v, kv_len, part, Hq, S, n_splits,
      (long long)B * Hq * n_splits, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, split_size,
      scale_log2);
  return (int)cudaGetLastError();
}

template <typename TKV>
int launch_typed(int D, const void* q, int q_bf16, const void* k, const void* v,
                 const int* kv_len, float* part, int B, int Hq, int Hkv, int S, int n_splits,
                 long long q_sb, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh, int split_size, float scale_log2,
                 cudaStream_t stream) {
#define ARGS q, q_bf16, k, v, kv_len, part, B, Hq, Hkv, S, n_splits, q_sb, q_sh, k_sb, k_ss, \
             k_sh, v_sb, v_ss, v_sh, split_size, scale_log2, stream
  switch (D) {
    case 32: return launch_split<TKV, 32>(ARGS);
    case 64: return launch_split<TKV, 64>(ARGS);
    case 80: return launch_split<TKV, 80>(ARGS);
    case 128: return launch_split<TKV, 128>(ARGS);
    case 256: return launch_split<TKV, 256>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; the output has q's dtype.  part
// holds B * Hq * n_splits (m, l) pairs, then as many D-float accumulators.
// K/V rows are read with 16-byte copies: the wrapper guarantees 16-byte
// aligned base pointers and row strides.
extern "C" int decode_attention(const void* q, const void* k, const void* v, const void* kv_len,
                                void* out, void* part, int B, int Hq, int Hkv, int S, int D,
                                int n_splits, long long q_sb, long long q_sh, long long k_sb,
                                long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                                long long v_sh, int split_size, float scale, int q_dtype,
                                int kv_dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv || Hq / Hkv > kMaxRep || n_splits <= 0 ||
      split_size % kTile || (long long)n_splits * split_size < S)
    return (int)cudaErrorInvalidValue;
  if ((q_dtype != 0 && q_dtype != 1) || (kv_dtype != 0 && kv_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float scale_log2 = scale * 1.4426950408889634f;
#define ARGS D, q, q_dtype, k, v, (const int*)kv_len, (float*)part, B, Hq, Hkv, S, n_splits, \
             q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, split_size, scale_log2, s
  const int err = kv_dtype == 1 ? launch_typed<__nv_bfloat16>(ARGS) : launch_typed<float>(ARGS);
#undef ARGS
  if (err) return err;
  const int merge_threads = (D + 31) / 32 * 32;  // whole warps for block_reduce's shuffles
  decode_combine_kernel<<<B * Hq, merge_threads, n_splits * sizeof(float), s>>>((const float*)part, (const int*)kv_len, out, q_dtype,
                                             Hq, S, n_splits, (long long)B * Hq * n_splits,
                                             split_size, D);
  return (int)cudaGetLastError();
}
