// Prefill flash attention with causal / prefix-LM masks and GQA (Hopper, sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_pallas.
//
// q (B, Tq, Hq, D) against k, v (B, Tk, Hkv, D), all in the model's native
// token-major layout and read through strides, so the caller never moves
// the head axis.  Query t sits at position t + (Tk - Tq) (the decoder
// offset); with ``causal`` it sees keys at positions <= its own, and with a
// prefix_len[b] it also sees every key below that (prefix-LM).  Query head
// h reads KV head h / (Hq / Hkv).
//
// Bound: causal prefill does about Hq * T / (2 * Hkv) flops per K/V byte
// (4,608 at T = 3072, Hq/Hkv = 3), far above the ~300 flop/byte where the
// memory rate stops bounding, so the tensor cores' rate bounds it.
//
// bf16 (the engine's dtype): both products run on the tensor cores with
// wgmma m64n64k16, f32 accumulate.  A block holds 64 query rows of one query
// head and two warpgroups; they split the rows' key tiles (warpgroup w takes
// tiles 2i + w), each keeping its own online softmax, and merge their
// (m, l, O) through shared memory at the end.  Splitting the keys, not the
// rows, halves the longest chain of tiles a block runs: with causal masks
// the kernel's time was that of the blocks over the last rows (48 tiles in a
// row at T = 3072), not the card's throughput.  The grid puts the heads
// fastest and the query tiles in reverse, so the heaviest tiles of every
// head launch first.  Per 64-key tile:
//   S = Q K^T   Q and the K tile both K-major ([row][d], as the tensors
//               store them) in shared memory;
//   softmax     online, in f32 on the accumulator fragments: a row lives in
//               one quad of lanes, so its max and sum take two shuffles; the
//               max is taken on the raw scores and the scale folded into one
//               FFMA before ex2.approx; only the diagonal tile(s) and a
//               ragged last tile are masked; tiles past every row's last key
//               are skipped;
//   O += P V    P rounded to bf16 in registers is wgmma's register A
//               operand (the accumulator fragment of S is its layout), and
//               the V tile is read as an MN-major B operand (wgmma's
//               transpose flag), so V is never transposed.
// The K/V tile pairs go through a 3-stage shared-memory ring, filled by
// 16-byte cp.async from all 256 threads into the 128-byte-swizzled layout
// the wgmma descriptors name; a stage is refilled two pairs ahead of its
// use.  cp.async needs no tensor map, so the library links no libcuda.
// Tried and measured slower at the main shape (PERF.md): a producer warp
// with mbarrier-handed stages and the two warpgroups taking turns on the
// tensor cores (FlashAttention-3's ping-pong, with each warpgroup's softmax
// overlapping its previous value product), and four warpgroups per block.
// The 3 query heads that share a KV head are not grouped into one block: a
// head's K/V (0.8 MB at T = 3072) stays in the 50 MB L2, so the re-reads
// cost L2 bandwidth, not HBM, while one block per (64 rows, head) works for
// any group size and gives 48 x 15 = 720 blocks at the main shape.  D = 32
// is zero-padded to 64 in shared memory.  The row sum l is taken over the
// f32 weights before their rounding; the rounding is what the reference's
// chunked_mha does at bf16 (it casts its weights to v's dtype), and
// kernels/ops.py states the rule it is held to.
//
// Head dim 80 (zamba2-2.7b's shared attention) is zero-padded to DP = 128
// in shared memory, two 64-column blocks of the 128-byte swizzle, as D = 32
// is padded to 64: it keeps D = 128's plan (64-key tiles, 214,016 B of
// shared memory) and its layouts.  S = Q K^T runs only the k-steps that
// hold data (TcPlan::kSteps: 5 of 16 columns at D = 80, where the padded
// plan would run 8); P V runs as m64n128k16 and only the first 80 output
// columns are stored.  m64n80k16 would cut the value product's tensor work
// by 3/8, but its MN-major V operand would end inside the second 64-column
// swizzle atom, a layout the wgmma descriptors name only in whole atoms;
// the padded plan keeps to the layouts the other head dims already run.
//
// Head dim 256 (paligemma-3b) has its own shared-memory plan (TcPlan): at
// 64 keys a warpgroup its ring would need 384 KB beside the 32 KB Q panel,
// against the 227 KB a block may have, so each warpgroup takes 32-key tiles
// (wgmma m64n32k16 for S) and the 3-stage ring of (K, V) tile pairs holds
// 192 KB: 230,400 B with the alignment slack.  The value product is one
// wgmma m64n256k16 a k-step, its accumulator 128 f32 registers a thread
// beside S's 16 and P's 8.  D <= 128 keeps its plan.
//
// Any head dim from 1 to 256 runs on one of the five plans (32, 64, 80,
// 128, 256), the smallest at least as wide, as D = 80 runs on D = 128's
// panels: the kernel takes the real D (Dr) at run time, loads Dr columns
// and zero-fills the rest of each panel, so S over the padded k-steps adds
// nothing and P V's padded columns are never stored.  The scale is the
// wrapper's, 1/sqrt(Dr).  A head dim that is a multiple of 8 keeps the
// 16-byte cp.async copies; any other (D = 100) fills the same swizzled
// panels by element loads and stores its output element by element
// (kNarrow), a path of the same kernel with the same products.  A head dim
// past 256 runs on the wide kernels (flash_tc_wide_kernel, flash_wide_kernel
// for f32): output panels of 256 columns (128 for f32) across blocks, S
// summed over k-chunks (128 columns; 64 for f32), no buffer that grows with D.
//
// f32 keeps the first, scalar design: one thread per query row, K/V tiles
// of 32 keys (16 at D = 256, so the static shared memory stays under 48 KB;
// 28,928 B at D = 80)
// staged through shared memory, scalar FMAs; at D = 256 a thread's q and
// accumulator rows spill to local memory.  Nothing on the main path sends
// f32 (the engine is bf16).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------------ f32
constexpr int kBQ = 64;  // query rows per block, one thread each

template <int D>  // the plan's width; Dr <= D columns hold data
__global__ void __launch_bounds__(kBQ)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             const int* __restrict__ prefix_len, float* __restrict__ out, int Hq, int Hkv, int Tq,
             int Tk, int Dr, long long q_sb, long long q_st, long long q_sh, long long k_sb,
             long long k_st, long long k_sh, long long v_sb, long long v_st, long long v_sh,
             long long o_sb, long long o_st, long long o_sh, int causal, int use_prefix,
             float scale) {
  constexpr int kBK = D > 128 ? 16 : 32;  // keys per shared-memory tile
  __shared__ float Ks[kBK][D];
  __shared__ float Vs[kBK][D];
  __shared__ float Ss[kBQ][kBK + 1];

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int q0 = (int)blockIdx.x * kBQ;
  const int qi = q0 + (int)threadIdx.x;
  const bool active = qi < Tq;
  const int off = Tk - Tq;
  const int q_pos = qi + off;
  const int plen = use_prefix ? prefix_len[b] : 0;

  float qv[D], acc[D];
  const float* qp = q + b * q_sb + (long long)qi * q_st + (long long)h * q_sh;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qv[d] = active && d < Dr ? qp[d] * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  int kend = Tk;
  if (causal) {
    const int last_q = min(q0 + kBQ, Tq) - 1 + off;
    kend = min(Tk, max(last_q + 1, plen));
  }
  const float* kb = k + b * k_sb + (long long)kvh * k_sh;
  const float* vb = v + b * v_sb + (long long)kvh * v_sh;

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();
    for (int e = threadIdx.x; e < kBK * D; e += kBQ) {
      const int r = e / D, d = e % D;
      const int t = k0 + r;
      Ks[r][d] = t < Tk && d < Dr ? kb[(long long)t * k_st + d] : 0.f;
      Vs[r][d] = t < Tk && d < Dr ? vb[(long long)t * v_st + d] : 0.f;
    }
    __syncthreads();
    if (!active) continue;

    // the tile's scores go through shared memory (one row per thread, padded
    // against bank conflicts), so the key loops need not be unrolled to keep
    // them in registers: unrolling 32 keys x D made the build take minutes
    float* srow = Ss[threadIdx.x];
    float m_tile = -INFINITY;
#pragma unroll 1
    for (int r = 0; r < kBK; ++r) {
      const int t = k0 + r;
      const bool ok = t < Tk && (!causal || t <= q_pos || t < plen);
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot += qv[d] * Ks[r][d];
      srow[r] = ok ? dot : -INFINITY;
      m_tile = fmaxf(m_tile, srow[r]);
    }
    if (m_tile == -INFINITY) continue;  // every key of this tile is masked
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);  // 0 before the first unmasked key
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll 1
    for (int r = 0; r < kBK; ++r) {
      const float p = srow[r] == -INFINITY ? 0.f : expf(srow[r] - m_new);
      l += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] += p * Vs[r][d];
    }
    m = m_new;
  }

  if (active) {
    float* op = out + b * o_sb + (long long)qi * o_st + (long long)h * o_sh;
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d < Dr) op[d] = acc[d] * inv;
  }
}

// ----------------------------------------------------------------- bf16
typedef __nv_bfloat16 bf16;

constexpr int kWG = 2;              // warpgroups per block, one per key tile of a pair
constexpr int kBM = 64;             // query rows per block (wgmma M)
constexpr int kThreads = kWG * 128;

// The bf16 kernel's shared-memory plan by head dim: the padded head dim DP
// (whole 64-column swizzle blocks), the k-steps of S that hold data
// (kSteps: the columns past D are zeros), the keys of a warpgroup's tile
// (kBN, wgmma's N for S), the keys of a ring stage (kPair: one tile per
// warpgroup) and the stages.  D = 256 halves the tile so that three stages
// fit beside the Q panel.
template <int D>
struct TcPlan {
  static constexpr int DP = (D + 63) / 64 * 64;
  static constexpr int kSteps = (D + 15) / 16;
  static constexpr int kBN = D > 128 ? 32 : 64;
  static constexpr int kPair = kWG * kBN;
  static constexpr int kStages = 3;
  static constexpr int kSmem = kBM * DP * 2 + kStages * 2 * kPair * DP * 2 + 1024;
  static_assert(kSmem <= 232448, "the plan fits a block's shared memory");
  static_assert((DP / 2 + 4) * 128 * 4 <= kStages * 2 * kPair * DP * 2, "the merge fits the ring");
  static_assert(D % 16 == 0 && kSteps * 16 <= DP, "S's k-steps cover D and stay in the panel");
};

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

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A panel of R rows x DP bf16 columns in shared memory, in the canonical
// 128-byte-swizzle layout of wgmma: column blocks of 64 elements (128 bytes
// per row) one after the other, each R rows of 128 bytes, the 16-byte chunk c
// of row r stored at chunk c ^ (r % 8).  The panel starts 1024-byte aligned.
template <int R>
__device__ __forceinline__ uint32_t panel_offset(int r, int c) {  // c: 16-byte chunk
  return (uint32_t)((c >> 3) * R * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// Rows [0, n_valid) of a (rows, Dr) bf16 matrix with row stride ``stride``
// (elements) into a panel of DP columns, by all the block's threads; rows
// past n_valid and columns past Dr are zeros.  With 16-byte copies (Dr a
// multiple of 8, ``any`` a valid address handed to the copies that read
// nothing), or (kNarrow) one element a load into the panel at ``gdst``,
// the generic address of ``dst``.
template <int R, int DP, bool kNarrow>
__device__ __forceinline__ void load_panel(uint32_t dst, uint8_t* gdst, const bf16* src,
                                           long long stride, int n_valid, int Dr, const bf16* any,
                                           int tid) {
  if constexpr (kNarrow) {
    const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
    for (int e = tid; e < R * DP; e += kThreads) {
      const int r = e / DP, col = e % DP;
      const uint16_t x = r < n_valid && col < Dr ? s16[r * stride + col] : 0;
      *reinterpret_cast<uint16_t*>(gdst + panel_offset<R>(r, col / 8) + (col % 8) * 2) = x;
    }
  } else {
    constexpr int kChunks = DP / 8;
    const int nc = Dr / 8;
#pragma unroll
    for (int e = tid; e < R * kChunks; e += kThreads) {
      const int r = e / kChunks, c = e % kChunks;
      const bool ok = r < n_valid && c < nc;
      cp_async16(dst + panel_offset<R>(r, c), ok ? src + r * stride + c * 8 : any, ok);
    }
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// pins an accumulator's registers around the asynchronous wgmma, so the
// compiler moves no access to them across the fence / wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D[64 x 64] = A[64 x 16] (smem, K-major) * B[16 x 64] (smem, K-major): D is
// only written, so no instruction before it counts as defining its input
__device__ __forceinline__ void wgmma_ss_n64_zero(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// D[64 x 64] += A[64 x 16] (smem, K-major) * B[16 x 64] (smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 32] = A[64 x 16] (smem, K-major) * B[16 x 32] (smem, K-major)
__device__ __forceinline__ void wgmma_ss_n32_zero(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
      : "l"(da), "l"(db), "r"(0));
}

// D[64 x 32] += A[64 x 16] (smem, K-major) * B[16 x 32] (smem, K-major)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] (registers) * B[16 x 64] (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] (registers) * B[16 x 128] (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] (registers) * B[16 x 256] (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S over one k-step: N = kBN keys (the first k-step overwrites s)
template <int N>
__device__ __forceinline__ void wgmma_qk(float (&s)[N / 2], uint64_t da, uint64_t db, bool first) {
  if constexpr (N == 32) {
    if (first)
      wgmma_ss_n32_zero(s, da, db);
    else
      wgmma_ss_n32(s, da, db);
  } else {
    if (first)
      wgmma_ss_n64_zero(s, da, db);
    else
      wgmma_ss_n64(s, da, db);
  }
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DP == 64)
    wgmma_rs_n64(o, a, db);
  else if constexpr (DP == 128)
    wgmma_rs_n128(o, a, db);
  else
    wgmma_rs_n256(o, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int D, bool kNarrow>  // the plan's width; Dr <= D columns hold data
__global__ void __launch_bounds__(kThreads)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                const int* __restrict__ prefix_len, bf16* __restrict__ out, int Hq, int Hkv, int Tq,
                int Tk, int Dr, long long q_sb, long long q_st, long long q_sh, long long k_sb,
                long long k_st, long long k_sh, long long v_sb, long long v_st, long long v_sh,
                long long o_sb, long long o_st, long long o_sh, int causal, int use_prefix,
                float scale_log2) {
  using P = TcPlan<D>;
  constexpr int DP = P::DP, kBN = P::kBN, kPair = P::kPair, kStages = P::kStages;
  constexpr uint32_t kQBytes = kBM * DP * 2;     // the Q panel
  constexpr uint32_t kKVBytes = kPair * DP * 2;  // one K (or V) tile pair
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base;                      // the Q panel, then the ring
  const uint32_t sRing = base + kQBytes;         // stage s: K pair at +2s, V pair after it

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * kBM;  // heaviest tiles first
  const int kvh = h / (Hq / Hkv);
  const int off = Tk - Tq;
  const int plen = use_prefix ? prefix_len[b] : 0;
  // the warpgroup index through a shuffle, so the compiler sees the control
  // flow around the wgmma as warp-uniform
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = (tid % 128) / 32, lane = tid % 32;

  const int first = q0 + off, last = min(q0 + kBM, Tq) - 1 + off;  // the rows' positions
  const int kend = causal ? min(Tk, max(last + 1, plen)) : Tk;
  const int n_pairs = kend > 0 ? (kend + kPair - 1) / kPair : 0;

  const bf16* qg = q + b * q_sb + (long long)h * q_sh + (long long)q0 * q_st;
  const bf16* kg = k + b * k_sb + (long long)kvh * k_sh;
  const bf16* vg = v + b * v_sb + (long long)kvh * v_sh;
  auto generic = [&](uint32_t a) { return smem_raw + (a - raw); };
  auto load_pair = [&](int i) {
    const uint32_t st = sRing + (uint32_t)(i % kStages) * 2 * kKVBytes;
    const int k0 = i * kPair;
    load_panel<kPair, DP, kNarrow>(st, generic(st), kg + (long long)k0 * k_st, k_st, Tk - k0, Dr, kg, tid);
    load_panel<kPair, DP, kNarrow>(st + kKVBytes, generic(st + kKVBytes), vg + (long long)k0 * v_st, v_st,
                                   Tk - k0, Dr, vg, tid);
  };
  load_panel<kBM, DP, kNarrow>(sQ, generic(sQ), qg, q_st, Tq - q0, Dr, qg, tid);
  if (n_pairs > 0) load_pair(0);
  cp_async_commit();
  if (n_pairs > 1) load_pair(1);
  cp_async_commit();

  // this thread's two accumulator rows (g and g + 8 of its warp's 16), the
  // same in both warpgroups
  const int row0 = q0 + warp * 16 + lane / 4;
  const int pos0 = row0 + off, pos1 = row0 + 8 + off;
  const int cq = 2 * (lane % 4);  // this lane's first column in each 8-column block

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // m in log2 units

  // Pair i holds key tiles 2i and 2i + 1; warpgroup w takes tile 2i + w, so
  // the two split the keys of the same 64 rows and the block's chain of
  // tiles is half as long.
  for (int i = 0; i < n_pairs; ++i) {
    cp_async_wait<1>();  // pair i (and Q) landed for this thread's copies
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();     // ... for every thread's copies; stage (i+2)%3 is free
    if (i + 2 < n_pairs) load_pair(i + 2);
    cp_async_commit();

    const int k0 = i * kPair + wg * kBN;
    if (k0 >= kend) continue;  // warpgroup-uniform: past the keys any row sees
    const uint32_t sK = sRing + (uint32_t)(i % kStages) * 2 * kKVBytes + wg * kBN * 128;
    const uint32_t sV = sK + kKVBytes;

    // S = Q K^T over the k-steps that hold data (the first one overwrites
    // s; the padded columns past D are zeros and add nothing)
    float s[kBN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < P::kSteps; ++kk) {
      const uint32_t koff = (uint32_t)(kk % 4) * 32;  // 16 columns into the 128-byte row
      const uint64_t da = smem_desc(sQ + (kk / 4) * kBM * 128 + koff, 16, 1024);
      const uint64_t db = smem_desc(sK + (kk / 4) * kPair * 128 + koff, 16, 1024);
      wgmma_qk<kBN>(s, da, db, kk == 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // online softmax; s[i] sits at row (i % 4 < 2 ? g : g + 8), key
    // k0 + 8 * (i / 4) + cq + i % 2.  Only the diagonal and ragged tiles
    // are masked.  The max is taken on the raw scores (the scale is
    // positive) and the scale folded into the exponent.
    const bool mask = k0 + kBN > Tk || (causal && k0 + kBN - 1 > first && k0 + kBN > plen);
    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) {
      if (mask) {
        const int key = k0 + 8 * (e / 4) + cq + (e % 2);
        const int pos = (e % 4) < 2 ? pos0 : pos1;
        if (key >= Tk || (causal && key > pos && key >= plen)) s[e] = -INFINITY;
      }
      if ((e % 4) < 2)
        t0 = fmaxf(t0, s[e]);
      else
        t1 = fmaxf(t1, s[e]);
    }
    t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 1));
    t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 2));
    t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 1));
    t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 2));
    const float n0 = fmaxf(m0, t0 * scale_log2), n1 = fmaxf(m1, t1 * scale_log2);
    const float u0 = n0 == -INFINITY ? 0.f : n0;  // a row with no key yet
    const float u1 = n1 == -INFINITY ? 0.f : n1;
    const float a0 = ex2(m0 - u0), a1 = ex2(m1 - u1);  // 0 while m is -inf
    m0 = n0;
    m1 = n1;
    float r0 = 0.f, r1 = 0.f;
    uint32_t p[kBN / 16][4];
#pragma unroll
    for (int e = 0; e < kBN / 2; e += 2) {
      const bool top = (e % 4) < 2;
      const float e0 = ex2(fmaf(s[e], scale_log2, -(top ? u0 : u1)));
      const float e1 = ex2(fmaf(s[e + 1], scale_log2, -(top ? u0 : u1)));
      if (top)
        r0 += e0 + e1;
      else
        r1 += e0 + e1;
      // register A fragment of k-step e / 8: a0 (g, keys 2c..), a1 (g + 8,
      // keys 2c..), a2 (g, keys 8 + 2c..), a3 (g + 8, keys 8 + 2c..)
      p[e / 8][(e % 8) / 2] = pack_bf16(e0, e1);
    }
    l0 = l0 * a0 + r0;
    l1 = l1 * a1 + r1;
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) o[e] *= (e % 4) < 2 ? a0 : a1;

    // O += P V over kBN / 16 k-steps of 16 keys (two 8-row swizzle atoms)
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_pv<DP>(o, p[kk], smem_desc(sV + kk * 16 * 128, kPair * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }
  cp_async_wait<0>();

  // merge the two warpgroups' (m, l, o) for the same rows through the ring's
  // shared memory: warpgroup 1 writes, warpgroup 0 merges and stores
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  float* xs = reinterpret_cast<float*>(smem_raw + (sRing - raw));  // [DP / 2 + 4][128]
  const int t = tid % 128;
  __syncthreads();  // every warpgroup is done with the ring
  if (wg == 1) {
    xs[0 * 128 + t] = m0;
    xs[1 * 128 + t] = m1;
    xs[2 * 128 + t] = l0;
    xs[3 * 128 + t] = l1;
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) xs[(4 + e) * 128 + t] = o[e];
  }
  __syncthreads();
  if (wg == 1 || q0 >= Tq) return;
  const float mb0 = xs[0 * 128 + t], mb1 = xs[1 * 128 + t];
  const float M0 = fmaxf(m0, mb0), M1 = fmaxf(m1, mb1);
  // the weight of each side's sums; 0 for a side that saw no key
  const float ca0 = M0 == -INFINITY ? 0.f : ex2(m0 - M0), cb0 = M0 == -INFINITY ? 0.f : ex2(mb0 - M0);
  const float ca1 = M1 == -INFINITY ? 0.f : ex2(m1 - M1), cb1 = M1 == -INFINITY ? 0.f : ex2(mb1 - M1);
  const float L0 = l0 * ca0 + xs[2 * 128 + t] * cb0, L1 = l1 * ca1 + xs[3 * 128 + t] * cb1;
  const float inv0 = L0 > 0.f ? 1.f / L0 : 0.f, inv1 = L1 > 0.f ? 1.f / L1 : 0.f;
  bf16* op0 = out + b * o_sb + (long long)row0 * o_st + (long long)h * o_sh;
  bf16* op1 = op0 + 8 * o_st;
#pragma unroll
  for (int nb = 0; nb < DP / 8; ++nb) {
    const int col = nb * 8 + cq;
    if (col >= Dr) break;
    const float x0 = (o[4 * nb] * ca0 + xs[(4 + 4 * nb) * 128 + t] * cb0) * inv0;
    const float x1 = (o[4 * nb + 1] * ca0 + xs[(5 + 4 * nb) * 128 + t] * cb0) * inv0;
    const float x2 = (o[4 * nb + 2] * ca1 + xs[(6 + 4 * nb) * 128 + t] * cb1) * inv1;
    const float x3 = (o[4 * nb + 3] * ca1 + xs[(7 + 4 * nb) * 128 + t] * cb1) * inv1;
    if constexpr (kNarrow) {  // element stores: an odd Dr leaves pairs unaligned, the last one half out
      if (row0 < Tq) {
        op0[col] = __float2bfloat16_rn(x0);
        if (col + 1 < Dr) op0[col + 1] = __float2bfloat16_rn(x1);
      }
      if (row0 + 8 < Tq) {
        op1[col] = __float2bfloat16_rn(x2);
        if (col + 1 < Dr) op1[col + 1] = __float2bfloat16_rn(x3);
      }
    } else {
      if (row0 < Tq) *reinterpret_cast<__nv_bfloat162*>(op0 + col) = __floats2bfloat162_rn(x0, x1);
      if (row0 + 8 < Tq) *reinterpret_cast<__nv_bfloat162*>(op1 + col) = __floats2bfloat162_rn(x2, x3);
    }
  }
}

// ------------------------------------------------------- wide head dims
// A head dim past 256 (Dr > 256): no panel of D columns fits beside a ring,
// so each block computes one panel of at most kPanel output columns (a grid
// axis: blockIdx.x = head * n_panels + panel).  Its S = Q K^T sums over all
// Dr columns in k-chunks of 128 (two swizzle atoms), the Q chunk and the K
// chunk of a key pair streamed through a 3-stage ring (no whole-D Q panel:
// Q is read again for every key pair, from L2); then the online softmax as
// above and O += P V over its panel of V, a (kPair x kPanel) tile in a
// double buffer.  Every panel's block computes the same S in the same order,
// so their (m, l) agree and each panel's output is what one block over all
// Dr columns would write.  Each block re-reads all of K: at Dr = 512 the
// two panels' blocks do 1.5x the flops of one pass.  Plan: D = 256's tiles
// (32 keys a warpgroup, wgmma m64n32k16 for S, m64n256k16 for P V), 164,864
// bytes of shared memory whatever Dr is.  Loads go in one sequence of units
// per key pair (its n_chunks QK chunks, then its V tile), each unit one
// cp.async group issued two units ahead of its use.
constexpr int kPanel = 256;  // output columns a block
constexpr int kChunk = 128;  // columns of S's k-chunks

struct WidePlan {
  static constexpr int kBN = 32;                            // keys a warpgroup's tile
  static constexpr int kPair = kWG * kBN;                   // keys a pair
  static constexpr int kQBytes = kBM * kChunk * 2;          // a Q chunk
  static constexpr int kKBytes = kPair * kChunk * 2;        // a K chunk of the pair
  static constexpr int kQKStages = 3;
  static constexpr int kVBytes = kPair * kPanel * 2;        // the pair's V tile of the panel
  static constexpr int kSmem = kQKStages * (kQBytes + kKBytes) + 2 * kVBytes + 1024;
  static_assert(kSmem <= 232448, "the plan fits a block's shared memory");
  static_assert((kPanel / 2 + 4) * 128 * 4 <= kSmem - 1024, "the merge fits the ring");
};

template <bool kNarrow>
__global__ void __launch_bounds__(kThreads)
flash_tc_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const int* __restrict__ prefix_len, bf16* __restrict__ out, int Hq, int Hkv, int Tq,
                     int Tk, int Dr, int n_panels, long long q_sb, long long q_st, long long q_sh,
                     long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st,
                     long long v_sh, long long o_sb, long long o_st, long long o_sh, int causal,
                     int use_prefix, float scale_log2) {
  using P = WidePlan;
  constexpr int kBN = P::kBN, kPair = P::kPair;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQK = base;  // stage s: Q chunk, then the pair's K chunk
  const uint32_t sV = base + P::kQKStages * (P::kQBytes + P::kKBytes);  // buffer j at + j * kVBytes

  const int h = blockIdx.x / n_panels, p0 = (blockIdx.x % n_panels) * kPanel, b = blockIdx.z;
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * kBM;  // heaviest tiles first
  const int kvh = h / (Hq / Hkv);
  const int off = Tk - Tq;
  const int plen = use_prefix ? prefix_len[b] : 0;
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = (tid % 128) / 32, lane = tid % 32;

  const int first = q0 + off, last = min(q0 + kBM, Tq) - 1 + off;
  const int kend = causal ? min(Tk, max(last + 1, plen)) : Tk;
  const int n_pairs = kend > 0 ? (kend + kPair - 1) / kPair : 0;
  const int n_chunks = (Dr + kChunk - 1) / kChunk;
  const int n_units = n_pairs * (n_chunks + 1);  // per pair: its QK chunks, then its V tile

  const bf16* qg = q + b * q_sb + (long long)h * q_sh + (long long)q0 * q_st;
  const bf16* kg = k + b * k_sb + (long long)kvh * k_sh;
  const bf16* vg = v + b * v_sb + (long long)kvh * v_sh;
  auto generic = [&](uint32_t a) { return smem_raw + (a - raw); };
  auto qk_stage = [&](int u) {  // the ring stage of QK unit u (its index among the QK units)
    const int i = u / (n_chunks + 1), c = u % (n_chunks + 1);
    return sQK + (uint32_t)((i * n_chunks + c) % P::kQKStages) * (P::kQBytes + P::kKBytes);
  };
  auto load_unit = [&](int u) {
    const int i = u / (n_chunks + 1), c = u % (n_chunks + 1);
    const int k0 = i * kPair;
    if (c < n_chunks) {
      const uint32_t st = qk_stage(u);
      const int c0 = c * kChunk;
      load_panel<kBM, kChunk, kNarrow>(st, generic(st), qg + c0, q_st, Tq - q0, Dr - c0, qg, tid);
      load_panel<kPair, kChunk, kNarrow>(st + P::kQBytes, generic(st + P::kQBytes), kg + (long long)k0 * k_st + c0,
                                         k_st, Tk - k0, Dr - c0, kg, tid);
    } else {
      const uint32_t st = sV + (uint32_t)(i % 2) * P::kVBytes;
      load_panel<kPair, kPanel, kNarrow>(st, generic(st), vg + (long long)k0 * v_st + p0, v_st, Tk - k0, Dr - p0,
                                         vg, tid);
    }
  };
  if (n_units > 0) load_unit(0);
  cp_async_commit();
  if (n_units > 1) load_unit(1);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + lane / 4;
  const int pos0 = row0 + off, pos1 = row0 + 8 + off;
  const int cq = 2 * (lane % 4);

  float o[kPanel / 2];
#pragma unroll
  for (int i = 0; i < kPanel / 2; ++i) o[i] = 0.f;
  float s[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int u = 0; u < n_units; ++u) {
    cp_async_wait<1>();  // unit u landed for this thread's copies
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();     // ... for every thread's; the buffer of unit u + 2 is free
    if (u + 2 < n_units) load_unit(u + 2);
    cp_async_commit();

    const int i = u / (n_chunks + 1), c = u % (n_chunks + 1);
    const int k0 = i * kPair + wg * kBN;
    if (k0 >= kend) continue;  // warpgroup-uniform: past the keys any row sees
    if (c < n_chunks) {
      // S += Q_c K_c^T over the chunk's k-steps that hold data (the first
      // chunk's first overwrites s)
      const uint32_t st = qk_stage(u), sK = st + P::kQBytes + wg * kBN * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        if (c * kChunk + kk * 16 >= Dr) break;  // warpgroup-uniform
        const uint32_t koff = (uint32_t)(kk % 4) * 32;  // 16 columns into the 128-byte row
        const uint64_t da = smem_desc(st + (kk / 4) * kBM * 128 + koff, 16, 1024);
        const uint64_t db = smem_desc(sK + (kk / 4) * kPair * 128 + koff, 16, 1024);
        wgmma_qk<kBN>(s, da, db, c == 0 && kk == 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      continue;
    }

    // the pair's S is complete: online softmax as flash_tc_kernel's
    const bool mask = k0 + kBN > Tk || (causal && k0 + kBN - 1 > first && k0 + kBN > plen);
    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) {
      if (mask) {
        const int key = k0 + 8 * (e / 4) + cq + (e % 2);
        const int pos = (e % 4) < 2 ? pos0 : pos1;
        if (key >= Tk || (causal && key > pos && key >= plen)) s[e] = -INFINITY;
      }
      if ((e % 4) < 2)
        t0 = fmaxf(t0, s[e]);
      else
        t1 = fmaxf(t1, s[e]);
    }
    t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 1));
    t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 2));
    t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 1));
    t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 2));
    const float n0 = fmaxf(m0, t0 * scale_log2), n1 = fmaxf(m1, t1 * scale_log2);
    const float u0 = n0 == -INFINITY ? 0.f : n0;
    const float u1 = n1 == -INFINITY ? 0.f : n1;
    const float a0 = ex2(m0 - u0), a1 = ex2(m1 - u1);
    m0 = n0;
    m1 = n1;
    float r0 = 0.f, r1 = 0.f;
    uint32_t pf[kBN / 16][4];
#pragma unroll
    for (int e = 0; e < kBN / 2; e += 2) {
      const bool top = (e % 4) < 2;
      const float e0 = ex2(fmaf(s[e], scale_log2, -(top ? u0 : u1)));
      const float e1 = ex2(fmaf(s[e + 1], scale_log2, -(top ? u0 : u1)));
      if (top)
        r0 += e0 + e1;
      else
        r1 += e0 + e1;
      pf[e / 8][(e % 8) / 2] = pack_bf16(e0, e1);
    }
    l0 = l0 * a0 + r0;
    l1 = l1 * a1 + r1;
#pragma unroll
    for (int e = 0; e < kPanel / 2; ++e) o[e] *= (e % 4) < 2 ? a0 : a1;

    // O += P V over the panel's columns
    const uint32_t sVt = sV + (uint32_t)(i % 2) * P::kVBytes + wg * kBN * 128;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_rs_n256(o, pf[kk], smem_desc(sVt + kk * 16 * 128, kPair * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }
  cp_async_wait<0>();

  // merge the two warpgroups' (m, l, o) as flash_tc_kernel does
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  float* xs = reinterpret_cast<float*>(smem_raw + (base - raw));  // [kPanel / 2 + 4][128]
  const int t = tid % 128;
  __syncthreads();
  if (wg == 1) {
    xs[0 * 128 + t] = m0;
    xs[1 * 128 + t] = m1;
    xs[2 * 128 + t] = l0;
    xs[3 * 128 + t] = l1;
#pragma unroll
    for (int e = 0; e < kPanel / 2; ++e) xs[(4 + e) * 128 + t] = o[e];
  }
  __syncthreads();
  if (wg == 1 || q0 >= Tq) return;
  const float mb0 = xs[0 * 128 + t], mb1 = xs[1 * 128 + t];
  const float M0 = fmaxf(m0, mb0), M1 = fmaxf(m1, mb1);
  const float ca0 = M0 == -INFINITY ? 0.f : ex2(m0 - M0), cb0 = M0 == -INFINITY ? 0.f : ex2(mb0 - M0);
  const float ca1 = M1 == -INFINITY ? 0.f : ex2(m1 - M1), cb1 = M1 == -INFINITY ? 0.f : ex2(mb1 - M1);
  const float L0 = l0 * ca0 + xs[2 * 128 + t] * cb0, L1 = l1 * ca1 + xs[3 * 128 + t] * cb1;
  const float inv0 = L0 > 0.f ? 1.f / L0 : 0.f, inv1 = L1 > 0.f ? 1.f / L1 : 0.f;
  bf16* op0 = out + b * o_sb + (long long)row0 * o_st + (long long)h * o_sh + p0;
  bf16* op1 = op0 + 8 * o_st;
  const int dr = Dr - p0;  // the panel's columns that hold data
#pragma unroll
  for (int nb = 0; nb < kPanel / 8; ++nb) {
    const int col = nb * 8 + cq;
    if (col >= dr) break;
    const float x0 = (o[4 * nb] * ca0 + xs[(4 + 4 * nb) * 128 + t] * cb0) * inv0;
    const float x1 = (o[4 * nb + 1] * ca0 + xs[(5 + 4 * nb) * 128 + t] * cb0) * inv0;
    const float x2 = (o[4 * nb + 2] * ca1 + xs[(6 + 4 * nb) * 128 + t] * cb1) * inv1;
    const float x3 = (o[4 * nb + 3] * ca1 + xs[(7 + 4 * nb) * 128 + t] * cb1) * inv1;
    if constexpr (kNarrow) {
      if (row0 < Tq) {
        op0[col] = __float2bfloat16_rn(x0);
        if (col + 1 < dr) op0[col + 1] = __float2bfloat16_rn(x1);
      }
      if (row0 + 8 < Tq) {
        op1[col] = __float2bfloat16_rn(x2);
        if (col + 1 < dr) op1[col + 1] = __float2bfloat16_rn(x3);
      }
    } else {
      if (row0 < Tq) *reinterpret_cast<__nv_bfloat162*>(op0 + col) = __floats2bfloat162_rn(x0, x1);
      if (row0 + 8 < Tq) *reinterpret_cast<__nv_bfloat162*>(op1 + col) = __floats2bfloat162_rn(x2, x3);
    }
  }
}

// f32 past 256 columns: flash_kernel's design (a thread a query row, keys
// through shared memory, scalar FMAs, the key loops not unrolled: unrolled
// they made the build take minutes) with the same panel split, at kFPanel
// columns, so the thread's accumulator stays in registers.  A key tile's
// scores sum over Dr in chunks of kFChunk columns, the rows' q chunk staged
// beside the K chunk (q read again for every key tile).
constexpr int kFChunk = 64, kFPanel = 128, kFBK = 16;

__global__ void __launch_bounds__(kBQ)
flash_wide_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                  const int* __restrict__ prefix_len, float* __restrict__ out, int Hq, int Hkv, int Tq,
                  int Tk, int Dr, int n_panels, long long q_sb, long long q_st, long long q_sh,
                  long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st,
                  long long v_sh, long long o_sb, long long o_st, long long o_sh, int causal,
                  int use_prefix, float scale) {
  __shared__ float Qs[kBQ][kFChunk + 1];
  __shared__ float Ks[kFBK][kFChunk];
  __shared__ float Vs[kFBK][kFPanel];
  __shared__ float Ss[kBQ][kFBK + 1];  // a row's masked scores, read by the rolled key loop

  const int h = blockIdx.y / n_panels, p0 = (blockIdx.y % n_panels) * kFPanel, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int q0 = (int)blockIdx.x * kBQ;
  const int qi = q0 + (int)threadIdx.x;
  const bool active = qi < Tq;
  const int off = Tk - Tq;
  const int q_pos = qi + off;
  const int plen = use_prefix ? prefix_len[b] : 0;

  float acc[kFPanel];
#pragma unroll
  for (int d = 0; d < kFPanel; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  int kend = Tk;
  if (causal) {
    const int last_q = min(q0 + kBQ, Tq) - 1 + off;
    kend = min(Tk, max(last_q + 1, plen));
  }
  const float* qb = q + b * q_sb + (long long)q0 * q_st + (long long)h * q_sh;
  const float* kb = k + b * k_sb + (long long)kvh * k_sh;
  const float* vb = v + b * v_sb + (long long)kvh * v_sh;

  for (int k0 = 0; k0 < kend; k0 += kFBK) {
    float s[kFBK];
#pragma unroll
    for (int r = 0; r < kFBK; ++r) s[r] = 0.f;
    for (int c0 = 0; c0 < Dr; c0 += kFChunk) {
      __syncthreads();
      for (int e = threadIdx.x; e < kBQ * kFChunk; e += kBQ) {
        const int r = e / kFChunk, d = e % kFChunk;
        Qs[r][d] = q0 + r < Tq && c0 + d < Dr ? qb[(long long)r * q_st + c0 + d] * scale : 0.f;
      }
      for (int e = threadIdx.x; e < kFBK * kFChunk; e += kBQ) {
        const int r = e / kFChunk, d = e % kFChunk;
        const int t = k0 + r;
        Ks[r][d] = t < Tk && c0 + d < Dr ? kb[(long long)t * k_st + c0 + d] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kFBK; ++r) {
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < kFChunk; ++d) dot += Qs[threadIdx.x][d] * Ks[r][d];
        s[r] += dot;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kFBK * kFPanel; e += kBQ) {
      const int r = e / kFPanel, d = e % kFPanel;
      const int t = k0 + r;
      Vs[r][d] = t < Tk && p0 + d < Dr ? vb[(long long)t * v_st + p0 + d] : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    float m_tile = -INFINITY;
    float* srow = Ss[threadIdx.x];
#pragma unroll
    for (int r = 0; r < kFBK; ++r) {
      const int t = k0 + r;
      const bool ok = t < Tk && (!causal || t <= q_pos || t < plen);
      srow[r] = ok ? s[r] : -INFINITY;
      m_tile = fmaxf(m_tile, srow[r]);
    }
    if (m_tile == -INFINITY) continue;
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < kFPanel; ++d) acc[d] *= alpha;
#pragma unroll 1
    for (int r = 0; r < kFBK; ++r) {
      const float p = srow[r] == -INFINITY ? 0.f : expf(srow[r] - m_new);
      l += p;
#pragma unroll
      for (int d = 0; d < kFPanel; ++d) acc[d] += p * Vs[r][d];
    }
    m = m_new;
  }

  if (active) {
    float* op = out + b * o_sb + (long long)qi * o_st + (long long)h * o_sh + p0;
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int d = 0; d < kFPanel; ++d)
      if (p0 + d < Dr) op[d] = acc[d] * inv;
  }
}

template <bool kNarrow>
int launch_tc_wide(const void* q, const void* k, const void* v, const int* plen, void* out, int B, int Hq,
                   int Hkv, int Tq, int Tk, int Dr, long long q_sb, long long q_st, long long q_sh,
                   long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st,
                   long long v_sh, long long o_sb, long long o_st, long long o_sh, int causal, int use_prefix,
                   float scale, cudaStream_t stream) {
  constexpr int smem = WidePlan::kSmem;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_tc_wide_kernel<kNarrow>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int n_panels = (Dr + kPanel - 1) / kPanel;
  dim3 grid(Hq * n_panels, (Tq + kBM - 1) / kBM, B);
  flash_tc_wide_kernel<kNarrow><<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, plen, (bf16*)out, Hq, Hkv, Tq, Tk, Dr, n_panels, q_sb,
      q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh, causal, use_prefix,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <int D, bool kNarrow>
int launch_tc(const void* q, const void* k, const void* v, const int* plen, void* out, int B,
              int Hq, int Hkv, int Tq, int Tk, int Dr, long long q_sb, long long q_st, long long q_sh,
              long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st,
              long long v_sh, long long o_sb, long long o_st, long long o_sh, int causal,
              int use_prefix, float scale, cudaStream_t stream) {
  constexpr int smem = TcPlan<D>::kSmem;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_tc_kernel<D, kNarrow>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(Hq, (Tq + kBM - 1) / kBM, B);
  flash_tc_kernel<D, kNarrow><<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, plen, (bf16*)out, Hq, Hkv, Tq, Tk, Dr, q_sb,
      q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh, causal, use_prefix,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, const int* plen, void* out, int B,
               int Hq, int Hkv, int Tq, int Tk, int D, long long q_sb, long long q_st,
               long long q_sh, long long k_sb, long long k_st, long long k_sh, long long v_sb,
               long long v_st, long long v_sh, long long o_sb, long long o_st, long long o_sh,
               int causal, int use_prefix, float scale, cudaStream_t stream) {
  if (D > 256) {  // the panel split
    const int n_panels = (D + kFPanel - 1) / kFPanel;
    flash_wide_kernel<<<dim3((Tq + kBQ - 1) / kBQ, Hq * n_panels, B), kBQ, 0, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, plen, (float*)out, Hq, Hkv, Tq, Tk, D, n_panels, q_sb,
        q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh, causal, use_prefix, scale);
    return (int)cudaGetLastError();
  }
  dim3 grid((Tq + kBQ - 1) / kBQ, Hq, B);
#define FLASH(DD)                                                                              \
  flash_kernel<DD><<<grid, kBQ, 0, stream>>>(                                                  \
      (const float*)q, (const float*)k, (const float*)v, plen, (float*)out, Hq, Hkv, Tq, Tk, D, \
      q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh, causal,           \
      use_prefix, scale)
  // the smallest plan at least D wide
  if (D <= 32)
    FLASH(32);
  else if (D <= 64)
    FLASH(64);
  else if (D <= 80)
    FLASH(80);
  else if (D <= 128)
    FLASH(128);
  else
    FLASH(256);
#undef FLASH
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32 (scalar kernel), 1 = bfloat16 (tensor cores); q,
// k, v and out share it.  With narrow 0 the bf16 kernel reads rows with
// 16-byte copies: the wrapper guarantees a head dim that is a multiple of 8
// and 16-byte aligned base pointers and row strides; with narrow 1 it reads
// any layout with a contiguous head dim.  D is the real head dim, any D >= 1:
// up to 256 on the smallest plan at least as wide, past it on the wide
// kernels' column panels.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               const void* prefix_len, void* out, int B, int Hq, int Hkv, int Tq,
                               int Tk, int D, long long q_sb, long long q_st, long long q_sh,
                               long long k_sb, long long k_st, long long k_sh, long long v_sb,
                               long long v_st, long long v_sh, long long o_sb, long long o_st,
                               long long o_sh, int causal, int use_prefix, float scale,
                               int dtype, int narrow, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || Tq <= 0 || B <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* plen = (const int*)prefix_len;
  if (dtype == 0)
    return launch_f32(q, k, v, plen, out, B, Hq, Hkv, Tq, Tk, D, q_sb, q_st, q_sh, k_sb, k_st,
                      k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh, causal, use_prefix, scale, s);
  if (dtype != 1 || !(scale > 0.f) || (!narrow && D % 8)) return (int)cudaErrorInvalidValue;
#define ARGS q, k, v, plen, out, B, Hq, Hkv, Tq, Tk, D, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, \
             v_st, v_sh, o_sb, o_st, o_sh, causal, use_prefix, scale, s
  // the smallest plan at least D wide
#define PLAN(N) (narrow ? launch_tc<N, true>(ARGS) : launch_tc<N, false>(ARGS))
  if (D <= 32) return PLAN(32);
  if (D <= 64) return PLAN(64);
  if (D <= 80) return PLAN(80);
  if (D <= 128) return PLAN(128);
  if (D <= 256) return PLAN(256);
  return narrow ? launch_tc_wide<true>(ARGS) : launch_tc_wide<false>(ARGS);
#undef PLAN
#undef ARGS
}
