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
// memory rate stops bounding, so operations bound it: a kernel on the tensor
// cores (wgmma, TMA-fed tiles) is the way to its bound, and is later work.
// This first version is simple and right: one block per (row, query head,
// 64-query tile), one thread per query row holding its query and its f32
// accumulator in registers, K/V tiles of 32 keys staged through shared
// memory (read once per block), each tile's scores kept in shared memory,
// an online softmax in f32 over the tiles,
// and the tiles wholly in the future of the whole query tile skipped.
// Ragged Tq and Tk are masked, so no length needs a divisor.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;  // query rows per block, one thread each
constexpr int kBK = 32;  // keys per shared-memory tile

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T, int D>
__global__ void __launch_bounds__(kBQ)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const int* __restrict__ prefix_len, T* __restrict__ out, int Hq, int Hkv, int Tq,
             int Tk, long long q_sb, long long q_st, long long q_sh, long long k_sb,
             long long k_st, long long k_sh, long long v_sb, long long v_st, long long v_sh,
             long long o_sb, long long o_st, long long o_sh, int causal, int use_prefix,
             float scale) {
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
  const T* qp = q + b * q_sb + (long long)qi * q_st + (long long)h * q_sh;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qv[d] = active ? ld(qp + d) * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  int kend = Tk;
  if (causal) {
    const int last_q = min(q0 + kBQ, Tq) - 1 + off;
    kend = min(Tk, max(last_q + 1, plen));
  }
  const T* kb = k + b * k_sb + (long long)kvh * k_sh;
  const T* vb = v + b * v_sb + (long long)kvh * v_sh;

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();
    for (int e = threadIdx.x; e < kBK * D; e += kBQ) {
      const int r = e / D, d = e % D;
      const int t = k0 + r;
      Ks[r][d] = t < Tk ? ld(kb + (long long)t * k_st + d) : 0.f;
      Vs[r][d] = t < Tk ? ld(vb + (long long)t * v_st + d) : 0.f;
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
    T* op = out + b * o_sb + (long long)qi * o_st + (long long)h * o_sh;
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) st(op + d, acc[d] * inv);
  }
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, const int* plen, void* out, int B,
                 int Hq, int Hkv, int Tq, int Tk, int D, long long q_sb, long long q_st,
                 long long q_sh, long long k_sb, long long k_st, long long k_sh, long long v_sb,
                 long long v_st, long long v_sh, long long o_sb, long long o_st, long long o_sh,
                 int causal, int use_prefix, float scale, cudaStream_t stream) {
  dim3 grid((Tq + kBQ - 1) / kBQ, Hq, B);
#define FLASH(DD)                                                                         \
  flash_kernel<T, DD><<<grid, kBQ, 0, stream>>>(                                         \
      (const T*)q, (const T*)k, (const T*)v, plen, (T*)out, Hq, Hkv, Tq, Tk, q_sb, q_st,  \
      q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh, causal, use_prefix,     \
      scale)
  switch (D) {
    case 32: FLASH(32); break;
    case 64: FLASH(64); break;
    case 128: FLASH(128); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and out share it)
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               const void* prefix_len, void* out, int B, int Hq, int Hkv, int Tq,
                               int Tk, int D, long long q_sb, long long q_st, long long q_sh,
                               long long k_sb, long long k_st, long long k_sh, long long v_sb,
                               long long v_st, long long v_sh, long long o_sb, long long o_st,
                               long long o_sh, int causal, int use_prefix, float scale,
                               int dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || Tq <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* plen = (const int*)prefix_len;
#define ARGS q, k, v, plen, out, B, Hq, Hkv, Tq, Tk, D, q_sb, q_st, q_sh, k_sb, k_st, k_sh, \
             v_sb, v_st, v_sh, o_sb, o_st, o_sh, causal, use_prefix, scale, s
  if (dtype == 0) return launch_typed<float>(ARGS);
  if (dtype == 1) return launch_typed<__nv_bfloat16>(ARGS);
#undef ARGS
  return (int)cudaErrorInvalidValue;
}
