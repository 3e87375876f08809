// One-token GQA decode attention, split-KV flash-decoding (Hopper, sm_90a).
//
// Replaces src/repro/kernels/decode_attention.py:decode_attention_pallas.
//
// q (B, Hq, D) attends over the cache K/V read in their native serving
// layout (B, S, Hkv, D) through strides (no head-major copy of the cache),
// masked to the first kv_len[b] positions; a row with kv_len == 0 outputs 0.
//
// Bound: each cached K/V byte is used for 2 * Hq/Hkv flops, about 3 flops
// per byte at Hq/Hkv = 3, so the memory rate bounds the kernel.  The design
// reads every valid K/V row exactly once: one block per (row, KV head,
// S-split) serves all Hq/Hkv query heads of its group, and splits wholly
// past kv_len read nothing.  Within a block each warp takes four tokens at a
// time, all their loads in flight together (32 lanes x D/32 elements per
// row, coalesced), and keeps its own online softmax (max, sum, acc) in
// registers in f32; the warps merge through
// shared memory and each block writes one partial (m, l, acc) per query
// head.  A second, small launch merges the splits.  Unlike the TPU kernel,
// S needs no divisor: the last split is ragged.
//
// The kernels are compiled per cache dtype only: q is read (once per block)
// and the output written (once per element) through a runtime dtype flag, so
// an f32 model over the serving cache's bf16 K/V needs no instantiation of
// its own.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kMaxRep = 16;  // query heads per KV head
constexpr int kWarps = 4;
constexpr int kUnroll = 4;  // tokens in flight per warp

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
// q and out are f32 or bf16, chosen at run time
__device__ __forceinline__ float ld_any(const void* p, long long i, bool bf16) {
  return bf16 ? ld((const __nv_bfloat16*)p + i) : ld((const float*)p + i);
}
__device__ __forceinline__ void st_any(void* p, long long i, float x, bool bf16) {
  if (bf16)
    ((__nv_bfloat16*)p)[i] = __float2bfloat16_rn(x);
  else
    ((float*)p)[i] = x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename TKV, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
split_kernel(const void* __restrict__ q, bool q_bf16, const TKV* __restrict__ k,
             const TKV* __restrict__ v, const int* __restrict__ kv_len, float* __restrict__ part_m,
             float* __restrict__ part_l, float* __restrict__ part_acc, int Hq, int Hkv, int S,
             int n_splits, long long q_sb, long long q_sh, long long k_sb, long long k_ss,
             long long k_sh, long long v_sb, long long v_ss, long long v_sh, int split_size,
             float scale) {
  constexpr int D = DPL * 32;
  __shared__ float sm_m[kWarps][kMaxRep];
  __shared__ float sm_l[kWarps][kMaxRep];
  __shared__ float sm_acc[kWarps][kMaxRep][D];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int rep = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int len = kv_len[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int s0 = split * split_size;
  const int s1 = min(s0 + split_size, len);
  const long long pbase = ((long long)b * Hq + (long long)h * rep) * n_splits + split;

  if (s0 >= s1) {  // nothing valid in this split: an empty partial, no reads
    for (int e = threadIdx.x; e < rep * D; e += blockDim.x) {
      const int r = e / D, d = e % D;
      part_acc[(pbase + (long long)r * n_splits) * D + d] = 0.f;
      if (d == 0) {
        part_m[pbase + (long long)r * n_splits] = -INFINITY;
        part_l[pbase + (long long)r * n_splits] = 0.f;
      }
    }
    return;
  }

  float qr[kMaxRep][DPL];
  float m[kMaxRep], l[kMaxRep], acc[kMaxRep][DPL];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      acc[r][i] = 0.f;
      qr[r][i] = r < rep
                     ? ld_any(q, b * q_sb + (long long)(h * rep + r) * q_sh + i * 32 + lane, q_bf16) *
                           scale
                     : 0.f;
    }
  }

  // each warp takes kUnroll consecutive tokens per step and issues all their
  // loads before the first use: the online softmax is a dependent chain, so
  // one token per step would wait out a full memory latency per token
  for (int t0 = s0 + warp * kUnroll; t0 < s1; t0 += kWarps * kUnroll) {
    float kk[kUnroll][DPL], vv[kUnroll][DPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = min(t0 + u, s1 - 1);  // a ragged tail re-reads a valid row, unused
      const TKV* kp = k + b * k_sb + (long long)t * k_ss + (long long)h * k_sh;
      const TKV* vp = v + b * v_sb + (long long)t * v_ss + (long long)h * v_sh;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        kk[u][i] = ld(kp + i * 32 + lane);
        vv[u][i] = ld(vp + i * 32 + lane);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u >= s1) break;  // warp-uniform
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < rep) {
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < DPL; ++i) part += qr[r][i] * kk[u][i];
          const float s = warp_sum(part);
          const float m_new = fmaxf(m[r], s);
          const float alpha = expf(m[r] - m_new);  // 0 on the first token
          const float p = expf(s - m_new);
          l[r] = l[r] * alpha + p;
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] = acc[r][i] * alpha + p * vv[u][i];
          m[r] = m_new;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r < rep) {
      if (lane == 0) {
        sm_m[warp][r] = m[r];
        sm_l[warp][r] = l[r];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) sm_acc[warp][r][i * 32 + lane] = acc[r][i];
    }
  }
  __syncthreads();

  // merge the warps: thread e handles (r, d) pairs
  for (int e = threadIdx.x; e < rep * D; e += blockDim.x) {
    const int r = e / D, d = e % D;
    float M = -INFINITY;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][r]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      if (sm_l[w][r] > 0.f) {  // a warp that saw no token has m = -inf
        const float c = expf(sm_m[w][r] - M);
        L += sm_l[w][r] * c;
        A += sm_acc[w][r][d] * c;
      }
    }
    const long long p = pbase + (long long)r * n_splits;
    part_acc[p * D + d] = A;
    if (d == 0) {
      part_m[p] = M;
      part_l[p] = L;
    }
  }
}

__global__ void combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                               const float* __restrict__ part_acc, void* __restrict__ out,
                               bool out_bf16, int n_splits, int D) {
  const long long bh = blockIdx.x;  // b * Hq + query head
  const float* pm = part_m + bh * n_splits;
  const float* pl = part_l + bh * n_splits;
  float M = -INFINITY;
  for (int s = 0; s < n_splits; ++s)
    if (pl[s] > 0.f) M = fmaxf(M, pm[s]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float L = 0.f, A = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      if (pl[s] > 0.f) {
        const float c = expf(pm[s] - M);
        L += pl[s] * c;
        A += part_acc[(bh * n_splits + s) * D + d] * c;
      }
    }
    st_any(out, bh * D + d, L > 0.f ? A / L : 0.f, out_bf16);
  }
}

template <typename TKV>
int launch_typed(const void* q, bool q_bf16, const void* k, const void* v, const int* kv_len,
                 void* out, float* pm, float* pl, float* pa, int B, int Hq, int Hkv, int S, int D,
                 int n_splits, long long q_sb, long long q_sh, long long k_sb, long long k_ss,
                 long long k_sh, long long v_sb, long long v_ss, long long v_sh, int split_size,
                 float scale, cudaStream_t stream) {
  dim3 grid(n_splits, Hkv, B);
  const TKV* kk = (const TKV*)k;
  const TKV* vv = (const TKV*)v;
#define SPLIT(DPL)                                                                           \
  split_kernel<TKV, DPL><<<grid, kWarps * 32, 0, stream>>>(                                  \
      q, q_bf16, kk, vv, kv_len, pm, pl, pa, Hq, Hkv, S, n_splits, q_sb, q_sh, k_sb, k_ss, \
      k_sh, v_sb, v_ss, v_sh, split_size, scale)
  switch (D) {
    case 32: SPLIT(1); break;
    case 64: SPLIT(2); break;
    case 128: SPLIT(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPLIT
  const int err = (int)cudaGetLastError();
  if (err) return err;
  combine_kernel<<<B * Hq, D, 0, stream>>>(pm, pl, pa, out, q_bf16, n_splits, D);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; the output has q's dtype
extern "C" int decode_attention(const void* q, const void* k, const void* v, const void* kv_len,
                                void* out, void* part_m, void* part_l, void* part_acc, int B,
                                int Hq, int Hkv, int S, int D, int n_splits, long long q_sb,
                                long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                                long long v_sb, long long v_ss, long long v_sh, int split_size,
                                float scale, int q_dtype, int kv_dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || Hq / Hkv > kMaxRep) return (int)cudaErrorInvalidValue;
  if ((q_dtype != 0 && q_dtype != 1) || (kv_dtype != 0 && kv_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const bool q_bf16 = q_dtype == 1;
#define ARGS q, q_bf16, k, v, (const int*)kv_len, out, (float*)part_m, (float*)part_l, \
             (float*)part_acc, B, Hq, Hkv, S, D, n_splits, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, \
             v_ss, v_sh, split_size, scale, (cudaStream_t)stream
  if (kv_dtype == 1) return launch_typed<__nv_bfloat16>(ARGS);
  return launch_typed<float>(ARGS);
#undef ARGS
}
