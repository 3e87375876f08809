// Fused KV reconstruction for the CacheGen decode path (Hopper, sm_90a).
//
// K1 kv_dequant_tokens replaces src/repro/kernels/kvquant.py:kv_dequant_tokens_pallas
// K2 kv_lossless_tokens replaces src/repro/kernels/kvquant.py:kv_lossless_tokens_pallas
//
// Both turn entropy-decoded symbols into whole token groups: slot 0 of each
// group is the anchor, slots 1..g-1 are anchor + dequantized delta, cast to
// the cache's type.  Each output element costs three or four flops against
// 4-8 bytes moved, so the card's memory rate bounds both (about 0.002
// flop/byte, far under the ~300 flop/byte where the tensor cores would
// bound).  The design reads every input byte once and writes every output
// byte once, in one pass: one thread per output element, a grid-stride loop,
// neighbouring threads on neighbouring channels so every warp reads and
// writes contiguous runs.  Unlike the TPU kernel there is no block of whole
// groups, so G needs no divisor.
//
// K2 must equal quant.lossless_reconstruct bit for bit in f32, so it spells
// its multiply and add as __fmul_rn/__fadd_rn: nvcc may not contract them
// into an FMA.  K1 may contract; its tolerance covers one rounding.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void store(float* out, long long i, float x) { out[i] = x; }
__device__ __forceinline__ void store(__nv_bfloat16* out, long long i, float x) {
  out[i] = __float2bfloat16_rn(x);
}

int grid_for(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  const long long cap = 132LL * 32;  // enough blocks in flight on 132 SMs
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return (int)blocks;
}

template <typename TOut>
__global__ void dequant_tokens_kernel(const uint16_t* __restrict__ d_sym,
                                      const float* __restrict__ anchors,
                                      const float* __restrict__ bins,
                                      TOut* __restrict__ out, long long total,
                                      int G, int gm1, int C, float qmax) {
  const int g = gm1 + 1;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    const long long rest = i / C;
    const int j = (int)(rest % g);
    const long long bg = rest / g;  // b * G + group
    const float anchor = anchors[bg * C + c];
    float x = anchor;
    if (j > 0) {
      const float d = (float)d_sym[(bg * gm1 + (j - 1)) * C + c] - qmax;
      x = d * bins[bg / G] + anchor;
    }
    store(out, i, x);
  }
}

template <typename TOut>
__global__ void lossless_tokens_kernel(const uint16_t* __restrict__ d_sym,
                                       const uint16_t* __restrict__ a_sym,
                                       const float* __restrict__ scales,
                                       TOut* __restrict__ out, long long total,
                                       int gm1, int C) {
  const int g = gm1 + 1;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    const long long rest = i / C;
    const int j = (int)(rest % g);
    const long long bg = rest / g;
    const float s = scales[bg];
    const float q_a = __fadd_rn((float)a_sym[bg * C + c], -128.0f);
    float x;
    if (j == 0) {
      x = __fmul_rn(q_a, s);
    } else {
      const float q_d = __fadd_rn((float)d_sym[(bg * gm1 + (j - 1)) * C + c], -254.0f);
      x = __fmul_rn(__fadd_rn(q_d, q_a), s);
    }
    store(out, i, x);
  }
}

}  // namespace

extern "C" int kv_dequant_tokens(const void* d_sym, const void* anchors, const void* bins,
                                 void* out, long long B, int G, int gm1, int C, int qmax,
                                 int out_bf16, void* stream) {
  const long long total = B * G * (long long)(gm1 + 1) * C;
  if (total == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const int blocks = grid_for(total, threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (out_bf16) {
    dequant_tokens_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const uint16_t*)d_sym, (const float*)anchors, (const float*)bins,
        (__nv_bfloat16*)out, total, G, gm1, C, (float)qmax);
  } else {
    dequant_tokens_kernel<float><<<blocks, threads, 0, s>>>(
        (const uint16_t*)d_sym, (const float*)anchors, (const float*)bins, (float*)out,
        total, G, gm1, C, (float)qmax);
  }
  return (int)cudaGetLastError();
}

extern "C" int kv_lossless_tokens(const void* d_sym, const void* a_sym, const void* scales,
                                  void* out, long long B, int G, int gm1, int C, int out_bf16,
                                  void* stream) {
  const long long total = B * G * (long long)(gm1 + 1) * C;
  if (total == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const int blocks = grid_for(total, threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (out_bf16) {
    lossless_tokens_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const uint16_t*)d_sym, (const uint16_t*)a_sym, (const float*)scales,
        (__nv_bfloat16*)out, total, gm1, C);
  } else {
    lossless_tokens_kernel<float><<<blocks, threads, 0, s>>>(
        (const uint16_t*)d_sym, (const uint16_t*)a_sym, (const float*)scales, (float*)out,
        total, gm1, C);
  }
  return (int)cudaGetLastError();
}
