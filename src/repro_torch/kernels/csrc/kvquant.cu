// Fused KV reconstruction for the CacheGen decode path (Hopper, sm_90a).
//
// K1 kv_dequant_tokens replaces src/repro/kernels/kvquant.py:kv_dequant_tokens_pallas
// K2 kv_lossless_tokens replaces src/repro/kernels/kvquant.py:kv_lossless_tokens_pallas
// K5 kv_quant           replaces src/repro/kernels/kvquant.py:kv_quant_pallas
// K6 kv_dequant         replaces src/repro/kernels/kvquant.py:kv_dequant_pallas
//
// K1/K2 turn entropy-decoded symbols into whole token groups: slot 0 of each
// group is the anchor, slots 1..g-1 are anchor + dequantized delta, cast to
// the cache's type.  K6 is the delta-only form of K1 (slots 1..g-1 alone;
// the caller places the anchors).  K5 is the encoder's mirror: delta against
// the group's anchor, divide by the bin, round half to even, clip, bias.
// Each element costs one to four flops against 6-10 bytes moved, so the
// card's memory rate is the only bound these passes should meet (well under
// 1 flop/byte, far under the ~300 flop/byte where the tensor cores would
// bound).  Every input byte is read once and every output byte written once.
//
// All four: one thread per (row b, group, vector of V channels).  The first
// design, one thread per output element, spent its time on integer work, not
// bytes: every element recovered its coordinates with 64-bit division and
// modulo (three or four of them), loaded its anchor and bin (K2: scale)
// again, and moved 2-4 bytes per access; at ~80 integer instructions an
// element the SMs' issue rate, not memory, set its time (0.9-1.25 TB/s).
// Now b comes from blockIdx.y, the group from one 32-bit division per
// thread, and the thread walks its group's slots itself, with the row's bin
// (K2: the group's scale) and the group's anchor vector in registers
// throughout.  Its accesses are V elements wide, up to 16 bytes (K5 reads
// its f32 slots at V = 8 in two), and it issues the loads of several slots
// (kUnrollSym, kUnrollK5) before their arithmetic and stores, so each
// thread keeps four to eight 16-byte loads in flight.  Bytes now bound them:
// on an H100 they move 2.8-2.9 TB/s, 84-88% of 3.35 TB/s.  The wrapper
// picks V (8, 4, 2 or 1): the largest that divides C with every pointer
// aligned to its access width, and whose output a thread stores in one
// access of at most 16 bytes, so V = 4 for an f32 output.  Two 16-byte
// stores to one 32-byte span per thread held K6 (f32 out) at 61% of its
// bound; one store reached 84%.  All four widths are instantiations of the
// same kernel.  Streaming stores (__stcs) measured no faster.  K1 and K6
// share one body (dequant_groups): K6 is K1 without the anchor slot.
//
// K2 must equal quant.lossless_reconstruct bit for bit in f32, and K6 its
// plain version, so both spell their multiply and add as
// __fmul_rn/__fadd_rn: nvcc may not contract them into an FMA.  In bf16 each
// is one round-to-nearest cast of that f32 value, as in the plain versions.
// K1 may contract; its tolerance covers one rounding.  K5's symbols must
// equal the plain version's (and the reference's) bit for bit: the
// subtraction and the IEEE division are __fsub_rn/__fdiv_rn (the library is
// built without fast math), and rintf rounds half to even as jnp.round does.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
// slots whose loads a thread issues before their arithmetic and stores: 8
// for the kernels that read uint16 symbols (K1, K2, K6: 9 x 2 bytes a
// channel per group), 4 for K5, whose f32 slots take twice the registers (72
// a thread at V = 8; capping it at 64 spills, and 2 slots or 8 measured
// slower on the H100)
constexpr int kUnrollSym = 8;
constexpr int kUnrollK5 = 4;
constexpr int kMaxGridY = 65535;

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

// The V elements at p, in accesses of min(16, V * sizeof(T)) bytes; p is
// aligned to that width (the wrapper's vector_width checks the base
// pointers, and every offset is a multiple of V elements).
template <int V, typename T>
__device__ __forceinline__ void load_vec(const T* p, T (&v)[V]) {
  constexpr int BYTES = V * (int)sizeof(T) < 16 ? V * (int)sizeof(T) : 16;
  using R = typename Raw<BYTES>::type;
#pragma unroll
  for (int i = 0; i < V; i += BYTES / (int)sizeof(T)) {
    const R r = __ldg(reinterpret_cast<const R*>(p + i));
    memcpy(&v[i], &r, BYTES);
  }
}

template <int V, typename T>
__device__ __forceinline__ void store_vec(T* p, const T (&v)[V]) {
  constexpr int BYTES = V * (int)sizeof(T) < 16 ? V * (int)sizeof(T) : 16;
  using R = typename Raw<BYTES>::type;
#pragma unroll
  for (int i = 0; i < V; i += BYTES / (int)sizeof(T)) {
    R r;
    memcpy(&r, &v[i], BYTES);
    *reinterpret_cast<R*>(p + i) = r;
  }
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Thread t of a row's G * C / V covers group t / (C / V) and channels
// (t % (C / V)) * V ..+V; rows are blockIdx.y, then every gridDim.y-th.
// Returns false for the threads past the row's end.
template <int V>
__device__ __forceinline__ bool group_vector(int G, int C, int& grp, int& c) {
  const int cv = C / V;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= G * cv) return false;
  grp = t / cv;
  c = (t - grp * cv) * V;
  return true;
}

// K1 (kTokens) and K6: `(d - qmax) * bin + anchor` for each delta slot of
// the thread's group and channels.  K1 writes the whole group, slot 0 the
// anchor, and may contract the multiply-add; K6 writes the g-1 delta slots
// alone, each a rounded multiply and then a rounded add.
template <bool kTokens, typename TOut, int V>
__device__ __forceinline__ void dequant_groups(
    const uint16_t* __restrict__ d_sym, const float* __restrict__ anchors,
    const float* __restrict__ bins, TOut* __restrict__ out, long long B, int G, int gm1,
    int C, float qmax) {
  int grp, c;
  if (!group_vector<V>(G, C, grp, c)) return;
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const long long bg = b * G + grp;
    const float bin = bins[b];
    const uint16_t* sym = d_sym + bg * gm1 * C + c;
    TOut* o = out + bg * (gm1 + kTokens) * C + c;
    float anchor[V];
    TOut y[V];
    load_vec<V>(anchors + bg * C + c, anchor);
    if constexpr (kTokens) {
#pragma unroll
      for (int k = 0; k < V; ++k) y[k] = from_float<TOut>(anchor[k]);
      store_vec<V>(o, y);
    }
    for (int j0 = 0; j0 < gm1; j0 += kUnrollSym) {
      uint16_t s[kUnrollSym][V];
#pragma unroll
      for (int u = 0; u < kUnrollSym; ++u)
        if (j0 + u < gm1) load_vec<V>(sym + (long long)(j0 + u) * C, s[u]);
#pragma unroll
      for (int u = 0; u < kUnrollSym; ++u) {
        if (j0 + u < gm1) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float d = (float)s[u][k] - qmax;
            y[k] = from_float<TOut>(kTokens ? d * bin + anchor[k]
                                            : __fadd_rn(__fmul_rn(d, bin), anchor[k]));
          }
          store_vec<V>(o + (long long)(j0 + u + kTokens) * C, y);
        }
      }
    }
  }
}

template <typename TOut, int V>
__global__ void __launch_bounds__(kThreads) dequant_tokens_kernel(
    const uint16_t* __restrict__ d_sym, const float* __restrict__ anchors,
    const float* __restrict__ bins, TOut* __restrict__ out, long long B, int G, int gm1,
    int C, float qmax) {
  dequant_groups<true, TOut, V>(d_sym, anchors, bins, out, B, G, gm1, C, qmax);
}

template <typename TOut, int V>
__global__ void __launch_bounds__(kThreads) dequant_kernel(
    const uint16_t* __restrict__ d_sym, const float* __restrict__ anchors,
    const float* __restrict__ bins, TOut* __restrict__ out, long long B, int G, int gm1,
    int C, float qmax) {
  dequant_groups<false, TOut, V>(d_sym, anchors, bins, out, B, G, gm1, C, qmax);
}

// K2: slot 0 `(a - 128) * s`, slot j `((d - 254) + (a - 128)) * s`, with the
// group's scale s and its V anchors' (a - 128) in registers.
template <typename TOut, int V>
__global__ void __launch_bounds__(kThreads) lossless_tokens_kernel(
    const uint16_t* __restrict__ d_sym, const uint16_t* __restrict__ a_sym,
    const float* __restrict__ scales, TOut* __restrict__ out, long long B, int G, int gm1,
    int C) {
  int grp, c;
  if (!group_vector<V>(G, C, grp, c)) return;
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const long long bg = b * G + grp;
    const float scale = scales[bg];
    const uint16_t* sym = d_sym + bg * gm1 * C + c;
    TOut* o = out + bg * (gm1 + 1) * C + c;
    uint16_t a[V];
    float q_a[V];
    TOut y[V];
    load_vec<V>(a_sym + bg * C + c, a);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      q_a[k] = __fadd_rn((float)a[k], -128.0f);
      y[k] = from_float<TOut>(__fmul_rn(q_a[k], scale));
    }
    store_vec<V>(o, y);
    for (int j0 = 0; j0 < gm1; j0 += kUnrollSym) {
      uint16_t s[kUnrollSym][V];
#pragma unroll
      for (int u = 0; u < kUnrollSym; ++u)
        if (j0 + u < gm1) load_vec<V>(sym + (long long)(j0 + u) * C, s[u]);
#pragma unroll
      for (int u = 0; u < kUnrollSym; ++u) {
        if (j0 + u < gm1) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float q_d = __fadd_rn((float)s[u][k], -254.0f);
            y[k] = from_float<TOut>(__fmul_rn(__fadd_rn(q_d, q_a[k]), scale));
          }
          store_vec<V>(o + (long long)(j0 + u + 1) * C, y);
        }
      }
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads) quant_kernel(
    const float* __restrict__ kv, const float* __restrict__ bins, uint16_t* __restrict__ out,
    long long B, int G, int gm1, int C, float qmax) {
  int grp, c;
  if (!group_vector<V>(G, C, grp, c)) return;
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const long long bg = b * G + grp;
    const float bin = bins[b];
    const float* x = kv + bg * (gm1 + 1) * C + c;
    uint16_t* o = out + bg * gm1 * C + c;
    float anchor[V];
    load_vec<V>(x, anchor);
    for (int j0 = 0; j0 < gm1; j0 += kUnrollK5) {
      float v[kUnrollK5][V];
#pragma unroll
      for (int u = 0; u < kUnrollK5; ++u)
        if (j0 + u < gm1) load_vec<V>(x + (long long)(j0 + u + 1) * C, v[u]);
#pragma unroll
      for (int u = 0; u < kUnrollK5; ++u) {
        if (j0 + u < gm1) {
          uint16_t q[V];
#pragma unroll
          for (int k = 0; k < V; ++k) {
            float r = rintf(__fdiv_rn(__fsub_rn(v[u][k], anchor[k]), bin));
            r = fminf(fmaxf(r, -qmax), qmax);
            q[k] = (uint16_t)(int)(r + qmax);
          }
          store_vec<V>(o + (long long)(j0 + u) * C, q);
        }
      }
    }
  }
}

// Calls f(std::integral_constant<int, V>()) for V in {8, 4, 2, 1}; false for
// any other V.
template <typename F>
bool with_vector_width(int V, F&& f) {
  switch (V) {
    case 8: f(std::integral_constant<int, 8>()); return true;
    case 4: f(std::integral_constant<int, 4>()); return true;
    case 2: f(std::integral_constant<int, 2>()); return true;
    case 1: f(std::integral_constant<int, 1>()); return true;
    default: return false;
  }
}

// The grid of all four kernels: x over a row's G * C / V vectors, y over rows.
bool row_grid(long long B, int G, int C, int V, dim3& grid) {
  if (V < 1 || C % V || (long long)G * C > INT_MAX) return false;
  grid = dim3((G * (C / V) + kThreads - 1) / kThreads, (unsigned)(B < kMaxGridY ? B : kMaxGridY));
  return true;
}

// K1 (kTokens) and K6 on the stream: dequant_tokens_kernel or
// dequant_kernel at V channels a thread, f32 or bf16 out.
template <bool kTokens>
int launch_dequant(const void* d_sym, const void* anchors, const void* bins, void* out,
                   long long B, int G, int gm1, int C, int qmax, int out_bf16, int V,
                   void* stream) {
  dim3 grid;
  if (!row_grid(B, G, C, V, grid)) return (int)cudaErrorInvalidValue;
  if (B * G * (long long)(gm1 + kTokens) * C == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const bool ok = with_vector_width(V, [&](auto v) {
    constexpr int W = decltype(v)::value;
    auto launch = [&](auto* o) {
      using T = std::remove_pointer_t<decltype(o)>;
      const auto kernel = kTokens ? dequant_tokens_kernel<T, W> : dequant_kernel<T, W>;
      kernel<<<grid, kThreads, 0, s>>>((const uint16_t*)d_sym, (const float*)anchors,
                                       (const float*)bins, o, B, G, gm1, C, (float)qmax);
    };
    if (out_bf16) launch((__nv_bfloat16*)out);
    else launch((float*)out);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int kv_quant(const void* kv, const void* bins, void* out, long long B, int G,
                        int gm1, int C, int qmax, int V, void* stream) {
  dim3 grid;
  if (!row_grid(B, G, C, V, grid)) return (int)cudaErrorInvalidValue;
  if (B * G * (long long)gm1 * C == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const bool ok = with_vector_width(V, [&](auto v) {
    quant_kernel<decltype(v)::value><<<grid, kThreads, 0, s>>>(
        (const float*)kv, (const float*)bins, (uint16_t*)out, B, G, gm1, C, (float)qmax);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

extern "C" int kv_dequant(const void* d_sym, const void* anchors, const void* bins, void* out,
                          long long B, int G, int gm1, int C, int qmax, int out_bf16, int V,
                          void* stream) {
  return launch_dequant<false>(d_sym, anchors, bins, out, B, G, gm1, C, qmax, out_bf16, V, stream);
}

extern "C" int kv_dequant_tokens(const void* d_sym, const void* anchors, const void* bins,
                                 void* out, long long B, int G, int gm1, int C, int qmax,
                                 int out_bf16, int V, void* stream) {
  return launch_dequant<true>(d_sym, anchors, bins, out, B, G, gm1, C, qmax, out_bf16, V, stream);
}

extern "C" int kv_lossless_tokens(const void* d_sym, const void* a_sym, const void* scales,
                                  void* out, long long B, int G, int gm1, int C, int out_bf16,
                                  int V, void* stream) {
  dim3 grid;
  if (!row_grid(B, G, C, V, grid)) return (int)cudaErrorInvalidValue;
  if (B * G * (long long)C == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const bool ok = with_vector_width(V, [&](auto v) {
    constexpr int W = decltype(v)::value;
    auto launch = [&](auto* o) {
      using T = std::remove_pointer_t<decltype(o)>;
      lossless_tokens_kernel<T, W><<<grid, kThreads, 0, s>>>(
          (const uint16_t*)d_sym, (const uint16_t*)a_sym, (const float*)scales, o, B, G, gm1, C);
    };
    if (out_bf16) launch((__nv_bfloat16*)out);
    else launch((float*)out);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}
