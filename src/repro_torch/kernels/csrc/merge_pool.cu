// The masked K-way cut-layer merge (forward reductions) for Hopper, CUDA
// C++ for sm_90a.
//
// Replaces the JAX package's Pallas kernel _merge_kernel
// (src/repro/kernels/merge_pool.py, launched by _merge_pool_fwd_call): the
// masked sum / avg / max / mul of a contiguous (K, B, D) stack into (B, D),
// accumulated in f32, in the stack's type (f32 or bf16), with the JAX
// package's neutrals:
//
//   sum  sum_k live_k x_k
//   avg  the sum over max(sum_k live_k, 1)
//   max  max_k of x_k, a dropped client (live_k == 0) counting as -3e38;
//        zeros when every client is dropped
//   mul  prod_k of x_k, a dropped client counting as 1
//
// The reduction runs over K only, so (B, D) is one flat run of n = B * D
// outputs and client k's plane starts k * n elements into the stack.
//
// Bound on an H100 SXM: bytes.  Each output reads K inputs and does a few
// flops per input; at the path's (4, 1024, 960) that is 19.7 MB to move
// (5.9 us at 3.35 TB/s) against 7.9 MFLOP.  So the design is a plain
// streaming kernel that keeps as many loads in flight as it can:
//
//  * One thread per 4 consecutive outputs, loaded as one 16-byte vector per
//    client (8 bytes in bf16).  K is a template parameter: all K loads are
//    issued before any is combined, so a thread has K vectors in flight.
//  * The grid covers the n / 4 vectors exactly (no tile is half masked, as
//    a power-of-two tile over D = 960 would be).
//  * A stack whose run n is not a multiple of 4, or whose stack or output
//    does not start on a vector boundary, takes the scalar path: the same
//    thread-per-4 layout, one element at a time, every element bounds
//    checked.  The last vector of a run is bounds checked the same way.
//  * K above 8 takes a runtime-K instantiation that combines each load
//    as it arrives.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int THREADS = 256;
constexpr float MAX_NEUTRAL = -3.0e38f;

enum Strategy { SUM = 0, AVG = 1, MAX = 2, MUL = 3 };

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &u.x, sizeof(lo));
  memcpy(&hi, &u.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  memcpy(&u.x, &lo, sizeof(lo));
  memcpy(&u.y, &hi, sizeof(hi));
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the strategy's neutral start and one combining step, per element
template <int STRATEGY>
__device__ __forceinline__ float start() {
  return STRATEGY == MAX ? MAX_NEUTRAL : STRATEGY == MUL ? 1.f : 0.f;
}

template <int STRATEGY>
__device__ __forceinline__ float combine(float acc, float x, float live) {
  if (STRATEGY == MAX) return fmaxf(acc, live > 0.f ? x : MAX_NEUTRAL);
  if (STRATEGY == MUL) return acc * (live > 0.f ? x : 1.f);
  return fmaf(x, live, acc);
}

template <int STRATEGY>
__device__ __forceinline__ float finish(float acc, float total) {
  if (STRATEGY == AVG) return acc / fmaxf(total, 1.f);
  if (STRATEGY == MAX) return total > 0.f ? acc : 0.f;
  return acc;
}

template <int STRATEGY>
__device__ __forceinline__ float4 combine4(float4 acc, float4 x, float live) {
  return make_float4(combine<STRATEGY>(acc.x, x.x, live),
                     combine<STRATEGY>(acc.y, x.y, live),
                     combine<STRATEGY>(acc.z, x.z, live),
                     combine<STRATEGY>(acc.w, x.w, live));
}

// K > 0: K is fixed and every load is issued first; K == 0: the runtime
// count k_rt, each load combined as it arrives
template <typename T, int K, int STRATEGY>
__global__ void __launch_bounds__(THREADS)
    merge_reduce_kernel(const T* __restrict__ x,
                        const float* __restrict__ live, T* __restrict__ out,
                        long long n, int k_rt, int vector_ok) {
  const int nk = K > 0 ? K : k_rt;
  const long long i0 =
      4 * (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x);
  if (i0 >= n) return;
  float total = 0.f;
  for (int k = 0; k < nk; ++k) total += live[k];

  if (vector_ok && i0 + 4 <= n) {
    float4 acc = make_float4(start<STRATEGY>(), start<STRATEGY>(),
                             start<STRATEGY>(), start<STRATEGY>());
    if constexpr (K > 0) {
      float4 v[K];
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = load4(x + k * n + i0);
#pragma unroll
      for (int k = 0; k < K; ++k) acc = combine4<STRATEGY>(acc, v[k], live[k]);
    } else {
      for (int k = 0; k < nk; ++k)
        acc = combine4<STRATEGY>(acc, load4(x + k * n + i0), live[k]);
    }
    store4(out + i0, make_float4(finish<STRATEGY>(acc.x, total),
                                 finish<STRATEGY>(acc.y, total),
                                 finish<STRATEGY>(acc.z, total),
                                 finish<STRATEGY>(acc.w, total)));
    return;
  }
  // the scalar path: a run that is not a multiple of 4, a misaligned start
  for (long long i = i0; i < i0 + 4 && i < n; ++i) {
    float acc = start<STRATEGY>();
    for (int k = 0; k < nk; ++k)
      acc = combine<STRATEGY>(acc, to_f32(x[k * n + i]), live[k]);
    store1(out + i, finish<STRATEGY>(acc, total));
  }
}

template <typename T, int K, int STRATEGY>
void launch_k(const void* x, const float* live, void* out, long long n,
              int k, int vector_ok, cudaStream_t stream) {
  const long long vectors = (n + 3) / 4;
  const unsigned blocks = static_cast<unsigned>((vectors + THREADS - 1) /
                                                THREADS);
  merge_reduce_kernel<T, K, STRATEGY><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), live, static_cast<T*>(out), n, k, vector_ok);
}

template <typename T, int STRATEGY>
void launch_s(const void* x, const float* live, void* out, long long n,
              int k, int vector_ok, cudaStream_t s) {
  switch (k) {
    case 1: return launch_k<T, 1, STRATEGY>(x, live, out, n, k, vector_ok, s);
    case 2: return launch_k<T, 2, STRATEGY>(x, live, out, n, k, vector_ok, s);
    case 3: return launch_k<T, 3, STRATEGY>(x, live, out, n, k, vector_ok, s);
    case 4: return launch_k<T, 4, STRATEGY>(x, live, out, n, k, vector_ok, s);
    case 5: return launch_k<T, 5, STRATEGY>(x, live, out, n, k, vector_ok, s);
    case 6: return launch_k<T, 6, STRATEGY>(x, live, out, n, k, vector_ok, s);
    case 7: return launch_k<T, 7, STRATEGY>(x, live, out, n, k, vector_ok, s);
    case 8: return launch_k<T, 8, STRATEGY>(x, live, out, n, k, vector_ok, s);
    default: return launch_k<T, 0, STRATEGY>(x, live, out, n, k, vector_ok, s);
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* live, void* out, long long n,
                   int k, int strategy, cudaStream_t s) {
  // a vector is 4 elements: the stack's planes (k * n) and both starts must
  // fall on a vector boundary
  const uintptr_t vec_bytes = 4 * sizeof(T);
  const int vector_ok = n % 4 == 0 &&
                        reinterpret_cast<uintptr_t>(x) % vec_bytes == 0 &&
                        reinterpret_cast<uintptr_t>(out) % vec_bytes == 0;
  switch (strategy) {
    case SUM: launch_s<T, SUM>(x, live, out, n, k, vector_ok, s); break;
    case AVG: launch_s<T, AVG>(x, live, out, n, k, vector_ok, s); break;
    case MAX: launch_s<T, MAX>(x, live, out, n, k, vector_ok, s); break;
    case MUL: launch_s<T, MUL>(x, live, out, n, k, vector_ok, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: the contiguous (K, B, D) stack, n = B * D elements per client; live:
// (K,) f32 flags on the same card; out: contiguous (B, D).  strategy: 0
// sum, 1 avg, 2 max, 3 mul.  dtype: 0 f32, 1 bf16 (stack and output).
// Launches on ``stream`` without synchronizing; returns cudaGetLastError()
// after the launch (0 = success).  ``device`` is the card that ``stream``
// and the tensors belong to: this library carries its own CUDA runtime,
// whose current device is set here.
int repro_merge_reduce(const void* x, const void* live, void* out,
                       long long n, int K, int strategy, int dtype,
                       int device, void* stream) {
  if (n < 1 || K < 1 || (n + 3) / 4 / THREADS >= 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const float* lv = static_cast<const float*>(live);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0   ? launch<float>(x, lv, out, n, K, strategy, s)
      : dtype == 1 ? launch<__nv_bfloat16>(x, lv, out, n, K, strategy, s)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
