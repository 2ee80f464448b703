// The K-client cut-layer merge for Hopper, CUDA C++ for sm_90a: the masked
// reductions and their backward, and the concat merge with its backward.
//
// merge_reduce_kernel replaces the JAX package's Pallas kernel
// _merge_kernel (src/repro/kernels/merge_pool.py, launched by
// _merge_pool_fwd_call): the masked sum / avg / max / mul of a contiguous
// (K, B, D) stack into (B, D), accumulated in f32, in the stack's type (f32
// or bf16), with the JAX package's neutrals:
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
//
// merge_reduce_bwd_kernel replaces _merge_bwd_kernel (src/repro/kernels/
// merge_pool.py, launched by _merge_pool_bwd_call): the reductions' jacobian
// splitting.  From g (B, D), the merged output's gradient, it writes every
// client's dx_k (B, D), formed in f32 and stored in T, as the plain version
// (kernels/ref.py merge_pool_bwd) forms it, operation for operation:
//
//   sum  g * l_k
//   avg  g * (l_k / max(sum_k l_k, 1))
//   max  g / ties where x_k == out and l_k > 0, else 0; ties counts the live
//        clients holding the maximum, at least 1 (tied clients split it)
//   mul  g * (prefix_k * suffix_k) for a live client, else 0: the products of
//        the clients before and after k, a dropped client selected to 1
//        (never multiplied by its flag, so a NaN there reaches no one); the
//        prefix ascends from client 0, the suffix descends from client K-1.
//        The Pallas body's g * out / x_k is 0/0 at a live zero; this is
//        autodiff's answer there.
//
// Bound on an H100 SXM: bytes.  At the training path's avg (4, 2048, 960)
// f32 it reads g (7.9 MB) and writes four planes (31.5 MB): 11.7 us at
// 3.35 TB/s; max also reads the stack and the output, mul the stack.  The
// layout is the forward's (one flat run of n = B * D, client k's plane
// k * n in, one thread per 16-byte vector, the grid covering n / 4 vectors
// exactly, the same scalar path).  sum and avg load g's vector once and
// store K.  max and mul, with K fixed, issue all K stack loads first and
// keep them in registers, so the stack is read once from device memory (the
// Triton kernel this replaces read it twice for max, and K(K-1)/2 planes
// more for mul's suffixes).  The runtime-K instantiation (K > 8) reads
// again what it needs, from L1/L2.  The vector path stores evict-first.
//
// merge_concat_kernel replaces _concat_kernel (src/repro/kernels/
// merge_pool.py, launched by _concat_fwd_call) and merge_concat_bwd_kernel
// replaces _concat_bwd_kernel (launched by _concat_bwd_call):
//
//   forward   out[b, k*D + d] = x[k, b, d] * live[k]    x (K, B, D), out (B, K*D)
//   backward  dx[k, b, d] = g[b, k*D + d] * live[k]     g (B, K*D), dx (K, B, D)
//
// both formed in f32 and stored in T.  A dropped client's values are
// multiplied by its 0 flag, never skipped: a NaN or Inf there gives NaN, as
// the plain merge and the Pallas body give.  Any K, B, D >= 1.
//
// Bound on an H100 SXM: bytes.  Both directions are a permutation with one
// multiply per element: at the serving path's (4, 1024, 240) f32 they move
// 7.9 MB (2.35 us at 3.35 TB/s), at the training path's (4, 2048, 240)
// 15.7 MB (4.70 us).  The design:
//
//  * No staging.  The permutation moves whole client rows: row (k, b) is one
//    contiguous run of D elements on both sides, at (k*B + b)*D in the stack
//    and at b*K*D + k*D in the merged tensor.  So with D % 4 == 0 every
//    16-byte load and store is already coalesced and there is nothing to
//    transpose; a pass through shared memory or a TMA bulk copy would add a
//    step and move no fewer bytes.
//  * One thread per 4 consecutive stack elements, one 16-byte vector in f32
//    (8 bytes in bf16); the 1-D grid covers the K*B*D / 4 vectors exactly,
//    and each vector finds its client row with two 32-bit divisions.  Two
//    or four vectors per thread, all loads issued before the first store,
//    measured no faster (within 4%, the sign changing between runs; see
//    PERF.md): at the path's shapes one wave of blocks already keeps every
//    load in flight.
//  * The scalar path takes D % 4 != 0 and any operand whose start is not on
//    a vector boundary (a contiguous view at a storage offset): the same
//    grid, one element at a time, every element bounds checked.
//  * Index arithmetic is unsigned 32-bit: the entry points refuse
//    K*B*D >= 2^31, so no stack or merged offset, nor e + 4 past the last
//    element, can wrap.

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

__device__ __forceinline__ uint2 pack4(float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  memcpy(&u.x, &lo, sizeof(lo));
  memcpy(&u.y, &hi, sizeof(hi));
  return u;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = pack4(v);
}

// Evict-first stores (st.global.cs), for the backward's K gradient planes,
// which nothing here reads again: on the card they were faster than plain
// stores at the training shape, and no slower for max and mul.
__device__ __forceinline__ void store4_evict_first(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}

__device__ __forceinline__ void store4_evict_first(__nv_bfloat16* p,
                                                   float4 v) {
  __stcs(reinterpret_cast<uint2*>(p), pack4(v));
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

__device__ __forceinline__ float4 scale4(float4 v, float live) {
  return make_float4(v.x * live, v.y * live, v.z * live, v.w * live);
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ float4 splat4(float v) {
  return make_float4(v, v, v, v);
}

// the backward's per-element rules, as ref.merge_pool_bwd writes them
__device__ __forceinline__ float holds(float x, float out, float live) {
  return x == out && live > 0.f ? 1.f : 0.f;
}

__device__ __forceinline__ float4 holds4(float4 x, float4 out, float live) {
  return make_float4(holds(x.x, out.x, live), holds(x.y, out.y, live),
                     holds(x.z, out.z, live), holds(x.w, out.w, live));
}

__device__ __forceinline__ float4 credit4(float4 held, float4 share) {
  return make_float4(held.x > 0.f ? share.x : 0.f, held.y > 0.f ? share.y : 0.f,
                     held.z > 0.f ? share.z : 0.f,
                     held.w > 0.f ? share.w : 0.f);
}

__device__ __forceinline__ float4 ties4(float4 count) {
  return make_float4(fmaxf(count.x, 1.f), fmaxf(count.y, 1.f),
                     fmaxf(count.z, 1.f), fmaxf(count.w, 1.f));
}

__device__ __forceinline__ float4 div4(float4 a, float4 b) {
  return make_float4(a.x / b.x, a.y / b.y, a.z / b.z, a.w / b.w);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// sum and avg: the weight of client k's share of g
template <int STRATEGY>
__device__ __forceinline__ float weight(float live, float total) {
  return STRATEGY == AVG ? live / fmaxf(total, 1.f) : live;
}

// One vector of 4 elements at i0, K fixed: the stack's K vectors are loaded
// before any is used and stay in registers.
template <typename T, int K, int STRATEGY>
__device__ __forceinline__ void bwd_vector(const T* __restrict__ g,
                                           const float* __restrict__ live,
                                           const T* __restrict__ x,
                                           const T* __restrict__ out,
                                           T* __restrict__ dx, long long n,
                                           long long i0) {
  const float4 gv = load4(g + i0);
  if constexpr (STRATEGY == SUM || STRATEGY == AVG) {
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) total += live[k];
#pragma unroll
    for (int k = 0; k < K; ++k)
      store4_evict_first(dx + k * n + i0,
                         scale4(gv, weight<STRATEGY>(live[k], total)));
  } else {
    float4 v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = load4(x + k * n + i0);
    if constexpr (STRATEGY == MAX) {
      const float4 o = load4(out + i0);
      float4 count = splat4(0.f);
#pragma unroll
      for (int k = 0; k < K; ++k) count = add4(count, holds4(v[k], o, live[k]));
      const float4 share = div4(gv, ties4(count));
#pragma unroll
      for (int k = 0; k < K; ++k)
        store4_evict_first(dx + k * n + i0,
                           credit4(holds4(v[k], o, live[k]), share));
    } else {  // MUL: suffix[k] = x_{K-1} * ... * x_{k+1}, dropped ones as 1
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (!(live[k] > 0.f)) v[k] = splat4(1.f);
      float4 suffix[K];
      suffix[K - 1] = splat4(1.f);
#pragma unroll
      for (int k = K - 2; k >= 0; --k)
        suffix[k] = mul4(suffix[k + 1], v[k + 1]);
      float4 prefix = splat4(1.f);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        store4_evict_first(dx + k * n + i0,
                           live[k] > 0.f ? mul4(gv, mul4(prefix, suffix[k]))
                                         : splat4(0.f));
        prefix = mul4(prefix, v[k]);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ float masked(const T* __restrict__ x,
                                        const float* __restrict__ live,
                                        long long n, int k, long long i) {
  return live[k] > 0.f ? to_f32(x[k * n + i]) : 1.f;
}

// One element i, any K: the scalar path and the runtime-K instantiation;
// what it needs twice it reads twice.
template <typename T, int STRATEGY>
__device__ __forceinline__ void bwd_element(const T* __restrict__ g,
                                            const float* __restrict__ live,
                                            const T* __restrict__ x,
                                            const T* __restrict__ out,
                                            T* __restrict__ dx, long long n,
                                            int nk, long long i) {
  const float gi = to_f32(g[i]);
  if (STRATEGY == SUM || STRATEGY == AVG) {
    float total = 0.f;
    for (int k = 0; k < nk; ++k) total += live[k];
    for (int k = 0; k < nk; ++k)
      store1(dx + k * n + i, gi * weight<STRATEGY>(live[k], total));
  } else if (STRATEGY == MAX) {
    const float o = to_f32(out[i]);
    float count = 0.f;
    for (int k = 0; k < nk; ++k)
      count += holds(to_f32(x[k * n + i]), o, live[k]);
    const float share = gi / fmaxf(count, 1.f);
    for (int k = 0; k < nk; ++k)
      store1(dx + k * n + i,
             holds(to_f32(x[k * n + i]), o, live[k]) > 0.f ? share : 0.f);
  } else {
    float prefix = 1.f;
    for (int k = 0; k < nk; ++k) {
      float suffix = 1.f;
      for (int j = nk - 1; j > k; --j) suffix *= masked(x, live, n, j, i);
      store1(dx + k * n + i, live[k] > 0.f ? gi * (prefix * suffix) : 0.f);
      prefix *= masked(x, live, n, k, i);
    }
  }
}

// K > 0: K is fixed and a whole vector's stack loads are issued first;
// K == 0: the runtime count k_rt, one element at a time.  The launch bounds
// ask for at least one block per SM: with the default, ptxas held the f32
// K = 4 mul (the training path's shape) at 32 registers and spilled; with
// this floor it takes a few more and spills nothing.
template <typename T, int K, int STRATEGY>
__global__ void __launch_bounds__(THREADS, 1)
    merge_reduce_bwd_kernel(const T* __restrict__ g,
                            const float* __restrict__ live,
                            const T* __restrict__ x, const T* __restrict__ out,
                            T* __restrict__ dx, long long n, int k_rt,
                            int vector_ok) {
  const long long i0 =
      4 * (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x);
  if (i0 >= n) return;
  if constexpr (K > 0) {
    if (vector_ok && i0 + 4 <= n) {
      bwd_vector<T, K, STRATEGY>(g, live, x, out, dx, n, i0);
      return;
    }
  }
  // the scalar path: a run that is not a multiple of 4, a misaligned start
  for (long long i = i0; i < i0 + 4 && i < n; ++i)
    bwd_element<T, STRATEGY>(g, live, x, out, dx, n, K > 0 ? K : k_rt, i);
}

// The reductions' operands in either direction.  The forward reads x and
// writes out; the backward reads g (and x for max and mul, out for max) and
// writes dx.  A pointer the direction and strategy do not read is null.
struct Reduce {
  const void* x;
  const float* live;
  void* out;
  const void* g;
  void* dx;
  long long n;
  int k;
  int vector_ok;
};

template <typename T, int K, int STRATEGY, bool BWD>
void launch_k(const Reduce& r, cudaStream_t stream) {
  const long long vectors = (r.n + 3) / 4;
  const unsigned blocks = static_cast<unsigned>((vectors + THREADS - 1) /
                                                THREADS);
  if constexpr (BWD)
    merge_reduce_bwd_kernel<T, K, STRATEGY><<<blocks, THREADS, 0, stream>>>(
        static_cast<const T*>(r.g), r.live, static_cast<const T*>(r.x),
        static_cast<const T*>(r.out), static_cast<T*>(r.dx), r.n, r.k,
        r.vector_ok);
  else
    merge_reduce_kernel<T, K, STRATEGY><<<blocks, THREADS, 0, stream>>>(
        static_cast<const T*>(r.x), r.live, static_cast<T*>(r.out), r.n, r.k,
        r.vector_ok);
}

template <typename T, int STRATEGY, bool BWD>
void launch_s(const Reduce& r, cudaStream_t s) {
  switch (r.k) {
    case 1: return launch_k<T, 1, STRATEGY, BWD>(r, s);
    case 2: return launch_k<T, 2, STRATEGY, BWD>(r, s);
    case 3: return launch_k<T, 3, STRATEGY, BWD>(r, s);
    case 4: return launch_k<T, 4, STRATEGY, BWD>(r, s);
    case 5: return launch_k<T, 5, STRATEGY, BWD>(r, s);
    case 6: return launch_k<T, 6, STRATEGY, BWD>(r, s);
    case 7: return launch_k<T, 7, STRATEGY, BWD>(r, s);
    case 8: return launch_k<T, 8, STRATEGY, BWD>(r, s);
    default: return launch_k<T, 0, STRATEGY, BWD>(r, s);
  }
}

template <typename T, bool BWD>
cudaError_t launch(Reduce r, int strategy, cudaStream_t s) {
  // a vector is 4 elements: the stack's planes (k * n) and every start must
  // fall on a vector boundary (a null pointer, never read, does)
  const uintptr_t vec_bytes = 4 * sizeof(T);
  r.vector_ok = r.n % 4 == 0 &&
                reinterpret_cast<uintptr_t>(r.x) % vec_bytes == 0 &&
                reinterpret_cast<uintptr_t>(r.out) % vec_bytes == 0 &&
                reinterpret_cast<uintptr_t>(r.g) % vec_bytes == 0 &&
                reinterpret_cast<uintptr_t>(r.dx) % vec_bytes == 0;
  switch (strategy) {
    case SUM: launch_s<T, SUM, BWD>(r, s); break;
    case AVG: launch_s<T, AVG, BWD>(r, s); break;
    case MAX: launch_s<T, MAX, BWD>(r, s); break;
    case MUL: launch_s<T, MUL, BWD>(r, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Both directions' entry: refuse what no kernel takes before any CUDA call,
// set the device, launch by dtype (0 f32, 1 bf16).
template <bool BWD>
int reduce_entry(const Reduce& r, int strategy, int dtype, int device,
                 void* stream) {
  if (r.n < 1 || r.k < 1 || (r.n + 3) / 4 / THREADS >= 0x7fffffffLL ||
      strategy < SUM || strategy > MUL || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0
                              ? launch<float, BWD>(r, strategy, s)
                              : launch<__nv_bfloat16, BWD>(r, strategy, s);
  return static_cast<int>(err);
}

// Stack element e = k*n + b*D + d (n = B*D) sits at b*KD + k*D + d in the
// merged (B, K*D) tensor (KD = K*D); the client index k comes back too.
__device__ __forceinline__ unsigned merged_offset(unsigned e, unsigned n,
                                                  unsigned D, unsigned KD,
                                                  unsigned& k) {
  k = e / n;
  const unsigned r = e - k * n;
  const unsigned b = r / D;
  return b * KD + k * D + (r - b * D);
}

// The permutation in either direction: BWD false reads the stack (src) and
// writes the merged tensor (dst), BWD true reads the merged tensor and
// writes the stack.  Thread t of block j takes the vector starting at stack
// element 4 * (j*THREADS + t).
template <typename T, bool BWD>
__device__ __forceinline__ void concat_move(const T* __restrict__ src,
                                            const float* __restrict__ live,
                                            T* __restrict__ dst, unsigned n,
                                            unsigned D, unsigned KD,
                                            unsigned total, int vector_ok) {
  const unsigned e0 = 4 * (blockIdx.x * THREADS + threadIdx.x);
  if (e0 >= total) return;
  if (vector_ok) {
    unsigned k;
    const unsigned m = merged_offset(e0, n, D, KD, k);
    store4(dst + (BWD ? e0 : m), scale4(load4(src + (BWD ? m : e0)), live[k]));
    return;
  }
  // the scalar path: D % 4 != 0, or an operand off a vector boundary
  for (unsigned e = e0; e < e0 + 4 && e < total; ++e) {
    unsigned k;
    const unsigned m = merged_offset(e, n, D, KD, k);
    store1(dst + (BWD ? e : m), to_f32(src[BWD ? m : e]) * live[k]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    merge_concat_kernel(const T* __restrict__ x,
                        const float* __restrict__ live, T* __restrict__ out,
                        unsigned n, unsigned D, unsigned KD, unsigned total,
                        int vector_ok) {
  concat_move<T, false>(x, live, out, n, D, KD, total, vector_ok);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    merge_concat_bwd_kernel(const float* __restrict__ live,
                            const T* __restrict__ g, T* __restrict__ dx,
                            unsigned n, unsigned D, unsigned KD,
                            unsigned total, int vector_ok) {
  concat_move<T, true>(g, live, dx, n, D, KD, total, vector_ok);
}

template <typename T>
cudaError_t launch_concat(const void* src, const float* live, void* dst,
                          int B, int D, int K, bool bwd, cudaStream_t s) {
  const unsigned n = static_cast<unsigned>(B) * D;
  const unsigned total = n * K;
  const uintptr_t vec_bytes = 4 * sizeof(T);
  const int vector_ok = D % 4 == 0 &&
                        reinterpret_cast<uintptr_t>(src) % vec_bytes == 0 &&
                        reinterpret_cast<uintptr_t>(dst) % vec_bytes == 0;
  const unsigned KD = static_cast<unsigned>(K) * D;
  const unsigned blocks = ((total + 3) / 4 + THREADS - 1) / THREADS;
  if (bwd)
    merge_concat_bwd_kernel<T><<<blocks, THREADS, 0, s>>>(
        live, static_cast<const T*>(src), static_cast<T*>(dst), n, D, KD,
        total, vector_ok);
  else
    merge_concat_kernel<T><<<blocks, THREADS, 0, s>>>(
        static_cast<const T*>(src), live, static_cast<T*>(dst), n, D, KD,
        total, vector_ok);
  return cudaGetLastError();
}

// src, dst: the stack and the merged tensor, in the order the direction
// reads and writes them
int concat_entry(const void* src, const void* live, void* dst, int B, int D,
                 int K, int dtype, bool bwd, int device, void* stream) {
  if (B < 1 || D < 1 || K < 1 ||
      static_cast<long long>(B) * D * K >= 0x80000000LL)
    return cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const float* lv = static_cast<const float*>(live);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0   ? launch_concat<float>(src, lv, dst, B, D, K, bwd, s)
      : dtype == 1 ? launch_concat<__nv_bfloat16>(src, lv, dst, B, D, K, bwd, s)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
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
  if (!x || !live || !out) return cudaErrorInvalidValue;
  const Reduce r{x, static_cast<const float*>(live), out, nullptr, nullptr,
                 n, K, 0};
  return reduce_entry<false>(r, strategy, dtype, device, stream);
}

// The reductions' backward: g, the contiguous (B, D) gradient of the merge,
// n = B * D elements; live as above; x, the contiguous (K, B, D) stack, read
// by max and mul (may be null for sum and avg); out, the forward's
// contiguous (B, D) output, read by max (may be null otherwise); dx, the
// contiguous (K, B, D) gradient of the stack.  strategy and dtype (g, x,
// out and dx) as for repro_merge_reduce; so are the launch and ``device``.
int repro_merge_reduce_bwd(const void* g, const void* live, const void* x,
                           const void* out, void* dx, long long n, int K,
                           int strategy, int dtype, int device,
                           void* stream) {
  if (!g || !live || !dx || ((strategy == MAX || strategy == MUL) && !x) ||
      (strategy == MAX && !out))
    return cudaErrorInvalidValue;
  const Reduce r{x, static_cast<const float*>(live), const_cast<void*>(out),
                 g, dx, n, K, 0};
  return reduce_entry<true>(r, strategy, dtype, device, stream);
}

// x: the contiguous (K, B, D) stack; live: (K,) f32 flags on the same card;
// out: the contiguous (B, K*D) merge.  dtype: 0 f32, 1 bf16 (x and out).
// K * B * D must be below 2^31.  Launches on ``stream`` without
// synchronizing; returns cudaGetLastError() after the launch (0 = success).
// ``device`` as for repro_merge_reduce.
int repro_merge_concat(const void* x, const void* live, void* out, int B,
                       int D, int K, int dtype, int device, void* stream) {
  return concat_entry(x, live, out, B, D, K, dtype, false, device, stream);
}

// The concat's backward: g, the contiguous (B, K*D) gradient of the merge;
// dx, the contiguous (K, B, D) gradient of the stack; the rest as for
// repro_merge_concat.
int repro_merge_concat_bwd(const void* live, const void* g, void* dx, int B,
                           int D, int K, int dtype, int device,
                           void* stream) {
  return concat_entry(g, live, dx, B, D, K, dtype, true, device, stream);
}

}  // extern "C"
