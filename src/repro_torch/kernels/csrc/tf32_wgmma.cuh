// TF32 tensor-core building blocks for Hopper (sm_90a) shared by the
// port's kernels: the 3xTF32 split of an f32 value, the no-swizzle
// K-major operand layout and its wgmma descriptor, wgmma.mma_async
// m64nNk8 wrappers (TF32 in, f32 accumulate) and cp.async copies.
//
// Operand layout.  wgmma reads B (and A, when A comes from shared memory)
// K-major in core matrices of 8 rows of 16 bytes (4 TF32 values): value
// (r, k) of a tile with KD values along K lives at core_index(r, k, KD).
// The next core matrix along K is 128 bytes on (the descriptor's LBO), the
// next 8 rows (KD / 4) * 128 bytes on (its SBO).  A k-step of 8 starts
// 2 * CORE values after the previous one.
//
// Fragments.  A from registers (wgmma_rs): warp w of the warpgroup holds
// rows 16w .. 16w + 15; lane 4g + t holds a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4).  The f32 accumulator D (64 x N) holds,
// per 8 columns i: d[4i] (g, 8i + 2t), d[4i + 1] (g, 8i + 2t + 1),
// d[4i + 2] and d[4i + 3] the same of row g + 8.
//
// 3xTF32: x = hi + lo with hi = rna_tf32(x), lo = rna_tf32(x - hi); a
// product a b is accumulated as a_lo b_hi + a_hi b_lo + a_hi b_hi, small
// terms first (CUTLASS's OpMultiplyAddFastF32).  The dropped a_lo b_lo is
// below f32's own rounding, and one TF32 pass (a_hi b_hi) keeps about
// three decimal digits.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t CORE = 32;  // TF32 values in a core matrix (8 x 16 B)

// where TF32 value (r, k) of a K-major operand tile with KD columns along
// K lives: core matrix (r / 8, k / 4), its row r % 8, column k % 4
__device__ __forceinline__ int core_index(int r, int k, int kd) {
  return ((r >> 3) * (kd >> 2) + (k >> 2)) * CORE + (r & 7) * 4 + (k & 3);
}

// A wgmma shared-memory descriptor, no swizzle: start address, LBO (the
// next core matrix along K, 128 bytes on) and SBO, each in 16-byte units
__device__ __forceinline__ uint64_t descriptor(const uint32_t* tile,
                                               uint32_t sbo_bytes) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return static_cast<uint64_t>((addr >> 4) & 0x3fff) |
         static_cast<uint64_t>((128 >> 4) & 0x3fff) << 16 |
         static_cast<uint64_t>((sbo_bytes >> 4) & 0x3fff) << 32;
}

// x = hi + lo to about 22 bits, each rounded to TF32 to nearest with ties
// away from zero: the rounding of cvt.rna.tf32.f32.  sm_90 has no such
// instruction; ptxas emulates it as an add of half a TF32 ulp, a mask, and
// an Inf/NaN guard that these finite operands do not need, so the add and
// the mask are written out here.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// four values of an operand tile's row as hi (and lo): the TF32 split of
// f32, or values already exact in TF32 (bf16) as they are
template <bool SPLIT>
__device__ __forceinline__ void store_operand(uint32_t* hi, uint32_t* lo,
                                              int at, float4 x) {
  if constexpr (SPLIT) {
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + at) = h;
    *reinterpret_cast<uint4*>(lo + at) = l;
  } else {
    *reinterpret_cast<uint4*>(hi + at) =
        make_uint4(__float_as_uint(x.x), __float_as_uint(x.y),
                   __float_as_uint(x.z), __float_as_uint(x.w));
  }
}

// D = A B (+ D when scale_d), wgmma m64nNk8 in TF32: A 64 x 8 from
// registers (wgmma_rs) or from shared memory through a descriptor
// (wgmma_ss), B 8 x N K-major in shared memory, D 64 x N f32 in registers
#define ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC8(i) ACC4(i), ACC4(i + 4)

__device__ __forceinline__ void wgmma_rs_n8(
    float (&d)[4], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : ACC4(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_rs_n16(
    float (&d)[8], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : ACC8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_rs_n32(
    float (&d)[16], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : ACC8(0), ACC8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_rs_n40(
    float (&d)[20], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC4(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_rs_n56(
    float (&d)[28], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27}, "
      "{%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC4(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_rs_n64(
    float (&d)[32], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16),
        ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_rs_n80(
    float (&d)[40], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16),
        ACC8(24), ACC8(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_rs_n112(
    float (&d)[56], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16),
        ACC8(24), ACC8(32), ACC8(40),
        ACC8(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_rs_n128(
    float (&d)[64], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16),
        ACC8(24), ACC8(32), ACC8(40),
        ACC8(48), ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_ss_n16(
    float (&d)[8], uint64_t desc_a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : ACC8(0)
      : "l"(desc_a), "l"(desc), "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_ss_n32(
    float (&d)[16], uint64_t desc_a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : ACC8(0), ACC8(8)
      : "l"(desc_a), "l"(desc), "r"(scale_d)
      : "memory");
}

#undef ACC8
#undef ACC4

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2],
                                      const uint32_t (&a)[4], uint64_t desc,
                                      int scale_d) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 40 || N == 56 ||
                    N == 64 || N == 80 || N == 112 || N == 128,
                "no wgmma wrapper for this N");
  if constexpr (N == 8)
    wgmma_rs_n8(d, a, desc, scale_d);
  else if constexpr (N == 16)
    wgmma_rs_n16(d, a, desc, scale_d);
  else if constexpr (N == 32)
    wgmma_rs_n32(d, a, desc, scale_d);
  else if constexpr (N == 40)
    wgmma_rs_n40(d, a, desc, scale_d);
  else if constexpr (N == 56)
    wgmma_rs_n56(d, a, desc, scale_d);
  else if constexpr (N == 64)
    wgmma_rs_n64(d, a, desc, scale_d);
  else if constexpr (N == 80)
    wgmma_rs_n80(d, a, desc, scale_d);
  else if constexpr (N == 112)
    wgmma_rs_n112(d, a, desc, scale_d);
  else
    wgmma_rs_n128(d, a, desc, scale_d);
}

// the same with A from shared memory through a descriptor
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc, int scale_d) {
  static_assert(N == 16 || N == 32, "no wgmma_ss wrapper for this N");
  if constexpr (N == 16)
    wgmma_ss_n16(d, desc_a, desc, scale_d);
  else
    wgmma_ss_n32(d, desc_a, desc, scale_d);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// shared-memory writes by the threads, made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one copy of BYTES (4, 8 or 16) from device memory into shared memory;
// an invalid one writes zeros and reads nothing
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async size");
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(d), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %3, %2;\n"
                 ::"r"(d), "l"(src), "r"(n), "n"(BYTES) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace
