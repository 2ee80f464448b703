// Blocked flash attention (forward) for Hopper, CUDA C++ for sm_90a.
//
// Replaces the JAX package's Pallas kernel _flash_kernel
// (src/repro/kernels/flash_attention.py, launched by flash_attention):
// causal or full attention over (B, H, S, D) with an online softmax in
// f32.  Scores are scaled by 1/sqrt(D), masked scores are -1e30, blocks
// wholly above the causal diagonal are skipped, and the output is
// acc / max(l, 1e-30), written in the input's type.  Two differences of
// form, none of function:
//
//  * GQA: kv head h / (H / Hkv) serves q head h; the Pallas kernel's
//    callers repeat the kv heads in memory first.  Same function, no copy.
//  * Layout: every tensor comes with its own batch, head and row strides
//    (the last dimension is contiguous), so the model's (B, S, H, D)
//    activations are read as permuted views without a transpose.  Any S
//    is taken: rows and columns past S are masked, not padded in memory.
//
// Bound on an H100 SXM: compute.  Causal attention does 4 * D flops per
// attended (q, kv) pair (two D-deep products), S (S + 1) / 2 pairs per
// head; the bytes (q, k, v read once, o written once) are O(S * D) and
// take microseconds.  Both products run on the tensor cores:
//
//  * Exactness.  The path runs f32 and is held to 5e-4 against the plain
//    version and 1e-3 on the long-prompt logits; one TF32 pass keeps about
//    three digits and breaks both.  So every f32 operand x is split as
//    hi = rna_tf32(x), lo = rna_tf32(x - hi) (round to nearest, ties away:
//    the rounding of cvt.rna.tf32.f32, see split()), and each product is
//    accumulated in f32 as a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms
//    first (3xTF32: the scheme of CUTLASS's OpMultiplyAddFastF32).  The
//    dropped a_lo b_lo term is below f32's own rounding.  In bf16 every
//    input is exact in TF32, so Q K^T takes one pass and P V two (P, an f32
//    softmax, is still split).  The bound is then three TF32 products per
//    f32 product: 3 * 4 * D * pairs over 495 TFLOP/s.  The softmax's exp2
//    (one per pair) runs on the special-function units beside them.
//  * Instruction: wgmma.mma_async m64nNk8 (TF32 in, f32 accumulate; the
//    split, the operand layout, descriptors and wrappers are in
//    tf32_wgmma.cuh, shared with the SSD chunk kernel).  A
//    (Q, then P) comes from registers (Q lo from shared memory above
//    D = 64, see Head dims); B (K, then V) from shared memory
//    through a descriptor, which for TF32 must be K-major: K as stored (d
//    contiguous in each kv row), V transposed (kv contiguous in each d
//    row).  wgmma and not mma.sync.m16n8k8: with mma.sync every warp
//    loads and splits each K/V element it multiplies, and that integer
//    work, not the tensor cores, bounded the kernel; wgmma reads B from
//    shared memory, so each element is split once per block.
//  * Split once per block.  A block stages each raw K/V tile with cp.async
//    (16 bytes a copy in f32, 8 in bf16: strides need only be multiples of
//    4 elements; rows past S are zero-filled), then its 256 threads split
//    every element once into hi and lo TF32 operand tiles, V transposed on
//    the way, in wgmma's core-matrix layout without swizzle: 8 rows of 16
//    bytes per 128-byte core matrix, the next core along K 128 bytes on
//    (LBO), the next 8 rows after all of a row group's cores (SBO).  The
//    raw stage is refilled with tile kt + 1 while tile kt is multiplied.
//  * Tiles: 128 q rows per block, two warpgroups of 64 (wgmma's M; warp w
//    of a warpgroup holds its rows 16w .. 16w + 15) that share each split
//    K/V tile, so a K/V element is split once per 128 q rows.  Q's A
//    fragments stay in registers for the whole kv loop.  The loop over kv
//    tiles (only up to the diagonal when causal) takes the place of the
//    Pallas kernel's sequential kv grid axis and its @pl.when skip.
//  * Head dims.  D = 32 and 64 take kv tiles of 64 rows and hold Q's hi
//    and lo fragments in registers (D registers).  Above 64 (80, 112 and
//    128) that budget breaks twice: registers (Q hi and lo, the D/2 of the
//    P V accumulator, the scores of a 64-row tile and P's hi and lo
//    fragments would take ~290 at D = 128) and shared memory (264 KB at
//    D = 128 in f32, past the 227 KB a block may have).  So there the kv
//    tile is 32 rows (halving the scores and P's fragments) and Q's lo
//    operand moves to shared memory, written once per block in the
//    core-matrix layout and read by wgmma through a descriptor (A from
//    shared memory) while Q hi stays in registers: at D = 128 in f32
//    that is 193 KB of shared memory, and ptxas fits the kernel in 233
//    registers without spilling.  bf16 has no Q lo (its Q is exact in
//    TF32) and takes the same 32-row tiles.
//  * The two warpgroups take turns on the tensor cores: warpgroup 0 runs
//    Q K^T, the softmax and P V of tile kt, warpgroup 1 the softmax and
//    P V of tile kt - 1 and then Q K^T of tile kt, so one's softmax runs
//    while the other's products do.  V^T is kept two tiles deep for it.
//    A block needs 130 KB of shared memory in f32 at D = 64 (193 KB at
//    D = 128) and up to 234 registers a thread: one block per SM.  Above
//    48 KB, shared memory must be allowed: the launcher does it once per
//    device at the first launch, never inside a CUDA-graph capture.
//  * Fragments: the accumulator of Q K^T holds kv columns (2t, 2t + 1) of
//    rows g and g + 8 in lane 4g + t; P V's A operand wants columns t and
//    t + 4.  The kernel renames the kv order inside each 8-column step
//    instead of moving P: A's column t is kv 2t and column t + 4 is kv
//    2t + 1, and the transposed V tile is written in that order.  A sum
//    over kv does not depend on the order of its terms.
//  * Softmax: in base 2 (scores times log2(e) / sqrt(D), ex2.approx), the
//    same function as exp of the unscaled scores.  Each row's max lives in
//    the 4 lanes of a quad and is reduced with __shfl_xor 1 and 2 before
//    the rescale; each lane keeps a partial row sum, reduced once at the
//    end.  The causal diagonal tile and a ragged last tile are masked per
//    accumulator element from its (row, column).
//  * The grid's slow axis walks the q tiles from the bottom up, so the
//    longest causal rows are scheduled first and the short ones fill the
//    tail.
//  * Logsumexp.  For training, the wrapper may pass an f32 (B, H, S)
//    buffer ``lse``: each row's m * ln 2 + ln(l) at the finish, the natural
//    logsumexp of its scaled, masked scores, which the backward
//    (flash_attention_bwd.cu) reads to recompute P without a second
//    softmax.  Serving passes none and writes nothing more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "tf32_wgmma.cuh"

namespace {

constexpr int WG_ROWS = 64;           // q rows per warpgroup: wgmma's M
constexpr int THREADS = 2 * 128;       // two warpgroups
constexpr int BLOCK_Q = 2 * WG_ROWS;   // q rows per block
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, S) contiguous, or null: not written
  // batch, head and row strides in elements; the last dimension is dense
  long long sq[3], sk[3], sv[3], so[3];
  int H;      // q heads
  int group;  // q heads per kv head
  int S;
  int causal;
  float scale_log2;  // log2(e) / sqrt(D)
};

// A block's tiling and shared memory: the raw K and V tiles (rows padded
// by 16 bytes), then the TF32 operand tiles, each KV * D values in the
// core-matrix layout: K hi, V^T hi (two tiles deep), and in f32 K lo,
// V^T lo (two tiles deep); above D = 64 in f32, then Q lo of both
// warpgroups (BLOCK_Q * D values).
template <typename T, int D>
struct Smem {
  static constexpr bool SPLIT = std::is_same<T, float>::value;
  static constexpr int KV = D > 64 ? 32 : 64;  // kv rows per tile
  static constexpr bool Q_LO_SHARED = SPLIT && D > 64;
  static constexpr int LDR = D + 16 / static_cast<int>(sizeof(T));
  static constexpr int RAW = KV * LDR;  // elements of one raw tile
  static constexpr int OP = KV * D;     // values of one operand tile
  static constexpr int RAW_BYTES = 2 * RAW * static_cast<int>(sizeof(T));
  static constexpr int BYTES = RAW_BYTES + (SPLIT ? 6 : 3) * OP * 4 +
                               (Q_LO_SHARED ? BLOCK_Q * D * 4 : 0);
  static_assert(D % 8 == 0 && D <= 128, "wgmma k-steps of 8, N <= 128");
  static_assert(RAW_BYTES % 128 == 0, "operand tiles start 128-aligned");
  static_assert(BYTES <= 232448, "an H100 block has 227 KB");
};

// rows row0 .. row0 + KV of one head into a raw tile
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride, int row0, int S) {
  constexpr int PER_ROW = D / 4;
  for (int c = threadIdx.x; c < Smem<T, D>::KV * PER_ROW; c += THREADS) {
    const int r = c / PER_ROW;
    const int col = (c % PER_ROW) * 4;
    const bool valid = row0 + r < S;
    cp_async<static_cast<int>(4 * sizeof(T))>(
        dst + r * Smem<T, D>::LDR + col,
        valid ? src + (row0 + r) * stride + col : src, valid);
  }
}

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_kernel(const Params p) {
  using L = Smem<T, D>;
  constexpr bool SPLIT = L::SPLIT;
  constexpr int KV = L::KV;
  constexpr int DK = D / 8;    // Q K^T's k-steps
  constexpr int NKV = KV / 8;  // P V's k-steps
  constexpr uint32_t SBO_K = (D / 4) * CORE * 4;   // K and Q: d along K
  constexpr uint32_t SBO_V = (KV / 4) * CORE * 4;  // V^T: kv along K
  extern __shared__ __align__(128) unsigned char smem[];
  T* raw_k = reinterpret_cast<T*>(smem);
  T* raw_v = raw_k + L::RAW;
  // K hi, V^T hi (two buffers), then K lo, V^T lo (two buffers), f32 only
  uint32_t* k_hi = reinterpret_cast<uint32_t*>(smem + L::RAW_BYTES);
  uint32_t* v_hi = k_hi + L::OP;
  uint32_t* k_lo = v_hi + 2 * L::OP;
  uint32_t* v_lo = k_lo + L::OP;
  // Q lo of this warpgroup's 64 rows (above D = 64 in f32), K-major as K
  uint32_t* q_lo_s = v_lo + 2 * L::OP + (threadIdx.x / 128) * WG_ROWS * D;

  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int hk = h / p.group;
  const int qt = gridDim.y - 1 - blockIdx.y;  // bottom (longest) tiles first
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // the fragment's row group
  const int t = lane % 4;  // its column within the group
  const int wg = threadIdx.x / 128;  // this thread's warpgroup
  const int wg_row0 = qt * BLOCK_Q + wg * WG_ROWS;
  const int row = wg_row0 + ((threadIdx.x / 32) % 4) * 16 + g;  // and row + 8

  const T* q = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const T* k = static_cast<const T*>(p.k) + b * p.sk[0] + hk * p.sk[1];
  const T* v = static_cast<const T*>(p.v) + b * p.sv[0] + hk * p.sv[1];
  T* o = static_cast<T*>(p.o) + b * p.so[0] + h * p.so[1];

  const int last_row = min(p.S, (qt + 1) * BLOCK_Q) - 1;
  const int n_kv = p.causal ? last_row / KV + 1 : (p.S + KV - 1) / KV;
  load_tile<T, D>(raw_k, k, p.sk[2], 0, p.S);
  load_tile<T, D>(raw_v, v, p.sv[2], 0, p.S);
  cp_commit();

  // Q as A fragments, held for the whole loop (above D = 64 in f32, Q lo
  // goes to shared memory instead).  A row past S is zeros and is never
  // stored.
  uint32_t q_hi[DK][4], q_lo[L::Q_LO_SHARED ? 1 : DK][4];
  {
    const int wg_row = row - wg_row0;  // this thread's row in its warpgroup
    const bool ok0 = row < p.S, ok1 = row + 8 < p.S;
    const T* q0 = q + (ok0 ? row : 0) * p.sq[2];
    const T* q1 = q + (ok1 ? row + 8 : 0) * p.sq[2];
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      const int c = 8 * kk + t;
      const float x[4] = {ok0 ? to_f32(q0[c]) : 0.f,
                          ok1 ? to_f32(q1[c]) : 0.f,
                          ok0 ? to_f32(q0[c + 4]) : 0.f,
                          ok1 ? to_f32(q1[c + 4]) : 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (L::Q_LO_SHARED) {
          uint32_t lo;
          split(x[i], q_hi[kk][i], lo);
          q_lo_s[core_index(wg_row + 8 * (i & 1), c + 4 * (i >> 1), D)] = lo;
        } else if constexpr (SPLIT) {
          split(x[i], q_hi[kk][i], q_lo[kk][i]);
        } else {
          q_hi[kk][i] = __float_as_uint(x[i]);
        }
      }
    }
  }

  float acc[D / 2];  // O, in wgmma's accumulator order
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max of rows row, row + 8
  float l[2] = {0.f, 0.f};          // this lane's share of the row sums

  // The two warpgroups take turns on the tensor cores: warpgroup 0 runs
  // Q K^T, the softmax and P V of tile kt; warpgroup 1 runs the softmax and
  // P V of tile kt - 1 and then Q K^T of tile kt, so that one's softmax
  // falls in the other's products.  V^T is kept two tiles deep for it.
  float s[KV / 2];
  auto qk = [&]() {
    // S = Q K^T, k-step kk reading K's (and Q's) columns 8 kk .. 8 kk + 7
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      const uint64_t dh = descriptor(k_hi + kk * 2 * CORE, SBO_K);
      if constexpr (SPLIT) {
        const uint64_t dl = descriptor(k_lo + kk * 2 * CORE, SBO_K);
        if constexpr (L::Q_LO_SHARED)
          wgmma_ss_n32(s, descriptor(q_lo_s + kk * 2 * CORE, SBO_K), dh,
                       kk > 0);
        else
          wgmma<KV>(s, q_lo[kk], dh, kk > 0);
        wgmma<KV>(s, q_hi[kk], dl, 1);
        wgmma<KV>(s, q_hi[kk], dh, 1);
      } else {
        wgmma<KV>(s, q_hi[kk], dh, kk > 0);
      }
    }
    wgmma_commit_and_wait();
  };
  auto softmax_pv = [&](int kt) {
    const uint32_t* vh = v_hi + (kt & 1) * L::OP;
    const uint32_t* vl = v_lo + (kt & 1) * L::OP;
    // mask the diagonal tile and a ragged last tile: s[4 j + i] holds kv
    // column 8 j + 2t + (i & 1) of row row + 8 (i >> 1)
    const int kv0 = kt * KV;
    if ((p.causal && kv0 + KV - 1 > wg_row0) || kv0 + KV > p.S) {
#pragma unroll
      for (int i = 0; i < KV / 2; ++i) {
        const int col = kv0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const int r = row + ((i >> 1) & 1) * 8;
        if (col >= p.S || (p.causal && col > r)) s[i] = NEG_INF;
      }
    }

    // online softmax in base 2 (the running max m is of the scaled
    // scores).  Column 0 is valid for every row (causal) and the first
    // tile holds a valid column (full), so a valid row has a finite
    // running max before any masked column is seen: a masked column's
    // exp2 is exactly 0.
    float m_new[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < KV / 2; ++i)
      m_new[(i >> 1) & 1] = fmaxf(m_new[(i >> 1) & 1], s[i]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the row's 4 lanes hold one quad
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(FULL, m_new[r], 1));
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(FULL, m_new[r], 2));
      m_new[r] = fmaxf(m[r], m_new[r] * p.scale_log2);
      alpha[r] = ex2(m[r] - m_new[r]);
      m[r] = m_new[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < KV / 2; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = ex2(fmaf(s[i], p.scale_log2, -m_new[r]));
      l[r] += s[i];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // P as A fragments, its kv columns renamed: A's column t is kv 8 j + 2t
    // (s[4 j] / s[4 j + 2]), column t + 4 is kv 8 j + 2t + 1 (s[4 j + 1] /
    // s[4 j + 3]); V^T was written in the same order
    uint32_t p_hi[NKV][4], p_lo[NKV][4];
#pragma unroll
    for (int j = 0; j < NKV; ++j) {
      split(s[4 * j], p_hi[j][0], p_lo[j][0]);
      split(s[4 * j + 2], p_hi[j][1], p_lo[j][1]);
      split(s[4 * j + 1], p_hi[j][2], p_lo[j][2]);
      split(s[4 * j + 3], p_hi[j][3], p_lo[j][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NKV; ++j) {
      const uint64_t dh = descriptor(vh + j * 2 * CORE, SBO_V);
      wgmma<D>(acc, p_lo[j], dh, 1);
      if constexpr (SPLIT)
        wgmma<D>(acc, p_hi[j], descriptor(vl + j * 2 * CORE, SBO_V), 1);
      wgmma<D>(acc, p_hi[j], dh, 1);
    }
    wgmma_commit_and_wait();
  };
  for (int kt = 0; kt < n_kv; ++kt) {
    cp_wait_all();
    __syncthreads();  // tile kt has landed; every warp is done with the
                      // previous operand tiles

    // split the raw tiles into the operand tiles.  K: thread idx takes
    // core matrix idx / 8, row idx % 8 (kv 8 nb + r, d 4 kb .. 4 kb + 3):
    // a quarter-warp reads 8 rows of one 16-byte column, and writes one
    // whole core matrix.
    for (int idx = threadIdx.x; idx < L::OP / 4; idx += THREADS) {
      const int kb = (idx >> 3) % (D / 4);
      const int kv = 8 * ((idx >> 3) / (D / 4)) + (idx & 7);
      store_operand<SPLIT>(k_hi, k_lo, 4 * idx,
                           load4(raw_k + kv * L::LDR + 4 * kb));
    }
    // V^T: thread idx takes d = idx % D and kv positions 4 kb .. 4 kb + 3,
    // which in the renamed order are kv 8 j + 2e + half (e = 0..3, kb =
    // 2 j + half); a warp reads 32 neighbouring d of one kv row at a time
    for (int idx = threadIdx.x; idx < L::OP / 4; idx += THREADS) {
      const int d = idx % D;
      const int kb = idx / D;
      const T* src = raw_v + (8 * (kb >> 1) + (kb & 1)) * L::LDR + d;
      const float4 x = make_float4(to_f32(src[0]), to_f32(src[2 * L::LDR]),
                                   to_f32(src[4 * L::LDR]),
                                   to_f32(src[6 * L::LDR]));
      store_operand<SPLIT>(v_hi + (kt & 1) * L::OP, v_lo + (kt & 1) * L::OP,
                           core_index(d, 4 * kb, KV), x);
    }
    fence_proxy_async();
    __syncthreads();  // operand tiles complete; the raw tiles are free
    if (kt + 1 < n_kv) {  // the next tile loads while this one is used
      load_tile<T, D>(raw_k, k, p.sk[2], (kt + 1) * KV, p.S);
      load_tile<T, D>(raw_v, v, p.sv[2], (kt + 1) * KV, p.S);
    }
    cp_commit();

    if (wg == 0) {
      // a causal tile wholly above warpgroup 0's rows is skipped
      if (!p.causal || kt * KV < wg_row0 + WG_ROWS) {
        qk();
        softmax_pv(kt);
      }
    } else {
      if (kt > 0) softmax_pv(kt - 1);
      qk();
    }
  }
  if (wg == 1) softmax_pv(n_kv - 1);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    // every lane of the quad holds the row's m and l: lane t = 0 writes
    if (p.lse != nullptr && t == 0 && row + 8 * r < p.S)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.S + row + 8 * r] =
          m[r] * LN2 + logf(l[r]);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int out_row = row + 8 * r;
    if (out_row < p.S) {
      T* orow = o + out_row * p.so[2] + 2 * t;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        store2(orow + 8 * nd, acc[4 * nd + 2 * r] * l[r],
               acc[4 * nd + 2 * r + 1] * l[r]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_d(const Params& p, int B, int device, cudaStream_t stream) {
  // Above 48 KB a block's shared memory must be allowed first: once per
  // device, at the first launch, since a later launch may be inside a
  // CUDA-graph capture, where no such call belongs.
  static bool allowed[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!allowed[device]) {
    const cudaError_t set = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<T, D>::BYTES);
    if (set != cudaSuccess) return set;
    allowed[device] = true;
  }
  const dim3 grid(B * p.H, (p.S + BLOCK_Q - 1) / BLOCK_Q);
  flash_attention_kernel<T, D>
      <<<grid, THREADS, Smem<T, D>::BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params& p, int B, int D, int device,
                   cudaStream_t stream) {
  switch (D) {
    case 32: return launch_d<T, 32>(p, B, device, stream);
    case 64: return launch_d<T, 64>(p, B, device, stream);
    case 80: return launch_d<T, 80>(p, B, device, stream);
    case 112: return launch_d<T, 112>(p, B, device, stream);
    case 128: return launch_d<T, 128>(p, B, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o: (B, H, S, D); k, v: (B, Hkv, S, D); lse: (B, H, S) f32 contiguous,
// or null (not written).  strides: 12 int64 values, the
// batch, head and row strides of q, k, v and o in that order, each a
// multiple of 4 elements, with 16-byte aligned starts.  dtype: 0 f32,
// 1 bf16 (all four tensors).  D: 32, 64, 80, 112 or 128.  Launches on
// ``stream`` without
// synchronizing; returns cudaGetLastError() after the launch (0 = success).
// ``device`` is the card that ``stream`` and the tensors belong to: this
// library carries its own CUDA runtime, whose current device is set here.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, float* lse, const long long* strides,
                          int dtype, int B, int H, int Hkv, int S, int D,
                          int causal, int device, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || S < 1 ||
      (S + BLOCK_Q - 1) / BLOCK_Q > 65535)
    return cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
    p.so[i] = strides[9 + i];
  }
  p.H = H;
  p.group = H / Hkv;
  p.S = S;
  p.causal = causal;
  p.scale_log2 = LOG2E / sqrtf(static_cast<float>(D));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0   ? launch<float>(p, B, D, device, s)
      : dtype == 1 ? launch<__nv_bfloat16>(p, B, D, device, s)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
