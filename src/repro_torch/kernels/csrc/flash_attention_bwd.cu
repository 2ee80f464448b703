// Blocked flash attention, backward, for Hopper: CUDA C++ for sm_90a, on
// the tensor cores (3xTF32 wgmma).
//
// Replaces no Pallas kernel: the JAX package's flash kernel
// (src/repro/kernels/flash_attention.py, _flash_kernel) has no backward,
// and the JAX model differentiates its plain chunked attention
// (src/repro/models/attention.py, chunked_flash_attention) with jax.grad.
// The port trains past 2048 tokens through flash_attention_kernel
// (flash_attention.cu) forward and these kernels backward, held on the
// CPU to jax.vjp of that chunked attention (tests/test_torch_flash_bwd.py,
// and tests/test_torch_flash_bwd_wgmma.py for this arithmetic) and on the
// card to the plain backward, ref.flash_attention_bwd.
//
// The function: for q (B, H, S, D), k and v (B, Hkv, S, D) (kv head
// h / (H / Hkv) serves q head h), the forward's output o and its per-row
// logsumexp lse (the forward kernel writes it, f32 (B, H, S), in natural
// units of the scaled scores), and the output's gradient dO:
//
//   P   = exp(Q K^T / sqrt(D) - lse)            masked entries 0
//   dV  = P^T dO                                 summed over the group
//   dS  = P o (dO V^T - Delta),  Delta_i = sum_d dO_id O_id
//   dQ  = dS K / sqrt(D),   dK = dS^T Q / sqrt(D)   (dK summed likewise)
//
// with the forward's masks: scale 1/sqrt(D), causal or full, rows and
// columns past S masked (any S), tiles wholly above the causal diagonal
// skipped.  Inputs are the forward's strided views (the model's
// (B, S, H, D) activations, transposed, with no copy); dq, dk and dv are
// written in the input's type, accumulated in f32.
//
// Bound on an H100 SXM: operations.  The function needs five D-deep
// products per attended (q, kv) pair (Q K^T, dO V^T, P^T dO, dS^T Q and
// dS K: 10 D flops), S (S + 1) / 2 pairs per head when causal; the bytes
// (q, k, v, o, dO, lse read once, dq, dk, dv written once) are O(S D) and
// take microseconds.  Every product runs on the tensor cores as
// wgmma.mma_async m64nNk8 in TF32 with f32 accumulation (tf32_wgmma.cuh),
// as 3xTF32: an f32 operand x is split into hi = rna_tf32(x) and lo =
// rna_tf32(x - hi) and a product is accumulated as a_lo b_hi + a_hi b_lo
// + a_hi b_hi, small terms first, as the forward does.  One TF32 pass
// would not do: modelled in numpy (tests/test_torch_flash_bwd_wgmma.py),
// it errs 3e-4 to 1e-3 of each gradient's largest entry, past the card's
// f32 gate of 1e-4, where the model's 3xTF32 errs ~1e-6 (the card's ~5e-6).
// In bf16, Q, K, V and dO are exact in TF32: Q K^T and dO V^T take one
// pass, the products with P and dS (f32, still split) two.  The bound is
// 3 TF32 products per f32 product at 495 TFLOP/s.  This design does seven
// products per pair, not five: the dq kernel recomputes S and dP so that
// no sum needs an atomic, which puts its own floor at 7/5 of the bound.
//
// Four kernels, launched in order on one stream:
//
//  * flash_attention_bwd_preprocess_kernel: Delta, one warp per row, in
//    f32 (B, H, S) scratch that the wrapper allocates.
//  * flash_attention_bwd_dkdv_kernel, in the transposed orientation (as
//    FlashAttention-2/3 and ssd_chunk_bwd.cu): one block per (batch, q
//    head, kv block), the kv blocks of the causal diagonal's top (the
//    longest) first; a warpgroup takes 64 kv rows, wgmma's M.  K and V of
//    the block are split once into operand tiles in shared memory (K-major
//    along d, read as A through descriptors).  The block walks its head's
//    q tiles at or below the diagonal: each q tile of Q and dO is staged
//    with cp.async (the next one while this one is used) and split into
//    four operand tiles, Q and dO as stored (K-major along d: B of
//    S^T = K Q^T and dP^T = V dO^T) and Q^T and dO^T (K-major along q:
//    B of dV += P^T dO and dK += dS^T Q), the latter with q renamed
//    inside each 8 as the forward renames kv for V^T.  P^T and dS^T are
//    computed in the accumulator (lse and Delta per column) and become the
//    A fragments of dV and dK through that renaming, with no trip through
//    shared memory.  Each block writes its head's dK and dV as f32
//    partials (B, H, S, D).
//  * flash_attention_bwd_reduce_kernel: dK and dV of each kv head, the
//    partials of its group summed in head order, dK scaled, written in the
//    input's type, on eight blocks an SM (the card's SM count, read
//    once).  Per-head blocks fill the card where a block per kv head
//    would not: the towers' (2, 3 / 1, 4096, 64) gives 192 dkdv blocks,
//    not 64.  repro_flash_attention_bwd_plan reports every grid.
//  * flash_attention_bwd_dq_kernel: the forward's shape.  One block per
//    (batch, q head, q block), the bottom (longest) blocks first; a
//    warpgroup takes 64 q rows.  Q and dO are split once into operand
//    tiles (A through descriptors), lse and Delta of the thread's rows
//    held in registers; each kv tile is staged, then split into K and V as
//    stored (B of S = Q K^T and dP = dO V^T) and K^T renamed (B of
//    dQ += dS K); dS becomes dQ's A fragments as P^T does above.
//
// Tiles and budgets.  A warpgroup holds its dK and dV (or dQ) accumulators
// (D / 2 registers each), one tile's product, S and dP of one tile and the
// hi and lo fragments of P and dS; up to D = 64 the dq kernel also holds Q
// hi and dO hi as A fragments (two of the three passes of S and dP then
// read A from registers).  Every other operand is in shared memory, and
// shared memory is the limit: in f32 each input operand is two tiles (hi,
// lo), and the q tiles of dkdv are needed in two layouts.  So (Plan below):
// up to D = 64, two warpgroups per block (128 kv or q rows) and 32-row
// tiles; at D = 80, one warpgroup and 32-row tiles; at D = 112 and 128,
// one warpgroup and 16-row tiles.  At D = 64 in f32 a dkdv block takes
// 209 KB, a dq block 193 KB: one block per SM.  ptxas fits every
// instantiation in 142-248 registers without spilling.
//
// Overlap.  Each tile's S and dP are two commit groups: P is computed
// while dP runs, dS while dV's product runs.  lse and Delta of the next q
// tile are staged with its Q and dO.  The split pass (split_tile) issues
// a thread's loads two items at a time before their splits and stores:
// as four separate loops it took a fifth of dkdv's time.
//
// Accuracy.  The tensor cores accumulate in f32 with truncation, and a
// sum over thousands of rows (288 k-steps of 3 passes at 2304) in one
// accumulator drifts by ~3e-5 of its size.  So each tile's product goes
// to a fresh accumulator and is added to the running sum with an f32
// add: ~2e-6 of each gradient's largest entry at 2304 and 4096 tokens, as
// the FMA kernel that came before.
//
// Control flow around the products is warpgroup-uniform (the warpgroup
// index read from lane 0).  Causal tiles wholly above a warpgroup's rows
// are skipped by that warpgroup; diagonal and ragged tiles are masked per
// accumulator element from its (row, column); rows and columns past S are
// zeros in every operand and never stored.

// Deterministic: no atomics, every sum is taken in one fixed order (the
// k-steps, the q or kv tiles, the heads of a group in the reduce pass),
// so two runs are bit-identical (split training's step-0 check holds the
// Executor to the serial protocol_step at 1e-5, both on the card).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "tf32_wgmma.cuh"

namespace {

constexpr int WG = 128;          // threads per warpgroup
constexpr int WG_ROWS = 64;      // rows per warpgroup: wgmma's M
constexpr int PRE_THREADS = 256;  // the preprocess and reduce kernels
constexpr int PRE_WARPS = PRE_THREADS / 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, S) f32, contiguous
  float* delta;      // (B, H, S) f32 scratch, contiguous
  float* part;       // (2, B, H, S, D) f32 scratch: dK, dV per q head
  void* dq;
  void* dk;
  void* dv;
  // batch, head and row strides in elements of q, k, v, o, dout, dq, dk,
  // dv; the last dimension is dense
  long long sq[3], sk[3], sv[3], so[3], sdo[3], sdq[3], sdk[3], sdv[3];
  int B;
  int H;      // q heads
  int group;  // q heads per kv head
  int S;
  int D;
  int causal;
  float scale;       // 1 / sqrt(D)
  float scale_log2;  // log2(e) / sqrt(D)
};

// Tiling and shared memory of (T, D).  Each block has WGS warpgroups of 64
// rows (kv rows in dkdv, q rows in dq) and walks tiles of TILE rows (q
// tiles in dkdv, kv tiles in dq).  dkdv's shared memory holds K and V (hi,
// and lo in f32) of the block's kv rows, then Q, dO, Q^T, dO^T (hi, and lo
// in f32) of one q tile, the raw Q and dO tiles and the lse and Delta of
// two q tiles (this one and the next, staged with it).  dq's holds Q and
// dO (hi, lo) of the block's rows, then K, V, K^T (hi, lo) of one kv tile
// and the raw K and V tiles.  Every operand tile is a multiple of 1 KB, so
// each starts 128-byte aligned.
template <typename T, int D>
struct Plan {
  static constexpr bool SPLIT = std::is_same<T, float>::value;
  static constexpr int PARTS = SPLIT ? 2 : 1;  // hi and lo of an input
  static constexpr int WGS = D <= 64 ? 2 : 1;
  static constexpr int TILE = D <= 80 ? 32 : 16;
  // dkdv sums each q tile's dK and dV in a fresh accumulator of D / KV_N
  // columns and adds it to the running sums (see Accuracy): whole up to
  // D = 64, in two halves above, for the registers
  static constexpr int KV_N = D <= 64 ? 1 : 2;
  static constexpr int LDR = D + 16 / static_cast<int>(sizeof(T));
  static constexpr int RAW_BYTES =
      2 * TILE * LDR * static_cast<int>(sizeof(T));
  static constexpr int ROWS = WGS * WG_ROWS;  // kv (dkdv) or q (dq) rows
  static constexpr int DKDV_BYTES = (2 * PARTS * ROWS * D +
                                     4 * PARTS * TILE * D) * 4 +
                                    RAW_BYTES + 2 * 2 * TILE * 4;
  static constexpr int DQ_BYTES =
      (2 * PARTS * ROWS * D + 3 * PARTS * TILE * D) * 4 + RAW_BYTES;
  static_assert(D % 16 == 0 && D <= 128, "head dims 32 .. 128, by 16");
  static_assert(DKDV_BYTES <= 232448 && DQ_BYTES <= 232448,
                "an H100 block has 227 KB");
};

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

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  memcpy(&u.x, &a, sizeof(a));
  memcpy(&u.y, &b, sizeof(b));
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool attended(int row, int col, int S,
                                         int causal) {
  return row < S && col < S && !(causal && col > row);
}

// rows row0 .. row0 + ROWS of one head into a raw tile (rows LDR apart)
// with cp.async; rows past S are zero-filled
template <typename T, int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage(T* dst, const T* src, long long stride,
                                      int row0, int S) {
  constexpr int PER_ROW = D / 4;
  constexpr int LDR = Plan<T, D>::LDR;
  for (int c = threadIdx.x; c < ROWS * PER_ROW; c += THREADS) {
    const int r = c / PER_ROW;
    const int col = (c % PER_ROW) * 4;
    const bool valid = row0 + r < S;
    cp_async<static_cast<int>(4 * sizeof(T))>(
        dst + r * LDR + col, valid ? src + (row0 + r) * stride + col : src,
        valid);
  }
}

// One tile's operand tiles from its raw tiles (ROWS rows each, LDR apart):
// raw tile n as an operand tile with d along K and its rows as rows
// (rows_hi[n], rows_lo[n]), and raw tile n < NCOLS transposed, its rows
// along K and d as rows (cols_hi[n], cols_lo[n]).  Rows: thread idx writes
// core matrix idx / 8, row idx % 8 (row 8 nb + r, d 4 kb .. 4 kb + 3), so
// a quarter-warp writes one whole core matrix.  Transposed: thread idx
// takes d = idx % D and K positions 4 kb .. 4 kb + 3, which in the renamed
// order are rows 8 j + 2e + half (e = 0..3, kb = 2 j + half): the
// accumulator's columns (2t, 2t + 1) become A's columns (t, t + 4), as the
// forward writes V^T.  A thread's loads of two items come first, then
// their splits and stores, so that the loads' latencies overlap (more
// items at once spill at D = 112).
template <bool SPLIT, typename T, int D, int ROWS, int THREADS, int NROWS,
          int NCOLS>
__device__ __forceinline__ void split_tile(
    const T* const (&raw)[NROWS], uint32_t* const (&rows_hi)[NROWS],
    uint32_t* const (&rows_lo)[NROWS], uint32_t* const (&cols_hi)[NCOLS],
    uint32_t* const (&cols_lo)[NCOLS]) {
  constexpr int LDR = Plan<T, D>::LDR;
  constexpr int N = ROWS * D / 4;
  constexpr int ITERS = (N + THREADS - 1) / THREADS;
  constexpr int BATCH = 2;  // iterations whose loads are held at once
#pragma unroll
  for (int i0 = 0; i0 < ITERS; i0 += BATCH) {
    float4 xr[BATCH][NROWS], xc[BATCH][NCOLS];
#pragma unroll
    for (int it = 0; it < BATCH; ++it) {
      const int idx = threadIdx.x + (i0 + it) * THREADS;
      if (i0 + it < ITERS && (N % THREADS == 0 || idx < N)) {
        const int kb = (idx >> 3) % (D / 4);
        const int r = 8 * ((idx >> 3) / (D / 4)) + (idx & 7);
#pragma unroll
        for (int n = 0; n < NROWS; ++n)
          xr[it][n] = load4(raw[n] + r * LDR + 4 * kb);
        const int d = idx % D;
        const int kc = idx / D;
#pragma unroll
        for (int n = 0; n < NCOLS; ++n) {
          const T* src = raw[n] + (8 * (kc >> 1) + (kc & 1)) * LDR + d;
          xc[it][n] = make_float4(to_f32(src[0]), to_f32(src[2 * LDR]),
                                  to_f32(src[4 * LDR]),
                                  to_f32(src[6 * LDR]));
        }
      }
    }
#pragma unroll
    for (int it = 0; it < BATCH; ++it) {
      const int idx = threadIdx.x + (i0 + it) * THREADS;
      if (i0 + it < ITERS && (N % THREADS == 0 || idx < N)) {
#pragma unroll
        for (int n = 0; n < NROWS; ++n)
          store_operand<SPLIT>(rows_hi[n], rows_lo[n], 4 * idx, xr[it][n]);
#pragma unroll
        for (int n = 0; n < NCOLS; ++n)
          store_operand<SPLIT>(cols_hi[n], cols_lo[n],
                               core_index(idx % D, 4 * (idx / D), ROWS),
                               xc[it][n]);
      }
    }
  }
}

// rows row0 .. row0 + ROWS of one head from device memory straight into an
// operand tile laid out as split_tile lays out its rows; zeros past S
template <bool SPLIT, typename T, int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(uint32_t* hi, uint32_t* lo,
                                          const T* src, long long stride,
                                          int row0, int S) {
  for (int idx = threadIdx.x; idx < ROWS * D / 4; idx += THREADS) {
    const int kb = (idx >> 3) % (D / 4);
    const int r = 8 * ((idx >> 3) / (D / 4)) + (idx & 7);
    const float4 x = row0 + r < S
                         ? load4(src + (row0 + r) * stride + 4 * kb)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    store_operand<SPLIT>(hi, lo, 4 * idx, x);
  }
}

// acc = A B over K = 8 KSTEPS, A (this warpgroup's 64 rows) and B (N
// rows) both from shared memory, K-major: 3xTF32 when SPLIT, else one
// pass; the first k-step overwrites acc
template <bool SPLIT, int N, int KSTEPS>
__device__ __forceinline__ void product_ss(float (&acc)[N / 2],
                                           const uint32_t* a_hi,
                                           const uint32_t* a_lo,
                                           uint32_t sbo_a,
                                           const uint32_t* b_hi,
                                           const uint32_t* b_lo,
                                           uint32_t sbo_b) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const uint64_t ah = descriptor(a_hi + kk * 2 * CORE, sbo_a);
    const uint64_t bh = descriptor(b_hi + kk * 2 * CORE, sbo_b);
    if constexpr (SPLIT) {
      wgmma_ss<N>(acc, descriptor(a_lo + kk * 2 * CORE, sbo_a), bh, kk > 0);
      wgmma_ss<N>(acc, ah, descriptor(b_lo + kk * 2 * CORE, sbo_b), 1);
      wgmma_ss<N>(acc, ah, bh, 1);
    } else {
      wgmma_ss<N>(acc, ah, bh, kk > 0);
    }
  }
}

// the same with A's hi as register fragments (a_hi, one k-step each) and
// A's lo from shared memory: two of the three passes read A from registers
template <bool SPLIT, int N, int KSTEPS>
__device__ __forceinline__ void product_rs_hi(
    float (&acc)[N / 2], const uint32_t (&a_hi)[KSTEPS][4],
    const uint32_t* a_lo, uint32_t sbo_a, const uint32_t* b_hi,
    const uint32_t* b_lo, uint32_t sbo_b) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const uint64_t bh = descriptor(b_hi + kk * 2 * CORE, sbo_b);
    if constexpr (SPLIT) {
      wgmma_ss<N>(acc, descriptor(a_lo + kk * 2 * CORE, sbo_a), bh, kk > 0);
      wgmma<N>(acc, a_hi[kk], descriptor(b_lo + kk * 2 * CORE, sbo_b), 1);
      wgmma<N>(acc, a_hi[kk], bh, 1);
    } else {
      wgmma<N>(acc, a_hi[kk], bh, kk > 0);
    }
  }
}

// this thread's A fragments of a 64-row operand tile with KD values along
// K in shared memory (core_index layout): rows r0 and r0 + 8, columns
// 8 kk + t and 8 kk + t + 4
template <int KD>
__device__ __forceinline__ void read_fragments(uint32_t (&a)[KD / 8][4],
                                               const uint32_t* tile, int r0,
                                               int t) {
#pragma unroll
  for (int kk = 0; kk < KD / 8; ++kk) {
    a[kk][0] = tile[core_index(r0, 8 * kk + t, KD)];
    a[kk][1] = tile[core_index(r0 + 8, 8 * kk + t, KD)];
    a[kk][2] = tile[core_index(r0, 8 * kk + t + 4, KD)];
    a[kk][3] = tile[core_index(r0 + 8, 8 * kk + t + 4, KD)];
  }
}

// acc = A B, A from registers (the hi and lo fragments of P^T, dS^T or
// dS, always split), B from shared memory (hi, and lo when SPLIT)
template <bool SPLIT, int N, int KSTEPS>
__device__ __forceinline__ void product_rs(float (&acc)[N / 2],
                                           const uint32_t (&a_hi)[KSTEPS][4],
                                           const uint32_t (&a_lo)[KSTEPS][4],
                                           const uint32_t* b_hi,
                                           const uint32_t* b_lo,
                                           uint32_t sbo_b) {
#pragma unroll
  for (int j = 0; j < KSTEPS; ++j) {
    const uint64_t bh = descriptor(b_hi + j * 2 * CORE, sbo_b);
    wgmma<N>(acc, a_lo[j], bh, j > 0);
    if constexpr (SPLIT)
      wgmma<N>(acc, a_hi[j], descriptor(b_lo + j * 2 * CORE, sbo_b), 1);
    wgmma<N>(acc, a_hi[j], bh, 1);
  }
}

// an accumulator of N / 8 column groups as A fragments, hi and lo, its
// columns renamed: A's column t is column 8 j + 2t (x[4 j] / x[4 j + 2]),
// column t + 4 is 8 j + 2t + 1 (x[4 j + 1] / x[4 j + 3])
template <int NK>
__device__ __forceinline__ void fragments(const float (&x)[4 * NK],
                                          uint32_t (&hi)[NK][4],
                                          uint32_t (&lo)[NK][4]) {
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    split(x[4 * j], hi[j][0], lo[j][0]);
    split(x[4 * j + 2], hi[j][1], lo[j][1]);
    split(x[4 * j + 1], hi[j][2], lo[j][2]);
    split(x[4 * j + 3], hi[j][3], lo[j][3]);
  }
}

// one warp per row of batch blockIdx.y: Delta = sum_d dO_d O_d in f32
template <typename T>
__global__ void __launch_bounds__(PRE_THREADS)
    flash_attention_bwd_preprocess_kernel(const Params p) {
  const int local = blockIdx.x * PRE_WARPS + threadIdx.x / 32;  // h S + i
  if (local >= p.H * p.S) return;  // the whole warp
  const int b = blockIdx.y;
  const int h = local / p.S;
  const int i = local % p.S;
  const T* o = static_cast<const T*>(p.o) + b * p.so[0] + h * p.so[1] +
               i * p.so[2];
  const T* d = static_cast<const T*>(p.dout) + b * p.sdo[0] +
               h * p.sdo[1] + i * p.sdo[2];
  float acc = 0.f;
  for (int c = threadIdx.x % 32; c < p.D; c += 32)
    acc = fmaf(to_f32(o[c]), to_f32(d[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(FULL, acc, off);
  if (threadIdx.x % 32 == 0)
    p.delta[static_cast<long long>(b) * p.H * p.S + local] = acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(Plan<T, D>::WGS * WG, 1)
    flash_attention_bwd_dkdv_kernel(const Params p) {
  using L = Plan<T, D>;
  constexpr bool SPLIT = L::SPLIT;
  constexpr int QT = L::TILE;  // q rows per q tile
  constexpr int ROWS = L::ROWS;
  constexpr int THREADS = L::WGS * WG;
  constexpr int DK = D / 8;   // k-steps of K Q^T and V dO^T
  constexpr int NQ = QT / 8;  // k-steps of P^T dO and dS^T Q
  constexpr uint32_t SBO_D = (D / 4) * CORE * 4;   // d along K
  constexpr uint32_t SBO_Q = (QT / 4) * CORE * 4;  // q along K
  constexpr int KV_OP = SPLIT ? ROWS * D : 0;      // a lo tile, or none
  constexpr int Q_OP = SPLIT ? QT * D : 0;
  extern __shared__ __align__(128) unsigned char smem[];
  // K, V hi, then K, V lo (f32); then Q, dO (rows q), Q^T, dO^T (rows d)
  // hi, then their lo (f32); the raw Q and dO; lse and Delta of two tiles
  uint32_t* k_hi = reinterpret_cast<uint32_t*>(smem);
  uint32_t* v_hi = k_hi + ROWS * D;
  uint32_t* k_lo = v_hi + ROWS * D;
  uint32_t* v_lo = k_lo + KV_OP;
  uint32_t* q_hi = v_lo + KV_OP;
  uint32_t* do_hi = q_hi + QT * D;
  uint32_t* qt_hi = do_hi + QT * D;
  uint32_t* dot_hi = qt_hi + QT * D;
  uint32_t* q_lo = dot_hi + QT * D;
  uint32_t* do_lo = q_lo + Q_OP;
  uint32_t* qt_lo = do_lo + Q_OP;
  uint32_t* dot_lo = qt_lo + Q_OP;
  T* raw_q = reinterpret_cast<T*>(dot_lo + Q_OP);
  T* raw_do = raw_q + QT * L::LDR;
  float* lse_s = reinterpret_cast<float*>(raw_do + QT * L::LDR);  // 2 x QT
  float* dlt_s = lse_s + 2 * QT;                                 // 2 x QT

  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int hk = h / p.group;
  const int kv0 = blockIdx.y * ROWS;  // the diagonal's top (longest) first
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // the fragment's row group
  const int t = lane % 4;  // its column within the group
  // the warpgroup, read from lane 0 so that ptxas sees it is the same
  // across each warp
  const int wg = __shfl_sync(FULL, static_cast<int>(threadIdx.x) / WG, 0);
  const int kw0 = kv0 + wg * WG_ROWS;  // this warpgroup's first kv row
  const int row = kw0 + ((threadIdx.x / 32) % 4) * 16 + g;  // and row + 8
  // this warpgroup's K and V tiles (64 rows: A operands)
  const int a_off = wg * WG_ROWS * D;

  const T* q = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const T* dout = static_cast<const T*>(p.dout) + b * p.sdo[0] +
                  h * p.sdo[1];
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.S;
  const int n_q = (p.S + QT - 1) / QT;
  const int first = p.causal ? kv0 / QT : 0;
  // a q tile's raw Q and dO and its lse and Delta, staged with cp.async
  // (zeros past S); lse and Delta into buffer qt & 1
  auto stage_tile = [&](int qt) {
    stage<T, D, QT, THREADS>(raw_q, q, p.sq[2], qt * QT, p.S);
    stage<T, D, QT, THREADS>(raw_do, dout, p.sdo[2], qt * QT, p.S);
    if (threadIdx.x < QT) {
      const int r = qt * QT + threadIdx.x;
      const bool ok = r < p.S;
      float* at = lse_s + (qt & 1) * QT + threadIdx.x;
      cp_async<4>(at, ok ? p.lse + row_base + r : p.lse, ok);
      cp_async<4>(at + 2 * QT, ok ? p.delta + row_base + r : p.delta, ok);
    }
    cp_commit();
  };
  stage_tile(first);
  load_rows<SPLIT, T, D, ROWS, THREADS>(
      k_hi, k_lo, static_cast<const T*>(p.k) + b * p.sk[0] + hk * p.sk[1],
      p.sk[2], kv0, p.S);
  load_rows<SPLIT, T, D, ROWS, THREADS>(
      v_hi, v_lo, static_cast<const T*>(p.v) + b * p.sv[0] + hk * p.sv[1],
      p.sv[2], kv0, p.S);

  float dk[D / 2], dv[D / 2];  // in wgmma's accumulator order
  // one q tile's product of DN columns of dV or dK; a column block of
  // Q^T or dO^T (DN rows d) starts B_OFF words on
  constexpr int DN = D / L::KV_N;
  constexpr int B_OFF = (DN / 8) * (QT / 4) * CORE;
  float acc[DN / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int qt = first; qt < n_q; ++qt) {
    const int q0 = qt * QT;
    cp_wait_all();
    __syncthreads();  // tile qt has landed; every warpgroup is done with
                      // the previous operand tiles
    split_tile<SPLIT, T, D, QT, THREADS, 2, 2>(
        {raw_q, raw_do}, {q_hi, do_hi}, {q_lo, do_lo}, {qt_hi, dot_hi},
        {qt_lo, dot_lo});
    fence_proxy_async();
    __syncthreads();  // operand tiles complete; the raw tiles are free
    if (qt + 1 < n_q)
      stage_tile(qt + 1);  // the next tile loads while this one is used
    else
      cp_commit();
    const float* lse_t = lse_s + (qt & 1) * QT;
    const float* dlt_t = dlt_s + (qt & 1) * QT;

    // a q tile wholly above this warpgroup's kv rows is skipped
    if (!p.causal || q0 + QT - 1 >= kw0) {
      // S^T = K Q^T and dP^T = V dO^T: kv rows, q columns, two groups
      float s[QT / 2], dp[QT / 2];
      wgmma_fence();
      product_ss<SPLIT, QT, DK>(s, k_hi + a_off, k_lo + a_off, SBO_D, q_hi,
                                q_lo, SBO_D);
      wgmma_commit();
      product_ss<SPLIT, QT, DK>(dp, v_hi + a_off, v_lo + a_off, SBO_D,
                                do_hi, do_lo, SBO_D);
      wgmma_commit();

      // P^T while dP^T runs: s[4 j + i] holds q column 8 j + 2t + (i & 1)
      // of kv row row + 8 ((i >> 1) & 1); the diagonal tile and ragged
      // edges are masked per element
      wgmma_wait<1>();
      const bool edge = (p.causal && q0 < kw0 + WG_ROWS - 1) ||
                        q0 + QT > p.S || kw0 + WG_ROWS > p.S;
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lse_t + 8 * j +
                                                          2 * t);
        const float l2[2] = {l.x * LOG2E, l.y * LOG2E};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 4 * j + i;
          float pr = ex2(fmaf(s[e], p.scale_log2, -l2[i & 1]));
          if (edge && !attended(q0 + 8 * j + 2 * t + (i & 1),
                                row + 8 * ((i >> 1) & 1), p.S, p.causal))
            pr = 0.f;
          s[e] = pr;
        }
      }

      // dV += P^T dO and dK += dS^T Q, P^T and dS^T as A fragments, each
      // tile's product in acc (KV_N column blocks of DN, one at a time)
      // and added to dV and dK in f32; dS^T while the first block runs
      uint32_t p_hi[NQ][4], p_lo[NQ][4], ds_hi[NQ][4], ds_lo[NQ][4];
      fragments<NQ>(s, p_hi, p_lo);
#pragma unroll
      for (int n = 0; n < L::KV_N; ++n) {
        wgmma_fence();
        product_rs<SPLIT, DN, NQ>(acc, p_hi, p_lo, dot_hi + n * B_OFF,
                                  dot_lo + n * B_OFF, SBO_Q);
        wgmma_commit();
        if (n == 0) {
          wgmma_wait<1>();  // dP^T is done
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            const float2 dl = *reinterpret_cast<const float2*>(
                dlt_t + 8 * j + 2 * t);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              dp[4 * j + i] = s[4 * j + i] * (dp[4 * j + i] -
                                              ((i & 1) ? dl.y : dl.x));
          }
          fragments<NQ>(dp, ds_hi, ds_lo);
        }
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < DN / 2; ++i) dv[n * DN / 2 + i] += acc[i];
      }
#pragma unroll
      for (int n = 0; n < L::KV_N; ++n) {
        wgmma_fence();
        product_rs<SPLIT, DN, NQ>(acc, ds_hi, ds_lo, qt_hi + n * B_OFF,
                                  qt_lo + n * B_OFF, SBO_Q);
        wgmma_commit_and_wait();
#pragma unroll
        for (int i = 0; i < DN / 2; ++i) dk[n * DN / 2 + i] += acc[i];
      }
    }
  }

  // this head's partials: d[4 nd + 2r + c] is (row + 8r, 8 nd + 2t + c)
  float* pk = p.part + row_base * D;
  float* pv = pk + static_cast<long long>(p.B) * p.H * p.S * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int out = row + 8 * r;
    if (out < p.S) {
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const long long at = static_cast<long long>(out) * D + 8 * nd + 2 * t;
        store2(pk + at, dk[4 * nd + 2 * r], dk[4 * nd + 2 * r + 1]);
        store2(pv + at, dv[4 * nd + 2 * r], dv[4 * nd + 2 * r + 1]);
      }
    }
  }
}

// dK and dV of each kv head: its group's partials summed in head order;
// one thread per 4 values of a (batch, kv head, row)
template <typename T>
__global__ void __launch_bounds__(PRE_THREADS)
    flash_attention_bwd_reduce_kernel(const Params p) {
  const int Hkv = p.H / p.group;
  const int per_row = p.D / 4;
  const long long n = static_cast<long long>(p.B) * Hkv * p.S * per_row;
  const long long half = static_cast<long long>(p.B) * p.H * p.S * p.D;
  for (long long idx = blockIdx.x * static_cast<long long>(PRE_THREADS) +
                       threadIdx.x;
       idx < n; idx += static_cast<long long>(gridDim.x) * PRE_THREADS) {
    const int c = static_cast<int>(idx % per_row) * 4;
    long long rest = idx / per_row;
    const int s = static_cast<int>(rest % p.S);
    rest /= p.S;
    const int hk = static_cast<int>(rest % Hkv);
    const int b = static_cast<int>(rest / Hkv);
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int g = 0; g < p.group; ++g) {
      const long long at =
          ((static_cast<long long>(b) * p.H + hk * p.group + g) * p.S + s) *
              p.D + c;
      const float4 a = load4(p.part + at);
      const float4 v = load4(p.part + half + at);
      sk = make_float4(sk.x + a.x, sk.y + a.y, sk.z + a.z, sk.w + a.w);
      sv = make_float4(sv.x + v.x, sv.y + v.y, sv.z + v.z, sv.w + v.w);
    }
    store4(static_cast<T*>(p.dk) + b * p.sdk[0] + hk * p.sdk[1] +
               s * p.sdk[2] + c,
           make_float4(sk.x * p.scale, sk.y * p.scale, sk.z * p.scale,
                       sk.w * p.scale));
    store4(static_cast<T*>(p.dv) + b * p.sdv[0] + hk * p.sdv[1] +
               s * p.sdv[2] + c,
           sv);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Plan<T, D>::WGS * WG, 1)
    flash_attention_bwd_dq_kernel(const Params p) {
  using L = Plan<T, D>;
  constexpr bool SPLIT = L::SPLIT;
  constexpr int KT = L::TILE;  // kv rows per kv tile
  constexpr int ROWS = L::ROWS;
  constexpr int THREADS = L::WGS * WG;
  constexpr int DK = D / 8;    // k-steps of Q K^T and dO V^T
  constexpr int NKV = KT / 8;  // k-steps of dS K
  constexpr uint32_t SBO_D = (D / 4) * CORE * 4;   // d along K
  constexpr uint32_t SBO_K = (KT / 4) * CORE * 4;  // kv along K
  constexpr int Q_OP = SPLIT ? ROWS * D : 0;
  constexpr int K_OP = SPLIT ? KT * D : 0;
  extern __shared__ __align__(128) unsigned char smem[];
  // Q, dO hi, then lo (f32); K, V (rows kv), K^T (rows d) hi, then lo
  // (f32); the raw K and V
  uint32_t* q_hi = reinterpret_cast<uint32_t*>(smem);
  uint32_t* do_hi = q_hi + ROWS * D;
  uint32_t* q_lo = do_hi + ROWS * D;
  uint32_t* do_lo = q_lo + Q_OP;
  uint32_t* k_hi = do_lo + Q_OP;
  uint32_t* v_hi = k_hi + KT * D;
  uint32_t* kt_hi = v_hi + KT * D;
  uint32_t* k_lo = kt_hi + KT * D;
  uint32_t* v_lo = k_lo + K_OP;
  uint32_t* kt_lo = v_lo + K_OP;
  T* raw_k = reinterpret_cast<T*>(kt_lo + K_OP);
  T* raw_v = raw_k + KT * L::LDR;

  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int hk = h / p.group;
  const int qb0 = (gridDim.y - 1 - blockIdx.y) * ROWS;  // bottom first
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wg = __shfl_sync(FULL, static_cast<int>(threadIdx.x) / WG, 0);
  const int wq0 = qb0 + wg * WG_ROWS;  // this warpgroup's first q row
  const int row = wq0 + ((threadIdx.x / 32) % 4) * 16 + g;  // and row + 8
  const int a_off = wg * WG_ROWS * D;

  const T* k = static_cast<const T*>(p.k) + b * p.sk[0] + hk * p.sk[1];
  const T* v = static_cast<const T*>(p.v) + b * p.sv[0] + hk * p.sv[1];
  const int last_row = min(p.S, qb0 + ROWS) - 1;
  const int n_kv = p.causal ? last_row / KT + 1 : (p.S + KT - 1) / KT;
  stage<T, D, KT, THREADS>(raw_k, k, p.sk[2], 0, p.S);
  stage<T, D, KT, THREADS>(raw_v, v, p.sv[2], 0, p.S);
  cp_commit();
  load_rows<SPLIT, T, D, ROWS, THREADS>(
      q_hi, q_lo, static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[1],
      p.sq[2], qb0, p.S);
  load_rows<SPLIT, T, D, ROWS, THREADS>(
      do_hi, do_lo,
      static_cast<const T*>(p.dout) + b * p.sdo[0] + h * p.sdo[1],
      p.sdo[2], qb0, p.S);
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.S;
  float lse2[2], dlt[2];  // of rows row and row + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row + 8 * r < p.S;
    lse2[r] = ok ? p.lse[row_base + row + 8 * r] * LOG2E : 0.f;
    dlt[r] = ok ? p.delta[row_base + row + 8 * r] : 0.f;
  }
  // up to D = 64, Q hi and dO hi are also held as A fragments: two of the
  // three passes of S and dP read A from registers (the register budget
  // allows it there, as the forward's does)
  constexpr bool A_REGS = D <= 64;
  uint32_t qf[A_REGS ? DK : 1][4], dof[A_REGS ? DK : 1][4];
  if constexpr (A_REGS) {
    __syncthreads();  // Q and dO are in shared memory
    const int r0 = ((threadIdx.x / 32) % 4) * 16 + g;
    read_fragments<D>(qf, q_hi + a_off, r0, t);
    read_fragments<D>(dof, do_hi + a_off, r0, t);
  }

  float dq[D / 2], acc[D / 2];  // the running sum and one kv tile's
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int kv0 = kt * KT;
    cp_wait_all();
    __syncthreads();  // tile kt has landed; every warpgroup is done with
                      // the previous operand tiles
    split_tile<SPLIT, T, D, KT, THREADS, 2, 1>(
        {raw_k, raw_v}, {k_hi, v_hi}, {k_lo, v_lo}, {kt_hi}, {kt_lo});
    fence_proxy_async();
    __syncthreads();  // operand tiles complete; the raw tiles are free
    if (kt + 1 < n_kv) {  // the next tile loads while this one is used
      stage<T, D, KT, THREADS>(raw_k, k, p.sk[2], kv0 + KT, p.S);
      stage<T, D, KT, THREADS>(raw_v, v, p.sv[2], kv0 + KT, p.S);
    }
    cp_commit();

    // a kv tile wholly right of this warpgroup's q rows is skipped
    if (!p.causal || kv0 <= wq0 + WG_ROWS - 1) {
      // S = Q K^T and dP = dO V^T: q rows, kv columns, two groups
      float s[KT / 2], dp[KT / 2];
      wgmma_fence();
      if constexpr (A_REGS)
        product_rs_hi<SPLIT, KT, DK>(s, qf, q_lo + a_off, SBO_D, k_hi, k_lo,
                                     SBO_D);
      else
        product_ss<SPLIT, KT, DK>(s, q_hi + a_off, q_lo + a_off, SBO_D, k_hi,
                                  k_lo, SBO_D);
      wgmma_commit();
      if constexpr (A_REGS)
        product_rs_hi<SPLIT, KT, DK>(dp, dof, do_lo + a_off, SBO_D, v_hi,
                                     v_lo, SBO_D);
      else
        product_ss<SPLIT, KT, DK>(dp, do_hi + a_off, do_lo + a_off, SBO_D,
                                  v_hi, v_lo, SBO_D);
      wgmma_commit();

      // P while dP runs, then dS: s[4 j + i] holds kv column
      // 8 j + 2t + (i & 1) of q row row + 8 ((i >> 1) & 1)
      wgmma_wait<1>();
      const bool edge = (p.causal && kv0 + KT - 1 > wq0) ||
                        kv0 + KT > p.S || wq0 + WG_ROWS > p.S;
#pragma unroll
      for (int e = 0; e < KT / 2; ++e) {
        const int r = (e >> 1) & 1;
        float pr = ex2(fmaf(s[e], p.scale_log2, -lse2[r]));
        if (edge && !attended(row + 8 * r, kv0 + 8 * (e >> 2) + 2 * t +
                                               (e & 1), p.S, p.causal))
          pr = 0.f;
        s[e] = pr;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < KT / 2; ++e)
        dp[e] = s[e] * (dp[e] - dlt[(e >> 1) & 1]);

      // dQ += dS K, dS as A fragments: each tile's product in acc, added
      // to dQ in f32
      uint32_t ds_hi[NKV][4], ds_lo[NKV][4];
      fragments<NKV>(dp, ds_hi, ds_lo);
      wgmma_fence();
      product_rs<SPLIT, D, NKV>(acc, ds_hi, ds_lo, kt_hi, kt_lo, SBO_K);
      wgmma_commit_and_wait();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq[i] += acc[i];
    }
  }

  T* dq_out = static_cast<T*>(p.dq) + b * p.sdq[0] + h * p.sdq[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int out = row + 8 * r;
    if (out < p.S) {
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        store2(dq_out + out * p.sdq[2] + 8 * nd + 2 * t,
               dq[4 * nd + 2 * r] * p.scale,
               dq[4 * nd + 2 * r + 1] * p.scale);
    }
  }
}

// Above 48 KB a block's shared memory must be allowed first: once per
// device and kernel, at the first launch (never inside a CUDA-graph
// capture, where no such call belongs).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool* allowed, int device) {
  if (allowed[device]) return cudaSuccess;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set == cudaSuccess) allowed[device] = true;
  return set;
}

// the card's SM count, read once per device (0 if it cannot be read)
int sm_count(int device) {
  static int counts[MAX_DEVICES] = {};
  if (!counts[device] &&
      cudaDeviceGetAttribute(&counts[device],
                             cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    counts[device] = 0;
  return counts[device];
}

// The grids of (T, D) at a shape on a card of ``sms`` SMs: dkdv's and
// dq's (batch x q head, then blocks of ROWS rows), the reduce pass's
// (enough blocks to fill the card eight times over, each thread walking
// the rest), and the longest block's tile count (every tile, for dkdv's
// first block and dq's last, causal or not).
struct Grid {
  dim3 rows;
  int reduce;
  int longest;
};

template <typename T, int D>
Grid grid_of(int B, int H, int Hkv, int S, int sms) {
  using L = Plan<T, D>;
  const long long n = static_cast<long long>(B) * Hkv * S * (D / 4);
  const long long reduce = n / PRE_THREADS + 1;
  const long long fill = 8LL * sms;
  return {dim3(B * H, (S + L::ROWS - 1) / L::ROWS),
          static_cast<int>(reduce < fill ? reduce : fill),
          (S + L::TILE - 1) / L::TILE};
}

template <typename T, int D>
cudaError_t launch_d(const Params& p, int sms, int device,
                     cudaStream_t stream) {
  using L = Plan<T, D>;
  static bool dkdv_allowed[MAX_DEVICES] = {};
  static bool dq_allowed[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(flash_attention_bwd_dkdv_kernel<T, D>,
                               L::DKDV_BYTES, dkdv_allowed, device);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_attention_bwd_dq_kernel<T, D>, L::DQ_BYTES,
                   dq_allowed, device);
  if (err != cudaSuccess) return err;

  const Grid g = grid_of<T, D>(p.B, p.H, p.H / p.group, p.S, sms);
  flash_attention_bwd_preprocess_kernel<T>
      <<<dim3((p.H * p.S + PRE_WARPS - 1) / PRE_WARPS, p.B), PRE_THREADS, 0,
         stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dkdv_kernel<T, D>
      <<<g.rows, L::WGS * WG, L::DKDV_BYTES, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_attention_bwd_reduce_kernel<T>
      <<<g.reduce, PRE_THREADS, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dq_kernel<T, D>
      <<<g.rows, L::WGS * WG, L::DQ_BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params& p, int sms, int device,
                   cudaStream_t stream) {
  switch (p.D) {
    case 32: return launch_d<T, 32>(p, sms, device, stream);
    case 64: return launch_d<T, 64>(p, sms, device, stream);
    case 80: return launch_d<T, 80>(p, sms, device, stream);
    case 112: return launch_d<T, 112>(p, sms, device, stream);
    case 128: return launch_d<T, 128>(p, sms, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int D>
void plan_d(int B, int H, int Hkv, int S, int sms, int* out) {
  using L = Plan<T, D>;
  const Grid g = grid_of<T, D>(B, H, Hkv, S, sms);
  out[0] = L::ROWS;
  out[1] = L::TILE;
  out[2] = L::DKDV_BYTES;
  out[3] = L::DQ_BYTES;
  out[4] = static_cast<int>(g.rows.x * g.rows.y);
  out[5] = g.reduce;
  out[6] = g.longest;
  out[7] = sms;
}

template <typename T>
int plan(int B, int H, int Hkv, int S, int D, int sms, int* out) {
  switch (D) {
    case 32: plan_d<T, 32>(B, H, Hkv, S, sms, out); return 0;
    case 64: plan_d<T, 64>(B, H, Hkv, S, sms, out); return 0;
    case 80: plan_d<T, 80>(B, H, Hkv, S, sms, out); return 0;
    case 112: plan_d<T, 112>(B, H, Hkv, S, sms, out); return 0;
    case 128: plan_d<T, 128>(B, H, Hkv, S, sms, out); return 0;
    default: return cudaErrorInvalidValue;
  }
}

bool valid_shape(int B, int H, int Hkv, int S, int device) {
  return B >= 1 && B <= 65535 && H >= 1 && Hkv >= 1 && H % Hkv == 0 &&
         S >= 1 && (S + WG_ROWS - 1) / WG_ROWS <= 65535 &&
         static_cast<long long>(B) * H <= 2147483647LL &&
         static_cast<long long>(H) * S <= 2147483647LL && device >= 0 &&
         device < MAX_DEVICES;
}

}  // namespace

extern "C" {

// q, o, dout, dq: (B, H, S, D); k, v, dk, dv: (B, Hkv, S, D); lse and
// delta: (B, H, S) f32 contiguous (lse from the forward kernel, delta
// scratch written here); part: (2, B, H, S, D) f32 scratch (each q
// head's dK and dV, summed over the group by the reduce pass).  strides:
// 24 int64 values, the batch, head and row strides of q, k, v, o, dout,
// dq, dk and dv in that order, each a multiple of 4 elements, with
// 16-byte aligned starts.  dtype: 0 f32, 1 bf16 (all eight tensors).  D:
// 32, 64, 80, 112 or 128.  Launches the four kernels on ``stream``
// without synchronizing; returns the first cudaGetLastError() that is not
// 0, else 0.  ``device`` is the card that ``stream`` and the tensors
// belong to.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const float* lse, float* delta, float* part,
                              void* dq, void* dk, void* dv,
                              const long long* strides, int dtype, int B,
                              int H, int Hkv, int S, int D, int causal,
                              int device, void* stream) {
  if (!valid_shape(B, H, Hkv, S, device)) return cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int sms = sm_count(device);
  if (sms < 1) return cudaErrorInvalidDevice;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.part = part;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  long long* dst[8] = {p.sq, p.sk, p.sv, p.so, p.sdo, p.sdq, p.sdk, p.sdv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  p.B = B;
  p.H = H;
  p.group = H / Hkv;
  p.S = S;
  p.D = D;
  p.causal = causal;
  p.scale = 1.f / sqrtf(static_cast<float>(D));
  p.scale_log2 = LOG2E * p.scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0   ? launch<float>(p, sms, device, s)
      : dtype == 1 ? launch<__nv_bfloat16>(p, sms, device, s)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The launch plan of a call at (B, H, Hkv, S, D, dtype 0 f32 or 1 bf16)
// on ``device``, as repro_flash_attention_bwd launches it: out[0] rows per
// block (kv rows in dkdv, q rows in dq), out[1] rows per tile (q tiles in
// dkdv, kv tiles in dq), out[2] and out[3] the dkdv and dq blocks' shared
// memory in bytes, out[4] the blocks of each of dkdv and dq, out[5] the
// reduce pass's blocks, out[6] the longest block's tiles, out[7] the
// card's SM count.  Returns 0, or an error for a shape, D, dtype or
// device it does not take.
int repro_flash_attention_bwd_plan(int B, int H, int Hkv, int S, int D,
                                   int dtype, int device, int* out) {
  if (!out || !valid_shape(B, H, Hkv, S, device) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const int sms = sm_count(device);
  if (sms < 1) return cudaErrorInvalidDevice;
  return dtype == 0 ? plan<float>(B, H, Hkv, S, D, sms, out)
                    : plan<__nv_bfloat16>(B, H, Hkv, S, D, sms, out);
}

}  // extern "C"
