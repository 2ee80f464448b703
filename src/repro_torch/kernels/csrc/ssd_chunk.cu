// Mamba2 SSD intra-chunk kernel for Hopper, CUDA C++ for sm_90a, on the
// tensor cores (3xTF32 wgmma).
//
// Replaces the JAX package's Pallas kernel _ssd_chunk_kernel
// (src/repro/kernels/ssd_scan.py:23, launched by ssd_chunk_batch).  For one
// chunk of Q rows of one head of one sequence, with x already scaled by dt,
// a = dt * A the log-decays and B, C the input and output projections:
//
//   cum     = cumsum(a)                                  (Q)
//   y_intra = ((C B^T) o L) x,  L[i, j] = exp(cum_i - cum_j) for i >= j
//   state   = sum_j exp(cum_Q - cum_j) x_j B_j^T          (P, N)
//   decay   = exp(cum_Q)
//
// all in f32.  The inter-chunk recurrence and the y_off = exp(cum) C state
// term stay on the host side (kernels/ops.py), as in the JAX package.  Two
// differences of form, none of function:
//
//  * Layout.  The Pallas kernel takes a (batch * head * chunk, Q, ...) grid
//    that its host side builds with transposes and with B/C broadcast over
//    the heads in memory.  This kernel reads the model's own tensors by
//    strides: x (B, S, H, P), a (B, S, H), and B/C (B, S, N) indexed by
//    (batch, chunk) only, shared by every head (one group).  It writes
//    y_intra (B, S, H, P) and cum (B, S, H) in the sequence layout, and
//    state (B, nc, H, P, N) and decay (B, nc, H) per chunk.
//  * Q is any chunk length up to 128 (a prompt shorter than a chunk is one
//    chunk of its own length).
//
// Bound on an H100 SXM: bytes.  At mamba2-1.3b's server shape (1, 32768
// tokens, 64 heads, P 64, N 128, Q 128) the function moves 1.661 GB (x and
// y_intra 268 MB each, the states 537 MB): 0.496 ms at 3.35 TB/s.  Its
// 52.6 GFLOP (C B^T's causal half once per chunk; per head the decay
// mask, S x and the state) take 0.319 ms as 3xTF32 on the tensor cores at
// 495 TFLOP/s, and would take 0.785 ms as f32 FMA at 67 TFLOP/s.  So all
// three products run on the tensor cores, and C B^T, which B and C (one
// group) make the same for every head, is computed once per block:
//
//  * Exactness.  The path is held to 3e-4 (the JAX package's tolerance);
//    one TF32 pass keeps about three digits and breaks it.  Every f32
//    operand is split hi + lo and each product accumulated as 3xTF32
//    (tf32_wgmma.cuh), as the flash kernel does.
//  * Grid.  One block of two warpgroups (256 threads) per (chunk, group of
//    HG heads, batch), and per 128 state columns when N > 128.  The block
//    computes C B^T once and keeps it in registers for its HG heads.  The
//    launcher picks HG from the SM count, fewest waves times (HG + 1)
//    (C B^T costs about one head's work): at 2048 tokens HG 8 (128 blocks),
//    at 8192 HG 32 (128), at 32768 HG 64 (256); the towers' 16 heads take
//    HG 2 at 2048 (128 blocks) and HG 16 at 32768 (256).
//    repro_ssd_chunk_plan reports the choice.
//  * C B^T: M = the chunk's rows (warpgroup w: rows 64w .. 64w + 63), N =
//    its columns up to the warpgroup's last row (64 or 128: the causal
//    half), K = d_state in slices of 64.  C's A fragments are split in
//    registers from device memory; each B slice is split into a K-major
//    tile.  The accumulator (64 registers) is held across the heads.
//  * y_h = S_h x_h: S_h is built from the C B^T accumulator one k-step at
//    a time: masked above the diagonal before the exponential, and
//    exp(cum_i - cum_j) taken of the difference (a product of exp(cum_i)
//    and exp(-cum_j) overflows over a long chunk); then split into A
//    fragments.  B is x_h^T.  k-steps above the warpgroup's last row are
//    skipped.  As in the flash kernel, the accumulator's columns (2t,
//    2t + 1) are renamed A columns (t, t + 4) instead of moving S: every
//    tile with the chunk's rows along K (x^T, B^T) stores j = 8 s + 2 e + h
//    at position 8 s + e + 4 h.
//  * state_h = (x_h o w)^T B with w_j = exp(cum_Q - cum_j): M = P (rows
//    past P are zero), N = the warpgroup's half of the block's state
//    columns, K = j.  A is built from x_h^T's hi + lo (x to 22 bits) times
//    w, split again; B is B^T, split once per block.  The accumulator holds
//    rows p and columns n, so it is stored as (P, N) directly.
//  * y_h and state_h are issued four k-steps at a time from two fragment
//    buffers (32 registers each): batch b + 1's fragments are built while
//    batch b's wgmmas run (wait_group 1), since building them (the
//    exponentials, the scaling, the splits) costs about as much as the
//    products.  ptxas fits the kernel without spilling.
//  * Control flow around the products is uniform and each branch holds
//    whole fence-issue-commit-wait sequences: the warpgroup index is read
//    from lane 0 (so ptxas can tell it is warp-uniform), and the batch
//    counts are fixed per warpgroup (y: two for warpgroup 0, four for
//    warpgroup 1; the state: four), whatever Q.  Otherwise ptxas
//    serializes every wgmma (its note C7520).  A k-step past the diagonal
//    or past Q multiplies zeros (masked S, zero-filled rows, w = 0).
//  * Shared memory at P 64, N 128: B^T hi and lo (128 KB, the block's),
//    the current head's x^T hi and lo (64 KB; C B^T's B slices use it
//    before the first head), the next head's x (32 KB, cp.async, rows past
//    Q zero-filled) and a, and cum and w: 225.5 KB, one block per SM.
//  * The prefix sum of a: warp 0, four values a lane and __shfl_up_sync
//    across the lanes.  a past Q is zero, so cum past Q is cum_Q.
//  * Rows past Q are zero in every operand and never stored.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tf32_wgmma.cuh"

namespace {

constexpr int QMAX = 128;     // chunk rows a block takes
constexpr int WG_ROWS = 64;   // rows per warpgroup: wgmma's M
constexpr int THREADS = 256;  // two warpgroups
constexpr int NS = 64;        // d_state columns per staged B slice
constexpr int NT_MAX = 128;   // state columns per block
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;
// the SBO of tiles with the chunk's rows along K (x^T, B^T) and of a B
// slice (d_state along K)
constexpr uint32_t SBO_J = (QMAX / 4) * CORE * 4;
constexpr uint32_t SBO_S = (NS / 4) * CORE * 4;

struct Params {
  const float* x;   // (B, S, H, P): last stride 1, 16-byte rows
  const float* a;   // (B, S, H), strided
  const float* bm;  // (B, S, N), strided
  const float* cm;  // (B, S, N), strided
  float* y;         // (B, S, H, P), contiguous
  float* state;     // (B, nc, H, P, N), contiguous
  float* decay;     // (B, nc, H), contiguous
  float* cum;       // (B, S, H), contiguous
  long long sx[4], sa[3], sb[3], sc[3];  // element strides
  int S, H, N, Q, nc;
  int heads;   // heads per block (HG)
  int groups;  // head groups: ceil(H / heads)
};

// A block's shared memory, in 4-byte words: B^T hi and lo (rows: the
// block's NT state columns; K: the chunk's rows), then a region that holds
// the B slices' hi and lo (rows: the chunk's; K: NS columns of d_state)
// before the first head and x_h^T hi and lo (rows p) after, then the next
// head's raw x and a, and cum and w.
template <int P, int NT2>
struct Smem {
  static constexpr int NT = 2 * NT2;
  static constexpr int BT = NT * QMAX;
  static constexpr int XT = P * QMAX;
  static constexpr int BK = QMAX * NS;
  static constexpr int REGION = 2 * (XT > BK ? XT : BK);
  static constexpr int RAW_X = QMAX * P;
  static constexpr int BYTES = (2 * BT + REGION + RAW_X + 3 * QMAX) * 4;
  static_assert(NT <= NT_MAX && NT2 % 8 == 0, "state columns per block");
  static_assert(BYTES <= 232448, "an H100 block has 227 KB");
};

// head h's x (Q x P, rows past Q zero) and a (zero past Q), into raw_x and
// a_buf with cp.async
template <int P>
__device__ __forceinline__ void load_head(float* raw_x, float* a_buf,
                                          const Params& p, const float* xb,
                                          const float* ab, int h) {
  constexpr int PER_ROW = P / 4;
  const float* xh = xb + h * p.sx[2];
  for (int idx = threadIdx.x; idx < QMAX * PER_ROW; idx += THREADS) {
    const int r = idx / PER_ROW;
    const int col = (idx % PER_ROW) * 4;
    const bool valid = r < p.Q;
    cp_async<16>(raw_x + r * P + col, valid ? xh + r * p.sx[1] + col : xh,
                 valid);
  }
  const float* ah = ab + h * p.sa[2];
  for (int i = threadIdx.x; i < QMAX; i += THREADS)
    cp_async<4>(a_buf + i, i < p.Q ? ah + i * p.sa[1] : ah, i < p.Q);
}

template <int P, int NT2>
__global__ void __launch_bounds__(THREADS, 1)
    ssd_chunk_kernel(const Params p) {
  using L = Smem<P, NT2>;
  constexpr int NT = L::NT;
  extern __shared__ __align__(128) uint32_t smem[];
  uint32_t* bt_hi = smem;
  uint32_t* bt_lo = bt_hi + L::BT;
  uint32_t* bk_hi = bt_lo + L::BT;  // before the first head
  uint32_t* bk_lo = bk_hi + L::BK;
  uint32_t* xt_hi = bt_lo + L::BT;  // from the first head on
  uint32_t* xt_lo = xt_hi + L::XT;
  float* raw_x = reinterpret_cast<float*>(xt_hi + L::REGION);
  float* a_buf = raw_x + L::RAW_X;
  float* cum_s = a_buf + QMAX;  // cum; past Q, cum_Q
  float* w_s = cum_s + QMAX;    // exp(cum_Q - cum_j); past Q, 0

  const int c = blockIdx.x;
  const int group = blockIdx.y % p.groups;
  const int slice = blockIdx.y / p.groups;
  const int b = blockIdx.z;
  const int h_end = min(p.H, (group + 1) * p.heads);
  const int n_base = slice * NT;  // the block's first state column
  const bool first = slice == 0;  // writes y_intra, cum and decay
  const int Q = p.Q;
  const long long s0 = static_cast<long long>(c) * Q;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;  // the fragment's row group
  const int t = lane % 4;  // its column within the group
  // the warpgroup, read from lane 0 so that ptxas sees it is the same in
  // every lane: its branches then hold whole wgmma sequences and leave
  // the products unserialized
  const int wg = __shfl_sync(FULL, tid / 128, 0);
  const int warp = (tid / 32) % 4;  // within the warpgroup
  // this thread's chunk rows in C B^T and y: row0 and row0 + 8
  const int row0 = wg * WG_ROWS + warp * 16 + g;

  const float* xb = p.x + b * p.sx[0] + s0 * p.sx[1];
  const float* ab = p.a + b * p.sa[0] + s0 * p.sa[1];
  const float* bb = p.bm + b * p.sb[0] + s0 * p.sb[1];
  const float* cb = p.cm + b * p.sc[0] + s0 * p.sc[1];

  load_head<P>(raw_x, a_buf, p, xb, ab, group * p.heads);
  cp_commit();

  // B^T of the block's state columns: thread idx takes column n_base + nn
  // and K positions 4 kb .. 4 kb + 3 (rows j = 8 (kb / 2) + kb % 2 + 2e);
  // a warp reads 32 neighbouring columns of one row at a time
  for (int idx = tid; idx < NT * (QMAX / 4); idx += THREADS) {
    const int nn = idx % NT;
    const int kb = idx / NT;
    const int n = n_base + nn;
    const int j = 8 * (kb >> 1) + (kb & 1);
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = n < p.N && j + 2 * e < Q
                 ? bb[(j + 2 * e) * p.sb[1] + n * p.sb[2]]
                 : 0.f;
    store_operand<true>(bt_hi, bt_lo, core_index(nn, 4 * kb, QMAX),
                        make_float4(v[0], v[1], v[2], v[3]));
  }

  // C B^T, once for all the block's heads: warpgroup 0 holds rows 0..63,
  // columns 0..63 (the first 32 registers), warpgroup 1 rows 64..127,
  // columns 0..127.  Only the first slice's blocks need it.  Rows past Q
  // are zeros.
  float gacc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) gacc[i] = 0.f;
  uint32_t c_hi[NS / 8][4], c_lo[NS / 8][4];
  auto c_bt = [&](auto columns) {  // this slice's k-steps, N = columns
    constexpr int NC = decltype(columns)::value;
    float(&d)[NC / 2] = reinterpret_cast<float(&)[NC / 2]>(gacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NS / 8; ++kk) {
      const uint64_t dh = descriptor(bk_hi + kk * 2 * CORE, SBO_S);
      const uint64_t dl = descriptor(bk_lo + kk * 2 * CORE, SBO_S);
      wgmma<NC>(d, c_lo[kk], dh, 1);
      wgmma<NC>(d, c_hi[kk], dl, 1);
      wgmma<NC>(d, c_hi[kk], dh, 1);
    }
    wgmma_commit_and_wait();
  };
  for (int n0 = 0; first && n0 < p.N; n0 += NS) {
    const int ns = min(NS, p.N - n0);
    __syncthreads();  // the previous slice's tile is no longer read
    // thread idx takes core matrix idx / 8, its row idx % 8: row j,
    // columns n0 + 4 kb .. n0 + 4 kb + 3, at word 4 idx
    for (int idx = tid; idx < QMAX * NS / 4; idx += THREADS) {
      const int kb = (idx >> 3) % (NS / 4);
      const int j = 8 * ((idx >> 3) / (NS / 4)) + (idx & 7);
      const bool ok = j < Q && 4 * kb < ns;
      const float* src = bb + j * p.sb[1] + (n0 + 4 * kb) * p.sb[2];
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = ok ? src[e * p.sb[2]] : 0.f;
      store_operand<true>(bk_hi, bk_lo, 4 * idx,
                          make_float4(v[0], v[1], v[2], v[3]));
    }
    fence_proxy_async();
    __syncthreads();  // the slice's tile (and, the first time, B^T) is
                      // complete
    {
      const bool ok0 = row0 < Q, ok1 = row0 + 8 < Q;
      const float* c0 = cb + row0 * p.sc[1];
      const float* c1 = cb + (row0 + 8) * p.sc[1];
#pragma unroll
      for (int kk = 0; kk < NS / 8; ++kk) {
        const bool in = 8 * kk < ns;  // columns past N are zero
        const long long n = (n0 + 8 * kk + t) * p.sc[2];
        const long long n4 = n + 4 * p.sc[2];
        split(in && ok0 ? c0[n] : 0.f, c_hi[kk][0], c_lo[kk][0]);
        split(in && ok1 ? c1[n] : 0.f, c_hi[kk][1], c_lo[kk][1]);
        split(in && ok0 ? c0[n4] : 0.f, c_hi[kk][2], c_lo[kk][2]);
        split(in && ok1 ? c1[n4] : 0.f, c_hi[kk][3], c_lo[kk][3]);
      }
    }
    if (wg == 0)
      c_bt(std::integral_constant<int, 64>());
    else
      c_bt(std::integral_constant<int, 128>());
  }

  for (int h = group * p.heads; h < h_end; ++h) {
    cp_wait_all();
    __syncthreads();  // head h's x and a have landed; every warp is done
                      // with the previous head's x^T (or the B slices)

    // cum by warp 0: lane l scans a[4l .. 4l + 3], then the lanes' totals
    if (tid < 32) {
      float4 v = reinterpret_cast<const float4*>(a_buf)[lane];
      v.y += v.x;
      v.z += v.y;
      v.w += v.z;
      float run = v.w;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const float up = __shfl_up_sync(FULL, run, d);
        if (lane >= d) run += up;
      }
      const float off = run - v.w;
      v.x += off;
      v.y += off;
      v.z += off;
      v.w += off;
      const float last = __shfl_sync(FULL, run, 31);  // cum_Q
      reinterpret_cast<float4*>(cum_s)[lane] = v;
      const float cv[4] = {v.x, v.y, v.z, v.w};
      float wv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * lane + e;
        wv[e] = j < Q ? expf(last - cv[e]) : 0.f;
        if (first && j < Q)
          p.cum[(b * static_cast<long long>(p.S) + s0 + j) * p.H + h] = cv[e];
      }
      reinterpret_cast<float4*>(w_s)[lane] =
          make_float4(wv[0], wv[1], wv[2], wv[3]);
      if (first && lane == 0)
        p.decay[(b * static_cast<long long>(p.nc) + c) * p.H + h] =
            expf(last);
    }
    // x_h^T: thread idx takes p = idx % P and K positions 4 kb .. 4 kb + 3
    // (rows 8 (kb / 2) + kb % 2 + 2e); a warp reads neighbouring p of a row
    for (int idx = tid; idx < P * QMAX / 4; idx += THREADS) {
      const int pp = idx % P;
      const int kb = idx / P;
      const float* src = raw_x + (8 * (kb >> 1) + (kb & 1)) * P + pp;
      store_operand<true>(xt_hi, xt_lo, core_index(pp, 4 * kb, QMAX),
                          make_float4(src[0], src[2 * P], src[4 * P],
                                      src[6 * P]));
    }
    fence_proxy_async();
    __syncthreads();  // x_h^T, cum and w are complete; raw x and a are free
    if (h + 1 < h_end) load_head<P>(raw_x, a_buf, p, xb, ab, h + 1);
    cp_commit();

    // y_h = S_h x_h over k-steps up to this warpgroup's last row (batches
    // of four: two for warpgroup 0, four for warpgroup 1).  S's A fragment
    // of k-step kk: a0 (row0, j0), a1 (row0 + 8, j0), a2 (row0, j0 + 1),
    // a3 (row0 + 8, j0 + 1) with j0 = 8 kk + 2t, from gacc[4 kk .. 4 kk + 3]
    auto y_product = [&](auto batches) {
      const float cum0 = cum_s[row0], cum1 = cum_s[row0 + 8];
      const float ninf = __int_as_float(0xff800000);
      float yacc[P / 2];
#pragma unroll
      for (int i = 0; i < P / 2; ++i) yacc[i] = 0.f;
      uint32_t f_hi[2][4][4], f_lo[2][4][4];
#pragma unroll
      for (int bt = 0; bt < decltype(batches)::value; ++bt) {
        if (bt >= 2) wgmma_wait<1>();  // batch bt - 2 is done with f[bt & 1]
        uint32_t(&hi)[4][4] = f_hi[bt & 1];
        uint32_t(&lo)[4][4] = f_lo[bt & 1];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kk = 4 * bt + q;
          const int j0 = 8 * kk + 2 * t;
          const float2 cj = *reinterpret_cast<const float2*>(cum_s + j0);
          const float e0 = __expf(j0 <= row0 ? cum0 - cj.x : ninf);
          const float e1 = __expf(j0 + 1 <= row0 ? cum0 - cj.y : ninf);
          const float e2 = __expf(j0 <= row0 + 8 ? cum1 - cj.x : ninf);
          const float e3 = __expf(j0 + 1 <= row0 + 8 ? cum1 - cj.y : ninf);
          split(gacc[4 * kk] * e0, hi[q][0], lo[q][0]);
          split(gacc[4 * kk + 2] * e2, hi[q][1], lo[q][1]);
          split(gacc[4 * kk + 1] * e1, hi[q][2], lo[q][2]);
          split(gacc[4 * kk + 3] * e3, hi[q][3], lo[q][3]);
        }
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kk = 4 * bt + q;
          const uint64_t dh = descriptor(xt_hi + kk * 2 * CORE, SBO_J);
          const uint64_t dl = descriptor(xt_lo + kk * 2 * CORE, SBO_J);
          wgmma<P>(yacc, lo[q], dh, 1);
          wgmma<P>(yacc, hi[q], dl, 1);
          wgmma<P>(yacc, hi[q], dh, 1);
        }
        wgmma_commit();
      }
      wgmma_wait<0>();
      float* y0 = p.y + ((b * static_cast<long long>(p.S) + s0 + row0) *
                             p.H + h) * P + 2 * t;
      float* y1 = y0 + 8LL * p.H * P;
#pragma unroll
      for (int q = 0; q < P / 8; ++q) {
        if (row0 < Q)
          *reinterpret_cast<float2*>(y0 + 8 * q) =
              make_float2(yacc[4 * q], yacc[4 * q + 1]);
        if (row0 + 8 < Q)
          *reinterpret_cast<float2*>(y1 + 8 * q) =
              make_float2(yacc[4 * q + 2], yacc[4 * q + 3]);
      }
    };
    if (first) {
      if (wg == 0)
        y_product(std::integral_constant<int, 2>());
      else
        y_product(std::integral_constant<int, 4>());
    }

    // state_h (P x this warpgroup's NT2 columns) = (x_h o w)^T B, in four
    // batches of four k-steps.  A's fragment of k-step kk: rows p0, p0 + 8
    // and K positions t, t + 4 of x_h^T (rows j0 = 8 kk + 2t and j0 + 1,
    // by the renaming)
    {
      const int p0 = warp * 16 + g;
      const bool ok0 = p0 < P, ok1 = p0 + 8 < P;
      const uint32_t* bth = bt_hi + wg * NT2 * QMAX;
      const uint32_t* btl = bt_lo + wg * NT2 * QMAX;
      auto x = [&](bool ok, int i) {
        return ok ? __uint_as_float(xt_hi[i]) + __uint_as_float(xt_lo[i])
                  : 0.f;
      };
      float sacc[NT2 / 2];
#pragma unroll
      for (int i = 0; i < NT2 / 2; ++i) sacc[i] = 0.f;
      uint32_t f_hi[2][4][4], f_lo[2][4][4];
#pragma unroll
      for (int bt = 0; bt < 4; ++bt) {
        if (bt >= 2) wgmma_wait<1>();  // batch bt - 2 is done with f[bt & 1]
        uint32_t(&hi)[4][4] = f_hi[bt & 1];
        uint32_t(&lo)[4][4] = f_lo[bt & 1];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kk = 4 * bt + q;
          const float2 wj =
              *reinterpret_cast<const float2*>(w_s + 8 * kk + 2 * t);
          // rows p0 and p0 + 8 (the next row group) at positions t and
          // t + 4 (the next core matrix along K)
          const int at = core_index(p0, 8 * kk + t, QMAX);
          const int at8 = at + (QMAX / 4) * CORE;
          split(x(ok0, at) * wj.x, hi[q][0], lo[q][0]);
          split(x(ok1, at8) * wj.x, hi[q][1], lo[q][1]);
          split(x(ok0, at + CORE) * wj.y, hi[q][2], lo[q][2]);
          split(x(ok1, at8 + CORE) * wj.y, hi[q][3], lo[q][3]);
        }
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kk = 4 * bt + q;
          const uint64_t dh = descriptor(bth + kk * 2 * CORE, SBO_J);
          const uint64_t dl = descriptor(btl + kk * 2 * CORE, SBO_J);
          wgmma<NT2>(sacc, lo[q], dh, 1);
          wgmma<NT2>(sacc, hi[q], dl, 1);
          wgmma<NT2>(sacc, hi[q], dh, 1);
        }
        wgmma_commit();
      }
      wgmma_wait<0>();
      float* st = p.state +
                  ((b * static_cast<long long>(p.nc) + c) * p.H + h) * P *
                      static_cast<long long>(p.N);
      const int n0 = n_base + wg * NT2 + 2 * t;
#pragma unroll
      for (int q = 0; q < NT2 / 8; ++q) {
        const int n = n0 + 8 * q;
        if (n < p.N) {
          if (ok0)
            *reinterpret_cast<float2*>(st + p0 * p.N + n) =
                make_float2(sacc[4 * q], sacc[4 * q + 1]);
          if (ok1)
            *reinterpret_cast<float2*>(st + (p0 + 8) * p.N + n) =
                make_float2(sacc[4 * q + 2], sacc[4 * q + 3]);
        }
      }
    }
  }
}

// How a call is cut into blocks: state columns per block (NT, a power of
// two from 16 to 128), the blocks per chunk along d_state (slices), heads
// per block (HG) and head groups.  HG minimises the number of waves of
// blocks over the SMs times (HG + 1): a block's C B^T costs about as much
// as one head.
struct Plan {
  int nt, slices, heads, groups;
};

Plan plan(int B, int S, int H, int N, int Q, int sms) {
  Plan pl;
  pl.nt = N > 64 ? NT_MAX : N > 32 ? 64 : N > 16 ? 32 : 16;
  pl.slices = (N + pl.nt - 1) / pl.nt;
  const long long per_group = static_cast<long long>(S / Q) * B * pl.slices;
  long long best = -1;
  for (int hg = 1; hg <= H; ++hg) {
    const int groups = (H + hg - 1) / hg;
    if (static_cast<long long>(groups) * pl.slices > 65535) continue;
    const long long waves = (per_group * groups + sms - 1) / sms;
    const long long cost = waves * (hg + 1);
    if (best < 0 || cost < best) {
      best = cost;
      pl.heads = hg;
      pl.groups = groups;
    }
  }
  return pl;
}

int sm_count(int device) {
  static int counts[MAX_DEVICES] = {};
  if (!counts[device] &&
      cudaDeviceGetAttribute(&counts[device],
                             cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    counts[device] = 0;
  return counts[device];
}

template <int P, int NT2>
cudaError_t launch(const Params& p, int B, int slices, int device,
                   cudaStream_t stream) {
  // Above 48 KB a block's shared memory must be allowed first: once per
  // device, at the first launch, since a later launch may be inside a
  // CUDA-graph capture, where no such call belongs.
  static bool allowed[MAX_DEVICES] = {};
  if (!allowed[device]) {
    const cudaError_t set = cudaFuncSetAttribute(
        ssd_chunk_kernel<P, NT2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<P, NT2>::BYTES);
    if (set != cudaSuccess) return set;
    allowed[device] = true;
  }
  const dim3 grid(p.nc, p.groups * slices, B);
  ssd_chunk_kernel<P, NT2>
      <<<grid, THREADS, Smem<P, NT2>::BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_p(const Params& p, int B, int nt, int slices, int device,
                     cudaStream_t stream) {
  switch (nt) {
    case 16: return launch<P, 8>(p, B, slices, device, stream);
    case 32: return launch<P, 16>(p, B, slices, device, stream);
    case 64: return launch<P, 32>(p, B, slices, device, stream);
    default: return launch<P, 64>(p, B, slices, device, stream);
  }
}

bool valid_shape(int B, int S, int H, int P, int N, int Q, int device) {
  return B >= 1 && B <= 65535 && H >= 1 && H <= 65535 && Q >= 1 &&
         Q <= QMAX && S >= Q && S % Q == 0 && N >= 16 && N % 16 == 0 &&
         (P == 16 || P == 32 || P == 64) && device >= 0 &&
         device < MAX_DEVICES;
}

}  // namespace

extern "C" {

// x (B, S, H, P), a (B, S, H), bm and cm (B, S, N): f32 (13 int64 strides:
// those of x, a, bm and cm in that order).  x's last stride is 1, its
// other strides are multiples of 4 and it starts 16-byte aligned; a, bm
// and cm take any strides.  Outputs, contiguous f32: y (B, S, H, P), state
// (B, S / Q, H, P, N), decay (B, S / Q, H), cum (B, S, H).  P: 16, 32 or
// 64; N: a multiple of 16; Q: 1..128, dividing S.  Launches on ``stream``
// without synchronizing; returns the launch's CUDA error (0 = success).
// ``device`` is the card that ``stream`` and the tensors belong to: this
// library carries its own CUDA runtime, whose current device is set here.
int repro_ssd_chunk(const void* x, const void* a, const void* bm,
                    const void* cm, void* y, void* state, void* decay,
                    void* cum, const long long* strides, int B, int S, int H,
                    int P, int N, int Q, int device, void* stream) {
  if (!valid_shape(B, S, H, P, N, Q, device) || strides[3] != 1 ||
      strides[0] % 4 || strides[1] % 4 || strides[2] % 4 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int sms = sm_count(device);
  if (sms < 1) return cudaErrorInvalidDevice;
  const Plan pl = plan(B, S, H, N, Q, sms);
  Params p;
  p.x = static_cast<const float*>(x);
  p.a = static_cast<const float*>(a);
  p.bm = static_cast<const float*>(bm);
  p.cm = static_cast<const float*>(cm);
  p.y = static_cast<float*>(y);
  p.state = static_cast<float*>(state);
  p.decay = static_cast<float*>(decay);
  p.cum = static_cast<float*>(cum);
  for (int i = 0; i < 4; ++i) p.sx[i] = strides[i];
  for (int i = 0; i < 3; ++i) {
    p.sa[i] = strides[4 + i];
    p.sb[i] = strides[7 + i];
    p.sc[i] = strides[10 + i];
  }
  p.S = S;
  p.H = H;
  p.N = N;
  p.Q = Q;
  p.nc = S / Q;
  p.heads = pl.heads;
  p.groups = pl.groups;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      P == 64   ? launch_p<64>(p, B, pl.nt, pl.slices, device, s)
      : P == 32 ? launch_p<32>(p, B, pl.nt, pl.slices, device, s)
                : launch_p<16>(p, B, pl.nt, pl.slices, device, s);
  return static_cast<int>(err);
}

// How repro_ssd_chunk cuts a call of this shape on ``device``: out[0]
// heads per block, out[1] head groups, out[2] blocks per chunk along
// d_state, out[3] state columns per block.  Returns a CUDA error code.
int repro_ssd_chunk_plan(int B, int S, int H, int P, int N, int Q,
                         int device, int* out) {
  if (!valid_shape(B, S, H, P, N, Q, device)) return cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int sms = sm_count(device);
  if (sms < 1) return cudaErrorInvalidDevice;
  const Plan pl = plan(B, S, H, N, Q, sms);
  out[0] = pl.heads;
  out[1] = pl.groups;
  out[2] = pl.slices;
  out[3] = pl.nt;
  return 0;
}

}  // extern "C"
