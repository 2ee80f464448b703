// Backward of the Mamba2 SSD intra-chunk kernel for Hopper, CUDA C++ for
// sm_90a, on the tensor cores (3xTF32 wgmma).
//
// The JAX package has no backward kernel for its Pallas _ssd_chunk_kernel
// (src/repro/kernels/ssd_scan.py:23): its model differentiates the plain
// chunked scan with jax.grad.  This kernel is the gradient of the port's
// forward kernel (ssd_chunk.cu), held to jax.vjp of the JAX package's
// ref.ssd_chunk and to the port's written-out plain backward
// (kernels/ref.py: ssd_chunks_bwd).  Per chunk of Q rows of one head of
// one sequence, with x already scaled by dt, a = dt * A the log-decays,
// cum = cumsum(a), L[i, j] = exp(cum_i - cum_j) for i >= j (else 0),
// M = (C B^T) o L, w_j = exp(cum_Q - cum_j), and the upstream gradients gy
// (of y_intra = M x), gS (of the state (x o w)^T B) and gcum (of cum), any
// of them absent (zero):
//
//   dM   = gy x^T                 (zero above the diagonal, through L)
//   dx   = M^T gy + w o (B gS^T)
//   dC   = (dM o L) B
//   dB   = (dM o L)^T C + (x o w) gS
//   dcum = rowsum(R) - colsum(R) - T + [j = Q - 1] sum(T) + gcum,
//          R = dM o M,  T_j = w_j sum_p x_jp (B gS^T)_jp
//   da   = the reverse cumsum of dcum
//
// The forward's decay = exp(cum_Q) has no gradient path: the host side
// (kernels/ops.py) reads cum instead.  B and C are shared by every head
// (one group), so C B^T is the same for every head, and dB and dC are sums
// over the heads: dC = D B and dB = D^T C + E with D = sum_h dM_h o L_h and
// E = sum_h (x_h o w_h) gS_h, two Q x Q x N products after the sums.
//
// Bound on an H100 SXM.  At mamba2-1.3b's training shape on the server (8
// sequences of 256 tokens, 64 heads, P 64, N 128, Q 128) the function
// moves 140 MB (x, gy, the states' gradient and dx 33.5 MB each): 0.042 ms
// at 3.35 TB/s.  Its 6.6 GFLOP (C B^T, D B and D^T C once per chunk over
// the causal half, per head gy x^T and M^T gy over the causal half, B gS^T
// and (x o w) gS) take 0.040 ms as 3xTF32 at 495 TFLOP/s and 0.099 ms as
// f32 FMA at 67 TFLOP/s.  So every product runs on the tensor cores, as
// 3xTF32 (tf32_wgmma.cuh: one TF32 pass errs 10x past the gates), and what
// the heads share is computed once per block of heads:
//
//  * Grid.  One block of two warpgroups (256 threads) per (chunk, group of
//    HG heads, batch), and per 128 state columns when N > 128.  The
//    launcher picks HG as the forward does, fewest waves times (HG + 1):
//    at 8 x 256 tokens HG 8 on the server's 64 heads (128 blocks), HG 2 on
//    the towers' 16 (128 blocks).  repro_ssd_chunk_bwd_plan reports it.
//  * Orientation.  The Q x Q terms are held transposed, rows j and columns
//    i (nonzero for i >= j): warpgroup 0 holds rows 0..63 and columns
//    0..127, warpgroup 1 rows 64..127 and columns 64..127.  Then M^T, as
//    wgmma's A operand of dx = M^T gy, and D^T, as the A operand of
//    D^T C, come from the accumulator layout with its columns (2t, 2t + 1)
//    renamed A columns (t, t + 4), as the forward does with S: every tile
//    with the chunk's rows along K that such an A meets (gy^T, C^T) stores
//    row i = 8 s + 2 e + h at position 8 s + e + 4 h.  No Q x Q matrix is
//    transposed per head.
//  * Per block: C B^T once, as G^T = B C^T (A: B's rows from device
//    memory, split in registers; B operand: C in slices of 64 state
//    columns, K-major), kept in shared memory at each thread's own
//    fragment slots (element e of thread l at word 128 e + l: no bank
//    conflicts).  Then per head, in order:
//     - cum and w by warp 0; gy (rows i, K = p) split into a K-major tile,
//       x staged in shared memory;
//     - phase A: dM_h^T = x_h gy_h^T over the warpgroup's columns, 64 at a
//       time (A: x split in registers), each half followed by the
//       elementwise pass on the CUDA cores, f32: L masked before the
//       exponential, D^T += dM^T o L^T into D^T's fragment slots (heads in
//       order), and R^T = dM^T o (G^T o L^T) with its row sums (colsum R:
//       two shuffles over the 4 lanes of a row) and column sums (rowsum R:
//       three shuffles over the 8 row groups of a warp, then the 8 warps'
//       partials summed in order through shared memory);
//     - phase B: dx_h = M_h^T gy_h + (w o B) gS_h^T in one accumulator
//       (A: M^T from G^T's slots times L^T, then B's rows staged in shared
//       memory, swizzled, times w; B operands: gy^T, rows p and K = i
//       renamed, and gS, rows p and K = n);
//     - dx stored, T_j = sum_p x_jp dx_jp - colsum(R)_j (= w_j sum_p x_jp
//       (B gS^T)_jp, since colsum(R)_j = sum_p x_jp (M^T gy)_jp), and da,
//       the reverse cumsum of dcum, by warp 0.
//    A second pass over the heads accumulates E += (x_h o w_h) gS_h (A: x
//    staged again, times w; B: gS^T, rows n and K = p).  Then dB_g = E +
//    D^T C (A: D^T from its slots, renamed; B: C^T, rows n, K = i) and
//    dC_g^T = B^T D (A: B^T from device memory; B: D, rows i and K = j,
//    stored once from D^T's slots, zeros above the diagonal written by
//    warpgroup 1), written into the workspace (2, B, S, groups, N).
//    ssd_chunk_bwd_reduce_kernel sums the groups in order.  Blocks of a
//    later d_state slice do only what depends on their state columns
//    (dM^T, D^T, E, dB and dC); the first slice's do the rest.
//  * Registers.  G^T, D and E each live across the heads, 64 registers a
//    thread per warpgroup at Q 128 (E at N 128), and not all fit in 255
//    with a head's own accumulators: G^T and D^T are kept in shared memory
//    at each thread's fragment slots, and E is accumulated in its own pass
//    over the heads, where nothing else is live; held through the first
//    pass it made every instantiation spill.  dM^T lives 32 registers at
//    a time (a half of the columns), dx P / 2; every product's A fragments
//    are double-buffered one k-step at a time (8 registers a buffer), in
//    a loop that is not unrolled (kloop).  The thread's coordinates are
//    re-derived from an opaque read of its index at every head, and every
//    tile-building loop starts from one: otherwise the compiler hoists the
//    masks and offsets of every unrolled pass out of the head loop into
//    registers that live through the kernel, and spills.  ptxas fits all
//    twelve instantiations without spilling (188-255 registers) and
//    issues the wgmmas unserialized (no C7511, C7512, C7515 or C7520).
//  * Shared memory: G^T and D^T slots (48 KB each: warpgroup 0 64 x 128
//    values, warpgroup 1 32 x 128), one 128 KB region that holds in turn
//    the C slices (for G^T), phase A's gy tile (hi and lo, 64 KB at P 64)
//    with the R column partials (4 KB) and x (34 KB), phase B's tiles (gy^T
//    and gS, 64 KB each at P 64, N 128) and B (64 KB, in gy^T's words once
//    M^T gy is done, or past gS where it fits), the E pass's x and gS^T,
//    and, after the heads, C^T then the D tile (each 128 KB hi and lo),
//    and cum, w, rowsum R, colsum R and T: 226.5 KB, one block per SM.
//  * Control flow around the products is uniform, and each branch holds
//    whole fence-issue-commit-wait sequences: the warpgroup index is read
//    from lane 0, the k-step counts are fixed per warpgroup (16 and 8 over
//    the chunk's rows), whatever Q; where the two warpgroups run different
//    code between products, they meet at barrier.sync without .aligned.
//    Otherwise ptxas serializes every wgmma (its notes C7515 and C7520).
//    A k-step past the diagonal or past Q multiplies zeros.
//  * Edges.  Rows past Q are zero in every operand and never stored; the
//    upper triangle is masked before exp, so no inf * 0 makes a NaN,
//    however negative a is.  A last head group may be partly filled.
//  * Determinism.  Every sum runs in a fixed order (the heads, the
//    shuffle trees, the warps' partials, the groups in the reduce pass);
//    no float atomics: two launches give the same bits.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tf32_wgmma.cuh"

namespace {

constexpr int QMAX = 128;       // chunk rows a block takes
constexpr int WG_ROWS = 64;     // rows per warpgroup: wgmma's M
constexpr int THREADS = 256;    // two warpgroups
constexpr int NS = 64;          // d_state columns per staged C slice
constexpr int NT_MAX = 128;     // state columns per block
constexpr int WGS = 128;        // threads per warpgroup: a slot's stride
// one Q x Q slot array (G^T or D^T): 64 values of each thread of
// warpgroup 0, then 32 of each of warpgroup 1
constexpr int SLOTS = (64 + 32) * WGS;
constexpr int REGION = 2 * QMAX * QMAX;  // the largest tile, hi and lo
constexpr int REDUCE_THREADS = 256;
constexpr long long REDUCE_MAX_BLOCKS = 1 << 20;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;
// the SBO of tiles with the chunk's rows along K (gy^T, C^T, D)
constexpr uint32_t SBO_J = (QMAX / 4) * CORE * 4;

struct BwdParams {
  const float* x;       // (B, S, H, P), 16-byte rows
  const float* a;       // (B, S, H), strided
  const float* bm;      // (B, S, N), rows strided
  const float* cm;      // (B, S, N), rows strided
  const float* gy;      // (B, S, H, P) contiguous, 16-byte aligned, or null
  const float* gstate;  // (B, nc, H, P, N) likewise, or null
  const float* gcum;    // (B, S, H) contiguous, or null
  float* dx;            // (B, S, H, P), contiguous
  float* da;            // (B, S, H), contiguous
  float* work;          // (2, B, S, groups, N): dB per group, dC per group
  float* dbm;           // (B, S, N), contiguous: the reduce kernel's
  float* dcm;           // (B, S, N), contiguous
  long long sx[4], sa[3], sb[3], sc[3];  // element strides; x's, B's and
                                         // C's last are 1
  int B, S, H, N, Q, nc;
  int heads;   // heads per block (HG)
  int groups;  // head groups: ceil(H / heads)
};

// A block's shared memory, in 4-byte words: the G^T and D^T slots, the
// region of tiles, then five vectors of QMAX.
template <int P, int NT>
struct BwdSmem {
  static constexpr int GY = QMAX * P;  // gy or gy^T, hi or lo
  static constexpr int GS = NT * P;    // gS^T or gS, hi or lo
  static constexpr int NSG = NT < NS ? NT : NS;  // columns per C slice
  static constexpr int XS = P + 4;  // row stride of the staged x, in words
  static constexpr int PART = 2 * GY;  // the R partials, past the gy tile
  static constexpr int XA = PART + 8 * QMAX;  // x in phase A, past them
  // B's chunk in phase B: in gy^T's words where it fits, else past gS
  static constexpr int BS = QMAX * NT <= 2 * GY ? 0 : 2 * GY + 2 * GS;
  static constexpr int BYTES = (2 * SLOTS + REGION + 5 * QMAX) * 4;
  static_assert(NT <= NT_MAX && NT % 16 == 0, "state columns per block");
  static_assert(2 * (GY + GS) <= REGION, "phase A's and B's tiles fit");
  static_assert(2 * QMAX * NSG <= REGION && 2 * NT * QMAX <= REGION &&
                    XA + QMAX * XS <= REGION && 2 * GY + 2 * GS <= REGION &&
                    QMAX * XS <= 2 * GY && BS + QMAX * NT <= REGION,
                "the C slices, C^T, phase A's and the E pass's tiles with "
                "the staged x, and the staged B (in gy^T's place) fit");
  static_assert(BYTES <= 232448, "an H100 block has 227 KB");
};

// k-steps 0 .. K - 1 (K even) of one product, two a loop iteration:
// load(kk) gives k-step kk's four A values (a0 .. a3 of the thread's
// fragment), which are split into one of two fragment buffers (hi and lo)
// while the previous k-step's wgmmas run.  The loop is not unrolled
// further, so that the compiler does not hoist every k-step's loads over
// the whole product.
template <int K, class Load, class Issue>
__device__ __forceinline__ void kloop(Load&& load, Issue&& issue) {
  static_assert(K % 2 == 0, "k-steps in pairs");
  uint32_t hi[2][4], lo[2][4];
#pragma unroll 1
  for (int kk = 0; kk < K; kk += 2) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      wgmma_wait<1>();  // k-step kk + s - 2 is done with buffer s
      const float4 a = load(kk + s);
      split(a.x, hi[s][0], lo[s][0]);
      split(a.y, hi[s][1], lo[s][1]);
      split(a.z, hi[s][2], lo[s][2]);
      split(a.w, hi[s][3], lo[s][3]);
      wgmma_fence();
      issue(kk + s, hi[s], lo[s]);
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
}

// one 3xTF32 k-step: a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms first
template <int N>
__device__ __forceinline__ void wgmma3(float (&d)[N / 2],
                                       const uint32_t (&hi)[4],
                                       const uint32_t (&lo)[4],
                                       const uint32_t* b_hi,
                                       const uint32_t* b_lo, uint32_t sbo) {
  const uint64_t dh = descriptor(b_hi, sbo);
  const uint64_t dl = descriptor(b_lo, sbo);
  wgmma<N>(d, lo, dh, 1);
  wgmma<N>(d, hi, dl, 1);
  wgmma<N>(d, hi, dh, 1);
}

// no load or store of shared or device memory moves across this point: the
// unrolled passes over a thread's fragment slots would otherwise hoist all
// their loads at once, past the 255 registers
__device__ __forceinline__ void compiler_fence() {
  asm volatile("" ::: "memory");
}

// the thread's index, read opaquely: the offsets a tile-building loop
// derives from it are then computed in that loop and not hoisted out of
// every loop around it into registers that live through the kernel
__device__ __forceinline__ int opaque_tid() {
  int tid;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
  return tid;
}

// a barrier of the whole block that the two warpgroups may reach from
// different code (their functions of their own columns): barrier.sync
// without .aligned
__device__ __forceinline__ void cta_sync() {
  asm volatile("barrier.sync 0;\n" ::: "memory");
}

template <int P, int NT>
__global__ void __launch_bounds__(THREADS, 1)
    ssd_chunk_bwd_kernel(const BwdParams p) {
  using L = BwdSmem<P, NT>;
  constexpr int NSG = L::NSG;
  constexpr uint32_t SBO_P = (P / 4) * CORE * 4;    // tiles with K = p
  constexpr uint32_t SBO_G = (NSG / 4) * CORE * 4;  // C slices
  constexpr uint32_t SBO_N = (NT / 4) * CORE * 4;   // gS (K = n)
  extern __shared__ __align__(128) uint32_t smem[];
  float* gt_s = reinterpret_cast<float*>(smem);  // G^T slots
  float* dt_s = gt_s + SLOTS;                    // D^T slots
  uint32_t* region = smem + 2 * SLOTS;
  // phase A: gy (rows i, K = p); the E pass: gS^T (rows n, K = p), past
  // it; phase B: gy^T (rows p, K = i renamed) and gS (rows p, K = n), at
  // the same words
  uint32_t* gy_hi = region;
  uint32_t* gy_lo = gy_hi + L::GY;
  uint32_t* gs_hi = gy_lo + L::GY;
  uint32_t* gs_lo = gs_hi + L::GS;
  uint32_t* big_hi = region;  // C slices, C^T, the D tile
  // (8, QMAX): R's column partials, past phase A's gy tile
  float* part = reinterpret_cast<float*>(region + L::PART);
  // x_h staged (rows at stride XS, zero past Q): past the partials in
  // phase A, at the region's start in the E pass
  float* xs_a = reinterpret_cast<float*>(region + L::XA);
  float* xs_e = reinterpret_cast<float*>(region);
  // B's columns n0 .. n0 + NT of a chunk in phase B: value (j, n) at word
  // j NT + (n ^ swizzle(j)), which keeps a fragment's loads free of bank
  // conflicts
  float* bs = reinterpret_cast<float*>(region + L::BS);
  auto swizzle = [](int j) { return (4 * (j & 7)) & (NT - 1); };
  float* cum_s = reinterpret_cast<float*>(region + REGION);  // past Q, cum_Q
  float* w_s = cum_s + QMAX;    // exp(cum_Q - cum_j); past Q, 0
  float* rs_s = w_s + QMAX;     // rowsum(R)_i
  float* cs_s = rs_s + QMAX;    // colsum(R)_j
  float* t_s = cs_s + QMAX;     // T_j

  const int c = blockIdx.x;
  const int group = blockIdx.y % p.groups;
  const int slice = blockIdx.y / p.groups;
  const int b = blockIdx.z;
  const int h_end = min(p.H, (group + 1) * p.heads);
  const int n_base = slice * NT;  // the block's first state column
  const bool first = slice == 0;  // computes dx, da and C B^T
  const int Q = p.Q;
  const int N = p.N;
  const long long s0 = static_cast<long long>(c) * Q;
  // The thread's coordinates, derived anew from an opaque read of its
  // index at the start of every head and phase: the compiler then keeps
  // the masks and offsets it derives from them (hundreds, over the
  // unrolled passes) inside the head instead of hoisting them all out of
  // the loop, which needs more than 255 registers.
  int tid, lane, g, t, wg, warp, row0;
  bool ok0, ok1;
  float *gt_t, *dt_t;
  auto locate = [&] {
    tid = opaque_tid();
    lane = tid % 32;
    g = lane / 4;  // the fragment's row group
    t = lane % 4;  // its column within the group
    // the warpgroup, read from lane 0 so that ptxas sees it is the same
    // in every lane: its branches then hold whole wgmma sequences
    wg = __shfl_sync(FULL, tid / 128, 0);
    warp = (tid / 32) % 4;  // within the warpgroup
    // this thread's rows j of the Q x Q terms, dx and E: row0, row0 + 8
    row0 = wg * WG_ROWS + warp * 16 + g;
    ok0 = row0 < Q;
    ok1 = row0 + 8 < Q;
    // this thread's fragment slots: element e at [e * WGS]
    gt_t = gt_s + wg * 64 * WGS + tid % WGS;
    dt_t = dt_s + wg * 64 * WGS + tid % WGS;
  };
  locate();
  const float ninf = __int_as_float(0xff800000);

  // x, B and C have unit last strides
  const float* xb = p.x + b * p.sx[0] + s0 * p.sx[1];
  const float* ab = p.a + b * p.sa[0] + s0 * p.sa[1];
  const float* bb = p.bm + b * p.sb[0] + s0 * p.sb[1];
  const float* cb = p.cm + b * p.sc[0] + s0 * p.sc[1];
  // row strides and offsets within a chunk fit 32 bits (the entry point
  // checks)
  const int sx1 = static_cast<int>(p.sx[1]);
  const int sb1 = static_cast<int>(p.sb[1]);
  const int sc1 = static_cast<int>(p.sc[1]);
  // B's A fragment at columns n and n + 4 of rows row0 and row0 + 8 (zero
  // past Q, and past N when ``in`` is false)
  auto b_fragment = [&](int n, bool in, float scale0, float scale1) {
    const float* b0 = bb + row0 * sb1;
    const float* b1 = b0 + 8 * sb1;
    return make_float4(ok0 && in ? b0[n] * scale0 : 0.f,
                       ok1 && in ? b1[n] * scale1 : 0.f,
                       ok0 && in ? b0[n + 4] * scale0 : 0.f,
                       ok1 && in ? b1[n + 4] * scale1 : 0.f);
  };
  // x_h staged in shared memory: rows i < Q at stride XS (zero past Q)
  auto stage_x = [&](float* xs, int h) {
    const float* xh = xb + h * p.sx[2];
#pragma unroll 4
    for (int idx = opaque_tid(); idx < QMAX * P / 4; idx += THREADS) {
      const int i = idx / (P / 4);
      const int col = 4 * (idx % (P / 4));
      *reinterpret_cast<float4*>(xs + i * L::XS + col) =
          i < Q ? *reinterpret_cast<const float4*>(xh + i * sx1 + col)
                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  // x_h's A fragment of k-step kk from the staged tile: a0 (row0, p), a1
  // (row0 + 8, p), a2 (row0, p + 4), a3 (row0 + 8, p + 4), p = 8 kk + t,
  // each row times its scale
  auto x_fragment = [&](const float* xs, int kk, float scale0,
                        float scale1) {
    const float* x0 = xs + row0 * L::XS + 8 * kk + t;
    const float* x1 = x0 + 8 * L::XS;
    return make_float4(x0[0] * scale0, x1[0] * scale1, x0[4] * scale0,
                       x1[4] * scale1);
  };
  // row (b, s0) of the contiguous (B, S, ...) tensors
  const long long rowb = static_cast<long long>(b) * p.S + s0;
  const int hp = p.H * P;

  for (int e = 0; e < 64; ++e)
    if (wg == 0 || e < 32) dt_t[e * WGS] = 0.f;

  // G^T = B C^T, once for the block's heads, into the G^T slots.  The
  // C slices: thread idx takes core matrix idx / 8, its row idx % 8: row
  // i, columns n0 + 4 kb .. n0 + 4 kb + 3, at word 4 idx
  if (first) {
    float gacc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) gacc[i] = 0.f;
    auto g_product = [&](auto columns, int n0) {  // columns i from QMAX - NC
      constexpr int NC = decltype(columns)::value;
      float(&d)[NC / 2] = reinterpret_cast<float(&)[NC / 2]>(gacc);
      const uint32_t* th = big_hi + (QMAX - NC) * NSG;
      const uint32_t* tl = th + QMAX * NSG;
      kloop<NSG / 8>(
          [&](int kk) {
            return b_fragment(n0 + 8 * kk + t, n0 + 8 * kk < N, 1.f, 1.f);
          },
          [&](int kk, const uint32_t(&hi)[4], const uint32_t(&lo)[4]) {
            wgmma3<NC>(d, hi, lo, th + kk * 2 * CORE, tl + kk * 2 * CORE,
                       SBO_G);
          });
    };
    for (int n0 = 0; n0 < N; n0 += NSG) {
      __syncthreads();  // the previous slice's tile is no longer read
#pragma unroll 4
      for (int idx = opaque_tid(); idx < QMAX * NSG / 4; idx += THREADS) {
        const int kb = (idx >> 3) % (NSG / 4);
        const int i = 8 * ((idx >> 3) / (NSG / 4)) + (idx & 7);
        const bool ok = i < Q && n0 + 4 * kb < N;
        const float* src = cb + i * sc1 + n0 + 4 * kb;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = ok ? src[e] : 0.f;
        store_operand<true>(big_hi, big_hi + QMAX * NSG, 4 * idx,
                            make_float4(v[0], v[1], v[2], v[3]));
      }
      fence_proxy_async();
      __syncthreads();
      if (wg == 0)
        g_product(std::integral_constant<int, 128>(), n0);
      else
        g_product(std::integral_constant<int, 64>(), n0);
    }
#pragma unroll
    for (int e = 0; e < 64; ++e)
      if (wg == 0 || e < 32) gt_t[e * WGS] = gacc[e];
  }

  // cum and w of head h into cum_s and w_s, by warp 0: lane l scans
  // a[4l .. 4l + 3], then the lanes' totals
  auto scan = [&](int h) {
    if (tid >= 32) return;
    const float* ah = ab + h * p.sa[2];
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * lane + e;
      v[e] = j < Q ? ah[j * p.sa[1]] : 0.f;
    }
    v[1] += v[0];
    v[2] += v[1];
    v[3] += v[2];
    float run = v[3];
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const float up = __shfl_up_sync(FULL, run, d);
      if (lane >= d) run += up;
    }
    const float off = run - v[3];
    const float last = __shfl_sync(FULL, run, 31);  // cum_Q
    float wv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] += off;
      wv[e] = 4 * lane + e < Q ? expf(last - v[e]) : 0.f;
    }
    reinterpret_cast<float4*>(cum_s)[lane] =
        make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(w_s)[lane] =
        make_float4(wv[0], wv[1], wv[2], wv[3]);
  };

  for (int h = group * p.heads; h < h_end; ++h) {
    __syncthreads();  // the previous head (or G^T) is done with the region
                      // and the vectors
    locate();
    const float* xh = xb + h * p.sx[2];
    const float* x0 = xh + row0 * sx1;  // x_h's rows row0, row0 + 8
    const float* x1 = x0 + 8 * sx1;
    // gy_h row i at gyh + i * H * P; gS_h (p, n) at gsh + p * N + n
    const float* gyh = p.gy ? p.gy + (rowb * p.H + h) * P : nullptr;
    const float* gsh =
        p.gstate ? p.gstate + ((static_cast<long long>(b) * p.nc + c) * p.H +
                               h) * static_cast<long long>(P) * N
                 : nullptr;

    scan(h);

    // phase A's tile, gy (rows i, K = p): as the C slices
#pragma unroll 4
    for (int idx = opaque_tid(); idx < QMAX * P / 4; idx += THREADS) {
      const int kb = (idx >> 3) % (P / 4);
      const int i = 8 * ((idx >> 3) / (P / 4)) + (idx & 7);
      const float4 v = gyh && i < Q
                           ? *reinterpret_cast<const float4*>(
                                 gyh + i * hp + 4 * kb)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      store_operand<true>(gy_hi, gy_lo, 4 * idx, v);
    }
    stage_x(xs_a, h);
    fence_proxy_async();
    __syncthreads();  // the tile, x, cum and w are complete

    // phase A: dM^T = x gy^T over the warpgroup's columns i, 64 at a time,
    // each half followed by its elementwise pass.  x's A fragment of k-step
    // kk: a0 (row0, p), a1 (row0 + 8, p), a2
    // (row0, p + 4), a3 (row0 + 8, p + 4), p = 8 kk + t, each row times its
    // scale.  Element 4 q + 2 r + e of a half from column C1 is row row0 +
    // 8 r, column i = C1 + 8 q + 2 t + e: element 4 (q + (C1 - C0) / 8) +
    // 2 r + e of the warpgroup's fragment slots.  One function of the
    // warpgroup's columns, so that dM^T lives in it alone
    const float w0 = w_s[row0], w1 = w_s[row0 + 8];
    const float cj0 = cum_s[row0], cj1 = cum_s[row0 + 8];
    auto phase_a = [&](auto columns) {
      constexpr int NC = decltype(columns)::value;
      constexpr int C0 = QMAX - NC;
      float rsum[2] = {0.f, 0.f};
      float* mine = part + (wg * 4 + warp) * QMAX;
#pragma unroll
      for (int C1 = C0; C1 < QMAX; C1 += 64) {
        float dm[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) dm[i] = 0.f;
        kloop<P / 8>(
            [&](int kk) { return x_fragment(xs_a, kk, 1.f, 1.f); },
            [&](int kk, const uint32_t(&hi)[4], const uint32_t(&lo)[4]) {
              wgmma3<64>(dm, hi, lo, gy_hi + C1 * P + kk * 2 * CORE,
                         gy_lo + C1 * P + kk * 2 * CORE, SBO_P);
            });
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int i0 = C1 + 8 * q + 2 * t;
          const float2 ci = *reinterpret_cast<const float2*>(cum_s + i0);
          float csum[2] = {0.f, 0.f};  // columns i0, i0 + 1 over both rows
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = i0 + e;
            const float cv = e ? ci.y : ci.x;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int el = 4 * q + 2 * r + e;
              const int slot = (4 * ((C1 - C0) / 8) + el) * WGS;
              const int j = row0 + 8 * r;
              const float lt =
                  __expf(j <= i && i < Q ? cv - (r ? cj1 : cj0) : ninf);
              dt_t[slot] += dm[el] * lt;
              const float rr = dm[el] * (gt_t[slot] * lt);
              rsum[r] += rr;
              csum[e] += rr;
            }
          }
          if (first) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float v = csum[e];
              v += __shfl_xor_sync(FULL, v, 4);
              v += __shfl_xor_sync(FULL, v, 8);
              v += __shfl_xor_sync(FULL, v, 16);
              if (g == 0) mine[i0 + e] = v;
            }
          }
          compiler_fence();
        }
      }
      if (first) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float v = rsum[r];
          v += __shfl_xor_sync(FULL, v, 1);
          v += __shfl_xor_sync(FULL, v, 2);
          if (t == 0) cs_s[row0 + 8 * r] = v;
        }
      }
    };
    if (wg == 0)
      phase_a(std::integral_constant<int, 128>());
    else
      phase_a(std::integral_constant<int, 64>());
    if (!first) continue;  // a later slice: dM^T, D^T and E only
    __syncthreads();  // the column partials are written
    if (tid < QMAX) {  // rowsum(R)_i: the eight warps' partials in order
      float v = 0.f;
#pragma unroll
      for (int w8 = 0; w8 < 8; ++w8)
        if (w8 < 4 || tid >= QMAX - 64) v += part[w8 * QMAX + tid];
      rs_s[tid] = v;
    }
    __syncthreads();  // the partials are consumed: the region is free

    // phase B: dx = M^T gy + (w o B) gS^T in one accumulator, gS in chunks
    // of NT state columns (one when N <= 128), then dx stored and T_j =
    // w_j sum_p x_jp (B gS^T)_jp = sum_p x_jp dx_jp - colsum(R)_j (since
    // colsum(R)_j = sum_p x_jp (M^T gy)_jp).  M^T's A fragment of k-step
    // C0 / 8 + q: a0 (row0, i0), a1 (row0 + 8, i0), a2 (row0, i0 + 1), a3
    // (row0 + 8, i0 + 1), i0 = C0 + 8 q + 2 t: elements 4 q, 4 q + 2,
    // 4 q + 1 and 4 q + 3 of G^T times L^T; w o B's A fragment of k-step
    // kk at columns n0 + 8 kk + t and + 4.  One function of the
    // warpgroup's columns, as phase A
    auto phase_b = [&](auto columns) {
      constexpr int NC = decltype(columns)::value;
      constexpr int C0 = QMAX - NC;
      float dxacc[P / 2];
#pragma unroll
      for (int i = 0; i < P / 2; ++i) dxacc[i] = 0.f;
      for (int n0 = 0; n0 < N; n0 += NT) {
        if (n0) cta_sync();  // every warp is done with the last chunk
        if (!n0) {
          // gy^T: thread idx takes p = idx % P and K positions 4 kb ..
          // 4 kb + 3 (rows 8 (kb / 2) + kb % 2 + 2e); a warp reads
          // neighbouring p of a row
#pragma unroll 4
          for (int idx = opaque_tid(); idx < P * QMAX / 4; idx += THREADS) {
            const int pp = idx % P;
            const int kb = idx / P;
            const int i = 8 * (kb >> 1) + (kb & 1);
            float v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              v[e] = gyh && i + 2 * e < Q ? gyh[(i + 2 * e) * hp + pp] : 0.f;
            store_operand<true>(gy_hi, gy_lo, core_index(pp, 4 * kb, QMAX),
                                make_float4(v[0], v[1], v[2], v[3]));
          }
        }
        // gS's columns n0 .. n0 + NT: as the C slices
#pragma unroll 4
        for (int idx = opaque_tid(); idx < P * NT / 4; idx += THREADS) {
          const int kb = (idx >> 3) % (NT / 4);
          const int pp = 8 * ((idx >> 3) / (NT / 4)) + (idx & 7);
          const int n = n0 + 4 * kb;
          const float4 v = gsh && n < N
                               ? *reinterpret_cast<const float4*>(
                                     gsh + pp * N + n)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
          store_operand<true>(gs_hi, gs_lo, 4 * idx, v);
        }
        fence_proxy_async();
        cta_sync();  // the tiles are complete
        if (!n0)
          kloop<NC / 8>(
              [&](int q) {
                const int i0 = C0 + 8 * q + 2 * t;
                const float2 ci =
                    *reinterpret_cast<const float2*>(cum_s + i0);
                const bool in0 = i0 < Q, in1 = i0 + 1 < Q;
                const float* gq = gt_t + 4 * q * WGS;
                return make_float4(
                    gq[0] * __expf(row0 <= i0 && in0 ? ci.x - cj0 : ninf),
                    gq[2 * WGS] *
                        __expf(row0 + 8 <= i0 && in0 ? ci.x - cj1 : ninf),
                    gq[WGS] *
                        __expf(row0 <= i0 + 1 && in1 ? ci.y - cj0 : ninf),
                    gq[3 * WGS] * __expf(row0 + 8 <= i0 + 1 && in1
                                             ? ci.y - cj1
                                             : ninf));
              },
              [&](int q, const uint32_t(&hi)[4], const uint32_t(&lo)[4]) {
                const int kk = C0 / 8 + q;
                wgmma3<P>(dxacc, hi, lo, gy_hi + kk * 2 * CORE,
                          gy_lo + kk * 2 * CORE, SBO_J);
              });
        cta_sync();  // M^T gy (or the last chunk) is done with gy^T's words
#pragma unroll 4
        for (int idx = opaque_tid(); idx < QMAX * NT / 4; idx += THREADS) {
          const int j = idx / (NT / 4);
          const int nn = 4 * (idx % (NT / 4));
          const bool ok = j < Q && n0 + nn < N;
          const float* src = bb + j * sb1 + n0 + nn;
          *reinterpret_cast<float4*>(bs + j * NT + (nn ^ swizzle(j))) =
              make_float4(ok ? src[0] : 0.f, ok ? src[1] : 0.f,
                          ok ? src[2] : 0.f, ok ? src[3] : 0.f);
        }
        cta_sync();  // B's chunk is staged
        kloop<NT / 8>(
            [&](int kk) {
              const int n = 8 * kk + t;
              const float* b0 = bs + row0 * NT;
              const float* b1 = b0 + 8 * NT;
              const int sw = swizzle(row0);  // row0 + 8 swizzles alike
              return make_float4(b0[n ^ sw] * w0, b1[n ^ sw] * w1,
                                 b0[(n + 4) ^ sw] * w0,
                                 b1[(n + 4) ^ sw] * w1);
            },
            [&](int kk, const uint32_t(&hi)[4], const uint32_t(&lo)[4]) {
              wgmma3<P>(dxacc, hi, lo, gs_hi + kk * 2 * CORE,
                        gs_lo + kk * 2 * CORE, SBO_N);
            });
      }
      // element 4 q + 2 r + e of dx: row row0 + 8 r, column 8 q + 2 t + e
      float ur[2] = {0.f, 0.f};
      float* dx0 = p.dx + ((rowb + row0) * p.H + h) * P + 2 * t;
      float* dx1 = dx0 + 8 * hp;
#pragma unroll
      for (int q = 0; q < P / 8; ++q) {
        const int pp = 8 * q + 2 * t;
        if (ok0) {
          const float2 xv = *reinterpret_cast<const float2*>(x0 + pp);
          ur[0] += xv.x * dxacc[4 * q] + xv.y * dxacc[4 * q + 1];
          *reinterpret_cast<float2*>(dx0 + 8 * q) =
              make_float2(dxacc[4 * q], dxacc[4 * q + 1]);
        }
        if (ok1) {
          const float2 xv = *reinterpret_cast<const float2*>(x1 + pp);
          ur[1] += xv.x * dxacc[4 * q + 2] + xv.y * dxacc[4 * q + 3];
          *reinterpret_cast<float2*>(dx1 + 8 * q) =
              make_float2(dxacc[4 * q + 2], dxacc[4 * q + 3]);
        }
        compiler_fence();
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = ur[r];
        v += __shfl_xor_sync(FULL, v, 1);
        v += __shfl_xor_sync(FULL, v, 2);
        if (t == 0) t_s[row0 + 8 * r] = v - cs_s[row0 + 8 * r];
      }
    };
    if (wg == 0)
      phase_b(std::integral_constant<int, 128>());
    else
      phase_b(std::integral_constant<int, 64>());
    __syncthreads();  // T, rowsum R and colsum R are complete

    // dcum = rowsum(R) - colsum(R) - T + [j = Q - 1] sum(T) + gcum; da =
    // its reverse cumsum, by warp 0
    if (tid < 32) {
      const long long r0 = (rowb + 4 * lane) * p.H + h;  // row 4 lane of da
      const float4 t4 = reinterpret_cast<const float4*>(t_s)[lane];
      const float4 r4 = reinterpret_cast<const float4*>(rs_s)[lane];
      const float4 c4 = reinterpret_cast<const float4*>(cs_s)[lane];
      const float tv[4] = {t4.x, t4.y, t4.z, t4.w};
      const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = 4 * lane + e < Q;
        v[e] = rv[e] - cv[e] - tv[e] +
               (in && p.gcum ? p.gcum[r0 + e * p.H] : 0.f);
      }
      float total = (tv[0] + tv[1]) + (tv[2] + tv[3]);
#pragma unroll
      for (int d = 16; d >= 1; d /= 2)
        total += __shfl_xor_sync(FULL, total, d);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * lane + e == Q - 1) v[e] += total;
      v[2] += v[3];
      v[1] += v[2];
      v[0] += v[1];
      float run = v[0];  // the sum over this lane's and the later lanes' rows
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const float down = __shfl_down_sync(FULL, run, d);
        if (lane + d < 32) run += down;
      }
      const float off = run - v[0];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * lane + e < Q) p.da[r0 + e * p.H] = v[e] + off;
    }
  }

  // E = sum over the group's heads of (x_h o w_h) gS_h (rows j, this
  // block's NT state columns), in a second pass over the heads: held in
  // registers through the first, E and the first pass's accumulators need
  // more than 255.  gS_h^T: thread idx takes column n_base + nn and K
  // positions 4 kb .. 4 kb + 3 (p); a warp reads 32 neighbouring columns
  // of one row at a time
  float eacc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) eacc[i] = 0.f;
  for (int h = group * p.heads; h < h_end; ++h) {
    __syncthreads();  // the previous head is done with gS^T, cum and w
    locate();
    const float* gsh =
        p.gstate ? p.gstate + ((static_cast<long long>(b) * p.nc + c) * p.H +
                               h) * static_cast<long long>(P) * N
                 : nullptr;
    scan(h);
#pragma unroll 4
    for (int idx = opaque_tid(); idx < NT * P / 4; idx += THREADS) {
      const int nn = idx % NT;
      const int kb = idx / NT;
      const int n = n_base + nn;
      const bool ok = gsh && n < N;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = ok ? gsh[(4 * kb + e) * N + n] : 0.f;
      store_operand<true>(gs_hi, gs_lo, core_index(nn, 4 * kb, P),
                          make_float4(v[0], v[1], v[2], v[3]));
    }
    stage_x(xs_e, h);
    fence_proxy_async();
    __syncthreads();  // gS^T, x and w are complete
    const float w0 = w_s[row0], w1 = w_s[row0 + 8];
    kloop<P / 8>(
        [&](int kk) { return x_fragment(xs_e, kk, w0, w1); },
        [&](int kk, const uint32_t(&hi)[4], const uint32_t(&lo)[4]) {
          wgmma3<NT>(eacc, hi, lo, gs_hi + kk * 2 * CORE,
                     gs_lo + kk * 2 * CORE, SBO_P);
        });
  }

  // dB_g = E + D^T C: A = D^T from its slots, renamed; B = C^T (rows n of
  // the block's slice, K = i at the renamed positions)
  __syncthreads();  // the last head is done with the region
  locate();
#pragma unroll 4
  for (int idx = opaque_tid(); idx < NT * QMAX / 4; idx += THREADS) {
    const int nn = idx % NT;
    const int kb = idx / NT;
    const int n = n_base + nn;
    const int i = 8 * (kb >> 1) + (kb & 1);
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = n < N && i + 2 * e < Q ? cb[(i + 2 * e) * sc1 + n] : 0.f;
    store_operand<true>(big_hi, big_hi + NT * QMAX,
                        core_index(nn, 4 * kb, QMAX),
                        make_float4(v[0], v[1], v[2], v[3]));
  }
  fence_proxy_async();
  __syncthreads();
  auto db_product = [&](auto columns) {
    constexpr int NC = decltype(columns)::value;
    constexpr int C0 = QMAX - NC;
    kloop<NC / 8>(
        [&](int q) {
          const float* dq = dt_t + 4 * q * WGS;
          return make_float4(dq[0], dq[2 * WGS], dq[WGS], dq[3 * WGS]);
        },
        [&](int q, const uint32_t(&hi)[4], const uint32_t(&lo)[4]) {
          const int kk = C0 / 8 + q;
          wgmma3<NT>(eacc, hi, lo, big_hi + kk * 2 * CORE,
                     big_hi + NT * QMAX + kk * 2 * CORE, SBO_J);
        });
  };
  if (wg == 0)
    db_product(std::integral_constant<int, 128>());
  else
    db_product(std::integral_constant<int, 64>());
  const long long gn = static_cast<long long>(p.groups) * N;
  float* wb = p.work + (rowb * p.groups + group) * N;  // dB; row i at + i gn
  float* wc = wb + static_cast<long long>(p.B) * p.S * gn;  // dC
#pragma unroll
  for (int q = 0; q < NT / 8; ++q) {
    const int n = n_base + 8 * q + 2 * t;
    if (n < N) {
      if (ok0)
        *reinterpret_cast<float2*>(wb + row0 * gn + n) =
            make_float2(eacc[4 * q], eacc[4 * q + 1]);
      if (ok1)
        *reinterpret_cast<float2*>(wb + (row0 + 8) * gn + n) =
            make_float2(eacc[4 * q + 2], eacc[4 * q + 3]);
    }
  }

  // dC_g^T = B^T D: the D tile (rows i, K = j) from D^T's slots, value
  // (j, i) at core_index(i, j); warpgroup 1 also writes the zeros of its
  // rows j >= 64 at the columns i < 64 it does not hold
  __syncthreads();  // every warp is done with C^T
  uint32_t* dk_lo = big_hi + QMAX * QMAX;
  auto d_tile = [&](auto columns) {
    constexpr int NC = decltype(columns)::value;
    constexpr int C0 = QMAX - NC;
#pragma unroll 1
    for (int q = 0; q < NC / 8; ++q)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int at = core_index(C0 + 8 * q + 2 * t + e, row0 + 8 * r, QMAX);
          uint32_t hi, lo;
          split(dt_t[(4 * q + 2 * r + e) * WGS], hi, lo);
          big_hi[at] = hi;
          dk_lo[at] = lo;
          if (C0) {
            const int zero = core_index(8 * q + 2 * t + e, row0 + 8 * r, QMAX);
            big_hi[zero] = 0u;
            dk_lo[zero] = 0u;
          }
        }
  };
  if (wg == 0)
    d_tile(std::integral_constant<int, 128>());
  else
    d_tile(std::integral_constant<int, 64>());
  fence_proxy_async();
  __syncthreads();
  // A = B^T: rows n = n_base + nl (nl = row0, + 8: the accumulator's rows
  // are this slice's state columns), K = j; k-step kk: a0 (nl, j), a1
  // (nl + 8, j), a2 (nl, j + 4), a3 (nl + 8, j + 4), j = 8 kk + t.  Only
  // the warpgroups that hold state columns
  if (wg == 0 || NT > WG_ROWS) {
    float cacc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) cacc[i] = 0.f;
    const int n = n_base + row0;
    const bool in0 = row0 < NT && n < N, in1 = row0 + 8 < NT && n + 8 < N;
    kloop<QMAX / 8>(
        [&](int kk) {
          const int j = 8 * kk + t;
          const float* bj = bb + j * sb1 + n;
          const float* bj4 = bj + 4 * sb1;
          const bool okj = j < Q, okj4 = j + 4 < Q;
          return make_float4(in0 && okj ? bj[0] : 0.f,
                             in1 && okj ? bj[8] : 0.f,
                             in0 && okj4 ? bj4[0] : 0.f,
                             in1 && okj4 ? bj4[8] : 0.f);
        },
        [&](int kk, const uint32_t(&hi)[4], const uint32_t(&lo)[4]) {
          wgmma3<QMAX>(cacc, hi, lo, big_hi + kk * 2 * CORE,
                       dk_lo + kk * 2 * CORE, SBO_J);
        });
    // element 4 q + 2 r + e: state column n + 8 r, chunk row 8 q + 2 t + e
#pragma unroll
    for (int q = 0; q < QMAX / 8; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 8 * q + 2 * t + e;
        if (i < Q) {
          if (in0) wc[i * gn + n] = cacc[4 * q + e];
          if (in1) wc[i * gn + n + 8] = cacc[4 * q + 2 + e];
        }
      }
  }
}

// dB and dC: the per-group partials of the workspace summed over the
// groups in order (e < rows * N: dB; past it: dC)
__global__ void __launch_bounds__(REDUCE_THREADS)
    ssd_chunk_bwd_reduce_kernel(const float* __restrict__ work,
                                float* __restrict__ dbm,
                                float* __restrict__ dcm, long long rows,
                                int groups, int N) {
  const long long per = rows * N;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < 2 * per; e += stride) {
    const bool second = e >= per;
    const long long rem = second ? e - per : e;
    const long long row = rem / N;
    const int n = static_cast<int>(rem % N);
    const float* src = work + (second ? per * groups : 0) + row * groups * N + n;
    float sum = 0.f;
    for (int gg = 0; gg < groups; ++gg)
      sum += src[static_cast<long long>(gg) * N];
    (second ? dcm : dbm)[rem] = sum;
  }
}

// How a call is cut into blocks: state columns per block (NT, a power of
// two from 16 to 128), blocks per chunk along d_state (slices), heads per
// block (HG) and head groups.  HG minimises the number of waves of blocks
// over the SMs times (HG + 1), as the forward's plan does.
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

template <int P, int NT>
cudaError_t launch(const BwdParams& p, int slices, int device,
                   cudaStream_t stream) {
  // Above 48 KB a block's shared memory must be allowed first: once per
  // device, at the first launch, outside any CUDA-graph capture.
  static bool allowed[MAX_DEVICES] = {};
  if (!allowed[device]) {
    const cudaError_t set = cudaFuncSetAttribute(
        ssd_chunk_bwd_kernel<P, NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, BwdSmem<P, NT>::BYTES);
    if (set != cudaSuccess) return set;
    allowed[device] = true;
  }
  const dim3 grid(p.nc, p.groups * slices, p.B);
  ssd_chunk_bwd_kernel<P, NT>
      <<<grid, THREADS, BwdSmem<P, NT>::BYTES, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(p.B) * p.S;
  long long blocks = (2 * rows * p.N + REDUCE_THREADS - 1) / REDUCE_THREADS;
  if (blocks > REDUCE_MAX_BLOCKS) blocks = REDUCE_MAX_BLOCKS;
  ssd_chunk_bwd_reduce_kernel<<<static_cast<unsigned>(blocks),
                                REDUCE_THREADS, 0, stream>>>(
      p.work, p.dbm, p.dcm, rows, p.groups, p.N);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_p(const BwdParams& p, int nt, int slices, int device,
                     cudaStream_t stream) {
  switch (nt) {
    case 16: return launch<P, 16>(p, slices, device, stream);
    case 32: return launch<P, 32>(p, slices, device, stream);
    case 64: return launch<P, 64>(p, slices, device, stream);
    default: return launch<P, 128>(p, slices, device, stream);
  }
}

bool valid_shape(int B, int S, int H, int P, int N, int Q, int device) {
  return B >= 1 && B <= 65535 && H >= 1 && H <= 65535 && Q >= 1 &&
         Q <= QMAX && S >= Q && S % Q == 0 && N >= 16 && N % 16 == 0 &&
         (P == 16 || P == 32 || P == 64) && device >= 0 &&
         device < MAX_DEVICES;
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

extern "C" {

// The backward of repro_ssd_chunk.  Inputs as the forward takes them: x
// (B, S, H, P), a (B, S, H), bm and cm (B, S, N), f32 (13 int64 strides:
// those of x, a, bm and cm in that order); x's last stride is 1, its
// other strides are multiples of 4 and it starts 16-byte aligned; bm's and
// cm's last strides are 1; a takes any strides.  Upstream
// gradients, contiguous f32, each may be null (zero): gy (B, S, H, P) of
// y_intra and gstate (B, S / Q, H, P, N) of the states, both 16-byte
// aligned, and gcum (B, S, H) of cum.  Outputs, contiguous f32: dx (B, S,
// H, P), da (B, S, H), dbm and dcm (B, S, N); work is a scratch of 2 * B *
// S * groups * N floats, groups as repro_ssd_chunk_bwd_plan reports.  P:
// 16, 32 or 64; N: a multiple of 16; Q: 1..128, dividing S.  Launches the
// two kernels on ``stream`` without synchronizing; returns the launches'
// CUDA error (0 = success), and refuses a bad shape or pointer before any
// kernel launch.
int repro_ssd_chunk_bwd(const void* x, const void* a, const void* bm,
                        const void* cm, const void* gy, const void* gstate,
                        const void* gcum, void* dx, void* da, void* dbm,
                        void* dcm, void* work, const long long* strides,
                        int B, int S, int H, int P, int N, int Q, int device,
                        void* stream) {
  if (!x || !a || !bm || !cm || !dx || !da || !dbm || !dcm || !work ||
      !strides || !valid_shape(B, S, H, P, N, Q, device) || !aligned16(x) ||
      strides[0] % 4 || strides[1] % 4 || strides[2] % 4 || strides[3] != 1 ||
      strides[9] != 1 || strides[12] != 1 || strides[1] >= (1LL << 24) ||
      strides[8] >= (1LL << 24) || strides[11] >= (1LL << 24) ||
      static_cast<long long>(H) * P * QMAX >= (1LL << 31) || !aligned16(gy) ||
      !aligned16(gstate) || !aligned16(dx) || !aligned16(work))
    return cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int sms = sm_count(device);
  if (sms < 1) return cudaErrorInvalidDevice;
  const Plan pl = plan(B, S, H, N, Q, sms);
  BwdParams p;
  p.x = static_cast<const float*>(x);
  p.a = static_cast<const float*>(a);
  p.bm = static_cast<const float*>(bm);
  p.cm = static_cast<const float*>(cm);
  p.gy = static_cast<const float*>(gy);
  p.gstate = static_cast<const float*>(gstate);
  p.gcum = static_cast<const float*>(gcum);
  p.dx = static_cast<float*>(dx);
  p.da = static_cast<float*>(da);
  p.work = static_cast<float*>(work);
  p.dbm = static_cast<float*>(dbm);
  p.dcm = static_cast<float*>(dcm);
  for (int i = 0; i < 4; ++i) p.sx[i] = strides[i];
  for (int i = 0; i < 3; ++i) {
    p.sa[i] = strides[4 + i];
    p.sb[i] = strides[7 + i];
    p.sc[i] = strides[10 + i];
  }
  p.B = B;
  p.S = S;
  p.H = H;
  p.N = N;
  p.Q = Q;
  p.nc = S / Q;
  p.heads = pl.heads;
  p.groups = pl.groups;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = P == 64   ? launch_p<64>(p, pl.nt, pl.slices, device, s)
                          : P == 32 ? launch_p<32>(p, pl.nt, pl.slices, device, s)
                                    : launch_p<16>(p, pl.nt, pl.slices, device, s);
  return static_cast<int>(err);
}

// How repro_ssd_chunk_bwd cuts a call of this shape on ``device``: out[0]
// heads per block, out[1] head groups, out[2] blocks per chunk along
// d_state, out[3] state columns per block.  Returns a CUDA error code.
int repro_ssd_chunk_bwd_plan(int B, int S, int H, int P, int N, int Q,
                             int device, int* out) {
  if (!out || !valid_shape(B, S, H, P, N, Q, device))
    return cudaErrorInvalidValue;
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
