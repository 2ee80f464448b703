// Backward of the Mamba2 SSD intra-chunk kernel for Hopper, CUDA C++ for
// sm_90a, f32 FMA.
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
// (kernels/ops.py) reads cum instead.
//
// Bound on an H100 SXM: operations.  At mamba2-1.3b's training shape on
// the server (8 sequences of 256 tokens, 64 heads, P 64, N 128, Q 128)
// the function moves about 140 MB (x, gy, the states' gradient and dx
// 33.5 MB each): 0.042 ms at 3.35 TB/s; its products (C B^T, gy x^T,
// M^T gy, B gS^T, (dM o L) B, (dM o L)^T C and (x o w) gS, the three
// Q x Q ones over their causal half) are about 13 GFLOP: 0.19 ms at the
// 67 TFLOP/s of f32 FMA.  This first kernel is the simple form, all f32
// FMA from shared memory:
//
//  * Grid.  One block of 256 threads per (chunk, head, batch).  It
//    recomputes cum, w, L and C B^T from the inputs: the forward saves
//    nothing for it.
//  * Shared memory at P 64: x and gy (Q x P each, rows padded to P + 1
//    words), M and dM o L (Q x Q each, rows padded to Q + 1), and the
//    small vectors: 208 KB, one block per SM.  B and C (Q x N each) and
//    gS (P x N) are staged NS = 16 columns of d_state at a time, first
//    (C^T, B^T, for C B^T) in the dM o L tile before it is written, then
//    (B, C, gS, for the d_state-wide products) in the M tile after M^T gy
//    has read it.  The paddings keep every product's reads free of bank
//    conflicts.
//  * Thread tiles.  Thread (ty, tx) = (tid / 16, tid % 16) holds rows
//    ty + 16 r and columns tx + 16 s of each Q x Q tile (8 x 8), rows
//    ty + 16 r and columns tx + 16 s of the Q x P tiles (dx, B gS^T), and
//    rows ty + 16 r of column tx of each staged d_state slice.
//  * The upper triangle.  exp is taken of -inf there (masked before the
//    exponential), so no inf * 0 makes a NaN, however negative a is.
//  * Determinism.  Every sum runs in a fixed order: the row sums of R by
//    butterfly shuffles over the 16 threads of a row, the column sums
//    through a (16, Q) table in shared memory summed in order, and the
//    reverse cumsum by one warp.  dB and dC, which B and C (one group)
//    share over the heads, are written per head into a workspace (2, B,
//    S, H, N) and summed over the heads, in order, by a second kernel,
//    ssd_chunk_bwd_reduce_kernel.  No float atomics: two launches give
//    the same bits.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int QMAX = 128;       // chunk rows a block takes
constexpr int THREADS = 256;    // 16 x 16 thread tiles
constexpr int NS = 16;          // d_state columns per staged slice
constexpr int LDQ = QMAX + 1;   // row stride of the Q x Q tiles, in words
constexpr int REDUCE_THREADS = 256;
constexpr long long REDUCE_MAX_BLOCKS = 1 << 20;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;

struct BwdParams {
  const float* x;       // (B, S, H, P), strided
  const float* a;       // (B, S, H), strided
  const float* bm;      // (B, S, N), strided
  const float* cm;      // (B, S, N), strided
  const float* gy;      // (B, S, H, P) contiguous, or null (zero)
  const float* gstate;  // (B, nc, H, P, N) contiguous, or null
  const float* gcum;    // (B, S, H) contiguous, or null
  float* dx;            // (B, S, H, P), contiguous
  float* da;            // (B, S, H), contiguous
  float* work;          // (2, B, S, H, N): dB per head, then dC per head
  float* dbm;           // (B, S, N), contiguous: the reduce kernel's
  float* dcm;           // (B, S, N), contiguous
  long long sx[4], sa[3], sb[3], sc[3];  // element strides
  int B, S, H, N, Q, nc;
};

// A block's shared memory, in 4-byte words.
template <int P>
struct BwdSmem {
  static constexpr int LDP = P + 1;      // row stride of x and gy
  static constexpr int XS = QMAX * LDP;  // x; gy
  static constexpr int QQ = QMAX * LDQ;  // M; dM o L
  static constexpr int VECTORS = 5 * QMAX + 16 * QMAX;
  static constexpr int BYTES = (2 * XS + 2 * QQ + VECTORS) * 4;
  static_assert(BYTES <= 232448, "an H100 block has 227 KB");
  static_assert(2 * NS * LDQ <= QQ, "the C^T, B^T slices fit the dG tile");
  static_assert(2 * QMAX * NS + P * (NS + 1) <= QQ,
                "the B, C and gS slices fit the M tile");
  static_assert(XS % 4 == 0 && QQ % 4 == 0, "the vectors are 16-byte "
                                            "aligned");
};

template <int P>
__global__ void __launch_bounds__(THREADS, 1)
    ssd_chunk_bwd_kernel(const BwdParams p) {
  using L = BwdSmem<P>;
  constexpr int LDP = L::LDP;
  constexpr int PS = P / 16;  // columns of a Q x P tile per thread
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* gys = xs + L::XS;
  float* ms = gys + L::XS;     // M; from the d_state products on, slices
  float* dgs = ms + L::QQ;     // C^T and B^T slices for C B^T; then dM o L
  float* cum_s = dgs + L::QQ;  // cum; past Q, cum_Q
  float* w_s = cum_s + QMAX;   // exp(cum_Q - cum_j); past Q, 0
  float* dcum_s = w_s + QMAX;  // a, then the row sums of R, then dcum
  float* t_s = dcum_s + QMAX;  // T
  float* gc_s = t_s + QMAX;    // gcum
  float* colpart = gc_s + QMAX;  // (16, QMAX): column sums of R by ty

  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int Q = p.Q;
  const long long s0 = static_cast<long long>(c) * Q;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const float ninf = __int_as_float(0xff800000);

  const float* xb = p.x + b * p.sx[0] + s0 * p.sx[1] + h * p.sx[2];
  const float* ab = p.a + b * p.sa[0] + s0 * p.sa[1] + h * p.sa[2];
  const float* bb = p.bm + b * p.sb[0] + s0 * p.sb[1];
  const float* cb = p.cm + b * p.sc[0] + s0 * p.sc[1];
  // row (b, s0, h) of the contiguous (B, S, H, ...) tensors; row i of the
  // chunk is row0 + i * H
  const long long row0 = (static_cast<long long>(b) * p.S + s0) * p.H + h;

  // x and gy (rows past Q zero), a and gcum
  for (int idx = tid; idx < QMAX * P; idx += THREADS) {
    const int r = idx / P;
    const int col = idx % P;
    const bool ok = r < Q;
    xs[r * LDP + col] = ok ? xb[r * p.sx[1] + col * p.sx[3]] : 0.f;
    gys[r * LDP + col] =
        ok && p.gy ? p.gy[(row0 + static_cast<long long>(r) * p.H) * P + col]
                   : 0.f;
  }
  if (tid < QMAX) {
    const bool ok = tid < Q;
    dcum_s[tid] = ok ? ab[tid * p.sa[1]] : 0.f;
    gc_s[tid] =
        ok && p.gcum ? p.gcum[row0 + static_cast<long long>(tid) * p.H] : 0.f;
  }
  __syncthreads();
  // cum by warp 0: lane l scans a[4l .. 4l + 3], then the lanes' totals
  if (tid < 32) {
    float4 v = reinterpret_cast<const float4*>(dcum_s)[lane];
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
    for (int e = 0; e < 4; ++e)
      wv[e] = 4 * lane + e < Q ? expf(last - cv[e]) : 0.f;
    reinterpret_cast<float4*>(w_s)[lane] =
        make_float4(wv[0], wv[1], wv[2], wv[3]);
  }

  // C B^T over d_state slices, into acc (rows ty + 16 r, columns tx + 16 s)
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int s = 0; s < 8; ++s) acc[r][s] = 0.f;
  {
    float* ct = dgs;             // (NS, LDQ): C^T of the slice
    float* bt = dgs + NS * LDQ;  // (NS, LDQ): B^T of the slice
    for (int n0 = 0; n0 < p.N; n0 += NS) {
      __syncthreads();  // the previous slice is consumed; cum and w landed
      for (int idx = tid; idx < QMAX * NS; idx += THREADS) {
        const int j = idx / NS;
        const int nn = idx % NS;
        const bool ok = j < Q;
        ct[nn * LDQ + j] = ok ? cb[j * p.sc[1] + (n0 + nn) * p.sc[2]] : 0.f;
        bt[nn * LDQ + j] = ok ? bb[j * p.sb[1] + (n0 + nn) * p.sb[2]] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int nn = 0; nn < NS; ++nn) {
        float cv[8], bv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) cv[r] = ct[nn * LDQ + ty + 16 * r];
#pragma unroll
        for (int s = 0; s < 8; ++s) bv[s] = bt[nn * LDQ + tx + 16 * s];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int s = 0; s < 8; ++s) acc[r][s] = fmaf(cv[r], bv[s], acc[r][s]);
      }
    }
  }

  // M = (C B^T) o L into ms; L masked before the exponential
  float ci[8], cj[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) ci[r] = cum_s[ty + 16 * r];
#pragma unroll
  for (int s = 0; s < 8; ++s) cj[s] = cum_s[tx + 16 * s];
  auto decay = [&](int r, int s) {
    const int i = ty + 16 * r, j = tx + 16 * s;
    return expf(j <= i && i < Q ? ci[r] - cj[s] : ninf);
  };
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int s = 0; s < 8; ++s)
      ms[(ty + 16 * r) * LDQ + tx + 16 * s] = acc[r][s] * decay(r, s);

  // dM = gy x^T, into acc
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int s = 0; s < 8; ++s) acc[r][s] = 0.f;
#pragma unroll 4
  for (int pp = 0; pp < P; ++pp) {
    float gv[8], xv[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) gv[r] = gys[(ty + 16 * r) * LDP + pp];
#pragma unroll
    for (int s = 0; s < 8; ++s) xv[s] = xs[(tx + 16 * s) * LDP + pp];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int s = 0; s < 8; ++s) acc[r][s] = fmaf(gv[r], xv[s], acc[r][s]);
  }

  // R = dM o M (its row and column sums) and dG = dM o L; both vanish
  // above the diagonal, where M and L do
  __syncthreads();  // every warp is done with the C^T, B^T slices in dgs
  {
    float rsum[8], csum[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) rsum[i] = csum[i] = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int at = (ty + 16 * r) * LDQ + tx + 16 * s;
        const float rr = acc[r][s] * ms[at];  // this thread wrote ms[at]
        rsum[r] += rr;
        csum[s] += rr;
        dgs[at] = acc[r][s] * decay(r, s);
      }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float v = rsum[r];
#pragma unroll
      for (int d = 8; d >= 1; d /= 2) v += __shfl_xor_sync(FULL, v, d);
      if (tx == 0) dcum_s[ty + 16 * r] = v;
    }
#pragma unroll
    for (int s = 0; s < 8; ++s) colpart[ty * QMAX + tx + 16 * s] = csum[s];
  }
  __syncthreads();  // M, dG, the row sums and the column partials are done

  // dcum = rowsum(R) - colsum(R) + gcum (T comes below)
  if (tid < QMAX) {
    float col = 0.f;
#pragma unroll
    for (int t = 0; t < 16; ++t) col += colpart[t * QMAX + tid];
    dcum_s[tid] = dcum_s[tid] - col + gc_s[tid];
  }

  // M^T gy, into dxa (rows j = ty + 16 r, columns p = tx + 16 s)
  float dxa[8][PS];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int s = 0; s < PS; ++s) dxa[r][s] = 0.f;
  for (int i = 0; i < Q; ++i) {
    float mv[8], gv[PS];
#pragma unroll
    for (int r = 0; r < 8; ++r) mv[r] = ms[i * LDQ + ty + 16 * r];
#pragma unroll
    for (int s = 0; s < PS; ++s) gv[s] = gys[i * LDP + tx + 16 * s];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int s = 0; s < PS; ++s) dxa[r][s] = fmaf(mv[r], gv[s], dxa[r][s]);
  }

  // the d_state-wide products, NS columns at a time: V = B gS^T (Q x P,
  // in registers), and this slice's columns of dC and dB, per head into
  // the workspace
  float vacc[8][PS];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int s = 0; s < PS; ++s) vacc[r][s] = 0.f;
  {
    float* bs = ms;                    // (QMAX, NS)
    float* cs = ms + QMAX * NS;        // (QMAX, NS)
    float* gss = ms + 2 * QMAX * NS;   // (P, NS + 1)
    const float* gsb =
        p.gstate ? p.gstate + ((static_cast<long long>(b) * p.nc + c) * p.H +
                               h) * static_cast<long long>(P) * p.N
                 : nullptr;
    const long long hn = static_cast<long long>(p.H) * p.N;
    float* wb = p.work + row0 * p.N;  // dB partials; row i at + i * hn
    float* wc = wb + static_cast<long long>(p.B) * p.S * hn;  // dC
    for (int n0 = 0; n0 < p.N; n0 += NS) {
      __syncthreads();  // the previous slice (first time: M) is consumed
      for (int idx = tid; idx < QMAX * NS; idx += THREADS) {
        const int j = idx / NS;
        const int nn = idx % NS;
        const bool ok = j < Q;
        bs[idx] = ok ? bb[j * p.sb[1] + (n0 + nn) * p.sb[2]] : 0.f;
        cs[idx] = ok ? cb[j * p.sc[1] + (n0 + nn) * p.sc[2]] : 0.f;
      }
      for (int idx = tid; idx < P * NS; idx += THREADS) {
        const int pp = idx / NS;
        const int nn = idx % NS;
        gss[pp * (NS + 1) + nn] = gsb ? gsb[pp * p.N + n0 + nn] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int nn = 0; nn < NS; ++nn) {
        float bv[8], sv[PS];
#pragma unroll
        for (int r = 0; r < 8; ++r) bv[r] = bs[(ty + 16 * r) * NS + nn];
#pragma unroll
        for (int s = 0; s < PS; ++s)
          sv[s] = gss[(tx + 16 * s) * (NS + 1) + nn];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int s = 0; s < PS; ++s)
            vacc[r][s] = fmaf(bv[r], sv[s], vacc[r][s]);
      }
      float dc[8], db[8], xg[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) dc[r] = db[r] = xg[r] = 0.f;
      for (int k = 0; k < Q; ++k) {
        const float bk = bs[k * NS + tx];
        const float ck = cs[k * NS + tx];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          dc[r] = fmaf(dgs[(ty + 16 * r) * LDQ + k], bk, dc[r]);
          db[r] = fmaf(dgs[k * LDQ + ty + 16 * r], ck, db[r]);
        }
      }
#pragma unroll 4
      for (int pp = 0; pp < P; ++pp) {
        const float sv = gss[pp * (NS + 1) + tx];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          xg[r] = fmaf(xs[(ty + 16 * r) * LDP + pp], sv, xg[r]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = ty + 16 * r;
        if (i < Q) {
          const long long at = i * hn + n0 + tx;
          wc[at] = dc[r];
          wb[at] = fmaf(w_s[i], xg[r], db[r]);
        }
      }
    }
  }

  // dx = M^T gy + w o V, and T_j = w_j sum_p x_jp V_jp
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int j = ty + 16 * r;
    const float wj = w_s[j];
    float t = 0.f;
#pragma unroll
    for (int s = 0; s < PS; ++s) {
      t = fmaf(xs[j * LDP + tx + 16 * s], vacc[r][s], t);
      dxa[r][s] = fmaf(wj, vacc[r][s], dxa[r][s]);
    }
#pragma unroll
    for (int d = 8; d >= 1; d /= 2) t += __shfl_xor_sync(FULL, t, d);
    if (tx == 0) t_s[j] = wj * t;
    if (j < Q) {
      float* dst = p.dx + (row0 + static_cast<long long>(j) * p.H) * P + tx;
#pragma unroll
      for (int s = 0; s < PS; ++s) dst[16 * s] = dxa[r][s];
    }
  }
  __syncthreads();  // T and dcum are complete

  // dcum -= T, dcum_{Q-1} += sum T; da = the reverse cumsum, by warp 0
  if (tid < 32) {
    const float4 d4 = reinterpret_cast<const float4*>(dcum_s)[lane];
    const float4 t4 = reinterpret_cast<const float4*>(t_s)[lane];
    float v[4] = {d4.x - t4.x, d4.y - t4.y, d4.z - t4.z, d4.w - t4.w};
    float total = (t4.x + t4.y) + (t4.z + t4.w);
#pragma unroll
    for (int d = 16; d >= 1; d /= 2) total += __shfl_xor_sync(FULL, total, d);
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
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * lane + e;
      if (k < Q) p.da[row0 + static_cast<long long>(k) * p.H] = v[e] + off;
    }
  }
}

// dB and dC: the per-head partials of the workspace summed over the heads
// in order (e < rows * N: dB; past it: dC)
__global__ void __launch_bounds__(REDUCE_THREADS)
    ssd_chunk_bwd_reduce_kernel(const float* __restrict__ work,
                                float* __restrict__ dbm,
                                float* __restrict__ dcm, long long rows,
                                int H, int N) {
  const long long per = rows * N;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < 2 * per; e += stride) {
    const bool second = e >= per;
    const long long rem = second ? e - per : e;
    const long long row = rem / N;
    const int n = static_cast<int>(rem % N);
    const float* src = work + (second ? per * H : 0) + row * H * N + n;
    float sum = 0.f;
    for (int hh = 0; hh < H; ++hh) sum += src[static_cast<long long>(hh) * N];
    (second ? dcm : dbm)[rem] = sum;
  }
}

template <int P>
cudaError_t launch(const BwdParams& p, int device, cudaStream_t stream) {
  // Above 48 KB a block's shared memory must be allowed first: once per
  // device, at the first launch, outside any CUDA-graph capture.
  static bool allowed[MAX_DEVICES] = {};
  if (!allowed[device]) {
    const cudaError_t set = cudaFuncSetAttribute(
        ssd_chunk_bwd_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        BwdSmem<P>::BYTES);
    if (set != cudaSuccess) return set;
    allowed[device] = true;
  }
  const dim3 grid(p.nc, p.H, p.B);
  ssd_chunk_bwd_kernel<P><<<grid, THREADS, BwdSmem<P>::BYTES, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(p.B) * p.S;
  long long blocks = (2 * rows * p.N + REDUCE_THREADS - 1) / REDUCE_THREADS;
  if (blocks > REDUCE_MAX_BLOCKS) blocks = REDUCE_MAX_BLOCKS;
  ssd_chunk_bwd_reduce_kernel<<<static_cast<unsigned>(blocks),
                                REDUCE_THREADS, 0, stream>>>(
      p.work, p.dbm, p.dcm, rows, p.H, p.N);
  return cudaGetLastError();
}

bool valid_shape(int B, int S, int H, int P, int N, int Q, int device) {
  return B >= 1 && B <= 65535 && H >= 1 && H <= 65535 && Q >= 1 &&
         Q <= QMAX && S >= Q && S % Q == 0 && N >= 16 && N % 16 == 0 &&
         (P == 16 || P == 32 || P == 64) && device >= 0 &&
         device < MAX_DEVICES;
}

}  // namespace

extern "C" {

// The backward of repro_ssd_chunk.  Inputs as the forward takes them: x
// (B, S, H, P), a (B, S, H), bm and cm (B, S, N), f32, any strides (13
// int64 strides: those of x, a, bm and cm in that order).  Upstream
// gradients, contiguous f32, each may be null (zero): gy (B, S, H, P) of
// y_intra, gstate (B, S / Q, H, P, N) of the states, gcum (B, S, H) of
// cum.  Outputs, contiguous f32: dx (B, S, H, P), da (B, S, H), dbm and dcm
// (B, S, N); work is a scratch of 2 * B * S * H * N floats.  P: 16, 32 or
// 64; N: a multiple of 16; Q: 1..128, dividing S.  Launches the two
// kernels on ``stream`` without synchronizing; returns the launches' CUDA
// error (0 = success), and refuses a bad shape or a null pointer before
// any CUDA call.
int repro_ssd_chunk_bwd(const void* x, const void* a, const void* bm,
                        const void* cm, const void* gy, const void* gstate,
                        const void* gcum, void* dx, void* da, void* dbm,
                        void* dcm, void* work, const long long* strides,
                        int B, int S, int H, int P, int N, int Q, int device,
                        void* stream) {
  if (!x || !a || !bm || !cm || !dx || !da || !dbm || !dcm || !work ||
      !strides || !valid_shape(B, S, H, P, N, Q, device))
    return cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = P == 64   ? launch<64>(p, device, s)
                          : P == 32 ? launch<32>(p, device, s)
                                    : launch<16>(p, device, s);
  return static_cast<int>(err);
}

}  // extern "C"
