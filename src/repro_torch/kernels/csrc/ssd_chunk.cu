// Mamba2 SSD intra-chunk kernel for Hopper, CUDA C++ for sm_90a.
//
// Replaces the JAX package's Pallas kernel _ssd_chunk_kernel
// (src/repro/kernels/ssd_scan.py, launched by ssd_chunk_batch).  For one
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
// Bound on an H100 SXM: compute.  One chunk of one head does about
// Q^2 N (scores, causal half) + Q^2 P (y) + 2 Q P N (state) flops, against
// 67 TFLOP/s of f32 FMA outside the tensor cores; it reads and writes
// O(Q (P + N) + P N) floats.  At the server shape (64 heads, P 64, N 128,
// Q 128) that is ~5.3 MFLOP against ~100 KB per block: about 50 flops per
// byte, above the f32 ridge of 20.  So the design keeps the FMA units fed
// from registers and shared memory:
//
//  * One block of 128 threads per (chunk, head, batch); thread i owns chunk
//    row i (threads past Q only help with loads and the state).  Its 64-wide
//    y accumulator stays in registers for the whole block.
//  * The x tile (Q, P) sits in shared memory for the whole block; B and C
//    are staged NC = 64 columns at a time (Q, NC + 4), so a block needs about
//    100 KB at the server shape and two blocks share an SM.  Thread i copies
//    its C row's NC columns into registers; each step j of the causal loop
//    then reads B_j and x_j as 16-byte broadcasts (every thread reads the
//    same address): one shared load feeds four FMAs, in both products.
//  * The state is spread over the threads as 4 x 4 tiles of (p, n): per row
//    j, one 16-byte load of x_j (scaled by exp(cum_Q - cum_j)) and one of
//    B_j feed sixteen FMAs.
//  * The prefix sum of a runs in shared memory in one thread, in order.
//
// Tensor cores (TF32 would break the reference's 3e-4 tolerance; a bf16 or
// 3xTF32 split could keep it), sharing C B^T across the heads of a chunk and
// TMA-fed tiles are later work; this kernel is the simple, exact f32 version.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_Q = THREADS;  // one chunk row per thread
constexpr int PAD = 4;          // floats of padding per staged B/C row

struct Params {
  const float* x;   // (B, S, H, P), strided
  const float* a;   // (B, S, H), strided
  const float* bm;  // (B, S, N), strided
  const float* cm;  // (B, S, N), strided
  float* y;         // (B, S, H, P), contiguous
  float* state;     // (B, nc, H, P, N), contiguous
  float* decay;     // (B, nc, H), contiguous
  float* cum;       // (B, S, H), contiguous
  long long sx[4], sa[3], sb[3], sc[3];  // element strides
  int S, H, N, Q, nc;
};

template <int P, int NC>
__global__ void __launch_bounds__(THREADS, 2)
    ssd_chunk_kernel(const Params p) {
  constexpr int LD = NC + PAD;
  constexpr int N4 = NC / 4;
  extern __shared__ float4 smem4[];
  const int Q = p.Q;
  float* const cum = reinterpret_cast<float*>(smem4);  // [MAX_Q]
  float* const dte = cum + MAX_Q;  // [MAX_Q] exp(cum_Q - cum_j)
  float* const xs = dte + MAX_Q;   // [Q][P]
  float* const bs = xs + Q * P;    // [Q][LD]
  float* const cs = bs + Q * LD;   // [Q][LD]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x;
  const long long s0 = static_cast<long long>(c) * Q;

  for (int i = t; i < Q; i += THREADS)
    cum[i] = p.a[b * p.sa[0] + (s0 + i) * p.sa[1] + h * p.sa[2]];
  for (int idx = t; idx < Q * P; idx += THREADS) {
    const int i = idx / P, q = idx - i * P;
    xs[idx] = p.x[b * p.sx[0] + (s0 + i) * p.sx[1] + h * p.sx[2] +
                  q * p.sx[3]];
  }
  __syncthreads();
  if (t == 0) {
    float run = 0.f;
    for (int i = 0; i < Q; ++i) {
      run += cum[i];
      cum[i] = run;
    }
  }
  __syncthreads();
  const float last = cum[Q - 1];
  for (int i = t; i < Q; i += THREADS) {
    dte[i] = expf(last - cum[i]);
    p.cum[(b * static_cast<long long>(p.S) + s0 + i) * p.H + h] = cum[i];
  }
  if (t == 0)
    p.decay[(b * static_cast<long long>(p.nc) + c) * p.H + h] = expf(last);

  const bool has_row = t < Q;
  const float cum_i = has_row ? cum[t] : 0.f;
  float acc[P];
#pragma unroll
  for (int q = 0; q < P; ++q) acc[q] = 0.f;

  for (int n0 = 0; n0 < p.N; n0 += NC) {
    __syncthreads();  // dte is written; the last column block is done
    for (int idx = t; idx < Q * NC; idx += THREADS) {
      const int i = idx / NC, n = idx - i * NC;
      const long long row = s0 + i;
      bs[i * LD + n] = p.bm[b * p.sb[0] + row * p.sb[1] + (n0 + n) * p.sb[2]];
      cs[i * LD + n] = p.cm[b * p.sc[0] + row * p.sc[1] + (n0 + n) * p.sc[2]];
    }
    __syncthreads();

    // y_i += sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) x_j over these NC
    // columns of C and B
    if (has_row) {
      float cr[NC];
#pragma unroll
      for (int k = 0; k < NC; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(cs + t * LD + k);
        cr[k] = v.x;
        cr[k + 1] = v.y;
        cr[k + 2] = v.z;
        cr[k + 3] = v.w;
      }
      for (int j = 0; j <= t; ++j) {
        const float* bj = bs + j * LD;
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < NC; k += 4) {
          const float4 v = *reinterpret_cast<const float4*>(bj + k);
          s[0] = fmaf(cr[k], v.x, s[0]);
          s[1] = fmaf(cr[k + 1], v.y, s[1]);
          s[2] = fmaf(cr[k + 2], v.z, s[2]);
          s[3] = fmaf(cr[k + 3], v.w, s[3]);
        }
        const float w = ((s[0] + s[1]) + (s[2] + s[3])) * expf(cum_i - cum[j]);
        const float* xj = xs + j * P;
#pragma unroll
        for (int q = 0; q < P; q += 4) {
          const float4 v = *reinterpret_cast<const float4*>(xj + q);
          acc[q] = fmaf(w, v.x, acc[q]);
          acc[q + 1] = fmaf(w, v.y, acc[q + 1]);
          acc[q + 2] = fmaf(w, v.z, acc[q + 2]);
          acc[q + 3] = fmaf(w, v.w, acc[q + 3]);
        }
      }
    }

    // state[:, n0:n0 + NC] = sum_j (exp(cum_Q - cum_j) x_j) B_j^T, in 4 x 4
    // tiles of (p, n)
    for (int item = t; item < (P / 4) * N4; item += THREADS) {
      const int p4 = item / N4, n4 = item - p4 * N4;
      float st[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[r][e] = 0.f;
      for (int j = 0; j < Q; ++j) {
        const float w = dte[j];
        const float4 xv = *reinterpret_cast<const float4*>(xs + j * P + 4 * p4);
        const float4 bv = *reinterpret_cast<const float4*>(bs + j * LD + 4 * n4);
        const float xw[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[r][e] = fmaf(xw[r], bb[e], st[r][e]);
      }
      float* out = p.state +
                   ((b * static_cast<long long>(p.nc) + c) * p.H + h) * P *
                       p.N +
                   static_cast<long long>(4 * p4) * p.N + n0 + 4 * n4;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float4*>(out + r * p.N) =
            make_float4(st[r][0], st[r][1], st[r][2], st[r][3]);
    }
  }

  if (has_row) {
    float* out =
        p.y + ((b * static_cast<long long>(p.S) + s0 + t) * p.H + h) * P;
#pragma unroll
    for (int q = 0; q < P; q += 4)
      *reinterpret_cast<float4*>(out + q) =
          make_float4(acc[q], acc[q + 1], acc[q + 2], acc[q + 3]);
  }
}

constexpr int MAX_DEVICES = 64;

template <int P, int NC>
constexpr int smem_bytes(int Q) {
  return static_cast<int>((2 * MAX_Q + Q * P + 2 * Q * (NC + PAD)) *
                          sizeof(float));
}

template <int P, int NC>
cudaError_t launch(const Params& p, int B, int device, cudaStream_t stream) {
  // Above 48 KB a block's shared memory must be allowed first.  Allow the
  // most any Q needs, once per device, at the first launch: a later launch
  // may be inside a CUDA-graph capture, where no such call belongs.
  static bool allowed[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!allowed[device]) {
    const cudaError_t set = cudaFuncSetAttribute(
        ssd_chunk_kernel<P, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<P, NC>(MAX_Q));
    if (set != cudaSuccess) return set;
    allowed[device] = true;
  }
  const dim3 grid(p.nc, p.H, B);
  ssd_chunk_kernel<P, NC>
      <<<grid, THREADS, smem_bytes<P, NC>(p.Q), stream>>>(p);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_p(const Params& p, int B, int device,
                     cudaStream_t stream) {
  if (p.N % 64 == 0) return launch<P, 64>(p, B, device, stream);
  if (p.N % 32 == 0) return launch<P, 32>(p, B, device, stream);
  return launch<P, 16>(p, B, device, stream);
}

}  // namespace

extern "C" {

// x (B, S, H, P), a (B, S, H), bm and cm (B, S, N): f32, any strides
// (13 int64 values: those of x, a, bm and cm in that order).  Outputs,
// contiguous f32: y (B, S, H, P), state (B, S / Q, H, P, N), decay
// (B, S / Q, H), cum (B, S, H).  P: 16, 32 or 64; N: a multiple of 16;
// Q: 1..128, dividing S.  Launches on ``stream`` without synchronizing;
// returns the launch's CUDA error (0 = success).  ``device`` is the card
// that ``stream`` and the tensors belong to: this library carries its own
// CUDA runtime, whose current device is set here.
int repro_ssd_chunk(const void* x, const void* a, const void* bm,
                    const void* cm, void* y, void* state, void* decay,
                    void* cum, const long long* strides, int B, int S, int H,
                    int P, int N, int Q, int device, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || Q < 1 || Q > MAX_Q ||
      S < Q || S % Q || N < 16 || N % 16)
    return cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = P == 64   ? launch_p<64>(p, B, device, s)
                          : P == 32 ? launch_p<32>(p, B, device, s)
                          : P == 16 ? launch_p<16>(p, B, device, s)
                                    : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
