// Blocked flash attention, backward, for Hopper: CUDA C++ for sm_90a.
//
// Replaces no Pallas kernel: the JAX package's flash kernel
// (src/repro/kernels/flash_attention.py, _flash_kernel) has no backward,
// and the JAX model differentiates its plain chunked attention
// (src/repro/models/attention.py, chunked_flash_attention) with jax.grad.
// The port trains past 2048 tokens through flash_attention_kernel
// (flash_attention.cu) forward and these kernels backward, held on the
// CPU to jax.vjp of that chunked attention (tests/test_torch_flash_bwd.py)
// and on the card to the plain backward, ref.flash_attention_bwd.
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
// Three kernels, launched in order on one stream:
//
//  * flash_attention_bwd_preprocess_kernel: Delta, one warp per row, in
//    f32 (B, H, S) scratch that the wrapper allocates.
//  * flash_attention_bwd_dkdv_kernel: one block per (batch, kv head, kv
//    tile of 64 rows).  It holds K and V of its tile in shared memory and
//    dK, dV in registers, and walks the group's q heads in order and, for
//    each, the q tiles at or below the diagonal: it recomputes S and P
//    from Q and lse, dP = dO V^T and dS, then dV += P^T dO and
//    dK += dS^T Q.  The GQA sum is inside the block: each output element
//    is written once, by one thread.
//  * flash_attention_bwd_dq_kernel: one block per (batch, q head, q tile
//    of 64 rows), the bottom (longest) tiles first.  It holds Q, dO, lse
//    and Delta of its tile and walks the kv tiles up to the diagonal:
//    S, P, dP and dS again, then dQ += dS K.
//
// Deterministic: no atomics, every sum is taken in one fixed order, so two
// runs are bit-identical (split training's step-0 check holds the
// Executor to the serial protocol_step at 1e-5, both on the card).
//
// Bound on an H100 SXM: operations.  The function needs five D-deep
// products per attended (q, kv) pair (Q K^T, dO V^T, P^T dO, dS^T Q and
// dS K: 10 D flops), S (S + 1) / 2 pairs per head when causal; the bytes
// (q, k, v, o, dO, lse read once, dq, dk, dv written once) are O(S D).
// This first kernel does them as f32 FMAs outside the tensor cores (67
// TFLOP/s), and the dq kernel recomputes S and dP (seven products per
// pair in all, as FlashAttention-2's backward does).  Its design: 64 x 64
// tiles in shared memory, each thread a 4 x 4 block of scores (16
// independent FMA chains) and a 4 x D/16 block of its outputs.  A
// product's operand that a thread reads as four consecutive values
// (K^T, V^T in dkdv, Q^T, dO^T in dq, and P, dS) is stored transposed
// and read as one 16-byte load; the other is read as scalars that a warp
// shares (a broadcast).  Rows are padded by 4 floats so that neither
// read has a bank conflict.  Making it fast (3xTF32 wgmma, as the forward
// does) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;  // q rows and kv rows per tile
constexpr int WARPS = THREADS / 32;
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
  void* dq;
  void* dk;
  void* dv;
  // batch, head and row strides in elements of q, k, v, o, dout, dq, dk,
  // dv; the last dimension is dense
  long long sq[3], sk[3], sv[3], so[3], sdo[3], sdq[3], sdk[3], sdv[3];
  int H;      // q heads
  int group;  // q heads per kv head
  int S;
  int D;
  int causal;
  float scale;       // 1 / sqrt(D)
  float scale_log2;  // log2(e) / sqrt(D)
};

// A block's shared-memory tiles, in floats: row-major tiles (a row's D
// values, LD apart) and transposed ones (a d's 64 values, LDT apart; also
// P and dS, a row's 64 values LDT apart).  The pads keep 16-byte rows
// and put the two rows a warp reads at once in different banks.
template <int D>
struct Tiles {
  static constexpr int LD = D + 4;
  static constexpr int LDT = TILE + 4;
  static constexpr int ROWS = TILE * LD;  // a row-major tile
  static constexpr int COLS = D * LDT;    // a transposed tile
  static constexpr int SQUARE = TILE * LDT;
  static constexpr int NJ = D / 16;  // d columns per thread: td + 16 j
  // K^T, V^T, Q, dO, P, dS, lse and Delta of a q tile
  static constexpr int DKDV_BYTES =
      (2 * COLS + 2 * ROWS + 2 * SQUARE + 2 * TILE) * 4;
  // Q^T, dO^T, K, V, dS^T
  static constexpr int DQ_BYTES = (2 * COLS + 2 * ROWS + SQUARE) * 4;
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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float at(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// rows row0 .. row0 + TILE of one head into a row-major tile: value
// (r, d) at dst[r * LD + d]; zeros past S
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long stride, int row0,
                                          int S) {
  constexpr int PER_ROW = D / 4;
  for (int idx = threadIdx.x; idx < TILE * PER_ROW; idx += THREADS) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * 4;
    const float4 x = row0 + r < S ? load4(src + (row0 + r) * stride + c)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * Tiles<D>::LD + c) = x;
  }
}

// the same rows transposed: value (r, d) at dst[d * LDT + r]; zeros past S
template <typename T, int D>
__device__ __forceinline__ void load_cols(float* dst, const T* src,
                                          long long stride, int row0,
                                          int S) {
  constexpr int PER_ROW = D / 4;
  constexpr int LDT = Tiles<D>::LDT;
  for (int idx = threadIdx.x; idx < TILE * PER_ROW; idx += THREADS) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * 4;
    const float4 x = row0 + r < S ? load4(src + (row0 + r) * stride + c)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[c * LDT + r] = x.x;
    dst[(c + 1) * LDT + r] = x.y;
    dst[(c + 2) * LDT + r] = x.z;
    dst[(c + 3) * LDT + r] = x.w;
  }
}

__device__ __forceinline__ bool attended(int row, int col, int S,
                                         int causal) {
  return row < S && col < S && !(causal && col > row);
}

// one warp per row of batch blockIdx.y: Delta = sum_d dO_d O_d in f32
template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_attention_bwd_preprocess_kernel(const Params p) {
  const int local = blockIdx.x * WARPS + threadIdx.x / 32;  // h * S + i
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
__global__ void __launch_bounds__(THREADS, D <= 64 ? 2 : 1)
    flash_attention_bwd_dkdv_kernel(const Params p) {
  using L = Tiles<D>;
  constexpr int LD = L::LD;
  constexpr int LDT = L::LDT;
  constexpr int NJ = L::NJ;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;               // K^T of this kv tile
  float* vt = kt + L::COLS;       // V^T
  float* qs = vt + L::COLS;       // Q of the current q tile
  float* dos = qs + L::ROWS;      // dO
  float* ps = dos + L::ROWS;      // P (row, kv)
  float* dss = ps + L::SQUARE;    // dS (row, kv)
  float* lse2 = dss + L::SQUARE;  // the rows' lse, in base 2
  float* dlt = lse2 + TILE;       // the rows' Delta

  const int Hkv = p.H / p.group;
  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int kv0 = blockIdx.y * TILE;  // the first (longest) tiles first
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_cols<T, D>(kt, static_cast<const T*>(p.k) + b * p.sk[0] +
                          hk * p.sk[1], p.sk[2], kv0, p.S);
  load_cols<T, D>(vt, static_cast<const T*>(p.v) + b * p.sv[0] +
                          hk * p.sv[1], p.sv[2], kv0, p.S);

  // this thread's outputs: kv rows 4 ty + i, d columns tx + 16 j
  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int n_q = (p.S + TILE - 1) / TILE;
  for (int g = 0; g < p.group; ++g) {
    const int h = hk * p.group + g;
    const T* q = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[1];
    const T* dout = static_cast<const T*>(p.dout) + b * p.sdo[0] +
                    h * p.sdo[1];
    const long long row_base = (static_cast<long long>(b) * p.H + h) * p.S;
    for (int qt = p.causal ? blockIdx.y : 0; qt < n_q; ++qt) {
      const int q0 = qt * TILE;
      __syncthreads();  // every warp is done with the previous q tile
      load_rows<T, D>(qs, q, p.sq[2], q0, p.S);
      load_rows<T, D>(dos, dout, p.sdo[2], q0, p.S);
      if (threadIdx.x < TILE) {
        const int row = q0 + threadIdx.x;
        lse2[threadIdx.x] = row < p.S ? p.lse[row_base + row] * LOG2E : 0.f;
        dlt[threadIdx.x] = row < p.S ? p.delta[row_base + row] : 0.f;
      }
      __syncthreads();

      // scores and dP: q rows ty + 16 a, kv columns 4 tx + c
      float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 kc = load4(kt + d * LDT + 4 * tx);
        const float4 vc = load4(vt + d * LDT + 4 * tx);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float qa = qs[(ty + 16 * a) * LD + d];
          const float oa = dos[(ty + 16 * a) * LD + d];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[a][c] = fmaf(qa, at(kc, c), s[a][c]);
            dp[a][c] = fmaf(oa, at(vc, c), dp[a][c]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a;
        float pr[4], dsr[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          pr[c] = attended(q0 + r, kv0 + 4 * tx + c, p.S, p.causal)
                      ? exp2f(fmaf(s[a][c], p.scale_log2, -lse2[r]))
                      : 0.f;
          dsr[c] = pr[c] * (dp[a][c] - dlt[r]);
        }
        *reinterpret_cast<float4*>(ps + r * LDT + 4 * tx) =
            make_float4(pr[0], pr[1], pr[2], pr[3]);
        *reinterpret_cast<float4*>(dss + r * LDT + 4 * tx) =
            make_float4(dsr[0], dsr[1], dsr[2], dsr[3]);
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over the tile's rows, in order
      const int rows = min(TILE, p.S - q0);
      for (int r = 0; r < rows; ++r) {
        const float4 pc = load4(ps + r * LDT + 4 * ty);
        const float4 sc = load4(dss + r * LDT + 4 * ty);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float o = dos[r * LD + tx + 16 * j];
          const float x = qs[r * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][j] = fmaf(at(pc, i), o, dv[i][j]);
            dk[i][j] = fmaf(at(sc, i), x, dk[i][j]);
          }
        }
      }
    }
  }

  T* dk_out = static_cast<T*>(p.dk) + b * p.sdk[0] + hk * p.sdk[1];
  T* dv_out = static_cast<T*>(p.dv) + b * p.sdv[0] + hk * p.sdv[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = kv0 + 4 * ty + i;
    if (row < p.S) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        store(dk_out + row * p.sdk[2] + tx + 16 * j, dk[i][j] * p.scale);
        store(dv_out + row * p.sdv[2] + tx + 16 * j, dv[i][j]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 2 : 1)
    flash_attention_bwd_dq_kernel(const Params p) {
  using L = Tiles<D>;
  constexpr int LD = L::LD;
  constexpr int LDT = L::LDT;
  constexpr int NJ = L::NJ;
  extern __shared__ __align__(16) float smem[];
  float* qt_s = smem;             // Q^T of this q tile
  float* dot_s = qt_s + L::COLS;  // dO^T
  float* ks = dot_s + L::COLS;    // K of the current kv tile
  float* vs = ks + L::ROWS;       // V
  float* dst = vs + L::ROWS;      // dS^T (kv, row)

  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int hk = h / p.group;
  const int qt = gridDim.y - 1 - blockIdx.y;  // bottom (longest) tiles first
  const int q0 = qt * TILE;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_cols<T, D>(qt_s, static_cast<const T*>(p.q) + b * p.sq[0] +
                            h * p.sq[1], p.sq[2], q0, p.S);
  load_cols<T, D>(dot_s, static_cast<const T*>(p.dout) + b * p.sdo[0] +
                             h * p.sdo[1], p.sdo[2], q0, p.S);
  // the rows 4 tx + c of the scores this thread computes
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.S;
  float lse2[4], dlt[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int row = q0 + 4 * tx + c;
    lse2[c] = row < p.S ? p.lse[row_base + row] * LOG2E : 0.f;
    dlt[c] = row < p.S ? p.delta[row_base + row] : 0.f;
  }
  const T* k = static_cast<const T*>(p.k) + b * p.sk[0] + hk * p.sk[1];
  const T* v = static_cast<const T*>(p.v) + b * p.sv[0] + hk * p.sv[1];

  // this thread's outputs: q rows 4 ty + i, d columns tx + 16 j
  float dq[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[i][j] = 0.f;

  const int last_row = min(p.S, q0 + TILE) - 1;
  const int n_kv = p.causal ? last_row / TILE + 1 : (p.S + TILE - 1) / TILE;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int kv0 = kt * TILE;
    __syncthreads();  // every warp is done with the previous kv tile
    load_rows<T, D>(ks, k, p.sk[2], kv0, p.S);
    load_rows<T, D>(vs, v, p.sv[2], kv0, p.S);
    __syncthreads();

    // scores and dP: kv columns ty + 16 a, q rows 4 tx + c
    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qc = load4(qt_s + d * LDT + 4 * tx);
      const float4 oc = load4(dot_s + d * LDT + 4 * tx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float ka = ks[(ty + 16 * a) * LD + d];
        const float va = vs[(ty + 16 * a) * LD + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[a][c] = fmaf(at(qc, c), ka, s[a][c]);
          dp[a][c] = fmaf(at(oc, c), va, dp[a][c]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int col = ty + 16 * a;
      float dsr[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pr =
            attended(q0 + 4 * tx + c, kv0 + col, p.S, p.causal)
                ? exp2f(fmaf(s[a][c], p.scale_log2, -lse2[c]))
                : 0.f;
        dsr[c] = pr * (dp[a][c] - dlt[c]);
      }
      *reinterpret_cast<float4*>(dst + col * LDT + 4 * tx) =
          make_float4(dsr[0], dsr[1], dsr[2], dsr[3]);
    }
    __syncthreads();

    // dQ += dS K over the tile's kv rows, in order
    const int cols = min(TILE, p.S - kv0);
    for (int c = 0; c < cols; ++c) {
      const float4 sc = load4(dst + c * LDT + 4 * ty);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float x = ks[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][j] = fmaf(at(sc, i), x, dq[i][j]);
      }
    }
  }

  T* dq_out = static_cast<T*>(p.dq) + b * p.sdq[0] + h * p.sdq[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row < p.S) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        store(dq_out + row * p.sdq[2] + tx + 16 * j, dq[i][j] * p.scale);
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

template <typename T, int D>
cudaError_t launch_d(const Params& p, int B, int device,
                     cudaStream_t stream) {
  using L = Tiles<D>;
  static bool dkdv_allowed[MAX_DEVICES] = {};
  static bool dq_allowed[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(flash_attention_bwd_dkdv_kernel<T, D>,
                               L::DKDV_BYTES, dkdv_allowed, device);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_attention_bwd_dq_kernel<T, D>, L::DQ_BYTES,
                   dq_allowed, device);
  if (err != cudaSuccess) return err;

  const int tiles = (p.S + TILE - 1) / TILE;
  flash_attention_bwd_preprocess_kernel<T>
      <<<dim3((p.H * p.S + WARPS - 1) / WARPS, B), THREADS, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dkdv_kernel<T, D>
      <<<dim3(B * (p.H / p.group), tiles), THREADS, L::DKDV_BYTES,
         stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dq_kernel<T, D>
      <<<dim3(B * p.H, tiles), THREADS, L::DQ_BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params& p, int B, int device, cudaStream_t stream) {
  switch (p.D) {
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

// q, o, dout, dq: (B, H, S, D); k, v, dk, dv: (B, Hkv, S, D); lse and
// delta: (B, H, S) f32 contiguous (lse from the forward kernel, delta
// scratch written here).  strides: 24 int64 values, the batch, head and
// row strides of q, k, v, o, dout, dq, dk and dv in that order, each a
// multiple of 4 elements, with 16-byte aligned starts.  dtype: 0 f32,
// 1 bf16 (all eight tensors).  D: 32, 64, 80, 112 or 128.  Launches the
// three kernels on ``stream`` without synchronizing; returns the first
// cudaGetLastError() that is not 0, else 0.  ``device`` is the card that
// ``stream`` and the tensors belong to.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const float* lse, float* delta, void* dq,
                              void* dk, void* dv, const long long* strides,
                              int dtype, int B, int H, int Hkv, int S, int D,
                              int causal, int device, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || Hkv < 1 || H % Hkv || S < 1 ||
      (S + TILE - 1) / TILE > 65535 ||
      static_cast<long long>(H) * S > 2147483647LL ||
      device < 0 || device >= MAX_DEVICES)
    return cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  long long* dst[8] = {p.sq, p.sk, p.sv, p.so, p.sdo, p.sdq, p.sdk, p.sdv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  p.H = H;
  p.group = H / Hkv;
  p.S = S;
  p.D = D;
  p.causal = causal;
  p.scale = 1.f / sqrtf(static_cast<float>(D));
  p.scale_log2 = LOG2E * p.scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0   ? launch<float>(p, B, device, s)
                          : dtype == 1 ? launch<__nv_bfloat16>(p, B, device, s)
                                       : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
