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
// Bound on an H100 SXM: compute.  Causal attention does about
// 2 * B * H * S^2 * D flops (two D-deep products per (q, kv) pair, S^2/2
// pairs), against 67 TFLOP/s of f32 FMA outside the tensor cores; the
// bytes (q, k, v read once, o written once) are O(S * D) and take
// microseconds.  So the design spends its effort on keeping the FMA units
// fed from registers and shared memory, and nothing on device memory:
//
//  * One block of 64 threads per (batch * head, 64-row q tile); thread t
//    owns q row t of the tile: its scaled q row, its running max m, sum l
//    and the 64-wide accumulator live in registers for the whole kv loop.
//    The loop over kv tiles (only up to the diagonal when causal) takes
//    the place of the Pallas kernel's sequential kv grid axis and its
//    @pl.when skip.
//  * Each 64-row K tile (stored transposed) and V tile is staged in
//    shared memory as f32 (2 x 16 KB at D = 64, under the 48 KB static
//    limit).  Every thread reads the same shared address at the same
//    time, a broadcast, as a 16-byte vector: one shared load feeds four
//    FMAs, in both products.
//  * Scores are taken 32 kv columns at a time, so q (64), acc (64) and
//    the scores (32) fit in registers without spilling.  The softmax runs
//    in base 2 (q pre-scaled by log2(e) / sqrt(D), exp2f), which is the
//    same function as exp of the unscaled scores.
//  * The grid's slow axis walks the q tiles from the bottom up, so the
//    longest causal rows are scheduled first and the short ones fill the
//    tail.
//
// Tensor cores (TF32 or bf16 wgmma), TMA and double-buffered tiles are
// later work; this kernel is the simple, exact f32 version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int BLOCK_Q = 64;   // q rows per block, one per thread
constexpr int BLOCK_KV = 64;  // kv rows staged per tile
constexpr int SUB = 32;       // kv columns scored at a time
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // batch, head and row strides in elements; the last dimension is dense
  long long sq[3], sk[3], sv[3], so[3];
  int H;      // q heads
  int group;  // q heads per kv head
  int S;
  int causal;
  float scale_log2;  // log2(e) / sqrt(D)
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

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  memcpy(&u.x, &lo, sizeof(lo));
  memcpy(&u.y, &hi, sizeof(hi));
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T, int D>
__global__ void __launch_bounds__(BLOCK_Q)
    flash_attention_kernel(const Params p) {
  __shared__ __align__(16) float k_t[D][BLOCK_KV];  // K tile, transposed
  __shared__ __align__(16) float v_s[BLOCK_KV][D];

  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int hk = h / p.group;
  const int qt = gridDim.y - 1 - blockIdx.y;  // bottom (longest) tiles first
  const int t = threadIdx.x;
  const int row = qt * BLOCK_Q + t;
  const bool row_ok = row < p.S;

  const T* q = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const T* k = static_cast<const T*>(p.k) + b * p.sk[0] + hk * p.sk[1];
  const T* v = static_cast<const T*>(p.v) + b * p.sv[0] + hk * p.sv[1];
  T* o = static_cast<T*>(p.o) + b * p.so[0] + h * p.so[1];

  float qr[D];
  {
    // a row past S reads row 0 and is never stored
    const T* q_row = q + (row_ok ? row : 0) * p.sq[2];
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 x = load4(q_row + d);
      qr[d] = x.x * p.scale_log2;
      qr[d + 1] = x.y * p.scale_log2;
      qr[d + 2] = x.z * p.scale_log2;
      qr[d + 3] = x.w * p.scale_log2;
    }
  }
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = NEG_INF;
  float l = 0.f;

  const int n_kv = p.causal ? qt + 1 : (p.S + BLOCK_KV - 1) / BLOCK_KV;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int kv0 = kt * BLOCK_KV;
    __syncthreads();  // every thread is done with the previous tile
    // K: neighbouring threads take neighbouring rows, so the transposed
    // stores land in distinct banks
    for (int i = t; i < BLOCK_KV * (D / 4); i += BLOCK_Q) {
      const int j = i % BLOCK_KV;
      const int d = (i / BLOCK_KV) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kv0 + j < p.S) x = load4(k + (kv0 + j) * p.sk[2] + d);
      k_t[d][j] = x.x;
      k_t[d + 1][j] = x.y;
      k_t[d + 2][j] = x.z;
      k_t[d + 3][j] = x.w;
    }
    // V: neighbouring threads take neighbouring columns of one row
    for (int i = t; i < BLOCK_KV * (D / 4); i += BLOCK_Q) {
      const int j = i / (D / 4);
      const int d = (i % (D / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kv0 + j < p.S) x = load4(v + (kv0 + j) * p.sv[2] + d);
      *reinterpret_cast<float4*>(&v_s[j][d]) = x;
    }
    __syncthreads();

    // the diagonal tile and a ragged last tile need the element mask
    const bool masked = (p.causal && kt == qt) || kv0 + BLOCK_KV > p.S;
#pragma unroll 1
    for (int c = 0; c < BLOCK_KV; c += SUB) {
      float s[SUB];
#pragma unroll
      for (int j = 0; j < SUB; ++j) s[j] = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
#pragma unroll
        for (int j = 0; j < SUB; j += 4) {
          const float4 kk =
              *reinterpret_cast<const float4*>(&k_t[d][c + j]);
          s[j] = fmaf(qr[d], kk.x, s[j]);
          s[j + 1] = fmaf(qr[d], kk.y, s[j + 1]);
          s[j + 2] = fmaf(qr[d], kk.z, s[j + 2]);
          s[j + 3] = fmaf(qr[d], kk.w, s[j + 3]);
        }
      }
      if (masked) {
#pragma unroll
        for (int j = 0; j < SUB; ++j) {
          const int col = kv0 + c + j;
          if (col >= p.S || (p.causal && col > row)) s[j] = NEG_INF;
        }
      }
      // online softmax.  Column 0 is valid for every row (causal) and the
      // first tile holds a valid column (full), so a valid row has a
      // finite running max before any masked column is seen: a masked
      // column's exp2f(-1e30 - m) is exactly 0.
      float m_new = m;
#pragma unroll
      for (int j = 0; j < SUB; ++j) m_new = fmaxf(m_new, s[j]);
      const float alpha = exp2f(m - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        s[j] = exp2f(s[j] - m_new);
        row_sum += s[j];
      }
      l = l * alpha + row_sum;
      m = m_new;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&v_s[c + j][d]);
          acc[d] = fmaf(s[j], vv.x, acc[d]);
          acc[d + 1] = fmaf(s[j], vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(s[j], vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(s[j], vv.w, acc[d + 3]);
        }
      }
    }
  }

  if (row_ok) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* o_row = o + row * p.so[2];
#pragma unroll
    for (int d = 0; d < D; d += 4)
      store4(o_row + d, acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv,
             acc[d + 3] * inv);
  }
}

template <typename T>
cudaError_t launch(const Params& p, int B, int D, cudaStream_t stream) {
  const dim3 grid(B * p.H, (p.S + BLOCK_Q - 1) / BLOCK_Q);
  if (D == 64)
    flash_attention_kernel<T, 64><<<grid, BLOCK_Q, 0, stream>>>(p);
  else if (D == 32)
    flash_attention_kernel<T, 32><<<grid, BLOCK_Q, 0, stream>>>(p);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: (B, H, S, D); k, v: (B, Hkv, S, D).  strides: 12 int64 values, the
// batch, head and row strides of q, k, v and o in that order.  dtype: 0 f32,
// 1 bf16 (all four tensors).  D: 32 or 64.  Launches on ``stream`` without
// synchronizing; returns cudaGetLastError() after the launch (0 = success).
// ``device`` is the card that ``stream`` and the tensors belong to: this
// library carries its own CUDA runtime, whose current device is set here.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, const long long* strides, int dtype, int B,
                          int H, int Hkv, int S, int D, int causal,
                          int device, void* stream) {
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
  const cudaError_t err = dtype == 0 ? launch<float>(p, B, D, s)
                          : dtype == 1
                              ? launch<__nv_bfloat16>(p, B, D, s)
                              : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
