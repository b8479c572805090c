// Flash attention in fp32 for Hopper (sm_90a): forward, dQ and dK/dV on fp32 q, k, v,
// fp32 throughout.
//
// Replaces, for fp32 inputs: difashion_tpu/nn/pallas/flash_attention.py::_fwd_kernel
// (through _forward), ::_dq_kernel and ::_dkv_kernel (through _backward). The
// JAX package sends fp32 q/k/v into the same Pallas kernels as bf16 ones (its
// gate has no dtype test), and they compute fp32 dots on fp32 input; a model
// built with mixed_precision other than "bf16" runs every UNet attention here.
//
// What they compute: the same functions as flash_attention_fwd.cu,
// flash_attention_dq.cu and flash_attention_dkv.cu, for any head dim d <= 128
// (the tiles are DP = 32, 64 or 128 columns wide, columns d..DP-1 zero):
//   forward: O = softmax(scale * Q K^T) V and the natural-log LSE, [B*H, Sq];
//   dQ:      dQ = scale * [P * (dO V^T - D)] K, P = exp(scale * Q K^T - LSE);
//   dK/dV:   dV = P^T dO, dK = scale * [P * (dO V^T - D)]^T Q.
// Online softmax over 64-row KV tiles in the base-2 domain with the precise
// exp2f; columns >= Skv masked in place (-inf in the forward, P = 0 in the
// backward); rows past Sq or Skv zero-filled on load and not stored. No tf32 and
// no rounding to 16 bits anywhere, no atomics (each block owns its output rows).
//
// What bounds them on the H100: fp32 FFMA, 67 TFLOP/s outside the tensor cores
// (a 4096-token self-attention of 5 heads at batch 16 is 344 GFLOP: 5 ms at
// best). They are off every bf16 path, so the design is the simple one: a
// block of 256 threads owns 64 rows; each KV (or Q) tile is copied into shared
// memory with rows padded by one float, so that a thread's 4 x 4 share of the
// 64 x 64 score tile (rows ty + 16i, columns tx + 16j) reads conflict-free;
// the scores go through shared memory, where 4 threads a row run the softmax,
// and the products with V, K, dO or Q read them back.
//
// Interface: plain C (loaded with ctypes), the same arguments as the 16-bit
// kernels (dtype 2 = fp32). Tensors are addressed by element strides for batch,
// head and sequence (the last dim contiguous, any other strides).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;       // rows of every tile
constexpr int kThreads = 256;   // 16 x 16: thread (ty, tx) owns rows ty + 16i, columns tx + 16j
constexpr int kLDS = kRows + 1; // padded row of a 64 x 64 score tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// `valid` rows of d columns (row r at src + r * stride) into a [64][DP + 1]
// tile; the other rows and columns zero.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int64_t stride,
                                          int valid, int d) {
  for (int i = threadIdx.x; i < kRows * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    dst[r * (DP + 1) + c] = (r < valid && c < d) ? src[int64_t(r) * stride + c] : 0.f;
  }
}

// acc[i][j] = sum_c A[ty + 16i][c] * B[tx + 16j][c]: this thread's share of the
// product of two [64][DP + 1] tiles, the second read as transposed.
template <int DP>
__device__ __forceinline__ void tile_abt(float (&acc)[4][4], const float* A, const float* B,
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < DP; ++c) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (DP + 1) + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * (DP + 1) + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// out[i][j] += sum_k M[ty + 16i][k] * V[k][tx + 16j]: a [64][kLDS] score tile
// times a [64][DP + 1] tile.
template <int DP>
__device__ __forceinline__ void tile_mv(float (&out)[4][DP / 16], const float* M, const float* V,
                                        int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < kRows; ++k) {
    float mm[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) mm[i] = M[(ty + 16 * i) * kLDS + k];
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      const float vv = V[k * (DP + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) out[i][j] = fmaf(mm[i], vv, out[i][j]);
    }
  }
}

// Rows < valid and columns < d of this thread's share of a 64-row result, times f.
template <int DP>
__device__ __forceinline__ void store_rows(float* dst, int64_t stride,
                                           const float (&acc)[4][DP / 16], int valid, int d,
                                           float f, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= valid) continue;
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      const int c = tx + 16 * j;
      if (c < d) dst[int64_t(r) * stride + c] = acc[i][j] * f;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
               int H, int Sq, int Skv, int d, int64_t q_sb, int64_t q_sh, int64_t q_ss,
               int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
               int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss, float scale_log2) {
  constexpr int LD = DP + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kRows * LD;
  float* sV = sK + kRows * LD;
  float* sP = sV + kRows * LD;       // [64][kLDS]: scores, then probabilities
  float* sAlpha = sP + kRows * kLDS; // [64]
  float* sL = sAlpha + kRows;        // [64]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int sr = tid / 4, sp = tid % 4;   // the softmax's row and quarter of it
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  load_tile<DP>(sQ, q + b * q_sb + h * q_sh + int64_t(q0) * q_ss, q_ss, Sq - q0, d);
  float acc[4][DP / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) acc[i][j] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;   // row sr, base 2, kept by its 4 threads

  for (int kv0 = 0; kv0 < Skv; kv0 += kRows) {
    __syncthreads();   // the previous tile's readers are done
    load_tile<DP>(sK, kb + int64_t(kv0) * k_ss, k_ss, Skv - kv0, d);
    load_tile<DP>(sV, vb + int64_t(kv0) * v_ss, v_ss, Skv - kv0, d);
    __syncthreads();
    float s[4][4];
    tile_abt<DP>(s, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sP[(ty + 16 * i) * kLDS + tx + 16 * j] =
            kv0 + tx + 16 * j < Skv ? s[i][j] * scale_log2 : -INFINITY;
    __syncthreads();
    float* row = sP + sr * kLDS + sp * 16;
    float mx = m_run;
#pragma unroll
    for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
    const float alpha = exp2f(m_run - mx);   // 0 on the first tile
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const float p = exp2f(row[c] - mx);
      row[c] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffff, sum, 1);
    sum += __shfl_xor_sync(0xffffffff, sum, 2);
    l_run = l_run * alpha + sum;
    m_run = mx;
    if (sp == 0) sAlpha[sr] = alpha;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sAlpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DP / 16; ++j) acc[i][j] *= a;
    }
    tile_mv<DP>(acc, sP, sV, ty, tx);
  }
  if (sp == 0) {
    sL[sr] = l_run;
    if (q0 + sr < Sq) lse[int64_t(bh) * Sq + q0 + sr] = m_run * kLn2 + logf(l_run);
  }
  __syncthreads();
  float* ob = o + b * o_sb + h * o_sh + int64_t(q0) * o_ss;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= Sq) continue;
    const float inv = 1.f / sL[r];
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      const int c = tx + 16 * j;
      if (c < d) ob[int64_t(r) * o_ss + c] = acc[i][j] * inv;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int H, int Sq, int Skv, int d,
              int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
              int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t do_sb,
              int64_t do_sh, int64_t do_ss, int64_t dq_sb, int64_t dq_sh, int64_t dq_ss,
              float scale, float scale_log2) {
  constexpr int LD = DP + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + kRows * LD;
  float* sK = sDO + kRows * LD;
  float* sV = sK + kRows * LD;
  float* sS = sV + kRows * LD;        // [64][kLDS]: dS
  float* sLse = sS + kRows * kLDS;    // [64], base 2
  float* sD = sLse + kRows;           // [64]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  load_tile<DP>(sQ, q + b * q_sb + h * q_sh + int64_t(q0) * q_ss, q_ss, Sq - q0, d);
  load_tile<DP>(sDO, dout + b * do_sb + h * do_sh + int64_t(q0) * do_ss, do_ss, Sq - q0, d);
  if (tid < kRows) {
    const bool ok = q0 + tid < Sq;
    const int64_t i = int64_t(bh) * Sq + q0 + tid;
    sLse[tid] = ok ? lse[i] * kLog2e : INFINITY;   // P = 0 on rows past Sq
    sD[tid] = ok ? delta[i] : 0.f;
  }
  float acc[4][DP / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) acc[i][j] = 0.f;

  for (int kv0 = 0; kv0 < Skv; kv0 += kRows) {
    __syncthreads();
    load_tile<DP>(sK, kb + int64_t(kv0) * k_ss, k_ss, Skv - kv0, d);
    load_tile<DP>(sV, vb + int64_t(kv0) * v_ss, v_ss, Skv - kv0, d);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_abt<DP>(s, sQ, sK, ty, tx);
    tile_abt<DP>(dp, sDO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = kv0 + c < Skv ? exp2f(fmaf(s[i][j], scale_log2, -sLse[r])) : 0.f;
        sS[r * kLDS + c] = p * (dp[i][j] - sD[r]);
      }
    }
    __syncthreads();
    tile_mv<DP>(acc, sS, sK, ty, tx);
  }
  store_rows<DP>(dq + b * dq_sb + h * dq_sh + int64_t(q0) * dq_ss, dq_ss, acc, Sq - q0, d,
                 scale, ty, tx);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int H, int Sq, int Skv, int d,
               int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
               int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t do_sb,
               int64_t do_sh, int64_t do_ss, int64_t dk_sb, int64_t dk_sh, int64_t dk_ss,
               int64_t dv_sb, int64_t dv_sh, int64_t dv_ss, float scale, float scale_log2) {
  constexpr int LD = DP + 1;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kRows * LD;
  float* sQ = sV + kRows * LD;
  float* sDO = sQ + kRows * LD;
  float* sP = sDO + kRows * LD;       // [64 kv][kLDS]: P^T
  float* sS = sP + kRows * kLDS;      // [64 kv][kLDS]: dS^T
  float* sLse = sS + kRows * kLDS;    // [64 q], base 2
  float* sD = sLse + kRows;           // [64 q]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kv0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* dob = dout + b * do_sb + h * do_sh;

  load_tile<DP>(sK, k + b * k_sb + h * k_sh + int64_t(kv0) * k_ss, k_ss, Skv - kv0, d);
  load_tile<DP>(sV, v + b * v_sb + h * v_sh + int64_t(kv0) * v_ss, v_ss, Skv - kv0, d);
  float dka[4][DP / 16], dva[4][DP / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int q0 = 0; q0 < Sq; q0 += kRows) {
    __syncthreads();
    load_tile<DP>(sQ, qb + int64_t(q0) * q_ss, q_ss, Sq - q0, d);
    load_tile<DP>(sDO, dob + int64_t(q0) * do_ss, do_ss, Sq - q0, d);
    if (tid < kRows) {
      const bool ok = q0 + tid < Sq;
      const int64_t i = int64_t(bh) * Sq + q0 + tid;
      sLse[tid] = ok ? lse[i] * kLog2e : INFINITY;   // P = 0 on query rows past Sq
      sD[tid] = ok ? delta[i] : 0.f;
    }
    __syncthreads();
    float st[4][4], dpt[4][4];
    tile_abt<DP>(st, sK, sQ, ty, tx);     // S^T: rows kv, columns q
    tile_abt<DP>(dpt, sV, sDO, ty, tx);   // dP^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = exp2f(fmaf(st[i][j], scale_log2, -sLse[c]));
        sP[r * kLDS + c] = p;
        sS[r * kLDS + c] = p * (dpt[i][j] - sD[c]);
      }
    }
    __syncthreads();
    tile_mv<DP>(dva, sP, sDO, ty, tx);   // dV += P^T dO
    tile_mv<DP>(dka, sS, sQ, ty, tx);    // dK += dS^T Q
  }
  store_rows<DP>(dk + b * dk_sb + h * dk_sh + int64_t(kv0) * dk_ss, dk_ss, dka, Skv - kv0, d,
                 scale, ty, tx);
  store_rows<DP>(dv + b * dv_sb + h * dv_sh + int64_t(kv0) * dv_ss, dv_ss, dva, Skv - kv0, d,
                 1.f, ty, tx);
}

// Shared memory above 48 KB is granted on request, once per kernel.
template <typename K>
cudaError_t allow_smem(K kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

constexpr int tile_bytes(int dp) { return kRows * (dp + 1) * 4; }
constexpr int scores_bytes() { return kRows * kLDS * 4; }

template <int DP>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int Sq,
        int Skv, int D, const int64_t* st, float scale, cudaStream_t stream) {
  constexpr int smem = 3 * tile_bytes(DP) + scores_bytes() + 2 * kRows * 4;
  static const cudaError_t attr = allow_smem(fwd_f32_kernel<DP>, smem);
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid((Sq + kRows - 1) / kRows, B * H);
  fwd_f32_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, H, Sq, Skv, D, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale * kLog2e);
  return int(cudaGetLastError());
}

template <int DP>
int dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
       const float* delta, void* dqp, int B, int H, int Sq, int Skv, int D, const int64_t* st,
       float scale, cudaStream_t stream) {
  constexpr int smem = 4 * tile_bytes(DP) + scores_bytes() + 2 * kRows * 4;
  static const cudaError_t attr = allow_smem(dq_f32_kernel<DP>, smem);
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid((Sq + kRows - 1) / kRows, B * H);
  dq_f32_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dqp), H, Sq, Skv, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      st[12], st[13], st[14], scale, scale * kLog2e);
  return int(cudaGetLastError());
}

template <int DP>
int dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
        const float* delta, void* dkp, void* dvp, int B, int H, int Sq, int Skv, int D,
        const int64_t* st, float scale, cudaStream_t stream) {
  constexpr int smem = 4 * tile_bytes(DP) + 2 * scores_bytes() + 2 * kRows * 4;
  static const cudaError_t attr = allow_smem(dkv_f32_kernel<DP>, smem);
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid((Skv + kRows - 1) / kRows, B * H);
  dkv_f32_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dkp),
      static_cast<float*>(dvp), H, Sq, Skv, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14], st[15], st[16], st[17], scale,
      scale * kLog2e);
  return int(cudaGetLastError());
}

bool args_ok(int B, int H, int Sq, int Skv, int D, int dtype) {
  return dtype == 2 && B > 0 && H > 0 && Sq > 0 && Skv > 0 && D > 0 && D <= 128 &&
         int64_t(B) * H <= 65535;
}

}  // namespace

// Each returns cudaGetLastError() after the launch, or -1 for arguments it does
// not take (dtype other than 2 = fp32, a head dim above 128). Strides as in the
// 16-bit kernels: (batch, head, seq) per tensor, in the argument order.
extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                       float* lse, int B, int H, int Sq, int Skv, int D,
                                       const int64_t* strides, float scale, int dtype,
                                       void* stream) {
  if (!args_ok(B, H, Sq, Skv, D, dtype)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return fwd<32>(q, k, v, o, lse, B, H, Sq, Skv, D, strides, scale, s);
  if (D <= 64) return fwd<64>(q, k, v, o, lse, B, H, Sq, Skv, D, strides, scale, s);
  return fwd<128>(q, k, v, o, lse, B, H, Sq, Skv, D, strides, scale, s);
}

extern "C" int flash_attention_dq_f32(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse, const float* delta,
                                      void* dqp, int B, int H, int Sq, int Skv, int D,
                                      const int64_t* strides, float scale, int dtype,
                                      void* stream) {
  if (!args_ok(B, H, Sq, Skv, D, dtype)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return dq<32>(q, k, v, dout, lse, delta, dqp, B, H, Sq, Skv, D, strides, scale, s);
  if (D <= 64) return dq<64>(q, k, v, dout, lse, delta, dqp, B, H, Sq, Skv, D, strides, scale, s);
  return dq<128>(q, k, v, dout, lse, delta, dqp, B, H, Sq, Skv, D, strides, scale, s);
}

extern "C" int flash_attention_dkv_f32(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* delta,
                                       void* dkp, void* dvp, int B, int H, int Sq, int Skv,
                                       int D, const int64_t* strides, float scale, int dtype,
                                       void* stream) {
  if (!args_ok(B, H, Sq, Skv, D, dtype)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return dkv<32>(q, k, v, dout, lse, delta, dkp, dvp, B, H, Sq, Skv, D, strides, scale, s);
  if (D <= 64)
    return dkv<64>(q, k, v, dout, lse, delta, dkp, dvp, B, H, Sq, Skv, D, strides, scale, s);
  return dkv<128>(q, k, v, dout, lse, delta, dkp, dvp, B, H, Sq, Skv, D, strides, scale, s);
}
