// Flash-attention backward, dK and dV, for Hopper (sm_90a): bf16 / fp16 in, fp32
// accumulation.
//
// Replaces: difashion_tpu/nn/pallas/flash_attention.py::_dkv_kernel (reached through
// _backward, the custom VJP of flash_attention): the key and value gradients of
// every UNet attention of the training step.
//
// What it computes, for one (batch, head) and a tile of 64 KV rows per block,
// looping over 64-row query tiles, all in the transposed orientation:
//   S^T  = K Q^T,  P^T = exp2(scale*log2(e) * S^T - LSE*log2(e))  (LSE per column)
//   dP^T = V dO^T
//   dS^T = P^T * (dP^T - D),  D = rowsum(dO * O) per column (computed before the kernel)
//   dV  += P^T dO,  dK += scale * dS^T Q
// P and dS are rounded to the input type before their products, as the TPU kernel
// rounds them. Computing S^T rather than S leaves the fp32 accumulators already in
// the A-operand layout of P^T dO and dS^T Q: both products take their left operand
// from registers. Query columns >= Sq are zero-filled on load and get P = 0 (their
// LSE and D are never written); KV rows >= Skv get P = 0 and are not stored. No
// atomics: each block owns its dK/dV rows, so results are the same from run to run.
//
// What bounds it on the H100: the four products, 8*B*H*Sq*Skv*d operations. At the
// training UNet's 4096-token self-attention (batch 8, 5 heads, d = 64) that is
// 344 GFLOP against 127 MB of q/k/v/dO/LSE/D/dK/dV: tensor-core bound (0.35 ms at
// 989 TFLOP/s). At the 77-token cross-attention it is memory bound, and there the
// grid is small (two KV tiles per batch-head, 80 blocks at batch 8 x 5 heads, fewer
// than the card's 132 SMs), each block streaming every q/dO tile: a known weak
// spot of this first design (a split over the query range with a second reduction
// pass is the later fix).
//
// What the design does about it: K and V fragments stay in registers for the whole
// query loop; S^T and dP^T never leave registers; Q and dO tiles (and their LSE
// and D values) are double-buffered in shared memory with cp.async, and read
// transposed with ldmatrix for the P^T dO and dS^T Q products. wgmma and TMA are
// later work.
//
// Interface: plain C (loaded with ctypes). Tensors are addressed by element strides
// for batch, head and sequence (the last dim is contiguous): the [B, S, H, D] views
// of the projections are read in place and dK/dV are written in the layout given.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, int H, int Sq, int Skv,
                 int64_t q_sb, int64_t q_sh, int64_t q_ss,
                 int64_t k_sb, int64_t k_sh, int64_t k_ss,
                 int64_t v_sb, int64_t v_sh, int64_t v_ss,
                 int64_t do_sb, int64_t do_sh, int64_t do_ss,
                 int64_t dk_sb, int64_t dk_sh, int64_t dk_ss,
                 int64_t dv_sb, int64_t dv_sh, int64_t dv_ss,
                 float scale, float scale_log2) {
  constexpr int LD = D + kPad;
  constexpr int NT_Q = kTile / 8;   // n-tiles of S^T and dP^T
  constexpr int NT_D = D / 8;       // n-tiles of dK and dV

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + kTile * LD;
  T* sQ = sV + kTile * LD;          // 2 buffers
  T* sDO = sQ + 2 * kTile * LD;     // 2 buffers
  float* sL = reinterpret_cast<float*>(sDO + 2 * kTile * LD);  // 2 buffers
  float* sD = sL + 2 * kTile;                                   // 2 buffers

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kv0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* dob = dout + b * do_sb + h * do_sh;
  const float* lb = lse + static_cast<int64_t>(bh) * Sq;
  const float* db = delta + static_cast<int64_t>(bh) * Sq;
  const int n_q = (Sq + kTile - 1) / kTile;

  load_tile<T, D, kTile>(sK, k + b * k_sb + h * k_sh + static_cast<int64_t>(kv0) * k_ss,
                         k_ss, Skv - kv0);
  load_tile<T, D, kTile>(sV, v + b * v_sb + h * v_sh + static_cast<int64_t>(kv0) * v_ss,
                         v_ss, Skv - kv0);
  load_tile<T, D, kTile>(sQ, qb, q_ss, Sq);
  load_tile<T, D, kTile>(sDO, dob, do_ss, Sq);
  load_row_vector(sL, lb, Sq, 0);
  load_row_vector(sD, db, Sq, kTile);
  cp_async_commit();

  // rows g and g+8 of this warp: KV rows >= Skv get P = 0 and are not stored
  const int r0 = kv0 + warp * 16 + g;
  const int rows[2] = {r0, r0 + 8};

  uint32_t ka[D / 16][4], va[D / 16][4];
  float dk_acc[NT_D][4] = {};
  float dv_acc[NT_D][4] = {};

  for (int i = 0; i < n_q; ++i) {
    const int buf = i & 1;
    if (i + 1 < n_q) {
      const int nb = buf ^ 1;
      const int q_next = (i + 1) * kTile;
      const int64_t off = q_next;
      load_tile<T, D, kTile>(sQ + nb * kTile * LD, qb + off * q_ss, q_ss, Sq - q_next);
      load_tile<T, D, kTile>(sDO + nb * kTile * LD, dob + off * do_ss, do_ss, Sq - q_next);
      load_row_vector(sL + nb * kTile, lb + q_next, Sq - q_next, 0);
      load_row_vector(sD + nb * kTile, db + q_next, Sq - q_next, kTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (i == 0) {
      load_a_frags<T, D>(ka, sK + warp * 16 * LD, g, t);
      load_a_frags<T, D>(va, sV + warp * 16 * LD, g, t);
    }
    const T* qt = sQ + buf * kTile * LD;
    const T* dot = sDO + buf * kTile * LD;
    const float* lt = sL + buf * kTile;
    const float* dt = sD + buf * kTile;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 KV rows x 64 query columns.
    float s[NT_Q][4] = {};
    float dp[NT_Q][4] = {};
    mma_rows_t<T, D>(s, ka, qt, g, t);
    mma_rows_t<T, D>(dp, va, dot, g, t);

    // P^T and dS^T; the LSE and D of a column come from the shared tile.
    const int q0 = i * kTile;
    const bool ragged = q0 + kTile > Sq;
#pragma unroll
    for (int n = 0; n < NT_Q; ++n) {
      const int c = n * 8 + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(lt + c);
      const float2 d2 = *reinterpret_cast<const float2*>(dt + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool odd = e & 1;
        float p = fast_exp2(fmaf(s[n][e], scale_log2, -(odd ? l2.y : l2.x) * kLog2e));
        if ((ragged && q0 + c + odd >= Sq) || rows[e >> 1] >= Skv) p = 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - (odd ? d2.y : d2.x));
      }
    }

    // dV += P^T dO and dK += dS^T Q: left operands from the accumulators (rounded
    // to T), dO and Q read transposed.
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4], dsa[4];
      pack_a<T>(pa, s[2 * kk], s[2 * kk + 1]);
      pack_a<T>(dsa, dp[2 * kk], dp[2 * kk + 1]);
      mma_a_tile<T, D>(dv_acc, pa, dot, kk, lane);
      mma_a_tile<T, D>(dk_acc, dsa, qt, kk, lane);
    }
    __syncthreads();  // the buffer is refilled at iteration i + 1
  }

  T* dkb = dk + b * dk_sb + h * dk_sh;
  T* dvb = dv + b * dv_sb + h * dv_sh;
#pragma unroll
  for (int n = 0; n < NT_D; ++n) {
    const int c = n * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] < Skv) {
        const int64_t row = rows[r];
        *reinterpret_cast<uint32_t*>(dkb + row * dk_ss + c) =
            MmaOp<T>::pack(dk_acc[n][2 * r] * scale, dk_acc[n][2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvb + row * dv_ss + c) =
            MmaOp<T>::pack(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv, int B, int H,
           int Sq, int Skv, const int64_t* st, float scale, cudaStream_t stream) {
  constexpr int LD = D + kPad;
  constexpr int smem = 6 * kTile * LD * static_cast<int>(sizeof(T)) +
                       4 * kTile * static_cast<int>(sizeof(float));
  auto kern = flash_dkv_kernel<T, D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((Skv + kTile - 1) / kTile, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      H, Sq, Skv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12], st[13], st[14], st[15], st[16], st[17],
      scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv, int B, int H,
               int Sq, int Skv, int D, const int64_t* st, float scale,
               cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv, st, scale, stream);
    case 32: return launch<T, 32>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv, st, scale, stream);
    case 64: return launch<T, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv, st, scale, stream);
    case 128: return launch<T, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv, st, scale, stream);
    default: return -1;
  }
}

}  // namespace

// strides: 18 element strides, (batch, head, seq) for q, k, v, dout, dk, dv in that
// order. lse, delta: [B*H, Sq] fp32, contiguous. dtype: 0 = bf16, 1 = fp16.
// Returns cudaGetLastError() after the launch, or -1 for a head dim / dtype the
// kernel does not take.
extern "C" int flash_attention_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse,
                                   const float* delta, void* dk, void* dv, int B,
                                   int H, int Sq, int Skv, int D,
                                   const int64_t* strides, float scale, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv,
                                     D, strides, scale, s);
  if (dtype == 1)
    return dispatch_d<__half>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv, D,
                              strides, scale, s);
  return -1;
}
