// Flash-attention backward, dQ, for Hopper (sm_90a): bf16 / fp16 in, fp32 accumulation.
//
// Replaces: difashion_tpu/nn/pallas/flash_attention.py::_dq_kernel (reached through
// _backward, the custom VJP of flash_attention): the query gradient of every UNet
// attention of the training step.
//
// What it computes, for one (batch, head) and a tile of 64 query rows per block,
// looping over 64-row KV tiles:
//   P  = exp2(scale*log2(e) * Q K^T - LSE*log2(e))   (recomputed from the forward's LSE)
//   dP = dO V^T
//   dS = P * (dP - D),  D = rowsum(dO * O) (computed before the kernel, fp32)
//   dQ = scale * dS K    (dS rounded to the input type before the product, as the
//                         TPU kernel rounds it)
// KV columns >= Skv (the 77-token text context) get P = 0; query rows >= Sq are
// zero-filled, get an LSE of +inf (so P = 0) and are not stored. No atomics: each
// block owns its dQ rows, so results are the same from run to run.
//
// What bounds it on the H100: the three products, 6*B*H*Sq*Skv*d operations. At the
// training UNet's 4096-token self-attention (batch 8, 5 heads, d = 64) that is
// 258 GFLOP against 106 MB of q/k/v/dO/LSE/D/dQ, about 2400 operations per
// byte: tensor-core bound (0.26 ms at 989 TFLOP/s). The 77-token cross-attention is memory bound (q, dO and dQ pass
// once through the block, the 77 K/V rows stay in shared memory).
//
// What the design does about it: the same shape as the forward kernel. The three
// products run on the tensor cores through mma.sync m16n8k16 with fp32
// accumulators; Q and dO fragments stay in registers for the whole KV loop; S and
// dP never leave registers, and dS goes from the accumulators straight into the
// A operand of the dS K product; K fragments for that product are read
// transposed with ldmatrix. K/V tiles are double-buffered in shared memory with
// cp.async so the next tile's load overlaps this tile's math. wgmma and TMA are
// later work.
//
// Interface: plain C (loaded with ctypes). Tensors are addressed by element strides
// for batch, head and sequence (the last dim is contiguous): the [B, S, H, D] views
// of the projections are read in place and dQ is written in the layout given.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int H, int Sq, int Skv,
                int64_t q_sb, int64_t q_sh, int64_t q_ss,
                int64_t k_sb, int64_t k_sh, int64_t k_ss,
                int64_t v_sb, int64_t v_sh, int64_t v_ss,
                int64_t do_sb, int64_t do_sh, int64_t do_ss,
                int64_t dq_sb, int64_t dq_sh, int64_t dq_ss,
                float scale, float scale_log2) {
  constexpr int LD = D + kPad;
  constexpr int NT_KV = kTile / 8;  // n-tiles of S and dP
  constexpr int NT_D = D / 8;       // n-tiles of dQ

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sDO = sQ + kTile * LD;
  T* sK = sDO + kTile * LD;         // 2 buffers
  T* sV = sK + 2 * kTile * LD;      // 2 buffers

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const int n_kv = (Skv + kTile - 1) / kTile;

  load_tile<T, D, kTile>(sQ, q + b * q_sb + h * q_sh + static_cast<int64_t>(q0) * q_ss,
                         q_ss, Sq - q0);
  load_tile<T, D, kTile>(sDO, dout + b * do_sb + h * do_sh + static_cast<int64_t>(q0) * do_ss,
                         do_ss, Sq - q0);
  load_tile<T, D, kTile>(sK, kb, k_ss, Skv);
  load_tile<T, D, kTile>(sV, vb, v_ss, Skv);
  cp_async_commit();

  // LSE (base 2) and D of rows g and g+8 of this warp
  const int r0 = q0 + warp * 16 + g;
  const int rows[2] = {r0, r0 + 8};
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = rows[r] < Sq;
    const int64_t i = static_cast<int64_t>(bh) * Sq + rows[r];
    lse2[r] = ok ? lse[i] * kLog2e : INFINITY;
    dl[r] = ok ? delta[i] : 0.f;
  }

  uint32_t qa[D / 16][4], da[D / 16][4];
  float acc[NT_D][4] = {};

  for (int j = 0; j < n_kv; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_kv) {
      const int nb = buf ^ 1;
      const int64_t off = static_cast<int64_t>(j + 1) * kTile;
      load_tile<T, D, kTile>(sK + nb * kTile * LD, kb + off * k_ss, k_ss,
                             Skv - (j + 1) * kTile);
      load_tile<T, D, kTile>(sV + nb * kTile * LD, vb + off * v_ss, v_ss,
                             Skv - (j + 1) * kTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (j == 0) {
      load_a_frags<T, D>(qa, sQ + warp * 16 * LD, g, t);
      load_a_frags<T, D>(da, sDO + warp * 16 * LD, g, t);
    }
    const T* kt = sK + buf * kTile * LD;
    const T* vt = sV + buf * kTile * LD;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 KV columns.
    float s[NT_KV][4] = {};
    float dp[NT_KV][4] = {};
    mma_rows_t<T, D>(s, qa, kt, g, t);
    mma_rows_t<T, D>(dp, da, vt, g, t);

    // dS = P * (dP - D), P recomputed from the LSE; ragged KV columns give 0.
    const int kv0 = j * kTile;
    const bool ragged = kv0 + kTile > Skv;
#pragma unroll
    for (int n = 0; n < NT_KV; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        float p = fast_exp2(fmaf(s[n][i], scale_log2, -lse2[r]));
        if (ragged && kv0 + n * 8 + 2 * t + (i & 1) >= Skv) p = 0.f;
        s[n][i] = p * (dp[n][i] - dl[r]);
      }
    }

    // dQ += dS K: dS from the accumulators (rounded to T), K read transposed.
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t dsa[4];
      pack_a<T>(dsa, s[2 * kk], s[2 * kk + 1]);
      mma_a_tile<T, D>(acc, dsa, kt, kk, lane);
    }
    __syncthreads();  // the buffer is refilled at iteration j + 1
  }

  T* dqb = dq + b * dq_sb + h * dq_sh;
#pragma unroll
  for (int n = 0; n < NT_D; ++n) {
    const int c = n * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] < Sq)
        *reinterpret_cast<uint32_t*>(dqb + static_cast<int64_t>(rows[r]) * dq_ss + c) =
            MmaOp<T>::pack(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, int B, int H, int Sq,
           int Skv, const int64_t* st, float scale, cudaStream_t stream) {
  constexpr int LD = D + kPad;
  constexpr int smem = 6 * kTile * LD * static_cast<int>(sizeof(T));
  auto kern = flash_dq_kernel<T, D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((Sq + kTile - 1) / kTile, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), H, Sq, Skv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12], st[13], st[14], scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, int B, int H, int Sq,
               int Skv, int D, const int64_t* st, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, dout, lse, delta, dq, B, H, Sq, Skv, st, scale, stream);
    case 32: return launch<T, 32>(q, k, v, dout, lse, delta, dq, B, H, Sq, Skv, st, scale, stream);
    case 64: return launch<T, 64>(q, k, v, dout, lse, delta, dq, B, H, Sq, Skv, st, scale, stream);
    case 128: return launch<T, 128>(q, k, v, dout, lse, delta, dq, B, H, Sq, Skv, st, scale, stream);
    default: return -1;
  }
}

}  // namespace

// strides: 15 element strides, (batch, head, seq) for q, k, v, dout, dq in that
// order. lse, delta: [B*H, Sq] fp32, contiguous. dtype: 0 = bf16, 1 = fp16.
// Returns cudaGetLastError() after the launch, or -1 for a head dim / dtype the
// kernel does not take.
extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dq, int B, int H, int Sq,
                                  int Skv, int D, const int64_t* strides, float scale,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, B, H, Sq, Skv, D,
                                     strides, scale, s);
  if (dtype == 1)
    return dispatch_d<__half>(q, k, v, dout, lse, delta, dq, B, H, Sq, Skv, D,
                              strides, scale, s);
  return -1;
}
