// Flash-attention forward for Hopper (sm_90a), bf16 / fp16 in, fp32 accumulation.
//
// Replaces: difashion_tpu/nn/pallas/flash_attention.py::_fwd_kernel (reached through
// _forward and flash_attention), the TPU kernel that carries every UNet attention
// of the generation loop.
//
// What it computes: non-causal softmax(scale * Q K^T) V for one (batch, head) and a
// tile of 64 query rows per block, with an online softmax over 64-row KV tiles in
// the base-2 domain (scale * log2(e) applied to S in fp32). Columns >= Skv are
// masked to -inf (ragged 77-token text KV); query rows >= Sq are computed on zeros
// and not stored. Outputs O in the input type and the per-row natural-log LSE in
// fp32, [B*H, Sq] (the TPU's 8-sublane broadcast of the LSE is dropped).
//
// What bounds it on the H100: the two products. At the UNet's 4096-token level
// (batch 16, 5 heads, d = 64) one call is 4*B*H*Sq*Skv*d = 344 GFLOP against
// 168 MB of q/k/v/o, about 2000 operations per byte, far above the card's ~295
// bf16 operations per byte: tensor-core bound (0.35 ms at 989 TFLOP/s). The 77-token cross-attention and
// the 256-token level are memory bound instead (every q row is read once and
// every o row written once, the KV tile stays in shared memory).
//
// What the design does about it: the products run on the tensor cores through
// mma.sync m16n8k16 (fp32 accumulators in registers), P stays in registers
// between the two products (the S accumulator layout is the A-operand layout
// of the PV product), and no [Sq, Skv] matrix touches device memory. K/V tiles
// are double-buffered in shared memory with cp.async so the next tile's load
// overlaps this tile's math. One block = 4 warps x 16 query rows. Rows of the
// shared tiles are padded by 8 elements so the fragment loads are free of bank
// conflicts. This is the simple first design: wgmma, TMA and warp
// specialisation are later work.
//
// Interface: plain C (loaded with ctypes). Tensors are addressed by element
// strides for batch, head and sequence (the last dim is contiguous), so the
// [B, S, H, D] view of a projection output is read in place.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBlockQ = kTile;   // query rows per block (16 per warp)
constexpr int kBlockKV = kTile;  // KV rows per tile

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Skv,
                 int64_t q_sb, int64_t q_sh, int64_t q_ss,
                 int64_t k_sb, int64_t k_sh, int64_t k_ss,
                 int64_t v_sb, int64_t v_sh, int64_t v_ss,
                 int64_t o_sb, int64_t o_sh, int64_t o_ss,
                 float scale_log2) {
  constexpr int LD = D + kPad;
  constexpr int KSTEPS = D / 16;       // k-steps of the QK^T product
  constexpr int NT_KV = kBlockKV / 8;  // n-tiles of S
  constexpr int NT_D = D / 8;          // n-tiles of O

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kBlockQ * LD;            // 2 buffers
  T* sV = sK + 2 * kBlockKV * LD;       // 2 buffers

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // row group of the mma fragment
  const int t = lane % 4;   // thread in group

  const T* qb = q + b * q_sb + h * q_sh + static_cast<int64_t>(q0) * q_ss;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  const int n_kv = (Skv + kBlockKV - 1) / kBlockKV;

  load_tile<T, D, kBlockQ>(sQ, qb, q_ss, Sq - q0);
  load_tile<T, D, kBlockKV>(sK, kb, k_ss, Skv);
  load_tile<T, D, kBlockKV>(sV, vb, v_ss, Skv);
  cp_async_commit();

  uint32_t qa[KSTEPS][4];
  float acc[NT_D][4];
#pragma unroll
  for (int n = 0; n < NT_D; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g+8, base-2 domain
  float l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n_kv; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_kv) {
      const int nb = buf ^ 1;
      const int64_t off = static_cast<int64_t>(j + 1) * kBlockKV;
      load_tile<T, D, kBlockKV>(sK + nb * kBlockKV * LD, kb + off * k_ss, k_ss,
                                Skv - (j + 1) * kBlockKV);
      load_tile<T, D, kBlockKV>(sV + nb * kBlockKV * LD, vb + off * v_ss, v_ss,
                                Skv - (j + 1) * kBlockKV);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (j == 0) load_a_frags<T, D>(qa, sQ + warp * 16 * LD, g, t);

    const T* kt = sK + buf * kBlockKV * LD;
    const T* vt = sV + buf * kBlockKV * LD;

    // S = Q K^T for this warp's 16 rows x 64 KV columns.
    float s[NT_KV][4] = {};
    mma_rows_t<T, D>(s, qa, kt, g, t);

    // Scale into the base-2 domain and mask the ragged KV edge.
    const int kv0 = j * kBlockKV;
    const bool ragged = kv0 + kBlockKV > Skv;
#pragma unroll
    for (int n = 0; n < NT_KV; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] *= scale_log2;
        if (ragged && kv0 + n * 8 + 2 * t + (i & 1) >= Skv) s[n][i] = -INFINITY;
      }
    }

    // Online softmax; each row is spread over the 4 threads of a group.
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_run[r];
#pragma unroll
      for (int n = 0; n < NT_KV; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
      alpha[r] = fast_exp2(m_run[r] - mx);
      m_run[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT_KV; ++n) {
        s[n][2 * r] = fast_exp2(s[n][2 * r] - mx);
        s[n][2 * r + 1] = fast_exp2(s[n][2 * r + 1] - mx);
        sum += s[n][2 * r] + s[n][2 * r + 1];
      }
      l_run[r] = alpha[r] * l_run[r] + sum;  // partial (per-thread) row sum
    }
#pragma unroll
    for (int n = 0; n < NT_D; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P comes straight from the S accumulators (rounded to T);
    // V fragments are read transposed with ldmatrix.
#pragma unroll
    for (int kk = 0; kk < kBlockKV / 16; ++kk) {
      uint32_t pa[4];
      pack_a<T>(pa, s[2 * kk], s[2 * kk + 1]);
      mma_a_tile<T, D>(acc, pa, vt, kk, lane);
    }
    __syncthreads();  // the buffer is refilled at iteration j + 1
  }

  // Finish the row sums across the 4 threads of each group, then store.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffff, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffff, l_run[r], 2);
  }
  const float inv0 = 1.f / l_run[0];
  const float inv1 = 1.f / l_run[1];
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;
  T* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int n = 0; n < NT_D; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + static_cast<int64_t>(r0) * o_ss + c) =
          MmaOp<T>::pack(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(ob + static_cast<int64_t>(r1) * o_ss + c) =
          MmaOp<T>::pack(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  if (t == 0) {
    float* lb = lse + static_cast<int64_t>(bh) * Sq;
    if (r0 < Sq) lb[r0] = m_run[0] * kLn2 + logf(l_run[0]);
    if (r1 < Sq) lb[r1] = m_run[1] * kLn2 + logf(l_run[1]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Sq, int Skv, const int64_t* st, float scale,
           cudaStream_t stream) {
  constexpr int LD = D + kPad;
  constexpr int smem = (kBlockQ + 4 * kBlockKV) * LD * static_cast<int>(sizeof(T));
  auto kern = flash_fwd_kernel<T, D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, Sq, Skv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, float* lse,
               int B, int H, int Sq, int Skv, int D, const int64_t* st,
               float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, stream);
    default: return -1;
  }
}

}  // namespace

// strides: 12 element strides, (batch, head, seq) for q, k, v, o in that order.
// dtype: 0 = bf16, 1 = fp16. Returns cudaGetLastError() after the launch, or -1
// for a head dim / dtype the kernel does not take.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int B, int H, int Sq,
                                   int Skv, int D, const int64_t* strides,
                                   float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, lse, B, H, Sq, Skv, D, strides, scale, s);
  if (dtype == 1)
    return dispatch_d<__half>(q, k, v, o, lse, B, H, Sq, Skv, D, strides, scale, s);
  return -1;
}
