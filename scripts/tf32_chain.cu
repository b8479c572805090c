// The fp32 dQ kernel's product chain in 3xTF32 by mma.sync and by wgmma, on
// operands already in shared memory: the measurement behind the fp32 backward's
// choice of mma.sync (scripts/tf32_chain.py builds this file and times it).
//
//   peak_mma:    independent mma.sync.m16n8k8.tf32 on registers: the rate ceiling of
//                the mma.sync route;
//   peak_wgmma:  wgmma.m64nNk8.tf32 on shared memory (N = 64, 128): the ceiling of
//                the wgmma route;
//   chain_mma:   the dQ kernel's own chain (S = Q K^T, dP = dO V^T, dS, dQ += dS K,
//                64 rows a block of 4 warps, the device functions of
//                csrc/flash_attention_f32.cu) on resident tiles: no loads, no barriers;
//   chain_wgmma: the same chain by wgmma, 128 rows a block of 2 warpgroups: per KV
//                tile the block splits K and V into hi and lo copies, K-major, and K
//                into transposed hi and lo copies (wgmma reads tf32 operands only
//                K-major), then S and dP by wgmma from shared memory and dQ by wgmma
//                with dS's split fragments in registers.
// Numbers only; nothing here is checked for the right answer.

#include "../difashion_tpu_torch/csrc/hopper_common.cuh"
#include "../difashion_tpu_torch/csrc/flash_attention_f32.cu"

namespace {

#ifdef TF32_NO_IMM_SCALE
#define TF32_SCALES ""
#else
#define TF32_SCALES ", 1, 1"
#endif

#define TF32_D8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

__device__ __forceinline__ void wgmma_tf32_ss64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p" TF32_SCALES
      ";\n}\n"
      : TF32_D8(0), TF32_D8(8), TF32_D8(16), TF32_D8(24)
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_ss128(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p" TF32_SCALES ";\n}\n"
      : TF32_D8(0), TF32_D8(8), TF32_D8(16), TF32_D8(24), TF32_D8(32), TF32_D8(40), TF32_D8(48),
        TF32_D8(56)
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_rs64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p"
      TF32_SCALES ";\n}\n"
      : TF32_D8(0), TF32_D8(8), TF32_D8(16), TF32_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

__global__ void __launch_bounds__(128) peak_mma(float* out, int iters) {
  const uint32_t x = to_tf32(1.f + threadIdx.x * 1e-3f);
  const uint32_t a[4] = {x, x ^ 0x2000u, x, x};
  float c[8][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n) mma_tf32(c[n], a, x, x ^ 0x4000u);
  float s = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n) s += c[n][0] + c[n][1] + c[n][2] + c[n][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int N>
__global__ void __launch_bounds__(128) peak_wgmma(float* out, int iters) {
  extern __shared__ __align__(1024) uint8_t sm_w[];
  for (int i = threadIdx.x; i < (8192 + N * 128) / 4; i += 128)
    reinterpret_cast<float*>(sm_w)[i] = 1e-3f * (i & 7);
  hopper::fence_proxy_async_shared();
  __syncthreads();
  const uint32_t base = hopper::smem_u32(sm_w);
  float d[N / 2] = {};
  for (int i = 0; i < iters; ++i) {
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint64_t da = hopper::wgmma_desc_sw128(base + 32 * k, 16, 1024);
      const uint64_t db = hopper::wgmma_desc_sw128(base + 8192 + 32 * k, 16, 1024);
      if constexpr (N == 64) wgmma_tf32_ss64(d, da, db, 1); else wgmma_tf32_ss128(d, da, db, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
  }
  hopper::wgmma_wait<0>();
  hopper::fence_operands(d);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < N / 2; ++j) s += d[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void __launch_bounds__(kBwdThreads) chain_mma(const float* src, float* out, int iters) {
  constexpr int T = kRows * 64;
  extern __shared__ __align__(16) float sm_c[];
  for (int i = threadIdx.x; i < 4 * T; i += kBwdThreads)
    sm_c[i] = src[(i + 4096 * (blockIdx.x & 63)) & ((1 << 20) - 1)];
  __syncthreads();
  const float *sQ = sm_c, *sDO = sm_c + T, *sK = sm_c + 2 * T, *sV = sm_c + 3 * T;
  const Lane<64> L;
  const int r0 = (threadIdx.x / 32) * 16;
  float acc[8][4] = {};
  for (int it = 0; it < iters; ++it) {
    float s[8][4], dp[8][4];
    scores<64>(s, L, sQ, sK, r0);
    scores<64>(dp, L, sDO, sV, r0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = exp2f(fmaf(s[n][c], 0.01f, -1.f)) * (dp[n][c] - 0.5f);
    accumulate<64>(acc, s, L, sK);
  }
  float t = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n) t += acc[n][0] + acc[n][1] + acc[n][2] + acc[n][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}

// A [64][64] fp32 operand tile, K-major, 128-byte swizzled: two 8 KB chunks of
// [64 rows][32 floats]; element (r, c)'s byte offset.
__device__ __forceinline__ uint32_t sw_off(int r, int c) {
  const int byte = (c & 31) * 4;
  return (c >> 5) * 8192 + r * 128 + ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15));
}

// wgmma's descriptor of k-step kk (8 floats) of such a tile at shared address t
__device__ __forceinline__ uint64_t sw_desc(uint32_t t, int kk) {
  return hopper::wgmma_desc_sw128(t + (kk / 4) * 8192 + (kk % 4) * 32, 16, 1024);
}

__global__ void __launch_bounds__(256) chain_wgmma(const float* src, float* out, int iters) {
  constexpr int kTile = 16384;
  extern __shared__ __align__(1024) uint8_t sm_g[];
  // per warpgroup: Q hi, lo, dO hi, lo; shared: K hi, lo, V hi, lo, K^T hi, lo
  const int wg = threadIdx.x / 128;
  uint8_t* own = sm_g + wg * 4 * kTile;
  uint8_t* kv = sm_g + 8 * kTile;
  for (int i = threadIdx.x % 128; i < 4096; i += 128) {
    const float x = src[(i + 4096 * (blockIdx.x & 63)) & ((1 << 20) - 1)];
    uint32_t hi, lo;
    split(x, hi, lo);
    const uint32_t o = sw_off(i / 64, i % 64);
    *reinterpret_cast<uint32_t*>(own + o) = hi;
    *reinterpret_cast<uint32_t*>(own + kTile + o) = lo;
    *reinterpret_cast<uint32_t*>(own + 2 * kTile + o) = hi;
    *reinterpret_cast<uint32_t*>(own + 3 * kTile + o) = lo;
  }
  const uint32_t own_a = hopper::smem_u32(own), kv_a = hopper::smem_u32(kv);
  float acc[32] = {};
  for (int it = 0; it < iters; ++it) {
    // the KV tile's split copies: K and V K-major, K transposed (its keys
    // permuted within 8 as the register fragments of dS take them)
    for (int i = threadIdx.x; i < 4096; i += 256) {
      const int r = i / 64, c = i % 64;
      const float* tile = src + ((4096 * (it & 15) + 65536 * (blockIdx.x & 7)) & ((1 << 20) - 1));
      uint32_t kh, kl, vh, vl;
      split(tile[i], kh, kl);
      split(tile[i + 4096], vh, vl);
      const uint32_t o = sw_off(r, c);
      const int pr = (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
      const uint32_t ot = sw_off(c, pr);
      *reinterpret_cast<uint32_t*>(kv + o) = kh;
      *reinterpret_cast<uint32_t*>(kv + kTile + o) = kl;
      *reinterpret_cast<uint32_t*>(kv + 2 * kTile + o) = vh;
      *reinterpret_cast<uint32_t*>(kv + 3 * kTile + o) = vl;
      *reinterpret_cast<uint32_t*>(kv + 4 * kTile + ot) = kh;
      *reinterpret_cast<uint32_t*>(kv + 5 * kTile + ot) = kl;
    }
    hopper::fence_proxy_async_shared();
    __syncthreads();
    float s[32] = {}, dp[32] = {};
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      wgmma_tf32_ss64(s, sw_desc(own_a + kTile, kk), sw_desc(kv_a, kk), 1);
      wgmma_tf32_ss64(s, sw_desc(own_a, kk), sw_desc(kv_a + kTile, kk), 1);
      wgmma_tf32_ss64(s, sw_desc(own_a, kk), sw_desc(kv_a, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      wgmma_tf32_ss64(dp, sw_desc(own_a + 3 * kTile, kk), sw_desc(kv_a + 2 * kTile, kk), 1);
      wgmma_tf32_ss64(dp, sw_desc(own_a + 2 * kTile, kk), sw_desc(kv_a + 3 * kTile, kk), 1);
      wgmma_tf32_ss64(dp, sw_desc(own_a + 2 * kTile, kk), sw_desc(kv_a + 2 * kTile, kk), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(s);
    hopper::fence_operands(dp);
    uint32_t ah[8][4], al[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[c] = exp2f(fmaf(s[4 * j + c], 0.01f, -1.f)) * (dp[4 * j + c] - 0.5f);
      split(v[0], ah[j][0], al[j][0]);
      split(v[2], ah[j][1], al[j][1]);
      split(v[1], ah[j][2], al[j][2]);
      split(v[3], ah[j][3], al[j][3]);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      wgmma_tf32_rs64(acc, al[j], sw_desc(kv_a + 4 * kTile, j));
      wgmma_tf32_rs64(acc, ah[j], sw_desc(kv_a + 5 * kTile, j));
      wgmma_tf32_rs64(acc, ah[j], sw_desc(kv_a + 4 * kTile, j));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) hopper::fence_operands(ah[j]), hopper::fence_operands(al[j]);
    __syncthreads();
  }
  float t = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) t += acc[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}

template <typename K>
int smem_attr(K kern, int bytes) {
  return int(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

extern "C" int tf32_chain_run(int which, const float* src, float* out, int blocks, int iters,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = 0;
  switch (which) {
    case 0:
      peak_mma<<<blocks, 128, 0, s>>>(out, iters);
      break;
    case 1:
      rc = smem_attr(peak_wgmma<64>, 8192 + 64 * 128);
      peak_wgmma<64><<<blocks, 128, 8192 + 64 * 128, s>>>(out, iters);
      break;
    case 2:
      rc = smem_attr(peak_wgmma<128>, 8192 + 128 * 128);
      peak_wgmma<128><<<blocks, 128, 8192 + 128 * 128, s>>>(out, iters);
      break;
    case 3:
      rc = smem_attr(chain_mma, 4 * 4096 * 4);
      chain_mma<<<blocks, kBwdThreads, 4 * 4096 * 4, s>>>(src, out, iters);
      break;
    case 4:
      rc = smem_attr(chain_wgmma, 14 * 16384);
      chain_wgmma<<<blocks, 256, 14 * 16384, s>>>(src, out, iters);
      break;
    default:
      return -1;
  }
  return rc ? rc : int(cudaGetLastError());
}
