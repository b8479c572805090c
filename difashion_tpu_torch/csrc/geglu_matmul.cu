// GEGLU's projection, gate and product in one kernel for Hopper (sm_90a):
// out = h * gelu(gate) with [h | gate] = x . w^T (+ bias), bf16 / fp16 in and
// out.
//
// Replaces no TPU kernel: the JAX package's GEGLU (nn/layers.py::GEGLU, a
// flax Dense to 2F columns, a split, the exact gelu and a product) is left
// to XLA, which fuses the gate and the product into the matmul's output. On
// the card the same module ran as a cuBLAS product writing the 2F-wide
// pre-activation, then two strided elementwise passes (the gelu of the gate
// half, the product with the h half) reading it back. This kernel is the
// port's own fusion of the three, for the transformer blocks' ff.net.0 of
// every no-grad UNet forward.
//
// What it computes, step for step as the reference does (flax's Dense
// rounds the dot to the dtype and adds the bias after it; jax.nn.gelu with
// approximate=False; the product in the dtype): for output element (m, n)
// with n < F,
//   hb = round(round(sum_k x[m, k] w[n, k]) + b[n])
//   gb = round(round(sum_k x[m, k] w[F + n, k]) + b[F + n])
//   g  = round(gelu(gb)),  gelu(v) = v * 0.5 * (1 + erff(v * sqrt(1/2))) in fp32,
//        the expression and the order of PyTorch's own GELU kernel
//   out[m, n] = round(hb * g)   (the product of two 16-bit values is exact in fp32)
// each sum one fp32 sum over K. x is [M, K] with unit stride along K and row
// stride ldx; w is [2F, K] row-major (torch.nn.Linear's layout of the
// projection: the F h rows, then the F gate rows); out is [M, F] row-major.
//
// What bounds it on the H100: 2 M K (2F) operations on 2 (M K + 2F K + M F +
// 2F) bytes. At the UNet's sites (K = C = 320, 640, 1280; F = 4C; M = 4k-262k
// rows) that is 500-1700 operations a byte against the card's ~295: the
// tensor cores bound it, and the 2F-wide pre-activation, which the unfused
// path wrote and read back twice, never leaves the SM. K is only 5-20 chunks
// of 64 deep, so every output tile pays its pipeline's fill and its
// epilogue, and the epilogue's erff (some 45 instructions an element, both
// of its polynomial branches selected) costs as much as the tile's products
// at K = 320.
//
// What the design does about it: the skinny-N kernel's shape
// (skinny_matmul.cu), a persistent grid of one 384-thread block per SM
// walking the 128 x BN output tiles with N fastest (x read from memory about
// once, the weight, at most 26 MB, kept in the 50 MB L2); warpgroup 0 the
// producer (one thread issuing TMA loads into a ring of stages, 128-byte
// swizzle, full / empty mbarriers), warpgroups 1 and 2 the consumers, 64 rows
// each. Per K chunk the producer loads x's 128 x 64 box and two boxes of the
// unchanged weight, rows n0.. n0 + BN (h) and F + n0.. F + n0 + BN (gate),
// side by side, so that one wgmma m64n(2 BN)k16 computes both halves: each
// consumer thread holds the h and the gate sums of the same columns (the
// accumulator's first and second halves), and the epilogue pairs them in
// registers. The epilogue rounds, adds the bias (fetched before the main
// loop, staged in shared memory), takes the gelu, rounds, multiplies and
// rounds, writes a 64-byte-swizzled staging tile and stores it with TMA
// (64 x 32 boxes; F a multiple of BN, so no tile is ragged in N; TMA
// zero-fills ragged M and the last K chunk on load and clips M on store).
// The ring runs on across tiles, so the producer fetches the next tile's
// chunks during the epilogue. BN (64 or 128) is the caller's choice per
// shape (nn/kernels/geglu_matmul.py::plan, measured). Measured on the H100
// and not kept: the consumers in ping-pong on tiles of their own, a second
// set of sums so that one tile's epilogue runs beside the next tile's
// products, and a shared-memory table of the bf16 gelu in place of erff;
// none was faster (PERF.md).
//
// Interface: plain C (loaded with ctypes). The caller allocates out, chooses
// BN and counts one launch per call.

#include <string.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 384;             // producer warpgroup + 2 consumer warpgroups
constexpr int kBM = 128;                  // rows of an output tile, 64 per consumer
constexpr int kBK = 64;                   // depth of a K chunk: 128 bytes of 16-bit values
constexpr int kRowBytes = kBK * 2;        // one swizzled row
constexpr int kOutCols = 32;              // columns of one TMA store box (64 bytes)
constexpr int kOutBoxBytes = 64 * kOutCols * 2;
constexpr int kSmemLimit = 232448;        // dynamic shared memory a block may have
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

template <int BN>
struct Plan {
  static constexpr int kBRows = 2 * BN;                      // BN h rows, then BN gate rows
  static constexpr int kABytes = kBM * kRowBytes;
  static constexpr int kBBytes = kBRows * kRowBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kOutBytes = kBM * BN * 2;             // both consumers' staging
  static constexpr int kBiasBytes = 2 * kBRows * 2;          // both consumers' h and gate bias
  static constexpr int kStagesFit =
      (kSmemLimit - 1024 - kOutBytes - kBiasBytes - 128) / kStageBytes;
  static constexpr int kStages = kStagesFit < 8 ? kStagesFit : 8;
  static constexpr int kSmem =
      1024 + kStages * kStageBytes + kOutBytes + kBiasBytes + 16 * kStages;
  static_assert(kStages >= 2 && kSmem <= kSmemLimit, "geglu_matmul: shared memory plan");
  // a consumer thread's BN fp32 sums; each consumer thread stages one or two
  // of a tile's 2 BN bias values
  static_assert((BN == 64 || BN == 128) && (BN * kRowBytes) % 1024 == 0,
                "geglu_matmul: tile plan");
};

__device__ __forceinline__ uint16_t load_u16_early(const void* p) {
  uint16_t v;
  asm volatile("ld.global.nc.b16 %0, [%1];\n" : "=h"(v) : "l"(p) : "memory");
  return v;
}

// Packed pairs added with one rounding, as in skinny_matmul.cu: what adding
// the two 16-bit values in fp32 and rounding gives.
template <typename T>
__device__ __forceinline__ uint32_t add_pair(uint32_t a, uint32_t b);
template <>
__device__ __forceinline__ uint32_t add_pair<__nv_bfloat16>(uint32_t a, uint32_t b) {
  const __nv_bfloat162 v = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t add_pair<__half>(uint32_t a, uint32_t b) {
  const __half2 v = __hadd2(*reinterpret_cast<const __half2*>(&a),
                            *reinterpret_cast<const __half2*>(&b));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A packed pair of T widened to fp32 (exact), the low half first.
template <typename T>
__device__ __forceinline__ float2 unpack_pair(uint32_t v);
template <>
__device__ __forceinline__ float2 unpack_pair<__nv_bfloat16>(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}
template <>
__device__ __forceinline__ float2 unpack_pair<__half>(uint32_t v) {
  return __half22float2(*reinterpret_cast<const __half2*>(&v));
}

// The exact gelu in fp32, as PyTorch's GELU kernel computes it for 16-bit
// tensors: x * 0.5 * (1 + erf(x * M_SQRT1_2)), erf being CUDA's erff.
__device__ __forceinline__ float gelu_erf(float x) {
  constexpr float kAlpha = 0.70710678118654752440f;
  return x * 0.5f * (1.0f + erff(x * kAlpha));
}

// round(gelu(g)) on a packed pair of T.
template <typename T>
__device__ __forceinline__ uint32_t gelu_pair(uint32_t g) {
  const float2 v = unpack_pair<T>(g);
  return round_pair<T>(gelu_erf(v.x), gelu_erf(v.y));
}

// round(hb * round(gelu(gb))) on a packed pair of each.
template <typename T>
__device__ __forceinline__ uint32_t geglu_pair(uint32_t hb, uint32_t gb) {
  const float2 g = unpack_pair<T>(gelu_pair<T>(gb));
  const float2 h = unpack_pair<T>(hb);
  return round_pair<T>(h.x * g.x, h.y * g.y);
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, 1)
geglu_matmul_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap omap, const T* __restrict__ bias,
                    int M, int F, int K) {
  using P = Plan<BN>;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle patterns repeat every 1024 bytes: align the tiles to them
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* a_tiles = smem;                                   // [stages][128 x 64]
  unsigned char* b_tiles = a_tiles + P::kStages * P::kABytes;      // [stages][2 BN x 64]
  unsigned char* staging = b_tiles + P::kStages * P::kBBytes;      // [2][BN / 32][64 x 32]
  uint16_t* bias_rows = reinterpret_cast<uint16_t*>(staging + P::kOutBytes);   // [2][2 BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + P::kOutBytes + P::kBiasBytes);
  uint64_t* empty = full + P::kStages;

  const int tiles_n = F / BN;
  const int tiles = ((M + kBM - 1) / kBM) * tiles_n;
  const int chunks = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(&full[s], 1);      // the producer's arrive-expect-tx
      mbar_init(&empty[s], 8);     // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  // The roles part here and never meet again (setmaxnreg needs the paths
  // not to reconverge).
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch(&xmap);
      tma_prefetch(&wmap);
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * BN;
        for (int kc = 0; kc < chunks; ++kc) {
          mbar_wait(&empty[stage], phase ^ 1);   // the first round passes at once
          mbar_arrive_expect_tx(&full[stage], P::kStageBytes);
          tma_load_2d(a_tiles + stage * P::kABytes, &xmap, &full[stage], kc * kBK, m0);
          unsigned char* b = b_tiles + stage * P::kBBytes;
          tma_load_2d(b, &wmap, &full[stage], kc * kBK, n0);                       // h
          tma_load_2d(b + BN * kRowBytes, &wmap, &full[stage], kc * kBK, F + n0);  // gate
          advance<P::kStages>(stage, phase);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;            // this consumer's 64 rows of a tile
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const bool leader = threadIdx.x % 128 == 0;
    const int ct = threadIdx.x % 128;
    unsigned char* my_staging = staging + cw * (P::kOutBytes / 2);
    uint16_t* my_bias = bias_rows + cw * P::kBRows;  // [h bias BN][gate bias BN]
    float acc[BN];                                   // columns 0..BN-1 h, BN..2BN-1 gate
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * BN;
      // the tile's h and gate bias, columns ct (and ct + 128) of the 2 BN,
      // fetched before the main loop so that the load's latency hides
      // behind it
      uint16_t bias0 = 0, bias1 = 0;
      if (bias != nullptr) {
        bias0 = load_u16_early(bias + (ct < BN ? n0 + ct : F + n0 + ct - BN));
        if (ct + 128 < P::kBRows) bias1 = load_u16_early(bias + F + n0 + ct + 128 - BN);
      }
      for (int kc = 0; kc < chunks; ++kc) {
        mbar_spin_wait(&full[stage], phase);         // the producer's waits are watched
        __syncwarp();                                // converged for the .aligned wgmma ops
        const uint32_t a_addr = smem_u32(a_tiles + stage * P::kABytes + cw * 64 * kRowBytes);
        const uint32_t b_addr = smem_u32(b_tiles + stage * P::kBBytes);
        wgmma_fence();
        fence_operands(acc);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t da = wgmma_desc_sw128(a_addr + kk * 32, 16, 1024);
          const uint64_t db = wgmma_desc_sw128(b_addr + kk * 32, 16, 1024);
          wgmma_ss<T, 2 * BN, 0>(acc, da, db, (kc | kk) != 0);
        }
        wgmma_commit();
        fence_operands(acc);
        if (kc > 0) {
          // the previous chunk's products are done: its stage may refill
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = stage;
        advance<P::kStages>(stage, phase);
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);

      // epilogue: the previous tile's stores have read the staging tile, and
      // every thread has left the previous epilogue (its bias reads)
      if (leader) tma_store_wait_read<0>();
      my_bias[ct] = bias0;
      if (ct + 128 < P::kBRows) my_bias[ct + 128] = bias1;
      named_bar_sync(1 + cw, 128);
      const int row0 = warp * 16 + g;                // and row0 + 8, of this consumer's 64
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const uint32_t bias_h = *reinterpret_cast<const uint32_t*>(my_bias + j * 8 + 2 * t);
        const uint32_t bias_g = *reinterpret_cast<const uint32_t*>(my_bias + BN + j * 8 + 2 * t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // h and gate of the same two columns: registers 4j + 2h (+1) of
          // the first half, and of the second half (BN / 2 further)
          uint32_t hb = round_pair<T>(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          uint32_t gb = round_pair<T>(acc[BN / 2 + 4 * j + 2 * h],
                                      acc[BN / 2 + 4 * j + 2 * h + 1]);
          if (bias != nullptr) {
            hb = add_pair<T>(hb, bias_h);
            gb = add_pair<T>(gb, bias_g);
          }
          const int r = row0 + 8 * h;
          // box j / 4, 16-byte group (j % 4) swizzled by bits 7-8 of the
          // byte offset (64-byte rows: (r / 2) % 4)
          const int off = (j / 4) * kOutBoxBytes + r * 64 + (((j % 4) ^ ((r >> 1) & 3)) << 4) +
                          t * 4;
          *reinterpret_cast<uint32_t*>(my_staging + off) = geglu_pair<T>(hb, gb);
        }
      }
      fence_proxy_async_shared();
      named_bar_sync(1 + cw, 128);
      if (leader) {
#pragma unroll
        for (int c = 0; c < BN / kOutCols; ++c)
          tma_store_2d(&omap, my_staging + c * kOutBoxBytes, n0 + c * kOutCols, m0 + cw * 64);
        tma_store_commit();
      }
    }
    if (leader) tma_store_wait<0>();
  }
}

template <typename T, int BN>
int launch(const void* x, const void* w, const void* bias, void* o, int M, int F, int K,
           int64_t ldx, cudaStream_t stream) {
  using P = Plan<BN>;
  if (F % BN != 0) return -1;
  // above 48 KB of shared memory only on request; once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      geglu_matmul_kernel<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (attr != cudaSuccess) return int(attr);
  CUtensorMap xmap, wmap, omap;
  int rc = encode_2d<T>(&xmap, x, M, K, ldx, kBM, kBK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0) rc = encode_2d<T>(&wmap, w, 2 * int64_t(F), K, K, BN, kBK,
                                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0) rc = encode_2d<T>(&omap, o, M, F, F, 64, kOutCols, CU_TENSOR_MAP_SWIZZLE_64B);
  if (rc != 0) return rc;
  const int tiles = ((M + kBM - 1) / kBM) * (F / BN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  geglu_matmul_kernel<T, BN><<<grid, kThreads, P::kSmem, stream>>>(
      xmap, wmap, omap, static_cast<const T*>(bias), M, F, K);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* w, const void* bias, void* o, int M, int F, int K,
             int64_t ldx, int bn, cudaStream_t s) {
  switch (bn) {
    case 64: return launch<T, 64>(x, w, bias, o, M, F, K, ldx, s);
    case 128: return launch<T, 128>(x, w, bias, o, M, F, K, ldx, s);
    default: return -1;
  }
}

// round(gelu(v)) in T for every 16-bit pattern v, out[v] for v = 0..65535:
// the epilogue's gelu at every input it can meet, for the tests, which hold
// it against PyTorch's GELU.
template <typename T>
__global__ void gelu_all_kernel(uint16_t* out) {
  const uint32_t v = blockIdx.x * blockDim.x + threadIdx.x;
  out[v] = static_cast<uint16_t>(gelu_pair<T>(v));
}

}  // namespace

// x: [M, K] of `dtype` (0 = bf16, 1 = fp16), unit stride along K, row stride
// ldx; w: contiguous [2F, K] (h rows, then gate rows); bias: [2F] or null;
// o: contiguous [M, F]. K and ldx multiples of 8; x, w and o 16-byte
// aligned; bn (the output tile width) 64 or 128, dividing F. Returns 0, the
// CUDA error of the launch (> 0), -1 for arguments it does not take, or a
// tensor-map error (hopper_common.cuh).
extern "C" int geglu_matmul(const void* x, const void* w, const void* bias, void* o,
                            long long M, long long F, long long K, long long ldx, int dtype,
                            int bn, void* stream) {
  if (M <= 0 || F <= 0 || K <= 0 || M > 0x7fffffffLL || 2 * F > 0x7fffffffLL ||
      K > 0x7fffffffLL)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<__nv_bfloat16>(x, w, bias, o, int(M), int(F), int(K), ldx, bn, s);
  if (dtype == 1) return dispatch<__half>(x, w, bias, o, int(M), int(F), int(K), ldx, bn, s);
  return -1;
}

// out: 65,536 uint16, the epilogue's gelu of every 16-bit pattern of `dtype`
// (see gelu_all_kernel). Returns 0, the CUDA error of the launch, or -1.
extern "C" int geglu_gelu_all(void* out, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    gelu_all_kernel<__nv_bfloat16><<<256, 256, 0, s>>>(static_cast<uint16_t*>(out));
  else if (dtype == 1)
    gelu_all_kernel<__half><<<256, 256, 0, s>>>(static_cast<uint16_t*>(out));
  else
    return -1;
  return int(cudaGetLastError());
}
