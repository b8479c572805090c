// Skinny-N matrix product for Hopper (sm_90a): o = x . w^T (+ bias), bf16 / fp16
// in and out, one fp32 sum per element.
//
// Replaces: tools/pallas_skinny_matmul.py::_mm_kernel (reached through _mm_call,
// the _matmul custom VJP, matmul_2d and pallas_dense_dot), the TPU kernel for
// the Dense layers whose output is a few hundred columns wide: the UNet's
// attention projections (q/k/v/out, proj_in/proj_out), its feed-forward
// down-projections and the VAE's mid-attention projections, behind the JAX
// package's gate (N <= 1280, weight <= 8 MiB, M >= 2048, M % 512 == 0). The
// backward's dx = g . w runs through it too, as in _matmul_bwd.
//
// What it computes: x is [M, K] with unit stride along K and row stride ldx;
// w is [N, K] row-major (torch.nn.Linear's layout, K-major for the tensor
// cores) or, for dx, [K, N] row-major (MN-major: the stored [N_out, K_out]
// weight read as it lies, no transposed copy); o is [M, N] row-major. Each
// element is one fp32 sum over K rounded to the input type; with a bias it is
// round(round(sum) + bias), bit for bit what adding the bias to the rounded
// product gives, which is what flax's Dense does after its dot_general.
//
// What bounds it on the H100: at the UNet's shapes (M = 2k-262k rows, K and N
// 320-2560) a product does 2MKN operations on 2(MK + KN + MN) bytes, 100-600
// operations a byte against the card's ~295: the tensor cores bound the large
// ones, memory the K = N = 320 ones. With K only 5-40 chunks of 64 deep, a
// block that fills its pipeline from empty for every output tile and runs its
// epilogue with nothing in flight loses most of its time to the fill and the
// drain, and mma.sync cannot reach the tensor cores' dense rate at all.
//
// What the design does about it: a persistent grid, one block of 384 threads
// per SM walking the 128 x BN output tiles with N fastest, so the N tiles of
// one M tile run back to back on neighbouring SMs: x is read from memory
// about once and the weight (0.2-3.3 MB) stays in the 50 MB L2. Warp
// specialisation: warpgroup 0 is the producer (setmaxnreg down to 40), one
// thread of which issues TMA loads of 64-deep K chunks of x (128 x 64) and w
// (BN x 64, or ceil(BN / 64) chunks of 64 x 64 when MN-major) into a ring of
// stages with full / empty mbarriers, 128-byte swizzle; warpgroups 1 and 2
// are the consumers (setmaxnreg up to 232), each owning 64 rows, running
// wgmma.mma_async m64nBNk16 straight from the swizzled tiles with fp32
// accumulators in registers, one wgmma group kept in flight while the next
// chunk is awaited. The ring runs on across tiles, so the producer fetches
// the next tile's chunks while the consumers run the epilogue: the rounding
// and the bias add on packed pairs (the bias fetched before the main loop), a
// write into a 64-byte-swizzled staging tile (conflict-free) and TMA stores
// (64 x 32 boxes), or plain stores where N % 8 != 0. TMA's bounds handling
// zero-fills ragged M, N and K on load and clips them on store; its
// coordinates make the 64-bit row offsets (M reaches 262,144). BN (128, 160
// or 256) is the caller's choice per N and layout (nn/kernels/skinny_matmul.py
// ::tile_n, measured: 160 for the forward at N = 320, 640 and 1280, so that
// N = 320 is two whole tiles; 128 at N = 512; 256, with only 3 stages and
// fewer tiles than SMs x waves, lost everywhere); the stages fill the 227 KB
// of shared memory beside the staging tile (6, 5 and 3 stages, K-major).
//
// Interface: plain C (loaded with ctypes). The caller allocates o, chooses
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

template <int BN, bool KN>
struct Plan {
  static constexpr int kBChunks = KN ? (BN + 63) / 64 : 1;   // 64-column chunks of B
  static constexpr int kABytes = kBM * kRowBytes;
  static constexpr int kBBytes = KN ? kBChunks * kBK * kRowBytes : BN * kRowBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kOutBytes = kBM * BN * 2;             // both consumers' staging
  static constexpr int kBiasBytes = 2 * BN * 2;              // both consumers' bias row
  static constexpr int kStagesFit =
      (kSmemLimit - 1024 - kOutBytes - kBiasBytes - 128) / kStageBytes;
  static constexpr int kStages = kStagesFit < 6 ? kStagesFit : 6;
  static constexpr int kSmem =
      1024 + kStages * kStageBytes + kOutBytes + kBiasBytes + 16 * kStages;
  static_assert(kStages >= 2 && kSmem <= kSmemLimit, "skinny_matmul: shared memory plan");
  // BN >= 128: each consumer thread stages one or two of a tile's bias values
  static_assert(BN >= 128 && BN <= 256 && BN % kOutCols == 0 && kBBytes % 1024 == 0,
                "skinny_matmul: tile plan");
};

// A 16-bit load kept in program order (asm volatile): issued before the main
// loop and waited for only where the value is used, in the epilogue. A plain
// load of const __restrict__ data may be sunk past the loop's asm, which
// exposes its latency once per tile.
__device__ __forceinline__ uint16_t load_u16_early(const void* p) {
  uint16_t v;
  asm volatile("ld.global.nc.b16 %0, [%1];\n" : "=h"(v) : "l"(p) : "memory");
  return v;
}

// Two fp32 values rounded to T and packed, the first in the low half (one
// cvt.rn for the pair).
template <typename T>
__device__ __forceinline__ uint32_t round_pair(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t round_pair<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t round_pair<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Packed pairs added with one rounding (add.rn on the pair): the sum of two
// 16-bit values is exact in fp32, so this is what adding them in fp32 and
// rounding gives, as torch's and XLA's bf16 / fp16 adds do.
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

template <typename T, int BN, bool KN>
__global__ void __launch_bounds__(kThreads, 1)
skinny_matmul_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap omap, const T* __restrict__ bias,
                     T* __restrict__ o, int M, int N, int K, int tma_store) {
  using P = Plan<BN, KN>;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle patterns repeat every 1024 bytes: align the tiles to them
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* a_tiles = smem;                                   // [stages][128 x 64]
  unsigned char* b_tiles = a_tiles + P::kStages * P::kABytes;      // [stages][B chunk(s)]
  unsigned char* staging = b_tiles + P::kStages * P::kBBytes;      // [2][BN / 32][64 x 32]
  uint16_t* bias_rows = reinterpret_cast<uint16_t*>(staging + P::kOutBytes);   // [2][BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + P::kOutBytes + P::kBiasBytes);
  uint64_t* empty = full + P::kStages;

  const int tiles_n = (N + BN - 1) / BN;
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
          if constexpr (KN) {
#pragma unroll
            for (int c = 0; c < P::kBChunks; ++c)
              tma_load_2d(b + c * kBK * kRowBytes, &wmap, &full[stage], n0 + c * 64, kc * kBK);
          } else {
            tma_load_2d(b, &wmap, &full[stage], kc * kBK, n0);
          }
          if (++stage == P::kStages) { stage = 0; phase ^= 1; }
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
    uint16_t* my_bias = bias_rows + cw * BN;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * BN;
      // the tile's bias, two columns a thread (ct, ct + 128), fetched before
      // the main loop so that the load's latency hides behind it; shared in
      // the epilogue (registers for BN / 4 values a thread would spill)
      uint16_t bias0 = 0, bias1 = 0;
      if (bias != nullptr) {
        // columns past N are never stored: clamp rather than branch
        bias0 = load_u16_early(bias + min(n0 + ct, N - 1));
        if (ct + 128 < BN) bias1 = load_u16_early(bias + min(n0 + ct + 128, N - 1));
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
          const uint64_t db = KN ? wgmma_desc_sw128(b_addr + kk * 16 * kRowBytes,
                                                    kBK * kRowBytes, 1024)
                                 : wgmma_desc_sw128(b_addr + kk * 32, 16, 1024);
          wgmma_ss<T, BN, KN ? 1 : 0>(acc, da, db, (kc | kk) != 0);
        }
        wgmma_commit();
        fence_operands(acc);
        if (kc > 0) {
          // the previous chunk's products are done: its stage may refill
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == P::kStages) { stage = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);

      // epilogue: the previous tile's stores have read the staging tile, and
      // every thread has left the previous epilogue (its bias reads)
      if (leader) tma_store_wait_read<0>();
      my_bias[ct] = bias0;
      if (ct + 128 < BN) my_bias[ct + 128] = bias1;
      named_bar_sync(1 + cw, 128);
      const int row0 = warp * 16 + g;                // and row0 + 8, of this consumer's 64
      const int64_t grow0 = int64_t(m0) + cw * 64 + row0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int gcol = n0 + j * 8 + 2 * t;
        const uint32_t bias_pair = *reinterpret_cast<const uint32_t*>(my_bias + j * 8 + 2 * t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // round(sum), then round(round(sum) + bias)
          uint32_t v = round_pair<T>(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          if (bias != nullptr) v = add_pair<T>(v, bias_pair);
          const int r = row0 + 8 * h;
          if (tma_store) {
            // box j / 4, 16-byte group (j % 4) swizzled by bits 7-8 of the
            // byte offset (64-byte rows: (r / 2) % 4)
            const int off = (j / 4) * kOutBoxBytes + r * 64 + (((j % 4) ^ ((r >> 1) & 3)) << 4) +
                            t * 4;
            *reinterpret_cast<uint32_t*>(my_staging + off) = v;
          } else if (grow0 + 8 * h < M) {
            uint16_t* out = reinterpret_cast<uint16_t*>(o) + (grow0 + 8 * h) * N;
            if (gcol < N) out[gcol] = static_cast<uint16_t>(v);
            if (gcol + 1 < N) out[gcol + 1] = static_cast<uint16_t>(v >> 16);
          }
        }
      }
      if (tma_store) fence_proxy_async_shared();
      named_bar_sync(1 + cw, 128);
      if (tma_store && leader) {
#pragma unroll
        for (int c = 0; c < BN / kOutCols; ++c)
          if (n0 + c * kOutCols < N)
            tma_store_2d(&omap, my_staging + c * kOutBoxBytes, n0 + c * kOutCols,
                         m0 + cw * 64);
        tma_store_commit();
      }
    }
    if (leader) tma_store_wait<0>();
  }
}

int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return counts[dev];
}

template <typename T, int BN, bool KN>
int launch(const void* x, const void* w, const void* bias, void* o, int M, int N, int K,
           int64_t ldx, cudaStream_t stream) {
  using P = Plan<BN, KN>;
  // above 48 KB of shared memory only on request; once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      skinny_matmul_kernel<T, BN, KN>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (attr != cudaSuccess) return int(attr);
  CUtensorMap xmap, wmap, omap;
  int rc = encode_2d<T>(&xmap, x, M, K, ldx, kBM, kBK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = KN ? encode_2d<T>(&wmap, w, K, N, N, kBK, 64, CU_TENSOR_MAP_SWIZZLE_128B)
            : encode_2d<T>(&wmap, w, N, K, K, BN, kBK, CU_TENSOR_MAP_SWIZZLE_128B);
  // TMA needs a row pitch that is a multiple of 16 bytes: N % 8 == 0
  const int tma_store = N % 8 == 0;
  if (rc == 0 && tma_store)
    rc = encode_2d<T>(&omap, o, M, N, N, 64, kOutCols, CU_TENSOR_MAP_SWIZZLE_64B);
  else if (rc == 0)
    memset(&omap, 0, sizeof(omap));
  if (rc != 0) return rc;
  const int tiles = ((M + kBM - 1) / kBM) * ((N + BN - 1) / BN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  skinny_matmul_kernel<T, BN, KN><<<grid, kThreads, P::kSmem, stream>>>(
      xmap, wmap, omap, static_cast<const T*>(bias), static_cast<T*>(o), M, N, K, tma_store);
  return int(cudaGetLastError());
}

template <typename T, bool KN>
int dispatch_bn(const void* x, const void* w, const void* bias, void* o, int M, int N, int K,
                int64_t ldx, int bn, cudaStream_t s) {
  switch (bn) {
    case 128: return launch<T, 128, KN>(x, w, bias, o, M, N, K, ldx, s);
    case 160: return launch<T, 160, KN>(x, w, bias, o, M, N, K, ldx, s);
    case 256: return launch<T, 256, KN>(x, w, bias, o, M, N, K, ldx, s);
    default: return -1;
  }
}

template <typename T>
int dispatch(const void* x, const void* w, const void* bias, void* o, int M, int N, int K,
             int64_t ldx, int w_kn, int bn, cudaStream_t s) {
  return w_kn ? dispatch_bn<T, true>(x, w, bias, o, M, N, K, ldx, bn, s)
              : dispatch_bn<T, false>(x, w, bias, o, M, N, K, ldx, bn, s);
}

}  // namespace

// x: [M, K] of `dtype` (0 = bf16, 1 = fp16), unit stride along K, row stride
// ldx; w: contiguous [N, K], or [K, N] with w_kn = 1; bias: [N] or null; o:
// contiguous [M, N]. K, ldx (and N with w_kn) multiples of 8; x and w 16-byte
// aligned; bn (the tile width) 128, 160 or 256. Returns 0, the CUDA error of
// the launch (> 0), -1 for arguments it does not take, or a tensor-map error
// (hopper_common.cuh).
extern "C" int skinny_matmul(const void* x, const void* w, const void* bias, void* o,
                             long long M, long long N, long long K, long long ldx, int dtype,
                             int w_kn, int bn, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M > 0x7fffffffLL || N > 0x7fffffffLL || K > 0x7fffffffLL)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<__nv_bfloat16>(x, w, bias, o, int(M), int(N), int(K), ldx, w_kn, bn, s);
  if (dtype == 1)
    return dispatch<__half>(x, w, bias, o, int(M), int(N), int(K), ldx, w_kn, bn, s);
  return -1;
}
