// Skinny-N matrix product in fp32 for Hopper (sm_90a): o = x . w^T (+ bias), fp32 in
// and out, summed in 3xTF32 on the tensor cores.
//
// Replaces, for fp32 inputs: tools/pallas_skinny_matmul.py::_mm_kernel (reached
// through _mm_call, the _matmul custom VJP, matmul_2d and pallas_dense_dot). The
// JAX gate sends every product whose x and weight share one dtype into that
// kernel, fp32 as well, and the custom VJP sends dx = g . w through it too: a
// model built with mixed_precision other than "bf16" runs every gated Dense
// here, forward and dx. bf16 and fp16 stay with skinny_matmul.cu.
//
// What it computes: x is [M, K] with unit stride along K and row stride ldx; w is
// [N, K] row-major (torch.nn.Linear's layout) or, for dx, [K, N] row-major (the
// stored [N_out, K_out] weight read as it lies, no transposed copy); o is [M, N]
// row-major. Each element is the sum over k of lo(x) hi(w) + hi(x) lo(w) +
// hi(x) hi(w), where hi is a value rounded to TF32 (to nearest, ties away from
// zero, as cvt.rna.tf32.f32) and lo the remainder rounded the same way; lo*lo
// (about 2^-22 of a product) is dropped. The products of each 32-deep K chunk
// are summed in fresh accumulators and added to the running sum with one
// rounded fp32 add: the tensor cores' fp32 sums truncate, and one chain of up
// to 3 x 2560 of them would drift. A bias is added to the finished fp32 sum,
// as flax's Dense adds it after its dot_general. This keeps fp32 accuracy, so
// it is not a TF32 pass: torch.backends.cuda.matmul.allow_tf32 does not gate it.
//
// What bounds it on the H100: at the UNet's shapes (M = 2k-65k rows, K and N
// 320-2560) 3 x 2MKN operations at the dense TF32 rate (495 TFLOP/s), above the
// bytes of x, w and o in fp32 at 3.35 TB/s. Within the SM, shared memory comes
// next: wgmma reads tf32 only K-major, so the split hi / lo operands are staged
// there, and each 8-deep step's three products read A and B three times (18 KB
// a warpgroup for 190 clocks of tensor work, at 128 bytes a clock).
//
// What the design does about it: the shape of the 16-bit kernel (a persistent
// grid, one block of 384 threads per SM walking the 128 x 128 output tiles with N
// fastest, so that x is read from memory about once and the weight stays in the
// 50 MB L2; a ring of stages with full / empty mbarriers; two consumer
// warpgroups of 64 rows each) with the producer warpgroup doing the split: its
// 128 threads load a 32-deep K chunk of x (128 rows) and of w (128 rows, or 32
// rows of [K, N]) with 16-byte loads, split every value into hi and lo in
// registers, and write them into K-major, 128-byte-swizzled hi / lo tiles of the
// stage (for dx the [K, N] chunk is written transposed on the way, the stores
// conflict-free); the loads of a chunk are in flight while the producer waits
// for its stage to come back. The consumers run wgmma.mma_async m64n128k8 tf32
// from shared memory, per 8-deep step lo(x) hi(w), hi(x) lo(w), hi(x) hi(w)
// into the chunk's accumulators, and add them to the running sums once the
// chunk is done; the epilogue adds the bias and stores from registers. Ragged
// M, N and K load as zeros and are not stored. The tile is 128 x 128 at every
// N: the running sums and the chunk's sums hold 128 registers a thread, and a
// block of 12 warps gets at most 168, so no wider tile fits; a 64-column tile
// ran slower at every routed product on an H100 (its x tile read by wgmma as
// often for half the work).
//
// Interface: plain C (loaded with ctypes). The caller allocates o and counts
// one launch per call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"   // mbarriers, wgmma descriptors and fences, sm_count

namespace {

using namespace hopper;

constexpr int kThreads = 384;            // producer warpgroup + 2 consumer warpgroups
constexpr int kBM = 128;                 // rows of an output tile, 64 per consumer
constexpr int kBN = 128;                 // columns of an output tile
constexpr int kBK = 32;                  // depth of a K chunk: one 128-byte row of fp32
constexpr int kRow = kBK * 4;            // bytes of a tile row
constexpr int kXTile = kBM * kRow;       // an x hi or lo tile (16 KB)
constexpr int kSmemLimit = 232448;       // dynamic shared memory a block may have

constexpr int kWTile = kBN * kRow;      // a w hi or lo tile (16 KB)
constexpr int kStageBytes = 2 * kXTile + 2 * kWTile;   // x hi, x lo, w hi, w lo
constexpr int kStages = (kSmemLimit - 1024 - 128) / kStageBytes;   // 3
constexpr int kSmem = 1024 + kStages * kStageBytes + 16 * kStages;
constexpr int kWLoads = kBN / 16;        // 16-byte loads of w a producer thread makes a chunk
static_assert(kStages >= 2 && kSmem <= kSmemLimit, "skinny_matmul_f32: shared memory plan");

// x rounded to TF32 to nearest, ties away from zero (cvt.rna.tf32.f32 for every
// finite x and inf) by two integer instructions, and x = hi + lo to about 2^-22
// of x: as flash_attention_f32.cu splits its operands.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// Byte offset of (row r, column c) in a K-major tile of 32 fp32 columns, 128-byte
// swizzled as wgmma reads it (the 16-byte unit XOR the row % 8).
__device__ __forceinline__ uint32_t tile_off(int r, int c) {
  return r * kRow + ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2));
}

// Columns c..c+3 of row r, split, into the hi and lo tiles: two 16-byte stores.
__device__ __forceinline__ void put_row4(unsigned char* hi, unsigned char* lo, int r, int c,
                                         float4 v) {
  uint4 h, l;
  split(v.x, h.x, l.x);
  split(v.y, h.y, l.y);
  split(v.z, h.z, l.z);
  split(v.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi + tile_off(r, c)) = h;
  *reinterpret_cast<uint4*>(lo + tile_off(r, c)) = l;
}

// Rows r..r+3 of column c (four values along N of a [K, N] row), split, into the
// hi and lo tiles: the transpose of dx's weight chunk.
__device__ __forceinline__ void put_col4(unsigned char* hi, unsigned char* lo, int r, int c,
                                         float4 v) {
  const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t h, l;
    split(vs[e], h, l);
    *reinterpret_cast<uint32_t*>(hi + tile_off(r + e, c)) = h;
    *reinterpret_cast<uint32_t*>(lo + tile_off(r + e, c)) = l;
  }
}

__device__ __forceinline__ float4 load4(const float* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// wgmma's descriptor of k step kk (8 columns, 32 bytes along the rows) of a tile
// at shared address a.
__device__ __forceinline__ uint64_t tile_desc(uint32_t a, int kk) {
  return wgmma_desc_sw128(a + kk * 32, 16, 1024);
}

#define SKINNY_F32_D8(i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A . B for a 64 x 8 A and an 8 x 128 B of tf32 values, both K-major in
// shared memory (descriptors a, b); scale_d = 0 overwrites d.
__device__ __forceinline__ void mma_tf32(float (&d)[kBN / 2], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : SKINNY_F32_D8(0), SKINNY_F32_D8(8), SKINNY_F32_D8(16), SKINNY_F32_D8(24),
        SKINNY_F32_D8(32), SKINNY_F32_D8(40), SKINNY_F32_D8(48), SKINNY_F32_D8(56)
      : "l"(a), "l"(b), "r"(scale_d));
}

#undef SKINNY_F32_D8

template <bool KN>
__global__ void __launch_bounds__(kThreads, 1)
skinny_matmul_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ bias, float* __restrict__ o, int M, int N,
                         int K, int64_t ldx) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle patterns repeat every 1024 bytes: align the tiles to them
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int tiles_n = (N + kBN - 1) / kBN;
  const int tiles = ((M + kBM - 1) / kBM) * tiles_n;
  const int chunks = (K + kBK - 1) / kBK;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 4);      // one arrival per producer warp
      mbar_init(&empty[s], 8);     // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the producer warpgroup: load, split, stage
    const int pt = threadIdx.x, pw = pt / 32;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * kBN;
      for (int kc = 0; kc < chunks; ++kc) {
        const int k0 = kc * kBK;
        // x: 128 rows x 8 16-byte units, a warp 4 whole 128-byte rows a load
        float4 xv[8], wv[kWLoads];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int idx = pt + 128 * i, k = k0 + (idx % 8) * 4;
          const int64_t row = int64_t(m0) + idx / 8;
          xv[i] = load4(x + row * ldx + k, row < M && k < K);
        }
        // w: 128 rows x 8 units ([N, K]), or 32 K rows x 32 units ([K, N]), a
        // warp 16 K rows x 2 units a load (so that the transposed stores below
        // meet every bank once)
#pragma unroll
        for (int i = 0; i < kWLoads; ++i) {
          if constexpr (KN) {
            const int b = i * 4 + pw;
            const int k = k0 + (b % 2) * 16 + lane % 16;
            const int n = n0 + ((b / 2) * 2 + lane / 16) * 4;
            wv[i] = load4(w + int64_t(k) * N + n, k < K && n < N);
          } else {
            const int idx = pt + 128 * i, n = n0 + idx / 8, k = k0 + (idx % 8) * 4;
            wv[i] = load4(w + int64_t(n) * K + k, n < N && k < K);
          }
        }
        mbar_wait(&empty[stage], phase ^ 1);   // the first round passes at once
        unsigned char* st = smem + stage * kStageBytes;
        unsigned char* wst = st + 2 * kXTile;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int idx = pt + 128 * i;
          put_row4(st, st + kXTile, idx / 8, (idx % 8) * 4, xv[i]);
        }
#pragma unroll
        for (int i = 0; i < kWLoads; ++i) {
          if constexpr (KN) {
            const int b = i * 4 + pw;
            put_col4(wst, wst + kWTile, ((b / 2) * 2 + lane / 16) * 4,
                     (b % 2) * 16 + lane % 16, wv[i]);
          } else {
            const int idx = pt + 128 * i;
            put_row4(wst, wst + kWTile, idx / 8, (idx % 8) * 4, wv[i]);
          }
        }
        // the tiles are read by wgmma (the async proxy) after the barrier
        fence_proxy_async_shared();
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[stage]);
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    // the consumer warpgroups: 64 rows of each tile each
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, g = lane / 4, t = lane % 4;
    float acc[kBN / 2], part[kBN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * kBN;
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
      for (int kc = 0; kc < chunks; ++kc) {
        mbar_wait_lo(&full[stage], phase);
        __syncwarp();                      // converged for the .aligned wgmma ops
        const uint32_t xh = smem_u32(smem + stage * kStageBytes) + cw * 64 * kRow;
        const uint32_t xl = xh + kXTile;
        const uint32_t wh = smem_u32(smem + stage * kStageBytes + 2 * kXTile);
        const uint32_t wl = wh + kWTile;
        wgmma_fence();
        fence_operands(part);
#pragma unroll
        for (int kk = 0; kk < kBK / 8; ++kk) {
          // the small terms first: lo hi, hi lo, then hi hi
          mma_tf32(part, tile_desc(xl, kk), tile_desc(wh, kk), kk != 0);
          mma_tf32(part, tile_desc(xh, kk), tile_desc(wl, kk), 1);
          mma_tf32(part, tile_desc(xh, kk), tile_desc(wh, kk), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(part);
        if (lane == 0) mbar_arrive(&empty[stage]);
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) acc[i] += part[i];
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
      // epilogue: the bias added to the sum, stored from registers (8-byte
      // pairs where N is even)
      const int64_t row0 = int64_t(m0) + cw * 64 + warp * 16 + g;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + j * 8 + 2 * t;
        if (col >= N) continue;
        const bool two = col + 1 < N;
        float b0 = 0.f, b1 = 0.f;
        if (bias != nullptr) {
          b0 = __ldg(bias + col);
          if (two) b1 = __ldg(bias + col + 1);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t row = row0 + 8 * h;
          if (row >= M) continue;
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (bias != nullptr) {
            v0 += b0;
            v1 += b1;
          }
          float* out = o + row * N + col;
          if (two && N % 2 == 0) {
            *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
          } else {
            out[0] = v0;
            if (two) out[1] = v1;
          }
        }
      }
    }
  }
}

template <bool KN>
int launch(const float* x, const float* w, const float* bias, float* o, int M, int N, int K,
           int64_t ldx, cudaStream_t stream) {
  // above 48 KB of shared memory only on request; once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      skinny_matmul_f32_kernel<KN>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return int(attr);
  const int64_t tiles = int64_t((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  if (tiles > 0x7fffffffLL) return -1;
  const int grid = tiles < sm_count() ? int(tiles) : sm_count();
  skinny_matmul_f32_kernel<KN><<<grid, kThreads, kSmem, stream>>>(x, w, bias, o, M, N, K, ldx);
  return int(cudaGetLastError());
}

}  // namespace

// x: fp32 [M, K], unit stride along K, row stride ldx; w: contiguous fp32 [N, K],
// or [K, N] with w_kn = 1; bias: fp32 [N] or null; o: contiguous fp32 [M, N]. K and
// ldx (and N with w_kn) multiples of 4; x and w 16-byte aligned. Returns 0, the
// CUDA error of the launch (> 0), or -1 for arguments it does not take.
extern "C" int skinny_matmul_f32(const void* x, const void* w, const void* bias, void* o,
                                 long long M, long long N, long long K, long long ldx,
                                 int w_kn, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M > 0x7fffffffLL || N > 0x7fffffffLL || K > 0x7fffffffLL)
    return -1;
  if (K % 4 != 0 || ldx % 4 != 0 || ldx < K || (w_kn && N % 4 != 0) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 != 0)
    return -1;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w_kn ? launch<true>(xf, wf, bf, of, int(M), int(N), int(K), ldx, s)
              : launch<false>(xf, wf, bf, of, int(M), int(N), int(K), ldx, s);
}
