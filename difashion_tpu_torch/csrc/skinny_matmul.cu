// Skinny-N matrix product for Hopper (sm_90a): o = x . w^T, bf16 / fp16 in and
// out, fp32 accumulators, rounded once to the input type.
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
// w is [N, K] row-major, the layout of torch.nn.Linear's weight, which is the
// column-major B operand that mma.sync wants, so no transpose is made; o is
// [M, N] row-major. Every output element is one fp32 sum over K, rounded once
// (preferred_element_type=float32, then astype, in the TPU kernel). No bias:
// the caller adds it, as flax's Dense does after its dot_general.
//
// What bounds it on the H100: at the UNet's shapes (M = 16k-262k rows, K and N
// 320-2560) a product does 2MKN operations on 2(MK + KN + MN) bytes, 100-600
// operations a byte, above the card's ~295: the tensor cores bound the large
// ones, memory the K = N = 320 ones.
//
// What the design does about it: one block of 256 threads (8 warps as 4 x 2)
// per 128-row x BN-column output tile (BN = 128, or 64 where N is not a
// multiple of 128, so that N = 320 is 5 whole tiles), a loop over K in chunks
// of 64 with the x and w chunks in a ring of 3 stages in shared memory, filled
// by cp.async two chunks ahead of the tensor cores (a product's K is only 5-40
// chunks, so the ring's fill is a large share of a block's time), then
// ldmatrix fragments and mma.sync m16n8k16 with fp32 accumulators in
// registers (64 a thread at BN = 128). The TPU design keeps the whole weight
// resident; here the weight (200 KB to 3.3 MB on the route) stays in the 50 MB
// L2, and the N tiles of one M tile run in neighbouring blocks (blockIdx.x), so
// each x tile is read from memory about once. Ragged M, N and K edges are
// zero-filled on load and masked on store; row offsets are 64-bit (M reaches
// 262,144 rows at the VAE encode's batch of 64). wgmma, TMA and a persistent
// schedule are later work.
//
// Interface: plain C (loaded with ctypes). The caller allocates o and counts
// one launch per call.

#include "flash_common.cuh"

namespace {

using flash::cp_async16;
using flash::cp_async_commit;
using flash::cp_async_wait;
using flash::MmaOp;
using flash::smem_addr;

constexpr int kThreads = 256;
constexpr int kBM = 128;           // rows of an output tile (32 per warp row)
constexpr int kBK = 64;            // depth of a K chunk
constexpr int kLD = kBK + 8;       // padded shared row: 144 bytes, conflict-free ldmatrix
constexpr int kStages = 3;         // chunks in flight: the ring of shared tiles
constexpr int kWarpsM = 4, kWarpsN = 2;

template <int BN>
constexpr int smem_bytes() {
  return kStages * (kBM + BN) * kLD * 2;  // 16-bit elements
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Copy a ROWS x kBK chunk (rows row0.., columns k0..) of a row-major matrix
// with `ld` elements per row into a padded shared tile; rows >= rows_valid and
// columns >= k_valid are zero-filled (k_valid is a multiple of 8).
template <typename T, int ROWS>
__device__ __forceinline__ void load_chunk(T* dst, const T* __restrict__ src, int64_t ld,
                                           int64_t row0, int64_t rows_valid, int k0,
                                           int k_valid) {
  constexpr int kVecPerRow = kBK / 8;
  constexpr int kVecs = ROWS * kVecPerRow;
  for (int i = threadIdx.x; i < kVecs; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 8;
    const bool ok = row0 + r < rows_valid && k0 + c < k_valid;
    const T* g = ok ? src + (row0 + r) * ld + k0 + c : src;
    cp_async16(dst + r * kLD + c, g, ok ? 16 : 0);
  }
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
skinny_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ o,
                     int64_t M, int N, int K, int64_t ldx) {
  constexpr int kWN = BN / kWarpsN;  // columns of a warp's tile
  constexpr int kNT = kWN / 8;       // n8 tiles of a warp
  constexpr int kMT = kBM / kWarpsM / 16;  // m16 tiles of a warp (2)
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);   // [kStages][kBM * kLD]
  T* ws = xs + kStages * kBM * kLD;     // [kStages][BN * kLD]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int64_t m0 = int64_t(blockIdx.y) * kBM;
  const int n0 = blockIdx.x * BN;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int chunks = (K + kBK - 1) / kBK;
  // one commit group per chunk, empty past the last, so that waiting for all
  // but the newest kStages - 2 groups always means the oldest chunk is in
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < chunks) {
      load_chunk<T, kBM>(xs + st * kBM * kLD, x, ldx, m0, M, st * kBK, K);
      load_chunk<T, BN>(ws + st * BN * kLD, w, K, n0, N, st * kBK, K);
    }
    cp_async_commit();
  }

  // ldmatrix addresses: A (16 x 16 of x) row lane % 16, column (lane / 16) * 8;
  // B (two n8 tiles x 16 of w) row (lane & 7) + (lane / 16) * 8, column
  // ((lane / 8) & 1) * 8
  const int a_row = wm * (kBM / kWarpsM) + (lane & 15), a_col = (lane >> 4) * 8;
  const int b_row = wn * kWN + (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;

  for (int kc = 0; kc < chunks; ++kc) {
    cp_async_wait<kStages - 2>();
    // chunk kc has landed for every thread, and every warp is done with chunk
    // kc - 1, whose stage the next load overwrites
    __syncthreads();
    const int next = kc + kStages - 1;
    if (next < chunks) {
      const int ns = next % kStages;
      load_chunk<T, kBM>(xs + ns * kBM * kLD, x, ldx, m0, M, next * kBK, K);
      load_chunk<T, BN>(ws + ns * BN * kLD, w, K, n0, N, next * kBK, K);
    }
    cp_async_commit();
    const T* xt = xs + (kc % kStages) * kBM * kLD;
    const T* wt = ws + (kc % kStages) * BN * kLD;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        ldmatrix_x4(a[i], xt + (a_row + i * 16) * kLD + kk + a_col);
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        uint32_t b[4];  // b0, b1 of n8 tile j, then of tile j + 1
        ldmatrix_x4(b, wt + (b_row + j * 8) * kLD + kk + b_col);
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          MmaOp<T>::run(acc[i][j], a[i], b[0], b[1]);
          MmaOp<T>::run(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }

  // epilogue: c0, c1 at (row g, columns 2t, 2t + 1), c2, c3 at row g + 8
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t row = m0 + wm * (kBM / kWarpsM) + i * 16 + g + half * 8;
      if (row >= M) continue;
      T* out = o + row * N;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int col = n0 + wn * kWN + j * 8 + 2 * t;
        const float v0 = acc[i][j][2 * half], v1 = acc[i][j][2 * half + 1];
        if (pairs && col + 1 < N) {
          *reinterpret_cast<uint32_t*>(out + col) = MmaOp<T>::pack(v0, v1);
        } else {
          const uint32_t p = MmaOp<T>::pack(v0, v1);
          const T* e = reinterpret_cast<const T*>(&p);
          if (col < N) out[col] = e[0];
          if (col + 1 < N) out[col + 1] = e[1];
        }
      }
    }
  }
}

template <typename T, int BN>
int launch(const void* x, const void* w, void* o, int64_t M, int N, int K, int64_t ldx,
           cudaStream_t stream) {
  // above 48 KB of shared memory only on request; once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      skinny_matmul_kernel<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<BN>());
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid(static_cast<unsigned>((N + BN - 1) / BN),
                  static_cast<unsigned>((M + kBM - 1) / kBM));
  skinny_matmul_kernel<T, BN><<<grid, kThreads, smem_bytes<BN>(), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(o), M, N, K, ldx);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* w, void* o, int64_t M, int N, int K, int64_t ldx,
             cudaStream_t s) {
  return N % 128 == 0 ? launch<T, 128>(x, w, o, M, N, K, ldx, s)
                      : launch<T, 64>(x, w, o, M, N, K, ldx, s);
}

}  // namespace

// x: [M, K] of `dtype` (0 = bf16, 1 = fp16), unit stride along K, row stride
// ldx; w: contiguous [N, K]; o: contiguous [M, N]. K, ldx multiples of 8, x and
// w 16-byte aligned; ceil(M / 128) <= 65535 (the grid's y limit). Returns the
// CUDA error of the launch.
extern "C" int skinny_matmul(const void* x, const void* w, void* o, long long M, long long N,
                             long long K, long long ldx, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<__nv_bfloat16>(x, w, o, M, int(N), int(K), ldx, s);
  if (dtype == 1)
    return dispatch<__half>(x, w, o, M, int(N), int(K), ldx, s);
  return -1;
}
