// Device helpers shared by the flash-attention kernels (forward, dQ, dK/dV):
// tile sizes, cp.async copies into padded shared tiles, mma.sync m16n8k16 for
// bf16 / fp16 with fp32 accumulators, and the fragment loads around it.
//
// Fragment layouts of mma.sync m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16 row-major: a0 (row g, cols 2t..2t+1), a1 (row g+8, same cols),
//                      a2 (row g, cols 2t+8..2t+9), a3 (row g+8, same cols);
//   B 16x8 "col":      b0 (k rows 2t..2t+1, col g), b1 (k rows 2t+8..2t+9, col g);
//   C 16x8:            c0,c1 (row g, cols 2t..2t+1), c2,c3 (row g+8, same cols).
// The C fragments of two neighbouring 8-column tiles are, once packed to 16
// bits, the A fragment of a 16-deep product: a product's result feeds the next
// product from registers (`pack_a`).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int kTile = 64;       // rows of every q / kv tile (16 per warp)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;         // row padding in elements (16 bytes): conflict-free fragment loads
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Async copies global -> shared; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

template <typename T> struct MmaOp;

template <> struct MmaOp<__nv_bfloat16> {
  __device__ __forceinline__ static void run(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <> struct MmaOp<__half> {
  __device__ __forceinline__ static void run(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// Copy ROWS rows of D elements (row r at src + r*stride) into a padded shared
// tile; rows >= valid are zero-filled.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t stride, int valid) {
  constexpr int kVecPerRow = D / 8;  // 16-byte vectors of 8 elements
  constexpr int kVecs = ROWS * kVecPerRow;
  for (int i = threadIdx.x; i < kVecs; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 8;
    const bool ok = r < valid;
    const T* g = src + (ok ? static_cast<int64_t>(r) * stride : 0) + c;
    cp_async16(dst + r * (D + kPad) + c, g, ok ? 16 : 0);
  }
}

// Copy kTile fp32 values src[0..valid) into dst, zero-filling the rest. Used by
// threads [first, first + kTile) of the block.
__device__ __forceinline__ void load_row_vector(float* dst, const float* src, int valid,
                                                int first) {
  const int i = threadIdx.x - first;
  if (i >= 0 && i < kTile) {
    const bool ok = i < valid;
    cp_async4(dst + i, src + (ok ? i : 0), ok ? 4 : 0);
  }
}

// The A fragments of 16 rows x D columns of a padded shared tile (the rows of
// one warp), for the D/16 k-steps of a product over D.
template <typename T, int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4], const T* rows,
                                             int g, int t) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + 2 * t;
    a[ks][0] = *reinterpret_cast<const uint32_t*>(rows + g * LD + c);
    a[ks][1] = *reinterpret_cast<const uint32_t*>(rows + (g + 8) * LD + c);
    a[ks][2] = *reinterpret_cast<const uint32_t*>(rows + g * LD + c + 8);
    a[ks][3] = *reinterpret_cast<const uint32_t*>(rows + (g + 8) * LD + c + 8);
  }
}

// acc[n] += A(16 x D, from registers) * rows(n*8 .. n*8+7 of tile)^T for the
// kTile/8 column tiles: the product of a warp's rows with every row of a
// shared tile (B read straight from the tile's rows, which are its columns).
// acc is added to, not cleared.
template <typename T, int D>
__device__ __forceinline__ void mma_rows_t(float (&acc)[kTile / 8][4],
                                           const uint32_t (&a)[D / 16][4],
                                           const T* tile, int g, int t) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int n = 0; n < kTile / 8; ++n) {
    const T* r = tile + (n * 8 + g) * LD + 2 * t;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(r + ks * 16);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(r + ks * 16 + 8);
      MmaOp<T>::run(acc[n], a[ks], b0, b1);
    }
  }
}

// A fragment for k-step kk of a product over kTile columns, from the fp32 C
// fragments of column tiles 2kk and 2kk+1, rounded to T.
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = MmaOp<T>::pack(c0[0], c0[1]);
  a[1] = MmaOp<T>::pack(c0[2], c0[3]);
  a[2] = MmaOp<T>::pack(c1[0], c1[1]);
  a[3] = MmaOp<T>::pack(c1[2], c1[3]);
}

// acc[0..D/8) += A(16 x 16, k-step kk) * tile[kk*16 .. kk*16+15][0..D): the
// product with a [k][n] row-major shared tile, its fragments read transposed
// by ldmatrix.
template <typename T, int D>
__device__ __forceinline__ void mma_a_tile(float (&acc)[D / 8][4], const uint32_t (&a)[4],
                                           const T* tile, int kk, int lane) {
  constexpr int LD = D + kPad;
  const int mi = lane / 8;
  const int row = kk * 16 + (mi & 1) * 8 + (lane % 8);
#pragma unroll
  for (int nd = 0; nd < D / 16; ++nd) {
    const int col = nd * 16 + (mi >> 1) * 8;
    uint32_t b0, b1, b2, b3;
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
        : "r"(smem_addr(tile + row * LD + col)));
    MmaOp<T>::run(acc[2 * nd], a, b0, b1);
    MmaOp<T>::run(acc[2 * nd + 1], a, b2, b3);
  }
}

}  // namespace flash
