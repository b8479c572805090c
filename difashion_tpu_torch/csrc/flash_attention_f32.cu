// Flash attention in fp32 for Hopper (sm_90a): forward, dQ and dK/dV on fp32 q, k, v.
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
//   dQ:      dQ = scale * [P * (dO V^T - D)] K, P = exp2(scale log2e Q K^T - LSE log2e);
//   dK/dV:   dV = P^T dO, dK = scale * [P * (dO V^T - D)]^T Q.
// The precise exp2f throughout; the forward's online softmax in the base-2
// domain (scale * log2e folded into the scores), its LSE m ln2 + log(l);
// columns >= Skv masked in place (-inf in the forward, P = 0 in the
// backward), query rows past Sq given P = 0; rows past Sq or Skv zero-filled
// on load and not stored. No rounding to 16 bits and no atomics: each output
// element is summed by one thread in a fixed order (the dK/dV split path's
// partial sums in split order), so repeats are bit-identical.
//
// All three run on the tensor cores in 3xTF32, at fp32 accuracy: every fp32
// operand x of a product is split into hi = x rounded to TF32 (as
// cvt.rna.tf32.f32: to nearest, ties away) and lo = x - hi rounded the same
// way, and each product adds lo*hi' + hi*lo' + hi*hi' (the small terms
// first) into fp32 accumulators; lo*lo' (about 2^-22 of a product) is
// dropped. A tile's products are summed in fresh accumulators and added to
// the running sums with one rounded add (the tensor cores' sums truncate).
// That is a choice of these kernels for fp32 inputs, not TF32 arithmetic: it
// keeps fp32 accuracy, so `torch.backends.cuda.matmul.allow_tf32` (which
// permits one TF32 pass with 10-bit operands) does not gate it. What bounds
// them on the H100: 3 x the products' operations at the dense TF32 rate
// (495 TFLOP/s). Two designs (scripts/tf32_chain.py compares their product
// chains on the card), chosen on the C side per call:
//   - wgmma (fwd_wg_kernel, dq_wg_kernel, dkv_wg_kernel), at head dims
//     33..64 with 16-byte rows (sd2_base's 64, sd15's 40): wgmma reads tf32
//     only K-major from shared memory, so the owned side (Q, Q and dO, or K
//     and V) is split once into hi / lo tiles, and every streamed tile is
//     split by the block's threads into hi / lo tiles and, for the product
//     that takes it as B (P V, dS K, P^T dO, dS^T Q), transposed hi / lo
//     tiles; the score tiles' accumulators become the A fragments of the
//     next product in registers. Two warpgroups share each staged tile. The
//     backward's 195-224 KB of tiles leave room for one stage (the next
//     tile's rows wait in registers during this tile's products); the
//     forward's 64 KB a stage leave room for two, so the next tile is split
//     into the other stage beside this tile's score product.
//   - mma.sync (fwd_tc_kernel, dq_tc_kernel, dkv_tc_kernel), at every other
//     head dim: a block of 4 warps owns 64 rows (16 a warp), keeps its owned
//     tiles in shared memory, streams the other side's two through a 2-stage
//     cp.async ring (16-byte copies where d, the strides and the bases allow
//     it, 4-byte ones otherwise: any d), and splits fragments in registers.
//     Tiles are unpadded, 32-float groups of a row XOR-swizzled by the row
//     (`swz`), so that both fragment shapes read conflict-free: 8-byte pairs
//     along a row (the k of Q K^T and dO V^T, permuted so that k slots t and
//     t + 4 are columns 2t and 2t + 1), and single floats down a column (the
//     k of P V, dS K, P^T dO, dS^T Q, whose A fragments are the score
//     accumulators themselves, with the same permutation: no shuffles).
//   - dK/dV with few KV tiles (the 77-token cross-attention at 4096 tokens)
//     splits the query range into parts, writes each part's fp32 partial sums
//     to a workspace, and a second kernel adds them in split order.
// The forward keeps its online softmax on the score accumulators in
// registers: a row's 64 scores of a tile lie with the 4 threads of a quad,
// which take its max and sum by two shuffles each.
//
// Interface: plain C (loaded with ctypes), the same arguments as the 16-bit
// kernels (dtype 2 = fp32). Tensors are addressed by element strides for batch,
// head and sequence (the last dim contiguous, any other strides).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"   // wgmma (tf32), descriptors, fences, named barriers

namespace {

constexpr int kRows = 64;       // rows of every tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---- 3xTF32 by mma.sync -------------------------------------------------------------

constexpr int kTcThreads = 128;    // 4 warps of 16 owned rows each

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies of 16 or 4 bytes into shared memory; zeros where !ok (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Row r's XOR of column bits 3-4: 8 * ((r & 3) ^ ((r >> 2) & 1)). Over rows
// 0-3, 4-7, the even rows and the odd rows of an 8-row group it takes each of
// 0, 8, 16, 24 once, which makes both fragment reads conflict-free.
__device__ __forceinline__ int swz(int r) { return (((r & 3) ^ ((r >> 2) & 1))) << 3; }

// `valid` rows of d columns (row r at src + r * stride) into a [ROWS][DP]
// tile, swizzled, by a block of THREADS threads; the other rows and columns
// zero. vec: d, the strides and src allow 16-byte copies.
template <int DP, int ROWS = kRows, int THREADS = kTcThreads>
__device__ __forceinline__ void load_tile_async(float* dst, const float* src, int64_t stride,
                                                int valid, int d, bool vec) {
  const uint32_t base = smem_u32(dst);
  if (vec) {
    constexpr int kChunks = DP / 4;
#pragma unroll
    for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
      const int r = i / kChunks, c = (i % kChunks) * 4;
      const bool ok = r < valid && c < d;
      cp_async16(base + 4 * (r * DP + (c ^ swz(r))), ok ? src + int64_t(r) * stride + c : src, ok);
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * DP; i += THREADS) {
      const int r = i / DP, c = i % DP;
      const bool ok = r < valid && c < d;
      cp_async4(base + 4 * (r * DP + (c ^ swz(r))), ok ? src + int64_t(r) * stride + c : src, ok);
    }
  }
}

// `n` floats of a per-row vector (the LSE or D) into shared memory, zeros past n.
__device__ __forceinline__ void load_vec_async(float* dst, const float* src, int n, int i) {
  cp_async4(smem_u32(dst + i), i < n ? src + i : src, i < n);
}

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero: the
// result of cvt.rna.tf32.f32 for every finite x and for inf, by half a TF32
// unit added to the magnitude's bits (a carry moves into the exponent) and
// the 13 low bits cleared. Two integer instructions: ptxas expands the cvt
// into five (a NaN test among them), which made the splits the kernels'
// largest instruction count.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo to about 2^-22 of x, both tf32 (round to nearest, ties away).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

struct Frag {   // one operand fragment, split
  uint32_t hi[4], lo[4];
};

// c += a b over k = 8 in 3xTF32: lo*hi, hi*lo, then hi*hi. The A fragment of
// m16n8k8.tf32 is (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B is
// (k t, col g), (t + 4, g); C is (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1),
// with g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Frag& a, const float b0,
                                           const float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(c, a.lo, bh0, bh1);
  mma_tf32(c, a.hi, bl0, bl1);
  mma_tf32(c, a.hi, bh0, bh1);
}

// The lane's place in a fragment, and its swizzled offsets into a [64][DP] tile.
template <int DP>
struct Lane {
  int g, t;
  int row_off, row_x;   // row g, columns 2t, 2t + 1 (+ 8 kk, XOR row_x): rows along k
  int col_off0, col_x0; // rows 2t and 2t + 1, column g (+ 8 n, XOR col_x): columns along k
  int col_off1, col_x1;
  __device__ __forceinline__ Lane() {
    const int lane = threadIdx.x % 32;
    g = lane / 4;
    t = lane % 4;
    row_off = g * DP + 2 * t;
    row_x = swz(g);
    col_off0 = 2 * t * DP + g;
    col_x0 = swz(2 * t);
    col_off1 = (2 * t + 1) * DP + g;
    col_x1 = swz(2 * t + 1);
  }
  // X[r0 + g][8kk + 2t], X[r0 + g][8kk + 2t + 1] (r0 a multiple of 8): the k
  // slots t and t + 4 of a fragment whose k runs along X's rows
  __device__ __forceinline__ float2 pair(const float* X, int r0, int kk) const {
    return *reinterpret_cast<const float2*>(X + r0 * DP + row_off + ((8 * kk) ^ row_x));
  }
  // X[8kk + 2t][8n + g] and X[8kk + 2t + 1][8n + g]: the k slots t and t + 4 of
  // a B fragment whose k runs down X's columns
  __device__ __forceinline__ float2 down(const float* X, int kk, int n) const {
    const float* base = X + 8 * kk * DP;
    return make_float2(base[col_off0 + ((8 * n) ^ col_x0)], base[col_off1 + ((8 * n) ^ col_x1)]);
  }
};

// The split A fragment of rows r0..r0 + 15 of X over columns 8kk..8kk + 7 (k permuted).
template <int DP>
__device__ __forceinline__ Frag frag_rows(const Lane<DP>& L, const float* X, int r0, int kk) {
  const float2 top = L.pair(X, r0, kk), bot = L.pair(X, r0 + 8, kk);
  Frag f;
  split(top.x, f.hi[0], f.lo[0]);
  split(bot.x, f.hi[1], f.lo[1]);
  split(top.y, f.hi[2], f.lo[2]);
  split(bot.y, f.hi[3], f.lo[3]);
  return f;
}

// The split A fragment of an m16n8 accumulator used as the next product's A
// over its 8 columns (k slot t = column 2t, slot t + 4 = column 2t + 1).
__device__ __forceinline__ Frag frag_acc(const float (&c)[4]) {
  Frag f;
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
  return f;
}

// s[n] = X[r0..r0+15] Y[8n..8n+7]^T over DP columns for n < 8: the 16 x 64
// scores of this warp's rows against a 64-row tile.
template <int DP>
__device__ __forceinline__ void scores(float (&s)[8][4], const Lane<DP>& L, const float* X,
                                       const float* Y, int r0) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll(DP == 128 ? 2 : DP / 8)   // at 128 fully unrolled loads spilled in dK/dV
  for (int kk = 0; kk < DP / 8; ++kk) {
    const Frag x = frag_rows<DP>(L, X, r0, kk);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 y = L.pair(Y, 8 * n, kk);
      mma_3xtf32(s[n], x, y.x, y.y);
    }
  }
}

// acc[n] += A Y[:, 8n..8n+7] for n < DP / 8, A the 16 x 64 accumulator a
// (rows of this warp, columns the 64 rows of Y). The tile's product is summed
// in registers of its own and then added with one rounded fp32 add: the
// tensor cores' fp32 sums truncate, and a chain of 3 x 512 of them into one
// accumulator (a 4096-row sum) drifted to 1e-5 of the result.
template <int DP>
__device__ __forceinline__ void accumulate(float (&acc)[DP / 8][4], const float (&a)[8][4],
                                           const Lane<DP>& L, const float* Y) {
  float part[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[n][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const Frag f = frag_acc(a[kk]);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const float2 y = L.down(Y, kk, n);
      mma_3xtf32(part[n], f, y.x, y.y);
    }
  }
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] += part[n][c];
}

// Rows < valid and columns < d of this warp's 16-row share (rows r0 + g, r0 +
// g + 8 of dst), times f.
template <int DP>
__device__ __forceinline__ void store_acc(float* dst, int64_t stride, const float (&acc)[DP / 8][4],
                                          int r0, int valid, int d, float f, const Lane<DP>& L) {
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = r0 + L.g + 8 * (c >> 1), col = 8 * n + 2 * L.t + (c & 1);
      if (r < valid && col < d) dst[int64_t(r) * stride + col] = acc[n][c] * f;
    }
}

// ---- the forward's softmax and epilogue, on either accumulator -------------------------

// A thread's share of a score or output tile: slot c of 8-column group n is
// row g + 8 (c >> 1), column 8n + 2t + (c & 1), in mma.sync's m16n8
// accumulators ([n][c]) and in wgmma's ([4n + c]) alike.
template <int N>
__device__ __forceinline__ float& at(float (&a)[N][4], int n, int c) { return a[n][c]; }
__device__ __forceinline__ float& at(float (&a)[32], int n, int c) { return a[4 * n + c]; }

// The online softmax of one 64-key tile in the base-2 domain, on this
// thread's scores s (keys kv0 + 8n + 2t + (c & 1)): scaled by scale_log2,
// -inf at keys >= Skv; the rows' running max m raised to the tile's, s
// overwritten by P = exp2(x - m), this thread's shares of the rows' running
// sums l updated (a quad's four shares add up to the row's sum:
// `finish_rows`), and alpha = exp2(m before - m after), the factor by which
// the rows' earlier output sums shrink (0 on the first tile).
template <typename S>
__device__ __forceinline__ void online_softmax(S& s, float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int kv0, int t, int Skv,
                                               float scale_log2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float x = kv0 + 8 * n + 2 * t + (c & 1) < Skv ? at(s, n, c) * scale_log2 : -INFINITY;
      at(s, n, c) = x;
      mx[c >> 1] = fmaxf(mx[c >> 1], x);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffff, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffff, mx[i], 2));
    alpha[i] = exp2f(m[i] - mx[i]);
    m[i] = mx[i];
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float p = exp2f(at(s, n, c) - m[c >> 1]);
      at(s, n, c) = p;
      sum[c >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
}

// The forward's epilogue for this thread's rows row0 and row0 + 8 (ob and
// lse at row 0 of its (batch, head)): the quad's shares of each row's sum
// added, O = acc / l at columns < d (NG 8-column groups), LSE = m ln2 +
// log(l); rows >= Sq not stored.
template <int NG, typename A>
__device__ __forceinline__ void finish_rows(A& acc, const float (&m)[2], float (&l)[2], float* ob,
                                            int64_t o_ss, float* lse, int row0, int t, int Sq,
                                            int d) {
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffff, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffff, l[i], 2);
    inv[i] = 1.f / l[i];
    if (t == 0 && row0 + 8 * i < Sq) lse[row0 + 8 * i] = m[i] * kLn2 + logf(l[i]);
  }
#pragma unroll
  for (int n = 0; n < NG; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = row0 + 8 * (c >> 1), col = 8 * n + 2 * t + (c & 1);
      if (r < Sq && col < d) ob[int64_t(r) * o_ss + col] = at(acc, n, c) * inv[c >> 1];
    }
}

// The forward at any head dim: O = softmax(scale Q K^T) V and the LSE for
// 16 W Q rows a block of W warps (16 rows a warp). Q stays in shared memory;
// K and V stream through a 2-stage cp.async ring; per 64-key tile S = Q K^T
// (`scores`), the online softmax on its accumulators, O scaled by alpha and
// the tile's P V added from fresh accumulators (`accumulate`, P as the A
// operand). `fwd_tc_warps` picks W.
template <int DP, int W>
__global__ void __launch_bounds__(32 * W)
fwd_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              int H, int Sq, int Skv, int d, int64_t q_sb, int64_t q_sh, int64_t q_ss,
              int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
              int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss, float scale_log2,
              bool vec) {
  constexpr int T = kRows * DP, QR = 16 * W, NT = 32 * W;
  extern __shared__ __align__(16) float smem_tc[];
  float* sQ = smem_tc;
  float* sKV = sQ + QR * DP;   // stage s: K at sKV + 2sT, V at sKV + (2s + 1)T

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * QR;
  const int r0 = (threadIdx.x / 32) * 16;
  const Lane<DP> L;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  load_tile_async<DP, QR, NT>(sQ, q + b * q_sb + h * q_sh + int64_t(q0) * q_ss, q_ss, Sq - q0,
                              d, vec);
  load_tile_async<DP, kRows, NT>(sKV, kb, k_ss, Skv, d, vec);
  load_tile_async<DP, kRows, NT>(sKV + T, vb, v_ss, Skv, d, vec);
  cp_async_commit();
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // rows r0 + g, r0 + g + 8

  const int n_kv = (Skv + kRows - 1) / kRows;
  for (int it = 0; it < n_kv; ++it) {
    if (it + 1 < n_kv) {
      const int kv1 = (it + 1) * kRows;
      float* nxt = sKV + ((it + 1) & 1) * 2 * T;
      load_tile_async<DP, kRows, NT>(nxt, kb + int64_t(kv1) * k_ss, k_ss, Skv - kv1, d, vec);
      load_tile_async<DP, kRows, NT>(nxt + T, vb + int64_t(kv1) * v_ss, v_ss, Skv - kv1, d,
                                     vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sK = sKV + (it & 1) * 2 * T;
    float s[8][4], alpha[2];
    scores<DP>(s, L, sQ, sK, r0);   // S = Q K^T
    online_softmax(s, m, l, alpha, it * kRows, L.t, Skv, scale_log2);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] *= alpha[c >> 1];
    accumulate<DP>(acc, s, L, sK + T);   // O += P V
    __syncthreads();
  }
  finish_rows<DP / 8>(acc, m, l, o + b * o_sb + h * o_sh, o_ss, lse + int64_t(bh) * Sq,
                      q0 + r0 + L.g, L.t, Sq, d);
}

template <int DP>
__global__ void __launch_bounds__(kTcThreads)
dq_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, int H, int Sq, int Skv, int d,
             int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
             int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t do_sb,
             int64_t do_sh, int64_t do_ss, int64_t dq_sb, int64_t dq_sh, int64_t dq_ss,
             float scale, float scale_log2, bool vec) {
  constexpr int T = kRows * DP;
  extern __shared__ __align__(16) float smem_tc[];
  float* sQ = smem_tc;
  float* sDO = sQ + T;
  float* sKV = sDO + T;   // stage s: K at sKV + 2sT, V at sKV + (2s + 1)T

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kRows;
  const int r0 = (threadIdx.x / 32) * 16;
  const Lane<DP> L;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  load_tile_async<DP>(sQ, q + b * q_sb + h * q_sh + int64_t(q0) * q_ss, q_ss, Sq - q0, d, vec);
  load_tile_async<DP>(sDO, dout + b * do_sb + h * do_sh + int64_t(q0) * do_ss, do_ss, Sq - q0,
                      d, vec);
  load_tile_async<DP>(sKV, kb, k_ss, Skv, d, vec);
  load_tile_async<DP>(sKV + T, vb, v_ss, Skv, d, vec);
  cp_async_commit();
  float lse2[2], dd[2];   // rows r0 + g and r0 + g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + L.g + 8 * i;
    const bool ok = row < Sq;
    lse2[i] = ok ? lse[int64_t(bh) * Sq + row] * kLog2e : INFINITY;   // P = 0 past Sq
    dd[i] = ok ? delta[int64_t(bh) * Sq + row] : 0.f;
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  const int n_kv = (Skv + kRows - 1) / kRows;
  for (int it = 0; it < n_kv; ++it) {
    if (it + 1 < n_kv) {
      const int kv1 = (it + 1) * kRows;
      float* nxt = sKV + ((it + 1) & 1) * 2 * T;
      load_tile_async<DP>(nxt, kb + int64_t(kv1) * k_ss, k_ss, Skv - kv1, d, vec);
      load_tile_async<DP>(nxt + T, vb + int64_t(kv1) * v_ss, v_ss, Skv - kv1, d, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sK = sKV + (it & 1) * 2 * T;
    const float* sV = sK + T;
    float s[8][4], dp[8][4];
    scores<DP>(s, L, sQ, sK, r0);    // S = Q K^T
    scores<DP>(dp, L, sDO, sV, r0);  // dP = dO V^T
    const int kv0 = it * kRows;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool in = kv0 + 8 * n + 2 * L.t + (c & 1) < Skv;
        const float p = in ? exp2f(fmaf(s[n][c], scale_log2, -lse2[c >> 1])) : 0.f;
        s[n][c] = p * (dp[n][c] - dd[c >> 1]);   // dS
      }
    accumulate<DP>(acc, s, L, sK);   // dQ += dS K
    __syncthreads();
  }
  store_acc<DP>(dq + b * dq_sb + h * dq_sh + int64_t(q0) * dq_ss, dq_ss, acc, r0, Sq - q0, d,
                scale, L);
}

// ---- dQ and dK/dV at head dims 33..64 by wgmma -----------------------------------------

constexpr int kWgThreads = 256;        // 2 warpgroups

// With -DF32_PHASE_TIMES (scripts/flash_bwd_f32.py --phases), thread 0 of each
// warpgroup of dq_wg_kernel adds the clock cycles of its phases (staging,
// the barrier after it, S and dP, dS, dQ, the barrier after it) to
// g_f32_phase_cycles, for f32_phase_cycles to read back.
#ifdef F32_PHASE_TIMES
__device__ unsigned long long g_f32_phase_cycles[6];
#define F32_PHASE(i)                          \
  do {                                         \
    const long long now = clock64();           \
    phase[i] += now - stamp;                   \
    stamp = now;                               \
  } while (0)
#else
#define F32_PHASE(i) \
  do {               \
  } while (0)
#endif
constexpr int kTf = 64 * 64 * 4;       // a [64][64] tf32 operand tile: 2 chunks of [64][32]
// dQ: per warpgroup Q hi, lo, dO hi, lo; shared K hi, lo, V hi, lo, K^T hi,
// lo; and 1024 bytes to align them
constexpr int kDqWgSmem = 14 * kTf + 1024;
// dK/dV: per warpgroup K hi, lo, V hi, lo; shared, of a 32-row Q tile, Q hi,
// lo, dO hi, lo, Q^T hi, lo, dO^T hi, lo (half tiles) and its LSE and D
constexpr int kQT = 32;
constexpr int kDkvWgSmem = 8 * kTf + 8 * (kTf / 2) + 2 * kQT * 4 + 1024;
// the forward: per warpgroup Q hi, lo; shared, in each of two stages, K hi,
// lo and V^T hi, lo (197 KB)
constexpr int kFwdWgSmem = 12 * kTf + 1024;

// Byte offset of (r, c) in a tile of ROWS rows and 64 columns, K-major and
// 128-byte swizzled (the 16-byte unit XOR the row % 8, as wgmma reads it):
// two chunks of [ROWS][32 columns].
template <int ROWS>
__device__ __forceinline__ uint32_t tf_off(int r, int c) {
  const int byte = (c & 31) * 4;
  return (c >> 5) * (ROWS * 128) + r * 128 + ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15));
}

// wgmma's descriptor of k-step kk (8 columns) of such a tile at shared address a.
template <int ROWS>
__device__ __forceinline__ uint64_t tf_desc(uint32_t a, int kk) {
  return hopper::wgmma_desc_sw128(a + (kk >> 2) * (ROWS * 128) + (kk & 3) * 32, 16, 1024);
}

// Row r's column in a transposed tile (K^T, Q^T, dO^T): slot t of an 8-row
// group holds row 2t, slot t + 4 row 2t + 1, the order in which a score
// tile's accumulator registers form the A fragment of the next product (as
// `frag_acc`).
__device__ __forceinline__ int kt_col(int r) {
  return (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
}

// Columns c..c+3 of row r, split, into ROWS-row hi and lo tiles (none where
// hi is null) and, with hi_t / lo_t, into 64-row transposed ones: rows
// c..c+3, column kt_col(r).
template <int ROWS>
__device__ __forceinline__ void put4(uint8_t* hi, uint8_t* lo, int r, int c, float4 x,
                                     uint8_t* hi_t = nullptr, uint8_t* lo_t = nullptr) {
  uint4 h, l;
  split(x.x, h.x, l.x);
  split(x.y, h.y, l.y);
  split(x.z, h.z, l.z);
  split(x.w, h.w, l.w);
  if (hi != nullptr) {
    *reinterpret_cast<uint4*>(hi + tf_off<ROWS>(r, c)) = h;
    *reinterpret_cast<uint4*>(lo + tf_off<ROWS>(r, c)) = l;
  }
  if (hi_t != nullptr) {
    const int col = kt_col(r);
    const uint32_t hs[4] = {h.x, h.y, h.z, h.w}, ls[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      *reinterpret_cast<uint32_t*>(hi_t + tf_off<64>(c + e, col)) = hs[e];
      *reinterpret_cast<uint32_t*>(lo_t + tf_off<64>(c + e, col)) = ls[e];
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p, bool ok) {
  return ok ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Columns c0..c0+4N-1 of row r of n rows of d columns (row i at p + i *
// stride), zeros past them.
template <int N>
__device__ __forceinline__ void fetch(float4 (&x)[N], const float* p, int64_t stride, int r,
                                      int n, int c0, int d) {
  const float* row = p + int64_t(r) * stride;
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] = ld4(row + c0 + 4 * j, r < n && c0 + 4 * j < d);
}

// Rows r0..r0+63 of n rows of q (or k) and dO (or v), split into the K-major
// hi / lo tiles at own (q hi, lo, dO hi, lo; 4 tiles of kTf bytes), by the 128
// threads of a warpgroup (wt its thread): row wt % 64, 32 columns each.
__device__ __forceinline__ void stage_owned(uint8_t* own, const float* a, int64_t a_ss,
                                            const float* bt, int64_t b_ss, int r0, int n, int d,
                                            int wt) {
  const int r = wt & 63, c0 = (wt >> 6) * 32;
  float4 x[8], y[8];
  fetch<8>(x, a + int64_t(r0) * a_ss, a_ss, r, n - r0, c0, d);
  fetch<8>(y, bt + int64_t(r0) * b_ss, b_ss, r, n - r0, c0, d);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    put4<64>(own, own + kTf, r, c0 + 4 * j, x[j]);
    put4<64>(own + 2 * kTf, own + 3 * kTf, r, c0 + 4 * j, y[j]);
  }
}

// Rows r0..r0+63 of n rows of q split into the K-major hi / lo tiles at own,
// by the 128 threads of a warpgroup (wt its thread): row wt % 64, 32 columns
// each.
__device__ __forceinline__ void stage_q(uint8_t* own, const float* a, int64_t a_ss, int r0,
                                        int n, int d, int wt) {
  const int r = wt & 63, c0 = (wt >> 6) * 32;
  float4 x[8];
  fetch<8>(x, a + int64_t(r0) * a_ss, a_ss, r, n - r0, c0, d);
#pragma unroll
  for (int j = 0; j < 8; ++j) put4<64>(own, own + kTf, r, c0 + 4 * j, x[j]);
}

// A thread's share of a 64-key tile (key kr, columns kc..kc+15 of K and of
// V), split into a forward stage: K hi, K lo, V^T hi, V^T lo (V^T, the B of
// P V, only transposed).
__device__ __forceinline__ void stage_kv(uint8_t* st, int kr, int kc, const float4 (&pk)[4],
                                         const float4 (&pv)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    put4<64>(st, st + kTf, kr, kc + 4 * j, pk[j]);
    put4<64>(nullptr, nullptr, kr, kc + 4 * j, pv[j], st + 2 * kTf, st + 3 * kTf);
  }
}

// The forward for 33 <= d <= 64 with 16-byte rows (d, strides and bases
// multiples of 4 floats): the same function as fwd_tc_kernel<64>, its
// products by wgmma. A block of 2 warpgroups owns 128 Q rows (64 each), Q
// split once into K-major hi / lo tiles. Each 64-key tile is split by the
// block's 256 threads (one key, 16 columns of K and of V each) into K hi /
// lo and transposed V^T hi / lo tiles (P V takes V as its B, which wgmma
// reads in tf32 only K-major), in one of two stages: the next tile is split
// beside this tile's S = Q K^T, and the rows of the one after are fetched
// into registers during its softmax and P V. Per tile: S from shared memory
// into fresh accumulators, the online softmax on them, P split into A
// fragments in registers, P V into fresh accumulators, O = alpha O + P V.
__global__ void __launch_bounds__(kWgThreads, 1)
fwd_wg_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              int H, int Sq, int Skv, int d, int64_t q_sb, int64_t q_sh, int64_t q_ss,
              int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
              int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss, float scale_log2) {
  extern __shared__ unsigned char smem_wg_raw[];
  // the tiles start on a 1024-byte boundary, reached by an offset into the
  // shared array, so that the staging's stores compile to shared-memory
  // stores (STS; a pointer through uintptr_t makes them generic stores)
  uint8_t* smem_wg = smem_wg_raw + (-hopper::smem_u32(smem_wg_raw) & 1023u);
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  uint8_t* own = smem_wg + wg * 2 * kTf;   // Q hi, Q lo
  uint8_t* kvs = smem_wg + 4 * kTf;        // stage s at kvs + 4s kTf: K hi, lo, V^T hi, lo
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * 128 + wg * 64;   // this warpgroup's first row
  stage_q(own, q + b * q_sb + h * q_sh, q_ss, q0, Sq, d, wt);
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + ((wt >> 5) << 4) + g;   // this thread's rows: row0, row0 + 8
  // the KV tiles: thread tid takes key tid % 64, columns 16 (tid / 64) .. + 15
  const int kr = tid & 63, kc = (tid >> 6) * 16;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const int n_kv = (Skv + kRows - 1) / kRows;
  float4 pk[4], pv[4];
  fetch<4>(pk, kb, k_ss, kr, Skv, kc, d);
  fetch<4>(pv, vb, v_ss, kr, Skv, kc, d);
  stage_kv(kvs, kr, kc, pk, pv);
  if (n_kv > 1) {
    fetch<4>(pk, kb + int64_t(kRows) * k_ss, k_ss, kr, Skv - kRows, kc, d);
    fetch<4>(pv, vb + int64_t(kRows) * v_ss, v_ss, kr, Skv - kRows, kc, d);
  }
  const uint32_t qh = hopper::smem_u32(own), ql = qh + kTf, kv_a = hopper::smem_u32(kvs);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int it = 0; it < n_kv; ++it) {
    hopper::fence_proxy_async_shared();
    __syncthreads();   // tile it staged, and every warpgroup done with tile it - 1
    const uint32_t kh = kv_a + (it & 1) * 4 * kTf, kl = kh + kTf;
    const uint32_t vh = kh + 2 * kTf, vl = kh + 3 * kTf;
    float s[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {   // S = Q K^T: lo hi, hi lo, hi hi
      hopper::wgmma_tf32_ss64(s, tf_desc<64>(ql, kk), tf_desc<64>(kh, kk), kk != 0);
      hopper::wgmma_tf32_ss64(s, tf_desc<64>(qh, kk), tf_desc<64>(kl, kk), 1);
      hopper::wgmma_tf32_ss64(s, tf_desc<64>(qh, kk), tf_desc<64>(kh, kk), 1);
    }
    hopper::wgmma_commit();
    if (it + 1 < n_kv) {   // the next tile, split beside this tile's S
      stage_kv(kvs + ((it + 1) & 1) * 4 * kTf, kr, kc, pk, pv);
      if (it + 2 < n_kv) {
        const int kv2 = (it + 2) * kRows;
        fetch<4>(pk, kb + int64_t(kv2) * k_ss, k_ss, kr, Skv - kv2, kc, d);
        fetch<4>(pv, vb + int64_t(kv2) * v_ss, v_ss, kr, Skv - kv2, kc, d);
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_operands(s);
    float alpha[2];
    online_softmax(s, m, l, alpha, it * kRows, t, Skv, scale_log2);
    uint32_t ph[8][4], pl[8][4];   // P, split into the A fragments of k-steps j (keys 8j..8j+7)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      split(s[4 * j], ph[j][0], pl[j][0]);
      split(s[4 * j + 2], ph[j][1], pl[j][1]);
      split(s[4 * j + 1], ph[j][2], pl[j][2]);
      split(s[4 * j + 3], ph[j][3], pl[j][3]);
    }
    float part[32];   // this tile's P V, summed apart (see `accumulate`)
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) {   // P V: lo hi, hi lo, hi hi
      hopper::wgmma_tf32_rs64(part, pl[j], tf_desc<64>(vh, j), j != 0);
      hopper::wgmma_tf32_rs64(part, ph[j], tf_desc<64>(vl, j), 1);
      hopper::wgmma_tf32_rs64(part, ph[j], tf_desc<64>(vh, j), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(part);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      hopper::fence_operands(ph[j]);
      hopper::fence_operands(pl[j]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], part[i]);
  }
  finish_rows<8>(acc, m, l, o + b * o_sb + h * o_sh, o_ss, lse + int64_t(bh) * Sq, row0, t, Sq,
                 d);
}

// dQ for 33 <= d <= 64 with 16-byte rows (d, strides and bases multiples of
// 4 floats): the same function as dq_tc_kernel<64>, its products by wgmma.
// A block of 2 warpgroups owns 128 Q rows (64 each), their Q and dO split
// once into K-major hi and lo tiles. Per KV tile of 64 keys every thread
// splits its 16 columns of one K row and one V row, fetched from global
// memory during the previous tile's products, into K and V hi / lo tiles and
// transposed K^T hi / lo tiles (wgmma reads tf32 only K-major, and dQ += dS K
// takes K as its B); then S = Q K^T and dP = dO V^T from shared memory, dS in
// registers, split into A fragments, and the tile's dS K from registers into
// fresh accumulators, added once to dQ.
__global__ void __launch_bounds__(kWgThreads, 1)
dq_wg_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, int H, int Sq, int Skv, int d,
             int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
             int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t do_sb,
             int64_t do_sh, int64_t do_ss, int64_t dq_sb, int64_t dq_sh, int64_t dq_ss,
             float scale, float scale_log2) {
  extern __shared__ unsigned char smem_wg_raw[];
  // the swizzle repeats every 1024 bytes: the tiles start on such a boundary
  uint8_t* smem_wg = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_wg_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  uint8_t* own = smem_wg + wg * 4 * kTf;   // Q hi, Q lo, dO hi, dO lo
  uint8_t* kvs = smem_wg + 8 * kTf;        // K hi, K lo, V hi, V lo, K^T hi, K^T lo
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * 128 + wg * 64;   // this warpgroup's first row
  stage_owned(own, q + b * q_sb + h * q_sh, q_ss, dout + b * do_sb + h * do_sh, do_ss, q0, Sq,
              d, wt);
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + ((wt >> 5) << 4) + g;   // this thread's rows: row0, row0 + 8
  float lse2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = row0 + 8 * i < Sq;
    lse2[i] = ok ? lse[int64_t(bh) * Sq + row0 + 8 * i] * kLog2e : INFINITY;   // P = 0 past Sq
    dd[i] = ok ? delta[int64_t(bh) * Sq + row0 + 8 * i] : 0.f;
  }
  // the KV tiles: thread tid takes key row tid % 64, columns 16 (tid / 64) .. + 15
  const int kr = tid & 63, kc = (tid >> 6) * 16;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  float4 pk[4], pv[4];
  fetch<4>(pk, kb, k_ss, kr, Skv, kc, d);
  fetch<4>(pv, vb, v_ss, kr, Skv, kc, d);
  const uint32_t own_a = hopper::smem_u32(own), kv_a = hopper::smem_u32(kvs);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const int n_kv = (Skv + kRows - 1) / kRows;
#ifdef F32_PHASE_TIMES
  long long phase[6] = {}, stamp = clock64();
#endif
  for (int it = 0; it < n_kv; ++it) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      put4<64>(kvs, kvs + kTf, kr, kc + 4 * j, pk[j], kvs + 4 * kTf, kvs + 5 * kTf);
      put4<64>(kvs + 2 * kTf, kvs + 3 * kTf, kr, kc + 4 * j, pv[j]);
    }
    F32_PHASE(0);
    hopper::fence_proxy_async_shared();
    __syncthreads();
    F32_PHASE(1);
    if (it + 1 < n_kv) {   // the next tile's rows, in flight during this tile's products
      const int kv1 = (it + 1) * kRows;
      fetch<4>(pk, kb + int64_t(kv1) * k_ss, k_ss, kr, Skv - kv1, kc, d);
      fetch<4>(pv, vb + int64_t(kv1) * v_ss, v_ss, kr, Skv - kv1, kc, d);
    }
    float s[32], dp[32];
    hopper::wgmma_fence();
    // warpgroup 1 issues its S and dP after warpgroup 0's, so that each one's
    // softmax runs beside the other's products (measured: dQ 7 % faster; the
    // same in dK/dV ran 3 % slower)
    if (wg == 1) hopper::named_bar_sync(1, kWgThreads);
    const uint32_t qh = own_a, ql = own_a + kTf, oh = own_a + 2 * kTf, ol = own_a + 3 * kTf;
    const uint32_t kh = kv_a, kl = kv_a + kTf, vh = kv_a + 2 * kTf, vl = kv_a + 3 * kTf;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {   // S = Q K^T: lo hi, hi lo, hi hi
      hopper::wgmma_tf32_ss64(s, tf_desc<64>(ql, kk), tf_desc<64>(kh, kk), kk != 0);
      hopper::wgmma_tf32_ss64(s, tf_desc<64>(qh, kk), tf_desc<64>(kl, kk), 1);
      hopper::wgmma_tf32_ss64(s, tf_desc<64>(qh, kk), tf_desc<64>(kh, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {   // dP = dO V^T
      hopper::wgmma_tf32_ss64(dp, tf_desc<64>(ol, kk), tf_desc<64>(vh, kk), kk != 0);
      hopper::wgmma_tf32_ss64(dp, tf_desc<64>(oh, kk), tf_desc<64>(vl, kk), 1);
      hopper::wgmma_tf32_ss64(dp, tf_desc<64>(oh, kk), tf_desc<64>(vh, kk), 1);
    }
    hopper::wgmma_commit();
    if (wg == 0) hopper::named_bar_arrive(1, kWgThreads);
    hopper::wgmma_wait<0>();
    hopper::fence_operands(s);
    hopper::fence_operands(dp);
    F32_PHASE(2);
    // dS, split into the A fragments of k-steps j (keys 8j..8j+7)
    const int kv0 = it * kRows;
    uint32_t ah[8][4], al[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool in = kv0 + 8 * j + 2 * t + (c & 1) < Skv;
        const float p = in ? exp2f(fmaf(s[4 * j + c], scale_log2, -lse2[c >> 1])) : 0.f;
        ds[c] = p * (dp[4 * j + c] - dd[c >> 1]);
      }
      split(ds[0], ah[j][0], al[j][0]);
      split(ds[2], ah[j][1], al[j][1]);
      split(ds[1], ah[j][2], al[j][2]);
      split(ds[3], ah[j][3], al[j][3]);
    }
    F32_PHASE(3);
    float part[32];   // this tile's dS K, summed apart (see `accumulate`)
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      hopper::wgmma_tf32_rs64(part, al[j], tf_desc<64>(kv_a + 4 * kTf, j), j != 0);
      hopper::wgmma_tf32_rs64(part, ah[j], tf_desc<64>(kv_a + 5 * kTf, j), 1);
      hopper::wgmma_tf32_rs64(part, ah[j], tf_desc<64>(kv_a + 4 * kTf, j), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(part);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      hopper::fence_operands(ah[j]);
      hopper::fence_operands(al[j]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += part[i];
    F32_PHASE(4);
    __syncthreads();   // every warpgroup is done with this tile before the next is staged
    F32_PHASE(5);
  }
#ifdef F32_PHASE_TIMES
  if (wt == 0)
    for (int i = 0; i < 6; ++i) atomicAdd(&g_f32_phase_cycles[i], (unsigned long long)phase[i]);
#endif
  float* out = dq + b * dq_sb + h * dq_sh;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = row0 + 8 * (c >> 1), col = 8 * j + 2 * t + (c & 1);
      if (r < Sq && col < d) out[int64_t(r) * dq_ss + col] = acc[4 * j + c] * scale;
    }
}

// dK/dV for 33 <= d <= 64 with 16-byte rows: the same function as
// dkv_tc_kernel<64>, its products by wgmma. A block of 2 warpgroups owns 128
// KV rows (64 each), their K and V split once into K-major hi / lo tiles. Per
// Q tile of 32 rows every thread splits 8 columns of one Q row and one dO
// row, fetched during the previous tile's products, into Q and dO hi / lo
// tiles and transposed Q^T and dO^T hi / lo tiles (dK += dS^T Q and dV +=
// P^T dO take Q and dO as their B, which wgmma reads in tf32 only K-major);
// then S^T = K Q^T and dP^T = V dO^T from shared memory, P^T and dS^T in
// registers, split into A fragments, and the tile's P^T dO and dS^T Q into
// fresh accumulators, added once to dV and dK. The 32-row Q tiles keep the
// shared tiles within 195 KB; both warpgroups read each, which halves the
// splitting a product needs (measured: warpgroups on alternate Q tiles,
// each splitting its own, ran 1.2x slower). ws as for dkv_tc_kernel.
__global__ void __launch_bounds__(kWgThreads, 1)
dkv_wg_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ ws, int H,
              int Sq, int Skv, int d, int per, int64_t q_sb, int64_t q_sh, int64_t q_ss,
              int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
              int64_t v_ss, int64_t do_sb, int64_t do_sh, int64_t do_ss, int64_t dk_sb,
              int64_t dk_sh, int64_t dk_ss, int64_t dv_sb, int64_t dv_sh, int64_t dv_ss,
              float scale, float scale_log2) {
  constexpr int kH = kTf / 2;   // a 32-row Q tile, or a [64][32] transposed one
  extern __shared__ unsigned char smem_wg_raw[];
  uint8_t* smem_wg = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_wg_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  uint8_t* own = smem_wg + wg * 4 * kTf;   // K hi, K lo, V hi, V lo
  uint8_t* qs = smem_wg + 8 * kTf;         // Q hi, lo, dO hi, lo, Q^T hi, lo, dO^T hi, lo
  float* sVec = reinterpret_cast<float*>(qs + 8 * kH);   // the Q tile's LSE, then D
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const int kv0 = blockIdx.x * 128 + wg * 64, part = blockIdx.y;
  stage_owned(own, k + b * k_sb + h * k_sh, k_ss, v + b * v_sb + h * v_sh, v_ss, kv0, Skv, d,
              wt);
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  // the Q tiles: thread tid takes row tid % 32, columns 8 (tid / 32) .. + 7;
  // threads 0-63 also the tile's LSE (0-31) and D (32-63)
  const int qr = tid & 31, qc = (tid >> 5) * 8;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* dob = dout + b * do_sb + h * do_sh;
  const float* vec_src = (tid < kQT ? lse : delta) + int64_t(bh) * Sq;
  const int n_qt = (Sq + kQT - 1) / kQT;
  const int it0 = part * per, it1 = min(n_qt, it0 + per);
  float4 pq[2], pd[2];
  float pvec = 0.f;
  if (it0 < it1) {
    const int q1 = it0 * kQT;
    fetch<2>(pq, qb + int64_t(q1) * q_ss, q_ss, qr, Sq - q1, qc, d);
    fetch<2>(pd, dob + int64_t(q1) * do_ss, do_ss, qr, Sq - q1, qc, d);
    if (tid < 2 * kQT && q1 + qr < Sq) pvec = vec_src[q1 + qr];
  }
  const uint32_t own_a = hopper::smem_u32(own), qs_a = hopper::smem_u32(qs);
  const uint32_t kh = own_a, kl = own_a + kTf, vh = own_a + 2 * kTf, vl = own_a + 3 * kTf;
  const uint32_t qh = qs_a, ql = qs_a + kH, oh = qs_a + 2 * kH, ol = qs_a + 3 * kH;
  const uint32_t qth = qs_a + 4 * kH, qtl = qs_a + 5 * kH, oth = qs_a + 6 * kH,
                 otl = qs_a + 7 * kH;
  float dka[32], dva[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;

  for (int it = it0; it < it1; ++it) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      put4<kQT>(qs, qs + kH, qr, qc + 4 * j, pq[j], qs + 4 * kH, qs + 5 * kH);
      put4<kQT>(qs + 2 * kH, qs + 3 * kH, qr, qc + 4 * j, pd[j], qs + 6 * kH, qs + 7 * kH);
    }
    if (tid < 2 * kQT) sVec[tid] = pvec;
    hopper::fence_proxy_async_shared();
    __syncthreads();
    const int q0 = it * kQT;
    if (it + 1 < it1) {   // the next tile's rows, in flight during this tile's products
      const int q1 = q0 + kQT;
      fetch<2>(pq, qb + int64_t(q1) * q_ss, q_ss, qr, Sq - q1, qc, d);
      fetch<2>(pd, dob + int64_t(q1) * do_ss, do_ss, qr, Sq - q1, qc, d);
      if (tid < 2 * kQT) pvec = q1 + qr < Sq ? vec_src[q1 + qr] : 0.f;
    }
    float st[16], dpt[16];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {   // S^T = K Q^T: lo hi, hi lo, hi hi
      hopper::wgmma_tf32_ss32(st, tf_desc<64>(kl, kk), tf_desc<kQT>(qh, kk), kk != 0);
      hopper::wgmma_tf32_ss32(st, tf_desc<64>(kh, kk), tf_desc<kQT>(ql, kk), 1);
      hopper::wgmma_tf32_ss32(st, tf_desc<64>(kh, kk), tf_desc<kQT>(qh, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {   // dP^T = V dO^T
      hopper::wgmma_tf32_ss32(dpt, tf_desc<64>(vl, kk), tf_desc<kQT>(oh, kk), kk != 0);
      hopper::wgmma_tf32_ss32(dpt, tf_desc<64>(vh, kk), tf_desc<kQT>(ol, kk), 1);
      hopper::wgmma_tf32_ss32(dpt, tf_desc<64>(vh, kk), tf_desc<kQT>(oh, kk), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(st);
    hopper::fence_operands(dpt);
    // P^T and dS^T: this thread's columns are queries q0 + 8j + 2t (+ 1)
#pragma unroll
    for (int j = 0; j < kQT / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(sVec + col);
      const float2 d2 = *reinterpret_cast<const float2*>(sVec + kQT + col);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int e = c & 1;
        const float lse_c = (e ? l2.y : l2.x) * kLog2e;
        const float p = q0 + col + e < Sq ? exp2f(fmaf(st[4 * j + c], scale_log2, -lse_c)) : 0.f;
        st[4 * j + c] = p;                                            // P^T
        dpt[4 * j + c] = p * (dpt[4 * j + c] - (e ? d2.y : d2.x));    // dS^T
      }
    }
    float part[32];   // this tile's products, summed apart (see `accumulate`)
    Frag f[kQT / 8];
#pragma unroll
    for (int j = 0; j < kQT / 8; ++j) {
      const float c4[4] = {st[4 * j], st[4 * j + 1], st[4 * j + 2], st[4 * j + 3]};
      f[j] = frag_acc(c4);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kQT / 8; ++j) {   // dV += P^T dO
      hopper::wgmma_tf32_rs64(part, f[j].lo, tf_desc<64>(oth, j), j != 0);
      hopper::wgmma_tf32_rs64(part, f[j].hi, tf_desc<64>(otl, j), 1);
      hopper::wgmma_tf32_rs64(part, f[j].hi, tf_desc<64>(oth, j), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(part);
#pragma unroll
    for (int j = 0; j < kQT / 8; ++j) {
      hopper::fence_operands(f[j].hi);
      hopper::fence_operands(f[j].lo);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) dva[i] += part[i];
#pragma unroll
    for (int j = 0; j < kQT / 8; ++j) {
      const float c4[4] = {dpt[4 * j], dpt[4 * j + 1], dpt[4 * j + 2], dpt[4 * j + 3]};
      f[j] = frag_acc(c4);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kQT / 8; ++j) {   // dK += dS^T Q
      hopper::wgmma_tf32_rs64(part, f[j].lo, tf_desc<64>(qth, j), j != 0);
      hopper::wgmma_tf32_rs64(part, f[j].hi, tf_desc<64>(qtl, j), 1);
      hopper::wgmma_tf32_rs64(part, f[j].hi, tf_desc<64>(qth, j), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(part);
#pragma unroll
    for (int j = 0; j < kQT / 8; ++j) {
      hopper::fence_operands(f[j].hi);
      hopper::fence_operands(f[j].lo);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[i] += part[i];
    __syncthreads();   // every warpgroup is done with this tile before the next is staged
  }
  const int row0 = kv0 + ((wt >> 5) << 4) + g;   // this thread's rows: row0, row0 + 8
  const bool split = gridDim.y > 1;
  const int64_t part_elems = int64_t(gridDim.y) * gridDim.z * Skv * d;
  const int64_t w0 = (int64_t(part) * gridDim.z + bh) * Skv * d;
  float* gk = dk + b * dk_sb + h * dk_sh;
  float* gv = dv + b * dv_sb + h * dv_sh;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = row0 + 8 * (c >> 1), col = 8 * j + 2 * t + (c & 1);
      if (r >= Skv || col >= d) continue;
      if (split) {
        ws[w0 + int64_t(r) * d + col] = dka[4 * j + c];
        ws[part_elems + w0 + int64_t(r) * d + col] = dva[4 * j + c];
      } else {
        gk[int64_t(r) * dk_ss + col] = dka[4 * j + c] * scale;
        gv[int64_t(r) * dv_ss + col] = dva[4 * j + c];
      }
    }
}

// ws (splits > 1): the parts' fp32 partial dK, then dV, each [splits][B*H][Skv][D].
template <int DP>
__global__ void __launch_bounds__(kTcThreads)
dkv_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ ws, int H,
              int Sq, int Skv, int d, int per, int64_t q_sb, int64_t q_sh, int64_t q_ss,
              int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
              int64_t v_ss, int64_t do_sb, int64_t do_sh, int64_t do_ss, int64_t dk_sb,
              int64_t dk_sh, int64_t dk_ss, int64_t dv_sb, int64_t dv_sh, int64_t dv_ss,
              float scale, float scale_log2, bool vec) {
  constexpr int T = kRows * DP;
  extern __shared__ __align__(16) float smem_tc[];
  float* sK = smem_tc;
  float* sV = sK + T;
  float* sQD = sV + T;              // stage s: Q at sQD + 2sT, dO at sQD + (2s + 1)T
  float* sVec = sQD + 4 * T;        // stage s: LSE at sVec + 128s, D at sVec + 128s + 64

  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const int kv0 = blockIdx.x * kRows, part = blockIdx.y;
  const int r0 = (threadIdx.x / 32) * 16;
  const Lane<DP> L;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* dob = dout + b * do_sb + h * do_sh;
  const float* lb = lse + int64_t(bh) * Sq;
  const float* db = delta + int64_t(bh) * Sq;
  const int n_qt = (Sq + kRows - 1) / kRows;
  const int it0 = part * per, it1 = min(n_qt, it0 + per);

  auto load_q = [&](int it, int stage) {
    const int q0 = it * kRows;
    float* dst = sQD + stage * 2 * T;
    load_tile_async<DP>(dst, qb + int64_t(q0) * q_ss, q_ss, Sq - q0, d, vec);
    load_tile_async<DP>(dst + T, dob + int64_t(q0) * do_ss, do_ss, Sq - q0, d, vec);
    const int i = threadIdx.x % kRows;
    if (threadIdx.x < kRows)
      load_vec_async(sVec + 128 * stage, lb + q0, Sq - q0, i);
    else
      load_vec_async(sVec + 128 * stage + 64, db + q0, Sq - q0, i);
  };
  load_tile_async<DP>(sK, k + b * k_sb + h * k_sh + int64_t(kv0) * k_ss, k_ss, Skv - kv0, d, vec);
  load_tile_async<DP>(sV, v + b * v_sb + h * v_sh + int64_t(kv0) * v_ss, v_ss, Skv - kv0, d, vec);
  if (it0 < it1) load_q(it0, 0);
  cp_async_commit();
  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[n][c] = dva[n][c] = 0.f;

  for (int it = it0; it < it1; ++it) {
    if (it + 1 < it1) {
      load_q(it + 1, (it + 1 - it0) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int stage = (it - it0) & 1;
    const float* sQ = sQD + stage * 2 * T;
    const float* sDO = sQ + T;
    const float* sLse = sVec + 128 * stage;
    const float* sD = sLse + 64;
    // one score tile at a time (S^T, then dP^T), so that the dK and dV sums,
    // P^T, dP^T and a tile's partial sums fit in registers
    float st[8][4], dpt[8][4];
    scores<DP>(st, L, sK, sQ, r0);   // S^T = K Q^T
    const int q0 = it * kRows;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + 2 * L.t;
      const float2 l2 = *reinterpret_cast<const float2*>(sLse + col);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int e = c & 1;
        const float lse_c = (e ? l2.y : l2.x) * kLog2e;
        st[n][c] = q0 + col + e < Sq ? exp2f(fmaf(st[n][c], scale_log2, -lse_c)) : 0.f;   // P^T
      }
    }
    accumulate<DP>(dva, st, L, sDO);   // dV += P^T dO
    scores<DP>(dpt, L, sV, sDO, r0);   // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 d2 = *reinterpret_cast<const float2*>(sD + 8 * n + 2 * L.t);
#pragma unroll
      for (int c = 0; c < 4; ++c) dpt[n][c] = st[n][c] * (dpt[n][c] - ((c & 1) ? d2.y : d2.x));
    }
    accumulate<DP>(dka, dpt, L, sQ);   // dK += dS^T Q
    __syncthreads();
  }
  if (gridDim.y == 1) {
    store_acc<DP>(dk + b * dk_sb + h * dk_sh + int64_t(kv0) * dk_ss, dk_ss, dka, r0, Skv - kv0,
                  d, scale, L);
    store_acc<DP>(dv + b * dv_sb + h * dv_sh + int64_t(kv0) * dv_ss, dv_ss, dva, r0, Skv - kv0,
                  d, 1.f, L);
  } else {
    const int64_t part_elems = int64_t(gridDim.y) * gridDim.z * Skv * d;
    float* wk = ws + (int64_t(part) * gridDim.z + bh) * Skv * d + int64_t(kv0) * d;
    store_acc<DP>(wk, d, dka, r0, Skv - kv0, d, 1.f, L);
    store_acc<DP>(wk + part_elems, d, dva, r0, Skv - kv0, d, 1.f, L);
  }
}

// The split path's second pass: dK = scale * the sum of the parts' dK, dV the
// sum of theirs, in split order; one thread an element.
__global__ void dkv_f32_reduce_kernel(const float* __restrict__ ws, float* __restrict__ dk,
                                      float* __restrict__ dv, int H, int Skv, int D, int BH,
                                      int splits, int64_t dk_sb, int64_t dk_sh, int64_t dk_ss,
                                      int64_t dv_sb, int64_t dv_sh, int64_t dv_ss, float scale) {
  const int64_t part = int64_t(BH) * Skv * D;
  const float* wv = ws + splits * part;
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < part;
       i += int64_t(gridDim.x) * blockDim.x) {
    const int col = int(i % D);
    const int64_t rows = i / D;
    const int row = int(rows % Skv), bh = int(rows / Skv), b = bh / H, h = bh % H;
    float sk = 0.f, sv = 0.f;
    for (int s = 0; s < splits; ++s) {
      sk += ws[s * part + i];
      sv += wv[s * part + i];
    }
    dk[b * dk_sb + h * dk_sh + int64_t(row) * dk_ss + col] = sk * scale;
    dv[b * dv_sb + h * dv_sh + int64_t(row) * dv_ss + col] = sv;
  }
}

// Shared memory above 48 KB is granted on request, once per kernel.
template <typename K>
cudaError_t allow_smem(K kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// 16-byte rows: d, every stride of the `n` strided tensors and their bases
// are multiples of 4 floats (cp.async's 16-byte copies, the wgmma kernels'
// float4 loads).
bool vec_ok(const void* const* ptrs, int n, const int64_t* st, int D) {
  if (D % 4 != 0) return false;
  for (int i = 0; i < n; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
    for (int j = 0; j < 3; ++j)
      if (st[3 * i + j] % 4 != 0) return false;
  }
  return true;
}

// The mma.sync forward's warps a block: 4 (64 Q rows) up to DP = 64, where
// 2-5 blocks share an SM; 8 (128 rows) at DP = 128, whose 64-row tiles would
// leave one 4-warp block an SM (160 KB of shared memory).
constexpr int fwd_tc_warps(int dp) { return dp == 128 ? 8 : 4; }

template <int DP>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int Sq,
        int Skv, int D, const int64_t* st, float scale, cudaStream_t stream) {
  const void* rw[4] = {q, k, v, o};
  const bool vec = vec_ok(rw, 4, st, D);
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  const bool wg = DP == 64 && vec;
  if (wg) {
    static const cudaError_t attr = allow_smem(fwd_wg_kernel, kFwdWgSmem);
    if (attr != cudaSuccess) return int(attr);
    const dim3 grid((Sq + 127) / 128, B * H);
    fwd_wg_kernel<<<grid, kWgThreads, kFwdWgSmem, stream>>>(
        qf, kf, vf, of, lse, H, Sq, Skv, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
        st[7], st[8], st[9], st[10], st[11], scale * kLog2e);
  } else {
    constexpr int W = fwd_tc_warps(DP), rows = 16 * W;
    constexpr int smem = (rows + 4 * kRows) * DP * 4;   // Q; K and V in 2 stages
    static const cudaError_t attr = allow_smem(fwd_tc_kernel<DP, W>, smem);
    if (attr != cudaSuccess) return int(attr);
    const dim3 grid((Sq + rows - 1) / rows, B * H);
    fwd_tc_kernel<DP, W><<<grid, 32 * W, smem, stream>>>(
        qf, kf, vf, of, lse, H, Sq, Skv, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
        st[7], st[8], st[9], st[10], st[11], scale * kLog2e, vec);
  }
  return int(cudaGetLastError());
}

int dq_wg(const void* q, const void* k, const void* v, const void* dout, const float* lse,
          const float* delta, void* dqp, int B, int H, int Sq, int Skv, int D,
          const int64_t* st, float scale, cudaStream_t stream) {
  static const cudaError_t attr = allow_smem(dq_wg_kernel, kDqWgSmem);
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid((Sq + 127) / 128, B * H);
  dq_wg_kernel<<<grid, kWgThreads, kDqWgSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dqp), H, Sq, Skv, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      st[12], st[13], st[14], scale, scale * kLog2e);
  return int(cudaGetLastError());
}

template <int DP>
int dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
       const float* delta, void* dqp, int B, int H, int Sq, int Skv, int D, const int64_t* st,
       float scale, cudaStream_t stream) {
  const void* read[4] = {q, k, v, dout};
  const bool vec = vec_ok(read, 4, st, D);
  if (DP == 64 && vec)
    return dq_wg(q, k, v, dout, lse, delta, dqp, B, H, Sq, Skv, D, st, scale, stream);
  constexpr int smem = 6 * kRows * DP * 4;   // Q, dO; K and V in 2 stages
  static const cudaError_t attr = allow_smem(dq_tc_kernel<DP>, smem);
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid((Sq + kRows - 1) / kRows, B * H);
  dq_tc_kernel<DP><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dqp), H, Sq, Skv, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      st[12], st[13], st[14], scale, scale * kLog2e, vec);
  return int(cudaGetLastError());
}

template <int DP>
int dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
        const float* delta, void* dkp, void* dvp, float* ws, int B, int H, int Sq, int Skv, int D,
        int splits, const int64_t* st, float scale, cudaStream_t stream) {
  const void* read[4] = {q, k, v, dout};
  const bool vec = vec_ok(read, 4, st, D);
  const bool wg = DP == 64 && vec;
  // parts of `per` Q tiles each, none empty
  const int rows = wg ? kQT : kRows;
  const int n_qt = (Sq + rows - 1) / rows;
  splits = splits < n_qt ? splits : n_qt;
  const int per = (n_qt + splits - 1) / splits;
  splits = (n_qt + per - 1) / per;
  if (splits > 1 && ws == nullptr) return -1;
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *df = static_cast<const float*>(dout);
  float *dkf = static_cast<float*>(dkp), *dvf = static_cast<float*>(dvp);
  if (wg) {
    static const cudaError_t attr = allow_smem(dkv_wg_kernel, kDkvWgSmem);
    if (attr != cudaSuccess) return int(attr);
    const dim3 grid((Skv + 127) / 128, splits, B * H);
    dkv_wg_kernel<<<grid, kWgThreads, kDkvWgSmem, stream>>>(
        qf, kf, vf, df, lse, delta, dkf, dvf, ws, H, Sq, Skv, D, per, st[0], st[1], st[2], st[3],
        st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14], st[15],
        st[16], st[17], scale, scale * kLog2e);
  } else {
    // + the LSE and D, 2 stages
    constexpr int smem = 6 * kRows * DP * 4 + 2 * 2 * kRows * 4;
    static const cudaError_t attr = allow_smem(dkv_tc_kernel<DP>, smem);
    if (attr != cudaSuccess) return int(attr);
    const dim3 grid((Skv + kRows - 1) / kRows, splits, B * H);
    dkv_tc_kernel<DP><<<grid, kTcThreads, smem, stream>>>(
        qf, kf, vf, df, lse, delta, dkf, dvf, ws, H, Sq, Skv, D, per, st[0], st[1], st[2], st[3],
        st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14], st[15],
        st[16], st[17], scale, scale * kLog2e, vec);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return int(e);
  const int64_t elems = int64_t(B) * H * Skv * D;
  const int blocks = int((elems + 255) / 256 < 65536 ? (elems + 255) / 256 : 65536);
  dkv_f32_reduce_kernel<<<blocks, 256, 0, stream>>>(ws, dkf, dvf, H, Skv, D, B * H, splits,
                                                    st[12], st[13], st[14], st[15], st[16],
                                                    st[17], scale);
  return int(cudaGetLastError());
}

bool args_ok(int B, int H, int Sq, int Skv, int D, int dtype) {
  return dtype == 2 && B > 0 && H > 0 && Sq > 0 && Skv > 0 && D > 0 && D <= 128 &&
         int64_t(B) * H <= 65535;
}

int dkv_any(const void* q, const void* k, const void* v, const void* dout, const float* lse,
            const float* delta, void* dkp, void* dvp, float* ws, int B, int H, int Sq, int Skv,
            int D, int splits, const int64_t* st, float scale, cudaStream_t s) {
  if (D <= 32)
    return dkv<32>(q, k, v, dout, lse, delta, dkp, dvp, ws, B, H, Sq, Skv, D, splits, st, scale, s);
  if (D <= 64)
    return dkv<64>(q, k, v, dout, lse, delta, dkp, dvp, ws, B, H, Sq, Skv, D, splits, st, scale, s);
  return dkv<128>(q, k, v, dout, lse, delta, dkp, dvp, ws, B, H, Sq, Skv, D, splits, st, scale, s);
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
  return dkv_any(q, k, v, dout, lse, delta, dkp, dvp, nullptr, B, H, Sq, Skv, D, 1, strides,
                 scale, static_cast<cudaStream_t>(stream));
}

// dK/dV with the query range in `splits` parts (`dkv_splits` in
// nn/kernels/flash_attention.py): the parts' fp32 partial sums go to `ws`
// (2 * splits * B * H * Skv * D floats), which a second kernel adds in split
// order into dK and dV.
extern "C" int flash_attention_dkv_split_f32(const void* q, const void* k, const void* v,
                                             const void* dout, const float* lse,
                                             const float* delta, void* dkp, void* dvp,
                                             void* ws, int B, int H, int Sq, int Skv, int D,
                                             int splits, const int64_t* strides, float scale,
                                             int dtype, void* stream) {
  if (!args_ok(B, H, Sq, Skv, D, dtype) || splits < 1) return -1;
  return dkv_any(q, k, v, dout, lse, delta, dkp, dvp, static_cast<float*>(ws), B, H, Sq, Skv,
                 D, splits, strides, scale, static_cast<cudaStream_t>(stream));
}

#ifdef F32_PHASE_TIMES
// dq_wg_kernel's phase cycles summed since the last call (6 values), then reset.
extern "C" int f32_phase_cycles(unsigned long long* out) {
  const unsigned long long zero[6] = {};
  cudaMemcpyFromSymbol(out, g_f32_phase_cycles, sizeof(zero));
  cudaMemcpyToSymbol(g_f32_phase_cycles, zero, sizeof(zero));
  return int(cudaGetLastError());
}
#endif
