// Flash-attention backward, dK and dV, for Hopper (sm_90a): bf16 / fp16 in, fp32
// accumulation.
//
// Replaces: difashion_tpu/nn/pallas/flash_attention.py::_dkv_kernel (reached through
// _backward, the custom VJP of flash_attention): the key and value gradients of
// every UNet attention of the training step.
//
// What it computes, for one (batch, head) and a tile of 64 * NC KV rows, looping
// over BQ-row query tiles, all in the transposed orientation:
//   S^T  = K Q^T,  P^T = exp2(scale*log2(e) * S^T - LSE*log2(e))  (LSE per column)
//   dP^T = V dO^T
//   dS^T = P^T * (dP^T - D),  D = rowsum(dO * O) per column (computed before the kernel)
//   dV  += P^T dO,  dK += scale * dS^T Q
// P and dS are rounded to the input type before their products, as the TPU kernel
// rounds them. Query columns >= Sq get P = dS = 0 (their Q, dO, LSE and D load
// as zeros, which alone would give P = 1); KV rows >= Skv are computed on zeros
// and not stored. No atomics: each output
// element is summed by one thread in a fixed order (and the split path's
// partial sums in split order), so results are the same from run to run.
//
// What bounds it on the H100: the four products, 8*B*H*Sq*Skv*d operations. At the
// training UNet's 4096-token self-attention (batch 8, 5 heads, d = 64) that is
// 344 GFLOP against 127 MB of q/k/v/dO/LSE/D/dK/dV, about 2700 operations per
// byte: tensor-core bound (0.35 ms at 989 TFLOP/s). At the 77-token
// cross-attention it is memory bound, and there a KV tile a (batch, head) gives
// 40-160 tiles at batch 8, fewer than two waves of the card's 132 SMs.
//
// What the design does about it (FA3's shape, on hopper_common.cuh):
//   - TMA loads straight from the projections' [B, S, H, D] memory: 4-D maps
//     over (D, H, S, B) with the tensors' own strides, 64-column boxes with a
//     128-byte swizzle, zero fill past a ragged sequence and past the head dim
//     (the box is the padding: d = 16..64 read as DP = 64, d = 72..128 as
//     128, no padded copy).
//   - Warp specialisation: NC consumer warpgroups (warps 0 .. 4NC-1), each
//     owning 64 KV rows, and one producer warp (warp 4NC), whose first lane
//     loads the tile's K and V once and then keeps a ring of ST stages of
//     (Q, dO) tiles in flight, with full / empty mbarriers a stage; its 32
//     lanes copy each Q tile's LSE (times log2 e) and D into the stage with
//     plain loads, zeros past Sq, before they arrive on its full barrier. (A
//     TMA box of those fp32 vectors faulted on the card where its start was
//     not 16-byte aligned: Sq = 77, 130.)
//   - Registers: an SM's four schedulers each hold 16K registers and warp w
//     runs on scheduler w % 4, so the 9 warps of NC = 2 get at most 168 a
//     thread from ptxas (3 warps on one scheduler), and a producer warpgroup
//     with setmaxnreg did not raise that (ptxas kept the consumers at 168 and
//     spilled). dK, dV, S^T and dP^T of a 64-row Q tile (DP + BQ = 128 live,
//     P^T and dS^T packed as they are computed, ~40 of addresses and state)
//     fill it; NC = 1 (5 warps, 255 registers) holds DP = 128. Issuing Q tile
//     i + 1's products under tile i's (the forward's overlap) would keep
//     tile i's packed P^T and dS^T live as well: it does not fit.
//   - wgmma for the four products: S^T = K Q^T and dP^T = V dO^T as SS (K, V,
//     Q, dO all K-major, N = BQ); P^T and dS^T stay in registers, where the
//     accumulator layout is already the A-fragment layout, for dV += P^T dO
//     and dK += dS^T Q as RS (dO and Q the MN-major B, the transpose bit).
//     The masks run only on a ragged last Q tile.
//   - Overlap: the consumer warpgroups take turns (PP: named barriers) to
//     issue their S^T / dP^T and their dV / dK products, so that one's
//     products run while the other computes P^T and dS^T.
//   - Epilogue: dK * scale and dV rounded once into swizzled staging tiles,
//     then TMA stores, which clip rows >= Skv and columns >= d.
//   - Grid: persistent, one block per SM walking the (KV tile, split, batch *
//     head) tiles, KV tiles fastest, so that the blocks of one head run
//     together and share its Q and dO in L2. The K/V load of the next tile
//     and the Q ring run on while the consumers store this one.
//   - Split: where the KV tiles leave most SMs idle (the 77-token
//     cross-attention at 4096 tokens), the wrapper asks for `splits` parts of
//     the query range (`dkv_splits` in nn/kernels/flash_attention.py); each
//     part writes its fp32 partial dK and dV to a workspace, and a second
//     kernel of this file sums the parts in split order, scales dK and rounds
//     once.
// The tile (NC, BQ, ST, PP) per padded head dim is measured by
// scripts/flash_bwd_tiles.py (built with -DFLASH_BWD_ALL_TILES, which
// instantiates every candidate).
//
// Interface: plain C (loaded with ctypes). Tensors are addressed by element
// strides for batch, head and sequence (the last dim is contiguous, every other
// stride a multiple of 8 elements: a TMA rule), so the [B, S, H, D] views of the
// projections are read in place and dK / dV are written in the layout given.

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemLimit = 232448;        // dynamic shared memory a block may have

template <int DP, int NC, int BQ, int ST>
struct Plan {
  static constexpr int kChunks = DP / 64;            // 64-column chunks of the head dim
  static constexpr int kBKV = 64 * NC;               // KV rows of a tile
  static constexpr int kThreads = 128 * NC + 32;     // consumers, then the producer warp
  static constexpr int kKVBytes = kBKV * DP * 2;     // a K or V tile: [chunk][kBKV rows][128 B]
  static constexpr int kQBytes = BQ * DP * 2;        // a Q or dO tile: [chunk][BQ rows][128 B]
  static constexpr int kVecBytes = BQ * 4;           // the LSE or D of a Q tile
  static constexpr int kStageTx = 2 * kQBytes;        // the TMA bytes of a stage
  static constexpr int kBars = 2 + 2 * ST;           // K/V full, empty; a stage's full, empty
  // K, V, the dK and dV staging, the (Q, dO) ring, the (LSE, D) ring, barriers
  static constexpr int kSmem =
      1024 + 4 * kKVBytes + 2 * ST * kQBytes + 2 * ST * kVecBytes + 8 * kBars;
  static_assert(DP == 64 || DP == 128, "flash dkv: the padded head dim is 64 or 128");
  static_assert(NC >= 1 && NC <= 3, "flash dkv: 1 to 3 consumer warpgroups");
  static_assert(BQ == 64, "flash dkv: a Q tile of 64 rows (dK, dV, S^T, dP^T fill 168 registers)");
  static_assert(ST >= 2, "flash dkv: stages");
  static_assert(kSmem <= kSmemLimit, "flash dkv: shared memory plan");
};

// P^T of one Q tile in place in s (S^T), then dS^T in place in dp (dP^T): the
// base-2 LSE and D of column c come from the stage's vectors; with kMask,
// columns >= `valid` (past Sq) give 0.
template <int BQ, bool kMask>
__device__ __forceinline__ void probs(float (&s)[BQ / 2], const float* lse2, float scale_log2,
                                      int valid, int t) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool odd = e & 1;
      const float p = fast_exp2(fmaf(s[4 * j + e], scale_log2, -(odd ? l2.y : l2.x)));
      s[4 * j + e] = !kMask || c + odd < valid ? p : 0.f;
    }
  }
}

template <int BQ, bool kMask>
__device__ __forceinline__ void dscores(float (&dp)[BQ / 2], const float (&p)[BQ / 2],
                                        const float* delta, int valid, int t) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 d2 = *reinterpret_cast<const float2*>(delta + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool odd = e & 1;
      const float ds = p[4 * j + e] * (dp[4 * j + e] - (odd ? d2.y : d2.x));
      dp[4 * j + e] = !kMask || c + odd < valid ? ds : 0.f;
    }
  }
}

// P^T and dS^T of a Q tile of which `valid` columns lie before Sq: the masks
// only on the ragged last tile. wait_dp waits for the dP^T product.
template <int BQ, typename WaitDp>
__device__ __forceinline__ void probs_dscores(float (&s)[BQ / 2], float (&dp)[BQ / 2],
                                              const float* lse2, const float* delta,
                                              float scale_log2, int valid, int t,
                                              WaitDp wait_dp) {
  if (valid >= BQ) {
    probs<BQ, false>(s, lse2, scale_log2, valid, t);
    wait_dp();
    dscores<BQ, false>(dp, s, delta, valid, t);
  } else {
    probs<BQ, true>(s, lse2, scale_log2, valid, t);
    wait_dp();
    dscores<BQ, true>(dp, s, delta, valid, t);
  }
}

template <typename T, int DP, int NC, int BQ, int ST, bool PP>
__global__ void __launch_bounds__(Plan<DP, NC, BQ, ST>::kThreads, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap domap,
                 const __grid_constant__ CUtensorMap dkmap,
                 const __grid_constant__ CUtensorMap dvmap,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ ws, int H,
                 int Sq, int Skv, int D, int n_kv, int n_qt, int splits, int per, int tiles,
                 float scale, float scale_log2) {
  using P = Plan<DP, NC, BQ, ST>;
  constexpr int kBKV = P::kBKV;
  static_assert(!PP || NC >= 2, "flash dkv: ping-pong needs two consumer warpgroups");
  extern __shared__ unsigned char smem_raw[];
  // the swizzle patterns repeat every 1024 bytes: align the tiles to them
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sK = smem;                           // [chunk][kBKV x 128 B]
  unsigned char* sV = sK + P::kKVBytes;
  unsigned char* sdK = sV + P::kKVBytes;              // the epilogue's staging
  unsigned char* sdV = sdK + P::kKVBytes;
  unsigned char* sQ = sdV + P::kKVBytes;              // [stage][chunk][BQ x 128 B]
  unsigned char* sdO = sQ + ST * P::kQBytes;
  float* sL = reinterpret_cast<float*>(sdO + ST * P::kQBytes);   // [stage][BQ], LSE * log2(e)
  float* sD = sL + ST * BQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sD + ST * BQ);
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* q_full = kv_full + 2;
  uint64_t* q_empty = q_full + ST;
  const int BH = tiles / (n_kv * splits);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);               // the producer's arrive-expect-tx
    mbar_init(kv_empty, 4 * NC);         // one arrival per consumer warp
    for (int s = 0; s < ST; ++s) {
      mbar_init(&q_full[s], 32);         // the producer warp's lanes, one with expect-tx
      mbar_init(&q_empty[s], 4 * NC);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Block i takes tiles i, i + grid, ...: tile = ((bh * splits) + part) * n_kv
  // + KV tile; part covers Q tiles [part * per, part * per + per) of n_qt.
  if (threadIdx.x >= 128 * NC) {
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      tma_prefetch(&qmap);
      tma_prefetch(&kmap);
      tma_prefetch(&vmap);
      tma_prefetch(&domap);
    }
    int stage = 0;
    uint32_t phase = 0, kv_phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int kvt = tile % n_kv, part = (tile / n_kv) % splits, bh = tile / (n_kv * splits);
      const int b = bh / H, h = bh % H;
      const int qt0 = part * per, qt1 = min(qt0 + per, n_qt);
      if (lane == 0) {
        mbar_wait(kv_empty, kv_phase ^ 1);       // the first round passes at once
        mbar_arrive_expect_tx(kv_full, 2 * P::kKVBytes);
#pragma unroll
        for (int c = 0; c < P::kChunks; ++c) {
          tma_load_4d(sK + c * kBKV * kSwRow, &kmap, kv_full, c * 64, h, kvt * kBKV, b);
          tma_load_4d(sV + c * kBKV * kSwRow, &vmap, kv_full, c * 64, h, kvt * kBKV, b);
        }
      }
      const float* lb = lse + static_cast<int64_t>(bh) * Sq;
      const float* db = delta + static_cast<int64_t>(bh) * Sq;
      for (int qt = qt0; qt < qt1; ++qt) {
        mbar_wait(&q_empty[stage], phase ^ 1);
        for (int i = lane; i < BQ; i += 32) {
          const int r = qt * BQ + i;
          sL[stage * BQ + i] = r < Sq ? lb[r] * kLog2e : 0.f;   // base 2
          sD[stage * BQ + i] = r < Sq ? db[r] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&q_full[stage], P::kStageTx);
#pragma unroll
          for (int c = 0; c < P::kChunks; ++c) {
            tma_load_4d(sQ + stage * P::kQBytes + c * BQ * kSwRow, &qmap, &q_full[stage], c * 64,
                        h, qt * BQ, b);
            tma_load_4d(sdO + stage * P::kQBytes + c * BQ * kSwRow, &domap, &q_full[stage],
                        c * 64, h, qt * BQ, b);
          }
        } else {
          mbar_arrive(&q_full[stage]);
        }
        advance<ST>(stage, phase);
      }
      kv_phase ^= 1;
    }
    return;
  }

  const int cw = threadIdx.x / 128;                // this consumer's 64 KV rows of a tile
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;
  // named barriers: the turns 1..NC (PP), then one of this warpgroup's own
  const int my_turn = 1 + cw, next_turn = 1 + (cw + 1) % NC, epilogue = 1 + NC + cw;
  const uint32_t k_addr = smem_u32(sK) + cw * 64 * kSwRow;
  const uint32_t v_addr = smem_u32(sV) + cw * 64 * kSwRow;
  const uint32_t q_base = smem_u32(sQ), do_base = smem_u32(sdO);
  float dk[DP / 2], dv[DP / 2];
  float s[BQ / 2], dp[BQ / 2];
  uint32_t pa[BQ / 16][4], da[BQ / 16][4];
  int stage = 0;
  uint32_t phase = 0, kv_phase = 0;
  if (PP && cw == NC - 1) named_bar_arrive(1, 256);    // consumer 0 goes first

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int kvt = tile % n_kv, part = (tile / n_kv) % splits, bh = tile / (n_kv * splits);
    const int b = bh / H, h = bh % H;
    const int qt0 = part * per, qt1 = min(qt0 + per, n_qt);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait_lo(kv_full, kv_phase);

    // each Q tile's four products in turn, the warpgroups taking turns (PP)
    for (int qt = qt0; qt < qt1; ++qt) {
      const int cur = stage;
      const uint32_t cur_phase = phase;
      advance<ST>(stage, phase);
      mbar_wait_lo(&q_full[cur], cur_phase);
      const int valid = Sq - qt * BQ;
      turn_take<PP>(my_turn);
      wgmma_fence();
      wgmma_ss_rows<T, DP, BQ, kBKV, BQ>(s, k_addr, q_base + cur * P::kQBytes);
      wgmma_commit();
      wgmma_ss_rows<T, DP, BQ, kBKV, BQ>(dp, v_addr, do_base + cur * P::kQBytes);
      wgmma_commit();
      turn_pass<PP>(next_turn);
      wgmma_wait<1>();
      fence_operands(s);
      probs_dscores<BQ>(s, dp, sL + cur * BQ, sD + cur * BQ, scale_log2, valid, t,
                        [&] { wgmma_wait<0>(); fence_operands(dp); });
      pack_rows<T, BQ>(pa, s);
      pack_rows<T, BQ>(da, dp);
      turn_take<PP>(my_turn);
      wgmma_fence();
      wgmma_rs_cols<T, DP, BQ, BQ>(dv, pa, do_base + cur * P::kQBytes);
      wgmma_rs_cols<T, DP, BQ, BQ>(dk, da, q_base + cur * P::kQBytes);
      wgmma_commit();
      turn_pass<PP>(next_turn);
      wgmma_wait<0>();
      fence_operands(dk);
      fence_operands(dv);
      fence_rows(pa);
      fence_rows(da);
      if (lane == 0) mbar_arrive(&q_empty[cur]);
    }
    // every product reading this tile's K and V has completed
    if (lane == 0) mbar_arrive(kv_empty);

    const int kv0 = kvt * kBKV + cw * 64;            // this consumer's first KV row
    if (splits == 1) {
      // dK * scale and dV rounded once into this consumer's rows of the
      // staging tiles once the previous tile's stores have read them, then
      // one TMA store per 64-column chunk (rows >= Skv, columns >= d clipped)
      const float mul_k[2] = {scale, scale}, mul_v[2] = {1.f, 1.f};
      if (leader) tma_store_wait_read<0>();
      named_bar_sync(epilogue, 128);
      stage_rows<T, DP, kBKV>(sdK + cw * 64 * kSwRow, dk, mul_k, warp, g, t);
      stage_rows<T, DP, kBKV>(sdV + cw * 64 * kSwRow, dv, mul_v, warp, g, t);
      fence_proxy_async_shared();
      named_bar_sync(epilogue, 128);
      if (leader) {
#pragma unroll
        for (int c = 0; c < P::kChunks; ++c) {
          tma_store_4d(&dkmap, sdK + c * kBKV * kSwRow + cw * 64 * kSwRow, c * 64, h, kv0, b);
          tma_store_4d(&dvmap, sdV + c * kBKV * kSwRow + cw * 64 * kSwRow, c * 64, h, kv0, b);
        }
        tma_store_commit();
      }
    } else {
      // this part's fp32 sums, unscaled, at [part][bh][row][D] of the
      // workspace (dK's, then dV's): rows < Skv and columns < D only
      const int64_t part_elems = static_cast<int64_t>(splits) * BH * Skv * D;
      float* wk = ws + (static_cast<int64_t>(part) * BH + bh) * Skv * D;
      float* wv = wk + part_elems;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (col >= D) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = kv0 + warp * 16 + g + 8 * hh;
          if (row >= Skv) continue;
          const int64_t at = static_cast<int64_t>(row) * D + col;
          const int i = 4 * j + 2 * hh;
          *reinterpret_cast<float2*>(wk + at) = make_float2(dk[i], dk[i + 1]);
          *reinterpret_cast<float2*>(wv + at) = make_float2(dv[i], dv[i + 1]);
        }
      }
    }
    kv_phase ^= 1;
  }
  if (leader) tma_store_wait<0>();
  // consumer 0's turn got one arrival more than it took (the opening one)
  if (PP && cw == 0) named_bar_sync(1, 256);
}

// The split path's second pass: dK = scale * sum of the parts' dK, dV = the sum
// of theirs, in split order, rounded once; one thread a pair of columns.
template <typename T>
__global__ void __launch_bounds__(256)
flash_dkv_reduce_kernel(const float* __restrict__ ws, T* __restrict__ dk, T* __restrict__ dv,
                        int H, int Skv, int D, int BH, int splits, int64_t dk_sb, int64_t dk_sh,
                        int64_t dk_ss, int64_t dv_sb, int64_t dv_sh, int64_t dv_ss,
                        float scale) {
  const int64_t rows = static_cast<int64_t>(BH) * Skv;
  const int64_t pairs = rows * (D / 2);
  const int64_t part = rows * D;
  const float* wv = ws + splits * part;
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < pairs;
       i += int64_t(gridDim.x) * blockDim.x) {
    const int col = int(i % (D / 2)) * 2;
    const int64_t r = i / (D / 2);
    const int row = int(r % Skv), bh = int(r / Skv);
    float2 sk = make_float2(0.f, 0.f), sv = make_float2(0.f, 0.f);
    for (int s = 0; s < splits; ++s) {
      const int64_t at = s * part + r * D + col;
      const float2 k2 = *reinterpret_cast<const float2*>(ws + at);
      const float2 v2 = *reinterpret_cast<const float2*>(wv + at);
      sk.x += k2.x;
      sk.y += k2.y;
      sv.x += v2.x;
      sv.y += v2.y;
    }
    const int b = bh / H, h = bh % H;
    *reinterpret_cast<uint32_t*>(dk + b * dk_sb + h * dk_sh + row * dk_ss + col) =
        round_pair<T>(sk.x * scale, sk.y * scale);
    *reinterpret_cast<uint32_t*>(dv + b * dv_sb + h * dv_sh + row * dv_ss + col) =
        round_pair<T>(sv.x, sv.y);
  }
}

// Element strides, (batch, head, seq) for q, k, v, dO, dK, dV in that order.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dk;
  void* dv;
  float* ws;
  int B, H, Sq, Skv, D, splits;
  const int64_t* st;
  float scale;
};

template <typename T, int DP, int NC, int BQ, int ST, bool PP>
int launch(const Args& a, cudaStream_t stream) {
  using P = Plan<DP, NC, BQ, ST>;
  auto kern = flash_dkv_kernel<T, DP, NC, BQ, ST, PP>;
  // above 48 KB of shared memory only on request; once per instantiation
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (attr != cudaSuccess) return int(attr);
  CUtensorMap maps[6];
  const void* ptrs[6] = {a.q, a.k, a.v, a.dout, a.dk, a.dv};
  const uint64_t rows[6] = {uint64_t(a.Sq), uint64_t(a.Skv), uint64_t(a.Skv), uint64_t(a.Sq),
                            uint64_t(a.Skv), uint64_t(a.Skv)};
  // K and V a whole KV tile; Q and dO a Q tile; dK and dV one consumer's rows
  const uint32_t box_rows[6] = {BQ, P::kBKV, P::kBKV, BQ, 64, 64};
  for (int i = 0; i < 6; ++i) {
    const uint64_t dims[4] = {uint64_t(a.D), uint64_t(a.H), rows[i], uint64_t(a.B)};
    const int64_t strides[3] = {a.st[3 * i + 1], a.st[3 * i + 2], a.st[3 * i]};
    const uint32_t box[4] = {64, 1, box_rows[i], 1};
    const int rc = encode_4d<T>(&maps[i], ptrs[i], dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc != 0) return rc;
  }
  const int n_kv = (a.Skv + P::kBKV - 1) / P::kBKV;
  const int n_qt = (a.Sq + BQ - 1) / BQ;
  const int splits = a.splits < n_qt ? a.splits : n_qt;
  const int per = (n_qt + splits - 1) / splits;
  const int tiles = n_kv * splits * a.B * a.H;
  // a persistent grid: one block per SM, or one per tile where there are fewer
  const int grid = tiles < sm_count() ? tiles : sm_count();
  kern<<<grid, P::kThreads, P::kSmem, stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4],
                                                maps[5], a.lse, a.delta, a.ws, a.H, a.Sq,
                                                a.Skv, a.D, n_kv, n_qt, splits, per, tiles,
                                                a.scale, a.scale * kLog2e);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return int(e);
  const int64_t pairs = int64_t(a.B) * a.H * a.Skv * (a.D / 2);
  const int64_t want = (pairs + 255) / 256;
  const int blocks = int(want < 8 * sm_count() ? want : 8 * sm_count());
  flash_dkv_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
      a.ws, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.Skv, a.D, a.B * a.H, splits,
      a.st[12], a.st[13], a.st[14], a.st[15], a.st[16], a.st[17], a.scale);
  return int(cudaGetLastError());
}

// The tile each padded head dim runs with (scripts/flash_bwd_tiles.py): NC
// consumer warpgroups (a KV tile of 64 * NC rows), the Q tile, the stages,
// ping-pong (1) or not (0). nn/kernels/flash_attention.py::DKV_TILES mirrors
// the first two, for the split plan.
constexpr int kTile64[4] = {2, 64, 3, 1};
constexpr int kTile128[4] = {1, 64, 3, 0};

template <typename T>
int dispatch(const Args& a, cudaStream_t s) {
  // the kernel pads the head dim to 64 or 128 with TMA's zero fill
  const int dp = a.D <= 64 ? 64 : 128;
  switch (dp) {
    case 64: return launch<T, 64, kTile64[0], kTile64[1], kTile64[2], kTile64[3] != 0>(a, s);
    case 128: return launch<T, 128, kTile128[0], kTile128[1], kTile128[2], kTile128[3] != 0>(a, s);
    default: return -1;
  }
}

bool args_ok(const Args& a) {
  if (a.B <= 0 || a.H <= 0 || a.Sq <= 0 || a.Skv <= 0 || a.D <= 0 || a.D > 128 || a.D % 8)
    return false;
  for (int i = 0; i < 18; ++i)
    if (a.st[i] % 8) return false;
  if (a.splits < 1 || (a.splits > 1 && a.ws == nullptr)) return false;
  return int64_t(a.B) * a.H * a.Sq < (int64_t(1) << 31);
}

int run(const Args& a, int dtype, void* stream) {
  if (!args_ok(a)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<__nv_bfloat16>(a, s);
  if (dtype == 1) return dispatch<__half>(a, s);
  return -1;
}

}  // namespace

// strides: 18 element strides, (batch, head, seq) for q, k, v, dout, dk, dv in
// that order, each a multiple of 8. lse, delta: [B*H, Sq] fp32, contiguous.
// D: any multiple of 8 up to 128. dtype: 0 = bf16, 1 = fp16.
// Returns 0, the CUDA error of the launch (> 0), -1 for arguments it does not
// take, or a tensor-map error (hopper_common.cuh).
extern "C" int flash_attention_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse,
                                   const float* delta, void* dk, void* dv, int B,
                                   int H, int Sq, int Skv, int D,
                                   const int64_t* strides, float scale, int dtype,
                                   void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, nullptr, B, H, Sq, Skv, D, 1, strides, scale};
  return run(a, dtype, stream);
}

// The same with the query range split into `splits` parts: ws holds
// 2 * splits * B * H * Skv * D fp32 values (each part's dK sums, then its dV
// sums), and a second kernel adds the parts in split order.
extern "C" int flash_attention_dkv_split(const void* q, const void* k, const void* v,
                                         const void* dout, const float* lse,
                                         const float* delta, void* dk, void* dv, float* ws,
                                         int B, int H, int Sq, int Skv, int D, int splits,
                                         const int64_t* strides, float scale, int dtype,
                                         void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, ws, B, H, Sq, Skv, D, splits, strides, scale};
  return run(a, dtype, stream);
}

// The split entry with the tile given: nc consumer warpgroups, a Q tile of bq
// rows, `stages` stages and ping-pong or not, bf16 only. The default build has the tiles of
// kTile64 / kTile128; -DFLASH_BWD_ALL_TILES builds every candidate
// (scripts/flash_bwd_tiles.py). Returns -1 for a tile that is not built.
extern "C" int flash_attention_dkv_tile(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse, const float* delta,
                                        void* dk, void* dv, float* ws, int B, int H, int Sq,
                                        int Skv, int D, int splits, const int64_t* strides,
                                        float scale, int nc, int bq, int stages, int pingpong,
                                        void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, ws, B, H, Sq, Skv, D, splits, strides, scale};
  if (!args_ok(a)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = D <= 64 ? 64 : 128;
#define FLASH_DKV_TILE(DP_, NC_, BQ_, ST_, PP_)                                  \
  if (dp == DP_ && nc == NC_ && bq == BQ_ && stages == ST_ && pingpong == PP_)   \
    return launch<__nv_bfloat16, DP_, NC_, BQ_, ST_, PP_ != 0>(a, s);
#ifdef FLASH_BWD_ALL_TILES
  FLASH_DKV_TILE(64, 2, 64, 2, 0)
  FLASH_DKV_TILE(64, 2, 64, 2, 1)
  FLASH_DKV_TILE(64, 2, 64, 3, 0)
  FLASH_DKV_TILE(64, 2, 64, 3, 1)
  FLASH_DKV_TILE(128, 1, 64, 2, 0)
  FLASH_DKV_TILE(128, 1, 64, 3, 0)
#else
  FLASH_DKV_TILE(64, kTile64[0], kTile64[1], kTile64[2], kTile64[3])
  FLASH_DKV_TILE(128, kTile128[0], kTile128[1], kTile128[2], kTile128[3])
#endif
#undef FLASH_DKV_TILE
  return -1;
}
