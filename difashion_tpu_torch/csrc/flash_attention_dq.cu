// Flash-attention backward, dQ, for Hopper (sm_90a): bf16 / fp16 in, fp32 accumulation.
//
// Replaces: difashion_tpu/nn/pallas/flash_attention.py::_dq_kernel (reached through
// _backward, the custom VJP of flash_attention): the query gradient of every UNet
// attention of the training step.
//
// What it computes, for one (batch, head) and a tile of 64 * NC query rows,
// looping over BKV-row KV tiles:
//   P  = exp2(scale*log2(e) * Q K^T - LSE*log2(e))   (recomputed from the forward's LSE)
//   dP = dO V^T
//   dS = P * (dP - D),  D = rowsum(dO * O) (computed before the kernel, fp32)
//   dQ = scale * dS K    (dS rounded to the input type before the product, as the
//                         TPU kernel rounds it)
// KV columns >= Skv (the 77-token text context) load as zeros and get P = dS = 0;
// query rows >= Sq are computed on zeros and not stored. No atomics: each dQ
// element is summed by one thread in a fixed order, so results are the same from
// run to run.
//
// What bounds it on the H100: the three products, 6*B*H*Sq*Skv*d operations. At the
// training UNet's 4096-token self-attention (batch 8, 5 heads, d = 64) that is
// 258 GFLOP against 106 MB of q/k/v/dO/LSE/D/dQ, about 2400 operations per
// byte: tensor-core bound (0.26 ms at 989 TFLOP/s). The 77-token
// cross-attention is memory bound (q, dO and dQ pass once through the block, the
// 77 K/V rows are one tile).
//
// What the design does about it (FA3's shape, on hopper_common.cuh; the same
// parts as csrc/flash_attention_dkv.cu):
//   - TMA loads straight from the projections' [B, S, H, D] memory (4-D maps
//     over (D, H, S, B), 64-column boxes, 128-byte swizzle, zero fill past a
//     ragged sequence and past the head dim: no padded copy for d = 16..128,
//     d % 8 == 0).
//   - Warp specialisation: NC consumer warpgroups, each owning 64 query rows,
//     and one producer warp that loads a tile's Q and dO once (TMA) and its
//     LSE and D (its 32 lanes, plain loads, zeros past Sq), and keeps a ring
//     of ST (K, V) stages in flight (full / empty mbarriers a stage). NC = 2
//     leaves ptxas 168 registers a thread (see flash_attention_dkv.cu).
//   - wgmma: S = Q K^T and dP = dO V^T as SS (N = BKV); dS in registers, in
//     the A-fragment layout, for dQ += dS K as RS (K the MN-major B). At
//     N = 64 the SS products read their A and B tiles from shared memory
//     about as fast as the tensor cores consume them; a 96-row KV tile (dQ,
//     S and dP in 157 registers, a tile's products in turn) took 30 % less
//     time than a 64-row one that issued KV tile j + 1's S and dP under tile
//     j's dS K (the forward's overlap, which only 64 rows leave room for);
//     112 rows spilled.
//   - Overlap: the consumer warpgroups take turns (PP) to issue their
//     products. The masks run only on a ragged last KV tile.
//   - Epilogue: dQ * scale rounded once into a swizzled staging tile, then a
//     TMA store that clips rows >= Sq and columns >= d.
//   - Grid: persistent, one block per SM walking the (Q tile, batch * head)
//     tiles, Q tiles fastest, so that the blocks of one head share its K and
//     V in L2; the producer loads the next tile's Q and dO while the consumers
//     finish this one.
// The tile (NC, BKV, ST, PP) per padded head dim is measured by
// scripts/flash_bwd_tiles.py (built with -DFLASH_BWD_ALL_TILES).
//
// Interface: plain C (loaded with ctypes). Tensors are addressed by element strides
// for batch, head and sequence (the last dim is contiguous, every other stride a
// multiple of 8 elements): the [B, S, H, D] views of the projections are read in
// place and dQ is written in the layout given.

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemLimit = 232448;        // dynamic shared memory a block may have

template <int DP, int NC, int BKV, int ST>
struct Plan {
  static constexpr int kChunks = DP / 64;            // 64-column chunks of the head dim
  static constexpr int kBQ = 64 * NC;                // query rows of a tile
  static constexpr int kThreads = 128 * NC + 32;     // consumers, then the producer warp
  static constexpr int kQBytes = kBQ * DP * 2;       // a Q, dO or dQ tile: [chunk][kBQ rows][128 B]
  static constexpr int kKVBytes = BKV * DP * 2;      // a K or V tile: [chunk][BKV rows][128 B]
  static constexpr int kVecBytes = kBQ * 4;          // the LSE or D of a Q tile
  static constexpr int kQTx = 2 * kQBytes;           // the TMA bytes of a Q tile
  static constexpr int kBars = 2 + 2 * ST;           // Q full, empty; a stage's full, empty
  // Q, dO, the dQ staging, the (K, V) ring, the LSE and D, barriers
  static constexpr int kSmem = 1024 + 3 * kQBytes + 2 * ST * kKVBytes + 2 * kVecBytes + 8 * kBars;
  static_assert(DP == 64 || DP == 128, "flash dq: the padded head dim is 64 or 128");
  static_assert(NC >= 1 && NC <= 3, "flash dq: 1 to 3 consumer warpgroups");
  static_assert(BKV % 16 == 0 && BKV >= 64 && BKV <= 128, "flash dq: KV tile");
  static_assert(ST >= 2, "flash dq: stages");
  static_assert(kSmem <= kSmemLimit, "flash dq: shared memory plan");
};

// dS of one KV tile, in place in dp, from S (s) and the rows' base-2 LSE and
// D; with kMask, columns >= `valid` (past Skv) give 0.
template <int BKV, bool kMask>
__device__ __forceinline__ void dscores_masked(float (&dp)[BKV / 2], const float (&s)[BKV / 2],
                                               const float (&lse2)[2], const float (&dl)[2],
                                               float scale_log2, int valid, int t) {
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float p = fast_exp2(fmaf(s[4 * j + e], scale_log2, -lse2[r]));
      const float ds = p * (dp[4 * j + e] - dl[r]);
      dp[4 * j + e] = !kMask || 8 * j + 2 * t + (e & 1) < valid ? ds : 0.f;
    }
  }
}

// The masks only on the ragged last KV tile.
template <int BKV>
__device__ __forceinline__ void dscores(float (&dp)[BKV / 2], const float (&s)[BKV / 2],
                                        const float (&lse2)[2], const float (&dl)[2],
                                        float scale_log2, int valid, int t) {
  if (valid >= BKV)
    dscores_masked<BKV, false>(dp, s, lse2, dl, scale_log2, valid, t);
  else
    dscores_masked<BKV, true>(dp, s, lse2, dl, scale_log2, valid, t);
}

template <typename T, int DP, int NC, int BKV, int ST, bool PP>
__global__ void __launch_bounds__(Plan<DP, NC, BKV, ST>::kThreads, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap domap,
                const __grid_constant__ CUtensorMap dqmap,
                const float* __restrict__ lse, const float* __restrict__ delta, int H,
                int Sq, int Skv, int n_qt,
                int tiles, float scale, float scale_log2) {
  using P = Plan<DP, NC, BKV, ST>;
  constexpr int kBQ = P::kBQ;
  static_assert(!PP || NC >= 2, "flash dq: ping-pong needs two consumer warpgroups");
  extern __shared__ unsigned char smem_raw[];
  // the swizzle patterns repeat every 1024 bytes: align the tiles to them
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sQ = smem;                           // [chunk][kBQ x 128 B]
  unsigned char* sdO = sQ + P::kQBytes;
  unsigned char* sdQ = sdO + P::kQBytes;              // the epilogue's staging
  unsigned char* sK = sdQ + P::kQBytes;               // [stage][chunk][BKV x 128 B]
  unsigned char* sV = sK + ST * P::kKVBytes;
  float* sL = reinterpret_cast<float*>(sV + ST * P::kKVBytes);   // [kBQ]
  float* sD = sL + kBQ;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sD + kBQ);
  uint64_t* q_empty = q_full + 1;
  uint64_t* kv_full = q_full + 2;
  uint64_t* kv_empty = kv_full + ST;
  const int n_kv = (Skv + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 32);               // the producer warp's lanes, one with expect-tx
    mbar_init(q_empty, 4 * NC);          // one arrival per consumer warp
    for (int s = 0; s < ST; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], 4 * NC);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Block i takes tiles i, i + grid, ... (Q tiles of a head fastest); the
  // K/V ring and the barriers' phases run on across them.
  if (threadIdx.x >= 128 * NC) {
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      tma_prefetch(&qmap);
      tma_prefetch(&kmap);
      tma_prefetch(&vmap);
      tma_prefetch(&domap);
    }
    int stage = 0;
    uint32_t phase = 0, q_phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int bh = tile / n_qt, q0 = (tile % n_qt) * kBQ;
      const int b = bh / H, h = bh % H;
      mbar_wait(q_empty, q_phase ^ 1);           // the first round passes at once
      for (int i = lane; i < kBQ; i += 32) {
        const int r = q0 + i;
        sL[i] = r < Sq ? lse[static_cast<int64_t>(bh) * Sq + r] : 0.f;
        sD[i] = r < Sq ? delta[static_cast<int64_t>(bh) * Sq + r] : 0.f;
      }
      if (lane != 0) {
        mbar_arrive(q_full);
      } else {
        mbar_arrive_expect_tx(q_full, P::kQTx);
#pragma unroll
        for (int c = 0; c < P::kChunks; ++c) {
          tma_load_4d(sQ + c * kBQ * kSwRow, &qmap, q_full, c * 64, h, q0, b);
          tma_load_4d(sdO + c * kBQ * kSwRow, &domap, q_full, c * 64, h, q0, b);
        }
        for (int j = 0; j < n_kv; ++j) {
          mbar_wait(&kv_empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&kv_full[stage], 2 * P::kKVBytes);
#pragma unroll
          for (int c = 0; c < P::kChunks; ++c) {
            tma_load_4d(sK + stage * P::kKVBytes + c * BKV * kSwRow, &kmap, &kv_full[stage],
                        c * 64, h, j * BKV, b);
            tma_load_4d(sV + stage * P::kKVBytes + c * BKV * kSwRow, &vmap, &kv_full[stage],
                        c * 64, h, j * BKV, b);
          }
          advance<ST>(stage, phase);
        }
      }
      q_phase ^= 1;
    }
    return;
  }

  const int cw = threadIdx.x / 128;                // this consumer's 64 rows of a Q tile
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;
  // named barriers: the turns 1..NC (PP), then one of this warpgroup's own
  const int my_turn = 1 + cw, next_turn = 1 + (cw + 1) % NC, epilogue = 1 + NC + cw;
  const uint32_t q_addr = smem_u32(sQ) + cw * 64 * kSwRow;
  const uint32_t do_addr = smem_u32(sdO) + cw * 64 * kSwRow;
  const uint32_t k_base = smem_u32(sK), v_base = smem_u32(sV);
  const int r0 = cw * 64 + warp * 16 + g;          // and r0 + 8, of the tile's rows
  float dq[DP / 2];
  float s[BKV / 2], dp[BKV / 2];
  uint32_t da[BKV / 16][4];
  int stage = 0;
  uint32_t phase = 0, q_phase = 0;
  if (PP && cw == NC - 1) named_bar_arrive(1, 256);    // consumer 0 goes first

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int bh = tile / n_qt, q0 = (tile % n_qt) * kBQ;
    const int b = bh / H, h = bh % H;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
    mbar_wait_lo(q_full, q_phase);
    const float lse2[2] = {sL[r0] * kLog2e, sL[r0 + 8] * kLog2e};
    const float dl[2] = {sD[r0], sD[r0 + 8]};

    // each KV tile's three products in turn, the warpgroups taking turns (PP)
    for (int j = 0; j < n_kv; ++j) {
      const int cur = stage;
      const uint32_t cur_phase = phase;
      advance<ST>(stage, phase);
      mbar_wait_lo(&kv_full[cur], cur_phase);
      turn_take<PP>(my_turn);
      wgmma_fence();
      wgmma_ss_rows<T, DP, BKV, kBQ, BKV>(s, q_addr, k_base + cur * P::kKVBytes);
      wgmma_ss_rows<T, DP, BKV, kBQ, BKV>(dp, do_addr, v_base + cur * P::kKVBytes);
      wgmma_commit();
      turn_pass<PP>(next_turn);
      wgmma_wait<0>();
      fence_operands(s);
      fence_operands(dp);
      if (lane == 0 && j + 1 == n_kv) mbar_arrive(q_empty);
      dscores<BKV>(dp, s, lse2, dl, scale_log2, Skv - j * BKV, t);
      pack_rows<T, BKV>(da, dp);
      turn_take<PP>(my_turn);
      wgmma_fence();
      wgmma_rs_cols<T, DP, BKV, BKV>(dq, da, k_base + cur * P::kKVBytes);
      wgmma_commit();
      turn_pass<PP>(next_turn);
      wgmma_wait<0>();
      fence_operands(dq);
      fence_rows(da);
      if (lane == 0) mbar_arrive(&kv_empty[cur]);
    }

    // epilogue: dQ * scale rounded once into this consumer's rows of the
    // staging tile once the previous tile's store has read it, then one TMA
    // store per 64-column chunk (rows >= Sq, columns >= d clipped)
    const float mul[2] = {scale, scale};
    if (leader) tma_store_wait_read<0>();
    named_bar_sync(epilogue, 128);
    stage_rows<T, DP, kBQ>(sdQ + cw * 64 * kSwRow, dq, mul, warp, g, t);
    fence_proxy_async_shared();
    named_bar_sync(epilogue, 128);
    if (leader) {
#pragma unroll
      for (int c = 0; c < P::kChunks; ++c)
        tma_store_4d(&dqmap, sdQ + c * kBQ * kSwRow + cw * 64 * kSwRow, c * 64, h, q0 + cw * 64, b);
      tma_store_commit();
    }
    q_phase ^= 1;
  }
  if (leader) tma_store_wait<0>();
  // consumer 0's turn got one arrival more than it took (the opening one)
  if (PP && cw == 0) named_bar_sync(1, 256);
}

// Element strides, (batch, head, seq) for q, k, v, dO, dQ in that order.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  int B, H, Sq, Skv, D;
  const int64_t* st;
  float scale;
};

template <typename T, int DP, int NC, int BKV, int ST, bool PP>
int launch(const Args& a, cudaStream_t stream) {
  using P = Plan<DP, NC, BKV, ST>;
  auto kern = flash_dq_kernel<T, DP, NC, BKV, ST, PP>;
  // above 48 KB of shared memory only on request; once per instantiation
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (attr != cudaSuccess) return int(attr);
  CUtensorMap maps[5];
  const void* ptrs[5] = {a.q, a.k, a.v, a.dout, a.dq};
  const uint64_t rows[5] = {uint64_t(a.Sq), uint64_t(a.Skv), uint64_t(a.Skv), uint64_t(a.Sq),
                            uint64_t(a.Sq)};
  // Q and dO a Q tile; K and V a KV tile; dQ one consumer's rows
  const uint32_t box_rows[5] = {P::kBQ, BKV, BKV, P::kBQ, 64};
  for (int i = 0; i < 5; ++i) {
    const uint64_t dims[4] = {uint64_t(a.D), uint64_t(a.H), rows[i], uint64_t(a.B)};
    const int64_t strides[3] = {a.st[3 * i + 1], a.st[3 * i + 2], a.st[3 * i]};
    const uint32_t box[4] = {64, 1, box_rows[i], 1};
    const int rc = encode_4d<T>(&maps[i], ptrs[i], dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc != 0) return rc;
  }
  // a persistent grid: one block per SM, or one per tile where there are fewer
  const int n_qt = (a.Sq + P::kBQ - 1) / P::kBQ;
  const int tiles = n_qt * a.B * a.H;
  const int grid = tiles < sm_count() ? tiles : sm_count();
  kern<<<grid, P::kThreads, P::kSmem, stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4],
                                                a.lse, a.delta, a.H, a.Sq, a.Skv, n_qt,
                                                tiles, a.scale, a.scale * kLog2e);
  return int(cudaGetLastError());
}

// The tile each padded head dim runs with (scripts/flash_bwd_tiles.py): NC
// consumer warpgroups (a Q tile of 64 * NC rows), the KV tile, the stages,
// ping-pong (1) or not (0).
constexpr int kTile64[4] = {2, 96, 2, 1};
constexpr int kTile128[4] = {2, 64, 3, 1};

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
  for (int i = 0; i < 15; ++i)
    if (a.st[i] % 8) return false;
  return int64_t(a.B) * a.H * a.Sq < (int64_t(1) << 31);
}

}  // namespace

// strides: 15 element strides, (batch, head, seq) for q, k, v, dout, dq in that
// order, each a multiple of 8. lse, delta: [B*H, Sq] fp32, contiguous. D: any
// multiple of 8 up to 128. dtype: 0 = bf16, 1 = fp16. Returns 0,
// the CUDA error of the launch (> 0), -1 for arguments it does not take, or a
// tensor-map error (hopper_common.cuh).
extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dq, int B, int H, int Sq,
                                  int Skv, int D, const int64_t* strides, float scale,
                                  int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, B, H, Sq, Skv, D, strides, scale};
  if (!args_ok(a)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<__nv_bfloat16>(a, s);
  if (dtype == 1) return dispatch<__half>(a, s);
  return -1;
}

// The same with the tile given: nc consumer warpgroups, a KV tile of bkv rows,
// `stages` stages and ping-pong or not, bf16 only. The default build has the tiles of kTile64 /
// kTile128; -DFLASH_BWD_ALL_TILES builds every candidate
// (scripts/flash_bwd_tiles.py). Returns -1 for a tile that is not built.
extern "C" int flash_attention_dq_tile(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* delta,
                                       void* dq, int B, int H, int Sq, int Skv, int D,
                                       const int64_t* strides, float scale, int nc, int bkv,
                                       int stages, int pingpong, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, B, H, Sq, Skv, D, strides, scale};
  if (!args_ok(a)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = D <= 64 ? 64 : 128;
#define FLASH_DQ_TILE(DP_, NC_, BKV_, ST_, PP_)                                  \
  if (dp == DP_ && nc == NC_ && bkv == BKV_ && stages == ST_ && pingpong == PP_) \
    return launch<__nv_bfloat16, DP_, NC_, BKV_, ST_, PP_ != 0>(a, s);
#ifdef FLASH_BWD_ALL_TILES
  FLASH_DQ_TILE(64, 2, 80, 3, 0)
  FLASH_DQ_TILE(64, 2, 96, 2, 0)
  FLASH_DQ_TILE(64, 2, 96, 2, 1)
  FLASH_DQ_TILE(64, 2, 96, 3, 0)
  FLASH_DQ_TILE(128, 2, 64, 2, 0)
  FLASH_DQ_TILE(128, 2, 64, 3, 1)
#else
  FLASH_DQ_TILE(64, kTile64[0], kTile64[1], kTile64[2], kTile64[3])
  FLASH_DQ_TILE(128, kTile128[0], kTile128[1], kTile128[2], kTile128[3])
#endif
#undef FLASH_DQ_TILE
  return -1;
}
