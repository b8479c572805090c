// Flash-attention forward for Hopper (sm_90a), bf16 / fp16 in, fp32 accumulation.
//
// Replaces: difashion_tpu/nn/pallas/flash_attention.py::_fwd_kernel (reached through
// _forward and flash_attention), the TPU kernel that carries every UNet attention
// of the generation loop.
//
// What it computes: non-causal softmax(scale * Q K^T) V for one (batch, head) and a
// tile of 64 * NC query rows per block, with an online softmax over BKV-row KV
// tiles in the base-2 domain (scale * log2(e) applied to S in fp32). Columns >= Skv
// are masked to -inf (ragged 77-token text KV); query rows >= Sq are computed on
// zeros and not stored. Outputs O in the input type and the per-row natural-log
// LSE in fp32, [B*H, Sq] (the TPU's 8-sublane broadcast of the LSE is dropped),
// which the dQ and dK/dV kernels read unchanged.
//
// What bounds it on the H100: the two products. At the UNet's 4096-token level
// (batch 16, 5 heads, d = 64) one call is 4*B*H*Sq*Skv*d = 344 GFLOP against
// 168 MB of q/k/v/o, about 2000 operations per byte, far above the card's ~295
// bf16 operations per byte: tensor-core bound (0.35 ms at 989 TFLOP/s). The
// 77-token cross-attention and the 256-token level are memory bound instead.
//
// What the design does about it (FA3-style, on hopper_common.cuh):
//   - TMA loads straight from the projections' [B, S, H, D] memory: 4-D maps
//     over (D, H, S, B) with the tensors' own strides, boxes of 64 columns x 1
//     head x a row tile, 128-byte swizzle. S is a dimension of its own, so the
//     loads zero-fill past a ragged sequence's end (never reading the next
//     sequence's rows) and the stores clip rows >= Sq. The zero fill is also
//     the head-dim padding: one 64-column box over d = 16, 32 or 40 gives 64
//     columns, two over d = 80 or 128 give 128 (DP, the padded head dim).
//     Zero columns of Q, K and V leave S and the kept columns of O unchanged.
//   - Warp specialisation: warpgroup 0 is the producer (setmaxnreg down), one
//     thread of which loads Q once and K/V tiles into a ring of ST stages,
//     with separate full / empty mbarriers for K and for V, so that QK^T of
//     a tile starts when its K has landed and K's stage frees as soon as the
//     product has read it. Warpgroups 1..NC are the consumers (setmaxnreg
//     up), each owning 64 query rows: NC = 2 gives a 128-row Q tile, half the
//     K/V traffic per query row of a 64-row tile.
//   - wgmma for both products: S = Q K^T is SS (m64nBKVk16, K read K-major),
//     O += P V is RS: P is rounded to bf16 / fp16 in registers, where the S
//     accumulator layout is already the A-fragment layout; V is the MN-major
//     B (the transpose bit), 64-column chunks LBO apart.
//   - Overlap: between warpgroups, named barriers pass a turn round
//     (ping-pong), so one warpgroup issues its products while the others run
//     their softmax. Within a warpgroup, where the registers allow (DP = 64,
//     BKV = 128), KV tile j's QK^T is issued together with tile j-1's PV and
//     tile j's softmax runs while PV is on the tensor cores; elsewhere a
//     tile's two products run in turn (S, P and O live at once would spill).
//     ex2.approx as in the mma.sync kernels.
//   - Epilogue: O / l rounded once into a 128-byte-swizzled staging tile,
//     then TMA-stored; the LSE written directly at rows < Sq.
//   - Grid: persistent, one block per SM walking the (Q tile, batch * head)
//     tiles with Q tiles fastest, so blocks of one head run together and
//     share its K/V in L2. The ring and the barriers run on across tiles: the
//     producer loads the next tile's Q (once the consumers' last QK^T has
//     read this one) and K/V while the consumers finish this tile and store
//     it. A 77-token cross-attention is one KV tile a Q tile; without that
//     overlap each block's load-compute-store chain ran alone on its SM
//     (one block of 384 threads fills an SM's registers).
// The tile (NC consumers, BKV, stages) per padded head dim is measured by
// scripts/flash_fwd_tiles.py (built with -DFLASH_FWD_ALL_TILES, which
// instantiates every candidate).
//
// Interface: plain C (loaded with ctypes). Tensors are addressed by element
// strides for batch, head and sequence (the last dim is contiguous; every other
// stride a multiple of 8 elements, a TMA rule), so the [B, S, H, D] view of a
// projection is read in place and O is written in the layout given.

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRow = 128;                 // bytes of one swizzled row: 64 16-bit columns
constexpr int kSmemLimit = 232448;        // dynamic shared memory a block may have

template <int DP, int NC, int BKV, int ST>
struct Plan {
  static constexpr int kChunks = DP / 64;            // 64-column chunks of the head dim
  static constexpr int kBQ = 64 * NC;                // query rows of a tile
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr int kQBytes = kBQ * DP * 2;       // [chunk][kBQ rows][128 B]
  static constexpr int kOBytes = kQBytes;            // the consumers' O staging, the same layout
  static constexpr int kKVBytes = BKV * DP * 2;      // one K or V tile: [chunk][BKV rows][128 B]
  static constexpr int kBars = 2 + 4 * ST;           // Q full, empty; K, V full, empty per stage
  static constexpr int kSmem = 1024 + kQBytes + kOBytes + 2 * ST * kKVBytes + 8 * kBars;
  // registers a thread after setmaxnreg, 64K a block: 2 consumers 232 (the
  // producer 40, as in the skinny kernel), 3 consumers 160 (the producer 32)
  static constexpr int kProducerRegs = NC == 2 ? 40 : 32;
  static constexpr int kConsumerRegs = NC == 2 ? 232 : 160;
  // What ptxas allocates a thread under __launch_bounds__(kThreads, 1),
  // consumers included (their SASS uses no register past it; setmaxnreg
  // moves the runtime allocation only): 168 or 128. Issuing tile j's QK^T
  // beside tile j-1's PV keeps S, P and O live at once (and ~40 registers of
  // addresses and softmax state): only where that fits (DP = 64, BKV = 128,
  // 2 consumers); elsewhere a tile's products run one after the other (S and
  // O live, then P and O), which ran without spills where the overlap spilled.
  static constexpr int kRegCap = (65536 / kThreads) & ~7;
  static constexpr bool kOverlap = BKV / 2 + BKV / 4 + DP / 2 + 40 <= kRegCap;
  static_assert(DP == 64 || DP == 128, "flash fwd: the padded head dim is 64 or 128");
  static_assert(NC == 2 || NC == 3, "flash fwd: 2 or 3 consumer warpgroups");
  static_assert(BKV % 16 == 0 && BKV <= 256 && ST >= 2, "flash fwd: KV tile");
  static_assert(kSmem <= kSmemLimit, "flash fwd: shared memory plan");
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values rounded to T and packed, the first in the low half.
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

// S = Q K^T for this consumer's 64 rows and the BKV rows of a K tile: DP / 16
// k-steps, each 32 bytes along the swizzled rows of a 64-column chunk.
template <typename T, int DP, int BKV, int BQ>
__device__ __forceinline__ void issue_qk(float (&s)[BKV / 2], uint32_t q_addr,
                                         uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int c = kk / 4, off = (kk % 4) * 32;
    const uint64_t da = wgmma_desc_sw128(q_addr + c * BQ * kRow + off, 16, 1024);
    const uint64_t db = wgmma_desc_sw128(k_addr + c * BKV * kRow + off, 16, 1024);
    wgmma_ss<T, BKV, 0>(s, da, db, kk != 0);
  }
}

// O += P V: P from registers (BKV / 16 k-steps of 16 KV rows), V MN-major in
// 64-column chunks BKV * 128 bytes apart; a k-step moves 16 rows (2048 bytes).
template <typename T, int DP, int BKV>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2], const uint32_t (&p)[BKV / 16][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    const uint64_t db = wgmma_desc_sw128(v_addr + kk * 16 * kRow, BKV * kRow, 1024);
    wgmma_rs<T, DP, 1>(o, p[kk], db, 1);
  }
}

// The online softmax of one S tile, in place: columns >= `valid` masked to
// -inf; each thread holds rows g and g + 8 of its warp, a row spread over the
// 4 threads of a quad. m is the running row max of raw S, l the thread's
// partial row sum, alpha the factor that brings the previous O to the new max.
template <int BKV>
__device__ __forceinline__ void softmax_tile(float (&s)[BKV / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale_log2, int valid,
                                             int t) {
  if (valid < BKV) {
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (8 * j + 2 * t + (i & 1) >= valid) s[4 * j + i] = -INFINITY;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
    alpha[r] = fast_exp2((m[r] - mx) * scale_log2);   // 0 on the first tile (m = -inf)
    m[r] = mx;
    const float m2 = mx * scale_log2;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      s[4 * j + 2 * r] = fast_exp2(fmaf(s[4 * j + 2 * r], scale_log2, -m2));
      s[4 * j + 2 * r + 1] = fast_exp2(fmaf(s[4 * j + 2 * r + 1], scale_log2, -m2));
      sum += s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
    }
    l[r] = alpha[r] * l[r] + sum;
  }
}

// P rounded to T in the A-fragment layout: k-step kk takes accumulator columns
// 16kk..16kk+15, i.e. registers 8kk..8kk+7.
template <typename T, int BKV>
__device__ __forceinline__ void pack_p(uint32_t (&p)[BKV / 16][4], const float (&s)[BKV / 2]) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) p[kk][i] = round_pair<T>(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// P's registers stay live and in place until the PV wgmma reading them is waited for.
template <int K>
__device__ __forceinline__ void fence_rows(uint32_t (&p)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) fence_operands(p[kk]);
}

template <int DP>
__device__ __forceinline__ void rescale(float (&o)[DP / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

template <int ST>
__device__ __forceinline__ void advance(int& stage, uint32_t& phase) {
  if (++stage == ST) { stage = 0; phase ^= 1; }
}

template <typename T, int DP, int NC, int BKV, int ST>
__global__ void __launch_bounds__(Plan<DP, NC, BKV, ST>::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap omap, float* __restrict__ lse, int H,
                 int Sq, int Skv, int n_qt, int tiles, float scale, float scale_log2) {
  using P = Plan<DP, NC, BKV, ST>;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle patterns repeat every 1024 bytes: align the tiles to them
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sQ = smem;                           // [chunk][kBQ x 128 B]
  unsigned char* sO = sQ + P::kQBytes;                // [chunk][kBQ x 128 B]
  unsigned char* sK = sO + P::kOBytes;                // [stage][chunk][BKV x 128 B]
  unsigned char* sV = sK + ST * P::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + ST * P::kKVBytes);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_full + 2;
  uint64_t* v_full = k_full + ST;
  uint64_t* k_empty = v_full + ST;
  uint64_t* v_empty = k_empty + ST;
  const int n_kv = (Skv + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);                // the producer's arrive-expect-tx
    mbar_init(q_empty, 4 * NC);          // one arrival per consumer warp
    for (int s = 0; s < ST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 4 * NC);
      mbar_init(&v_empty[s], 4 * NC);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // The roles part here and never meet again (setmaxnreg needs the paths
  // not to reconverge). Block i takes tiles i, i + grid, ... (Q tiles of a
  // head fastest); the K/V ring and the barriers' phases run on across them,
  // so the producer loads the next tile's Q and K/V while the consumers
  // finish this one.
  if (threadIdx.x < 128) {
    setmaxnreg_dec<P::kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch(&qmap);
      tma_prefetch(&kmap);
      tma_prefetch(&vmap);
      int stage = 0;
      uint32_t phase = 0, q_phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int bh = tile / n_qt, q0 = (tile % n_qt) * P::kBQ;
        const int b = bh / H, h = bh % H;
        mbar_wait(q_empty, q_phase ^ 1);         // the first round passes at once
        mbar_arrive_expect_tx(q_full, P::kQBytes);
#pragma unroll
        for (int c = 0; c < P::kChunks; ++c)
          tma_load_4d(sQ + c * P::kBQ * kRow, &qmap, q_full, c * 64, h, q0, b);
        for (int j = 0; j < n_kv; ++j) {
          mbar_wait(&k_empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&k_full[stage], P::kKVBytes);
          unsigned char* kt = sK + stage * P::kKVBytes;
#pragma unroll
          for (int c = 0; c < P::kChunks; ++c)
            tma_load_4d(kt + c * BKV * kRow, &kmap, &k_full[stage], c * 64, h, j * BKV, b);
          mbar_wait(&v_empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&v_full[stage], P::kKVBytes);
          unsigned char* vt = sV + stage * P::kKVBytes;
#pragma unroll
          for (int c = 0; c < P::kChunks; ++c)
            tma_load_4d(vt + c * BKV * kRow, &vmap, &v_full[stage], c * 64, h, j * BKV, b);
          advance<ST>(stage, phase);
        }
        q_phase ^= 1;
      }
    }
  } else {
    setmaxnreg_inc<P::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;            // this consumer's 64 rows of a Q tile
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const bool leader = threadIdx.x % 128 == 0;
    // ping-pong: a consumer issues its products between bar.sync on its own
    // barrier and bar.arrive on the next consumer's (256 threads each: the
    // waiting warpgroup and the arriving one)
    const int my_turn = 1 + cw, next_turn = 1 + (cw + 1) % NC, epilogue = 1 + NC + cw;
    if (cw == NC - 1) named_bar_arrive(1, 256);      // consumer 0 goes first

    const uint32_t q_addr = smem_u32(sQ) + cw * 64 * kRow;
    const uint32_t k_addr = smem_u32(sK), v_addr = smem_u32(sV);
    unsigned char* staging = sO + cw * 64 * kRow;
    const int r0 = warp * 16 + g;                    // and r0 + 8, of this consumer's 64 rows
    float o[DP / 2];
    float s[BKV / 2];
    uint32_t p[BKV / 16][4];
    int stage = 0;
    uint32_t phase = 0, q_phase = 0;

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int bh = tile / n_qt, q0 = (tile % n_qt) * P::kBQ;
      const int b = bh / H, h = bh % H;
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
      mbar_wait_lo(q_full, q_phase);

      if constexpr (P::kOverlap) {
        // KV tile 0: QK^T alone
        int prev = stage;
        uint32_t prev_phase = phase;
        advance<ST>(stage, phase);
        mbar_wait_lo(&k_full[prev], prev_phase);
        named_bar_sync(my_turn, 256);
        wgmma_fence();
        issue_qk<T, DP, BKV, P::kBQ>(s, q_addr, k_addr + prev * P::kKVBytes);
        wgmma_commit();
        named_bar_arrive(next_turn, 256);
        wgmma_wait<0>();
        fence_operands(s);
        if (lane == 0) {
          mbar_arrive(&k_empty[prev]);
          if (n_kv == 1) mbar_arrive(q_empty);       // this tile's last read of Q
        }
        softmax_tile<BKV>(s, m, l, alpha, scale_log2, Skv, t);
        pack_p<T, BKV>(p, s);
        // KV tile j: QK^T of j and PV of j - 1 in flight, then the softmax
        // of j while PV runs
        for (int j = 1; j < n_kv; ++j) {
          const int cur = stage;
          const uint32_t cur_phase = phase;
          advance<ST>(stage, phase);
          mbar_wait_lo(&k_full[cur], cur_phase);
          named_bar_sync(my_turn, 256);
          wgmma_fence();
          issue_qk<T, DP, BKV, P::kBQ>(s, q_addr, k_addr + cur * P::kKVBytes);
          wgmma_commit();
          rescale<DP>(o, alpha);
          mbar_wait_lo(&v_full[prev], prev_phase);
          wgmma_fence();
          issue_pv<T, DP, BKV>(o, p, v_addr + prev * P::kKVBytes);
          wgmma_commit();
          named_bar_arrive(next_turn, 256);
          wgmma_wait<1>();
          fence_operands(s);
          if (lane == 0) {
            mbar_arrive(&k_empty[cur]);
            if (j == n_kv - 1) mbar_arrive(q_empty);
          }
          softmax_tile<BKV>(s, m, l, alpha, scale_log2, Skv - j * BKV, t);
          wgmma_wait<0>();
          fence_operands(o);
          fence_rows(p);
          if (lane == 0) mbar_arrive(&v_empty[prev]);
          pack_p<T, BKV>(p, s);
          prev = cur;
          prev_phase = cur_phase;
        }
        // the last KV tile's PV
        rescale<DP>(o, alpha);
        mbar_wait_lo(&v_full[prev], prev_phase);
        wgmma_fence();
        issue_pv<T, DP, BKV>(o, p, v_addr + prev * P::kKVBytes);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(o);
        fence_rows(p);
        if (lane == 0) mbar_arrive(&v_empty[prev]);
      } else {
        // each KV tile's QK^T, softmax and PV in turn
        for (int j = 0; j < n_kv; ++j) {
          const int cur = stage;
          const uint32_t cur_phase = phase;
          advance<ST>(stage, phase);
          mbar_wait_lo(&k_full[cur], cur_phase);
          named_bar_sync(my_turn, 256);
          wgmma_fence();
          issue_qk<T, DP, BKV, P::kBQ>(s, q_addr, k_addr + cur * P::kKVBytes);
          wgmma_commit();
          named_bar_arrive(next_turn, 256);
          wgmma_wait<0>();
          fence_operands(s);
          if (lane == 0) {
            mbar_arrive(&k_empty[cur]);
            if (j == n_kv - 1) mbar_arrive(q_empty);
          }
          softmax_tile<BKV>(s, m, l, alpha, scale_log2, Skv - j * BKV, t);
          rescale<DP>(o, alpha);
          pack_p<T, BKV>(p, s);
          mbar_wait_lo(&v_full[cur], cur_phase);
          wgmma_fence();
          issue_pv<T, DP, BKV>(o, p, v_addr + cur * P::kKVBytes);
          wgmma_commit();
          wgmma_wait<0>();
          fence_operands(o);
          fence_rows(p);
          if (lane == 0) mbar_arrive(&v_empty[cur]);
        }
      }

      // epilogue: finish the row sums over the quad, O / l rounded once into
      // this consumer's rows of the staging tile (128-byte swizzle: the
      // 16-byte unit u of row r lands at u ^ (r % 8)) once the previous
      // tile's store has read it, then one TMA store per 64-column chunk
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffff, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffff, l[r], 2);
      }
      const float inv[2] = {1.f / l[0], 1.f / l[1]};
      if (leader) tma_store_wait_read<0>();
      named_bar_sync(epilogue, 128);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = r0 + 8 * hh;
          const int off = (j / 8) * P::kBQ * kRow + r * kRow + (((j % 8) ^ (r & 7)) << 4) + t * 4;
          *reinterpret_cast<uint32_t*>(staging + off) =
              round_pair<T>(o[4 * j + 2 * hh] * inv[hh], o[4 * j + 2 * hh + 1] * inv[hh]);
        }
      }
      fence_proxy_async_shared();
      named_bar_sync(epilogue, 128);
      if (leader) {
#pragma unroll
        for (int c = 0; c < P::kChunks; ++c)
          tma_store_4d(&omap, staging + c * P::kBQ * kRow, c * 64, h, q0 + cw * 64, b);
        tma_store_commit();
      }
      if (t == 0) {
        float* lb = lse + static_cast<int64_t>(bh) * Sq;
        const int row = q0 + cw * 64 + r0;
        if (row < Sq) lb[row] = m[0] * scale + logf(l[0]);
        if (row + 8 < Sq) lb[row + 8] = m[1] * scale + logf(l[1]);
      }
      q_phase ^= 1;
    }
    if (leader) tma_store_wait<0>();
    // consumer 0's barrier got one arrival more than its turns (the opening one)
    if (cw == 0) named_bar_sync(my_turn, 256);
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

// Element strides, (batch, head, seq) for q, k, v, o in that order.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, H, Sq, Skv, D;
  const int64_t* st;
  float scale;
};

template <typename T, int DP, int NC, int BKV, int ST>
int launch(const Args& a, cudaStream_t stream) {
  using P = Plan<DP, NC, BKV, ST>;
  auto kern = flash_fwd_kernel<T, DP, NC, BKV, ST>;
  // above 48 KB of shared memory only on request; once per instantiation
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (attr != cudaSuccess) return int(attr);
  CUtensorMap maps[4];
  const void* ptrs[4] = {a.q, a.k, a.v, a.o};
  const uint64_t rows[4] = {uint64_t(a.Sq), uint64_t(a.Skv), uint64_t(a.Skv), uint64_t(a.Sq)};
  const uint32_t box_rows[4] = {P::kBQ, BKV, BKV, 64};   // O: one consumer's rows a store
  for (int i = 0; i < 4; ++i) {
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
  kern<<<grid, P::kThreads, P::kSmem, stream>>>(maps[0], maps[1], maps[2], maps[3], a.lse, a.H,
                                                a.Sq, a.Skv, n_qt, tiles, a.scale,
                                                a.scale * kLog2e);
  return int(cudaGetLastError());
}

// The tile each padded head dim runs with (scripts/flash_fwd_tiles.py): NC
// consumer warpgroups, the KV tile, the stages.
constexpr int kTile64[3] = {2, 128, 2};
constexpr int kTile128[3] = {2, 128, 2};

template <typename T, int DP>
int launch_default(const Args& a, cudaStream_t s) {
  if constexpr (DP == 64)
    return launch<T, 64, kTile64[0], kTile64[1], kTile64[2]>(a, s);
  else
    return launch<T, 128, kTile128[0], kTile128[1], kTile128[2]>(a, s);
}

template <typename T>
int dispatch(const Args& a, cudaStream_t s) {
  // the kernel pads the head dim to 64 or 128 with TMA's zero fill
  const int dp = a.D <= 64 ? 64 : 128;
  switch (dp) {
    case 64: return launch_default<T, 64>(a, s);
    case 128: return launch_default<T, 128>(a, s);
    default: return -1;
  }
}

bool args_ok(const Args& a) {
  if (a.B <= 0 || a.H <= 0 || a.Sq <= 0 || a.Skv <= 0 || a.D <= 0 || a.D > 128 || a.D % 8)
    return false;
  for (int i = 0; i < 12; ++i)
    if (a.st[i] % 8) return false;
  return a.B * a.H <= 65535;
}

}  // namespace

// strides: 12 element strides, (batch, head, seq) for q, k, v, o in that order,
// each a multiple of 8. D: any multiple of 8 up to 128. dtype: 0 = bf16, 1 =
// fp16. Returns 0, the CUDA error of the launch (> 0), -1 for arguments it does
// not take, or a tensor-map error (hopper_common.cuh).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int B, int H, int Sq, int Skv, int D,
                                   const int64_t* strides, float scale, int dtype, void* stream) {
  const Args a{q, k, v, o, lse, B, H, Sq, Skv, D, strides, scale};
  if (!args_ok(a)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<__nv_bfloat16>(a, s);
  if (dtype == 1) return dispatch<__half>(a, s);
  return -1;
}

// The same with the tile given: nc consumer warpgroups (2 or 3), a KV tile of
// bkv rows and `stages` stages, bf16 only. The default build has the tiles of
// kTile64 / kTile128; -DFLASH_FWD_ALL_TILES builds every candidate that fits
// (scripts/flash_fwd_tiles.py). Returns -1 for a tile that is not built.
extern "C" int flash_attention_fwd_tile(const void* q, const void* k, const void* v, void* o,
                                        float* lse, int B, int H, int Sq, int Skv, int D,
                                        const int64_t* strides, float scale, int nc, int bkv,
                                        int stages, void* stream) {
  const Args a{q, k, v, o, lse, B, H, Sq, Skv, D, strides, scale};
  if (!args_ok(a)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = D <= 64 ? 64 : 128;
#define FLASH_FWD_TILE(DP_, NC_, BKV_, ST_)                                      \
  if (dp == DP_ && nc == NC_ && bkv == BKV_ && stages == ST_)                    \
    return launch<__nv_bfloat16, DP_, NC_, BKV_, ST_>(a, s);
#ifdef FLASH_FWD_ALL_TILES
  FLASH_FWD_TILE(64, 2, 128, 2)
  FLASH_FWD_TILE(64, 2, 128, 3)
  FLASH_FWD_TILE(64, 2, 176, 2)
  FLASH_FWD_TILE(64, 2, 176, 3)
  FLASH_FWD_TILE(64, 3, 128, 2)
  FLASH_FWD_TILE(64, 3, 128, 3)
  FLASH_FWD_TILE(128, 2, 128, 2)
#else
  FLASH_FWD_TILE(64, kTile64[0], kTile64[1], kTile64[2])
  FLASH_FWD_TILE(128, kTile128[0], kTile128[1], kTile128[2])
#endif
#undef FLASH_FWD_TILE
  return -1;
}
