// GroupNorm (+ SiLU) for Hopper (sm_90a) over channels-last x: bf16 / fp16 /
// fp32 in and out, fp32 statistics.
//
// Replaces: difashion_tpu/nn/pallas/groupnorm.py::_gn_silu_kernel (reached through
// _pallas_gn_silu and the _gn_silu custom VJP), the TPU kernel for every
// GroupNorm of the UNet's ResnetBlocks, its Transformer2D input norms and
// conv_norm_out; here it also takes every GroupNorm of the VAE.
//
// What it computes: x is [B, S, C] in memory (a channels-last [B, C, H, W]),
// as the TPU kernel reads it. Group mean and biased variance in fp32; then
// y = (x - mean) * a + bias[c] with a = scale[c] * rstd in fp32 (the TPU
// kernel's x * a + (bias - mean * a) cancels where |mean| >> std), rounded
// to the input type; then, with SiLU, silu(y) computed in fp32 from
// the rounded y and rounded again (the order of `_gn_silu_ref`, not the
// Pallas kernel's, which applies SiLU before rounding).
//
// What bounds it on the H100: bytes. A group norm does about ten operations
// per element against 4 (bf16) or 8 (fp32) bytes read and written, far below
// the card's ~295 operations per byte. The least it can take is one read of x
// and one write of y at 3.35 TB/s.
//
// What the design does about it: it reads x once. The TPU kernel holds a
// whole [S, C] row in VMEM; a Hopper block holds at most 227 KB, so here the
// unit of work is one batch row and a band of k adjacent groups (k the
// smallest count whose channels make a multiple of 16 bytes), owned by a
// thread-block cluster of n CTAs that split the S pixels:
//
//   one-read route (gn_cluster_kernel): each CTA loads its [rows, k * cg]
//     slice into shared memory once, by TMA through one 3-D map over
//     (C, S, B) (its rows are 20-240 bytes long at a stride of C, which TMA
//     fetches whole and coalesced loads would not); computes each group's
//     (count, mean, M2) of the slice exactly (two passes over shared memory:
//     the mean, then the squared deviations from it); publishes them in its
//     shared memory; after a cluster barrier reads every CTA's partials over
//     DSMEM (mapa / ld.shared::cluster) and merges them with Chan's formula in
//     rank order, so every CTA gets the same bits; then normalises the slice
//     in shared memory, with a channel's mean, a and bias loaded once, and stores it
//     by TMA. The caller picks n (nn/kernels/groupnorm.py::gn_plan) so that a
//     slice fits; more than 8 CTAs take the non-portable cluster size.
//   two-pass route (gn_partials_kernel, gn_finalize_kernel, gn_apply_kernel): where a band does
//     not fit a cluster (the VAE's 512x512 levels: 4 MB a band) or TMA cannot
//     take the tensor (a row of C * sizeof(T) bytes not a multiple of 16, or
//     x not 16-byte aligned). Pass 1 writes per-element Welford moments of a
//     chunk of rows, merged per channel and per group in a fixed order, as one
//     (count, mean, M2) partial per (row, group, chunk); a warp per group
//     merges its partials into its mean and rstd; pass 2 writes y, reading x
//     again (from L2 where it still lies). A block covers every channel of its rows, so a warp reads whole
//     rows; 16-byte vectors where the alignment allows, scalars otherwise;
//     offsets are 64-bit (the VAE encoder's first level at batch 64 holds
//     2^31 elements).
//
// Either way a thread keeps one vector column of its band for all its rows,
// so its channels, and their mean, a and bias, are fixed. Sums are taken in a fixed
// order, without atomics and never as E[x^2] - E[x]^2: the same result on
// every run, exact when |mean| >> std.
//
// Interface: plain C (loaded with ctypes). The caller allocates y and the
// two-pass route's partials and counts one launch per call.

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBand = 256;     // channels of a one-read band: TMA's box limit
constexpr int kMaxK = 8;          // groups of a one-read band: 16 bytes / 2-byte elements
constexpr int kMaxBoxes = 64;     // TMA boxes of a one-read slice, a barrier each
constexpr int kMaxCluster = 16;   // CTAs of a cluster (the non-portable size)
constexpr int kMaxSliceBytes = 208 * 1024;  // a one-read slice beside the static arrays

// With -DGN_PHASE_TIMES (scripts/group_norm_plans.py --phases), thread 0 of
// every one-read CTA stamps the global timer at its phase boundaries, for
// group_norm_silu_phase_times to read back.
#ifdef GN_PHASE_TIMES
constexpr int kTimedCtas = 65536;
__device__ unsigned long long g_phase_ns[kTimedCtas][8];
#define GN_STAMP(i)                                                                    \
  do {                                                                                 \
    const unsigned cta = blockIdx.y * gridDim.x + blockIdx.x;                          \
    if (threadIdx.x == 0 && cta < kTimedCtas) g_phase_ns[cta][i] = globaltimer_ns();    \
  } while (0)
#else
#define GN_STAMP(i) \
  do {              \
  } while (0)
#endif

constexpr int kRouteCluster = 0;
constexpr int kRouteTwoPass = 1;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) { return __float2half_rn(v); }

// VEC elements at p (16 bytes, or one element), as floats.
template <typename T, int VEC, bool kGlobal>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_float(kGlobal ? __ldg(p) : *p);
  } else {
    static_assert(VEC * sizeof(T) == 16, "a vector is 16 bytes");
    const uint4 u = kGlobal ? __ldg(reinterpret_cast<const uint4*>(p))
                            : *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_float(e[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const T (&v)[VEC]) {
  if constexpr (VEC == 1) {
    *p = v[0];
  } else {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = v[i];
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// y = (x - mean) * a + b in fp32, rounded; then SiLU in fp32 from the
// rounded y, rounded. The SiLU takes the fast exp and division (ex2.approx,
// rcp.approx): a few units in fp32's last place, far inside the tolerances,
// where the accurate ones cost as much as the memory traffic.
template <typename T, int VEC, bool kSiLU>
__device__ __forceinline__ void affine(const float (&x)[VEC], const float (&mean)[VEC],
                                       const float (&a)[VEC], const float (&b)[VEC],
                                       T (&y)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    T t = from_float<T>(fmaf(x[i] - mean[i], a[i], b[i]));
    if constexpr (kSiLU) {
      const float z = to_float(t);
      t = from_float<T>(__fdividef(z, 1.f + __expf(-z)));
    }
    y[i] = t;
  }
}

struct Moments {
  float n, mean, m2;  // count, mean, sum of squared deviations from the mean
};

// Chan et al.'s pairwise update: the moments of the union of two disjoint sets.
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float wb = b.n / n;
  const float delta = b.mean - a.mean;
  return {n, a.mean + delta * wb, a.m2 + b.m2 + delta * delta * a.n * wb};
}

__device__ __forceinline__ Moments warp_merge(Moments m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Moments o;
    o.n = __shfl_xor_sync(0xffffffffu, m.n, off);
    o.mean = __shfl_xor_sync(0xffffffffu, m.mean, off);
    o.m2 = __shfl_xor_sync(0xffffffffu, m.m2, off);
    m = merge(m, o);
  }
  return m;
}

__device__ __forceinline__ float rstd_of(const Moments& m, float eps) {
  return 1.f / sqrtf(m.m2 / m.n + eps);  // biased variance
}

// The band a block works on: kc = k * cg channels read in vectors of VEC,
// vw vector columns; thread t < rs * vw keeps vector column t % vw of rows
// t / vw, t / vw + rs, ... (rs = kThreads / vw rows per sweep).
struct Band {
  int kc, vw, rs, v, rf;
  bool active;
  template <int VEC>
  __device__ __forceinline__ static Band make(int k, int cg) {
    Band d;
    d.kc = k * cg;
    d.vw = d.kc / VEC;
    d.rs = kThreads / d.vw;
    d.v = threadIdx.x % d.vw;
    d.rf = threadIdx.x / d.vw;
    d.active = int(threadIdx.x) < d.rs * d.vw;
    return d;
  }
};

// Per-group sums of the per-element partials `acc` of the block's threads:
// out[j] for the band's group j < k (kc <= kThreads, k <= kWarps), in a fixed
// order: the rows of a sweep in P interleaved parts per channel (P =
// kThreads / kc), the parts in order, then the group's channels by warp j's
// lanes and a shuffle tree. Ends with a barrier.
template <int VEC>
__device__ __forceinline__ void band_group_sums(const Band& d, const float (&acc)[VEC], int k,
                                                int cg, float* red, float* chan, float* out) {
  const int t = threadIdx.x;
  if (d.active) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) red[t * VEC + i] = acc[i];  // = red[rf * kc + v * VEC + i]
  }
  __syncthreads();
  const int parts = max(1, min(d.rs, kThreads / d.kc));
  float s = 0.f;
  if (t < parts * d.kc) {
    const int c = t % d.kc;
    for (int q = t / d.kc; q < d.rs; q += parts) s += red[q * d.kc + c];
  }
  __syncthreads();
  if (t < parts * d.kc) red[t] = s;  // red[p * kc + c]
  __syncthreads();
  if (t < d.kc) {
    float sc = 0.f;
    for (int p = 0; p < parts; ++p) sc += red[p * d.kc + t];
    chan[t] = sc;
  }
  __syncthreads();
  const int warp = t >> 5, lane = t & 31;
  if (warp < k) {
    float sg = 0.f;
    for (int c = lane; c < cg; c += 32) sg += chan[warp * cg + c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sg += __shfl_xor_sync(0xffffffffu, sg, off);
    if (lane == 0) out[warp] = sg;
  }
  __syncthreads();
}

// ---- one-read route ---------------------------------------------------------------------------

// grid (n, groups / k * B), clusters of (n, 1, 1): cluster u holds band
// u % (groups / k) of batch row u / (groups / k), its CTA `rank` the rows
// [rank * rows_per_cta, ...) of it in shared memory, loaded by TMA in boxes of
// box_rows rows (a multiple of 8, so that every box starts 128-byte aligned),
// each box on a barrier of its own: the sums of a box start while the later
// boxes are in flight, and a box is stored as soon as it is normalised. The
// slice's statistics are exact two-pass sums over shared memory (the group
// means, then the squared deviations from them), merged across the cluster
// with Chan's formula in rank order.
template <typename T, bool kSiLU>
__global__ void __launch_bounds__(kThreads)
gn_cluster_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap ymap, const float* __restrict__ scale,
                  const float* __restrict__ bias, int S, int cg, int k, int bands,
                  int rows_per_cta, int box_rows, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);  // [rows][kc]
  __shared__ float red[kThreads * VEC];
  __shared__ float chan[kMaxBand];
  __shared__ float gsum[kMaxK];
  __shared__ float part[kMaxK][3];  // this slice's (count, mean, M2), read by the cluster
  __shared__ float remote[kMaxCluster][kMaxK][3];
  __shared__ float stat[kMaxK][2];  // the band's mean and rstd
  __shared__ __align__(8) uint64_t bar[kMaxBoxes];

  const int t = threadIdx.x;
  const Band d = Band::make<VEC>(k, cg);
  const uint32_t n = gridDim.x;
  const uint32_t rank = n > 1 ? cluster_ctarank() : 0;
  const int c0 = int(blockIdx.y % bands) * d.kc, b = int(blockIdx.y / bands);
  const int r0 = int(rank) * rows_per_cta;
  const int rows = min(rows_per_cta, S - r0);
  const int boxes = (rows + box_rows - 1) / box_rows;
  GN_STAMP(0);

  if (t == 0) {
    tma_prefetch(&xmap);
    tma_prefetch(&ymap);
    for (int j = 0; j < boxes; ++j) mbar_init(&bar[j], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (t == 0) {
    const uint32_t box_bytes = uint32_t(box_rows) * d.kc * sizeof(T);
    for (int j = 0; j < boxes; ++j) {
      mbar_arrive_expect_tx(&bar[j], box_bytes);
      tma_load_3d(tile + size_t(j) * box_rows * d.kc, &xmap, &bar[j], c0, r0 + j * box_rows, b);
    }
  }
  int grp[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) grp[i] = (d.v * VEC + i) / cg;
  T* my = tile + d.v * VEC;
  const float count = float(rows) * float(cg);

  // the slice's group means, box by box as the boxes arrive
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  int r = d.rf;
  for (int j = 0; j < boxes; ++j) {
    mbar_wait(&bar[j], 0);
    if (j == 0) GN_STAMP(1);
    if (!d.active) continue;
    const int end = min(rows, (j + 1) * box_rows);
    for (; r < end; r += d.rs) {
      float x[VEC];
      load_vec<T, VEC, false>(my + size_t(r) * d.kc, x);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += x[i];
    }
  }
  GN_STAMP(2);
  band_group_sums<VEC>(d, acc, k, cg, red, chan, gsum);
  GN_STAMP(3);
  float mean[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mean[i] = gsum[grp[i]] / count;
    acc[i] = 0.f;
  }
  if (t < k) {
    part[t][0] = count;
    part[t][1] = gsum[t] / count;
  }

  // the squared deviations from them
  if (d.active) {
    for (r = d.rf; r < rows; r += d.rs) {
      float x[VEC];
      load_vec<T, VEC, false>(my + size_t(r) * d.kc, x);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float dv = x[i] - mean[i];
        acc[i] = fmaf(dv, dv, acc[i]);
      }
    }
  }
  band_group_sums<VEC>(d, acc, k, cg, red, chan, gsum);
  GN_STAMP(4);
  if (t < k) part[t][2] = gsum[t];

  // every CTA merges the cluster's partials in rank order: the same bits.
  // Thread e fetches value e % 3 of group (e / 3) % k of CTA e / (3 k).
  if (n > 1) {
    cluster_arrive();
    cluster_wait();
    for (int e = t; e < int(n) * k * 3; e += kThreads) {
      const int q = e / (3 * k), j = (e / 3) % k, f = e % 3;
      remote[q][j][f] = ld_dsmem_f32(smem_u32(&part[j][f]), uint32_t(q));
    }
    cluster_arrive();  // this CTA has read the others' partials
  } else if (t < k * 3) {
    remote[0][t / 3][t % 3] = part[t / 3][t % 3];
  }
  __syncthreads();
  if (t < k) {
    Moments m{0.f, 0.f, 0.f};
    for (uint32_t q = 0; q < n; ++q)
      m = merge(m, Moments{remote[q][t][0], remote[q][t][1], remote[q][t][2]});
    stat[t][0] = m.mean;
    stat[t][1] = rstd_of(m, eps);
  }
  __syncthreads();
  GN_STAMP(5);

  float a[VEC], sh[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = c0 + d.v * VEC + i;
    mean[i] = stat[grp[i]][0];
    a[i] = __ldg(scale + c) * stat[grp[i]][1];
    sh[i] = __ldg(bias + c);
  }
  r = d.rf;
  for (int j = 0; j < boxes; ++j) {
    const int end = min(rows, (j + 1) * box_rows);
    if (d.active) {
      for (; r < end; r += d.rs) {
        float x[VEC];
        T yv[VEC];
        load_vec<T, VEC, false>(my + size_t(r) * d.kc, x);
        affine<T, VEC, kSiLU>(x, mean, a, sh, yv);
        store_vec<T, VEC>(my + size_t(r) * d.kc, yv);
      }
    }
    fence_proxy_async_shared();
    __syncthreads();
    // rows past S are not stored
    if (t == 0) {
      tma_store_3d(&ymap, tile + size_t(j) * box_rows * d.kc, c0, r0 + j * box_rows, b);
      tma_store_commit();
    }
  }
  GN_STAMP(6);
  if (t == 0) tma_store_wait_read<0>();
  if (n > 1) cluster_wait();  // no CTA leaves while another may still read its partials
  GN_STAMP(7);
}

// ---- two-pass route ---------------------------------------------------------------------------

// Pass 1, grid (chunks, groups / k, B): the (count, mean, M2) of each of the
// band's k groups over rows [chunk * chunk_rows, ...) of row blockIdx.z.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_partials_kernel(const T* __restrict__ x, float* __restrict__ partials, int S, int C,
                   int groups, int cg, int k, int chunk_rows) {
  __shared__ float red_n[kThreads];
  __shared__ float red_mean[kThreads * VEC];
  __shared__ float red_m2[kThreads * VEC];
  __shared__ Moments chan[kThreads * VEC];

  const int t = threadIdx.x;
  const Band d = Band::make<VEC>(k, cg);
  const int chunks = gridDim.x, chunk = blockIdx.x;
  const int c0 = blockIdx.y * d.kc;
  const int64_t b = blockIdx.z;
  const int s0 = chunk * chunk_rows, s1 = min(S, s0 + chunk_rows);
  const T* base = x + b * S * C + c0 + d.v * VEC;

  // per element: Welford's update, one reciprocal a row
  float n = 0.f, mean[VEC], m2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) mean[i] = m2[i] = 0.f;
  if (d.active) {
#pragma unroll 4
    for (int r = s0 + d.rf; r < s1; r += d.rs) {
      float v[VEC];
      load_vec<T, VEC, true>(base + int64_t(r) * C, v);
      n += 1.f;
      const float rn = __frcp_rn(n);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float dv = v[i] - mean[i];
        mean[i] = fmaf(dv, rn, mean[i]);
        m2[i] = fmaf(dv, v[i] - mean[i], m2[i]);
      }
    }
    red_n[t] = n;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      red_mean[t * VEC + i] = mean[i];
      red_m2[t * VEC + i] = m2[i];
    }
  }
  __syncthreads();
  // channel c (vector column c / VEC) over the rows of the sweep, in order
  for (int c = t; c < d.kc; c += kThreads) {
    Moments m{0.f, 0.f, 0.f};
    for (int q = 0; q < d.rs; ++q)
      m = merge(m, Moments{red_n[q * d.vw + c / VEC], red_mean[q * d.kc + c],
                           red_m2[q * d.kc + c]});
    chan[c] = m;
  }
  __syncthreads();
  for (int j = t; j < k; j += kThreads) {
    Moments m{0.f, 0.f, 0.f};
    for (int c = 0; c < cg; ++c) m = merge(m, chan[j * cg + c]);
    float* p = partials + ((b * groups + blockIdx.y * k + j) * chunks + chunk) * 3;
    p[0] = m.n;
    p[1] = m.mean;
    p[2] = m.m2;
  }
}

// Between the passes, a warp per (row, group), B * groups of them: the
// group's chunk partials merged (lane l takes chunks l, l + 32, ..., then the
// lanes in a fixed tree) into its mean and rstd, stats[(b * groups + g) * 2].
__global__ void __launch_bounds__(kThreads)
gn_finalize_kernel(const float* __restrict__ partials, float* __restrict__ stats, int n_groups,
                   int chunks, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t g = int64_t(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (g >= n_groups) return;
  const float* p = partials + g * chunks * 3;
  Moments m{0.f, 0.f, 0.f};
  for (int q = lane; q < chunks; q += 32)
    m = merge(m, Moments{p[3 * q], p[3 * q + 1], p[3 * q + 2]});
  m = warp_merge(m);
  if (lane == 0) {
    stats[2 * g] = m.mean;
    stats[2 * g + 1] = rstd_of(m, eps);
  }
}

// Pass 2, the same grid as pass 1: normalise the chunk with the band's
// groups' mean and rstd.
template <typename T, int VEC, bool kSiLU>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias, const float* __restrict__ stats,
                T* __restrict__ y, int S, int C, int groups, int cg, int k, int chunk_rows) {
  const Band d = Band::make<VEC>(k, cg);
  if (!d.active) return;
  const int chunk = blockIdx.x;
  const int c0 = blockIdx.y * d.kc;
  const int64_t b = blockIdx.z;
  const float* st = stats + (b * groups + blockIdx.y * k) * 2;
  float mean[VEC], a[VEC], sh[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int cl = d.v * VEC + i, j = cl / cg;
    mean[i] = __ldg(st + 2 * j);
    a[i] = __ldg(scale + c0 + cl) * __ldg(st + 2 * j + 1);
    sh[i] = __ldg(bias + c0 + cl);
  }
  const int s0 = chunk * chunk_rows, s1 = min(S, s0 + chunk_rows);
  const int64_t off = b * S * C + c0 + d.v * VEC;
#pragma unroll 4
  for (int r = s0 + d.rf; r < s1; r += d.rs) {
    float v[VEC];
    T o[VEC];
    load_vec<T, VEC, true>(x + off + int64_t(r) * C, v);
    affine<T, VEC, kSiLU>(v, mean, a, sh, o);
    store_vec<T, VEC>(y + off + int64_t(r) * C, o);
  }
}

// ---- host ------------------------------------------------------------------------------------

struct Args {
  const void* x;
  const float* scale;
  const float* bias;
  void* y;
  float* partials;
  int B, S, C, groups, k, n, rows, box_rows;
  float eps;
};

template <typename T, bool kSiLU>
int launch_cluster(const Args& a, cudaStream_t stream) {
  auto kern = gn_cluster_kernel<T, kSiLU>;
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxSliceBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  if (attr != cudaSuccess) return int(attr);
  const int kc = a.k * (a.C / a.groups), bands = a.groups / a.k;
  CUtensorMap xmap, ymap;
  const uint64_t dims[3] = {uint64_t(a.C), uint64_t(a.S), uint64_t(a.B)};
  const int64_t strides[2] = {int64_t(a.C), int64_t(a.S) * a.C};
  const uint32_t box[3] = {uint32_t(kc), uint32_t(a.box_rows), 1};
  int rc = encode_3d<T>(&xmap, a.x, dims, strides, box);
  if (rc == 0) rc = encode_3d<T>(&ymap, a.y, dims, strides, box);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(a.n), unsigned(bands * a.B), 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = size_t(a.rows) * kc * sizeof(T);
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = unsigned(a.n);
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = a.n > 1 ? 1 : 0;  // one CTA a band: no cluster
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, xmap, ymap, a.scale, a.bias, a.S,
                                           a.C / a.groups, a.k, bands, a.rows, a.box_rows,
                                           a.eps);
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

template <typename T, int VEC, bool kSiLU>
int launch_two_pass(const Args& a, cudaStream_t stream) {
  const dim3 grid(unsigned(a.n), unsigned(a.groups / a.k), unsigned(a.B));
  const int cg = a.C / a.groups;
  const int n_groups = a.B * a.groups;
  float* stats = a.partials + int64_t(n_groups) * a.n * 3;
  gn_partials_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.x), a.partials, a.S, a.C, a.groups, cg, a.k, a.rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  gn_finalize_kernel<<<(n_groups + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      a.partials, stats, n_groups, a.n, a.eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  gn_apply_kernel<T, VEC, kSiLU><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.x), a.scale, a.bias, stats, static_cast<T*>(a.y), a.S, a.C,
      a.groups, cg, a.k, a.rows);
  return int(cudaGetLastError());
}

template <typename T, bool kSiLU>
int dispatch_route(const Args& a, int route, int vector, cudaStream_t s) {
  if (route == kRouteCluster) return launch_cluster<T, kSiLU>(a, s);
  if (vector) return launch_two_pass<T, int(16 / sizeof(T)), kSiLU>(a, s);
  return launch_two_pass<T, 1, kSiLU>(a, s);
}

template <typename T>
int dispatch(const Args& a, int route, int vector, int silu, cudaStream_t s) {
  return silu ? dispatch_route<T, true>(a, route, vector, s)
              : dispatch_route<T, false>(a, route, vector, s);
}

// The plan's arguments that the kernels rely on (nn/kernels/groupnorm.py::gn_plan
// makes them; anything else is refused, not clipped).
bool args_ok(const Args& a, int route, int vector, int itemsize) {
  if (a.B <= 0 || a.S <= 0 || a.C <= 0 || a.groups <= 0 || a.C % a.groups || a.k <= 0 ||
      a.groups % a.k || a.n <= 0 || a.rows <= 0 || a.B > 65535 || a.groups / a.k > 65535)
    return false;
  const int cg = a.C / a.groups, kc = a.k * cg;
  if (route == kRouteCluster) {
    const int vec = 16 / itemsize;
    return a.k <= kMaxK && kc <= kMaxBand && (kc * itemsize) % 16 == 0 &&
           int64_t(a.groups / a.k) * a.B <= 65535 &&
           int64_t(a.rows) * kc * itemsize <= kMaxSliceBytes &&
           (int64_t(a.C) * itemsize) % 16 == 0 && a.box_rows > 0 && a.box_rows <= 256 &&
           a.box_rows % 8 == 0 && a.rows % a.box_rows == 0 && kc / vec <= kThreads &&
           int64_t(a.n - 1) * a.rows < a.S && int64_t(a.n) * a.rows >= a.S &&
           a.n <= kMaxCluster && (a.rows / a.box_rows) <= kMaxBoxes;
  }
  if (route == kRouteTwoPass) {
    const int vec = vector ? 16 / itemsize : 1;
    return kc % vec == 0 && kc / vec <= kThreads && int64_t(a.n - 1) * a.rows < a.S &&
           int64_t(a.n) * a.rows >= a.S && a.n <= 65535 &&
           (!vector || (int64_t(a.C) * itemsize) % 16 == 0);
  }
  return false;
}

}  // namespace

// x, y: [B, S, C] contiguous (channels-last) of `dtype` (0 = bf16, 1 = fp16,
// 2 = fp32), 16-byte aligned on the one-read route and with `vector`; scale,
// bias: [C] fp32. route 0 (one read): clusters of n CTAs, each holding
// `rows` rows of a band of k groups, loaded in boxes of box_rows. route 1
// (two passes): n chunks of `rows` rows a block, bands of k groups, 16-byte
// vectors if `vector`; partials: [B, groups, n, 3] + [B, groups, 2] fp32
// scratch (the chunks' moments, then each group's mean and rstd). Returns 0,
// the CUDA error of a launch (> 0; a refused cluster launch among them), -1
// for arguments it does not take, or a tensor-map error (hopper_common.cuh).
extern "C" int group_norm_silu(const void* x, const void* scale, const void* bias, void* y,
                               void* partials, int B, int S, int C, int groups, int route,
                               int k, int n, int rows, int box_rows, int vector, float eps,
                               int silu, int dtype, void* stream) {
  const Args a{x, static_cast<const float*>(scale), static_cast<const float*>(bias), y,
               static_cast<float*>(partials), B, S, C, groups, k, n, rows, box_rows, eps};
  const int itemsize = dtype == 2 ? 4 : 2;
  if (dtype < 0 || dtype > 2 || !args_ok(a, route, vector, itemsize)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<__nv_bfloat16>(a, route, vector, silu, s);
  if (dtype == 1) return dispatch<__half>(a, route, vector, silu, s);
  return dispatch<float>(a, route, vector, silu, s);
}

#ifdef GN_PHASE_TIMES
// The phase stamps of the one-read CTAs since the last reset: `ctas` CTAs
// (the first ones of the grid's x-fastest order), 8 each, 0 where none.
extern "C" int group_norm_silu_phase_times(unsigned long long* out, int ctas) {
  return int(cudaMemcpyFromSymbol(out, g_phase_ns, size_t(ctas) * 8 * 8));
}

extern "C" int group_norm_silu_phase_reset() {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, g_phase_ns);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(g_phase_ns));
  return int(e);
}
#endif
