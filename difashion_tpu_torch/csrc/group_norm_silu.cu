// GroupNorm (+ SiLU) for Hopper (sm_90a): bf16 / fp16 / fp32 in and out, fp32
// statistics.
//
// Replaces: difashion_tpu/nn/pallas/groupnorm.py::_gn_silu_kernel (reached through
// _pallas_gn_silu and the _gn_silu custom VJP), the TPU kernel for every
// GroupNorm of the UNet's ResnetBlocks, its Transformer2D input norms and
// conv_norm_out; here it also takes every GroupNorm of the VAE.
//
// What it computes: x is contiguous [B, C, *spatial] (NCHW), so each
// (batch, group) is one contiguous span of L = (C / G) * HW elements. Group
// mean and biased variance in fp32; then y = x * a + b with a = scale[c] * rstd
// and b = bias[c] - mean * a in fp32, rounded to the input type; then, with
// SiLU, silu(y) computed in fp32 from the rounded y and rounded again (the
// order of `_gn_silu_ref`, not the Pallas kernel's, which applies SiLU before
// rounding).
//
// What bounds it on the H100: bytes. A group norm does about ten operations
// per element against 4 (bf16) or 8 (fp32) bytes read and written, far below
// the card's ~295 operations per byte. The least it can take is one read of x
// and one write of y at 3.35 TB/s. This kernel reads x twice (the statistics
// pass, then the apply pass; for most UNet shapes the second read finds x in
// the 50 MB L2).
//
// What the design does about it: a span can be far larger than a block's
// shared memory (the UNet's 64x64 up-level norm over 960 channels is 122,880
// elements; the VAE's 512x512 levels are 1,048,576), so no block holds a group.
// Each group is split into chunks of whole tiles over several blocks (grid
// (B*G, chunks), chosen by the caller so that small batches still fill the 132
// SMs). Pass 1 writes one (count, mean, M2) partial per chunk; pass 2 merges
// its group's partials and writes y. Every thread reads 16-byte vectors
// (scalars where HW is not a multiple of the vector width or x is not 16-byte
// aligned). Statistics are exact two-pass sums over each thread's registers,
// merged across threads, warps and chunks with Chan's formula in a fixed order:
// no E[x^2] - E[x]^2 cancellation when |mean| >> std, no atomics, the same
// result on every run. Offsets into x are 64-bit (the VAE encoder's first level
// at batch 64 holds 2^31 elements). Thread-block clusters that keep a group in
// distributed shared memory (one read of x) are later work.
//
// Interface: plain C (loaded with ctypes). The caller allocates y and the
// partials ([B*G, chunks, 3] fp32) and counts one launch per call.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecBytes = 16;
constexpr int kVecsPerThread = 2;  // 16-byte vectors per thread per tile

template <typename T>
struct Tile {
  static constexpr int kVec = kVecBytes / sizeof(T);       // elements per vector
  static constexpr int kPerThread = kVecsPerThread * kVec;  // elements per thread
  static constexpr int kElems = kThreads * kPerThread;      // elements per tile
};

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

// The moments of the whole block, valid in thread 0.
__device__ __forceinline__ Moments block_merge(Moments m) {
  __shared__ Moments warp_m[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  m = warp_merge(m);
  if (lane == 0) warp_m[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? warp_m[lane] : Moments{0.f, 0.f, 0.f};
    m = warp_merge(m);
  }
  return m;
}

// One thread's elements of the tile starting at span offset `t0`, as floats,
// with each element's span offset. Vector mode: vector j of thread t covers
// elements t0 + (j * kThreads + t) * kVec + [0, kVec). Scalar mode: element e
// of thread t is t0 + e * kThreads + t. Neighbouring threads read neighbouring
// addresses either way. Elements at or past `end` are not read.
template <typename T, bool kVector>
__device__ __forceinline__ void load_tile(const T* __restrict__ span, uint32_t t0,
                                          uint32_t end, float (&v)[Tile<T>::kPerThread],
                                          uint32_t (&off)[Tile<T>::kPerThread]) {
  constexpr int kVec = Tile<T>::kVec;
  if constexpr (kVector) {
#pragma unroll
    for (int j = 0; j < kVecsPerThread; ++j) {
      const uint32_t o = t0 + (j * kThreads + threadIdx.x) * kVec;
      const uint4 u = o < end ? __ldg(reinterpret_cast<const uint4*>(span + o))
                              : make_uint4(0u, 0u, 0u, 0u);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        v[j * kVec + i] = to_float(e[i]);
        off[j * kVec + i] = o + i;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < Tile<T>::kPerThread; ++e) {
      const uint32_t o = t0 + e * kThreads + threadIdx.x;
      v[e] = o < end ? to_float(span[o]) : 0.f;
      off[e] = o;
    }
  }
}

// The span [start, end) of chunk `chunk` of a group of L elements.
template <typename T>
__device__ __forceinline__ void chunk_range(uint32_t L, int tiles_per_chunk, int chunk,
                                            uint32_t& start, uint32_t& end) {
  const uint64_t s = uint64_t(chunk) * tiles_per_chunk * Tile<T>::kElems;
  const uint64_t e = s + uint64_t(tiles_per_chunk) * Tile<T>::kElems;
  start = uint32_t(s < L ? s : L);
  end = uint32_t(e < L ? e : L);
}

// Pass 1: the (count, mean, M2) of chunk blockIdx.y of group blockIdx.x.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partials, uint32_t L,
                int tiles_per_chunk, int chunks) {
  constexpr int kPer = Tile<T>::kPerThread;
  const int64_t group = blockIdx.x;
  const T* span = x + group * int64_t(L);
  uint32_t start, end;
  chunk_range<T>(L, tiles_per_chunk, blockIdx.y, start, end);
  Moments m{0.f, 0.f, 0.f};
  for (uint32_t t0 = start; t0 < end; t0 += Tile<T>::kElems) {
    float v[kPer];
    uint32_t off[kPer];
    load_tile<T, kVector>(span, t0, end, v, off);
    float sum = 0.f, cnt = 0.f;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (off[e] < end) {
        sum += v[e];
        cnt += 1.f;
      }
    }
    if (cnt > 0.f) {
      const float mean = sum / cnt;
      float m2 = 0.f;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const float d = off[e] < end ? v[e] - mean : 0.f;
        m2 = fmaf(d, d, m2);
      }
      m = merge(m, Moments{cnt, mean, m2});
    }
  }
  m = block_merge(m);
  if (threadIdx.x == 0) {
    float* p = partials + (group * chunks + blockIdx.y) * 3;
    p[0] = m.n;
    p[1] = m.mean;
    p[2] = m.m2;
  }
}

// Pass 2: merge group blockIdx.x's partials, then normalise chunk blockIdx.y.
template <typename T, bool kVector, bool kSiLU>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias, const float* __restrict__ partials,
                T* __restrict__ y, uint32_t L, uint32_t hw, int cg, int groups,
                int tiles_per_chunk, int chunks, float eps) {
  constexpr int kPer = Tile<T>::kPerThread;
  constexpr int kVec = Tile<T>::kVec;
  __shared__ float s_mean, s_rstd;
  const int64_t group = blockIdx.x;
  if (threadIdx.x < 32) {
    // lane l merges chunks l, l + 32, ... in order, then the lanes merge
    Moments m{0.f, 0.f, 0.f};
    const float* p = partials + group * chunks * 3;
    for (int j = threadIdx.x; j < chunks; j += 32)
      m = merge(m, Moments{p[3 * j], p[3 * j + 1], p[3 * j + 2]});
    m = warp_merge(m);
    if (threadIdx.x == 0) {
      s_mean = m.mean;
      s_rstd = 1.f / sqrtf(m.m2 / m.n + eps);  // biased variance
    }
  }
  __syncthreads();
  const float mean = s_mean, rstd = s_rstd;
  const int c0 = int(group % groups) * cg;
  const T* span = x + group * int64_t(L);
  T* out = y + group * int64_t(L);
  uint32_t start, end;
  chunk_range<T>(L, tiles_per_chunk, blockIdx.y, start, end);
  for (uint32_t t0 = start; t0 < end; t0 += Tile<T>::kElems) {
    float v[kPer];
    uint32_t off[kPer];
    load_tile<T, kVector>(span, t0, end, v, off);
    T r[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      // a vector never straddles two channels (HW is a multiple of kVec), so
      // its first element's offset gives the channel of all of it
      const uint32_t o = kVector ? off[e - e % kVec] : off[e];
      const bool valid = o < end;
      const int c = c0 + int(o / hw);
      const float a = valid ? __ldg(scale + c) * rstd : 0.f;
      const float b = valid ? __ldg(bias + c) - mean * a : 0.f;
      T t = from_float<T>(fmaf(v[e], a, b));
      if constexpr (kSiLU) {
        const float z = to_float(t);
        t = from_float<T>(z / (1.f + expf(-z)));
      }
      r[e] = t;
    }
    if constexpr (kVector) {
#pragma unroll
      for (int j = 0; j < kVecsPerThread; ++j) {
        const uint32_t o = off[j * kVec];
        if (o < end) {
          uint4 u;
          T* e = reinterpret_cast<T*>(&u);
#pragma unroll
          for (int i = 0; i < kVec; ++i) e[i] = r[j * kVec + i];
          *reinterpret_cast<uint4*>(out + o) = u;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        if (off[e] < end) out[off[e]] = r[e];
    }
  }
}

template <typename T, bool kVector, bool kSiLU>
int launch(const void* x, const float* scale, const float* bias, void* y, float* partials,
           int64_t n_groups, uint32_t L, uint32_t hw, int cg, int groups, int chunks,
           int tiles_per_chunk, float eps, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(n_groups), static_cast<unsigned>(chunks));
  gn_stats_kernel<T, kVector><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), partials, L, tiles_per_chunk, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  gn_apply_kernel<T, kVector, kSiLU><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, partials, static_cast<T*>(y), L, hw, cg,
      groups, tiles_per_chunk, chunks, eps);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const float* scale, const float* bias, void* y,
             float* partials, int64_t n_groups, uint32_t L, uint32_t hw, int cg,
             int groups, int chunks, int tiles_per_chunk, float eps, int silu, int vector,
             cudaStream_t s) {
  if (vector)
    return silu ? launch<T, true, true>(x, scale, bias, y, partials, n_groups, L, hw, cg,
                                        groups, chunks, tiles_per_chunk, eps, s)
                : launch<T, true, false>(x, scale, bias, y, partials, n_groups, L, hw, cg,
                                         groups, chunks, tiles_per_chunk, eps, s);
  return silu ? launch<T, false, true>(x, scale, bias, y, partials, n_groups, L, hw, cg,
                                       groups, chunks, tiles_per_chunk, eps, s)
              : launch<T, false, false>(x, scale, bias, y, partials, n_groups, L, hw, cg,
                                        groups, chunks, tiles_per_chunk, eps, s);
}

}  // namespace

// x, y: contiguous [B, C, HW] of `dtype` (0 = bf16, 1 = fp16, 2 = fp32);
// scale, bias: [C] fp32; partials: [B * groups, chunks, 3] fp32 scratch.
// L = (C / groups) * HW < 2^32. `vector`: HW is a multiple of 16 / sizeof(dtype)
// and x, y are 16-byte aligned. Chunk k of a group covers tiles
// [k * tiles_per_chunk, (k + 1) * tiles_per_chunk) of 256 * 2 * 16 bytes; every
// chunk must hold at least one element. Returns the CUDA error of the launches.
extern "C" int group_norm_silu(const void* x, const void* scale, const void* bias, void* y,
                               void* partials, long long n_groups, long long L,
                               long long hw, int cg, int groups, int chunks,
                               int tiles_per_chunk, float eps, int silu, int dtype,
                               int vector, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* p = static_cast<float*>(partials);
  if (dtype == 0)
    return dispatch<__nv_bfloat16>(x, sc, bi, y, p, n_groups, uint32_t(L), uint32_t(hw), cg,
                                   groups, chunks, tiles_per_chunk, eps, silu, vector, s);
  if (dtype == 1)
    return dispatch<__half>(x, sc, bi, y, p, n_groups, uint32_t(L), uint32_t(hw), cg, groups,
                            chunks, tiles_per_chunk, eps, silu, vector, s);
  if (dtype == 2)
    return dispatch<float>(x, sc, bi, y, p, n_groups, uint32_t(L), uint32_t(hw), cg, groups,
                           chunks, tiles_per_chunk, eps, silu, vector, s);
  return -1;
}
