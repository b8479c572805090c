// Hopper (sm_90a) building blocks shared by the port's TMA / wgmma kernels:
// the skinny-N matmul and the flash-attention forward, dQ and dK/dV.
//
//   - TMA tensor maps (2-D, and 4-D with any strides), encoded on the host by
//     cuTensorMapEncodeTiled, reached from the runtime
//     (cudaGetDriverEntryPoint*), so that the libraries link nothing but the
//     runtime;
//   - the copies: cp.async.bulk.tensor loads (2-D, 4-D) into shared memory,
//     completed on an mbarrier, and stores from shared memory in bulk groups;
//   - the barriers: mbarrier init, arrive, arrive-expect-tx and try-wait on
//     a phase parity (with a watchdog that traps rather than hang the card
//     when a phase never completes, and a plain spin for tight code);
//   - wgmma: shared-memory descriptors for 128-byte-swizzled tiles, the
//     fence / commit / wait, and mma_async m64nNk16 with fp32 accumulators and
//     B either K-major or MN-major (the instruction's transpose bit): A in
//     shared memory (SS; N = 64, 80, 96, 128, 160, 176, 256) or in registers (RS;
//     N = 64, 128);
//   - fence.proxy.async, named barriers and setmaxnreg.
//
// Descriptor conventions (128-byte swizzle, 16-bit elements; a tile's base
// 1024-byte aligned, the swizzle atom being 8 rows of 128 bytes):
//   K-major (A, and B as [N, K]): rows of 64 elements, 8-row groups 1024 bytes
//     apart (SBO = 1024); a k16 step moves the start address 32 bytes along
//     the row, and the hardware applies the swizzle to the computed address;
//   MN-major (B as [K, N]): 64-column chunks, each [rows of K][64 of N],
//     8 K-rows per 1024 bytes (SBO = 1024), chunks LBO bytes apart; a k16
//     step moves the start 16 rows (2048 bytes).
//
// The wgmma accumulator layout (fp32, m64nN): warp w of the warpgroup holds
// rows 16w..16w+15; with g = lane / 4, t = lane % 4, registers 4j + 0, 1 hold
// row g, columns 8j + 2t, 8j + 2t + 1, and registers 4j + 2, 3 row g + 8.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

// ---- host: tensor maps ---------------------------------------------------------------

// Errors returned to the caller besides CUDA's own (positive) codes.
constexpr int kErrNoEncode = -2;        // cuTensorMapEncodeTiled not found
constexpr int kErrEncodeBase = -1000;   // -1000 - CUresult of a failed encode

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

template <typename T>
constexpr CUtensorMapDataType tensor_map_type() {
  return std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                               : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

// A 2-D map of a row-major [rows, cols] matrix of 16-bit elements, `ld`
// elements from one row to the next, read or written in boxes of
// box_rows x box_cols. Elements outside the matrix load as zeros and are not
// stored. Returns 0 or an error above.
template <typename T>
inline int encode_2d(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                     uint64_t ld, uint32_t box_rows, uint32_t box_cols,
                     CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return kErrNoEncode;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * sizeof(T)};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, tensor_map_type<T>(), 2, const_cast<void*>(base), dims, strides,
                        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncodeBase - int(r);
}

// A 4-D map of a tensor of 16-bit elements whose innermost dimension is
// contiguous: dims[0..3] innermost first, strides[0..2] the element strides of
// dims 1..3 (each a multiple of 8 elements: TMA takes strides in multiples of
// 16 bytes), read or written in boxes of box[0..3] elements. The flash
// forward's maps are over (D, H, S, B) of a [B, H, S, D] view with its own
// strides (the projections' [B, S, H, D] memory, read in place), in boxes of
// 64 columns x 1 head x a row tile x 1. Elements outside the tensor load as
// zeros and are not stored: past a ragged sequence's end, and past the head
// dim when the box (64 columns) is wider than it. Returns 0 or an error above.
template <typename T>
inline int encode_4d(CUtensorMap* map, const void* base, const uint64_t (&dims)[4],
                     const int64_t (&strides)[3], const uint32_t (&box)[4],
                     CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return kErrNoEncode;
  const cuuint64_t gdims[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t gstrides[3] = {cuuint64_t(strides[0]) * sizeof(T),
                                  cuuint64_t(strides[1]) * sizeof(T),
                                  cuuint64_t(strides[2]) * sizeof(T)};
  const cuuint32_t gbox[4] = {box[0], box[1], box[2], box[3]};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, tensor_map_type<T>(), 4, const_cast<void*>(base), gdims, gstrides,
                        gbox, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncodeBase - int(r);
}

// ---- device: addresses, barriers, copies ---------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (the TMA unit).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// One arrival that also expects `bytes` of TMA transfers in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. A phase that has
// not completed after kWatchdogNs means a broken protocol: trap, so that the
// launch fails with an error instead of holding the card.
constexpr uint64_t kWatchdogNs = 5000000000ull;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint64_t start = globaltimer_ns();
  while (!mbar_try_wait(addr, parity)) {
    if (globaltimer_ns() - start > kWatchdogNs) __trap();
  }
}

// The same wait without the watchdog, for code whose registers are tight:
// the timer's 64-bit values made ptxas spill a wgmma consumer holding 80
// accumulators a thread. Pair it with a watched wait on the other side of
// the protocol (a producer that traps when its stages never come back).
__device__ __forceinline__ void mbar_spin_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  while (!mbar_try_wait(addr, parity)) {
  }
}

// A watched wait on a 32-bit clock (the low word of the global timer): one
// register of state where mbar_wait keeps two, for consumers whose registers
// are tight. Traps after 2^31 ns (2.1 s); the wrap of the low word every
// 4.3 s cancels in the unsigned difference.
__device__ __forceinline__ void mbar_wait_lo(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  uint32_t start;
  asm volatile("mov.u32 %0, %%globaltimer_lo;\n" : "=r"(start));
  while (!mbar_try_wait(addr, parity)) {
    uint32_t now;
    asm volatile("mov.u32 %0, %%globaltimer_lo;\n" : "=r"(now));
    if (now - start > 0x80000000u) __trap();
  }
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Load the box at (column c0, row c1) of `map` into shared memory at dst;
// its bytes count towards the transactions `bar` expects.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1)
      : "memory");
}

// Store the box at (column c0, row c1) of `map` from shared memory at src.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// Load the box at coordinates (c0, c1, c2, c3) of a 4-D map, innermost first.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Store the box at coordinates (c0, c1, c2, c3) of a 4-D map from src.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most N committed store groups are still reading shared memory.
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// Until at most N committed store groups are incomplete.
template <int N>
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

// Orders this thread's ordinary shared-memory writes before later reads of
// the async proxy (a TMA store of the same bytes).
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// Signals arrival at named barrier `id` without waiting (the other side waits
// with bar.sync on the same id and thread count).
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

// ---- device: wgmma -----------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at shared address `addr`
// (offsets in bytes, stored in 16-byte units).
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t addr, uint32_t lbo,
                                                     uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo & 0x3FFFF) >> 4) << 16) |
         (uint64_t((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma fence or wait.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// The same for 32-bit operand registers (an A fragment read by wgmma from
// registers: kept live and unmoved until the wgmma that reads it is waited for).
template <int R>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i]) :: "memory");
}

#define HOPPER_D8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

#define HOPPER_WGMMA_SS_N64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n" \
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24) \
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransB))

#define HOPPER_WGMMA_SS_N80(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n80k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, " \
      "%38, %39" \
      "}, %40, %41, p, 1, 1, 0, %43;\n}\n" \
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24), HOPPER_D8(32) \
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransB))

#define HOPPER_WGMMA_SS_N96(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n96k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, " \
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47" \
      "}, %48, %49, p, 1, 1, 0, %51;\n}\n" \
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24), HOPPER_D8(32), HOPPER_D8(40) \
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransB))

#define HOPPER_WGMMA_SS_N128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, " \
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n" \
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24), HOPPER_D8(32), HOPPER_D8(40), \
        HOPPER_D8(48), HOPPER_D8(56) \
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransB))

#define HOPPER_WGMMA_SS_N160(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n160k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, " \
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, " \
      "%74, %75, %76, %77, %78, %79" \
      "}, %80, %81, p, 1, 1, 0, %83;\n}\n" \
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24), HOPPER_D8(32), HOPPER_D8(40), \
        HOPPER_D8(48), HOPPER_D8(56), HOPPER_D8(64), HOPPER_D8(72) \
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransB))

#define HOPPER_WGMMA_SS_N176(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %90, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n176k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, " \
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, " \
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87" \
      "}, %88, %89, p, 1, 1, 0, %91;\n}\n" \
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24), HOPPER_D8(32), HOPPER_D8(40), \
        HOPPER_D8(48), HOPPER_D8(56), HOPPER_D8(64), HOPPER_D8(72), HOPPER_D8(80) \
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransB))

#define HOPPER_WGMMA_SS_N256(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, " \
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, " \
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, " \
      "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, " \
      "%123, %124, %125, %126, %127" \
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n" \
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24), HOPPER_D8(32), HOPPER_D8(40), \
        HOPPER_D8(48), HOPPER_D8(56), HOPPER_D8(64), HOPPER_D8(72), HOPPER_D8(80), HOPPER_D8(88), \
        HOPPER_D8(96), HOPPER_D8(104), HOPPER_D8(112), HOPPER_D8(120) \
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransB))

#define HOPPER_WGMMA_RS_N64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n" \
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(kTransB))

#define HOPPER_WGMMA_RS_N128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, " \
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63" \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n" \
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24), HOPPER_D8(32), HOPPER_D8(40), \
        HOPPER_D8(48), HOPPER_D8(56) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(kTransB))

// d (+)= A . B for a 64 x 16 A and a 16 x N B, both in shared memory (descriptors
// a, b); scale_d = 0 overwrites d. kTransB = 1: B is MN-major.
template <typename T, int N, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int scale_d) {
  static_assert(N == 64 || N == 80 || N == 96 || N == 128 || N == 160 || N == 176 || N == 256,
                "wgmma_ss: N is 64, 80, 96, 128, 160, 176 or 256");
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (N == 64) {
    if constexpr (bf16) HOPPER_WGMMA_SS_N64("bf16"); else HOPPER_WGMMA_SS_N64("f16");
  } else if constexpr (N == 80) {
    if constexpr (bf16) HOPPER_WGMMA_SS_N80("bf16"); else HOPPER_WGMMA_SS_N80("f16");
  } else if constexpr (N == 96) {
    if constexpr (bf16) HOPPER_WGMMA_SS_N96("bf16"); else HOPPER_WGMMA_SS_N96("f16");
  } else if constexpr (N == 128) {
    if constexpr (bf16) HOPPER_WGMMA_SS_N128("bf16"); else HOPPER_WGMMA_SS_N128("f16");
  } else if constexpr (N == 160) {
    if constexpr (bf16) HOPPER_WGMMA_SS_N160("bf16"); else HOPPER_WGMMA_SS_N160("f16");
  } else if constexpr (N == 176) {
    if constexpr (bf16) HOPPER_WGMMA_SS_N176("bf16"); else HOPPER_WGMMA_SS_N176("f16");
  } else {
    if constexpr (bf16) HOPPER_WGMMA_SS_N256("bf16"); else HOPPER_WGMMA_SS_N256("f16");
  }
}

// d (+)= A . B with A (64 x 16) from registers: four 32-bit registers a thread
// holding pairs of T in the mma.sync m16n8k16 A-fragment layout, warp w
// supplying rows 16w..16w+15 (the layout of a 16-column slice of an fp32
// accumulator rounded to pairs); B (16 x N) in shared memory (descriptor b).
template <typename T, int N, int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (N == 64) {
    if constexpr (bf16) HOPPER_WGMMA_RS_N64("bf16"); else HOPPER_WGMMA_RS_N64("f16");
  } else {
    if constexpr (bf16) HOPPER_WGMMA_RS_N128("bf16"); else HOPPER_WGMMA_RS_N128("f16");
  }
}

#undef HOPPER_WGMMA_SS_N64
#undef HOPPER_WGMMA_SS_N80
#undef HOPPER_WGMMA_SS_N96
#undef HOPPER_WGMMA_SS_N128
#undef HOPPER_WGMMA_SS_N160
#undef HOPPER_WGMMA_SS_N176
#undef HOPPER_WGMMA_SS_N256
#undef HOPPER_WGMMA_RS_N64
#undef HOPPER_WGMMA_RS_N128
#undef HOPPER_D8

// ---- device: pieces of the flash-attention kernels (forward, dQ, dK/dV) ---------------

// Bytes of one 128-byte-swizzled row: 64 16-bit columns. A tile of R rows and
// DP columns lies in shared memory as DP / 64 chunks of R rows x kSwRow bytes.
constexpr int kSwRow = 128;

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

// acc (64 x N) = A . B^T over DP columns, A and B both K-major tiles of DP
// columns (A's chunks A_ROWS rows apart, B's B_ROWS; a and b the addresses of
// A's and B's first row): DP / 16 k-steps, each 32 bytes along the swizzled
// rows of a 64-column chunk. S = Q K^T in the forward and dQ, S^T = K Q^T in dK/dV.
template <typename T, int DP, int N, int A_ROWS, int B_ROWS>
__device__ __forceinline__ void wgmma_ss_rows(float (&acc)[N / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int c = kk / 4, off = (kk % 4) * 32;
    const uint64_t da = wgmma_desc_sw128(a + c * A_ROWS * kSwRow + off, 16, 1024);
    const uint64_t db = wgmma_desc_sw128(b + c * B_ROWS * kSwRow + off, 16, 1024);
    wgmma_ss<T, N, 0>(acc, da, db, kk != 0);
  }
}

// acc (64 x N) += A . B: A (64 x K) from registers in K / 16 k-steps, B a
// [K rows][N columns] tile read MN-major, its 64-column chunks B_ROWS rows
// apart; a k-step moves 16 rows (2048 bytes). O += P V in the forward,
// dQ += dS K, dV += P^T dO and dK += dS^T Q in the backward.
template <typename T, int N, int K, int B_ROWS>
__device__ __forceinline__ void wgmma_rs_cols(float (&acc)[N / 2], const uint32_t (&a)[K / 16][4],
                                              uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t db = wgmma_desc_sw128(b + kk * 16 * kSwRow, B_ROWS * kSwRow, 1024);
    wgmma_rs<T, N, 1>(acc, a[kk], db, 1);
  }
}

// An accumulator (64 x N) rounded to T in the A-fragment layout of wgmma_rs:
// k-step kk takes accumulator columns 16kk..16kk+15, i.e. registers 8kk..8kk+7.
template <typename T, int N>
__device__ __forceinline__ void pack_rows(uint32_t (&a)[N / 16][4], const float (&acc)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = round_pair<T>(acc[8 * kk + 2 * i], acc[8 * kk + 2 * i + 1]);
}

// A fragments stay live and in place until the wgmma reading them is waited for.
template <int K>
__device__ __forceinline__ void fence_rows(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) fence_operands(a[kk]);
}

// An accumulator (64 x DP, this warpgroup's rows) scaled, rounded to T and
// written into a 128-byte-swizzled staging tile for a TMA store: `stage` is
// the warpgroup's first row, its chunks CHUNK_ROWS rows apart; the 16-byte
// unit u of row r lands at u ^ (r % 8). With warp w, g = lane / 4, t = lane % 4.
template <typename T, int DP, int CHUNK_ROWS>
__device__ __forceinline__ void stage_rows(unsigned char* stage, const float (&acc)[DP / 2],
                                           const float (&mul)[2], int warp, int g, int t) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = warp * 16 + g + 8 * hh;
      const int off =
          (j / 8) * CHUNK_ROWS * kSwRow + r * kSwRow + (((j % 8) ^ (r & 7)) << 4) + t * 4;
      *reinterpret_cast<uint32_t*>(stage + off) =
          round_pair<T>(acc[4 * j + 2 * hh] * mul[hh], acc[4 * j + 2 * hh + 1] * mul[hh]);
    }
  }
}

// Ping-pong between consumer warpgroups (PP): a warpgroup issues a block of
// wgmma between taking its turn (bar.sync on its own named barrier) and
// passing it (bar.arrive on the next warpgroup's), 256 threads a barrier (the
// waiting warpgroup and the arriving one), so that the warpgroups' products
// reach the tensor cores in turns while the others compute between them.
template <bool PP>
__device__ __forceinline__ void turn_take(int id) {
  if constexpr (PP) named_bar_sync(id, 256);
}
template <bool PP>
__device__ __forceinline__ void turn_pass(int id) {
  if constexpr (PP) named_bar_arrive(id, 256);
}

// The next stage of a ring of ST, flipping the phase parity on the wrap.
template <int ST>
__device__ __forceinline__ void advance(int& stage, uint32_t& phase) {
  if (++stage == ST) { stage = 0; phase ^= 1; }
}

// The SM count of the current device (the size of a persistent grid).
inline int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return counts[dev];
}

}  // namespace hopper
