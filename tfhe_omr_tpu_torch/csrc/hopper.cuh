// Hopper's asynchronous matrix path, with stand-ins for the host build:
// TMA tile loads that complete on an mbarrier, warpgroup int8 products
// (wgmma m64nNk32 .s32.s8.s8) that read both operands from shared memory
// through descriptors, and TMA tile stores and reduce-adds.
//
// Layout: an operand tile is R rows x 128 bytes of k ("a k atom"), K-major
// (the only major order wgmma takes for 8-bit types), in TMA's 128-byte
// swizzle: the 16-byte chunk c of row r lies at chunk c ^ (r % 8) of that
// row (swz128). A tile starts on 1024 bytes, so a descriptor with the
// 128-byte swizzle and an 8-row stride of 1024 bytes reads it, and a k step
// of 32 bytes is 32 bytes added to the start address.
//
// The host build (g++, csrc/host/cuda_runtime.h) keeps the call sites and
// replaces the hardware: a TMA load copies the box into the same swizzled
// offsets (zero where it lies beyond the tensor), an mbarrier wait is a
// block barrier, and a wgmma is each thread's own share of the product, by
// the accumulator fragment layout of the PTX ISA. So the host build checks
// the tiling, the swizzle, the masks and the accumulator-to-C mapping; only
// a card checks the descriptors and the tensor maps themselves. A tile of
// int32 words leaves shared memory in the same swizzle, 32 words a row.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#ifdef __CUDACC__
#include <cuda.h>
#endif

// The byte offset of (row, k byte) in a 128-byte swizzled K-major tile.
static __host__ __device__ __forceinline__ int swz128(int row, int kbyte) {
  return row * 128 + ((((kbyte >> 4) ^ row) & 7) << 4) + (kbyte & 15);
}

#ifdef __CUDACC__
typedef CUtensorMap TmaMap;

static __device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the first byte at or after p whose shared-window offset is a multiple of 1024
static __device__ __forceinline__ unsigned char* smem_align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// ------------------------------------------------------------ mbarrier
static __device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// after the inits, before any other thread or the TMA unit uses them
static __device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
static __device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// every thread that reads what the barrier guards waits on it
static __device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------ TMA
// One box of a 3-D int8 tensor (d0 contiguous) into shared memory; its
// bytes count against the barrier's expected transaction.
static __device__ __forceinline__ void tma_load_3d(void* dst, const TmaMap* map, uint64_t* bar,
                                                   int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

typedef CUresult (*TmaEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime's entry-point query:
// the library links no -lcuda.
static TmaEncodeTiled tma_encoder() {
  static TmaEncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                            cudaEnableDefault, &found);
#else
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<TmaEncodeTiled>(p);
  }
  return fn;
}

// The map of a 3-D tensor (d2, d1, d0) of int8 (elem 1) or int32 (elem 4)
// words, d0 contiguous in rows of a multiple of 16 bytes, cut into boxes of
// box0 x box1 x 1 laid out in the 128-byte swizzle (box0 x elem = 128
// bytes). A load reads zero beyond the tensor; a store or reduce-add
// writes nothing there.
static int tma_map_3d(TmaMap* map, const void* base, int elem, uint64_t d0, uint64_t d1,
                      uint64_t d2, unsigned box0, unsigned box1) {
  const TmaEncodeTiled encode = tma_encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * elem, d0 * d1 * elem};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult rc = encode(
      map, elem == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_INT32, 3,
      const_cast<void*>(base), dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// After the threads' shared-memory writes and before a barrier and the TMA
// store that reads them.
static __device__ __forceinline__ void tma_store_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// One box from shared memory into the tensor (`add`: added to it, each
// word atomically, wrapping).
static __device__ __forceinline__ void tma_store_3d(const TmaMap* map, const void* src, bool add,
                                                    int c0, int c1, int c2) {
  if (add)
    asm volatile(
        "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.tile.bulk_group "
        "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.tile.bulk_group "
        "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}
// The thread's stores so far have read their shared memory.
static __device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ------------------------------------------------------------ wgmma
// A K-major operand in shared memory: its descriptor (start address >> 4,
// 8-row stride 1024 bytes, 128-byte swizzle).
typedef uint64_t KOperand;
static __device__ __forceinline__ KOperand k_operand(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}
// the same operand `bytes` further along k (within the 128-byte atom)
static __device__ __forceinline__ KOperand k_advance(KOperand d, int bytes) {
  return d + (uint64_t)(bytes >> 4);
}

static __device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
static __device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
static __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}
// keeps the compiler from moving accumulator reads across a wait
template <int R>
static __device__ __forceinline__ void wgmma_fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define OMR_D8(i)                                                                           \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])
#define OMR_D32(i) OMR_D8(i), OMR_D8(i + 8), OMR_D8(i + 16), OMR_D8(i + 24)
#define OMR_R0_31                                                 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "  \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, " \
  "%26, %27, %28, %29, %30, %31"
#define OMR_R32_63                                                  \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "   \
  "%56, %57, %58, %59, %60, %61, %62, %63"
#define OMR_R64_127                                                    \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, "      \
  "%76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, "      \
  "%88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "      \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, " \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, " \
  "%122, %123, %124, %125, %126, %127"

// d += A (64 x 32, K-major) x B (N x 32, K-major)^T, int32 sums that wrap
// (no .satfinite), as one warpgroup. d holds the thread's N / 2 accumulators.
template <int N>
static __device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], KOperand a, KOperand b);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], KOperand a, KOperand b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {" OMR_R0_31 "}, %32, %33, p;\n}\n"
      : OMR_D32(0)
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], KOperand a, KOperand b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" OMR_R0_31 ", " OMR_R32_63
      "}, %64, %65, p;\n}\n"
      : OMR_D32(0), OMR_D32(32)
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], KOperand a, KOperand b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" OMR_R0_31 ", " OMR_R32_63
      ", " OMR_R64_127 "}, %128, %129, p;\n}\n"
      : OMR_D32(0), OMR_D32(32), OMR_D32(64), OMR_D32(96)
      : "l"(a), "l"(b), "r"(1));
}
#undef OMR_D8
#undef OMR_D32
#undef OMR_R0_31
#undef OMR_R32_63
#undef OMR_R64_127

#else  // the host build

// the tensor map: what the stand-ins need to cut a box
struct TmaMap {
  unsigned char* base;
  int elem;
  uint64_t d0, d1, d2;
  unsigned box0, box1;
};

static int tma_map_3d(TmaMap* map, const void* base, int elem, uint64_t d0, uint64_t d1,
                      uint64_t d2, unsigned box0, unsigned box1) {
  if ((d0 * elem) % 16 || box0 * elem != 128 || box1 == 0 || box1 > 256)
    return cudaErrorInvalidValue;
  *map = TmaMap{static_cast<unsigned char*>(const_cast<void*>(base)), elem, d0, d1, d2, box0,
                box1};
  return 0;
}

static inline unsigned char* smem_align1024(unsigned char* p) {
  return p + ((1024 - (reinterpret_cast<uintptr_t>(p) & 1023)) & 1023);
}

static inline void mbar_init(uint64_t*, unsigned) {}
static inline void mbar_fence_init() {}
static inline void mbar_expect_tx(uint64_t*, unsigned) {}
static inline void mbar_wait(uint64_t*, unsigned) { __syncthreads(); }

// the box at (c0, c1, c2) at once, by rows of 128 bytes in the swizzle;
// `visit(global, box)` on each word that lies in the tensor, false beyond it
template <class F>
static inline void tma_box(const TmaMap* map, unsigned char* box, int c0, int c1, int c2,
                           F visit) {
  for (unsigned r = 0; r < map->box1; ++r)
    for (unsigned x = 0; x < map->box0; ++x) {
      const uint64_t gx = (uint64_t)c0 + x, gy = (uint64_t)c1 + r, gz = (uint64_t)c2;
      const bool in = gx < map->d0 && gy < map->d1 && gz < map->d2;
      visit(in ? map->base + ((gz * map->d1 + gy) * map->d0 + gx) * map->elem : nullptr,
            box + swz128(r, x * map->elem));
    }
}
static inline void tma_load_3d(void* dst, const TmaMap* map, uint64_t*, int c0, int c1,
                               int c2) {
  tma_box(map, static_cast<unsigned char*>(dst), c0, c1, c2,
          [&](unsigned char* g, unsigned char* b) {
            g ? memcpy(b, g, map->elem) : memset(b, 0, map->elem);
          });
}
static inline void tma_store_fence() {}
static inline void tma_store_3d(const TmaMap* map, const void* src, bool add, int c0, int c1,
                                int c2) {
  tma_box(map, static_cast<unsigned char*>(const_cast<void*>(src)), c0, c1, c2,
          [&](unsigned char* g, unsigned char* b) {
            if (!g) return;
            unsigned v, w;
            memcpy(&v, b, 4);
            memcpy(&w, g, 4);
            v += add ? w : 0;
            memcpy(g, &v, 4);
          });
}
static inline void tma_store_wait() {}

struct KOperand {
  const signed char* tile;
  int kbyte;
};
static inline KOperand k_operand(const void* tile) {
  return KOperand{static_cast<const signed char*>(tile), 0};
}
static inline KOperand k_advance(KOperand d, int bytes) { return KOperand{d.tile, d.kbyte + bytes}; }

static inline void wgmma_fence() {}
static inline void wgmma_commit() {}
template <int PENDING>
static inline void wgmma_wait() {}
template <int R>
static inline void wgmma_fence_acc(int (&)[R]) {}

// The thread's share of the product, by the PTX ISA's accumulator layout
// for m64nNk32 .s32: warp w of the warpgroup holds rows 16w .. 16w + 15;
// lane l holds, in each 8-column group j, d[4j + i] at row 16w + l / 4 +
// 8 (i / 2), column 8j + 2 (l % 4) + i % 2.
template <int N>
static inline void wgmma_s8(int (&d)[N / 2], KOperand a, KOperand b) {
  const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
  for (int j = 0; j < N / 8; ++j)
    for (int i = 0; i < 4; ++i) {
      const int row = 16 * w + l / 4 + 8 * (i / 2), col = 8 * j + 2 * (l % 4) + i % 2;
      unsigned sum = (unsigned)d[4 * j + i];
      for (int kk = 0; kk < 32; ++kk)
        sum += (unsigned)((int)a.tile[swz128(row, a.kbyte + kk)] *
                          (int)b.tile[swz128(col, b.kbyte + kk)]);
      d[4 * j + i] = (int)sum;
    }
}
#endif
