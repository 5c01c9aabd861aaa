// Shared device code of the port's kernels: words, word-sized field
// arithmetic with compile-time moduli, lazy double-width sums, table
// operands beside their Shoup companions, asynchronous copies.
//
// Values are residues of q1 = 2^27 - 2047 in 32-bit words and of
// q2 = 2^50 - 16383 in 64-bit words (and the small test preset's fields
// likewise); every stored output is a canonical residue in [0, q), so sums
// may be taken in any order and still match the plain torch versions bit
// for bit.
#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

typedef unsigned long long u64;
typedef long long i64;
typedef unsigned int u32;

// ---------------------------------------------------------------- helpers
static __host__ __device__ constexpr int bit_length(u64 v) { return v == 0 ? 0 : 1 + bit_length(v >> 1); }
static __host__ __device__ constexpr int ceil_log2(u64 v) { return bit_length(v - 1); }
static __host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

static __device__ __forceinline__ u32 mul_hi(u32 a, u32 b) { return __umulhi(a, b); }
static __device__ __forceinline__ u64 mul_hi(u64 a, u64 b) { return __umul64hi(a, b); }

// A table operand beside its Shoup companion: one vector load brings both.
template <typename W>
struct alignas(2 * sizeof(W)) Operand {
  W w, sh;
};

// The same from global memory through the read-only cache.
static __device__ __forceinline__ Operand<u32> ldg_operand(const Operand<u32>* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  return Operand<u32>{v.x, v.y};
}
static __device__ __forceinline__ Operand<u64> ldg_operand(const Operand<u64>* p) {
  const ulonglong2 v = __ldg(reinterpret_cast<const ulonglong2*>(p));
  return Operand<u64>{v.x, v.y};
}

// A 128-bit sum of 64 x 64 -> 128 bit products.
struct U128 {
  u64 lo, hi;
};

// Asynchronous global -> shared copies (Ampere-style cp.async, enough for
// the 8- and 16-byte pieces a thread stages for itself). A host compiler
// sees plain copies, so the kernel templates can be run on the host.
template <int BYTES>
static __device__ __forceinline__ void cp_async(void* smem_dst, const void* gmem_src) {
#ifdef __CUDACC__
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(gmem_src), "n"(BYTES) : "memory");
#else
  memcpy(smem_dst, gmem_src, BYTES);
#endif
}
// 16 bytes of data that is read once: past the L1 cache.
static __device__ __forceinline__ void cp_async_stream16(void* smem_dst, const void* gmem_src) {
#ifdef __CUDACC__
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src) : "memory");
#else
  memcpy(smem_dst, gmem_src, 16);
#endif
}
static __device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDACC__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}
template <int PENDING>
static __device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDACC__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
#endif
}

// ------------------------------------------------------------------ field
// Canonical residues in [0, Q) held in words W (32 bits where 2Q < 2^32,
// else 64). Q = 2^BITS - EPS with a small EPS, so products reduce by
// folding the high part times EPS; multiplication by a table operand is a
// Shoup product with the companion floor(w * 2^WBITS / Q).
template <typename W_, u64 Q_>
struct WordField {
  typedef W_ W;
  static constexpr u64 Q = Q_;
  static constexpr int WBITS = 8 * sizeof(W);
  static constexpr int BITS = bit_length(Q);
  static constexpr u64 EPS = (1ull << BITS) - Q;
  static constexpr int EPS_BITS = bit_length(EPS);
  static constexpr u64 MASK = (1ull << BITS) - 1;
  static_assert(BITS + 2 < WBITS, "4Q must fit the word");

  static __device__ __forceinline__ W add(W a, W b) {
    const W s = a + b;
    const W t = s - (W)Q;  // wraps above s when s < Q
    return s < t ? s : t;
  }
  static __device__ __forceinline__ W sub(W a, W b) { return a >= b ? a - b : a + (W)Q - b; }
  static __device__ __forceinline__ W neg(W a) { return a == 0 ? 0 : (W)Q - a; }
  // a + b for a, b in [0, 2Q), into [0, 2Q)
  static __device__ __forceinline__ W add2(W a, W b) {
    const W s = a + b;
    const W t = s - (W)(2 * Q);
    return s < t ? s : t;
  }
  // [0, 2Q) -> [0, Q)
  static __device__ __forceinline__ W canonical(W a) {
    const W t = a - (W)Q;
    return a < t ? a : t;
  }
  // x * w mod Q for any word x; w_sh = floor(w * 2^WBITS / Q). The lazy
  // form leaves the result in [0, 2Q).
  static __device__ __forceinline__ W mul_shoup_lazy(W x, W w, W w_sh) {
    return x * w - mul_hi(x, w_sh) * (W)Q;
  }
  static __device__ __forceinline__ W mul_shoup(W x, W w, W w_sh) {
    const W r = mul_shoup_lazy(x, w, w_sh);
    const W s = r - (W)Q;
    return r < s ? r : s;
  }
  // v < 2^BOUND -> [0, Q): fold until v < 2^(BITS + 1), then two subtracts
  // (ops/modmath.py PrimeField.reduce).
  template <int BOUND>
  static __device__ __forceinline__ W reduce64(u64 v) {
    constexpr int NB = cmax(BITS, BOUND - BITS + EPS_BITS) + 1;
    if constexpr (NB < BOUND) {
      return reduce64<NB>((v >> BITS) * EPS + (v & MASK));
    } else {
      static_assert(BOUND <= BITS + 1, "fold did not converge");
      v = v >= Q ? v - Q : v;
      v = v >= Q ? v - Q : v;
      return (W)v;
    }
  }
};

// Lazy sums of products: a double-width accumulator per word size.
template <typename F, typename W = typename F::W>
struct WideAcc;

template <typename F>
struct WideAcc<F, u32> {
  typedef u64 T;
  static __device__ __forceinline__ T from(u32 v) { return v; }
  static __device__ __forceinline__ void mac(T& a, u32 x, u32 y) { a += (u64)x * y; }
  // a holds at most 2^TERM_BITS terms, each below 2^(2 BITS)
  template <int TERM_BITS>
  static __device__ __forceinline__ u32 reduce(T a) {
    static_assert(2 * F::BITS + TERM_BITS <= 64, "lazy sum overflows 64 bits");
    return F::template reduce64<2 * F::BITS + TERM_BITS>(a);
  }
};

template <typename F>
struct WideAcc<F, u64> {
  typedef U128 T;
  static __device__ __forceinline__ T from(u64 v) { return U128{v, 0}; }
  static __device__ __forceinline__ void mac(T& a, u64 x, u64 y) {
    const u64 lo = x * y;
    a.lo += lo;
    a.hi += __umul64hi(x, y) + (a.lo < lo ? 1 : 0);
  }
  template <int TERM_BITS>
  static __device__ __forceinline__ u64 reduce(T a) {
    constexpr int B = F::BITS;
    static_assert(2 * B >= 64 && 2 * B + TERM_BITS <= 128, "limb split");
    static_assert(B + F::EPS_BITS <= 64, "a1 * EPS overflows");
    static_assert(64 - B + F::EPS_BITS <= B && TERM_BITS + 2 * F::EPS_BITS <= B, "bound");
    // three limbs of B bits: v = a0 + a1 2^B + a2 2^2B == a0 + a1 EPS + a2 EPS^2
    const u64 a0 = a.lo & F::MASK;
    const u64 a1 = ((a.lo >> B) | (a.hi << (64 - B))) & F::MASK;
    const u64 a2 = a.hi >> (2 * B - 64);
    const u64 w = a1 * F::EPS;
    const u64 w1 = (w >> B) * F::EPS + (w & F::MASK);
    return F::template reduce64<B + 2>(a0 + w1 + a2 * (F::EPS * F::EPS));
  }
};

// A kernel launch on a stream given as void*. (A host build of the kernel
// templates, which runs a block as one host thread per CUDA thread, brings
// its own.)
#ifdef __CUDACC__
#define OMR_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, (cudaStream_t)(stream)>>>(__VA_ARGS__)
#endif

// Thread-block clusters (sm_90): the CTA's rank in its cluster, a barrier
// of all the cluster's threads (release / acquire: shared-memory writes
// before it, local or a peer's, are seen after it), a peer's copy of a
// shared variable (generic addresses), the base of the CTA's dynamic shared
// memory (a macro: taken through a function, the kernels' shared accesses
// compiled to other code), a launch of clusters of `cluster` CTAs and the
// clusters of a kernel that the card holds at once. A host build brings its
// own.
#ifdef __CUDACC__
#define OMR_CTA_SMEM(raw) (raw)
static __device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
static __device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
template <class T>
static __device__ __forceinline__ T* cluster_map(T* p, unsigned rank) {
  u64 a;
  asm("mapa.u64 %0, %1, %2;" : "=l"(a) : "l"(reinterpret_cast<u64>(p)), "r"(rank));
  return reinterpret_cast<T*>(a);
}
template <class... P, class... A>
static cudaError_t omr_launch_cluster(void (*kernel)(P...), unsigned cluster, unsigned grid,
                                      unsigned block, size_t smem, void* stream, A... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}
template <class K>
static cudaError_t omr_cluster_fit(K kernel, unsigned cluster, unsigned block, size_t smem,
                                   int* n) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(n, (const void*)kernel, &cfg);
}
#endif

// Dynamic shared memory above 48 KB must be opted into per kernel, up to
// what one block may have on the H100.
constexpr int SMEM_BLOCK_MAX = 232448;
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
