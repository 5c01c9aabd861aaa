// Host stand-in for <cuda_runtime.h>: enough to compile the port's .cu files
// with g++ -std=c++20 and run a kernel on the host, one block after
// another, a block as one std::thread per CUDA thread with __syncthreads
// as a std::barrier. A cluster launch runs one cluster after another, its
// CTAs at once, each with shared memory of its own; the cluster barrier is
// a std::barrier over all of the cluster's threads and a peer's shared
// memory is read and written through a plain pointer. It finds index,
// layout and barrier faults of the kernel templates where there is no card
// (utils/build.py host_library); what nvcc itself refuses shows only on a
// card.
#pragma once
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __host__
#define __device__
#define __global__
#define __forceinline__ inline __attribute__((always_inline))
#define __restrict__
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)
#define __grid_constant__

struct uint3_ { unsigned x, y, z; };
inline thread_local uint3_ threadIdx, blockIdx;
inline uint3_ blockDim, gridDim;
struct uint2 { unsigned x, y; };
struct alignas(16) ulonglong2 { unsigned long long x, y; };
struct alignas(16) longlong2 { long long x, y; };
struct alignas(8) int2 { int x, y; };
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum { cudaMemcpyHostToDevice = 1 };
template <class K> inline int cudaFuncSetAttribute(K, int, int) { return 0; }
template <class K> inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) { *n = 2; return 0; }
inline int cudaGetLastError() { return 0; }
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  memset(p, v, n);
  return 0;
}
inline const char* cudaGetErrorString(int) { return "host shim error"; }

inline int __mulhi(int a, int b) { return (int)(((long long)a * b) >> 32); }
inline unsigned __umulhi(unsigned a, unsigned b) { return (unsigned)(((unsigned long long)a * b) >> 32); }
inline unsigned long long __umul64hi(unsigned long long a, unsigned long long b) {
  return (unsigned long long)(((unsigned __int128)a * b) >> 64);
}
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T>
inline int cudaMemcpyToSymbolAsync(T& symbol, const void* src, size_t count, size_t offset, int,
                                   cudaStream_t) {
  memcpy(reinterpret_cast<char*>(&symbol) + offset, src, count);
  return 0;
}
// a stand-in clock: each read in a thread is one later than the last, so
// every stage a profiled kernel stamps counts at least one
inline long long clock64() {
  static thread_local long long ticks = 0;
  return ++ticks;
}
// single-threaded where the kernels use it (thread 0 of a block)
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  const unsigned long long old = *p;
  *p = old + v;
  return old;
}

alignas(16) inline unsigned char smem_raw[232448];
inline thread_local std::barrier<>* omr_block_barrier = nullptr;
inline void __syncthreads() { omr_block_barrier->arrive_and_wait(); }

// A CTA of a cluster launch: its rank, its shared memory and its peers'
// (null outside a cluster launch: the block's memory is smem_raw), the
// barrier of the whole cluster.
inline thread_local unsigned omr_cta_rank = 0;
inline thread_local unsigned char* omr_cta_smem = nullptr;
inline thread_local unsigned char* const* omr_cluster_smem = nullptr;
inline thread_local std::barrier<>* omr_cluster_barrier = nullptr;
#define OMR_CTA_SMEM(raw) (omr_cta_smem ? omr_cta_smem : (raw))
inline unsigned cluster_ctarank() { return omr_cta_rank; }
inline void cluster_sync() { omr_cluster_barrier->arrive_and_wait(); }
template <class T>
inline T* cluster_map(T* p, unsigned rank) {
  const std::ptrdiff_t off = reinterpret_cast<const unsigned char*>(p) - omr_cta_smem;
  return reinterpret_cast<T*>(omr_cluster_smem[rank] + off);
}

template <class K, class... A>
inline void omr_host_launch(K kernel, unsigned grid, unsigned block, size_t smem, A... args) {
  if (smem > sizeof(smem_raw)) __builtin_trap();
  gridDim = {grid, 1, 1};
  blockDim = {block, 1, 1};
  for (unsigned b = 0; b < grid; ++b) {
    memset(smem_raw, 0xA5, sizeof(smem_raw));
    std::barrier<> bar(block);
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < block; ++t)
      ts.emplace_back([=, &bar] {
        threadIdx = {t, 0, 0};
        blockIdx = {b, 0, 0};
        omr_block_barrier = &bar;
        kernel(args...);
      });
    for (auto& t : ts) t.join();
  }
}
#define OMR_LAUNCH(kernel, grid, block, smem, stream, ...) \
  omr_host_launch(kernel, grid, block, smem, __VA_ARGS__)

// A launch of grid / cluster clusters of `cluster` CTAs (field.cuh's
// device version launches them with cudaLaunchKernelEx).
template <class K, class... A>
inline int omr_launch_cluster(K kernel, unsigned cluster, unsigned grid, unsigned block,
                              size_t smem, void*, A... args) {
  if (smem > sizeof(smem_raw) || cluster == 0 || grid % cluster) __builtin_trap();
  gridDim = {grid, 1, 1};
  blockDim = {block, 1, 1};
  std::vector<unsigned char> mem(cluster * sizeof(smem_raw) + 16);
  std::vector<unsigned char*> bases(cluster);
  for (unsigned r = 0; r < cluster; ++r)
    bases[r] = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<std::uintptr_t>(mem.data()) + 15) / 16 * 16 + r * sizeof(smem_raw));
  for (unsigned c0 = 0; c0 < grid; c0 += cluster) {
    memset(mem.data(), 0xA5, mem.size());
    std::barrier<> cluster_bar(cluster * block);
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    for (unsigned r = 0; r < cluster; ++r) bars.emplace_back(new std::barrier<>(block));
    std::vector<std::thread> ts;
    for (unsigned r = 0; r < cluster; ++r)
      for (unsigned t = 0; t < block; ++t)
        ts.emplace_back([=, &cluster_bar, &bars, &bases] {
          threadIdx = {t, 0, 0};
          blockIdx = {c0 + r, 0, 0};
          omr_block_barrier = bars[r].get();
          omr_cta_rank = r;
          omr_cta_smem = bases[r];
          omr_cluster_smem = bases.data();
          omr_cluster_barrier = &cluster_bar;
          kernel(args...);
        });
    for (auto& t : ts) t.join();
  }
  return 0;
}
// Every cluster fits at once: the host runs them one after another.
template <class K>
inline int omr_cluster_fit(K, unsigned, unsigned, size_t, int* n) {
  *n = 1 << 20;
  return 0;
}
