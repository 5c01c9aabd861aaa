// Host stand-in for <cuda_runtime.h>: enough to compile the port's .cu files
// with g++ -std=c++20 and run a kernel on the host, one block after
// another, a block as one std::thread per CUDA thread with __syncthreads
// as a std::barrier. It finds index, layout and barrier faults of the
// kernel templates where there is no card (utils/build.py host_library);
// what nvcc itself refuses shows only on a card.
#pragma once
#include <barrier>
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

struct uint3_ { unsigned x, y, z; };
inline thread_local uint3_ threadIdx, blockIdx;
inline uint3_ blockDim, gridDim;
struct uint2 { unsigned x, y; };
struct alignas(16) ulonglong2 { unsigned long long x, y; };
struct alignas(16) longlong2 { long long x, y; };
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum { cudaMemcpyHostToDevice = 1 };
template <class K> inline int cudaFuncSetAttribute(K, int, int) { return 0; }
template <class K> inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) { *n = 2; return 0; }
inline int cudaGetLastError() { return 0; }
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
inline std::barrier<>* omr_block_barrier = nullptr;
inline void __syncthreads() { omr_block_barrier->arrive_and_wait(); }

template <class K, class... A>
inline void omr_host_launch(K kernel, unsigned grid, unsigned block, size_t smem, A... args) {
  if (smem > sizeof(smem_raw)) __builtin_trap();
  gridDim = {grid, 1, 1};
  blockDim = {block, 1, 1};
  for (unsigned b = 0; b < grid; ++b) {
    memset(smem_raw, 0xA5, sizeof(smem_raw));
    std::barrier<> bar(block);
    omr_block_barrier = &bar;
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < block; ++t)
      ts.emplace_back([=] {
        threadIdx = {t, 0, 0};
        blockIdx = {b, 0, 0};
        kernel(args...);
      });
    for (auto& t : ts) t.join();
  }
}
#define OMR_LAUNCH(kernel, grid, block, smem, stream, ...) \
  omr_host_launch(kernel, grid, block, smem, __VA_ARGS__)
