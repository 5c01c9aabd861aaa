// Unit-rate probes: each kernel keeps one execution unit of the SM busy
// with work that no compiler can fold, so its time gives that unit's rate.
//
// Replaces the Pallas probes of benches/ (each computes the same function):
//   probe_chain  - vpu_probe.py make_probe, vpu_peak_probe.py
//                  make_chain_probe, mac_probe.py f32_fma_probe and
//                  mosaic_unsupported_probe.py chain_kernel (int32 mul,
//                  int64 mul, the signed high word of a 32 x 32 product);
//   probe_mac    - vpu_peak_probe.py make_mac_probe;
//   probe_i8dot  - vpu_probe.py make_dot_probe, mac_probe.py
//                  kernel_batched_dot and kernel_dot2d,
//                  mosaic_unsupported_probe.py build_bdot.
// The plain versions are ops/probes.py *_plain.
//
// probe_chain: one element per thread, S independent (a, b) pairs in
// registers, the mutual recurrence a' = fa(a, b); b' = fb(b, a') for a
// loop count given at run time; out = a_0 + b_0 + ... + b_{S-1}. Integer
// arithmetic wraps (it is done in the unsigned twin of the type), `>>` is
// arithmetic, the compare of sel_add signed. mulhi_add takes the signed
// high word (__mulhi), int64 mul_add multiplies in 64 bits (mul.lo.s64),
// fma is fmaf: one rounding per operation.
//
// probe_mac: acc_s += (v_s + i) * k_s with v_s = x + s, k_s = y - s loop
// invariant. The loop index passes through an empty asm so that the
// compiler cannot turn (v + i) * k into an induction variable of adds.
//
// probe_i8dot: C[g] = rounds x (A[g] @ B[g]) mod 2^32, int8 (g, m, k) x
// (g, k, n) -> int32, on the tensor cores: mma.sync m16n8k32 s8 x s8 + s32
// without .satfinite, so the sum wraps as the TPU's int32 sum does. A block
// of 4 warps owns a 64 x 64 tile of C; k is staged through shared memory in
// chunks of 128 bytes, zero-padded to a multiple of 32 and beyond m and n.
// The fragments of a chunk are loaded once and the rounds loop runs over
// them (sum_r sum_k = sum_k sum_r: the same wrapped sum), so the loop is
// nothing but mma.sync. What bounds each probe is its unit's issue rate:
// the data are read once.
#include "field.cuh"

#ifndef __CUDACC__
#include <cmath>
#endif

enum ProbeOp { ADD, MUL, MUL_ADD, SUB_ADD, SHIFT_ADD, MASK_ADD, SEL_ADD, MULHI_ADD, FMA };

template <class T> struct Unsigned;
template <> struct Unsigned<int> { typedef unsigned U; };
template <> struct Unsigned<long long> { typedef unsigned long long U; };

template <class T>
static __device__ __forceinline__ T wadd(T a, T b) {
  typedef typename Unsigned<T>::U U;
  return (T)((U)a + (U)b);
}
template <class T>
static __device__ __forceinline__ T wsub(T a, T b) {
  typedef typename Unsigned<T>::U U;
  return (T)((U)a - (U)b);
}
template <class T>
static __device__ __forceinline__ T wmul(T a, T b) {
  typedef typename Unsigned<T>::U U;
  return (T)((U)a * (U)b);
}
static __device__ __forceinline__ float wadd(float a, float b) { return a + b; }

template <int OP, class T>
static __device__ __forceinline__ void chain_step(T& a, T& b) {
  if constexpr (OP == FMA) {
    a = fmaf(a, b, 1.5f);
    b = fmaf(b, a, 0.5f);
  } else {
    T a2;
    if constexpr (OP == ADD || OP == MUL) {
      a2 = OP == ADD ? wadd(a, b) : wmul(a, b);
      b = OP == ADD ? wadd(b, a2) : wmul(b, a2);
    } else {
      if constexpr (OP == MUL_ADD) a2 = wmul(a, b);
      if constexpr (OP == SUB_ADD) a2 = wsub(a, b);
      if constexpr (OP == SHIFT_ADD) a2 = a >> 1;
      if constexpr (OP == MASK_ADD) a2 = a & b;
      if constexpr (OP == SEL_ADD) a2 = a > b ? wsub(a, b) : a;
      if constexpr (OP == MULHI_ADD) a2 = __mulhi(a, b);
      b = wadd(b, a2);
    }
    a = a2;
  }
}

template <int OP, class T, int S>
__global__ void __launch_bounds__(128)
probe_chain_kernel(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out,
                   long long n, int iters) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  T a[S], b[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if constexpr (OP == FMA) {
      a[s] = x[e] + (float)s;
      b[s] = y[e] * (float)(1.0 + 0.01 * s);
    } else {
      a[s] = wadd(x[e], (T)s);
      b[s] = wadd(y[e], (T)s);
    }
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int s = 0; s < S; ++s) chain_step<OP>(a[s], b[s]);
  }
  T acc = a[0];
#pragma unroll
  for (int s = 0; s < S; ++s) acc = wadd(acc, b[s]);
  out[e] = acc;
}

template <int S>
__global__ void __launch_bounds__(128)
probe_mac_kernel(const int* __restrict__ x, const int* __restrict__ y, int* __restrict__ out,
                 long long n, int iters) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  int v[S], k[S], acc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    v[s] = wadd(x[e], s);
    k[s] = wsub(y[e], s);
    acc[s] = 0;
  }
  for (int i = 0; i < iters; ++i) {
    int ii = i;
    asm("" : "+r"(ii));
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = wadd(acc[s], wmul(wadd(v[s], ii), k[s]));
  }
  int r = acc[0];
#pragma unroll
  for (int s = 1; s < S; ++s) r = wadd(r, acc[s]);
  out[e] = r;
}

// ------------------------------------------------------------ int8 mma
constexpr int DOT_BM = 64, DOT_BN = 64, DOT_KC = 128, DOT_KSTEPS = DOT_KC / 32;
constexpr int DOT_LDS = DOT_KC + 16;  // row pitch in bytes: fragment loads hit 32 banks
constexpr int DOT_SMEM = (DOT_BM + DOT_BN) * DOT_LDS;

#ifdef __CUDACC__
static __device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                              const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#else
// The host build: the lanes' fragments meet in a table and each lane sums
// its four elements of C from it, by the fragment layout of the PTX ISA
// (m16n8k32, .s8): lane = 4 * groupID + threadID_in_group; A register
// (row >= 8) + 2 (k >= 16), byte k % 4, held by groupID = row % 8,
// threadID_in_group = (k % 16) / 4; B register k >= 16, byte k % 4, held by
// groupID = col, threadID_in_group = (k % 16) / 4; C element i at row
// groupID + 8 (i >= 2), col 2 threadID_in_group + i % 2. Every thread of a
// block calls it equally often.
inline unsigned host_frag_a[1024][4], host_frag_b[1024][2];
static void mma_s8(int (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  const unsigned t = threadIdx.x, w0 = t & ~31u, lane = t & 31u;
  memcpy(host_frag_a[t], a, sizeof(a));
  memcpy(host_frag_b[t], b, sizeof(b));
  __syncthreads();
  const int g = lane >> 2, tq = lane & 3;
  for (int i = 0; i < 4; ++i) {
    const int row = g + (i >= 2 ? 8 : 0), col = 2 * tq + (i & 1);
    unsigned sum = (unsigned)c[i];
    for (int kk = 0; kk < 32; ++kk) {
      const unsigned wa = host_frag_a[w0 + (row & 7) * 4 + ((kk & 15) >> 2)][(row >> 3) + 2 * (kk >> 4)];
      const unsigned wb = host_frag_b[w0 + col * 4 + ((kk & 15) >> 2)][kk >> 4];
      const int av = (signed char)(wa >> (8 * (kk & 3)));
      const int bv = (signed char)(wb >> (8 * (kk & 3)));
      sum += (unsigned)(av * bv);
    }
    c[i] = (int)sum;
  }
  __syncthreads();
}
#endif

// The rounds over one staged chunk of NKS k-steps: fragments loaded once.
template <int NKS>
static __device__ __forceinline__ void dot_chunk(const signed char* as, const signed char* bs,
                                                 int rounds, int (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  unsigned af[NKS][2][4], bf[NKS][4][2];
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
    const int kb = ks * 32 + tq * 4;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const signed char* r0 = as + (wm + mt * 16 + g) * DOT_LDS + kb;
      af[ks][mt][0] = *reinterpret_cast<const unsigned*>(r0);
      af[ks][mt][1] = *reinterpret_cast<const unsigned*>(r0 + 8 * DOT_LDS);
      af[ks][mt][2] = *reinterpret_cast<const unsigned*>(r0 + 16);
      af[ks][mt][3] = *reinterpret_cast<const unsigned*>(r0 + 8 * DOT_LDS + 16);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const signed char* c0 = bs + (wn + nt * 8 + g) * DOT_LDS + kb;
      bf[ks][nt][0] = *reinterpret_cast<const unsigned*>(c0);
      bf[ks][nt][1] = *reinterpret_cast<const unsigned*>(c0 + 16);
    }
  }
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[ks][mt], bf[ks][nt]);
  }
}

// Grid: one block per (n tile, m tile, batch), flattened.
__global__ void __launch_bounds__(128)
probe_i8dot_kernel(const signed char* __restrict__ A, const signed char* __restrict__ B,
                   int* __restrict__ C, int m, int k, int n, int rounds) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  signed char* as = reinterpret_cast<signed char*>(smem_raw);
  signed char* bs = as + DOT_BM * DOT_LDS;
  const int tiles_n = (n + DOT_BN - 1) / DOT_BN, tiles_m = (m + DOT_BM - 1) / DOT_BM;
  const int bx = blockIdx.x % tiles_n, by = (blockIdx.x / tiles_n) % tiles_m;
  const long long bz = blockIdx.x / (tiles_n * tiles_m);
  const int m0 = by * DOT_BM, n0 = bx * DOT_BN;
  const signed char* a = A + bz * m * k;
  const signed char* b = B + bz * k * n;
  const int kpad = (k + 31) / 32 * 32;
  int acc[2][4][4] = {};
  for (int k0 = 0; k0 < kpad; k0 += DOT_KC) {
    const int kc = kpad - k0 < DOT_KC ? kpad - k0 : DOT_KC;
    for (int i = threadIdx.x; i < DOT_BM * kc; i += blockDim.x) {
      const int r = i / kc, kk = i % kc;
      const int gr = m0 + r, gk = k0 + kk;
      as[r * DOT_LDS + kk] = gr < m && gk < k ? a[(long long)gr * k + gk] : 0;
    }
    for (int i = threadIdx.x; i < DOT_BN * kc; i += blockDim.x) {
      const int kk = i / DOT_BN, c = i % DOT_BN;
      const int gc = n0 + c, gk = k0 + kk;
      bs[c * DOT_LDS + kk] = gc < n && gk < k ? b[(long long)gk * n + gc] : 0;
    }
    __syncthreads();
    switch (kc / 32) {
      case 1: dot_chunk<1>(as, bs, rounds, acc); break;
      case 2: dot_chunk<2>(as, bs, rounds, acc); break;
      case 3: dot_chunk<3>(as, bs, rounds, acc); break;
      default: dot_chunk<DOT_KSTEPS>(as, bs, rounds, acc); break;
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  int* c = C + bz * m * n;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + (warp >> 1) * 32 + mt * 16 + g + (i >= 2 ? 8 : 0);
        const int col = n0 + (warp & 1) * 32 + nt * 8 + 2 * tq + (i & 1);
        if (row < m && col < n) c[(long long)row * n + col] = acc[mt][nt][i];
      }
}

// ------------------------------------------------------------ entry points
template <int OP, class T, int S>
static int chain_launch(const void* x, const void* y, void* out, int64_t n, int iters,
                        void* stream) {
  void (*kernel)(const T*, const T*, T*, long long, int) = probe_chain_kernel<OP, T, S>;
  OMR_LAUNCH(kernel, (unsigned)((n + 127) / 128), 128, 0, stream, (const T*)x,
             (const T*)y, (T*)out, (long long)n, iters);
  return (int)cudaGetLastError();
}

template <int OP, class T>
static int chain_streams(int streams, const void* x, const void* y, void* out, int64_t n,
                         int iters, void* stream) {
  switch (streams) {
    case 1: return chain_launch<OP, T, 1>(x, y, out, n, iters, stream);
    case 4: return chain_launch<OP, T, 4>(x, y, out, n, iters, stream);
    case 16: return chain_launch<OP, T, 16>(x, y, out, n, iters, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// x, y, out (n) contiguous, of the type `dtype` names (0 int32, 1 int64,
// 2 float32); op a ProbeOp: int32 takes ADD .. MULHI_ADD, int64 MUL_ADD,
// float32 FMA; streams 1, 4 or 16.
extern "C" int omr_probe_chain(int op, int dtype, int streams, const void* x, const void* y,
                               void* out, int64_t n, int iters, void* stream) {
  if (n <= 0 || n > (int64_t)INT32_MAX * 128 || iters < 0) return (int)cudaErrorInvalidValue;
#define OMR_CHAIN(OP, T)                                                  \
  if (op == OP) return chain_streams<OP, T>(streams, x, y, out, n, iters, stream);
  if (dtype == 0) {
    OMR_CHAIN(ADD, int)
    OMR_CHAIN(MUL, int)
    OMR_CHAIN(MUL_ADD, int)
    OMR_CHAIN(SUB_ADD, int)
    OMR_CHAIN(SHIFT_ADD, int)
    OMR_CHAIN(MASK_ADD, int)
    OMR_CHAIN(SEL_ADD, int)
    OMR_CHAIN(MULHI_ADD, int)
  } else if (dtype == 1) {
    OMR_CHAIN(MUL_ADD, long long)
  } else if (dtype == 2) {
    OMR_CHAIN(FMA, float)
  }
#undef OMR_CHAIN
  return (int)cudaErrorInvalidValue;
}

template <int S>
static int mac_launch(const int* x, const int* y, int* out, int64_t n, int iters, void* stream) {
  OMR_LAUNCH(probe_mac_kernel<S>, (unsigned)((n + 127) / 128), 128, 0, stream, x, y, out,
             (long long)n, iters);
  return (int)cudaGetLastError();
}

// x, y, out (n) int32; streams 1, 4 or 16.
extern "C" int omr_probe_mac(int streams, const int* x, const int* y, int* out, int64_t n,
                             int iters, void* stream) {
  if (n <= 0 || n > (int64_t)INT32_MAX * 128 || iters < 0) return (int)cudaErrorInvalidValue;
  switch (streams) {
    case 1: return mac_launch<1>(x, y, out, n, iters, stream);
    case 4: return mac_launch<4>(x, y, out, n, iters, stream);
    case 16: return mac_launch<16>(x, y, out, n, iters, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// a (g, m, k), b (g, k, n) int8 and c (g, m, n) int32, contiguous.
extern "C" int omr_probe_i8dot(const void* a, const void* b, void* c, int64_t g, int m, int k,
                               int n, int rounds, void* stream) {
  const int64_t blocks = g * ((m + DOT_BM - 1) / DOT_BM) * ((n + DOT_BN - 1) / DOT_BN);
  if (g <= 0 || m <= 0 || k <= 0 || n <= 0 || rounds < 0 || blocks > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  OMR_LAUNCH(probe_i8dot_kernel, (unsigned)blocks, 128, DOT_SMEM, stream,
             (const signed char*)a, (const signed char*)b, (int*)c, m, k, n, rounds);
  return (int)cudaGetLastError();
}
