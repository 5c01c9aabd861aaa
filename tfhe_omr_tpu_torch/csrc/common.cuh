// Shared device code of the port's kernels: field arithmetic, the gadget
// digits and a block-wide negacyclic NTT in shared memory.
//
// Values are canonical residues in [0, q) held in 64-bit lanes for both
// fields (q1 = 2^27 - 2047 and q2 = 2^50 - 16383); every stored output is
// reduced, so sums may be taken in any order and still match the plain
// torch version bit for bit.
//
// Multiplication by a fixed operand w (twiddle, key, monomial table) is a
// Shoup product with the JAX package's companions w_sh = floor(w * 2^s / q),
// s = 30 for fields below 2^28 and s = 52 above: t = floor(x * w_sh / 2^s)
// comes from __umul64hi, and x * w - t * q (mod 2^64) lies in [0, 2q).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned long long u64;
typedef long long i64;

struct Field {
  u64 q;
  int shoup_shift;
};

// Radix-2 twiddle tables of ops/ntt.py (index m + i at stage m), with the
// 1/N scale folded into the inverse's last stage.
struct NttTables {
  const u64* fwd;
  const u64* fwd_sh;
  const u64* inv;
  const u64* inv_sh;
  u64 n_inv;
  u64 n_inv_sh;
  int log_n;
};

// ops/decompose.py SignedGadget.kernel_params(); shift == 0: exact digits.
struct Gadget {
  int log_b;
  int d;
  int shift;
  int corr_pre;
  int corr_post;
  i64 eps;
};

static __device__ __forceinline__ u64 mod_add(u64 a, u64 b, u64 q) {
  const u64 s = a + b;
  return s >= q ? s - q : s;
}

static __device__ __forceinline__ u64 mod_sub(u64 a, u64 b, u64 q) {
  return a >= b ? a - b : a + q - b;
}

static __device__ __forceinline__ u64 mod_neg(u64 a, u64 q) {
  return a == 0 ? 0 : q - a;
}

static __device__ __forceinline__ u64 mul_shoup(u64 x, u64 w, u64 w_sh,
                                                const Field& f) {
  const u64 lo = x * w_sh;
  const u64 hi = __umul64hi(x, w_sh);
  const u64 t = (hi << (64 - f.shoup_shift)) | (lo >> f.shoup_shift);
  const u64 r = x * w - t * f.q;
  return r >= f.q ? r - f.q : r;
}

// Digit j of x in [0, q), mapped into [0, q): the balanced signed digits of
// u = round(x * B^d / q) (Solinas-corrected), or exact base-B digits.
static __device__ __forceinline__ u64 gadget_digit(u64 x, int j,
                                                   const Gadget& g, u64 q) {
  const i64 bmask = (1LL << g.log_b) - 1;
  const i64 xs = (i64)x;
  if (g.shift == 0) return (u64)((xs >> (g.log_b * j)) & bmask);
  const i64 corr = ((xs >> g.corr_pre) * g.eps) >> g.corr_post;
  i64 r = (xs + corr + (1LL << (g.shift - 1))) >> g.shift;
  const i64 half = 1LL << (g.log_b - 1);
  i64 dj = 0;
  for (int jj = 0; jj <= j; ++jj) {
    dj = r & bmask;
    r >>= g.log_b;
    const i64 carry = dj >= half ? 1 : 0;
    dj -= carry << g.log_b;
    r += carry;
  }
  return dj < 0 ? (u64)(dj + (i64)q) : (u64)dj;
}

// Forward NTT of npoly polynomials stored one after another in shared
// memory: natural order in, radix-2 ("base") order out. Every thread of the
// block calls it after the data is in place; it ends synchronised.
static __device__ void block_ntt_fwd(u64* a, int npoly, const NttTables& t,
                                     const Field& f) {
  const int log_half = t.log_n - 1;
  const int half = 1 << log_half;
  const int total = npoly << log_half;
  for (int log_m = 0; log_m < t.log_n; ++log_m) {
    const int m = 1 << log_m;
    const int log_t = log_half - log_m;
    const int tmask = (1 << log_t) - 1;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int p = idx >> log_half;
      const int b = idx & (half - 1);
      const int i = b >> log_t;
      const int u = (p << t.log_n) + (i << (log_t + 1)) + (b & tmask);
      const int v = u + (1 << log_t);
      const u64 y = mul_shoup(a[v], t.fwd[m + i], t.fwd_sh[m + i], f);
      const u64 x = a[u];
      a[u] = mod_add(x, y, f.q);
      a[v] = mod_sub(x, y, f.q);
    }
    __syncthreads();
  }
}

// Inverse NTT (base order in, natural order out, including 1/N).
static __device__ void block_ntt_inv(u64* a, int npoly, const NttTables& t,
                                     const Field& f) {
  const int log_half = t.log_n - 1;
  const int half = 1 << log_half;
  const int total = npoly << log_half;
  for (int log_h = log_half; log_h >= 0; --log_h) {
    const int h = 1 << log_h;
    const int log_t = log_half - log_h;
    const int tmask = (1 << log_t) - 1;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int p = idx >> log_half;
      const int b = idx & (half - 1);
      const int i = b >> log_t;
      const int u = (p << t.log_n) + (i << (log_t + 1)) + (b & tmask);
      const int v = u + (1 << log_t);
      const u64 x = a[u];
      const u64 y = a[v];
      u64 s = mod_add(x, y, f.q);
      if (h == 1) s = mul_shoup(s, t.n_inv, t.n_inv_sh, f);
      a[v] = mul_shoup(mod_sub(x, y, f.q), t.inv[h + i], t.inv_sh[h + i], f);
      a[u] = s;
    }
    __syncthreads();
  }
}

// Dynamic shared memory above 48 KB must be opted into per kernel.
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
