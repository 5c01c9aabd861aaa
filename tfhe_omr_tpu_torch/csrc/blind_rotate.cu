// Paired (BMMP) blind rotation: the whole CMUX chain of one LWE sample in
// one thread block.
//
// Replaces the Pallas kernels FusedBlindRotateL1._make_call (first level,
// N = 1024, q1, B = 2^5, d = 4; tfhe_omr_tpu/ops/pallas_fused.py:436) and
// FusedBlindRotateL2._make_call (second level, N = 2048, q2, B = 2^7, d = 6;
// pallas_fused.py:1218). One template over the field, ring and gadget
// serves both; the plain version is ops/bootstrap.py make_blind_rotate.
//
// Per step s (pair of secret bits) and sample m:
//   1. gadget-decompose both accumulator polynomials, digit by digit,
//      exactly as ops/decompose.py does;
//   2. forward-NTT the two digit polynomials in shared memory;
//   3. multiply-accumulate against the three RGSW rows [m10, m01, m11]
//      (Shoup products with the key's companions) into 3 x 2 register
//      accumulators per coefficient slot;
//   4. multiply row t by NTT(X^{a_t}) - 1, a lookup in the 2N-entry table
//      of psi powers at (a_t * o_k) mod 2N, with a_t in [a0, a1, a0 + a1];
//   5. sum the rows, inverse-NTT the two polynomials, add to acc.
// The accumulator stays in shared memory for all steps; nothing carries
// between blocks. The key is pre-permuted into the NTT's radix-2 slot
// order (ops/fused.py), laid out (step, row, digit, in, out, slot) so that
// consecutive threads read consecutive slots.
//
// What bounds it: every block reads the whole key once per step (at L2,
// 2.4 MB of key and companions per step, 790 MB per sample), so the chain
// is key-bandwidth bound out of L2 cache and device memory, with the 64-bit
// modular multiplies of 2d + 2 NTTs per step behind it. Serving several
// samples per block, so that each key read feeds all of them, is the
// obvious next step; this first kernel keeps one sample per block.
//
// Shared memory: acc (2N) + NTT buffer (2N) words = 32 KB at N = 1024,
// 64 KB at N = 2048.
#include "common.cuh"

constexpr int kSlots = 4;  // coefficient slots per thread: blockDim = N / 4

__global__ void __launch_bounds__(512) blind_rotate_kernel(
    const i64* __restrict__ acc_in, i64* __restrict__ acc_out,
    const i64* __restrict__ amounts, long long n_msgs, int n_steps,
    const u64* __restrict__ key, const u64* __restrict__ key_sh,
    const u64* __restrict__ mono, const u64* __restrict__ mono_sh,
    const i64* __restrict__ orders, NttTables t, Field f, Gadget g) {
  extern __shared__ u64 sm[];
  const int n = 1 << t.log_n;
  const i64 two_n = 2 * n;
  const int T = blockDim.x;
  u64* acc = sm;
  u64* buf = sm + 2 * n;
  const long long msg = blockIdx.x;
  const size_t io = (size_t)msg * 2 * n;
  for (int k = threadIdx.x; k < 2 * n; k += T) acc[k] = (u64)acc_in[io + k];
  i64 ord[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) ord[i] = orders[threadIdx.x + i * T];
  __syncthreads();

  const size_t plane = (size_t)n;  // one (row, digit, in, out) slice
  const size_t step_stride = (size_t)3 * g.d * 4 * plane;
  for (int s = 0; s < n_steps; ++s) {
    const i64 a0 = amounts[(size_t)(2 * s) * n_msgs + msg];
    const i64 a1 = amounts[(size_t)(2 * s + 1) * n_msgs + msg];
    const i64 amt[3] = {a0, a1, (a0 + a1) % two_n};
    const u64* ks = key + s * step_stride;
    const u64* ks_sh = key_sh + s * step_stride;
    u64 p[3][2][kSlots];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int o = 0; o < 2; ++o)
#pragma unroll
        for (int i = 0; i < kSlots; ++i) p[r][o][i] = 0;

    for (int j = 0; j < g.d; ++j) {
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int k = threadIdx.x + i * T;
        buf[k] = gadget_digit(acc[k], j, g, f.q);
        buf[n + k] = gadget_digit(acc[n + k], j, g, f.q);
      }
      __syncthreads();
      block_ntt_fwd(buf, 2, t, f);
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int k = threadIdx.x + i * T;
        const u64 d0 = buf[k];
        const u64 d1 = buf[n + k];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
#pragma unroll
          for (int o = 0; o < 2; ++o) {
            const size_t i0 = (((size_t)(r * g.d + j) * 2 + 0) * 2 + o) * plane + k;
            const size_t i1 = (((size_t)(r * g.d + j) * 2 + 1) * 2 + o) * plane + k;
            const u64 v = mod_add(mul_shoup(d0, ks[i0], ks_sh[i0], f),
                                  mul_shoup(d1, ks[i1], ks_sh[i1], f), f.q);
            p[r][o][i] = mod_add(p[r][o][i], v, f.q);
          }
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int k = threadIdx.x + i * T;
      u64 r0 = 0, r1 = 0;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const int e = (int)((amt[r] * ord[i]) % two_n);
        const u64 mv = mono[e];
        const u64 ms = mono_sh[e];
        r0 = mod_add(r0, mul_shoup(p[r][0][i], mv, ms, f), f.q);
        r1 = mod_add(r1, mul_shoup(p[r][1][i], mv, ms, f), f.q);
      }
      buf[k] = r0;
      buf[n + k] = r1;
    }
    __syncthreads();
    block_ntt_inv(buf, 2, t, f);
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int k = threadIdx.x + i * T;
      acc[k] = mod_add(acc[k], buf[k], f.q);
      acc[n + k] = mod_add(acc[n + k], buf[n + k], f.q);
    }
    __syncthreads();
  }
  for (int k = threadIdx.x; k < 2 * n; k += T) acc_out[io + k] = (i64)acc[k];
}

// acc (n_msgs, 2, N) coefficient domain; amounts (2 * n_steps, n_msgs) in
// [0, 2N); key / key_sh (n_steps, 3, d, 2, 2, N) in the base slot order;
// mono / mono_sh the 2N-entry psi^e - 1 table; orders (N,) base orders.
extern "C" int omr_blind_rotate(
    const int64_t* acc_in, int64_t* acc_out, const int64_t* amounts,
    int64_t n_msgs, int n_steps, const int64_t* key, const int64_t* key_sh,
    const int64_t* mono, const int64_t* mono_sh, const int64_t* orders,
    const int64_t* fwd_tw, const int64_t* fwd_tw_sh, const int64_t* inv_tw,
    const int64_t* inv_tw_sh, int log_n, int64_t q, int shoup_shift,
    int64_t n_inv, int64_t n_inv_sh, int log_b, int d, int shift,
    int corr_pre, int corr_post, int64_t eps, void* stream) {
  const int n = 1 << log_n;
  if (n % kSlots != 0 || n / kSlots > 512) return (int)cudaErrorInvalidValue;
  NttTables t{(const u64*)fwd_tw, (const u64*)fwd_tw_sh, (const u64*)inv_tw,
              (const u64*)inv_tw_sh, (u64)n_inv, (u64)n_inv_sh, log_n};
  Field f{(u64)q, shoup_shift};
  Gadget g{log_b, d, shift, corr_pre, corr_post, (i64)eps};
  const size_t smem = (size_t)4 * n * sizeof(u64);
  cudaError_t err = allow_smem(blind_rotate_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  blind_rotate_kernel<<<(unsigned)n_msgs, n / kSlots, smem, (cudaStream_t)stream>>>(
      (const i64*)acc_in, (i64*)acc_out, (const i64*)amounts, (long long)n_msgs,
      n_steps, (const u64*)key, (const u64*)key_sh, (const u64*)mono,
      (const u64*)mono_sh, (const i64*)orders, t, f, g);
  return (int)cudaGetLastError();
}
