// Homomorphic trace (EvalTr), all rounds of one message in one block.
//
// Replaces the Pallas kernel FusedTrace._make_trace_call
// (tfhe_omr_tpu/ops/pallas_fused.py:1765); the plain version is
// ops/bootstrap.py make_trace. Per round r (Galois element g = N/2^r + 1):
//   1. the automorphism sigma_g as a signed gather through the static
//      (gidx, gsign) tables of OmrContext.trace_autos;
//   2. the exact base-B digits of the automorphed a-part (d = 25 at B = 4),
//      two digit polynomials per forward NTT pass in shared memory;
//   3. multiply-accumulate with the trace key row (Shoup products) into two
//      register accumulators per slot;
//   4. inverse-NTT both, then acc_a -= pc_a and acc_b += auto_b - pc_b.
// The trace key is pre-permuted into the radix-2 slot order and laid out
// (round, digit, out, slot) so that consecutive threads read consecutive
// slots.
//
// What bounds it: 26 forward and 2 inverse 2048-point NTTs per round, i.e.
// the 64-bit modular multiplies and the per-stage __syncthreads; the key
// (11 x 25 x 2 x 2048 words and companions, 18 MB) stays in L2 cache.
//
// Shared memory: acc, automorphed acc and NTT buffer, 2N words each: 96 KB
// at N = 2048.
#include "common.cuh"

constexpr int kTraceSlots = 4;

__global__ void __launch_bounds__(512) trace_kernel(
    const i64* __restrict__ acc_in, i64* __restrict__ acc_out, int rounds,
    const i64* __restrict__ gidx, const i64* __restrict__ gsign,
    const u64* __restrict__ key, const u64* __restrict__ key_sh, NttTables t,
    Field f, Gadget g) {
  extern __shared__ u64 sm[];
  const int n = 1 << t.log_n;
  const int T = blockDim.x;
  u64* acc = sm;
  u64* aut = sm + 2 * n;
  u64* buf = sm + 4 * n;
  const size_t io = (size_t)blockIdx.x * 2 * n;
  for (int k = threadIdx.x; k < 2 * n; k += T) acc[k] = (u64)acc_in[io + k];
  __syncthreads();

  for (int r = 0; r < rounds; ++r) {
    const i64* gi = gidx + (size_t)r * n;
    const i64* gs = gsign + (size_t)r * n;
#pragma unroll
    for (int i = 0; i < kTraceSlots; ++i) {
      const int k = threadIdx.x + i * T;
      const int src = (int)gi[k];
      const bool neg = gs[k] < 0;
      const u64 x0 = acc[src];
      const u64 x1 = acc[n + src];
      aut[k] = neg ? mod_neg(x0, f.q) : x0;
      aut[n + k] = neg ? mod_neg(x1, f.q) : x1;
    }
    __syncthreads();

    u64 p[2][kTraceSlots];
#pragma unroll
    for (int i = 0; i < kTraceSlots; ++i) p[0][i] = p[1][i] = 0;
    for (int j = 0; j < g.d; j += 2) {
      const int np = (j + 1 < g.d) ? 2 : 1;
#pragma unroll
      for (int i = 0; i < kTraceSlots; ++i) {
        const int k = threadIdx.x + i * T;
        buf[k] = gadget_digit(aut[k], j, g, f.q);
        if (np == 2) buf[n + k] = gadget_digit(aut[k], j + 1, g, f.q);
      }
      __syncthreads();
      block_ntt_fwd(buf, np, t, f);
#pragma unroll
      for (int i = 0; i < kTraceSlots; ++i) {
        const int k = threadIdx.x + i * T;
        for (int pp = 0; pp < np; ++pp) {
          const u64 dv = buf[pp * n + k];
#pragma unroll
          for (int o = 0; o < 2; ++o) {
            const size_t idx = (((size_t)r * g.d + j + pp) * 2 + o) * n + k;
            p[o][i] = mod_add(p[o][i], mul_shoup(dv, key[idx], key_sh[idx], f), f.q);
          }
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < kTraceSlots; ++i) {
      const int k = threadIdx.x + i * T;
      buf[k] = p[0][i];
      buf[n + k] = p[1][i];
    }
    __syncthreads();
    block_ntt_inv(buf, 2, t, f);
#pragma unroll
    for (int i = 0; i < kTraceSlots; ++i) {
      const int k = threadIdx.x + i * T;
      acc[k] = mod_sub(acc[k], buf[k], f.q);
      acc[n + k] = mod_add(acc[n + k], mod_sub(aut[n + k], buf[n + k], f.q), f.q);
    }
    __syncthreads();
  }
  for (int k = threadIdx.x; k < 2 * n; k += T) acc_out[io + k] = (i64)acc[k];
}

// acc (n_msgs, 2, N) coefficient domain; gidx / gsign (rounds, N); key /
// key_sh (rounds, d, 2, N) in the base slot order; exact base-2^log_b digits.
extern "C" int omr_trace(const int64_t* acc_in, int64_t* acc_out, int64_t n_msgs,
                         int rounds, const int64_t* gidx, const int64_t* gsign,
                         const int64_t* key, const int64_t* key_sh,
                         const int64_t* fwd_tw, const int64_t* fwd_tw_sh,
                         const int64_t* inv_tw, const int64_t* inv_tw_sh,
                         int log_n, int64_t q, int shoup_shift, int64_t n_inv,
                         int64_t n_inv_sh, int log_b, int d, void* stream) {
  const int n = 1 << log_n;
  if (n % kTraceSlots != 0 || n / kTraceSlots > 512) return (int)cudaErrorInvalidValue;
  NttTables t{(const u64*)fwd_tw, (const u64*)fwd_tw_sh, (const u64*)inv_tw,
              (const u64*)inv_tw_sh, (u64)n_inv, (u64)n_inv_sh, log_n};
  Field f{(u64)q, shoup_shift};
  Gadget g{log_b, d, 0, 0, 0, 0};
  const size_t smem = (size_t)6 * n * sizeof(u64);
  cudaError_t err = allow_smem(trace_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  trace_kernel<<<(unsigned)n_msgs, n / kTraceSlots, smem, (cudaStream_t)stream>>>(
      (const i64*)acc_in, (i64*)acc_out, rounds, (const i64*)gidx,
      (const i64*)gsign, (const u64*)key, (const u64*)key_sh, t, f, g);
  return (int)cudaGetLastError();
}
