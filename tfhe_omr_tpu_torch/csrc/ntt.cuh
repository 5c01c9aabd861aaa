// Device code of the row NTT (see ntt.cu for the design note): the
// configuration, what its passes read and write (ntt_passes.cuh) and the
// kernel template.
#pragma once

#include "ntt_passes.cuh"

// One instantiation per (ring, field): ROWS rows per block and turn, T
// threads, RLOG radix-2 stages per pass.
template <typename W_, int LOG_N_, u64 Q_, int RLOG_, int ROWS_, int T_>
struct NttConfig : NttPlan<W_, LOG_N_, Q_, RLOG_> {
  typedef NttPlan<W_, LOG_N_, Q_, RLOG_> Plan;
  typedef W_ W;
  typedef typename Plan::F F;
  static constexpr int LOG_N = LOG_N_, N = Plan::N, NP = Plan::NP;
  static constexpr int ROWS = ROWS_, T = T_;
  static constexpr int TW = N - 1;  // twiddles of a transform, either way
  static_assert(Plan::TW_FWD == TW && Plan::TW_INV == TW, "one twiddle per stage and group");
  static_assert(Plan::PASSES >= 2, "the next row is staged behind the first pass");
  static_assert(N <= 65536 && N % 2 == 0, "the permutation is held in 16-bit words");

  // shared memory map, in bytes
  static constexpr size_t OFF_STAGE = 0;                                   // ROWS x N int64
  static constexpr size_t OFF_TW = OFF_STAGE + (size_t)ROWS * N * 8;       // TW operands
  static constexpr size_t OFF_WORK = OFF_TW + (size_t)(TW + 1) * 2 * sizeof(W);  // ROWS x NP words
  static constexpr size_t OFF_PERM = OFF_WORK + ((size_t)ROWS * NP * sizeof(W) + 15) / 16 * 16;
  static constexpr size_t SMEM_BYTES = OFF_PERM + (size_t)N * 2;

  // [0, NTT_GROWTH Q) -> [0, Q)
  static __device__ __forceinline__ W canonical_after_fwd(W v) {
    return F::template reduce64<F::BITS + bit_length(Plan::NTT_GROWTH)>((u64)v);
  }
};

// Rows as they lie in device memory (int64, staged into shared memory): in
// their own order for the forward transform, gathered through the
// permutation from the reference slot order for the inverse.
template <class C, bool PERMUTED>
struct NttRows {
  typedef typename C::W W;
  static constexpr bool SMALL_DIGITS = false;
  const i64* stage;
  const unsigned short* perm;
  struct At {
    const i64* row;
    const unsigned short* perm;
    __device__ __forceinline__ W load(int k) const {
      return (W)row[PERMUTED ? perm[k] : k];
    }
  };
  __device__ __forceinline__ At at(int poly) const { return At{stage + poly * C::N, perm}; }
};

// rows (n_rows, N) int64 row-major; tw: the direction's per-pass twiddles,
// each followed by its companion; perm (N) 16-bit: forward, reference slot
// k holds base slot perm[k]; inverse, base slot k holds reference slot
// perm[k]. Block b takes the row groups b, b + gridDim.x, ...
template <class C, bool INVERSE>
__global__ void __launch_bounds__(C::T) ntt_kernel(
    const i64* __restrict__ in, i64* __restrict__ out, long long n_rows,
    const typename C::W* __restrict__ tw, const unsigned short* __restrict__ perm,
    typename C::W n_inv, typename C::W n_inv_sh) {
  typedef typename C::W W;
  typedef typename C::F F;
  constexpr int N = C::N, ROWS = C::ROWS, T = C::T;
  constexpr int R0 = C::pass_stages(0);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  i64* stage = reinterpret_cast<i64*>(smem_raw + C::OFF_STAGE);
  W* tw_sm = reinterpret_cast<W*>(smem_raw + C::OFF_TW);
  W* work = reinterpret_cast<W*>(smem_raw + C::OFF_WORK);
  unsigned short* perm_sm = reinterpret_cast<unsigned short*>(smem_raw + C::OFF_PERM);
  const SharedTable<W> table{reinterpret_cast<const Operand<W>*>(tw_sm)};
  const PolyBuffer<C> buffer{work};
  const NttRows<C, INVERSE> rows{stage, perm_sm};
  const int tid = threadIdx.x;
  const long long groups = (n_rows + ROWS - 1) / ROWS;

  // 16 bytes a thread, neighbouring threads on neighbouring addresses
  auto stage_group = [&](long long g) {
    if (g < groups) {
      const i64* src = in + g * ROWS * N;
      for (int k = tid * 2; k < ROWS * N; k += T * 2)
        if (g * ROWS + k / N < n_rows) cp_async_stream16(stage + k, src + k);
    }
    cp_async_commit();
  };
  long long g = blockIdx.x;
  stage_group(g);
  for (int k = tid; k < 2 * C::TW; k += T) tw_sm[k] = tw[k];
  for (int k = tid; k < N; k += T) perm_sm[k] = perm[k];

  for (; g < groups; g += gridDim.x) {
    cp_async_wait<0>();
    __syncthreads();  // the group is staged; the last one's stores are done
    if constexpr (INVERSE) {
      inv_pass<C, T, 0, R0>(ROWS, table, n_inv, n_inv_sh, rows, buffer);
      __syncthreads();
      stage_group(g + gridDim.x);  // behind the remaining passes
      inv_ntt<C, T, 1>(ROWS, table, n_inv, n_inv_sh, buffer, buffer, buffer);
    } else {
      fwd_pass<C, T, 0, R0>(ROWS, table, rows, buffer);
      __syncthreads();
      stage_group(g + gridDim.x);
      fwd_ntt<C, T, 1>(ROWS, table, buffer, buffer, buffer);
    }
    i64* dst = out + g * ROWS * N;
    for (int k = tid * 2; k < ROWS * N; k += T * 2) {
      const int row = k / N;
      const int c = k % N;
      if (g * ROWS + row >= n_rows) continue;
      const W* p = work + row * C::NP;
      longlong2 v;
      if constexpr (INVERSE) {
        v.x = (i64)F::canonical(p[C::pad(c)]);
        v.y = (i64)F::canonical(p[C::pad(c + 1)]);
      } else {
        v.x = (i64)C::canonical_after_fwd(p[C::pad(perm_sm[c])]);
        v.y = (i64)C::canonical_after_fwd(p[C::pad(perm_sm[c + 1])]);
      }
      *reinterpret_cast<longlong2*>(dst + k) = v;
    }
  }
  cp_async_wait<0>();
}
