// Device code of the homomorphic trace (see trace.cu for the design note):
// the configuration, what its NTT passes read and write (ntt_passes.cuh)
// and the kernel template.
#pragma once

#include "ntt_passes.cuh"

// ----------------------------------------------------------------- config
// One instantiation per (ring, field, gadget). S messages per block, T
// threads, DJ digit polynomials transformed per pass (the last pass of a
// round takes what is left of D), RLOG radix-2 stages per NTT pass.
template <typename W_, int LOG_N_, int D_, int LOG_B_, u64 Q_, int S_, int T_,
          int DJ_, int RLOG_>
struct TrConfig : NttPlan<W_, LOG_N_, Q_, RLOG_> {
  typedef NttPlan<W_, LOG_N_, Q_, RLOG_> Plan;
  typedef W_ W;
  typedef typename Plan::F F;
  typedef WideAcc<F> Wide;
  static constexpr int LOG_N = LOG_N_, N = Plan::N, NP = Plan::NP, TW_FWD = Plan::TW_FWD;
  static constexpr int D = D_, LOG_B = LOG_B_;
  static constexpr int S = S_, T = T_, DJ = DJ_;
  static constexpr int VEC = 2;            // consecutive slots per thread group
  static constexpr int G = N / (VEC * T);  // slot groups per thread
  static constexpr int JP = (D + DJ - 1) / DJ;  // digit passes per round
  static_assert(sizeof(W) == 8, "the trace runs in 64-bit words");
  static_assert(LOG_B == 2, "the first butterfly stage selects among multiples of one twiddle below 4");
  static_assert(D * LOG_B >= F::BITS, "the trace takes exact digits");
  static_assert(G * VEC * T == N && DJ <= D, "config");
  // a round's products, D digits below NTT_GROWTH * Q times a key word
  // below Q, are summed in double width and reduced once
  static constexpr int MAC_TERM_BITS = ceil_log2(D * Plan::NTT_GROWTH);

  // shared memory map, in words. The digit buffer holds the S * DJ digit
  // polynomials of a pass; after the last pass of a round its head holds
  // the 2 S product polynomials and, behind them, the S automorphed b-parts.
  static constexpr int DIG_POLYS = S * cmax(DJ, 3);
  static constexpr int OFF_ACC = 0;
  static constexpr int OFF_DIG = OFF_ACC + S * 2 * NP;
  static constexpr int OFF_PARK = OFF_DIG + S * 2 * NP;
  static constexpr int OFF_TWF = OFF_DIG + DIG_POLYS * NP;
  static constexpr int SMEM_WORDS = OFF_TWF + 2 * TW_FWD;
  static constexpr size_t SMEM_BYTES = (size_t)SMEM_WORDS * sizeof(W);
};

// sigma_g(c)[k] = +-c[m mod N] with m = g^{-1} k mod 2N, negated where
// m >= N: index and sign of the automorphism from one multiply.
template <class C>
static __device__ __forceinline__ typename C::W automorphed(const typename C::W* c, int ginv, int k) {
  const int m = (ginv * k) & (2 * C::N - 1);
  const typename C::W x = c[C::pad(m & (C::N - 1))];
  return (m >> C::LOG_N) ? C::F::neg(x) : x;
}

// ------------------------------------------------- sources and sinks
// What the first forward pass reads: exact digit j0 + jj of the
// automorphed a-part of message s, polynomial s * nd + jj of the pass.
template <class C>
struct TrDigits {
  typedef typename C::W W;
  static constexpr bool SMALL_DIGITS = true;
  const W* acc;
  int ginv, j0, nd;
  W w1, w2;  // the twiddle of stage 0 and twice it, canonical
  struct At {
    const W* a;
    int ginv, shift;
    W w1, w2;
    __device__ __forceinline__ W load(int k) const {
      return (automorphed<C>(a, ginv, k) >> shift) & 3;
    }
    // digit * w1 in [0, 2Q)
    __device__ __forceinline__ W times_first_twiddle(W digit) const {
      return ((digit & 1) ? w1 : 0) + ((digit & 2) ? w2 : 0);
    }
  };
  __device__ __forceinline__ At at(int poly) const {
    const int s = C::S == 1 ? 0 : poly / nd;
    const int jj = poly - s * nd;
    return At{acc + s * 2 * C::NP, ginv, C::LOG_B * (j0 + jj), w1, w2};
  }
};

// Where the last inverse pass leaves polynomial (s, o): acc_a -= pc_a, and
// acc_b += sigma(acc_b) - pc_b with sigma(acc_b) parked before any of
// acc_b is overwritten.
template <class C>
struct TrUpdate {
  typedef typename C::W W;
  typedef typename C::F F;
  W* acc;
  const W* park;
  struct At {
    W* a;
    const W* parked;  // null for the a-part
    __device__ __forceinline__ void store(int k, W v) const {
      const int p = C::pad(k);
      const W pc = F::canonical(v);
      const W base = parked ? F::add(a[p], parked[p]) : a[p];
      a[p] = F::sub(base, pc);
    }
  };
  __device__ __forceinline__ At at(int poly) const {
    return At{acc + poly * C::NP, (poly & 1) ? park + (poly >> 1) * C::NP : nullptr};
  }
};

// ----------------------------------------------------------------- kernel
// acc (n_msgs, 2, N) int64; ginv (rounds) int32, the inverse mod 2N of each
// round's Galois element; key (n_msgs / per_key, rounds, D, 2, N) words in
// the base slot order: messages k per_key .. k per_key + per_key - 1 take
// key k (one key: per_key = n_msgs); tw_fwd / tw_inv:
// per-pass twiddles, each followed by its companion.
template <class C>
__global__ void __launch_bounds__(C::T, 1) trace_kernel(
    const i64* __restrict__ acc_in, i64* __restrict__ acc_out, long long n_msgs,
    int rounds, const int* __restrict__ ginv, const typename C::W* __restrict__ key,
    const typename C::W* __restrict__ tw_fwd, const typename C::W* __restrict__ tw_inv,
    typename C::W n_inv, typename C::W n_inv_sh, long long per_key) {
  typedef typename C::W W;
  typedef typename C::F F;
  typedef typename C::Wide Wide;
  typedef typename Wide::T WideT;
  constexpr int N = C::N, S = C::S, G = C::G, VEC = C::VEC, DJ = C::DJ, D = C::D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* sm = reinterpret_cast<W*>(smem_raw);
  const SharedTable<W> tw_f{reinterpret_cast<const Operand<W>*>(sm + C::OFF_TWF)};
  const CachedTable<W> tw_i{reinterpret_cast<const Operand<W>*>(tw_inv)};
  const PolyBuffer<C> digits{sm + C::OFF_DIG};
  const int tid = threadIdx.x;
  // the block's messages: S of one key's per_key (as blind_rotate.cuh)
  const long long key_blocks = (per_key + S - 1) / S;
  const long long key_index = blockIdx.x / key_blocks;
  const long long key_lo = (blockIdx.x - key_index * key_blocks) * S;
  const long long msg0 = key_index * per_key + key_lo;
  const int n_valid = per_key - key_lo < S ? (int)(per_key - key_lo) : S;
  key += (size_t)key_index * rounds * D * 2 * N;

  for (int k = tid; k < 2 * C::TW_FWD; k += C::T) sm[C::OFF_TWF + k] = tw_fwd[k];
  for (int k = tid; k < S * 2 * N; k += C::T) {
    const int s = k / (2 * N);
    const int r = k % (2 * N);
    const bool valid = s < n_valid;
    sm[C::OFF_ACC + (s * 2 + r / N) * C::NP + C::pad(r % N)] =
        valid ? (W)acc_in[(msg0 + s) * 2 * N + r] : (W)0;
  }
  __syncthreads();
  const W w1 = tw_f(0).w;
  const W w2 = F::add(w1, w1);

  for (int round = 0; round < rounds; ++round) {
    const int gi = ginv[round];
    WideT sum[G][S][2][VEC];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int o = 0; o < 2; ++o)
#pragma unroll
          for (int v = 0; v < VEC; ++v) sum[g][s][o][v] = Wide::from(0);

#pragma unroll 1
    for (int j0 = 0; j0 < D; j0 += DJ) {
      const int nd = D - j0 < DJ ? D - j0 : DJ;
      if (j0 > 0) __syncthreads();  // the last pass's digits have been read
      fwd_ntt<C, C::T>(S * nd, tw_f, TrDigits<C>{sm + C::OFF_ACC, gi, j0, nd, w1, w2},
                       digits, digits);
      // multiply-accumulate with the key row of the round, lazily
      const W* row = key + ((size_t)round * D + j0) * 2 * N;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        if (jj < nd) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const int k = (g * C::T + tid) * VEC;
            W dv[S][VEC];
#pragma unroll
            for (int s = 0; s < S; ++s)
#pragma unroll
              for (int v = 0; v < VEC; ++v)
                dv[s][v] = sm[C::OFF_DIG + (s * nd + jj) * C::NP + C::pad(k + v)];
#pragma unroll
            for (int o = 0; o < 2; ++o) {
              const ulonglong2 kv =
                  __ldg(reinterpret_cast<const ulonglong2*>(row + (jj * 2 + o) * N + k));
#pragma unroll
              for (int s = 0; s < S; ++s) {
                Wide::mac(sum[g][s][o][0], dv[s][0], kv.x);
                Wide::mac(sum[g][s][o][1], dv[s][1], kv.y);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the digits have been read: their buffer is free

    // the two product polynomials of each message in the base order, and
    // sigma(acc_b) parked behind them
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const int k = (g * C::T + tid) * VEC + v;
#pragma unroll
        for (int s = 0; s < S; ++s) {
#pragma unroll
          for (int o = 0; o < 2; ++o)
            sm[C::OFF_DIG + (s * 2 + o) * C::NP + C::pad(k)] =
                Wide::template reduce<C::MAC_TERM_BITS>(sum[g][s][o][v]);
          sm[C::OFF_PARK + s * C::NP + C::pad(k)] =
              automorphed<C>(sm + C::OFF_ACC + (s * 2 + 1) * C::NP, gi, k);
        }
      }
    __syncthreads();
    inv_ntt<C, C::T>(S * 2, tw_i, n_inv, n_inv_sh, digits, digits,
                     TrUpdate<C>{sm + C::OFF_ACC, sm + C::OFF_PARK});
  }

  for (int k = tid; k < S * 2 * N; k += C::T) {
    const int s = k / (2 * N);
    const int r = k % (2 * N);
    if (s < n_valid)
      acc_out[(msg0 + s) * 2 * N + r] =
          (i64)sm[C::OFF_ACC + (s * 2 + r / N) * C::NP + C::pad(r % N)];
  }
}
