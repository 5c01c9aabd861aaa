// Device code of the paired blind rotation (see blind_rotate.cu for the
// design note): the configuration, what its NTT passes read and write
// (ntt_passes.cuh) and the kernel template; then the configurations of the
// reference and small rings and their launch.
#pragma once

#include "ntt_passes.cuh"

// sum_{j < d} (B/2) B^j
static __host__ __device__ constexpr u64 br_digit_offset(int log_b, int d) {
  return d == 0 ? 0 : (br_digit_offset(log_b, d - 1) | (1ull << (log_b * d - 1)));
}

// ----------------------------------------------------------------- config
// One instantiation per (ring, field, gadget). S samples per block, T
// threads, DJ digits transformed per pass (DJ divides D), RLOG radix-2
// stages per NTT pass (2^RLOG points per thread in registers), NST ring
// stages of one key plane (N words) each.
template <typename W_, int LOG_N_, int D_, int LOG_B_, u64 Q_, int S_, int T_,
          int DJ_, int RLOG_, int NST_>
struct BrConfig : NttPlan<W_, LOG_N_, Q_, RLOG_> {
  typedef NttPlan<W_, LOG_N_, Q_, RLOG_> Plan;
  typedef W_ W;
  typedef typename Plan::F F;
  typedef WideAcc<F> Wide;
  static constexpr int N = Plan::N, NP = Plan::NP, TW_FWD = Plan::TW_FWD;
  static constexpr int D = D_, LOG_B = LOG_B_;
  static constexpr int S = S_, T = T_, DJ = DJ_, NST = NST_;
  static constexpr bool PROFILED = false;     // see BrProfiled
  static constexpr bool PLANE_STAMPS = false;  // see BrProfiled
  static constexpr int CL = 1;                // CTAs a sample's cluster: see BrCluster
  static constexpr int VEC = 2;               // consecutive slots per thread group
  static constexpr int G = N / (VEC * T);     // slot groups per thread
  static constexpr int JP = D / DJ;           // digit passes per step
  static constexpr int PLANES = 12 * D;       // key planes per step
  // gadget (ops/decompose.py, approximate mode)
  static constexpr int SHIFT = F::BITS - D * LOG_B;
  static constexpr int CORR_PRE = cmax(0, F::BITS + F::EPS_BITS - 62);
  static constexpr int CORR_POST = F::BITS - CORR_PRE;
  static constexpr u64 HALF_B = 1ull << (LOG_B - 1);
  static constexpr u64 H = br_digit_offset(LOG_B, D);  // sum_j (B/2) B^j
  static_assert(SHIFT > 0, "the blind rotation gadgets are approximate");
  static_assert(D % DJ == 0 && G * VEC * T == N, "config");
  static_assert(NST >= 4 && (NST & (NST - 1)) == 0, "the ring index is a mask");
  // the forward NTT leaves its outputs below NTT_GROWTH * Q; the
  // multiply-accumulate takes them as they are and sums 2 DJ products and
  // the running row before it reduces
  static constexpr int MAC_TERM_BITS = ceil_log2(2 * DJ * Plan::NTT_GROWTH + 1);

  // shared memory map, in words; the monomial stage's table of psi powers
  // (2N words) goes last, where it fits in what a block may use, and is
  // otherwise read through the read-only cache
  static constexpr int OFF_ACC = 0;
  static constexpr int OFF_DIG = OFF_ACC + S * 2 * NP;
  static constexpr int OFF_TWF = OFF_DIG + S * DJ * 2 * NP;
  static constexpr int OFF_RING = (OFF_TWF + 2 * TW_FWD + 3) / 4 * 4;  // 16-byte aligned
  static constexpr int OFF_MONO = OFF_RING + NST * N;
  static constexpr bool MONO_SHARED = (OFF_MONO + 2 * N) * (int)sizeof(W) <= SMEM_BLOCK_MAX;
  static constexpr int SMEM_WORDS = OFF_MONO + (MONO_SHARED ? 2 * N : 0);
  static constexpr size_t SMEM_BYTES = (size_t)SMEM_WORDS * sizeof(W);

  // Digit j of the balanced signed decomposition of round(x B^D / Q),
  // mapped into [0, Q). With H added, the balanced digits are the plain
  // base-B digits less B/2, so every digit comes from one rounding with no
  // carry chain.
  static __device__ __forceinline__ W rounded_plus_h(W x) {
    // H rides in with the rounding constant: (x + corr + half + (H << SHIFT))
    // >> SHIFT, all inside the word
    constexpr u64 ADD = (1ull << (SHIFT - 1)) + (H << SHIFT);
    static_assert(bit_length(ADD) + 1 < F::WBITS, "rounding overflows the word");
    if constexpr (sizeof(W) == 4) {
      // (x EPS) >> BITS as the high word of (x << (32 - BITS)) * EPS
      static_assert(CORR_PRE == 0, "32-bit rounding");
      const W corr = __umulhi(x << (32 - F::BITS), (W)F::EPS);
      return (x + corr + (W)ADD) >> SHIFT;
    } else {
      const u64 corr = ((x >> CORR_PRE) * F::EPS) >> CORR_POST;
      return (x + corr + ADD) >> SHIFT;
    }
  }
  static __device__ __forceinline__ W digit(W uh, int j) {
    const int dj = (int)((uh >> (LOG_B * j)) & (W)((1u << LOG_B) - 1)) - (int)HALF_B;
    return dj < 0 ? (W)Q_ - (W)(-dj) : (W)dj;
  }
};

// ---------------------------------------------------------- clusters
// The cluster variant of a one-sample configuration K: a sample is served
// by a cluster of CL CTAs, CTA rank j taking the key's digits
// j DPC .. (j + 1) DPC - 1, DJ of them a pass (a BrConfig of its own
// digit buffer), and its 12 DPC key planes a step from K's key layout.
// The kernel sums the CTAs' partial products over the cluster before the
// inverse transforms (blind_rotate.cu, "Clusters").
template <class K, int CL_, int DJ_>
struct BrCluster : BrConfig<typename K::W, K::LOG_N, K::D, K::LOG_B, K::F::Q, 1, K::T, DJ_,
                            K::RLOG, K::NST> {
  static constexpr int CL = CL_;
  static constexpr int D = K::D, DJ = DJ_;
  static constexpr int DPC = D / CL;              // digits of a CTA
  static constexpr int JP = DPC / DJ;             // digit passes a step of a CTA
  static constexpr int KEY_DJ = K::DJ, KEY_JP = D / KEY_DJ;  // the key's layout
  static constexpr int CTA_PLANES = 12 * DPC;     // key planes a step of a CTA
  static_assert(K::S == 1 && CL >= 2 && CL <= 8 && D % CL == 0 && DPC % DJ == 0, "cluster");
  // plane l of the CTA's own consumption order (step, pass, row, digit of
  // the pass, in, out) -> its plane in a key of K's layout (step, pass,
  // row, digit of the pass, in, out)
  static __device__ __forceinline__ int key_plane(int l, int rank) {
    const int co = l & 3;
    int t = l >> 2;
    const int jj = t % DJ;
    t /= DJ;
    const int r = t % 3;
    t /= 3;
    const int jp = t % JP, step = t / JP;
    const int j = rank * DPC + jp * DJ + jj;
    return (((step * KEY_JP + j / KEY_DJ) * 3 + r) * KEY_DJ + j % KEY_DJ) * 4 + co;
  }
};

// ------------------------------------------------------ profiled steps
// The stages of a CMUX step that a profiled instantiation times apart: the
// digit and forward passes (BrDigits into fwd_ntt, its own barriers
// included); the key staging (the cp.async wait for a plane, its reads from
// the ring, the next plane's copy); the multiply-accumulate; the monomial
// stage; the inverse passes and the accumulate (BrAccumulate, their
// barriers included); the step loop's own barriers. ops/fused.py BR_STAGES
// names them in this order.
enum BrStage { BR_DIGITS_FWD, BR_STAGING, BR_MAC, BR_MONOMIAL, BR_INV_ACC, BR_BARRIER, BR_STAGES };

// A configuration whose kernel reads clock64() at every stage boundary of
// every step, in thread 0 of each block, and adds each delta to its block's
// row of br_stage_clocks (blocks, BR_STAGES). Thread 0's view: a stage's
// time is from the end of the stage before it to thread 0's end of this one,
// so where the other threads lag, the barrier that waits for them shows it.
// The stamps cost time of their own (two a key plane inside the
// multiply-accumulate): benches/probe_step_torch.py prints the production
// kernel's time beside the profiled one's. (A stamp in every thread, with
// only thread 0's add predicated, cost more.) With PLANES false the two
// stamps a key plane are left out: the key staging is then counted in
// BR_MAC (BR_STAGING stays 0), and a digit pass has one stamp around its
// whole multiply-accumulate, so the other stages are less disturbed. The
// production configurations have PROFILED false, and every stamp below is
// a no-op for them: their code is the same as without this.
template <class C, bool PLANES = true>
struct BrProfiled : C {
  static constexpr bool PROFILED = true;
  static constexpr bool PLANE_STAMPS = PLANES;
};

// The clocks buffer of the profiled launch in flight on this device.
static __device__ long long* br_stage_clocks;

template <bool ON>
struct StageClock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void lap(int) {}
};
template <>
struct StageClock<true> {
  long long last;
  unsigned long long* row;
  __device__ __forceinline__ void start() {
    if (threadIdx.x == 0) {
      row = reinterpret_cast<unsigned long long*>(br_stage_clocks) + (size_t)blockIdx.x * BR_STAGES;
      last = clock64();
    }
  }
  __device__ __forceinline__ void lap(int stage) {
    if (threadIdx.x == 0) {
      const long long now = clock64();
      atomicAdd(row + stage, (unsigned long long)(now - last));  // RED: nothing waits
      last = now;
    }
  }
};

// ------------------------------------------------- sources and sinks
// What the first forward pass reads: digit j0 + jj of the rounded
// accumulator, polynomial (s, jj, c) of the digit buffer from acc (s, c).
template <class C>
struct BrDigits {
  typedef typename C::W W;
  static constexpr bool SMALL_DIGITS = false;
  const W* acc;
  int j0;
  struct At {
    const W* a;
    int j;
    __device__ __forceinline__ W load(int k) const {
      return C::digit(C::rounded_plus_h(a[C::pad(k)]), j);
    }
  };
  __device__ __forceinline__ At at(int poly) const {
    const int c = poly & 1;
    const int jj = (poly >> 1) % C::DJ;
    const int s = (poly >> 1) / C::DJ;
    return At{acc + (s * 2 + c) * C::NP, j0 + jj};
  }
};

// The two polynomials per sample that the monomial stage left at the head
// of the sample's digit buffer.
template <class C>
struct BrProducts {
  typedef typename C::W W;
  W* dig;
  __device__ __forceinline__ typename PolyBuffer<C>::At at(int poly) const {
    return typename PolyBuffer<C>::At{dig + ((poly >> 1) * C::DJ * 2 + (poly & 1)) * C::NP};
  }
};

// Where the last inverse pass leaves them: added into the accumulator.
template <class C>
struct BrAccumulate {
  typedef typename C::W W;
  typedef typename C::F F;
  W* acc;
  struct At {
    W* a;
    __device__ __forceinline__ void store(int k, W v) const {
      const int p = C::pad(k);
      a[p] = F::add(a[p], F::canonical(v));
    }
  };
  __device__ __forceinline__ At at(int poly) const { return At{acc + poly * C::NP}; }
};

// ----------------------------------------------------------------- kernel
// acc (n_msgs, 2, N) int64; amounts (2 n_steps, n_msgs) int64 in [0, 2N);
// key (n_msgs / per_key, n_steps, D/DJ, 3, DJ, 2, 2, N) words in the base
// slot order: samples k per_key .. k per_key + per_key - 1 take key k (one
// key: per_key = n_msgs);
// mono (2N) words psi^e - 1 (copied to shared memory where the
// configuration has room, C::MONO_SHARED); orders (N) int32 base orders;
// tw_fwd / tw_inv: per-pass twiddles, each followed by its companion.
// A cluster configuration (C::CL > 1, S = 1) runs as clusters of CL CTAs,
// cluster i serving sample i (blind_rotate.cu, "Clusters").
template <class C>
__global__ void __launch_bounds__(C::T, 1) blind_rotate_kernel(
    const i64* __restrict__ acc_in, i64* __restrict__ acc_out,
    const i64* __restrict__ amounts, long long n_msgs, int n_steps,
    const typename C::W* __restrict__ key, const typename C::W* __restrict__ mono,
    const int* __restrict__ orders, const typename C::W* __restrict__ tw_fwd,
    const typename C::W* __restrict__ tw_inv, typename C::W n_inv,
    typename C::W n_inv_sh, long long per_key) {
  typedef typename C::W W;
  typedef typename C::F F;
  typedef typename C::Wide Wide;
  typedef typename Wide::T WideT;
  constexpr int N = C::N, S = C::S, G = C::G, VEC = C::VEC, DJ = C::DJ, NST = C::NST;
  constexpr int CL = C::CL;
  constexpr int TWO_N_MASK = 2 * N - 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* sm = reinterpret_cast<W*>(OMR_CTA_SMEM(smem_raw));
  W* ring = sm + C::OFF_RING;
  const SharedTable<W> tw_f{reinterpret_cast<const Operand<W>*>(sm + C::OFF_TWF)};
  const CachedTable<W> tw_i{reinterpret_cast<const Operand<W>*>(tw_inv)};
  const PolyBuffer<C> digits{sm + C::OFF_DIG};
  const int tid = threadIdx.x;
  // the block's samples: S of one key's per_key, from sample msg0 on; the
  // last block of a key masks those beyond the key's, so a block never
  // straddles two keys. With one key (per_key == n_msgs) this is block
  // b's samples b S .. b S + S - 1. A cluster takes the place of a block
  // (its one sample) and its CTAs are told apart by their rank.
  unsigned rank = 0;
  if constexpr (CL > 1) rank = cluster_ctarank();
  const unsigned unit = blockIdx.x / CL;
  const long long key_blocks = (per_key + S - 1) / S;
  const int key_index = (int)(unit / key_blocks);
  const long long key_lo = (unit - key_index * key_blocks) * S;
  const long long msg0 = key_index * per_key + key_lo;
  const int n_valid = per_key - key_lo < S ? (int)(per_key - key_lo) : S;

  // key pipeline: each thread stages, for itself, the VEC slots of its G
  // groups of every plane of its block's key (the stacked keys' planes
  // first_plane .. end_plane - 1), NST - 2 planes ahead of their use; a
  // CTA of a cluster its CTA_PLANES of each step's, counted from
  // first_plane in the order it consumes them
  const int first_plane = key_index * n_steps * C::PLANES;
  int end_plane = first_plane + n_steps * C::PLANES;
  if constexpr (CL > 1) end_plane = first_plane + n_steps * C::CTA_PLANES;
  int produced = first_plane, consumed = first_plane;
  auto stage_next = [&]() {
    if (produced < end_plane) {
      const W* src = key + (size_t)produced * N;
      if constexpr (CL > 1)
        src = key + (size_t)(first_plane + C::key_plane(produced - first_plane, rank)) * N;
      W* dst = ring + (produced & (NST - 1)) * N;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int k = (g * C::T + tid) * VEC;
        cp_async<VEC * sizeof(W)>(dst + k, src + k);
      }
    }
    cp_async_commit();
    ++produced;
  };
  for (int i = 0; i < NST - 2; ++i) stage_next();

  for (int k = tid; k < 2 * C::TW_FWD; k += C::T) sm[C::OFF_TWF + k] = tw_fwd[k];
  if constexpr (C::MONO_SHARED)
    for (int k = tid; k < 2 * N; k += C::T) sm[C::OFF_MONO + k] = mono[k];
  for (int k = tid; k < S * 2 * N; k += C::T) {
    const int s = k / (2 * N);
    const int r = k % (2 * N);
    const bool valid = s < n_valid;
    sm[C::OFF_ACC + (s * 2 + r / N) * C::NP + C::pad(r % N)] =
        valid ? (W)acc_in[(msg0 + s) * 2 * N + r] : (W)0;
  }
  int ord[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int v = 0; v < VEC; ++v) ord[g][v] = orders[(g * C::T + tid) * VEC + v];
  __syncthreads();
  StageClock<C::PROFILED> clk;
  clk.start();

  for (int step = 0; step < n_steps; ++step) {
    W p[G][S][3][2][VEC];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int o = 0; o < 2; ++o)
#pragma unroll
            for (int v = 0; v < VEC; ++v) p[g][s][r][o][v] = 0;

#pragma unroll 1
    for (int jp = 0; jp < C::JP; ++jp) {
      if (jp > 0) {
        __syncthreads();  // the last pass's digits have been read
        clk.lap(BR_BARRIER);
      }
      int j0 = jp * DJ;
      if constexpr (CL > 1) j0 += rank * C::DPC;
      fwd_ntt<C, C::T>(S * DJ * 2, tw_f, BrDigits<C>{sm + C::OFF_ACC, j0}, digits, digits);
      clk.lap(BR_DIGITS_FWD);
      // multiply-accumulate against the three RGSW rows, lazily: one
      // reduction per (row, output) and pass
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        WideT acc[G][S][2][VEC];
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int s = 0; s < S; ++s)
#pragma unroll
            for (int o = 0; o < 2; ++o)
#pragma unroll
              for (int v = 0; v < VEC; ++v) acc[g][s][o][v] = Wide::from(p[g][s][r][o][v]);
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            W dv[G][S][VEC];
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
              for (int s = 0; s < S; ++s)
#pragma unroll
                for (int v = 0; v < VEC; ++v)
                  dv[g][s][v] = sm[C::OFF_DIG + ((s * DJ + jj) * 2 + c) * C::NP +
                                   C::pad((g * C::T + tid) * VEC + v)];
#pragma unroll
            for (int o = 0; o < 2; ++o) {
              if constexpr (C::PLANE_STAMPS) clk.lap(BR_MAC);
              cp_async_wait<NST - 3>();
              const W* plane = ring + (consumed & (NST - 1)) * N;
              W kv[G][VEC];
#pragma unroll
              for (int g = 0; g < G; ++g)
#pragma unroll
                for (int v = 0; v < VEC; ++v) kv[g][v] = plane[(g * C::T + tid) * VEC + v];
              ++consumed;
              stage_next();
              if constexpr (C::PLANE_STAMPS) clk.lap(BR_STAGING);
#pragma unroll
              for (int g = 0; g < G; ++g)
#pragma unroll
                for (int s = 0; s < S; ++s)
#pragma unroll
                  for (int v = 0; v < VEC; ++v) Wide::mac(acc[g][s][o][v], dv[g][s][v], kv[g][v]);
            }
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int s = 0; s < S; ++s)
#pragma unroll
            for (int o = 0; o < 2; ++o)
#pragma unroll
              for (int v = 0; v < VEC; ++v)
                p[g][s][r][o][v] =
                    Wide::template reduce<C::MAC_TERM_BITS>(acc[g][s][o][v]);
      }
      clk.lap(BR_MAC);
    }

    // row t times NTT(X^{a_t}) - 1 (a lookup in the psi-power table at
    // a_t * order mod 2N, a_2 = a_0 + a_1), summed over the rows, into the
    // digit buffer. The lookups are gathers at scattered indices: from
    // shared memory one a bank conflict, through the cache one a line the
    // warp touches. The step's amounts are all loaded before the first
    // lookup: loaded a sample at a time beside the shared-memory lookups,
    // they left the first level's step loop 30 spill loads.
    int a0[S], a1[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      // a block of one sample always holds a valid one
      const bool valid = S == 1 || s < n_valid;
      a0[s] = valid ? (int)amounts[(long long)(2 * step) * n_msgs + msg0 + s] : 0;
      a1[s] = valid ? (int)amounts[(long long)(2 * step + 1) * n_msgs + msg0 + s] : 0;
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          WideT t0 = Wide::from(0), t1 = Wide::from(0);
          const int i0 = a0[s] * ord[g][v], i1 = a1[s] * ord[g][v];
          const int idx[3] = {i0, i1, i0 + i1};
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            const int e = idx[r] & TWO_N_MASK;
            W m;
            if constexpr (C::MONO_SHARED) m = sm[C::OFF_MONO + e];
            else m = __ldg(mono + e);
            Wide::mac(t0, p[g][s][r][0][v], m);
            Wide::mac(t1, p[g][s][r][1][v], m);
          }
          const int k = C::pad((g * C::T + tid) * VEC + v);
          sm[C::OFF_DIG + (s * DJ * 2 + 0) * C::NP + k] = Wide::template reduce<2>(t0);
          sm[C::OFF_DIG + (s * DJ * 2 + 1) * C::NP + k] = Wide::template reduce<2>(t1);
        }
      }
    }
    clk.lap(BR_MONOMIAL);
    if constexpr (CL == 1) {
      __syncthreads();
    } else {
      // the CTAs' partial products summed: each CTA sums its share of the
      // 2N (polynomial, slot) pairs over the cluster's digit buffers and
      // writes the sum back into all of them. Residues below Q: CL of them
      // stay below 2^(BITS + 3) and their sum is the one-block product.
      cluster_sync();  // every CTA's partial products are in place
      constexpr int PAIRS = 2 * N;
      W* peer[CL];
#pragma unroll
      for (int r = 0; r < CL; ++r) peer[r] = cluster_map(sm, r);
      for (int i = (int)rank * PAIRS / CL + tid; i < ((int)rank + 1) * PAIRS / CL; i += C::T) {
        const int at = C::OFF_DIG + (i / N) * C::NP + C::pad(i % N);
        W v[CL];
#pragma unroll
        for (int r = 0; r < CL; ++r) v[r] = peer[r][at];
        u64 sum = 0;
#pragma unroll
        for (int r = 0; r < CL; ++r) sum += v[r];
        const W total = F::template reduce64<F::BITS + ceil_log2(CL)>(sum);
#pragma unroll
        for (int r = 0; r < CL; ++r) peer[r][at] = total;
      }
      cluster_sync();  // every sum is in every buffer; no CTA reads a peer's until the next step's
    }
    clk.lap(BR_BARRIER);
    inv_ntt<C, C::T>(S * 2, tw_i, n_inv, n_inv_sh, BrProducts<C>{sm + C::OFF_DIG},
                     BrProducts<C>{sm + C::OFF_DIG}, BrAccumulate<C>{sm + C::OFF_ACC});
    clk.lap(BR_INV_ACC);
  }
  cp_async_wait<0>();
  if constexpr (CL > 1)
    if (rank != 0) return;  // CTA rank 0 writes the cluster's sample

  for (int k = tid; k < S * 2 * N; k += C::T) {
    const int s = k / (2 * N);
    const int r = k % (2 * N);
    if (s < n_valid)
      acc_out[(msg0 + s) * 2 * N + r] =
          (i64)sm[C::OFF_ACC + (s * 2 + r / N) * C::NP + C::pad(r % N)];
  }
}

// ------------------------------------------------------------- launch
// The host side that blind_rotate.cu (the production and small-preset
// instantiations) and blind_rotate_profiled.cu (the profiled ones) share:
// the configurations and one launch of a configuration.
//                 W    logN  d  logB  q                    S  T    DJ RLOG NST
typedef BrConfig<u32, 10, 4, 5, 134215681ull, 4, 512, 4, 5, 8> BrL1;
typedef BrConfig<u64, 11, 6, 7, 1125899906826241ull, 1, 512, 2, 4, 4> BrL2;
// the small test preset (core/params.py OmrParameters.tiny)
typedef BrConfig<u32, 8, 5, 4, 33551873ull, 4, 128, 5, 4, 8> BrTinyL1;
typedef BrConfig<u64, 9, 7, 5, 274877905921ull, 1, 128, 1, 3, 4> BrTinyL2;
// the second levels' cluster variants, one a divisor C of d in 2..8:
//                 K          C  DJ
typedef BrCluster<BrL2, 2, 1> BrL2C2;
typedef BrCluster<BrL2, 3, 2> BrL2C3;
typedef BrCluster<BrL2, 6, 1> BrL2C6;
typedef BrCluster<BrTinyL2, 7, 1> BrTinyL2C7;

struct BrArgs {
  const int64_t* acc_in;
  int64_t* acc_out;
  const int64_t* amounts;
  int64_t n_msgs;
  int n_steps;
  const void* key;
  const void* mono;
  const int* orders;
  const void* tw_fwd;
  const void* tw_inv;
  uint64_t n_inv, n_inv_sh;
  int log_n, d, log_b;
  int64_t q;
  int blocks;
  void* stream;
  int64_t per_key;
};

template <class C>
static bool matches(const BrArgs& a) {
  return a.log_n == C::LOG_N && a.d == C::D && a.log_b == C::LOG_B && (u64)a.q == C::F::Q;
}

template <class C>
static int launch(const BrArgs& a) {
  typedef typename C::W W;
  cudaError_t err = allow_smem(blind_rotate_kernel<C>, C::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (a.per_key < 1 || a.n_msgs % a.per_key ||
      a.n_msgs / a.per_key * a.n_steps > INT32_MAX / C::PLANES ||
      (int64_t)a.blocks != a.n_msgs / a.per_key * ((a.per_key + C::S - 1) / C::S) * C::CL)
    return (int)cudaErrorInvalidValue;
  if constexpr (C::CL == 1) {
    OMR_LAUNCH(blind_rotate_kernel<C>, (unsigned)a.blocks, C::T, C::SMEM_BYTES, a.stream,
               (const i64*)a.acc_in, (i64*)a.acc_out, (const i64*)a.amounts,
               (long long)a.n_msgs, a.n_steps, (const W*)a.key, (const W*)a.mono, a.orders,
               (const W*)a.tw_fwd, (const W*)a.tw_inv, (W)a.n_inv, (W)a.n_inv_sh,
               (long long)a.per_key);
  } else {
    err = omr_launch_cluster(blind_rotate_kernel<C>, C::CL, (unsigned)a.blocks, C::T,
                             C::SMEM_BYTES, a.stream, (const i64*)a.acc_in, (i64*)a.acc_out,
                             (const i64*)a.amounts, (long long)a.n_msgs, a.n_steps,
                             (const W*)a.key, (const W*)a.mono, a.orders, (const W*)a.tw_fwd,
                             (const W*)a.tw_inv, (W)a.n_inv, (W)a.n_inv_sh,
                             (long long)a.per_key);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// Clusters of C the card holds at once.
template <class C>
static int cluster_fit(int* n) {
  cudaError_t err = allow_smem(blind_rotate_kernel<C>, C::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  return (int)omr_cluster_fit(blind_rotate_kernel<C>, C::CL, C::T, C::SMEM_BYTES, n);
}
