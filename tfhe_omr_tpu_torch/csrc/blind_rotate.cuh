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

  // shared memory map, in words
  static constexpr int OFF_ACC = 0;
  static constexpr int OFF_DIG = OFF_ACC + S * 2 * NP;
  static constexpr int OFF_TWF = OFF_DIG + S * DJ * 2 * NP;
  static constexpr int OFF_RING = (OFF_TWF + 2 * TW_FWD + 3) / 4 * 4;  // 16-byte aligned
  static constexpr int SMEM_WORDS = OFF_RING + NST * N;
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
// key (n_steps, D/DJ, 3, DJ, 2, 2, N) words in the base slot order;
// mono (2N) words psi^e - 1; orders (N) int32 base orders;
// tw_fwd / tw_inv: per-pass twiddles, each followed by its companion.
template <class C>
__global__ void __launch_bounds__(C::T, 1) blind_rotate_kernel(
    const i64* __restrict__ acc_in, i64* __restrict__ acc_out,
    const i64* __restrict__ amounts, long long n_msgs, int n_steps,
    const typename C::W* __restrict__ key, const typename C::W* __restrict__ mono,
    const int* __restrict__ orders, const typename C::W* __restrict__ tw_fwd,
    const typename C::W* __restrict__ tw_inv, typename C::W n_inv,
    typename C::W n_inv_sh) {
  typedef typename C::W W;
  typedef typename C::F F;
  typedef typename C::Wide Wide;
  typedef typename Wide::T WideT;
  constexpr int N = C::N, S = C::S, G = C::G, VEC = C::VEC, DJ = C::DJ, NST = C::NST;
  constexpr int TWO_N_MASK = 2 * N - 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* sm = reinterpret_cast<W*>(smem_raw);
  W* ring = sm + C::OFF_RING;
  const SharedTable<W> tw_f{reinterpret_cast<const Operand<W>*>(sm + C::OFF_TWF)};
  const CachedTable<W> tw_i{reinterpret_cast<const Operand<W>*>(tw_inv)};
  const PolyBuffer<C> digits{sm + C::OFF_DIG};
  const int tid = threadIdx.x;
  const long long msg0 = (long long)blockIdx.x * S;

  // key pipeline: each thread stages, for itself, the VEC slots of its G
  // groups of every plane, NST - 2 planes ahead of their use
  const int total_planes = n_steps * C::PLANES;
  int produced = 0, consumed = 0;
  auto stage_next = [&]() {
    if (produced < total_planes) {
      const W* src = key + (size_t)produced * N;
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
  for (int k = tid; k < S * 2 * N; k += C::T) {
    const int s = k / (2 * N);
    const int r = k % (2 * N);
    const bool valid = msg0 + s < n_msgs;
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
      fwd_ntt<C, C::T>(S * DJ * 2, tw_f, BrDigits<C>{sm + C::OFF_ACC, jp * DJ}, digits, digits);
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
    // a_t * order mod 2N), summed over the rows, into the digit buffer
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool valid = msg0 + s < n_msgs;
      const int a0 = valid ? (int)amounts[(long long)(2 * step) * n_msgs + msg0 + s] : 0;
      const int a1 = valid ? (int)amounts[(long long)(2 * step + 1) * n_msgs + msg0 + s] : 0;
      const int amt[3] = {a0, a1, a0 + a1};
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          WideT t0 = Wide::from(0), t1 = Wide::from(0);
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            const W m = __ldg(mono + ((amt[r] * ord[g][v]) & TWO_N_MASK));
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
    __syncthreads();
    clk.lap(BR_BARRIER);
    inv_ntt<C, C::T>(S * 2, tw_i, n_inv, n_inv_sh, BrProducts<C>{sm + C::OFF_DIG},
                     BrProducts<C>{sm + C::OFF_DIG}, BrAccumulate<C>{sm + C::OFF_ACC});
    clk.lap(BR_INV_ACC);
  }
  cp_async_wait<0>();

  for (int k = tid; k < S * 2 * N; k += C::T) {
    const int s = k / (2 * N);
    const int r = k % (2 * N);
    if (msg0 + s < n_msgs)
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
  if (((int64_t)a.blocks * C::S) < a.n_msgs || a.n_steps > INT32_MAX / C::PLANES)
    return (int)cudaErrorInvalidValue;
  OMR_LAUNCH(blind_rotate_kernel<C>, (unsigned)a.blocks, C::T, C::SMEM_BYTES, a.stream,
             (const i64*)a.acc_in, (i64*)a.acc_out, (const i64*)a.amounts,
             (long long)a.n_msgs, a.n_steps, (const W*)a.key, (const W*)a.mono, a.orders,
             (const W*)a.tw_fwd, (const W*)a.tw_inv, (W)a.n_inv, (W)a.n_inv_sh);
  return (int)cudaGetLastError();
}
