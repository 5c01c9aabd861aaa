// Device code of the paired blind rotation (see blind_rotate.cu for the
// design note): word-sized field arithmetic, the register-blocked NTT
// passes and the kernel template.
#pragma once

#include "common.cuh"

typedef unsigned int u32;

// ---------------------------------------------------------------- helpers
static __host__ __device__ constexpr int bit_length(u64 v) { return v == 0 ? 0 : 1 + bit_length(v >> 1); }
static __host__ __device__ constexpr int ceil_log2(u64 v) { return bit_length(v - 1); }
static __host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Stages of NTT pass p when every pass takes rlog stages but the last.
static __host__ __device__ constexpr int br_pass_stages(int log_n, int rlog, int p) {
  return (p + 1) * rlog <= log_n ? rlog : log_n - p * rlog;
}
// Start of pass p in the regrouped forward / inverse twiddle tables
// (ops/fused.py pass_twiddles): pass p has (2^r - 1) entries for each
// value of the batch's high index bits.
static __host__ __device__ constexpr int br_fwd_offset(int log_n, int rlog, int p) {
  return p == 0 ? 0
                : br_fwd_offset(log_n, rlog, p - 1) +
                      (((1 << br_pass_stages(log_n, rlog, p - 1)) - 1) << ((p - 1) * rlog));
}
static __host__ __device__ constexpr int br_inv_offset(int log_n, int rlog, int p) {
  return p == 0 ? 0
                : br_inv_offset(log_n, rlog, p - 1) +
                      (((1 << br_pass_stages(log_n, rlog, p - 1)) - 1)
                       << (log_n - (p - 1) * rlog - br_pass_stages(log_n, rlog, p - 1)));
}
// sum_{j < d} (B/2) B^j
static __host__ __device__ constexpr u64 br_digit_offset(int log_b, int d) {
  return d == 0 ? 0 : (br_digit_offset(log_b, d - 1) | (1ull << (log_b * d - 1)));
}

static __device__ __forceinline__ u32 mul_hi(u32 a, u32 b) { return __umulhi(a, b); }
static __device__ __forceinline__ u64 mul_hi(u64 a, u64 b) { return __umul64hi(a, b); }

// A table operand beside its Shoup companion: one vector load brings both.
template <typename W>
struct alignas(2 * sizeof(W)) Operand {
  W w, sh;
};

// The same from global memory through the read-only cache.
static __device__ __forceinline__ Operand<u32> ldg_operand(const Operand<u32>* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  return Operand<u32>{v.x, v.y};
}
static __device__ __forceinline__ Operand<u64> ldg_operand(const Operand<u64>* p) {
  const ulonglong2 v = __ldg(reinterpret_cast<const ulonglong2*>(p));
  return Operand<u64>{v.x, v.y};
}

// A 128-bit sum of 64 x 64 -> 128 bit products.
struct U128 {
  u64 lo, hi;
};

// Asynchronous global -> shared copies (Ampere-style cp.async, enough for
// the 8- and 16-byte pieces a thread stages for itself).
template <int BYTES>
static __device__ __forceinline__ void cp_async(void* smem_dst, const void* gmem_src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(gmem_src), "n"(BYTES) : "memory");
}
static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// ------------------------------------------------------------------ field
// Canonical residues in [0, Q) held in words W (32 bits where 2Q < 2^32,
// else 64). Q = 2^BITS - EPS with a small EPS, so products reduce by
// folding the high part times EPS; multiplication by a table operand is a
// Shoup product with the companion floor(w * 2^WBITS / Q).
template <typename W_, u64 Q_>
struct WordField {
  typedef W_ W;
  static constexpr u64 Q = Q_;
  static constexpr int WBITS = 8 * sizeof(W);
  static constexpr int BITS = bit_length(Q);
  static constexpr u64 EPS = (1ull << BITS) - Q;
  static constexpr int EPS_BITS = bit_length(EPS);
  static constexpr u64 MASK = (1ull << BITS) - 1;
  static_assert(BITS + 2 < WBITS, "4Q must fit the word");

  static __device__ __forceinline__ W add(W a, W b) {
    const W s = a + b;
    const W t = s - (W)Q;  // wraps above s when s < Q
    return s < t ? s : t;
  }
  // a + b for a, b in [0, 2Q), into [0, 2Q)
  static __device__ __forceinline__ W add2(W a, W b) {
    const W s = a + b;
    const W t = s - (W)(2 * Q);
    return s < t ? s : t;
  }
  // [0, 2Q) -> [0, Q)
  static __device__ __forceinline__ W canonical(W a) {
    const W t = a - (W)Q;
    return a < t ? a : t;
  }
  // x * w mod Q for any word x; w_sh = floor(w * 2^WBITS / Q). The lazy
  // form leaves the result in [0, 2Q).
  static __device__ __forceinline__ W mul_shoup_lazy(W x, W w, W w_sh) {
    return x * w - mul_hi(x, w_sh) * (W)Q;
  }
  static __device__ __forceinline__ W mul_shoup(W x, W w, W w_sh) {
    const W r = mul_shoup_lazy(x, w, w_sh);
    const W s = r - (W)Q;
    return r < s ? r : s;
  }
  // v < 2^BOUND -> [0, Q): fold until v < 2^(BITS + 1), then two subtracts
  // (ops/modmath.py PrimeField.reduce).
  template <int BOUND>
  static __device__ __forceinline__ W reduce64(u64 v) {
    constexpr int NB = cmax(BITS, BOUND - BITS + EPS_BITS) + 1;
    if constexpr (NB < BOUND) {
      return reduce64<NB>((v >> BITS) * EPS + (v & MASK));
    } else {
      static_assert(BOUND <= BITS + 1, "fold did not converge");
      v = v >= Q ? v - Q : v;
      v = v >= Q ? v - Q : v;
      return (W)v;
    }
  }
};

// Lazy sums of products: a double-width accumulator per word size.
template <typename F, typename W = typename F::W>
struct WideAcc;

template <typename F>
struct WideAcc<F, u32> {
  typedef u64 T;
  static __device__ __forceinline__ T from(u32 v) { return v; }
  static __device__ __forceinline__ void mac(T& a, u32 x, u32 y) { a += (u64)x * y; }
  // a holds at most 2^TERM_BITS terms, each below 2^(2 BITS)
  template <int TERM_BITS>
  static __device__ __forceinline__ u32 reduce(T a) {
    static_assert(2 * F::BITS + TERM_BITS <= 64, "lazy sum overflows 64 bits");
    return F::template reduce64<2 * F::BITS + TERM_BITS>(a);
  }
};

template <typename F>
struct WideAcc<F, u64> {
  typedef U128 T;
  static __device__ __forceinline__ T from(u64 v) { return U128{v, 0}; }
  static __device__ __forceinline__ void mac(T& a, u64 x, u64 y) {
    const u64 lo = x * y;
    a.lo += lo;
    a.hi += __umul64hi(x, y) + (a.lo < lo ? 1 : 0);
  }
  template <int TERM_BITS>
  static __device__ __forceinline__ u64 reduce(T a) {
    constexpr int B = F::BITS;
    static_assert(2 * B >= 64 && 2 * B + TERM_BITS <= 128, "limb split");
    static_assert(B + F::EPS_BITS <= 64, "a1 * EPS overflows");
    static_assert(64 - B + F::EPS_BITS <= B && TERM_BITS + 2 * F::EPS_BITS <= B, "bound");
    // three limbs of B bits: v = a0 + a1 2^B + a2 2^2B == a0 + a1 EPS + a2 EPS^2
    const u64 a0 = a.lo & F::MASK;
    const u64 a1 = ((a.lo >> B) | (a.hi << (64 - B))) & F::MASK;
    const u64 a2 = a.hi >> (2 * B - 64);
    const u64 w = a1 * F::EPS;
    const u64 w1 = (w >> B) * F::EPS + (w & F::MASK);
    return F::template reduce64<B + 2>(a0 + w1 + a2 * (F::EPS * F::EPS));
  }
};

// ----------------------------------------------------------------- config
// One instantiation per (ring, field, gadget). S samples per block, T
// threads, DJ digits transformed per pass (DJ divides D), RLOG radix-2
// stages per NTT pass (2^RLOG points per thread in registers), NST ring
// stages of one key plane (N words) each.
template <typename W_, int LOG_N_, int D_, int LOG_B_, u64 Q_, int S_, int T_,
          int DJ_, int RLOG_, int NST_>
struct BrConfig {
  typedef W_ W;
  typedef WordField<W_, Q_> F;
  typedef WideAcc<F> Wide;
  static constexpr int LOG_N = LOG_N_, N = 1 << LOG_N_, D = D_, LOG_B = LOG_B_;
  static constexpr int S = S_, T = T_, DJ = DJ_, RLOG = RLOG_, NST = NST_;
  static constexpr int VEC = 2;               // consecutive slots per thread group
  static constexpr int G = N / (VEC * T);     // slot groups per thread
  static constexpr int JP = D / DJ;           // digit passes per step
  static constexpr int PLANES = 12 * D;       // key planes per step
  // one pad word every 32 (64-bit: every 16) keeps the NTT passes off
  // shared-memory bank conflicts
  static constexpr int PAD_SHIFT = sizeof(W) == 4 ? 5 : 4;
  static constexpr int NP = N + (N >> PAD_SHIFT);
  static constexpr int PASSES = (LOG_N + RLOG - 1) / RLOG;
  // gadget (ops/decompose.py, approximate mode)
  static constexpr int SHIFT = F::BITS - D * LOG_B;
  static constexpr int CORR_PRE = cmax(0, F::BITS + F::EPS_BITS - 62);
  static constexpr int CORR_POST = F::BITS - CORR_PRE;
  static constexpr u64 HALF_B = 1ull << (LOG_B - 1);
  static constexpr u64 H = br_digit_offset(LOG_B, D);  // sum_j (B/2) B^j
  static_assert(SHIFT > 0, "the blind rotation gadgets are approximate");
  static_assert(D % DJ == 0 && G * VEC * T == N, "config");
  static_assert(NST >= 4 && (NST & (NST - 1)) == 0, "the ring index is a mask");
  // the forward NTT is lazy: a butterfly (u, v) -> (u + y, u - y + 2Q) with
  // y = v w in [0, 2Q) reduces nothing, so its outputs grow by 2Q a stage
  // and end below NTT_GROWTH * Q; the multiply-accumulate takes them as
  // they are and sums 2 DJ products and the running row before it reduces
  static constexpr int NTT_GROWTH = 2 * LOG_N + 1;
  static constexpr int MAC_TERM_BITS = ceil_log2(2 * DJ * NTT_GROWTH + 1);
  static_assert((u64)NTT_GROWTH <= (~0ull >> (64 - F::WBITS)) / Q_, "lazy NTT overflows the word");

  // twiddle tables, regrouped per pass (ops/fused.py pass_twiddles):
  // forward pass p covers stages [p RLOG, p RLOG + r); entry (t, h) with
  // h < 2^(p RLOG) the high index bits of the batch
  static __host__ __device__ constexpr int pass_stages(int p) { return br_pass_stages(LOG_N, RLOG, p); }
  static __host__ __device__ constexpr int fwd_offset(int p) { return br_fwd_offset(LOG_N, RLOG, p); }
  static __host__ __device__ constexpr int inv_offset(int p) { return br_inv_offset(LOG_N, RLOG, p); }
  static constexpr int TW_FWD = br_fwd_offset(LOG_N, RLOG, PASSES);  // entries per table
  static constexpr int TW_INV = br_inv_offset(LOG_N, RLOG, PASSES);

  // shared memory map, in words
  static constexpr int OFF_ACC = 0;
  static constexpr int OFF_DIG = OFF_ACC + S * 2 * NP;
  static constexpr int OFF_TWF = OFF_DIG + S * DJ * 2 * NP;
  static constexpr int OFF_RING = (OFF_TWF + 2 * TW_FWD + 3) / 4 * 4;  // 16-byte aligned
  static constexpr int SMEM_WORDS = OFF_RING + NST * N;
  static constexpr size_t SMEM_BYTES = (size_t)SMEM_WORDS * sizeof(W);

  static __device__ __forceinline__ int pad(int p) { return p + (p >> PAD_SHIFT); }

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

// ------------------------------------------------------------- NTT passes
// Forward (Cooley-Tukey, natural order in, radix-2 "base" order out: the
// butterflies of ops/ntt.py _fwd_base, unreduced) stages [S0, S0 + R) on every digit
// polynomial of the block; a thread holds the 2^R points of one batch in
// registers. The first pass reads the accumulator and takes digit
// j0 + jj on the way in.
template <class C, int S0, int R>
static __device__ __forceinline__ void fwd_pass(typename C::W* sm, int j0) {
  typedef typename C::W W;
  typedef typename C::F F;
  constexpr int LOW = C::LOG_N - S0 - R;
  constexpr int LOG_NB = C::LOG_N - R;  // batches per polynomial
  constexpr int POLYS = C::S * C::DJ * 2;
  constexpr int PTS = 1 << R;
  const Operand<W>* tw =
      reinterpret_cast<const Operand<W>*>(sm + C::OFF_TWF) + C::fwd_offset(S0 / C::RLOG);
  for (int task = threadIdx.x; task < (POLYS << LOG_NB); task += C::T) {
    const int poly = task >> LOG_NB;
    const int b = task & ((1 << LOG_NB) - 1);
    const int l = b & ((1 << LOW) - 1);
    const int h = b >> LOW;
    const int base = (h << (C::LOG_N - S0)) + l;
    W* d = sm + C::OFF_DIG + poly * C::NP;
    W x[PTS];
    if constexpr (S0 == 0) {
      const int c = poly & 1;
      const int jj = (poly >> 1) % C::DJ;
      const int s = (poly >> 1) / C::DJ;
      const W* a = sm + C::OFF_ACC + (s * 2 + c) * C::NP;
#pragma unroll
      for (int i = 0; i < PTS; ++i)
        x[i] = C::digit(C::rounded_plus_h(a[C::pad(base + (i << LOW))]), j0 + jj);
    } else {
#pragma unroll
      for (int i = 0; i < PTS; ++i) x[i] = d[C::pad(base + (i << LOW))];
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int half = 1 << (R - 1 - k);
#pragma unroll
      for (int i = 0; i < PTS; ++i) {
        if (i & half) continue;
        const int t = ((1 << k) - 1 + (i >> (R - k))) * (1 << S0) + h;
        const Operand<W> w = tw[t];
        const W y = F::mul_shoup_lazy(x[i + half], w.w, w.sh);
        const W u = x[i];
        x[i] = u + y;
        x[i + half] = u + ((W)(2 * F::Q) - y);
      }
    }
#pragma unroll
    for (int i = 0; i < PTS; ++i) d[C::pad(base + (i << LOW))] = x[i];
  }
}

// Inverse (Gentleman-Sande, base order in, natural order out, 1/N folded
// into the last stage as in ops/ntt.py _inv_base; values in [0, 2Q) between
// stages) stages with pair stride
// 2^G0 ... 2^(G0+R-1) on the two polynomials per sample that the monomial
// stage left in the digit buffer. The last pass adds into the accumulator.
template <class C, int G0, int R>
static __device__ __forceinline__ void inv_pass(typename C::W* sm, const typename C::W* tw_inv,
                                                typename C::W n_inv, typename C::W n_inv_sh) {
  typedef typename C::W W;
  typedef typename C::F F;
  constexpr int LOG_NB = C::LOG_N - R;
  constexpr int PTS = 1 << R;
  constexpr int HI = 1 << (C::LOG_N - G0 - R);  // values of the high index bits
  constexpr bool LAST = G0 + R == C::LOG_N;
  const Operand<W>* tw =
      reinterpret_cast<const Operand<W>*>(tw_inv) + C::inv_offset(G0 / C::RLOG);
  for (int task = threadIdx.x; task < ((C::S * 2) << LOG_NB); task += C::T) {
    const int poly = task >> LOG_NB;  // s * 2 + o
    const int b = task & ((1 << LOG_NB) - 1);
    const int l = b & ((1 << G0) - 1);
    const int h = b >> G0;
    const int base = (h << (G0 + R)) + l;
    W* d = sm + C::OFF_DIG + ((poly >> 1) * C::DJ * 2 + (poly & 1)) * C::NP;
    W x[PTS];
#pragma unroll
    for (int i = 0; i < PTS; ++i) x[i] = d[C::pad(base + (i << G0))];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int step = 1 << k;
#pragma unroll
      for (int i = 0; i < PTS; ++i) {
        if (i & step) continue;
        const int t = ((1 << R) - (1 << (R - k)) + (i >> (k + 1))) * HI + h;
        // values stay in [0, 2Q): one conditional subtract a butterfly
        const W u = x[i];
        const W v = x[i + step];
        W s = F::add2(u, v);
        if (G0 + k == C::LOG_N - 1) s = F::mul_shoup_lazy(s, n_inv, n_inv_sh);
        const Operand<W> w = ldg_operand(tw + t);
        x[i + step] = F::mul_shoup_lazy(u + ((W)(2 * F::Q) - v), w.w, w.sh);
        x[i] = s;
      }
    }
    if constexpr (LAST) {
      W* a = sm + C::OFF_ACC + poly * C::NP;
#pragma unroll
      for (int i = 0; i < PTS; ++i) {
        const int p = C::pad(base + (i << G0));
        a[p] = F::add(a[p], F::canonical(x[i]));
      }
    } else {
#pragma unroll
      for (int i = 0; i < PTS; ++i) d[C::pad(base + (i << G0))] = x[i];
    }
  }
}

// All passes of one transform, a block barrier after each.
template <class C, int P = 0>
static __device__ __forceinline__ void fwd_ntt(typename C::W* sm, int j0) {
  if constexpr (P < C::PASSES) {
    fwd_pass<C, P * C::RLOG, C::pass_stages(P)>(sm, j0);
    __syncthreads();
    fwd_ntt<C, P + 1>(sm, j0);
  }
}
template <class C, int P = 0>
static __device__ __forceinline__ void inv_ntt(typename C::W* sm, const typename C::W* tw_inv,
                                               typename C::W n_inv, typename C::W n_inv_sh) {
  if constexpr (P < C::PASSES) {
    inv_pass<C, P * C::RLOG, C::pass_stages(P)>(sm, tw_inv, n_inv, n_inv_sh);
    __syncthreads();
    inv_ntt<C, P + 1>(sm, tw_inv, n_inv, n_inv_sh);
  }
}

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
      if (jp > 0) __syncthreads();  // the last pass's digits have been read
      fwd_ntt<C>(sm, jp * DJ);
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
              cp_async_wait<NST - 3>();
              const W* plane = ring + (consumed & (NST - 1)) * N;
              W kv[G][VEC];
#pragma unroll
              for (int g = 0; g < G; ++g)
#pragma unroll
                for (int v = 0; v < VEC; ++v) kv[g][v] = plane[(g * C::T + tid) * VEC + v];
              ++consumed;
              stage_next();
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
    __syncthreads();
    inv_ntt<C>(sm, tw_inv, n_inv, n_inv_sh);
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
