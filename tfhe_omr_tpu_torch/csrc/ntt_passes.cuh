// The negacyclic NTT of every kernel of the port: register-blocked passes
// over polynomials in shared memory.
//
// A transform of N = 2^LOG_N points runs as ceil(LOG_N / RLOG) passes with a
// block barrier between them. In a pass a thread holds the 2^R points of
// one batch in registers and runs R radix-2 stages on them; the twiddles
// are regrouped per pass, each beside its word-size Shoup companion
// (ops/fused.py pass_twiddles, shoup_companion). Where a pass takes its
// points from and where it leaves them is the caller's: a source and a
// sink, so the first pass can take gadget digits of an accumulator or a row
// from device memory on the way in, and the last can add into an
// accumulator or write a permuted row on the way out.
//
// Forward: Cooley-Tukey, natural order in, radix-2 ("base") order out, the
// butterflies of ops/ntt.py _fwd_base without any reduction: a butterfly
// (u, v) -> (u + y, u - y + 2Q) with y = v w in [0, 2Q) lets its outputs
// grow by 2Q a stage, below NTT_GROWTH * Q at the end. Inverse:
// Gentleman-Sande, base order in, natural order out, 1/N folded into the
// last stage as in _inv_base; values stay in [0, 2Q) between stages.
#pragma once

#include "field.cuh"

// Stages of NTT pass p when every pass takes rlog stages but the last.
static __host__ __device__ constexpr int ntt_pass_stages(int log_n, int rlog, int p) {
  return (p + 1) * rlog <= log_n ? rlog : log_n - p * rlog;
}
// Start of pass p in the regrouped forward / inverse twiddle tables
// (ops/fused.py pass_twiddles): pass p has (2^r - 1) entries for each
// value of the batch's high index bits.
static __host__ __device__ constexpr int ntt_fwd_offset(int log_n, int rlog, int p) {
  return p == 0 ? 0
                : ntt_fwd_offset(log_n, rlog, p - 1) +
                      (((1 << ntt_pass_stages(log_n, rlog, p - 1)) - 1) << ((p - 1) * rlog));
}
static __host__ __device__ constexpr int ntt_inv_offset(int log_n, int rlog, int p) {
  return p == 0 ? 0
                : ntt_inv_offset(log_n, rlog, p - 1) +
                      (((1 << ntt_pass_stages(log_n, rlog, p - 1)) - 1)
                       << (log_n - (p - 1) * rlog - ntt_pass_stages(log_n, rlog, p - 1)));
}

// Ring, field and pass shape of one transform.
template <typename W_, int LOG_N_, u64 Q_, int RLOG_>
struct NttPlan {
  typedef W_ W;
  typedef WordField<W_, Q_> F;
  static constexpr int LOG_N = LOG_N_, N = 1 << LOG_N_, RLOG = RLOG_;
  // one pad word every 32 (64-bit: every 16) keeps the passes off
  // shared-memory bank conflicts
  static constexpr int PAD_SHIFT = sizeof(W) == 4 ? 5 : 4;
  static constexpr int NP = N + (N >> PAD_SHIFT);
  static constexpr int PASSES = (LOG_N + RLOG - 1) / RLOG;
  // what a lazy forward transform of canonical points stays below, in Q
  static constexpr int NTT_GROWTH = 2 * LOG_N + 1;
  static_assert((u64)NTT_GROWTH <= (~0ull >> (64 - F::WBITS)) / Q_, "lazy NTT overflows the word");

  static __host__ __device__ constexpr int pass_stages(int p) { return ntt_pass_stages(LOG_N, RLOG, p); }
  static __host__ __device__ constexpr int fwd_offset(int p) { return ntt_fwd_offset(LOG_N, RLOG, p); }
  static __host__ __device__ constexpr int inv_offset(int p) { return ntt_inv_offset(LOG_N, RLOG, p); }
  static constexpr int TW_FWD = ntt_fwd_offset(LOG_N, RLOG, PASSES);  // entries per table
  static constexpr int TW_INV = ntt_inv_offset(LOG_N, RLOG, PASSES);

  static __device__ __forceinline__ int pad(int p) { return p + (p >> PAD_SHIFT); }
};

// ------------------------------------------------------- twiddle tables
// A regrouped table in shared memory, or in device memory behind the
// read-only cache.
template <typename W>
struct SharedTable {
  const Operand<W>* p;
  __device__ __forceinline__ Operand<W> operator()(int t) const { return p[t]; }
  __device__ __forceinline__ SharedTable from(int offset) const { return SharedTable{p + offset}; }
};
template <typename W>
struct CachedTable {
  const Operand<W>* p;
  __device__ __forceinline__ Operand<W> operator()(int t) const { return ldg_operand(p + t); }
  __device__ __forceinline__ CachedTable from(int offset) const { return CachedTable{p + offset}; }
};

// ---------------------------------------------------- sources and sinks
// A source has at(poly).load(k), a sink at(poly).store(k, v), k the index of
// the point in its polynomial. Padded polynomials one after another in
// shared memory are both.
template <class P>
struct PolyBuffer {
  typedef typename P::W W;
  static constexpr bool SMALL_DIGITS = false;
  W* base;
  struct At {
    W* d;
    __device__ __forceinline__ W load(int k) const { return d[P::pad(k)]; }
    __device__ __forceinline__ void store(int k, W v) const { d[P::pad(k)] = v; }
  };
  __device__ __forceinline__ At at(int poly) const { return At{base + poly * P::NP}; }
};

// ------------------------------------------------------------- NTT passes
// Forward stages [S0, S0 + R) on `polys` polynomials, T threads. A source
// with SMALL_DIGITS hands out points below 4 and multiplies them by the one
// twiddle of stage 0 itself (times_first_twiddle: a select, no product).
template <class P, int T, int S0, int R, class Tw, class In, class Out>
static __device__ __forceinline__ void fwd_pass(int polys, Tw tw, In in, Out out) {
  typedef typename P::W W;
  typedef typename P::F F;
  constexpr int LOW = P::LOG_N - S0 - R;
  constexpr int LOG_NB = P::LOG_N - R;  // batches per polynomial
  constexpr int PTS = 1 << R;
  for (int task = threadIdx.x; task < (polys << LOG_NB); task += T) {
    const int poly = task >> LOG_NB;
    const int b = task & ((1 << LOG_NB) - 1);
    const int l = b & ((1 << LOW) - 1);
    const int h = b >> LOW;
    const int base = (h << (P::LOG_N - S0)) + l;
    const auto src = in.at(poly);
    const auto dst = out.at(poly);
    W x[PTS];
#pragma unroll
    for (int i = 0; i < PTS; ++i) x[i] = src.load(base + (i << LOW));
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int half = 1 << (R - 1 - k);
#pragma unroll
      for (int i = 0; i < PTS; ++i) {
        if (i & half) continue;
        const int t = ((1 << k) - 1 + (i >> (R - k))) * (1 << S0) + h;
        W y;
        bool selected = false;
        if constexpr (In::SMALL_DIGITS && S0 == 0) {
          if (k == 0) {
            y = src.times_first_twiddle(x[i + half]);
            selected = true;
          }
        }
        if (!selected) {
          const Operand<W> w = tw(t);
          y = F::mul_shoup_lazy(x[i + half], w.w, w.sh);
        }
        const W u = x[i];
        x[i] = u + y;
        x[i + half] = u + ((W)(2 * F::Q) - y);
      }
    }
#pragma unroll
    for (int i = 0; i < PTS; ++i) dst.store(base + (i << LOW), x[i]);
  }
}

// Inverse stages with pair stride 2^G0 ... 2^(G0 + R - 1). Points come in
// below 2Q and leave below 2Q (the last pass's sink makes them canonical).
template <class P, int T, int G0, int R, class Tw, class In, class Out>
static __device__ __forceinline__ void inv_pass(int polys, Tw tw, typename P::W n_inv,
                                                typename P::W n_inv_sh, In in, Out out) {
  typedef typename P::W W;
  typedef typename P::F F;
  constexpr int LOG_NB = P::LOG_N - R;
  constexpr int PTS = 1 << R;
  constexpr int HI = 1 << (P::LOG_N - G0 - R);  // values of the high index bits
  for (int task = threadIdx.x; task < (polys << LOG_NB); task += T) {
    const int poly = task >> LOG_NB;
    const int b = task & ((1 << LOG_NB) - 1);
    const int l = b & ((1 << G0) - 1);
    const int h = b >> G0;
    const int base = (h << (G0 + R)) + l;
    const auto src = in.at(poly);
    const auto dst = out.at(poly);
    W x[PTS];
#pragma unroll
    for (int i = 0; i < PTS; ++i) x[i] = src.load(base + (i << G0));
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
        if (G0 + k == P::LOG_N - 1) s = F::mul_shoup_lazy(s, n_inv, n_inv_sh);
        const Operand<W> w = tw(t);
        x[i + step] = F::mul_shoup_lazy(u + ((W)(2 * F::Q) - v), w.w, w.sh);
        x[i] = s;
      }
    }
#pragma unroll
    for (int i = 0; i < PTS; ++i) dst.store(base + (i << G0), x[i]);
  }
}

// All passes of one transform, a block barrier after each: the first takes
// its points from `in`, the last leaves them in `out`, those between work
// in `mid`.
template <class P, int T, int PASS = 0, class Tw, class In, class Mid, class Out>
static __device__ __forceinline__ void fwd_ntt(int polys, Tw tw, In in, Mid mid, Out out) {
  if constexpr (PASS < P::PASSES) {
    constexpr int S0 = PASS * P::RLOG, R = P::pass_stages(PASS);
    const Tw t = tw.from(P::fwd_offset(PASS));
    if constexpr (P::PASSES == 1) fwd_pass<P, T, S0, R>(polys, t, in, out);
    else if constexpr (PASS == 0) fwd_pass<P, T, S0, R>(polys, t, in, mid);
    else if constexpr (PASS == P::PASSES - 1) fwd_pass<P, T, S0, R>(polys, t, mid, out);
    else fwd_pass<P, T, S0, R>(polys, t, mid, mid);
    __syncthreads();
    fwd_ntt<P, T, PASS + 1>(polys, tw, in, mid, out);
  }
}
template <class P, int T, int PASS = 0, class Tw, class In, class Mid, class Out>
static __device__ __forceinline__ void inv_ntt(int polys, Tw tw, typename P::W n_inv,
                                               typename P::W n_inv_sh, In in, Mid mid, Out out) {
  if constexpr (PASS < P::PASSES) {
    constexpr int G0 = PASS * P::RLOG, R = P::pass_stages(PASS);
    const Tw t = tw.from(P::inv_offset(PASS));
    if constexpr (P::PASSES == 1) inv_pass<P, T, G0, R>(polys, t, n_inv, n_inv_sh, in, out);
    else if constexpr (PASS == 0) inv_pass<P, T, G0, R>(polys, t, n_inv, n_inv_sh, in, mid);
    else if constexpr (PASS == P::PASSES - 1) inv_pass<P, T, G0, R>(polys, t, n_inv, n_inv_sh, mid, out);
    else inv_pass<P, T, G0, R>(polys, t, n_inv, n_inv_sh, mid, mid);
    __syncthreads();
    inv_ntt<P, T, PASS + 1>(polys, tw, n_inv, n_inv_sh, in, mid, out);
  }
}
