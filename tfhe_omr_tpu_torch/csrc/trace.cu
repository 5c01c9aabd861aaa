// Homomorphic trace (EvalTr): all rounds of S messages in one thread block.
//
// Replaces the Pallas kernel FusedTrace._make_trace_call
// (tfhe_omr_tpu/ops/pallas_fused.py:1765); the plain version is
// ops/bootstrap.py make_trace. One kernel template (trace.cuh) with ring,
// field and gadget as template parameters, on the NTT passes that the
// blind rotation uses (ntt_passes.cuh).
//
// Per round r (Galois element g = N / 2^r + 1), for each message:
//   1. the automorphism sigma_g and the exact base-4 digit of the
//      automorphed a-part are taken on the way into the first forward NTT
//      pass: point k of digit j is (x >> 2j) & 3 with x = +-acc_a[m mod N],
//      m = g^{-1} k mod 2N, negated where m >= N. No table, no second
//      buffer: one 32-bit multiply gives index and sign;
//   2. forward-NTT DJ digit polynomials a pass, 2^RLOG points per thread in
//      registers, butterflies that reduce nothing, twiddles regrouped per
//      pass in shared memory. The digits are below 4, so the first stage's
//      product with its one twiddle w is a select among {0, w, 2w, 3w};
//   3. multiply-accumulate with the key row (r, j): the products of a slot
//      are summed in 128 bits over all d digits of the round and reduced
//      once (d x 23 q x q < 2^110), so the key carries no Shoup companions;
//      each key word is read once per block through the read-only cache;
//   4. inverse-NTT the two product polynomials; the last pass leaves
//      acc_a -= pc_a and acc_b += sigma_g(acc_b) - pc_b. sigma_g(acc_b)
//      gathers acc_b from itself, so it is parked in the digit buffer
//      (free once the products are summed) before any of acc_b changes.
// Results are canonical residues: bit-equal to the plain version.
//
// Shared memory (words): acc S x 2 x NP | digits S x max(DJ, 3) x NP |
// forward twiddles beside their companions, NP = N + N / 16. Reference
// ring: S = 1, T = 512, DJ = 8 (three passes of eight digits and one of
// one), RLOG = 4: 206,832 bytes, 20 barriers a round.
//
// What bounds it: the integer work. Bytes (each input once) are the 9 MB
// key and 32 KB a message; per message and round 25 forward and 2 inverse
// 2048-point transforms (10 int32 multiplies a butterfly) and 102,400 key
// products (4 each). Ragged batches: messages beyond n_msgs are loaded as
// zeros and not stored. Several keys (one a recipient), one after another:
// messages k per_key .. (k + 1) per_key - 1 take key k, and a block never
// straddles two keys (blind_rotate.cu has the same scheme).
#include "trace.cuh"

//                 W    logN  d   logB  q                    S  T    DJ RLOG
typedef TrConfig<u64, 11, 25, 2, 1125899906826241ull, 1, 512, 8, 4> TrRef;
// the small test preset (core/params.py OmrParameters.tiny)
typedef TrConfig<u64, 9, 19, 2, 274877905921ull, 1, 128, 2, 3> TrTiny;

struct TrArgs {
  const int64_t* acc_in;
  int64_t* acc_out;
  int64_t n_msgs;
  int rounds;
  const int* ginv;
  const void* key;
  const void* tw_fwd;
  const void* tw_inv;
  uint64_t n_inv, n_inv_sh;
  int log_n, d, log_b;
  int64_t q;
  void* stream;
  int64_t per_key;
};

template <class C>
static bool matches(int log_n, int64_t q, int d, int log_b) {
  return log_n == C::LOG_N && (u64)q == C::F::Q && d == C::D && log_b == C::LOG_B;
}

template <class C>
static int launch(const TrArgs& a) {
  typedef typename C::W W;
  cudaError_t err = allow_smem(trace_kernel<C>, C::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (a.per_key < 1 || a.n_msgs % a.per_key) return (int)cudaErrorInvalidValue;
  const int64_t blocks = a.n_msgs / a.per_key * ((a.per_key + C::S - 1) / C::S);
  if (blocks > INT32_MAX || a.rounds < 0) return (int)cudaErrorInvalidValue;
  OMR_LAUNCH(trace_kernel<C>, (unsigned)blocks, C::T, C::SMEM_BYTES, a.stream,
             (const i64*)a.acc_in, (i64*)a.acc_out, (long long)a.n_msgs, a.rounds,
             a.ginv, (const W*)a.key, (const W*)a.tw_fwd, (const W*)a.tw_inv,
             (W)a.n_inv, (W)a.n_inv_sh, (long long)a.per_key);
  return (int)cudaGetLastError();
}

// The layout constants of the instantiation for (log_n, q, d, log_b):
// out = {S, DJ, RLOG, word bytes, TW_FWD, TW_INV}; non-zero if there is none.
extern "C" int omr_trace_config(int log_n, int64_t q, int d, int log_b, int* out) {
#define OMR_TR_TRY(C)                                                            \
  if (matches<C>(log_n, q, d, log_b)) {                                          \
    out[0] = C::S; out[1] = C::DJ; out[2] = C::RLOG; out[3] = (int)sizeof(C::W); \
    out[4] = C::TW_FWD; out[5] = C::TW_INV;                                      \
    return 0;                                                                    \
  }
  OMR_TR_TRY(TrRef)
  OMR_TR_TRY(TrTiny)
#undef OMR_TR_TRY
  return (int)cudaErrorInvalidValue;
}

// acc (n_msgs, 2, N) int64 coefficient domain; ginv (rounds) int32; key
// (n_msgs / per_key, rounds, d, 2, N) one after another, tw_fwd, tw_inv in the
// instantiation's word, laid out by the constants omr_trace_config reports;
// exact base-2^log_b digits; per_key the messages of a key (it divides
// n_msgs; n_msgs with one key).
extern "C" int omr_trace(const int64_t* acc_in, int64_t* acc_out, int64_t n_msgs,
                         int rounds, const int* ginv, const void* key,
                         const void* tw_fwd, const void* tw_inv, uint64_t n_inv,
                         uint64_t n_inv_sh, int log_n, int64_t q, int d, int log_b,
                         void* stream, int64_t per_key) {
  const TrArgs a{acc_in, acc_out, n_msgs, rounds, ginv, key, tw_fwd, tw_inv,
                 n_inv, n_inv_sh, log_n, d, log_b, q, stream, per_key};
  if (matches<TrRef>(log_n, q, d, log_b)) return launch<TrRef>(a);
  if (matches<TrTiny>(log_n, q, d, log_b)) return launch<TrTiny>(a);
  return (int)cudaErrorInvalidValue;
}
