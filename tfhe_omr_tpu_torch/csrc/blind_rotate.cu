// Paired (BMMP) blind rotation: the whole CMUX chain of S LWE samples in
// one thread block.
//
// Replaces the Pallas kernels FusedBlindRotateL1._make_call (first level,
// N = 1024, q1, B = 2^5, d = 4; tfhe_omr_tpu/ops/pallas_fused.py:436) and
// FusedBlindRotateL2._make_call (second level, N = 2048, q2, B = 2^7, d = 6;
// pallas_fused.py:1218). One kernel template (blind_rotate.cuh) with every
// ring, field and gadget constant a template parameter serves both, on the
// field arithmetic and NTT passes all kernels share (field.cuh,
// ntt_passes.cuh); the plain version is ops/bootstrap.py make_blind_rotate.
//
// Per step s (pair of secret bits), for each sample of the block:
//   1. round the accumulator coefficient and take a gadget digit from it
//      with a shift and a mask (no carry chain), on the way into the forward
//      NTT, DJ digits a pass;
//   2. forward-NTT the 2 DJ digit polynomials, 2^RLOG points per thread in
//      registers, RLOG radix-2 stages between two block barriers, twiddles
//      regrouped per pass in shared memory; the butterflies reduce nothing
//      (outputs grow by 2q a stage and stay inside the word);
//   3. multiply-accumulate against the three RGSW rows [m10, m01, m11]: the
//      products of one (row, output) are summed in a double-width register
//      and reduced once (no Shoup companions for the key);
//   4. multiply row t by NTT(X^{a_t}) - 1, a lookup in the 2N-entry table of
//      psi powers at (a_t * o_k) mod 2N, a_t in [a0, a1, a0 + a1], and sum
//      the rows (again one lazy sum);
//   5. inverse-NTT the two polynomials (values in [0, 2q) between stages,
//      one conditional subtract a butterfly); the last pass adds into acc.
// Results are canonical residues, so they equal the plain version's bit for
// bit whatever the order of the sums.
//
// Words: 32 bits at the first level (q1 < 2^27: __umulhi Shoup products
// with companions at shift 32, 64-bit lazy sums), 64 bits at the second
// (q2 < 2^50: __umul64hi, 128-bit lazy sums). t * q is shifts and a
// subtract because q is a compile-time constant; nothing in the step loop
// divides.
//
// Key: (n_steps, d / DJ, 3, DJ, 2, 2, N) words, the order in which the
// kernel consumes it, slots in the NTT's radix-2 order. Thread t owns
// slots {2 (g T + t), +1}: the only thread that reads those key words, for
// all S samples. It stages them for itself with cp.async into a ring of
// NST planes (N words each) in shared memory, NST - 2 planes ahead, across
// step boundaries, so the key's latency hides behind the NTTs and no
// barrier guards the ring.
//
// Shared memory (words): acc S x 2 x NP | digits S x 2 DJ x NP | forward
// twiddles, each beside its companion | ring NST x N, with NP = N + N / 32
// (one pad word per 32, per 16 at 64 bits, against bank conflicts). The
// inverse twiddles are read through the read-only cache. NST is a power
// of two: the ring index is a mask (a 64-bit `%` there cost 10-25 %).
//   first level:  S = 4, T = 512, DJ = 4 (all digits in one pass), RLOG = 5
//                 (two passes), NST = 8: 209,920 bytes, 5 barriers a step;
//   second level: S = 1, T = 512, DJ = 2, RLOG = 4 (three passes), NST = 4:
//                 202,752 bytes, 15 barriers a step.
// S at the second level: the six row accumulators of a sample are
// 6 x 2048 x 8 = 96 KB of registers, beside its 32 KB accumulator and the
// digit buffer in shared memory, so one SM holds one sample's state; at the
// first level a sample's state is a quarter of that and four samples share
// each key read. Ways to share a key read at the second level that were
// built, were bit-equal and measured slower than this layout's 187.3 ms
// (same card, same run of examples/bench_kernels_torch.py; forward
// twiddles through the read-only cache to make room, which alone costs
// 1.3 %): S = 2 with T = 1024, DJ = 1, RLOG = 3, 255.0 ms (64 registers,
// 584 bytes of spill stores); S = 2 with T = 512, DJ = 1, RLOG = 4,
// 228.6 ms (128 registers, 740 bytes). And a cluster of two blocks sharing
// one key load (each block multiply-accumulates half the slots for both
// samples and reads the other's digits through distributed shared memory):
// 221.9 ms against 209.6 ms for this layout in the same state of the code,
// 208 bytes of spill. The key is served by the L2 cache (a plane is read by
// all resident blocks at about the same time) and the ring hides its
// latency: the key's bytes are not what the kernel waits for.
//
// Ragged batches: samples beyond n_msgs are loaded as zeros and not stored.
//
// What bounds it: the integer work. Bytes (each input once): 0.17 GB and
// 0.43 GB, under 0.2 ms. int32 multiplies at 1.675e13 a second (half the
// float32 lanes): a product with a twiddle or 1/N (Shoup) is 3 of them in
// 32-bit words and 10 in 64-bit ones, a product summed in double width
// before one reduction (key, monomial) 1 and 4; per sample and step 53,248
// + 55,296 products at the first level and 161,792 + 159,744 at the second:
// 23.6 ms and 46.2 ms.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; one session, this kernel and
// the one it replaces each timed by examples/bench_kernels_torch.py
// from its own checkout): first level 7168 samples x 256 steps 99.5 ms
// (1674.1 ms for the kernel this replaces: one sample per block, 64-bit
// lanes, a barrier per radix-2 stage), second level 1024 x 335 steps
// 187.5 ms (908.1 ms): the bound is 24 % and 25 % of the time. What is
// left is the count of integer operations beside the multiplies (adds,
// compares, shifts, address arithmetic, shared-memory accesses share the
// issue slots): every cut of them (lazy butterflies, word-size digit
// rounding, the ring mask) showed in the time.
// Profiled instantiations (BrProfiled<BrL1|BrL2, true|false>, through
// omr_blind_rotate_profiled in blind_rotate_profiled.cu, a source of its own
// so that nvcc builds them beside these): the same template with stage clocks
// (blind_rotate.cuh BrStage) that split a step into digits and forward
// passes, key staging, multiply-accumulate, monomial, inverse passes and
// the step's barriers; benches/probe_step_torch.py reads them. The stamps
// are compiled only into these four, so the production kernels are
// unchanged, and the outputs are the production ones bit for bit.
// 512 threads cap a thread at 128 registers: ptxas leaves 20 bytes of
// spill at the first level and 76 at the second (the row accumulators are
// live across the NTT passes); 256 threads a block had no spill at the
// second level and was slower at both (156.1 and 254.8 ms against 105.7
// and 210.5 ms then), so the spill stays.
#include "blind_rotate.cuh"

// The layout constants of the instantiation for (log_n, q, d, log_b):
// out = {S, DJ, RLOG, word bytes, TW_FWD, TW_INV}; non-zero if there is none.
// The typedefs of blind_rotate.cuh are the only table of them: ops/fused.py
// br_layout asks here when it lays a key out.
extern "C" int omr_blind_rotate_config(int log_n, int64_t q, int d, int log_b, int* out) {
#define OMR_BR_TRY(C)                                                        \
  if (log_n == C::LOG_N && (u64)q == C::F::Q && d == C::D && log_b == C::LOG_B) { \
    out[0] = C::S; out[1] = C::DJ; out[2] = C::RLOG; out[3] = (int)sizeof(C::W); \
    out[4] = C::TW_FWD; out[5] = C::TW_INV;                                   \
    return 0;                                                                 \
  }
  OMR_BR_TRY(BrL1)
  OMR_BR_TRY(BrL2)
  OMR_BR_TRY(BrTinyL1)
  OMR_BR_TRY(BrTinyL2)
#undef OMR_BR_TRY
  return (int)cudaErrorInvalidValue;
}

// acc (n_msgs, 2, N) int64 coefficient domain; amounts (2 * n_steps, n_msgs)
// int64 in [0, 2N); key, mono, tw_fwd, tw_inv in the instantiation's word
// (see blind_rotate.cuh), laid out by the constants omr_blind_rotate_config
// reports; orders (N,) int32 base orders; blocks the grid: at least
// n_msgs / S, the kernel masks what lies beyond n_msgs.
extern "C" int omr_blind_rotate(
    const int64_t* acc_in, int64_t* acc_out, const int64_t* amounts,
    int64_t n_msgs, int n_steps, const void* key, const void* mono,
    const int* orders, const void* tw_fwd, const void* tw_inv, uint64_t n_inv,
    uint64_t n_inv_sh, int log_n, int64_t q, int d, int log_b, int blocks,
    void* stream) {
  const BrArgs a{acc_in, acc_out, amounts, n_msgs, n_steps, key, mono, orders,
                 tw_fwd, tw_inv, n_inv, n_inv_sh, log_n, d, log_b, q, blocks, stream};
  if (matches<BrL1>(a)) return launch<BrL1>(a);
  if (matches<BrL2>(a)) return launch<BrL2>(a);
  if (matches<BrTinyL1>(a)) return launch<BrTinyL1>(a);
  if (matches<BrTinyL2>(a)) return launch<BrTinyL2>(a);
  return (int)cudaErrorInvalidValue;
}
