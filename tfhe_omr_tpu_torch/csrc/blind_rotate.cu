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
// twiddles, each beside its companion | ring NST x N | the monomial table
// 2N, where it fits, with NP = N + N / 32 (one pad word per 32, per 16 at
// 64 bits, against bank conflicts). The inverse twiddles are read through
// the read-only cache. NST is a power of two: the ring index is a mask (a
// 64-bit `%` there cost 10-25 %).
//   first level:  S = 4, T = 512, DJ = 4 (all digits in one pass), RLOG = 5
//                 (two passes), NST = 8: 209,920 bytes and the table's
//                 8,192, 218,112 bytes, 5 barriers a step;
//   second level: S = 1, T = 512, DJ = 2, RLOG = 4 (three passes), NST = 4:
//                 202,752 bytes, 15 barriers a step; its table (4096 64-bit
//                 words, 32 KB) does not fit beside them in the 232,448
//                 bytes a block may have, and stays in device memory.
// The table: each step a thread looks up 3 rows x S samples x 2 slots
// words at (a_t o_k) mod 2N, indices scattered over the whole table. From
// the read-only cache a warp's gather is served a 128-byte line at a time
// (about 25 of the table's 64 lines), from shared memory a bank conflict
// at a time (3-4 passes). The block copies the table in beside the forward
// twiddles; BrConfig::MONO_SHARED says whether it has room, and where it
// has not the kernel compiles to what it was without it. At the first
// level (7168 x 256 steps, each build in turn on one card, NVIDIA H100
// 80GB HBM3, 700 W): 98.2-98.9 ms through the cache, 94.4 ms from shared
// memory with the step's amounts all loaded before the first lookup; 95.3
// ms with them loaded a sample at a time (30 spill loads in the step
// loop), 97.9 ms with them staged in shared memory 256 steps at a time,
// 101.9 ms with them loaded at the top of the step.
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
// Clusters (second level only). One sample a block leaves a card of 132
// SMs mostly idle below 132 samples: at one message (D = 1) one SM runs all
// 335 steps. Where the launch's blocks would leave SMs idle, ops/fused.py
// cluster_size picks C, the largest instantiated size (below) such that
// each sample's cluster of C CTAs runs at once (blocks x C <= SMs, blocks at
// most the clusters of C the card holds at once, which the occupancy query
// reports: on an H100 SXM 17 of 6, 39 of 3, 66 of 2); the launch takes the
// cluster variant BrCluster<K, C, DJ> of the same template, counted as
// `<key name>_cluster`. Otherwise (67 samples and more at d = 6, every
// first level) the one-block kernels run, compiled to the same code as
// without the variants. In a cluster CTA rank j takes the digits
// j d / C .. (j + 1) d / C - 1: it rounds and decomposes the whole
// accumulator for them, transforms them (DJ a pass) and multiply-accumulates
// against only their 12 d / C key planes a step, read from the one-block
// key layout (key_plane), so each CTA streams 1/C of a step's 1.18 MB and
// no key is held twice. Its monomial stage turns its partial rows into
// partial products over all N slots (linear, so the sum of the C partial
// products is the one-block product), left at the head of its digit
// buffer. Then, between two cluster barriers (barrier.cluster.arrive.release
// / wait.acquire: each CTA's writes before one are seen by all after it),
// CTA j sums its share of the 2N (polynomial, slot) pairs, pairs
// j 2N / C .. (j + 1) 2N / C - 1, over the C buffers through distributed
// shared memory (mapa), and writes the canonical sum back into all C
// buffers: C residues below q2 < 2^50 sum below 2^53, one fold and two
// subtracts. After the second barrier every CTA holds the whole product and
// runs both inverse NTTs into its own copy of the accumulator (the inverse
// is done C times: 24 % of a cluster step). A peer's buffer is read and
// written only between the two barriers, and only in the pairs the reader
// owns; a CTA overwrites its own buffer (the next step's forward NTT) only
// after the second, and no peer reads it again before the next step's
// first. CTA rank 0 writes the output. Shared memory of a CTA (bytes):
// acc 34,816 | digits 34,816 (DJ = 1) or 69,632 (DJ = 2) | forward
// twiddles 32,752 | ring 65,536 | the monomial table 32,768 where it fits:
// C = 6 and C = 2 (DJ = 1, three passes at C = 2) 200,704 with the table in
// shared memory; C = 3 (DJ = 2, one pass) 202,752 without it; the tiny
// preset's d = 7 only at C = 7. A cluster step at C = 6 (profiled clocks a
// step, thread 0 of each CTA, B = 1, NVIDIA H100 80GB HBM3, 700 W):
// digits and forward 9.2k (19 %), key staging and MAC 14.4k (30 %),
// monomial 5.3k (11 %), inverse and accumulate 11.8k (24 %), the barriers
// and the exchange 7.9k (16 %): 48.6k clocks, against 148k of a one-block
// step at B = 1 (54.7k, 69.7k, 7.3k, 14.1k, 2.4k). K2 alone, 335 steps
// (examples/bench_kernels_torch.py --only k2 --batch 1,8,.., medians of 5;
// the one-block kernels only / with the cluster variants, alternating on
// one card, each range over two runs):
//   B = 1: 24.107-24.114 / 7.932-7.939 ms (C = 6); 8: 23.437-23.440 /
//   7.766-7.768 (6); 22: 23.213-23.217 / 11.530-11.535 (3); 44: 23.130-
//   23.132 / 15.914 (2); 96: 23.103-23.106 / 23.095-23.102 (1); 1024:
//   185.254-186.474 / 186.208-186.472 (1).
// Tried and dropped: a bulk prefetch of the next step's planes into the L2
// cache (-1.2 % at C = 6, +3.4 % at C = 2); RLOG 3 for the cluster
// variants, so that the forward passes of two polynomials keep all 512
// threads busy (+2.7 % at C = 6, -2 % at C = 3); the ring three planes
// ahead (NST - 1) on the cluster variants (-2.2 % at C = 6, nothing at 3
// and 2), which leaves one iteration, not two, between a thread's reads
// of a slot and the copy that overwrites it.
//
// Ragged batches: samples beyond n_msgs are loaded as zeros and not stored.
//
// Several keys (one a recipient, core/detector.py RecipientsDetector): the
// keys lie one after another, and samples k per_key .. (k + 1) per_key - 1
// take key k. A block's S samples are one key's, so each key read is still
// shared by the block's samples: a key takes ceil(per_key / S) blocks, and
// its last block masks the samples beyond the key's as a ragged batch's
// last block does (7 samples a message at S = 4: 2 blocks, the second of
// 3). The block finds its key once, before the step loop, as the index of
// its first plane in the stacked keys, where the key ring starts counting:
// the step loop is the one-key loop, and with one key (per_key = n_msgs)
// the first plane is 0 and block b takes samples b S .. b S + S - 1.
// Every block of one key then reads the same planes at about the same time
// and the L2 cache serves them; with a key a block (K2 at one message a
// recipient) each block streams its own key from device memory.
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
#include <type_traits>

#include "blind_rotate.cuh"

// The layout constants of the instantiation for (log_n, q, d, log_b):
// out = {S, DJ, RLOG, word bytes, TW_FWD, TW_INV, MONO_SHARED, the cluster
// sizes of its cluster variants as bits (bit C)}; non-zero if there is none.
// The typedefs of blind_rotate.cuh are the only table of them: ops/fused.py
// br_layout asks here when it lays a key out.
extern "C" int omr_blind_rotate_config(int log_n, int64_t q, int d, int log_b, int* out) {
#define OMR_BR_TRY(C, CLUSTERS)                                              \
  if (log_n == C::LOG_N && (u64)q == C::F::Q && d == C::D && log_b == C::LOG_B) { \
    out[0] = C::S; out[1] = C::DJ; out[2] = C::RLOG; out[3] = (int)sizeof(C::W); \
    out[4] = C::TW_FWD; out[5] = C::TW_INV; out[6] = C::MONO_SHARED;          \
    out[7] = CLUSTERS;                                                        \
    return 0;                                                                 \
  }
  OMR_BR_TRY(BrL1, 0)
  OMR_BR_TRY(BrL2, (1 << BrL2C2::CL) | (1 << BrL2C3::CL) | (1 << BrL2C6::CL))
  OMR_BR_TRY(BrTinyL1, 0)
  OMR_BR_TRY(BrTinyL2, 1 << BrTinyL2C7::CL)
#undef OMR_BR_TRY
  return (int)cudaErrorInvalidValue;
}

// acc (n_msgs, 2, N) int64 coefficient domain; amounts (2 * n_steps, n_msgs)
// int64 in [0, 2N); key, mono, tw_fwd, tw_inv in the instantiation's word
// (see blind_rotate.cuh), laid out by the constants omr_blind_rotate_config
// reports, n_msgs / per_key keys one after another; orders (N,) int32 base
// orders; per_key the samples of a key (n_msgs with one key; it divides
// n_msgs); blocks the grid: n_msgs / per_key keys of ceil(per_key / S)
// blocks, the kernel masks what lies beyond each key's.
extern "C" int omr_blind_rotate(
    const int64_t* acc_in, int64_t* acc_out, const int64_t* amounts,
    int64_t n_msgs, int n_steps, const void* key, const void* mono,
    const int* orders, const void* tw_fwd, const void* tw_inv, uint64_t n_inv,
    uint64_t n_inv_sh, int log_n, int64_t q, int d, int log_b, int blocks,
    void* stream, int64_t per_key) {
  const BrArgs a{acc_in, acc_out, amounts, n_msgs, n_steps, key, mono, orders,
                 tw_fwd, tw_inv, n_inv, n_inv_sh, log_n, d, log_b, q, blocks, stream,
                 per_key};
  if (matches<BrL1>(a)) return launch<BrL1>(a);
  if (matches<BrL2>(a)) return launch<BrL2>(a);
  if (matches<BrTinyL1>(a)) return launch<BrTinyL1>(a);
  if (matches<BrTinyL2>(a)) return launch<BrTinyL2>(a);
  return (int)cudaErrorInvalidValue;
}

// The cluster variant with `cluster` CTAs a sample of the configuration for
// (log_n, q, d, log_b), through `act`; cudaErrorInvalidValue if there is
// none.
template <class Act>
static int with_cluster(int log_n, int64_t q, int d, int log_b, int cluster, Act act) {
  const BrArgs sig{nullptr, nullptr, nullptr, 0, 0, nullptr, nullptr, nullptr,
                   nullptr, nullptr, 0, 0, log_n, d, log_b, q, 0, nullptr, 0};
#define OMR_BR_CLUSTER(C) \
  if (matches<C>(sig) && cluster == C::CL) return act((C*)nullptr);
  OMR_BR_CLUSTER(BrL2C2)
  OMR_BR_CLUSTER(BrL2C3)
  OMR_BR_CLUSTER(BrL2C6)
  OMR_BR_CLUSTER(BrTinyL2C7)
#undef OMR_BR_CLUSTER
  return (int)cudaErrorInvalidValue;
}

// omr_blind_rotate on clusters of `cluster` CTAs, one a sample: `blocks` is
// the grid in CTAs, n_msgs / per_key keys of per_key clusters.
extern "C" int omr_blind_rotate_cluster(
    const int64_t* acc_in, int64_t* acc_out, const int64_t* amounts,
    int64_t n_msgs, int n_steps, const void* key, const void* mono,
    const int* orders, const void* tw_fwd, const void* tw_inv, uint64_t n_inv,
    uint64_t n_inv_sh, int log_n, int64_t q, int d, int log_b, int blocks,
    void* stream, int64_t per_key, int cluster) {
  const BrArgs a{acc_in, acc_out, amounts, n_msgs, n_steps, key, mono, orders,
                 tw_fwd, tw_inv, n_inv, n_inv_sh, log_n, d, log_b, q, blocks, stream,
                 per_key};
  return with_cluster(log_n, q, d, log_b, cluster,
                      [&](auto* c) { return launch<std::remove_pointer_t<decltype(c)>>(a); });
}

// *out: the clusters of that variant the current card holds at once.
extern "C" int omr_blind_rotate_cluster_fit(int log_n, int64_t q, int d, int log_b, int cluster,
                                            int* out) {
  return with_cluster(log_n, q, d, log_b, cluster, [&](auto* c) {
    return cluster_fit<std::remove_pointer_t<decltype(c)>>(out);
  });
}
