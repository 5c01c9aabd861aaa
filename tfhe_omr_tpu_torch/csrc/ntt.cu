// Negacyclic NTT and inverse of the rows of a matrix, in the reference slot
// order of each ring.
//
// Replaces the Pallas kernels PallasNtt._make_call (27-bit field, N = 1024,
// tfhe_omr_tpu/ops/pallas_ntt.py:190) and PallasNtt50._make_call (50-bit
// field, N = 2048, pallas_ntt.py:498). Those run the transform as int8 digit
// matmuls on the TPU's MXU because Mosaic has no 64-bit integers; here the
// card's integer lanes run radix-2 butterflies. One kernel template
// (ntt.cuh) with ring and field as template parameters, on the NTT passes
// that the blind rotation and the trace use (ntt_passes.cuh); the plain
// versions are ops/ntt.py fwd_last_plain / inv_last_plain.
//
// What bounds it: bytes. A row is read once and written once (16 bytes a
// coefficient) and its butterflies cost less than that takes. So the design
// is about moving rows:
//   - a block outlives its rows: the grid is a few blocks per SM, block b
//     takes the row groups b, b + grid, ...; the twiddles (beside their
//     companions) and the slot permutation (16-bit words) are loaded into
//     shared memory once per block, not once per row;
//   - rows come in by cp.async, 16 bytes a thread on neighbouring addresses,
//     and the next group is in flight while this one is transformed: the
//     first pass moves the staged rows into the working buffer, which frees
//     the staging buffer behind one barrier;
//   - the transform is 2-3 register-blocked passes (2^RLOG points a thread),
//     32-bit words inside for fields below 2^31 (rows stay int64 in device
//     memory), butterflies that reduce nothing on the way forward;
//   - the permutation between the radix-2 order of the butterflies and the
//     reference order happens between shared memory and registers: the
//     forward transform gathers through it for its 16-byte stores, the
//     inverse on the way into its first pass.
// Ragged groups: rows beyond n_rows are neither staged nor stored.
#include "ntt.cuh"

//                  W    logN  q                   RLOG ROWS T
typedef NttConfig<u64, 11, 1125899906826241ull, 4, 1, 128> NttQ2;
typedef NttConfig<u32, 10, 134215681ull, 5, 4, 128> NttQ1;
// the small test preset (core/params.py OmrParameters.tiny)
typedef NttConfig<u64, 9, 274877905921ull, 3, 2, 128> NttTinyQ2;
typedef NttConfig<u32, 8, 33551873ull, 4, 8, 128> NttTinyQ1;

extern "C" const char* omr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

template <class C>
static bool matches(int log_n, int64_t q) {
  return log_n == C::LOG_N && (u64)q == C::F::Q;
}

template <class C, bool INVERSE>
static int launch(const int64_t* in, int64_t* out, int64_t rows, const void* tw,
                  const void* perm, uint64_t n_inv, uint64_t n_inv_sh, int blocks,
                  void* stream) {
  typedef typename C::W W;
  auto kernel = ntt_kernel<C, INVERSE>;
  cudaError_t err = allow_smem(kernel, C::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  OMR_LAUNCH(kernel, (unsigned)blocks, C::T, C::SMEM_BYTES, stream, (const i64*)in,
             (i64*)out, (long long)rows, (const W*)tw, (const unsigned short*)perm,
             (W)n_inv, (W)n_inv_sh);
  return (int)cudaGetLastError();
}

template <class C>
static int config(int* out) {
  out[0] = C::ROWS;
  out[1] = C::RLOG;
  out[2] = (int)sizeof(typename C::W);
  out[3] = C::TW;
  int per_sm = 0;
  cudaError_t err = allow_smem(ntt_kernel<C, false>, C::SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ntt_kernel<C, false>,
                                                        C::T, C::SMEM_BYTES);
  out[4] = per_sm;
  return (int)err;
}

// The layout constants of the instantiation for (log_n, q): out = {ROWS,
// RLOG, word bytes, twiddles per table, resident blocks per SM}; non-zero if
// there is none.
extern "C" int omr_ntt_config(int log_n, int64_t q, int* out) {
  if (matches<NttQ2>(log_n, q)) return config<NttQ2>(out);
  if (matches<NttQ1>(log_n, q)) return config<NttQ1>(out);
  if (matches<NttTinyQ2>(log_n, q)) return config<NttTinyQ2>(out);
  if (matches<NttTinyQ1>(log_n, q)) return config<NttTinyQ1>(out);
  return (int)cudaErrorInvalidValue;
}

// rows polynomials of 2^log_n coefficients, row-major int64, 16-byte
// aligned; forward when inverse == 0. tw: the direction's regrouped
// twiddles beside their companions, in the instantiation's word; perm: the
// direction's permutation as 16-bit words (see ntt.cuh); blocks: the grid,
// any number from 1 to the number of row groups.
extern "C" int omr_ntt(const int64_t* in, int64_t* out, int64_t rows, const void* tw,
                       const void* perm, uint64_t n_inv, uint64_t n_inv_sh, int log_n,
                       int64_t q, int inverse, int blocks, void* stream) {
#define OMR_NTT_TRY(C)                                                                   \
  if (matches<C>(log_n, q))                                                              \
    return inverse ? launch<C, true>(in, out, rows, tw, perm, n_inv, n_inv_sh, blocks, stream) \
                   : launch<C, false>(in, out, rows, tw, perm, n_inv, n_inv_sh, blocks, stream);
  OMR_NTT_TRY(NttQ2)
  OMR_NTT_TRY(NttQ1)
  OMR_NTT_TRY(NttTinyQ2)
  OMR_NTT_TRY(NttTinyQ1)
#undef OMR_NTT_TRY
  return (int)cudaErrorInvalidValue;
}
