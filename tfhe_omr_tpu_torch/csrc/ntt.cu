// Negacyclic NTT and inverse, one thread block per polynomial.
//
// Replaces the Pallas kernels PallasNtt._make_call (27-bit field, N = 1024,
// tfhe_omr_tpu/ops/pallas_ntt.py:190) and PallasNtt50._make_call (50-bit
// field, N = 2048, pallas_ntt.py:498). Those run the transform as int8 digit
// matmuls on the TPU's MXU because Mosaic has no 64-bit integers; here the
// card's 64-bit integer lanes run the radix-2 butterflies directly.
//
// Design: the polynomial is loaded into shared memory (8 KB at N = 1024,
// 16 KB at N = 2048), the log2(N) butterfly stages run there with Shoup
// twiddles, and the result is written through the static permutation into
// the JAX package's slot order (the inverse reads through it). One global
// read and one write per coefficient.
//
// What bounds it: the 64-bit modular multiplies (each __umul64hi is several
// 32-bit multiply instructions) and one __syncthreads per stage; at these
// sizes the memory traffic (16 bytes per coefficient) is small beside them.
#include "common.cuh"

__global__ void ntt_fwd_kernel(const i64* __restrict__ in, i64* __restrict__ out,
                               const i64* __restrict__ perm, NttTables t, Field f) {
  extern __shared__ u64 sm[];
  const int n = 1 << t.log_n;
  const size_t base = (size_t)blockIdx.x << t.log_n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) sm[k] = (u64)in[base + k];
  __syncthreads();
  block_ntt_fwd(sm, 1, t, f);
  for (int k = threadIdx.x; k < n; k += blockDim.x) out[base + k] = (i64)sm[perm[k]];
}

__global__ void ntt_inv_kernel(const i64* __restrict__ in, i64* __restrict__ out,
                               const i64* __restrict__ perm, NttTables t, Field f) {
  extern __shared__ u64 sm[];
  const int n = 1 << t.log_n;
  const size_t base = (size_t)blockIdx.x << t.log_n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) sm[perm[k]] = (u64)in[base + k];
  __syncthreads();
  block_ntt_inv(sm, 1, t, f);
  for (int k = threadIdx.x; k < n; k += blockDim.x) out[base + k] = (i64)sm[k];
}

extern "C" const char* omr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// rows polynomials of 2^log_n coefficients, row-major; forward when
// inverse == 0. perm: reference slot k holds base slot perm[k].
extern "C" int omr_ntt(const int64_t* in, int64_t* out, const int64_t* tw,
                       const int64_t* tw_sh, const int64_t* perm, int64_t rows,
                       int log_n, int64_t q, int shoup_shift, int64_t n_inv,
                       int64_t n_inv_sh, int inverse, void* stream) {
  NttTables t;
  t.fwd = (const u64*)tw;
  t.fwd_sh = (const u64*)tw_sh;
  t.inv = (const u64*)tw;
  t.inv_sh = (const u64*)tw_sh;
  t.n_inv = (u64)n_inv;
  t.n_inv_sh = (u64)n_inv_sh;
  t.log_n = log_n;
  Field f{(u64)q, shoup_shift};
  const int n = 1 << log_n;
  const int threads = n / 2 < 256 ? n / 2 : 256;
  const size_t smem = (size_t)n * sizeof(u64);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (inverse) {
    err = allow_smem(ntt_inv_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    ntt_inv_kernel<<<(unsigned)rows, threads, smem, s>>>(
        (const i64*)in, (i64*)out, (const i64*)perm, t, f);
  } else {
    err = allow_smem(ntt_fwd_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    ntt_fwd_kernel<<<(unsigned)rows, threads, smem, s>>>(
        (const i64*)in, (i64*)out, (const i64*)perm, t, f);
  }
  return (int)cudaGetLastError();
}
