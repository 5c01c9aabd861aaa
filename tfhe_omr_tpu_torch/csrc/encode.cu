// The digest encoders' chunk work: the plaintext rows of every digest of a
// chunk, and the multiply-accumulate of their NTT images into the digests.
//
// Replaces no TPU kernel: the JAX package leaves this product to XLA
// (tfhe_omr_tpu/core/detector.py _encode_chunk_jit), and the port ran it as
// eager int64 torch (a 50-bit modular product alone is some 25 elementwise
// launches, each reading and writing a whole (B, 2, N) tensor), once per
// digest. The plain versions are ops/encode.py encode_mac_plain,
// index_poly_device and payload_plain_device.
//
// encode_mac: acc[k, c, i] += sum over m of pert[m, c, i] * pn[k, m, i]
// mod Q, for all K digests of a chunk in one launch; with several sets (one
// a recipient, core/detector.py RecipientsDetector) each set's digests sum
// its own rows, all sets in the same launch.
//
// What bounds it: bytes. At 2048 rows and 28 digests it reads 940 MB of
// NTT-domain plaintexts and 67 MB of pertinency (about 0.30 ms at 3.35
// TB/s) for 235 M products of 64 x 64 bits (about 0.17 ms of multiply
// slots). So the design reads each word once and keeps the sums out of
// device memory:
//   - a thread owns one slot i and MAC_G digests, and walks the chunk's
//     rows: pert[m, :, i] is loaded once for its MAC_G digests, and the
//     threads of the other digest groups of the same slots, in the same
//     block, take the same words from the L1 cache, so each pertinency word
//     comes from device memory once a chunk;
//   - the products are summed lazily in 128 bits and reduced once every
//     2^16 - 1 rows and once at the end (WideAcc, as K1 / K2 / K3 do);
//   - neighbouring threads own neighbouring slots, so every load of a warp
//     is 16 slots of one row (128 bytes) and each plaintext word is read
//     once;
//   - the rows are also split over the lanes of a block (as many as fit
//     in MAC_T threads: 4 at K = 28, 64 at K = 1), whose sums meet in
//     shared memory: a block of 896 or 1024 threads a slot tile keeps
//     enough loads in flight to stream the plaintexts.
// The block shape (slots a tile, digest groups, row lanes) follows from K
// and N alone (mac_plan), so one path serves 1 row or 2048, K = 1 or 28.
// Measured on an H100 at 2048 rows x 28 digests (N = 2048), against 256 /
// 512 threads and 8-slot tiles: 1024 threads and 16-slot tiles 0.43 ms,
// 256 threads (no lanes at K = 28) 1.16 ms.
//
// The plaintext builds write the (K, B, N) rows that K4 then takes to the
// NTT domain in one launch: a block a row, the row's weights or bucket
// addresses read once, every slot written (zeros included).
//
// Results are canonical residues: bit-equal to the plain versions.
#include "field.cuh"

// the second-level fields (q2) of the reference ring and of the small test
// preset (core/params.py OmrParameters.tiny)
typedef WordField<u64, 1125899906826241ull> EncQ2;
typedef WordField<u64, 274877905921ull> EncTinyQ2;

constexpr int MAC_T = 1024;        // threads a block, at most
constexpr int MAC_G = 2;           // digests a thread
constexpr int MAC_TILE = 16;       // slots a block
constexpr int MAC_TERM_BITS = 16;  // terms of a lazy sum before a reduction
constexpr int BUILD_T = 256;       // threads a block of the plaintext builds
static_assert(MAC_T / MAC_TILE <= 512, "the lanes' sum fits BITS + 9 bits");
static_assert(MAC_T * MAC_G * 2 * 8 <= 48 * 1024, "the lanes' residues fit static shared memory");

static __host__ __device__ __forceinline__ long long lmin(long long a, long long b) {
  return a < b ? a : b;
}
// floor(v / p) and v mod p in [0, p), as torch's // and % on int64
static __device__ __forceinline__ long long floor_div(long long v, long long p) {
  const long long d = v / p;
  return (v % p != 0 && ((v < 0) != (p < 0))) ? d - 1 : d;
}
static __device__ __forceinline__ long long floor_mod(long long v, long long p) {
  const long long r = v % p;
  return (r != 0 && ((r < 0) != (p < 0))) ? r + p : r;
}
// a residue mod p in [0, p) -> its centred representative mod q
static __device__ __forceinline__ long long centre(long long v, long long p, long long q) {
  return v < ((p + 1) >> 1) ? v : q - p + v;
}

// ----------------------------------------------------------- encode_mac
// A block: MAC_TILE slots x groups digest groups x lanes row lanes,
// thread t = (lane * groups + group) * MAC_TILE + slot.
struct MacPlan {
  int groups, lanes, threads, blocks;
};

static MacPlan mac_plan(int k_count, int n) {
  MacPlan p;
  p.groups = (k_count + MAC_G - 1) / MAC_G;
  p.lanes = 1;
  while (2 * p.lanes * p.groups * MAC_TILE <= MAC_T) p.lanes *= 2;
  p.threads = p.lanes * p.groups * MAC_TILE;
  p.blocks = (n + MAC_TILE - 1) / MAC_TILE;
  return p;
}

// pert (sets, rows, 2, n); pn (sets, k_count, rows, n); acc_in, acc_out
// (sets, k_count, 2, n); every word a canonical residue; a set takes
// ceil(n / MAC_TILE) blocks of the grid. smem: lanes x groups x MAC_TILE x
// MAC_G x 2 words when lanes > 1.
template <class F>
__global__ void __launch_bounds__(MAC_T) encode_mac_kernel(
    const i64* __restrict__ pert, const i64* __restrict__ pn,
    const i64* __restrict__ acc_in, i64* __restrict__ acc_out, long long rows,
    int k_count, int n, int groups, int lanes) {
  typedef WideAcc<F> A;
  typedef typename A::T Acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  u64* part = reinterpret_cast<u64*>(smem_raw);
  const int t = threadIdx.x;
  const int s = t % MAC_TILE;
  const int g = (t / MAC_TILE) % groups;
  const int lane = t / (MAC_TILE * groups);
  const int set_blocks = (n + MAC_TILE - 1) / MAC_TILE;
  const long long set = blockIdx.x / set_blocks;
  const int i = (blockIdx.x - (int)set * set_blocks) * MAC_TILE + s;
  pert += set * rows * 2 * n;
  pn += set * k_count * rows * n;
  acc_in += set * k_count * 2 * n;
  acc_out += set * k_count * 2 * n;
  const int k0 = g * MAC_G;
  // digests this thread sums: none beyond the ring's end
  const int kn = i < n ? (int)lmin(MAC_G, k_count - k0) : 0;

  Acc a[MAC_G][2];
#pragma unroll
  for (int j = 0; j < MAC_G; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      a[j][c] = A::from(lane == 0 && j < kn ? (u64)acc_in[((long long)(k0 + j) * 2 + c) * n + i]
                                            : 0);
  const i64* pn_k[MAC_G];
#pragma unroll
  for (int j = 0; j < MAC_G; ++j)
    pn_k[j] = pn + ((long long)(k0 + (j < kn ? j : 0)) * rows) * n + i;

  // rows lane, lane + lanes, ...; a reduction after every SEG of them keeps
  // a sum below 2^MAC_TERM_BITS terms (the carried residue is one)
  constexpr long long SEG = (1ll << MAC_TERM_BITS) - 1;
  for (long long seg = lane; seg < rows; seg += SEG * lanes) {
    const long long end = lmin(rows, seg + SEG * lanes);
    if (kn == MAC_G) {
#pragma unroll 8
      for (long long m = seg; m < end; m += lanes) {
        const u64 x0 = (u64)__ldg(pert + (m * 2) * n + i);
        const u64 x1 = (u64)__ldg(pert + (m * 2 + 1) * n + i);
#pragma unroll
        for (int j = 0; j < MAC_G; ++j) {
          const u64 y = (u64)__ldg(pn_k[j] + m * n);
          A::mac(a[j][0], x0, y);
          A::mac(a[j][1], x1, y);
        }
      }
    } else if (kn > 0) {  // the last group of an odd K
#pragma unroll 8
      for (long long m = seg; m < end; m += lanes) {
        const u64 y = (u64)__ldg(pn_k[0] + m * n);
        A::mac(a[0][0], (u64)__ldg(pert + (m * 2) * n + i), y);
        A::mac(a[0][1], (u64)__ldg(pert + (m * 2 + 1) * n + i), y);
      }
    }
#pragma unroll
    for (int j = 0; j < MAC_G; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) a[j][c] = A::from(A::template reduce<MAC_TERM_BITS>(a[j][c]));
  }

  u64 r[MAC_G][2];
#pragma unroll
  for (int j = 0; j < MAC_G; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) r[j][c] = A::template reduce<MAC_TERM_BITS>(a[j][c]);
  if (lanes > 1) {  // the lanes' residues meet in shared memory
    const int cell = (g * MAC_TILE + s) * MAC_G * 2;
    const int stride = groups * MAC_TILE * MAC_G * 2;
#pragma unroll
    for (int j = 0; j < MAC_G; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) part[lane * stride + cell + j * 2 + c] = r[j][c];
    __syncthreads();
    if (lane != 0) return;
    // at most MAC_T / MAC_TILE residues, each below Q < 2^BITS
#pragma unroll
    for (int j = 0; j < MAC_G; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        u64 sum = 0;
        for (int l = 0; l < lanes; ++l) sum += part[l * stride + cell + j * 2 + c];
        r[j][c] = F::template reduce64<F::BITS + 9>(sum);
      }
  }
#pragma unroll
  for (int j = 0; j < MAC_G; ++j)
    if (j < kn)
#pragma unroll
      for (int c = 0; c < 2; ++c) acc_out[((long long)(k0 + j) * 2 + c) * n + i] = (i64)r[j][c];
}

template <class F>
static bool has_field(int64_t q) {
  return (u64)q == F::Q;
}

template <class F>
static int launch_mac(const int64_t* pert, const int64_t* pn, const int64_t* acc_in,
                      int64_t* acc_out, int64_t rows, int k_count, int n, int sets,
                      void* stream) {
  const MacPlan p = mac_plan(k_count, n);
  const size_t smem = p.lanes > 1 ? (size_t)p.threads * MAC_G * 2 * sizeof(u64) : 0;
  OMR_LAUNCH(encode_mac_kernel<F>, (unsigned)(p.blocks * sets), (unsigned)p.threads, smem,
             stream,
             (const i64*)pert, (const i64*)pn, (const i64*)acc_in, (i64*)acc_out,
             (long long)rows, k_count, n, p.groups, p.lanes);
  return (int)cudaGetLastError();
}

// 0 when encode_mac is instantiated for the field q, else non-zero.
extern "C" int omr_encode_mac_field(int64_t q) {
  return has_field<EncQ2>(q) || has_field<EncTinyQ2>(q) ? 0 : (int)cudaErrorInvalidValue;
}

// acc_out = acc_in + sum over the rows of pert * pn, mod q, for each of
// ``sets`` sets; all int64 row-major and contiguous: pert (sets, rows, 2, n),
// pn (sets, k_count, rows, n), acc_in / acc_out (sets, k_count, 2, n),
// canonical residues in and out.
extern "C" int omr_encode_mac(const int64_t* pert, const int64_t* pn, const int64_t* acc_in,
                              int64_t* acc_out, int64_t rows, int k_count, int n, int64_t q,
                              void* stream, int sets) {
  if (k_count < 1 || n < 1 || rows < 0 || sets < 1 ||
      (int64_t)sets * ((n + MAC_TILE - 1) / MAC_TILE) > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (has_field<EncQ2>(q))
    return launch_mac<EncQ2>(pert, pn, acc_in, acc_out, rows, k_count, n, sets, stream);
  if (has_field<EncTinyQ2>(q))
    return launch_mac<EncTinyQ2>(pert, pn, acc_in, acc_out, rows, k_count, n, sets, stream);
  return (int)cudaErrorInvalidValue;
}

// --------------------------------------------------- plaintext builds
// Payload digests: out (k_count, rows, n); in digest k, row b, slot
// c * plen + j (c < cmb) holds centre((pay[b, j] * w[k, c, b]) mod p), every
// other slot 0. pay (rows, plen) contiguous; w[k, c, b] at
// w + k * w_k + c * w_c + b.
__global__ void __launch_bounds__(BUILD_T) encode_payload_plain_kernel(
    const i64* __restrict__ pay, const i64* __restrict__ w, long long w_k, long long w_c,
    i64* __restrict__ out, long long rows, int k_count, int cmb, int plen, int n, long long p,
    long long q) {
  const long long total = rows * k_count;
  for (long long row = blockIdx.x; row < total; row += gridDim.x) {
    const long long k = row / rows, b = row - k * rows;
    const i64* wr = w + k * w_k + b;
    const i64* pr = pay + b * plen;
    i64* dst = out + row * n;
    for (int slot = threadIdx.x; slot < n; slot += BUILD_T) {
      const int c = slot / plen;
      long long v = 0;
      if (c < cmb) {
        // wrapping int64 product, as torch's
        const long long prod = (long long)((u64)pr[slot - c * plen] * (u64)__ldg(wr + c * w_c));
        v = centre(floor_mod(prod, p), p, q);
      }
      dst[slot] = v;
    }
  }
}

// Index digests: out (rows, n); row b holds, in every segment s, the nd
// base-p digits of lo + b mod period (least first, centred; several
// digests' rows of the same messages one after another, period rows each)
// at slots base[b, s] ..
// base[b, s] + nd - 1 and a flag 1 at base[b, s] + nd, every other slot 0.
// Where the slots of two segments meet, the larger offset wins, as the
// plain version's scatters (one a digit, in order) leave it.
__global__ void __launch_bounds__(BUILD_T) encode_index_plain_kernel(
    const i64* __restrict__ base, long long lo, i64* __restrict__ out, long long rows,
    int segs, int nd, int n, long long p, long long q, long long period) {
  for (long long b = blockIdx.x; b < rows; b += gridDim.x) {
    const i64* br = base + b * segs;
    i64* dst = out + b * n;
    for (int slot = threadIdx.x; slot < n; slot += BUILD_T) {
      long long off = -1;
      for (int s = 0; s < segs; ++s) {
        const long long d = slot - __ldg(br + s);
        if (d >= 0 && d <= nd && d > off) off = d;
      }
      long long v = 0;
      if (off == nd) {
        v = 1;
      } else if (off >= 0) {
        long long x = lo + b % period;
        for (long long e = 0; e < off; ++e) x = floor_div(x, p);
        v = centre(floor_mod(x, p), p, q);
      }
      dst[slot] = v;
    }
  }
}

// The payload plaintexts of k_count digests (see the kernel); blocks: the
// grid, any number from 1.
extern "C" int omr_encode_payload_plain(const int64_t* pay, const int64_t* w, int64_t w_k,
                                        int64_t w_c, int64_t* out, int64_t rows, int k_count,
                                        int cmb, int plen, int n, int64_t p, int64_t q,
                                        int blocks, void* stream) {
  if (blocks < 1 || plen < 1 || p < 1) return (int)cudaErrorInvalidValue;
  OMR_LAUNCH(encode_payload_plain_kernel, (unsigned)blocks, BUILD_T, 0, stream,
             (const i64*)pay, (const i64*)w, (long long)w_k, (long long)w_c, (i64*)out,
             (long long)rows, k_count, cmb, plen, n, (long long)p, (long long)q);
  return (int)cudaGetLastError();
}

// The index plaintexts of the messages lo .. lo + period - 1 of a board,
// rows / period digests of them (see the kernel; period = rows for one);
// base (rows, segs) contiguous.
extern "C" int omr_encode_index_plain(const int64_t* base, int64_t lo, int64_t* out,
                                      int64_t rows, int segs, int nd, int n, int64_t p,
                                      int64_t q, int blocks, void* stream, int64_t period) {
  if (blocks < 1 || p < 1 || period < 1) return (int)cudaErrorInvalidValue;
  OMR_LAUNCH(encode_index_plain_kernel, (unsigned)blocks, BUILD_T, 0, stream,
             (const i64*)base, (long long)lo, (i64*)out, (long long)rows, segs, nd, n,
             (long long)p, (long long)q, (long long)period);
  return (int)cudaGetLastError();
}
