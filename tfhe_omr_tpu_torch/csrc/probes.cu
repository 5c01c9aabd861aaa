// Unit-rate probes: each kernel keeps one execution unit of the SM busy
// with work that no compiler can fold, so its time gives that unit's rate.
//
// Replaces the Pallas probes of benches/ (each computes the same function):
//   probe_chain  - vpu_probe.py make_probe, vpu_peak_probe.py
//                  make_chain_probe, mac_probe.py f32_fma_probe and
//                  mosaic_unsupported_probe.py chain_kernel (int32 mul,
//                  int64 mul, the signed high word of a 32 x 32 product);
//   probe_mac    - vpu_peak_probe.py make_mac_probe;
//   probe_i8dot  - vpu_probe.py make_dot_probe, mac_probe.py
//                  kernel_batched_dot and kernel_dot2d,
//                  mosaic_unsupported_probe.py build_bdot.
// The plain versions are ops/probes.py *_plain.
//
// probe_chain: S independent (a, b) pairs an element in registers, the
// mutual recurrence a' = fa(a, b); b' = fb(b, a') for a loop count given
// at run time; out = a_0 + b_0 + ... + b_{S-1}. Integer arithmetic wraps
// (it is done in the unsigned twin of the type), `>>` is arithmetic, the
// compare of sel_add signed. mulhi_add takes the signed high word
// (__mulhi), int64 mul_add multiplies in 64 bits, fma is fmaf: one
// rounding per operation; mulwide_add (no TPU probe's) adds both words of
// the unsigned 64-bit product. What bounds it: each op's least instruction
// mix a step (utils/rates.py STEP_WORK) on the SM's pipes, the FMA pipe's
// multiply slots (mul, mul_add, mulhi_add and mulwide_add: an IMAD.HI or
// IMAD.WIDE is two slots; int64: an IMAD.WIDE and two IMADs, four) or the
// issue of int32 instructions split between the ALU and FMA pipes (add,
// mask_add, sel_add, sub_add). Its design against each: every step names
// the pipe of its adds (Pipes: nvcc's own choice put most adds beside the
// multiplies on the FMA pipe), sel_add, sub_add, mulwide_add and the int64
// product are inline PTX in their least mix (sub_add's so that the compiler
// cannot fold its steps), the loop is unrolled so that a and b keep their
// registers, and where the elements are too few to keep the SMs'
// schedulers busy an element's streams are split over adjacent threads
// (chain_plan), the sum put together in shared memory in the plain
// version's order.
//
// probe_mac: acc_s += (v_s + i) * k_s with v_s = x + s, k_s = y - s loop
// invariant. The loop index passes through an empty asm so that the
// compiler cannot turn (v + i) * k into an induction variable of adds.
//
// probe_i8dot: C[g] = rounds x (A[g] @ B[g]) mod 2^32, int8 (g, m, k) x
// (g, k, n) -> int32, on the tensor cores: wgmma m64nNk32 .s32.s8.s8 without
// .satfinite, so the sum wraps as the TPU's int32 sum does, both operands
// read from shared memory that TMA fills (hopper.cuh). wgmma takes 8-bit
// operands K-major only, so a pre-pass packs B into Bt (g, n, kp) (and A
// where its rows are not 16-byte strides), k zero-padded to 16 bytes; TMA
// reads zeros beyond k, m and n. A staged k atom is multiplied `rounds`
// times before the next one replaces it (sum_r sum_k = sum_k sum_r: the
// same wrapped sum), every round on the tensor cores. What bounds it: the
// int8 tensor-core rate where the rounds are many (P5, P7), the bytes of C
// where they are few (P9). Its design against each: tiles of 64 x N chosen
// by n, k or the rounds split across blocks where the tiles are fewer than
// the SMs, the next atoms' loads in flight under this atom's products, and
// C written through shared memory by TMA stores (reduce-adds where blocks
// share a tile).
#include "field.cuh"
#include "hopper.cuh"

#ifndef __CUDACC__
#include <cmath>
#endif

enum ProbeOp { ADD, MUL, MUL_ADD, SUB_ADD, SHIFT_ADD, MASK_ADD, SEL_ADD, MULHI_ADD, FMA,
               MULWIDE_ADD };

template <class T> struct Unsigned;
template <> struct Unsigned<int> { typedef unsigned U; };
template <> struct Unsigned<long long> { typedef unsigned long long U; };

template <class T>
static __device__ __forceinline__ T wadd(T a, T b) {
  typedef typename Unsigned<T>::U U;
  return (T)((U)a + (U)b);
}
template <class T>
static __device__ __forceinline__ T wsub(T a, T b) {
  typedef typename Unsigned<T>::U U;
  return (T)((U)a - (U)b);
}
template <class T>
static __device__ __forceinline__ T wmul(T a, T b) {
  typedef typename Unsigned<T>::U U;
  return (T)((U)a * (U)b);
}
static __device__ __forceinline__ float wadd(float a, float b) { return a + b; }

// Which pipe an add takes is the compiler's choice (IADD3 on the ALU pipe
// or IMAD.IADD on the FMA pipe), and left to itself nvcc put up to 13 of
// every 16 adds of a chain on the FMA pipe beside its multiplies. A chain
// step names the pipe instead, through two kernel arguments the compiler
// cannot see through, zero (0) and one (1): x + y + zero has three
// addends, which only IADD3 takes; x * one + y is an IMAD.
template <class T>
struct Pipes {
  T zero, one;
  __device__ __forceinline__ T alu_add(T x, T y) const { return wadd(wadd(x, y), zero); }
  __device__ __forceinline__ T fma_add(T x, T y) const { return wadd(wmul(x, one), y); }
};

// One step of pair (a, b); `odd` is the step's parity, for the ops whose
// least mix takes turns between the pipes.
template <int OP, class T>
static __device__ __forceinline__ void chain_step(T& a, T& b, const Pipes<T>& p, bool odd) {
  if constexpr (OP == FMA) {
    a = fmaf(a, b, 1.5f);
    b = fmaf(b, a, 0.5f);
  } else if constexpr (OP == SEL_ADD) {
    static_assert(sizeof(T) == 4, "sel_add runs in int32");
#ifdef __CUDACC__
    // the compare (ALU), the subtract under its predicate and the add: an
    // even step subtracts on the FMA pipe (a + b x -one) and adds on the
    // ALU pipe, an odd one adds on the FMA pipe, so that two steps' six
    // instructions can split three and three (nvcc's own select spent a
    // move or a SEL more a step)
    if (!odd)
      asm("{\n\t.reg .pred q;\n\tsetp.gt.s32 q, %0, %1;\n\t"
          "@q mad.lo.s32 %0, %1, %3, %0;\n\tadd.s32 %1, %1, %0;\n\tadd.s32 %1, %1, %2;\n\t}"
          : "+r"(a), "+r"(b) : "r"(p.zero), "r"(-p.one));
    else
      asm("{\n\t.reg .pred q;\n\tsetp.gt.s32 q, %0, %1;\n\t@q sub.s32 %0, %0, %1;\n\t"
          "mad.lo.s32 %1, %0, %2, %1;\n\t}"
          : "+r"(a), "+r"(b) : "r"(p.one));
#else
    a = a > b ? wsub(a, b) : a;
    b = wadd(b, a);
#endif
  } else if constexpr (OP == MUL) {
    a = wmul(a, b);
    b = wmul(b, a);
  } else if constexpr (OP == ADD) {
    a = p.alu_add(a, b);
    b = p.fma_add(a, b);
  } else if constexpr (OP == MASK_ADD) {
    a = a & b;
    b = p.fma_add(a, b);
  } else if constexpr (OP == MUL_ADD && sizeof(T) == 8) {
#ifdef __CUDACC__
    // the low word of a 64 x 64 product in its least: IMAD.WIDE.U32 of the
    // low words and two IMADs that add the cross products into its high
    // word (nvcc's own spent an IMAD.IADD more a step)
    asm("{\n\t.reg .u32 al, ah, bl, bh, l, h;\n\t.reg .u64 w;\n\t"
        "mov.b64 {al, ah}, %0;\n\tmov.b64 {bl, bh}, %1;\n\t"
        "mul.wide.u32 w, al, bl;\n\tmov.b64 {l, h}, w;\n\t"
        "mad.lo.u32 h, al, bh, h;\n\tmad.lo.u32 h, ah, bl, h;\n\tmov.b64 %0, {l, h};\n\t}"
        : "+l"(a) : "l"(b));
#else
    a = wmul(a, b);
#endif
    b = p.alu_add(b, a);
  } else if constexpr (OP == MUL_ADD || OP == MULHI_ADD) {
    if constexpr (OP == MUL_ADD) a = wmul(a, b);
    else a = __mulhi(a, b);
    b = p.alu_add(b, a);
  } else if constexpr (OP == SUB_ADD) {
    static_assert(sizeof(T) == 4, "sub_add runs in int32");
    // b + (a - b) is a, so the step is its subtract. The pair (a, b) ->
    // (a - b, a) comes back every 6 steps, and over the unrolled loop nvcc
    // folded 64 steps into a few instructions: the subtract is inline PTX
    // that neither nvcc nor ptxas can fold, a - b + zero (one IADD3, ALU
    // pipe) on an even step and a + b x -one (one IMAD, FMA pipe) on an odd
    // one, so that the two pipes share the steps (IADD3 alone issues at
    // half the SM's integer rate)
    T a2;
#ifdef __CUDACC__
    if (!odd)
      asm("{\n\t.reg .s32 t;\n\tsub.s32 t, %1, %2;\n\tadd.s32 %0, t, %3;\n\t}"
          : "=r"(a2) : "r"(a), "r"(b), "r"(p.zero));
    else
      asm("mad.lo.s32 %0, %2, %3, %1;" : "=r"(a2) : "r"(a), "r"(b), "r"(-p.one));
#else
    a2 = wsub(a, b);
#endif
    b = a;
    a = a2;
  } else if constexpr (OP == MULWIDE_ADD) {
    // a' = b + the low and the high word of the unsigned 64-bit product
    // a x b, b' = a': one IMAD.WIDE.U32 and one IADD3 a step. No TPU probe
    // has it: it times the wide product's multiply slots beside the IMAD's
    // (utils/rates.py)
#ifdef __CUDACC__
    asm("{\n\t.reg .u64 w;\n\t.reg .u32 l, h;\n\tmul.wide.u32 w, %0, %1;\n\t"
        "mov.b64 {l, h}, w;\n\tadd.u32 l, l, h;\n\tadd.u32 %0, l, %1;\n\t}"
        : "+r"(a) : "r"(b));
#else
    const unsigned long long w = (unsigned long long)(unsigned)a * (unsigned)b;
    a = (T)((unsigned)b + (unsigned)w + (unsigned)(w >> 32));
#endif
    b = a;
  } else {
    // b + (a >> 1): the run of shifts becomes the add's own shift (one
    // LEA.HI), the compiler's fold and this step's least
    const T a2 = a >> 1;
    b = wadd(b, a2);
    a = a2;
  }
}

// How an element's streams are laid over threads; omr_probe_chain_plan
// tells the wrapper. Where the elements alone give an SM fewer than
// CHAIN_FILL threads for each 32-bit word of a stream (one warp a
// scheduler; two for int64, whose step is a chain of five dependent
// instructions against two), an element's S streams are split over `split`
// adjacent threads of per_thread streams each, the fewest threads that
// reach it (at most S). A thread's own streams hide each other's latency
// better than more threads do: at P8's (64, 512), S = 4 the int32 chains
// ran fastest unsplit, the int64 one split in two, and at (8, 512), S = 16
// a split over 8 threads ran 3.3x faster than none (PERF.md section 6).
constexpr int CHAIN_THREADS = 128, CHAIN_FILL = 128;
struct ChainPlan {
  int per_thread, split;
  long long blocks;
};

static ChainPlan chain_layout(long long n, int streams, int split) {
  return ChainPlan{streams / split, split, (n * split + CHAIN_THREADS - 1) / CHAIN_THREADS};
}

static ChainPlan chain_plan(long long n, int streams, int word_bytes, int sms) {
  const long long fill = (long long)sms * CHAIN_FILL * (word_bytes / 4);
  int split = 1;
  while (split < streams && n * split < fill) split *= 2;
  return chain_layout(n, streams, split);
}

// Thread g holds streams part * SP .. part * SP + SP - 1 of element
// g / split (part = g % split), so an element's threads are adjacent in
// one block. The loop is unrolled to 64 steps of the thread's streams, so
// that a and b keep their registers across the back edge and the loop's
// own instructions are few; the remainder runs one step at a time.
// Split elements put their sum together in shared memory: every thread
// leaves its b's there, and the element's first thread adds a_0, b_0, ...,
// b_{S-1} in that order (the order of the plain version: float addition
// is not associative). Threads past n run element n - 1 and write nothing,
// so that every thread reaches the barrier.
template <int OP, class T, int SP>
__global__ void __launch_bounds__(CHAIN_THREADS)
probe_chain_kernel(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out,
                   long long n, int iters, int split, int zero, int one) {
  constexpr int U = 64 / SP;
  const long long g = (long long)blockIdx.x * CHAIN_THREADS + threadIdx.x;
  const bool live = g / split < n;
  const long long e = live ? g / split : n - 1;
  const int part = (int)(g % split);
  T a[SP], b[SP];
#pragma unroll
  for (int j = 0; j < SP; ++j) {
    const int s = part * SP + j;
    if constexpr (OP == FMA) {
      a[j] = x[e] + (float)s;
      b[j] = y[e] * (float)(1.0 + 0.01 * s);
    } else {
      a[j] = wadd(x[e], (T)s);
      b[j] = wadd(y[e], (T)s);
    }
  }
  const Pipes<T> p{(T)zero, (T)one};
  int it = 0;
#pragma unroll 1
  for (; it + U <= iters; it += U) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < SP; ++j) chain_step<OP>(a[j], b[j], p, u % 2);
  }
#pragma unroll 1
  for (; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < SP; ++j) chain_step<OP>(a[j], b[j], p, false);
  if (split == 1) {
    T acc = a[0];
#pragma unroll
    for (int j = 0; j < SP; ++j) acc = wadd(acc, b[j]);
    if (live) out[e] = acc;
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bs = reinterpret_cast<T*>(smem_raw);
#pragma unroll
  for (int j = 0; j < SP; ++j) bs[threadIdx.x * SP + j] = b[j];
  __syncthreads();
  if (live && part == 0) {
    T acc = a[0];
    for (int k = 0; k < split * SP; ++k) acc = wadd(acc, bs[threadIdx.x * SP + k]);
    out[e] = acc;
  }
}

template <int S>
__global__ void __launch_bounds__(128)
probe_mac_kernel(const int* __restrict__ x, const int* __restrict__ y, int* __restrict__ out,
                 long long n, int iters) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  int v[S], k[S], acc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    v[s] = wadd(x[e], s);
    k[s] = wsub(y[e], s);
    acc[s] = 0;
  }
  for (int i = 0; i < iters; ++i) {
    int ii = i;
    asm("" : "+r"(ii));
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = wadd(acc[s], wmul(wadd(v[s], ii), k[s]));
  }
  int r = acc[0];
#pragma unroll
  for (int s = 1; s < S; ++s) r = wadd(r, acc[s]);
  out[e] = r;
}

// ------------------------------------------------------------ int8 wgmma
// A block is one warpgroup and owns a tile of C of 64 rows (wgmma's m64)
// x N columns (64, 128 or 256: the product's n rounded up, at most 256).
// k arrives in atoms of 128 bytes (four wgmma k steps), A's and B's atoms
// side by side in one stage of a ring of DOT_RING stages; thread 0 keeps
// the TMA loads of the next atoms in flight while the warpgroup multiplies
// the atom at hand `rounds` times. Where the tiles are fewer than the SMs,
// a tile's blocks share out its k atoms or its rounds and add their sums
// into a zeroed C (addition mod 2^32 is associative, so C stays bit-equal).
// C's tile leaves through shared memory as TMA stores or, for shared
// tiles, TMA reduce-adds (whole lines, clipped at m and at C's rows by the
// unit); C's rows are n rounded up to 4 words, so they are 16-byte strides.
constexpr int DOT_BM = 64, DOT_ATOM = 128, DOT_RING = 4, DOT_THREADS = 128;
constexpr int DOT_C_BOX = DOT_BM * 128;  // bytes of a box of C: 64 rows x 32 words
constexpr int PACK_THREADS = 256;

static __host__ __device__ constexpr int dot_stage_bytes(int n_tile) {
  return (DOT_BM + n_tile) * DOT_ATOM;
}
static __host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// How a product is cut into blocks; omr_probe_i8dot_plan tells the wrapper.
struct DotPlan {
  int n_tile, tiles_m, tiles_n;
  long long tiles;           // g x tiles_m x tiles_n
  int split_k, split_r;      // blocks a tile: its k atoms or its rounds shared out
  int atoms, atoms_per;      // k in 128-byte atoms; atoms a block at most
  int ksteps, kp;            // k in 32-byte wgmma steps; k padded to 16 bytes (TMA strides)
  int stages, smem;          // ring depth; dynamic shared memory bytes
  long long blocks;
  long long bt_bytes, scratch;  // Bt's bytes (rounded up to 256); Bt's and Ap's
};

static DotPlan dot_plan(long long g, int m, int k, int n, int rounds, int sms) {
  DotPlan p{};
  p.n_tile = n <= 64 ? 64 : n <= 128 ? 128 : 256;
  p.tiles_m = (m + DOT_BM - 1) / DOT_BM;
  p.tiles_n = (n + p.n_tile - 1) / p.n_tile;
  p.tiles = g * p.tiles_m * p.tiles_n;
  p.ksteps = (k + 31) / 32;
  p.atoms = (k + DOT_ATOM - 1) / DOT_ATOM;
  p.kp = (k + 15) / 16 * 16;
  const long long split = p.tiles < sms ? sms / p.tiles : 1;
  if (rounds >= 4 * split) {
    // every share keeps many rounds on atoms that stay resident
    p.split_k = 1;
    p.split_r = (int)split;
  } else {
    // few rounds: blocks that split them would each stream all of k
    p.split_k = (int)(split < p.atoms ? split : p.atoms);
    const long long r = split / p.split_k;
    p.split_r = (int)(r < rounds ? r : (rounds > 1 ? rounds : 1));
  }
  p.atoms_per = (p.atoms + p.split_k - 1) / p.split_k;
  p.split_k = (p.atoms + p.atoms_per - 1) / p.atoms_per;
  p.stages = imin(p.atoms_per, DOT_RING);
  const int ring = p.stages * dot_stage_bytes(p.n_tile);
  const int epilogue = p.n_tile / 32 * DOT_C_BOX;
  p.smem = 1024 + (ring > epilogue ? ring : epilogue) + 8 * DOT_RING;
  p.blocks = p.tiles * p.split_k * p.split_r;
  p.bt_bytes = (g * n * p.kp + 255) / 256 * 256;
  p.scratch = p.bt_bytes + (k % 16 ? g * m * p.kp : 0);
  return p;
}

// The pre-pass, a 16-byte piece of k a thread. Blocks below bt_blocks
// turn B (g, k, n) into Bt (g, n, kp), K-major: Bt[gi][j][16c + i] =
// B[gi][16c + i][j] (neighbouring threads take neighbouring j, so each of
// the 16 loads is coalesced). The blocks above them widen A (g, m, k) to
// Ap (g, m, kp). Both zero beyond k.
struct alignas(16) Bytes16 {
  unsigned w[4];
};
static __device__ __forceinline__ Bytes16 gather16(const signed char* src, long long stride,
                                                   int valid) {
  Bytes16 v = {{0, 0, 0, 0}};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < valid) v.w[i / 4] |= (unsigned)(unsigned char)src[i * stride] << (8 * (i % 4));
  return v;
}

__global__ void __launch_bounds__(PACK_THREADS)
probe_i8dot_pack_kernel(const signed char* __restrict__ A, const signed char* __restrict__ B,
                        signed char* __restrict__ Ap, signed char* __restrict__ Bt, long long g,
                        int m, int k, int n, int kp, long long bt_blocks) {
  const int chunks = kp / 16;
  if ((long long)blockIdx.x < bt_blocks) {
    const long long e = (long long)blockIdx.x * PACK_THREADS + threadIdx.x;
    if (e >= g * chunks * n) return;
    const int j = (int)(e % n), c = (int)(e / n % chunks);
    const long long gi = e / n / chunks;
    *reinterpret_cast<Bytes16*>(Bt + (gi * n + j) * kp + 16 * c) =
        gather16(B + (gi * k + 16 * c) * n + j, n, k - 16 * c);
  } else {
    const long long e = ((long long)blockIdx.x - bt_blocks) * PACK_THREADS + threadIdx.x;
    if (e >= g * m * chunks) return;
    const long long row = e / chunks;
    const int c = (int)(e % chunks);
    *reinterpret_cast<Bytes16*>(Ap + row * kp + 16 * c) =
        gather16(A + row * k + 16 * c, 1, k - 16 * c);
  }
}

// `rounds` passes over one resident atom of KS k steps.
template <int N, int KS>
static __device__ __forceinline__ void dot_atom(int (&acc)[N / 2], const unsigned char* sa,
                                                const unsigned char* sb, int rounds) {
  const KOperand a = k_operand(sa), b = k_operand(sb);
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int s = 0; s < KS; ++s) wgmma_s8<N>(acc, k_advance(a, 32 * s), k_advance(b, 32 * s));
  }
}

// One stage: A's atom (64 rows) and then B's (N rows) at k byte k0.
static __device__ __forceinline__ void dot_issue(unsigned char* stage, int bytes, uint64_t* bar,
                                                 const TmaMap* ta, const TmaMap* tb, int k0,
                                                 int m0, int n0, int gi) {
  mbar_expect_tx(bar, bytes);
  tma_load_3d(stage, ta, bar, k0, m0, gi);
  tma_load_3d(stage + DOT_BM * DOT_ATOM, tb, bar, k0, n0, gi);
}

// Grid: p.blocks, a tile's split_k x split_r blocks side by side; A's map
// (g, m, k or kp) in boxes 128 x 64, Bt's (g, n, kp) in boxes 128 x N.
template <int N>
__global__ void __launch_bounds__(DOT_THREADS)
probe_i8dot_kernel(const __grid_constant__ TmaMap ta, const __grid_constant__ TmaMap tb,
                   const __grid_constant__ TmaMap tc, int n, int rounds, const DotPlan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_align1024(smem_raw);
  constexpr int STAGE = dot_stage_bytes(N);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.smem - 1024 - 8 * DOT_RING);
  const int split = p.split_k * p.split_r;
  long long bi = blockIdx.x;
  const int s = (int)(bi % split);
  bi /= split;
  const int m0 = (int)(bi / p.tiles_n % p.tiles_m) * DOT_BM, n0 = (int)(bi % p.tiles_n) * N;
  const int gi = (int)(bi / p.tiles_n / p.tiles_m);
  const int a0 = (s % p.split_k) * p.atoms_per, sr = s / p.split_k;
  const int na = imin(p.atoms_per, p.atoms - a0);
  const int my_rounds = rounds / p.split_r + (sr < rounds % p.split_r ? 1 : 0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) mbar_init(&full[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < p.stages && i < na; ++i)
      dot_issue(smem + i * STAGE, STAGE, &full[i], &ta, &tb, (a0 + i) * DOT_ATOM, m0, n0, gi);

  int acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  for (int i = 0; i < na; ++i) {
    const int slot = i % p.stages;
    mbar_wait(&full[slot], (unsigned)(i / p.stages) & 1);
    const unsigned char* sa = smem + slot * STAGE;
    const unsigned char* sb = sa + DOT_BM * DOT_ATOM;
    wgmma_fence_acc(acc);
    wgmma_fence();
    switch (imin(4, p.ksteps - 4 * (a0 + i))) {
      case 1: dot_atom<N, 1>(acc, sa, sb, my_rounds); break;
      case 2: dot_atom<N, 2>(acc, sa, sb, my_rounds); break;
      case 3: dot_atom<N, 3>(acc, sa, sb, my_rounds); break;
      default: dot_atom<N, 4>(acc, sa, sb, my_rounds); break;
    }
    wgmma_commit();
    wgmma_wait<1>();
    __syncthreads();  // atom i - 1's products are done in every warp: its slot is free
    if (threadIdx.x == 0 && i >= 1 && i - 1 + p.stages < na) {
      const int prev = (i - 1) % p.stages;
      dot_issue(smem + prev * STAGE, STAGE, &full[prev], &ta, &tb,
                (a0 + i - 1 + p.stages) * DOT_ATOM, m0, n0, gi);
    }
  }
  wgmma_wait<0>();
  wgmma_fence_acc(acc);

  // C's tile through shared memory, in boxes of 32 words x 64 rows in the
  // 128-byte swizzle (conflict-free 8-byte writes of the fragments)
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  __syncthreads();  // every warp's products are done: the ring becomes C's tile
  unsigned char* st = smem;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int2 v;
      v.x = acc[4 * j + 2 * h];
      v.y = acc[4 * j + 2 * h + 1];
      *reinterpret_cast<int2*>(st + (j / 4) * DOT_C_BOX +
                               swz128(16 * w + l / 4 + 8 * h, 4 * (8 * (j % 4) + 2 * (l % 4)))) = v;
    }
  // the TMA unit writes the boxes, clipped at m and at C's rows (n rounded
  // up to 4 words: a multiple of 16 bytes)
  tma_store_fence();
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int b = 0; b < N / 32 && n0 + 32 * b < n; ++b)
      tma_store_3d(&tc, st + b * DOT_C_BOX, split > 1, n0 + 32 * b, m0, gi);
    tma_store_wait();
  }
}

// ------------------------------------------------------------ entry points
template <int OP, class T, int SP>
static int chain_launch(const void* x, const void* y, void* out, int64_t n, int iters,
                        const ChainPlan& p, void* stream) {
  void (*kernel)(const T*, const T*, T*, long long, int, int, int, int) =
      probe_chain_kernel<OP, T, SP>;
  const int smem = p.split > 1 ? CHAIN_THREADS * SP * (int)sizeof(T) : 0;
  OMR_LAUNCH(kernel, (unsigned)p.blocks, CHAIN_THREADS, smem, stream, (const T*)x,
             (const T*)y, (T*)out, (long long)n, iters, p.split, 0, 1);
  return (int)cudaGetLastError();
}

template <int OP, class T>
static int chain_per_thread(const void* x, const void* y, void* out, int64_t n, int iters,
                            const ChainPlan& p, void* stream) {
  switch (p.per_thread) {
    case 1: return chain_launch<OP, T, 1>(x, y, out, n, iters, p, stream);
    case 2: return chain_launch<OP, T, 2>(x, y, out, n, iters, p, stream);
    case 4: return chain_launch<OP, T, 4>(x, y, out, n, iters, p, stream);
    case 8: return chain_launch<OP, T, 8>(x, y, out, n, iters, p, stream);
    case 16: return chain_launch<OP, T, 16>(x, y, out, n, iters, p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

static const int CHAIN_WORD_BYTES[3] = {4, 8, 4};  // by dtype: int32, int64, float32

// The layout of a chain of n elements of `dtype` and `streams` streams for
// `sms` SMs (chain_plan): out = {per_thread, split, blocks}.
extern "C" int omr_probe_chain_plan(int64_t n, int dtype, int streams, int sms, int64_t* out) {
  if (n <= 0 || dtype < 0 || dtype > 2 || (streams != 1 && streams != 4 && streams != 16) ||
      sms <= 0)
    return (int)cudaErrorInvalidValue;
  const ChainPlan p = chain_plan(n, streams, CHAIN_WORD_BYTES[dtype], sms);
  const int64_t v[3] = {p.per_thread, p.split, p.blocks};
  memcpy(out, v, sizeof(v));
  return 0;
}

// x, y, out (n) contiguous, of the type `dtype` names (0 int32, 1 int64,
// 2 float32); op a ProbeOp: int32 takes ADD .. MULHI_ADD and MULWIDE_ADD,
// int64 MUL_ADD, float32 FMA; streams 1, 4 or 16, each element's split
// over `split` adjacent threads (a power of two up to streams: the
// plan's, or any other to time it).
extern "C" int omr_probe_chain(int op, int dtype, int streams, const void* x, const void* y,
                               void* out, int64_t n, int iters, int split, void* stream) {
  if (n <= 0 || iters < 0 || dtype < 0 || dtype > 2 ||
      (streams != 1 && streams != 4 && streams != 16) || split < 1 || split > streams ||
      (split & (split - 1)))
    return (int)cudaErrorInvalidValue;
  const ChainPlan p = chain_layout(n, streams, split);
  if (p.blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
#define OMR_CHAIN(OP, T)                                                  \
  if (op == OP) return chain_per_thread<OP, T>(x, y, out, n, iters, p, stream);
  if (dtype == 0) {
    OMR_CHAIN(ADD, int)
    OMR_CHAIN(MUL, int)
    OMR_CHAIN(MUL_ADD, int)
    OMR_CHAIN(SUB_ADD, int)
    OMR_CHAIN(SHIFT_ADD, int)
    OMR_CHAIN(MASK_ADD, int)
    OMR_CHAIN(SEL_ADD, int)
    OMR_CHAIN(MULHI_ADD, int)
    OMR_CHAIN(MULWIDE_ADD, int)
  } else if (dtype == 1) {
    OMR_CHAIN(MUL_ADD, long long)
  } else if (dtype == 2) {
    OMR_CHAIN(FMA, float)
  }
#undef OMR_CHAIN
  return (int)cudaErrorInvalidValue;
}

template <int S>
static int mac_launch(const int* x, const int* y, int* out, int64_t n, int iters, void* stream) {
  OMR_LAUNCH(probe_mac_kernel<S>, (unsigned)((n + 127) / 128), 128, 0, stream, x, y, out,
             (long long)n, iters);
  return (int)cudaGetLastError();
}

// x, y, out (n) int32; streams 1, 4 or 16.
extern "C" int omr_probe_mac(int streams, const int* x, const int* y, int* out, int64_t n,
                             int iters, void* stream) {
  if (n <= 0 || n > (int64_t)INT32_MAX * 128 || iters < 0) return (int)cudaErrorInvalidValue;
  switch (streams) {
    case 1: return mac_launch<1>(x, y, out, n, iters, stream);
    case 4: return mac_launch<4>(x, y, out, n, iters, stream);
    case 16: return mac_launch<16>(x, y, out, n, iters, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <int N>
static int dot_launch(const TmaMap& ta, const TmaMap& tb, const TmaMap& tc, int n, int rounds,
                      const DotPlan& p, void* stream) {
  const cudaError_t rc = allow_smem(probe_i8dot_kernel<N>, p.smem);
  if (rc != cudaSuccess) return (int)rc;
  OMR_LAUNCH(probe_i8dot_kernel<N>, (unsigned)p.blocks, DOT_THREADS, p.smem, stream, ta, tb, tc,
             n, rounds, p);
  return (int)cudaGetLastError();
}

// The cut of a product (dot_plan) for `sms` SMs: out = {n_tile, split_k,
// split_r, stages, blocks, smem, kp, scratch}; the wrapper gives
// omr_probe_i8dot `scratch` bytes for Bt (g, n, kp) and, where k is not a
// multiple of 16, Ap (g, m, kp).
extern "C" int omr_probe_i8dot_plan(int64_t g, int m, int k, int n, int rounds, int sms,
                                    int64_t* out) {
  if (g <= 0 || m <= 0 || k <= 0 || n <= 0 || rounds < 0 || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const DotPlan p = dot_plan(g, m, k, n, rounds, sms);
  const int64_t v[8] = {p.n_tile, p.split_k, p.split_r, p.stages, p.blocks, p.smem, p.kp,
                        p.scratch};
  memcpy(out, v, sizeof(v));
  return 0;
}

// a (g, m, k) (16-byte aligned), b (g, k, n) int8 and c (g, m, nc) int32,
// contiguous, nc = n rounded up to 4 (TMA's 16-byte rows; columns n .. nc - 1
// come out zero); scratch as omr_probe_i8dot_plan says. Zeroes C where
// blocks share a tile, then two launches: the pre-pass, then the product.
extern "C" int omr_probe_i8dot(const void* a, const void* b, void* c, void* scratch, int64_t g,
                               int m, int k, int n, int rounds, int sms, void* stream) {
  if (g <= 0 || m <= 0 || k <= 0 || n <= 0 || rounds < 0 || sms <= 0 || !scratch ||
      reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(scratch) % 16)
    return (int)cudaErrorInvalidValue;
  const DotPlan p = dot_plan(g, m, k, n, rounds, sms);
  if (p.blocks > INT32_MAX || g > INT32_MAX || p.smem > SMEM_BLOCK_MAX)
    return (int)cudaErrorInvalidValue;
  signed char* bt = static_cast<signed char*>(scratch);
  signed char* ap = k % 16 ? bt + p.bt_bytes : nullptr;
  const long long bt_blocks = (g * n * (p.kp / 16) + PACK_THREADS - 1) / PACK_THREADS;
  const long long ap_blocks = ap ? (g * m * (p.kp / 16) + PACK_THREADS - 1) / PACK_THREADS : 0;
  if (bt_blocks + ap_blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int nc = (n + 3) / 4 * 4;
  int rc = 0;
  if (p.split_k * p.split_r > 1)
    rc = (int)cudaMemsetAsync(c, 0, (size_t)g * m * nc * sizeof(int), (cudaStream_t)stream);
  if (rc) return rc;
  OMR_LAUNCH(probe_i8dot_pack_kernel, (unsigned)(bt_blocks + ap_blocks), PACK_THREADS, 0, stream,
             (const signed char*)a, (const signed char*)b, ap, bt, (long long)g, m, k, n, p.kp,
             bt_blocks);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  TmaMap ta, tb, tc;
  rc = tma_map_3d(&ta, ap ? ap : a, 1, ap ? p.kp : k, m, g, DOT_ATOM, DOT_BM);
  if (!rc) rc = tma_map_3d(&tb, bt, 1, p.kp, n, g, DOT_ATOM, p.n_tile);
  if (!rc) rc = tma_map_3d(&tc, c, 4, nc, m, g, 32, DOT_BM);
  if (rc) return rc;
  switch (p.n_tile) {
    case 64: return dot_launch<64>(ta, tb, tc, nc, rounds, p, stream);
    case 128: return dot_launch<128>(ta, tb, tc, nc, rounds, p, stream);
    default: return dot_launch<256>(ta, tb, tc, nc, rounds, p, stream);
  }
}
