// The profiled instantiations of the paired blind rotation
// (blind_rotate.cuh BrProfiled) at the reference rings: the production
// template with stage clocks, in a source of its own so that nvcc builds
// them beside blind_rotate.cu (utils/build.py starts one nvcc a source).
// benches/probe_step_torch.py reads the clocks.
#include "blind_rotate.cuh"

// A profiled launch of the reference ring's configuration C: the stage
// clocks go to ``clocks`` (blocks, BR_STAGES) int64, added to what it holds;
// ``planes`` non-zero stamps every key plane (BrProfiled).
template <class C>
static int launch_profiled(const BrArgs& a, long long* clocks, int planes) {
  cudaError_t err = cudaMemcpyToSymbolAsync(br_stage_clocks, &clocks, sizeof(clocks), 0,
                                            cudaMemcpyHostToDevice, (cudaStream_t)a.stream);
  if (err != cudaSuccess) return (int)err;
  return planes ? launch<BrProfiled<C, true>>(a) : launch<BrProfiled<C, false>>(a);
}

// omr_blind_rotate through the profiled instantiation of the reference
// rings (BrL1, BrL2 only), with the stage clocks buffer ``clocks`` of
// (blocks, omr_blind_rotate_stages()) int64 words; ``planes`` 0 leaves out
// the stamps of each key plane (the staging is counted in the MAC).
extern "C" int omr_blind_rotate_profiled(
    const int64_t* acc_in, int64_t* acc_out, const int64_t* amounts,
    int64_t n_msgs, int n_steps, const void* key, const void* mono,
    const int* orders, const void* tw_fwd, const void* tw_inv, uint64_t n_inv,
    uint64_t n_inv_sh, int log_n, int64_t q, int d, int log_b, int blocks,
    void* stream, int64_t* clocks, int planes) {
  const BrArgs a{acc_in, acc_out, amounts, n_msgs, n_steps, key, mono, orders,
                 tw_fwd, tw_inv, n_inv, n_inv_sh, log_n, d, log_b, q, blocks, stream};
  long long* c = reinterpret_cast<long long*>(clocks);
  if (matches<BrL1>(a)) return launch_profiled<BrL1>(a, c, planes);
  if (matches<BrL2>(a)) return launch_profiled<BrL2>(a, c, planes);
  return (int)cudaErrorInvalidValue;
}

extern "C" int omr_blind_rotate_stages() { return BR_STAGES; }
