// Stage ablation of the fused alignment scorer for Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/kernel_ablate.py::_kernel_var / _pair_var
// (pallas_call in _call), a switchable copy of the production _pair in
// which each variant drops one stage, so that timing a variant against the
// full kernel attributes time to that stage.  Here the switches are the
// template parameter of the kernels in fused_kernels.cuh (its note lists
// the stages and what each variant does instead), so `base` is the
// production kernel of fused_scorer.cu by construction.  Each variant drops
// one stage; ablations are not composed:
//
//   base       nothing: the production kernel
//   nostage    the shared-memory staging
//   nolookup   the table gathers
//   nodiag     the shared diagonals
//   nomax      the running max over G per offset
//   nocombine  the segment combine
//   noreduce   the first-hit reduction over offsets and tiles
//   nok        the recovery of k for the winning offset
//   noskip     the offset-tile skip
//
// What bounds it is what bounds the production kernel (integer issue and
// shared-memory lookups); the variants say how much of its time each stage
// holds.  The wrapper lives in scripts/torch_kernel_ablate.py, never in the
// production modules: ablations break semantics.

#include "fused_kernels.cuh"

// var: a fused::Variant id.  The operands are those of fused::launch at
// the width's default split;
// partial holds [batch, ntiles, 2] int32 words, or [batch, ntiles, 128, 2]
// for noreduce.  Returns the first CUDA error of the launches (0 on
// success).
extern "C" int ablate_scorer_launch(int var, const unsigned char* seq1ext,
                                    int len1,
                                    const unsigned char* rows,
                                    const int* lens,
                                    int batch, int l2p, int ntiles,
                                    const int* val, int* partial, int* out,
                                    cudaStream_t stream) {
  using namespace fused;
  switch (var) {
#define ABLATE_CASE(V)                                                   \
  case V:                                                                \
    return static_cast<int>(launch<V>(seq1ext, len1, rows, lens, batch,  \
                                      l2p, 0, ntiles, val, partial, out, \
                                      nullptr, nullptr, 0, stream));
    ABLATE_CASE(base)
    ABLATE_CASE(nostage)
    ABLATE_CASE(nolookup)
    ABLATE_CASE(nodiag)
    ABLATE_CASE(nomax)
    ABLATE_CASE(nocombine)
    ABLATE_CASE(noreduce)
    ABLATE_CASE(nok)
    ABLATE_CASE(noskip)
#undef ABLATE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
