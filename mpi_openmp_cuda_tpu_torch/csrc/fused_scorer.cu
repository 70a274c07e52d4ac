// Fused alignment scorer for Hopper (sm_90a): the production entry.
//
// Replaces the TPU kernel mpi_openmp_cuda_tpu/ops/pallas_scorer.py::_kernel
// / _pair (launched by _pallas_call, fed by _pallas_best): for each (Seq1,
// Seq2) pair one int32 row [score, n, k, eq], the best candidate over
// offsets and hyphen positions with the reference's first-hit order, and
// the equal-length score.  The kernels, their math, what bounds them on the
// H100 (integer issue and shared-memory lookups) and what the design does
// about it are in fused_kernels.cuh; this file instantiates the full
// kernel, fused::base, and nothing else.

#include "fused_kernels.cuh"

// The operands are those of fused::launch.  Returns the first CUDA error of
// the launches (0 on success).
extern "C" int fused_scorer_launch(const int* seq1ext, int len1,
                                   const int* rows, const int* lens,
                                   int batch, int l2p, int ntiles,
                                   const int* val, int* partial, int* out,
                                   cudaStream_t stream) {
  return static_cast<int>(fused::launch<fused::base>(
      seq1ext, len1, rows, lens, batch, l2p, ntiles, val, partial, out,
      stream));
}

// Dynamic shared memory a tile block takes at row width l2p, in bytes.
extern "C" long long fused_scorer_smem(int l2p) {
  return static_cast<long long>(fused::tile_shape(l2p).smem);
}

// Dynamic shared memory the current device allows a block after opting
// in, in bytes (a negative CUDA error code when it cannot be read).
extern "C" long long fused_scorer_smem_limit() {
  int dev = 0;
  int bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err == cudaSuccess ? bytes : -static_cast<long long>(err);
}
