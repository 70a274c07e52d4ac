// Fused alignment scorer for Hopper (sm_90a): the production entry.
//
// Replaces the TPU kernel mpi_openmp_cuda_tpu/ops/pallas_scorer.py::_kernel
// / _pair (launched by _pallas_call, fed by _pallas_best): for each (Seq1,
// Seq2) pair one int32 row [score, n, k, eq], the best candidate over
// offsets and hyphen positions with the reference's first-hit order, and
// the equal-length score; or, asked for finished rows, the answer row
// (score, n, k) at the pair's input position (finish_rows.cuh).  The
// kernels, their math, what bounds them on the H100 (integer issue and
// shared-memory lookups) and what the design does about it are in
// fused_kernels.cuh; this file instantiates the full kernel, fused::base,
// and nothing else.

#include "fused_kernels.cuh"

// The operands are those of fused::launch: split the segments a (pair,
// tile), 0 for the width's default; with done nullptr the raw [B, 4] rows
// in out, else the finished rows at their input positions in done.
// Returns the first CUDA error of the launches (0 on success).
extern "C" int fused_scorer_launch(const unsigned char* seq1ext,
                                   int len1,
                                   const unsigned char* rows, const int* lens,
                                   int batch, int l2p, int split,
                                   int ntiles,
                                   const int* val, int* partial, int* out,
                                   int* done, const long long* dst, int row0,
                                   cudaStream_t stream) {
  return static_cast<int>(fused::launch<fused::base>(
      seq1ext, len1, rows, lens, batch, l2p, split, ntiles, val, partial, out,
      done, dst, row0, stream));
}

// Dynamic shared memory a tile block takes at row width l2p and split (0:
// the width's default), in bytes.
extern "C" long long fused_scorer_smem(int l2p, int split) {
  return static_cast<long long>(fused::tile_shape(l2p, split).smem);
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

// Registers, static shared memory and the thread limit of the production
// kernels as cudaFuncGetAttributes reports them (which = 0: the tile
// kernel, 1: the finish kernel).  Returns the CUDA error (0 on success).
extern "C" int fused_scorer_attrs(int which, int* regs, long long* static_smem,
                                  int* max_threads) {
  cudaFuncAttributes a = {};
  cudaError_t err = which == 0
      ? cudaFuncGetAttributes(&a, fused::tile_kernel<fused::base>)
      : which == 1 ? cudaFuncGetAttributes(&a, fused::finish_kernel<fused::base>)
                   : cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *static_smem = static_cast<long long>(a.sharedSizeBytes);
  *max_threads = a.maxThreadsPerBlock;
  return 0;
}
