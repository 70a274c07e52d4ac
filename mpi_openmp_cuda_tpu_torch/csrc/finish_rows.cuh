// The one store a pair of the finish kernels of fused_kernels.cuh and
// packed_scorer.cu, in either of their two modes.
//
// Raw (done == nullptr): [s, n, k] at out[4b .. 4b + 2], beside the tile
// kernel's eq at out[4b + 3]: the [B, 4] row of the kernels' contract, for
// callers whose rows are candidates and not answers (the Seq1 ring's windows
// carry a block-local Seq1 length, so no rule below applies to them).
//
// Finished (done != nullptr): the row ops/cuda_scorer.py::finish_rows makes
// of the raw one (the JAX package's _pallas_rows), at its input position
// done[3 * (dst ? dst[b] : row0 + b)]:
//   len2 == len1       -> (eq, 0, 0), eq read back from out[4b + 3], which
//                         the tile kernel wrote and griddepcontrol.wait made
//                         visible;
//   0 < len2 < len1    -> (s, n, k);
//   len2 == 0 or len2 > len1 -> (INT_MIN, 0, 0).
// It replaces the O(B) PyTorch epilogue a dispatch ran after its launches
// (a handful of compares, wheres, a cat and a scatter, a kernel each) by a
// 12-byte store a pair in a kernel that already holds every operand.  The
// mode is a runtime pointer, uniform over the grid, not a template
// parameter: one instantiation serves both, so no build compiles twice.
#pragma once

#include <climits>

namespace finish_rows {

__device__ __forceinline__ void store(int* out, int* done, const long long* dst,
                                      int row0, int b, int len1, int len2,
                                      int s, int n, int k) {
  if (done == nullptr) {
    out[4 * b] = s;
    out[4 * b + 1] = n;
    out[4 * b + 2] = k;
    return;
  }
  const bool searchable = len2 > 0 && len2 < len1;
  int* row = done + 3 * (dst != nullptr ? dst[b] : static_cast<long long>(row0) + b);
  row[0] = len2 == len1 ? out[4 * b + 3] : searchable ? s : INT_MIN;
  row[1] = searchable ? n : 0;
  row[2] = searchable ? k : 0;
}

}  // namespace finish_rows
