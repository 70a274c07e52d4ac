// First-hit reduction shared by fused_scorer.cu and packed_scorer.cu.
//
// Both kernels score a pair over 128-offset tiles in independent blocks and
// write one partial [score, n, k] per (pair, tile).  The reference order is
// offset-major, so among equal scores the smallest offset wins; within a
// tile that is `better` below, across tiles it is a walk over the pair's
// live tiles in ascending order with a strict '>'.
#pragma once

#include <cuda_runtime.h>

namespace first_hit {

constexpr int kTile = 128;  // offsets per tile

__device__ __forceinline__ bool better(int s, int n, int bs, int bn) {
  return s > bs || (s == bs && n < bn);
}

// One thread per pair: out[4b..4b+2] = best partial over the live tiles
// (tile 0 always; tile t while t * 128 < len1 - len2).
__global__ void reduce_tiles(const int* __restrict__ partial,
                             const int* __restrict__ lens, int len1,
                             int batch, int ntiles, int* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int nvalid = len1 - lens[b];
  int live = nvalid > 0 ? (nvalid + kTile - 1) / kTile : 1;
  if (live > ntiles) live = ntiles;
  const int* p = partial + 3 * static_cast<size_t>(b) * ntiles;
  int s = p[0], n = p[1], k = p[2];
  for (int t = 1; t < live; ++t) {
    if (p[3 * t] > s) {
      s = p[3 * t];
      n = p[3 * t + 1];
      k = p[3 * t + 2];
    }
  }
  out[4 * b] = s;
  out[4 * b + 1] = n;
  out[4 * b + 2] = k;
}

inline cudaError_t launch_reduce(const int* partial, const int* lens,
                                 int len1, int batch, int ntiles, int* out,
                                 cudaStream_t stream) {
  reduce_tiles<<<(batch + 127) / 128, 128, 0, stream>>>(partial, lens, len1,
                                                         batch, ntiles, out);
  return cudaGetLastError();
}

}  // namespace first_hit
