// Fused alignment scorer for Hopper (sm_90a).
//
// Replaces the TPU kernel mpi_openmp_cuda_tpu/ops/pallas_scorer.py::_kernel
// / _pair (launched by _pallas_call, fed by _pallas_best).  Same contract:
// for each (Seq1, Seq2) pair, one row [score, n, k, eq] where (score, n, k)
// is the best candidate over offsets n < len1 - len2 and hyphen positions k
// (k = 0: hyphen after the end), first hit in offset-major, k-ascending
// order with k = 0 first, and eq is the k = 0 score at n = 0 (the
// equal-length answer).  Unsearchable pairs (no valid offset) carry
// (INT32_MIN, 0, 0).
//
// Math, per offset n, streaming over the Seq2 characters i < len2:
//   d0 = val[s2[i]][s1[n+i]]     (unshifted diagonal)
//   d1 = val[s2[i]][s1[n+i+1]]   (hyphen-shifted diagonal)
//   t1 += d1;  G += d0 - d1      (G after i+1 chars = G[kappa = i+1])
//   score(n, k >= 1) = t1 + G[k],  score(n, 0) = t1 + G[len2]
// A strict '>' running max over G[kappa], kappa < len2, keeps the first
// kappa; the k = 0 candidate wins ties with every k >= 1.
//
// What bounds it on the H100: integer issue and shared-memory lookups.
// Each (offset, char) cell costs one window load, one broadcast Seq2 load,
// two value-table lookups and about six int32 ops; the inputs are a few
// hundred KB, so device memory is never the limit.  The design therefore
// keeps everything a cell touches in shared memory (the zeroed 27x27
// table, the pair's Seq2 row pre-multiplied by 27, and the Seq1 window of
// this block's 128 offsets), reuses the shifted Seq1 char of step i as the
// unshifted one of step i+1 (three shared loads per cell, no conflicts:
// window loads are consecutive, table loads fall in one 27-word row), runs
// one thread per offset so no thread waits on another, and skips offset
// tiles with no valid offset (tile 0 always runs: it carries eq) and every
// char past len2.  Arithmetic is int32 throughout (ops/bounds.py derives
// the gate 2 * len2 * max|v| < 2^31).
//
// Work split: grid (pairs, offset tiles of 128); block = 128 threads, one
// per offset.  A first-hit block reduction (max score, smallest n) writes
// one partial [score, n, k] per (pair, tile) to a scratch buffer; a second
// small kernel (first_hit.cuh) reduces each pair's live tiles in offset
// order.

#include <climits>
#include <cuda_runtime.h>

#include "first_hit.cuh"

namespace {

using first_hit::better;
constexpr int kTile = first_hit::kTile;  // offsets per block, one per thread
constexpr int kAlpha = 27;  // character codes 0 (pad) .. 26
constexpr int kWarps = kTile / 32;

__global__ void __launch_bounds__(kTile)
fused_tile_kernel(const int* __restrict__ seq1ext, int len1,
                  const int* __restrict__ rows, const int* __restrict__ lens,
                  int l2p, const int* __restrict__ val,
                  int* __restrict__ partial, int* __restrict__ out,
                  int ntiles) {
  extern __shared__ int smem[];
  int* sval = smem;                  // [27 * 27], row/col 0 zeroed
  int* s2 = sval + kAlpha * kAlpha;  // [len2] Seq2 codes * 27
  int* win = s2 + l2p;               // [kTile + len2 + 1] Seq1 window
  __shared__ int red[3][kWarps];

  const int b = blockIdx.x;
  const int t = blockIdx.y;
  const int tid = threadIdx.x;
  const int n0 = t * kTile;
  const int len2 = lens[b];
  const int nvalid = len1 - len2;  // offsets n < nvalid are candidates
  if (t > 0 && n0 >= nvalid) return;  // offset-tile skip (block-uniform)

  for (int j = tid; j < kAlpha * kAlpha; j += kTile) sval[j] = val[j];
  const int* row = rows + static_cast<size_t>(b) * l2p;
  for (int j = tid; j < len2; j += kTile) s2[j] = row[j] * kAlpha;
  for (int j = tid; j < kTile + len2 + 1; j += kTile) win[j] = seq1ext[n0 + j];
  __syncthreads();

  const int n = n0 + tid;
  int t1 = 0, g = 0, gbest = INT_MIN, kbest = 0;
  if (n < nvalid || n == 0) {
    int c0 = win[tid];
    for (int i = 0; i < len2; ++i) {
      const int* vr = sval + s2[i];
      const int c1 = win[tid + i + 1];
      const int d0 = vr[c0];
      const int d1 = vr[c1];
      t1 += d1;
      g += d0 - d1;
      if (i + 1 < len2 && g > gbest) {
        gbest = g;
        kbest = i + 1;
      }
      c0 = c1;
    }
  }
  if (t == 0 && tid == 0) out[4 * b + 3] = t1 + g;  // eq: k = 0 at n = 0

  int s = INT_MIN, bn = 0, bk = 0;
  if (n < nvalid) {
    bn = n;
    if (gbest > g) {
      s = t1 + gbest;
      bk = kbest;
    } else {
      s = t1 + g;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int os = __shfl_down_sync(0xffffffffu, s, off);
    const int on = __shfl_down_sync(0xffffffffu, bn, off);
    const int ok = __shfl_down_sync(0xffffffffu, bk, off);
    if (better(os, on, s, bn)) {
      s = os;
      bn = on;
      bk = ok;
    }
  }
  const int warp = tid / 32;
  if ((tid & 31) == 0) {
    red[0][warp] = s;
    red[1][warp] = bn;
    red[2][warp] = bk;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) {
      if (better(red[0][w], red[1][w], s, bn)) {
        s = red[0][w];
        bn = red[1][w];
        bk = red[2][w];
      }
    }
    int* part = partial + 3 * (static_cast<size_t>(b) * ntiles + t);
    part[0] = s;
    part[1] = bn;
    part[2] = bk;
  }
}

}  // namespace

// seq1ext: [ntiles * 128 + l2p + 1] int32 codes; rows: [batch, l2p] int32;
// lens: [batch] int32; val: [27 * 27] int32 with row/col 0 zeroed;
// partial: [batch, ntiles, 3] int32 scratch; out: [batch, 4] int32.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int fused_scorer_launch(const int* seq1ext, int len1,
                                   const int* rows, const int* lens,
                                   int batch, int l2p, int ntiles,
                                   const int* val, int* partial, int* out,
                                   cudaStream_t stream) {
  if (batch == 0) return 0;
  // 19.8 KB at the Seq2 cap (l2p = 2048): under the 48 KB default.
  const size_t smem =
      sizeof(int) * (kAlpha * kAlpha + l2p + kTile + l2p + 1);
  fused_tile_kernel<<<dim3(batch, ntiles), kTile, smem, stream>>>(
      seq1ext, len1, rows, lens, l2p, val, partial, out, ntiles);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      first_hit::launch_reduce(partial, lens, len1, batch, ntiles, out, stream));
}
