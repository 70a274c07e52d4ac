// Row-packed alignment scorer for Hopper (sm_90a).
//
// Replaces the TPU kernel mpi_openmp_cuda_tpu/ops/pallas_scorer.py::
// _kernel_packed (launched by _pallas_call_packed, fed by
// _pallas_best_packed).  It serves buckets whose every Seq2 has
// len2 <= l2s, l2s in {8, 16, 32, 64} (dispatch.choose_rowpack), with the
// output row contract of fused_scorer.cu: [score, n, k, eq] per pair,
// first hit in offset-major, k-ascending order with k = 0 first;
// unsearchable pairs carry (INT32_MIN, 0, 0).
//
// What bounds it on the H100: integer issue and shared-memory lookups, as
// in the fused kernel.  At short rows the fused kernel's block per (pair,
// 128-offset tile) spends a large share of its time on per-block work that
// does not depend on the row length: staging the 27x27 table and the Seq1
// window, the block reduction, the partial write.  Here one block of 128
// threads holds p = 128 / l2s pairs over one 128-offset tile, so that
// per-block work is shared by p pairs.  Each pair gets l2s threads; each
// thread walks the offsets n0 + lane, n0 + lane + l2s, ... of its pair in
// ascending order (strict '>' keeps the first hit), and the char loop's
// bound l2s is a template parameter, so it unrolls fully (positions past
// len2 break out; the pad code's zeroed table row would add nothing).  The
// l2s lanes of a pair reduce by (max score, smallest n) in shared memory
// to one partial per (pair, tile); the second small kernel of
// first_hit.cuh reduces each pair's live tiles in offset order.  Scores stay
// plain int32 words (no packed score/key word), so the gate is the one of
// ops/bounds.py: 2 * len2 * max|v| < 2^31.

#include <climits>
#include <cuda_runtime.h>

#include "first_hit.cuh"

namespace {

using first_hit::better;
constexpr int kBlock = first_hit::kTile;  // threads = offsets per tile
constexpr int kAlpha = 27;

template <int L2S>
__global__ void __launch_bounds__(kBlock)
packed_tile_kernel(const int* __restrict__ seq1ext, int len1,
                   const int* __restrict__ rows, const int* __restrict__ lens,
                   int batch, int l2p, const int* __restrict__ val,
                   int* __restrict__ partial, int* __restrict__ out,
                   int ntiles) {
  constexpr int P = kBlock / L2S;  // pairs per block
  __shared__ int sval[kAlpha * kAlpha];  // row/col 0 zeroed
  __shared__ int win[kBlock + L2S + 1];  // Seq1 window of this tile
  __shared__ int s2[kBlock];             // P rows of L2S codes * 27
  __shared__ int red_s[kBlock], red_n[kBlock], red_k[kBlock];
  __shared__ int live_tile;

  const int tid = threadIdx.x;
  const int slot = tid / L2S;
  const int lane = tid % L2S;
  const int b = blockIdx.x * P + slot;
  const int t = blockIdx.y;
  const int n0 = t * kBlock;
  const bool real = b < batch;
  const int len2 = real ? lens[b] : 0;
  const int nvalid = len1 - len2;  // offsets n < nvalid are candidates

  // Offset-tile skip: the tile runs when any of its pairs has a valid
  // offset in it; tile 0 always runs (it carries eq).
  if (tid == 0) live_tile = t == 0;
  __syncthreads();
  if (real && lane == 0 && n0 < nvalid) live_tile = 1;
  __syncthreads();
  if (!live_tile) return;  // block-uniform

  for (int j = tid; j < kAlpha * kAlpha; j += kBlock) sval[j] = val[j];
  for (int j = tid; j < kBlock + L2S + 1; j += kBlock) win[j] = seq1ext[n0 + j];
  s2[tid] = real ? rows[static_cast<size_t>(b) * l2p + lane] * kAlpha : 0;
  __syncthreads();

  const int* row = s2 + slot * L2S;
  int bs = INT_MIN, bn = 0, bk = 0;
  for (int m = lane; m < kBlock; m += L2S) {
    const int n = n0 + m;
    if (!(n < nvalid || n == 0)) break;  // ascending n: the rest is invalid
    int t1 = 0, g = 0, gbest = INT_MIN, kbest = 0;
    int c0 = win[m];
#pragma unroll
    for (int i = 0; i < L2S; ++i) {
      if (i >= len2) break;
      const int* vr = sval + row[i];
      const int c1 = win[m + i + 1];
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
    if (n == 0 && real) out[4 * b + 3] = t1 + g;  // eq: k = 0 at n = 0
    if (n < nvalid) {
      const int s = gbest > g ? t1 + gbest : t1 + g;
      if (s > bs) {
        bs = s;
        bn = n;
        bk = gbest > g ? kbest : 0;
      }
    }
  }

  red_s[tid] = bs;
  red_n[tid] = bn;
  red_k[tid] = bk;
  for (int st = L2S / 2; st > 0; st >>= 1) {
    __syncthreads();
    if (lane < st && better(red_s[tid + st], red_n[tid + st], red_s[tid],
                            red_n[tid])) {
      red_s[tid] = red_s[tid + st];
      red_n[tid] = red_n[tid + st];
      red_k[tid] = red_k[tid + st];
    }
  }
  if (real && lane == 0) {
    int* part = partial + 3 * (static_cast<size_t>(b) * ntiles + t);
    part[0] = red_s[tid];
    part[1] = red_n[tid];
    part[2] = red_k[tid];
  }
}

template <int L2S>
cudaError_t launch(const int* seq1ext, int len1, const int* rows,
                   const int* lens, int batch, int l2p, int ntiles,
                   const int* val, int* partial, int* out,
                   cudaStream_t stream) {
  constexpr int P = kBlock / L2S;
  const dim3 grid((batch + P - 1) / P, ntiles);
  packed_tile_kernel<L2S><<<grid, kBlock, 0, stream>>>(
      seq1ext, len1, rows, lens, batch, l2p, val, partial, out, ntiles);
  return cudaGetLastError();
}

}  // namespace

// seq1ext: [ntiles * 128 + l2p + 1] int32 codes; rows: [batch, l2p] int32,
// every len2 <= l2s <= l2p; lens: [batch] int32; val: [27 * 27] int32 with
// row/col 0 zeroed; partial: [batch, ntiles, 3] int32 scratch; out:
// [batch, 4] int32.  Returns cudaGetLastError() after the launches (0 on
// success), or cudaErrorInvalidValue for an l2s outside {8, 16, 32, 64}.
extern "C" int packed_scorer_launch(const int* seq1ext, int len1,
                                    const int* rows, const int* lens,
                                    int batch, int l2p, int l2s, int ntiles,
                                    const int* val, int* partial, int* out,
                                    cudaStream_t stream) {
  if (batch == 0) return 0;
  cudaError_t err;
  switch (l2s) {
    case 8:
      err = launch<8>(seq1ext, len1, rows, lens, batch, l2p, ntiles, val,
                      partial, out, stream);
      break;
    case 16:
      err = launch<16>(seq1ext, len1, rows, lens, batch, l2p, ntiles, val,
                       partial, out, stream);
      break;
    case 32:
      err = launch<32>(seq1ext, len1, rows, lens, batch, l2p, ntiles, val,
                       partial, out, stream);
      break;
    case 64:
      err = launch<64>(seq1ext, len1, rows, lens, batch, l2p, ntiles, val,
                       partial, out, stream);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      first_hit::launch_reduce(partial, lens, len1, batch, ntiles, out, stream));
}
