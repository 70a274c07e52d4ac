// Stage ablation of the fused alignment scorer for Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/kernel_ablate.py::_kernel_var / _pair_var
// (pallas_call in _call), a switchable copy of the production _pair in
// which each variant drops one stage, so that timing a variant against the
// full kernel attributes time to that stage.  This file is a copy of
// fused_scorer.cu (the production kernel stays as it is) with the stages of
// the Hopper design behind the template parameter VAR.  Each variant drops
// one stage; ablations are not composed:
//
//   base      nothing: the production kernel, statement for statement
//   nostage   the shared-memory staging: the table, Seq2 and the Seq1
//             window are read from global memory (L1/L2) in the char loop
//   nolookup  the table gathers: d0 = s2 ^ c0, d1 = s2 ^ c1
//   nocarry   the t1 / G carries: t1 = d1, g = d0 - d1 at every step
//   nomax     the running max over G per offset
//   noreduce  the warp/block first-hit reduction and the first_hit.cuh
//             tile reduce: every thread writes its own candidate to a
//             [batch, ntiles, 128, 3] scratch buffer
//   noskip    the offset-tile skip (fused_scorer.cu:70): tiles past
//             len1 - len2 stage and reduce too (their threads skip the loop)
//
// base, nostage and noskip compute the production rows; the others compute
// nothing meaningful by design.  What bounds it is what bounds
// fused_scorer.cu (integer issue and shared-memory lookups); the variants
// say how much of its time each stage holds.  The wrapper lives in
// scripts/torch_kernel_ablate.py, never in the production modules.

#include <climits>
#include <cuda_runtime.h>

#include "first_hit.cuh"

namespace {

using first_hit::better;
constexpr int kTile = first_hit::kTile;
constexpr int kAlpha = 27;
constexpr int kWarps = kTile / 32;

// Variant ids, in the order of VARIANTS in scripts/torch_kernel_ablate.py.
enum Variant : int { base, nostage, nolookup, nocarry, nomax, noreduce, noskip };

template <int VAR>
__global__ void __launch_bounds__(kTile)
ablate_tile_kernel(const int* __restrict__ seq1ext, int len1,
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
  if (VAR != noskip && t > 0 && n0 >= nvalid) return;  // offset-tile skip

  const int* row = rows + static_cast<size_t>(b) * l2p;
  if constexpr (VAR != nostage) {
    for (int j = tid; j < kAlpha * kAlpha; j += kTile) sval[j] = val[j];
    for (int j = tid; j < len2; j += kTile) s2[j] = row[j] * kAlpha;
    for (int j = tid; j < kTile + len2 + 1; j += kTile) win[j] = seq1ext[n0 + j];
    __syncthreads();
  }
  const int* tab = VAR == nostage ? val : sval;
  const int* w = VAR == nostage ? seq1ext + n0 : win;

  const int n = n0 + tid;
  int t1 = 0, g = 0, gbest = INT_MIN, kbest = 0;
  if (n < nvalid || n == 0) {
    int c0 = w[tid];
    for (int i = 0; i < len2; ++i) {
      const int s = VAR == nostage ? row[i] * kAlpha : s2[i];
      const int c1 = w[tid + i + 1];
      int d0, d1;
      if constexpr (VAR == nolookup) {
        d0 = s ^ c0;
        d1 = s ^ c1;
      } else {
        const int* vr = tab + s;
        d0 = vr[c0];
        d1 = vr[c1];
      }
      if constexpr (VAR == nocarry) {
        t1 = d1;
        g = d0 - d1;
      } else {
        t1 += d1;
        g += d0 - d1;
      }
      if constexpr (VAR != nomax) {
        if (i + 1 < len2 && g > gbest) {
          gbest = g;
          kbest = i + 1;
        }
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
  if constexpr (VAR == noreduce) {
    int* part = partial + 3 * ((static_cast<size_t>(b) * ntiles + t) * kTile + tid);
    part[0] = s;
    part[1] = bn;
    part[2] = bk;
    return;
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
    for (int v = 1; v < kWarps; ++v) {
      if (better(red[0][v], red[1][v], s, bn)) {
        s = red[0][v];
        bn = red[1][v];
        bk = red[2][v];
      }
    }
    int* part = partial + 3 * (static_cast<size_t>(b) * ntiles + t);
    part[0] = s;
    part[1] = bn;
    part[2] = bk;
  }
}

template <int VAR>
void launch_variant(const int* seq1ext, int len1, const int* rows,
                    const int* lens, int batch, int l2p, int ntiles,
                    const int* val, int* partial, int* out,
                    cudaStream_t stream) {
  const size_t smem =
      VAR == nostage ? 0 : sizeof(int) * (kAlpha * kAlpha + l2p + kTile + l2p + 1);
  ablate_tile_kernel<VAR><<<dim3(batch, ntiles), kTile, smem, stream>>>(
      seq1ext, len1, rows, lens, l2p, val, partial, out, ntiles);
}

}  // namespace

// var: a Variant id.  The operands are fused_scorer_launch's; partial holds
// [batch, ntiles, 3] int32 words, or [batch, ntiles, 128, 3] for noreduce.
// Returns the first CUDA error of the launches (0 on success).
extern "C" int ablate_scorer_launch(int var, const int* seq1ext, int len1,
                                    const int* rows, const int* lens,
                                    int batch, int l2p, int ntiles,
                                    const int* val, int* partial, int* out,
                                    cudaStream_t stream) {
  if (batch == 0) return 0;
  switch (var) {
#define ABLATE_CASE(V)                                                     \
  case V:                                                                  \
    launch_variant<V>(seq1ext, len1, rows, lens, batch, l2p, ntiles, val, \
                      partial, out, stream);                               \
    break;
    ABLATE_CASE(base)
    ABLATE_CASE(nostage)
    ABLATE_CASE(nolookup)
    ABLATE_CASE(nocarry)
    ABLATE_CASE(nomax)
    ABLATE_CASE(noreduce)
    ABLATE_CASE(noskip)
#undef ABLATE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || var == noreduce) return static_cast<int>(err);
  return static_cast<int>(
      first_hit::launch_reduce(partial, lens, len1, batch, ntiles, out, stream));
}
