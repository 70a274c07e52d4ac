// Row-packed alignment scorer for Hopper (sm_90a).
//
// Replaces the TPU kernel mpi_openmp_cuda_tpu/ops/pallas_scorer.py::
// _kernel_packed (launched by _pallas_call_packed, fed by
// _pallas_best_packed).  It serves L2P = 128 buckets whose every Seq2 has
// len2 <= l2s, l2s in {8, 16, 32, 64} (dispatch.choose_rowpack), with the
// output row contract of fused_scorer.cu: [score, n, k, eq] per pair,
// first hit in offset-major, k-ascending order with k = 0 first, eq the
// k = 0 score at n = 0; unsearchable pairs carry (INT32_MIN, 0, 0).  Asked
// for finished rows, it stores the answer row (score, n, k) at the pair's
// input position instead (finish_rows.cuh), as the fused scorer does.
//
// Math: that of fused_kernels.cuh.  With e(n, i) = val[s2[i]][s1[n + i]]
// and A(n, kappa) its prefix over i < kappa, G[kappa](n) = A(n, kappa) -
// A(n + 1, kappa) and t1(n) = A(n + 1, len2); k = 0 wins every tie, so an
// offset's best score is t1(n) + max_kappa G[kappa](n), a max with no
// index, and k is recovered afterwards for the winning offset only.  A
// cell (offset, char) needs 1 table lookup and 3 int ops.  Every word stays
// in int32 under the gate of ops/bounds.py, 2 * len2 * max|v| < 2^31.
//
// What bounds it on the H100: integer issue and shared-memory lookups (the
// operands are a few KB a pair).  The fused kernel gives a (pair, tile) a
// block with a warp per 32-char segment, so a row of at most 64 chars
// keeps one or two of its warps busy and stages the table for them alone.
// Here, against each cost:
//  * A warp per (pair, 128-offset tile): no char segments, no combine.
//    Lane l owns the kR = 4 consecutive offsets n0 + 4l .. n0 + 4l + 3,
//    i.e. the 5 diagonals n0 + 4l .. n0 + 4l + 4 (the hyphen-shifted
//    diagonal of an offset is the unshifted one of the next): per char
//    step one window byte, 5 lookups, 5 prefix adds and 4 fused
//    difference-max, (kR + 1) / kR lookups a cell.  l2s is a template
//    parameter, so the char loop unrolls fully in groups of 4 chars, one
//    16-byte Seq2 load a group, and leaves at the first group past len2
//    (the branch is warp-uniform: one pair a warp); codes past len2 are the
//    pad code 0, whose zeroed table row adds nothing.  All lanes of a warp
//    look up one table row (the pair's char): conflict-free.
//  * A block holds W warps, W pairs of one offset tile (W = 4 measured
//    fastest; PERF.md has the sweep): they share one staged table and one
//    Seq1 window of 128 + l2s chars, staged as bytes pre-scaled to word
//    offsets, so lanes reading at stride 4 chars touch consecutive words.
//    Seq2 codes are staged pre-scaled to row byte offsets (code * 108): a
//    lookup address is one add.  Both arrive as uint8 codes, read only by
//    the staging loads and the finish kernel: a quarter of int32's bytes
//    over the host link, for the same int32 arithmetic once staged.
//  * Offset-tile skip: a block whose pairs have no valid offset in its tile
//    returns before staging, a warp whose pair has none leaves after the
//    staging barrier.  Tile 0 always runs: it writes eq.
//  * First hit over offsets only: a warp reduces (score, n) by shuffles,
//    the smaller n winning ties, to one partial [score, n] per (pair,
//    tile).  A finish kernel, launched with programmatic stream
//    serialization so that it stages while the tile kernel runs, gives each
//    pair a warp (8 pairs a block, one staged table): the lanes walk the
//    pair's live tiles in order, then recover k for the winning offset over
//    the chars (a lane per 1 or 2 chars, a warp scan, a first-hit max).
// Arithmetic is int32 throughout.

#include <climits>
#include <cuda_runtime.h>

#include "finish_rows.cuh"

// Warps (pairs) a block of the tile kernel: found with
// scripts/torch_packed_sweep.py, which sets it with -D.
#ifndef PACKED_WARPS
#define PACKED_WARPS 4
#endif

namespace {

constexpr int kTile = 128;       // offsets per tile
constexpr int kR = 4;            // consecutive offsets per lane
constexpr int kAlpha = 27;       // character codes 0 (pad) .. 26
constexpr int kTabWords = 732;   // 27 * 27 table words, padded to 16 bytes
constexpr int kRowBytes = kAlpha * 4;
constexpr int kWarps = PACKED_WARPS;
constexpr int kFinishPairs = 8;  // warps (pairs) a block of the finish kernel

static_assert(kTile == 32 * kR, "one warp spans the offset tile");

__device__ __forceinline__ bool better(int s, int n, int bs, int bn) {
  return s > bs || (s == bs && n < bn);
}

__device__ __forceinline__ int look(const char* tab, int row, int col) {
  return *reinterpret_cast<const int*>(tab + (row + col));
}

// (score, n) of the warp's best offset, the smaller n winning ties, in
// every lane.
__device__ __forceinline__ void warp_first_hit(int& s, int& n) {
  for (int off = 16; off > 0; off >>= 1) {
    const int os = __shfl_down_sync(0xffffffffu, s, off);
    const int on = __shfl_down_sync(0xffffffffu, n, off);
    if (better(os, on, s, n)) {
      s = os;
      n = on;
    }
  }
  s = __shfl_sync(0xffffffffu, s, 0);
  n = __shfl_sync(0xffffffffu, n, 0);
}

// Up to 48 resident warps an SM leave ptxas 40 registers a thread.
template <int L2S, int W>
__global__ void __launch_bounds__(W * 32, 48 / W)
tile_kernel(const unsigned char* __restrict__ seq1ext, int len1,
            const unsigned char* __restrict__ rows,
            const int* __restrict__ lens,
            int batch, int l2p, const int* __restrict__ val,
            int* __restrict__ partial, int* __restrict__ out, int ntiles) {
  constexpr int kWin = kTile + L2S;  // window chars of the tile
  __shared__ __align__(16) int sval[kTabWords];       // row/col 0 zeroed
  __shared__ __align__(16) int s2[W * L2S];           // codes * 108
  __shared__ __align__(16) unsigned char win[kWin];   // Seq1 codes * 4

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t = blockIdx.y;
  const int n0 = t * kTile;
  const int b0 = blockIdx.x * W;
  // The finish kernel may start now: it waits for this grid's results.
  asm volatile("griddepcontrol.launch_dependents;");
  // Block-level offset-tile skip (block-uniform).
  bool live = t == 0;
  if (tid < W && b0 + tid < batch) live = live || n0 < len1 - lens[b0 + tid];
  if (!__syncthreads_or(live)) return;

  for (int j = tid; j < kAlpha * kAlpha; j += W * 32) sval[j] = val[j];
  for (int j = tid; j < W * L2S; j += W * 32) {
    const int b = b0 + j / L2S;
    const int i = j % L2S;
    s2[j] = b < batch && i < lens[b]
                ? rows[static_cast<size_t>(b) * l2p + i] * kRowBytes : 0;
  }
  unsigned* win32 = reinterpret_cast<unsigned*>(win);
  for (int w = tid; w < kWin / 4; w += W * 32) {
    const unsigned char* c = seq1ext + n0 + 4 * w;
    win32[w] = (c[0] << 2) | (c[1] << 10) | (c[2] << 18) | (c[3] << 26);
  }
  __syncthreads();

  const char* tab = reinterpret_cast<const char*>(sval);
  const unsigned char* wp = win + kR * lane;
  const int nb = n0 + kR * lane;  // this lane's first offset
  // Past the block's last barrier: a warp may now leave (warp-uniform).
  const int b = b0 + warp;
  if (b >= batch) return;
  const int len2 = lens[b];
  const int nvalid = len1 - len2;  // offsets n < nvalid are candidates
  if (t > 0 && n0 >= nvalid) return;
  const int len2r = (len2 + 3) & ~3;
  const int* row = s2 + warp * L2S;
  int a[kR + 1], m[kR], c[kR + 1];
#pragma unroll
  for (int j = 0; j <= kR; ++j) a[j] = 0;
#pragma unroll
  for (int j = 0; j < kR; ++j) m[j] = len2 == 0 ? 0 : INT_MIN;
#pragma unroll
  for (int j = 0; j < kR; ++j) c[j] = wp[j];
#pragma unroll
  for (int i = 0; i < L2S; i += 4) {
    if (i >= len2r) break;
    const int4 sv = *reinterpret_cast<const int4*>(row + i);
    const int srow[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      c[kR] = wp[i + u + kR];
#pragma unroll
      for (int j = 0; j <= kR; ++j) a[j] += look(tab, srow[u], c[j]);
#pragma unroll
      for (int j = 0; j < kR; ++j) m[j] = max(m[j], a[j] - a[j + 1]);
#pragma unroll
      for (int j = 0; j < kR; ++j) c[j] = c[j + 1];
    }
  }
  if (t == 0 && lane == 0) out[4 * b + 3] = a[0];  // eq = A(0, len2)
  int s = INT_MIN, bn = 0;
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    const int sc = a[j + 1] + m[j];  // t1(n) + max G(n)
    if (nb + j < nvalid && sc > s) {
      s = sc;
      bn = nb + j;
    }
  }
  warp_first_hit(s, bn);
  if (lane == 0) {
    int* part = partial + 2 * (static_cast<size_t>(b) * ntiles + t);
    part[0] = s;
    part[1] = bn;
  }
}

// A warp per pair, F pairs a block: the best partial over the pair's live
// tiles (tile 0 always; tile t while t * 128 < len1 - len2), then k of that
// offset, lane l holding chars [l * C, l * C + C), stored raw or finished
// (finish_rows.cuh).
template <int L2S, int F>
__global__ void __launch_bounds__(F * 32)
finish_kernel(const unsigned char* __restrict__ seq1ext, int len1,
              const unsigned char* __restrict__ rows,
              const int* __restrict__ lens,
              int batch, int l2p, const int* __restrict__ val,
              const int* __restrict__ partial, int ntiles,
              int* __restrict__ out, int* __restrict__ done,
              const long long* __restrict__ dst, int row0) {
  constexpr int C = (L2S + 31) / 32;  // chars a lane
  __shared__ int sval[kAlpha * kAlpha];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int b = blockIdx.x * F + (tid >> 5);
  const bool real = b < batch;
  const int len2 = real ? lens[b] : 0;
  const int i0 = lane * C;
  // What does not depend on the tile kernel is loaded before waiting for
  // it: the table and this lane's table rows.
  for (int j = tid; j < kAlpha * kAlpha; j += F * 32) sval[j] = val[j];
  int rc[C];
#pragma unroll
  for (int u = 0; u < C; ++u)
    rc[u] = i0 + u < len2 ? rows[static_cast<size_t>(b) * l2p + i0 + u] * kAlpha
                          : 0;
  __syncthreads();
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (!real) return;  // warp-uniform

  const int nvalid = len1 - len2;
  int live = nvalid > 0 ? (nvalid + kTile - 1) / kTile : 1;
  if (live > ntiles) live = ntiles;
  const int* p = partial + 2 * static_cast<size_t>(b) * ntiles;
  // Each lane walks its tiles in ascending order with a strict '>'; the
  // lanes then reduce with the smaller n winning ties.
  int s = INT_MIN, n = 0;
  for (int t = lane; t < live; t += 32) {
    if (p[2 * t] > s) {
      s = p[2 * t];
      n = p[2 * t + 1];
    }
  }
  warp_first_hit(s, n);
  if (s == INT_MIN) {  // no valid offset
    if (lane == 0)
      finish_rows::store(out, done, dst, row0, b, len1, len2, INT_MIN, 0, 0);
    return;
  }

  // G[kappa](n) over this lane's chars: their sum, and the first max of the
  // running prefix over kappa < len2 (kappa = len2 is k = 0).
  const unsigned char* w = seq1ext + n;
  int run = 0, bv = INT_MIN, bk = 0;
#pragma unroll
  for (int u = 0; u < C; ++u) {
    const int i = i0 + u;
    if (i < len2) {
      const int* vr = sval + rc[u];
      run += vr[w[i]] - vr[w[i + 1]];
      if (i + 1 < len2 && run > bv) {
        bv = run;
        bk = i + 1;
      }
    }
  }
  int incl = run;  // inclusive scan of the lanes' sums
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  const int gend = __shfl_sync(0xffffffffu, incl, 31);  // G[len2]
  if (bk > 0) bv += incl - run;
  // First hit over kappa: the larger G, then the smaller kappa.
  warp_first_hit(bv, bk);
  if (lane == 0)  // k = 0 wins ties
    finish_rows::store(out, done, dst, row0, b, len1, len2, s, n,
                       bv > gend ? bk : 0);
}

template <int L2S>
cudaError_t launch(const unsigned char* seq1ext, int len1,
                   const unsigned char* rows, const int* lens, int batch, int l2p, int ntiles,
                   const int* val, int* partial, int* out, int* done,
                   const long long* dst, int row0, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((batch + kWarps - 1) / kWarps, ntiles);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.stream = stream;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, tile_kernel<L2S, kWarps>, seq1ext, len1, rows, lens,
      batch, l2p, val, partial, out, ntiles);
  if (err != cudaSuccess) return err;
  // The finish kernel: may start before the tile kernel has ended.
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const int* scored = partial;
  cfg.gridDim = dim3((batch + kFinishPairs - 1) / kFinishPairs);
  cfg.blockDim = dim3(kFinishPairs * 32);
  err = cudaLaunchKernelEx(&cfg, finish_kernel<L2S, kFinishPairs>, seq1ext,
                           len1, rows, lens, batch, l2p, val, scored, ntiles,
                           out, done, dst, row0);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// seq1ext: [ntiles * 128 + l2p + 1] uint8 codes; rows: [batch, l2p] uint8
// codes, every len2 <= l2s <= l2p; lens: [batch] int32; val: [27 * 27]
// int32 with row/col 0 zeroed; partial: [batch, ntiles, 2] int32 scratch; out:
// [batch, 4] int32, the raw rows (with done, the tile kernel's eq alone);
// done: nullptr, or int32 [count, 3] that takes each pair's finished row at
// dst[b] (int64 [batch]) or, with dst nullptr, at row0 + b (finish_rows.cuh).
// Returns the first CUDA error of the launches (0 on success), or
// cudaErrorInvalidValue for an l2s outside {8, 16, 32, 64}.
extern "C" int packed_scorer_launch(const unsigned char* seq1ext,
                                    int len1, const unsigned char* rows,
                                    const int* lens,
                                    int batch, int l2p, int l2s, int ntiles,
                                    const int* val, int* partial, int* out,
                                    int* done, const long long* dst, int row0,
                                    cudaStream_t stream) {
  if (batch == 0) return 0;
  cudaError_t err;
  switch (l2s) {
    case 8:
      err = launch<8>(seq1ext, len1, rows, lens, batch, l2p, ntiles, val,
                      partial, out, done, dst, row0, stream);
      break;
    case 16:
      err = launch<16>(seq1ext, len1, rows, lens, batch, l2p, ntiles, val,
                       partial, out, done, dst, row0, stream);
      break;
    case 32:
      err = launch<32>(seq1ext, len1, rows, lens, batch, l2p, ntiles, val,
                       partial, out, done, dst, row0, stream);
      break;
    case 64:
      err = launch<64>(seq1ext, len1, rows, lens, batch, l2p, ntiles, val,
                       partial, out, done, dst, row0, stream);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

namespace {

template <int L2S>
cudaError_t attrs(int which, cudaFuncAttributes* a) {
  if (which == 0) return cudaFuncGetAttributes(a, tile_kernel<L2S, kWarps>);
  if (which == 1)
    return cudaFuncGetAttributes(a, finish_kernel<L2S, kFinishPairs>);
  return cudaErrorInvalidValue;
}

}  // namespace

// Registers, static shared memory and the thread limit of the production
// kernels of class l2s as cudaFuncGetAttributes reports them (which = 0:
// the tile kernel, 1: the finish kernel).  Returns the CUDA error (0 on
// success; cudaErrorInvalidValue for an l2s outside {8, 16, 32, 64}).
extern "C" int packed_scorer_attrs(int l2s, int which, int* regs,
                                   long long* static_smem, int* max_threads) {
  cudaFuncAttributes a = {};
  cudaError_t err;
  switch (l2s) {
    case 8: err = attrs<8>(which, &a); break;
    case 16: err = attrs<16>(which, &a); break;
    case 32: err = attrs<32>(which, &a); break;
    case 64: err = attrs<64>(which, &a); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *static_smem = static_cast<long long>(a.sharedSizeBytes);
  *max_threads = a.maxThreadsPerBlock;
  return 0;
}
