// The kernels of the fused alignment scorer for Hopper (sm_90a), shared by
// fused_scorer.cu (the production entry) and ablate_scorer.cu (its stage
// ablation).
//
// They replace the TPU kernel mpi_openmp_cuda_tpu/ops/pallas_scorer.py::
// _kernel / _pair (launched by _pallas_call, fed by _pallas_best).  Same
// contract:
// for each (Seq1, Seq2) pair, one row [score, n, k, eq] where (score, n, k)
// is the best candidate over offsets n < len1 - len2 and hyphen positions k
// (k = 0: hyphen after the end), first hit in offset-major, k-ascending
// order with k = 0 first, and eq is the k = 0 score at n = 0 (the
// equal-length answer).  Unsearchable pairs (no valid offset) carry
// (INT32_MIN, 0, 0).
//
// Math.  With e(n, i) = val[s2[i]][s1[n + i]] (diagonal n of the pair's
// score matrix) and A(n, kappa) = sum of e(n, i) over i < kappa:
//   d0(n, i) = e(n, i) and d1(n, i) = e(n + 1, i): the hyphen-shifted
//   diagonal of offset n is the unshifted one of offset n + 1, so
//   G[kappa](n) = sum_{i < kappa} (d0 - d1) = A(n, kappa) - A(n + 1, kappa)
//   t1(n) = A(n + 1, len2),   eq = A(0, len2)
//   score(n, k >= 1) = t1(n) + G[k](n),   score(n, 0) = t1(n) + G[len2](n)
// k = 0 wins every tie against k >= 1, so the best score of an offset is
// t1(n) + max_{1 <= kappa <= len2} G[kappa](n): a plain max with no index.
// k is needed for one offset per pair, the winner, and is recovered after
// the search: k = 0 if G[len2] >= max_{kappa < len2} G[kappa], else the
// first kappa of that max.  Per (offset, char) cell the function therefore
// needs 1 table lookup and 3 int ops (prefix add, difference, max).
//
// Exactness.  |e| <= max|v|, so |A| <= len2 * max|v|, |G| <= 2 * len2 *
// max|v| and |score| <= len2 * max|v| (a score is a sum of len2 table
// values); partial sums over a char segment are bounded the same way.  The
// gate of ops/bounds.py, 2 * len2 * max|v| < 2^31, keeps every word in
// int32, and no real G can equal INT_MIN, the "no candidate" mark.
//
// What bounds it on the H100: integer issue and shared-memory lookups; the
// inputs are a few hundred KB, so device memory is never the limit.  The
// design, against each cost:
//  * Shared diagonals.  A thread owns kR = 4 consecutive offsets, i.e. the
//    kR + 1 diagonals n .. n + kR.  Per char step it takes one Seq2 code
//    (16-byte loads, four steps each), one new window char (the others
//    slide in registers), kR + 1 lookups into kR + 1 running sums A, and
//    kR times max(m, A(n) - A(n + 1)), one instruction each: (kR + 1) / kR
//    lookups a cell, kR + 1 independent loads in flight.  The lookups of a
//    warp fall in one 27-word table row (conflict-free); the window is
//    staged as bytes, so the lanes' window loads (stride kR chars) fall in
//    consecutive words.  Codes are staged pre-scaled to byte offsets
//    (row * 108, char * 4): a lookup address is one add.
//  * Codes in one byte.  Seq1 and Seq2 arrive as uint8 codes (0..26), read
//    only by the staging loads and the finish kernel's k recovery: a
//    quarter of the bytes int32 codes would take over the host link, for
//    the same int32 arithmetic once staged.
//  * Offsets x char segments.  One (pair, 128-offset tile) is the work of a
//    thread block cluster of kCluster blocks, so that a batch of few pairs
//    still spreads over the card's SMs.  A warp's 32 lanes x kR span the
//    tile, and the cluster's warps split the chars into segments: block r
//    stages and walks only its own share of the row.  A segment yields per
//    diagonal its sum E of e and per offset the max M of its local G
//    prefix, written into block 0's shared memory (distributed shared
//    memory); warp 0 of block 0 combines them in segment order, gmax =
//    max_s(P_s + M_s) with P_s the G prefix before segment s.  That is a
//    plain max, associative, with no tie rule.  The offset at a tile's
//    right edge needs the first diagonal of the next tile: lane 31 computes
//    it redundantly (its kR + 1-th), no cluster reads another's result.
//  * First hit over offsets only.  Warp 0 reduces (score, n), the smaller n
//    winning ties, to one partial [score, n] per (pair, tile).  A second
//    kernel, one block per pair, walks the pair's live tiles in ascending
//    order with a strict '>', then recovers k for the winning offset in
//    parallel over the chars (chunk sums, a scan, a first-hit max).  It is
//    launched with programmatic stream serialization: its blocks start
//    while the first kernel runs, stage the table and their row codes, and
//    wait for the first kernel's results only then.
//  * Tiles with no valid offset are skipped (tile 0 always runs: it carries
//    eq), as is every char past len2 rounded up to a multiple of 4 (pad
//    codes select the zeroed table row 0 and add nothing).
// Arithmetic is int32 throughout.
//
// The stage switches.  Every stage of the design sits behind the template
// parameter VAR (if constexpr, so a variant's code holds no trace of the
// others).  fused_scorer.cu instantiates `base` alone, the full kernel;
// ablate_scorer.cu instantiates every variant, so its `base` is the
// production kernel by construction: the same source through the same
// compiler.  (Two copies of one source need not compile alike: ptxas has
// given such a pair register budgets of 40 and 32, 8 % apart in time.)
// Each variant drops one stage; ablations are not composed, and a dropped
// stage keeps its loads alive:
//
//   base       nothing
//   nostage    the shared-memory staging: the table, Seq2 and the Seq1
//              window are read from global memory (L1/L2) in the char loop
//   nolookup   the table gathers: e = row ^ char
//   nodiag     the shared diagonals: every offset looks up its own d0 and
//              d1 (2 kR lookups and sums a step instead of kR + 1; the
//              second lookups are volatile so they are not merged)
//   nomax      the running max over G per offset
//   nocombine  the segment combine: no exchange through (distributed)
//              shared memory, warp 0 of block 0 reduces its own segment only
//   noreduce   the first-hit reduction over offsets and tiles: every lane
//              writes its kR candidates to a [batch, ntiles, 128, 2]
//              scratch buffer and the finish kernel walks no tiles
//   nok        the recovery of k for the winning offset
//   noskip     the offset-tile skip: tiles past len1 - len2 stage, run and
//              reduce too (their lanes skip the char loop)
//
// base, nostage, nodiag and noskip compute the contract's rows; the others
// compute nothing meaningful by design.
#pragma once

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "finish_rows.cuh"

namespace cg = cooperative_groups;

namespace fused {
namespace {

constexpr int kTile = 128;          // offsets per block (one tile)
constexpr int kR = 4;               // consecutive offsets per thread
constexpr int kAlpha = 27;          // character codes 0 (pad) .. 26
constexpr int kTabWords = 732;      // 27 * 27 table words, padded to 16 bytes
constexpr int kRowBytes = kAlpha * 4;
constexpr int kComb = 2 * kR + 1;   // words a thread hands to the combine
constexpr int kFinish = 128;        // threads of the finish kernel
constexpr int kChunk = 16;          // chars a finish thread loads ahead
// Tile constants, found with scripts/torch_segment_sweep.py (which sets
// them with -D): one (pair, tile) gets a char segment (warp) per kSegChars
// chars of the padded row length, at most kMaxSeg a block, in one block or,
// past kMaxSeg segments, in a cluster of kCluster blocks.
#ifndef FUSED_SEG_CHARS
#define FUSED_SEG_CHARS 32
#endif
#ifndef FUSED_MAX_SEG
#define FUSED_MAX_SEG 8
#endif
#ifndef FUSED_CLUSTER
#define FUSED_CLUSTER 2
#endif
constexpr int kSegChars = FUSED_SEG_CHARS;
constexpr int kMaxSeg = FUSED_MAX_SEG;
constexpr int kCluster = FUSED_CLUSTER;

static_assert(kTile == 32 * kR, "one warp spans the offset tile");
static_assert(kSegChars % 4 == 0, "segments are whole groups of 4 chars");

// Variant ids, in the order of VARIANTS in scripts/torch_kernel_ablate.py.
enum Variant : int {
  base, nostage, nolookup, nodiag, nomax, nocombine, noreduce, nok, noskip
};

// Seq2 chars a block stages at most: its share of the row, with every
// segment rounded up to whole groups of 4 and to kSegChars at least.
__host__ __device__ __forceinline__ int block_chars(int l2p, int nseg,
                                                    int nblk) {
  return ((l2p / nblk + 3) & ~3) + 4 * nseg + kSegChars;
}

__device__ __forceinline__ bool better(int s, int n, int bs, int bn) {
  return s > bs || (s == bs && n < bn);
}

__device__ __forceinline__ int look(const char* tab, int row, int col) {
  return *reinterpret_cast<const int*>(tab + (row + col));
}

// Two blocks an SM are all that is asked of the register allocator.  Left
// to aim at full occupancy it keeps the kernel in 32 registers and issues
// each lookup right before its use, a chain of load latencies; with room
// for 40 it issues a step's lookups together (8 to 10 % faster).
template <int VAR>
__global__ void __launch_bounds__(kMaxSeg * 32, 2)
tile_kernel(const unsigned char* __restrict__ seq1ext, int len1,
            const unsigned char* __restrict__ rows,
            const int* __restrict__ lens,
            int l2p, const int* __restrict__ val, int* __restrict__ partial,
            int* __restrict__ out, int ntiles) {
  extern __shared__ __align__(16) int smem[];
  const int nthr = blockDim.x;
  const int nseg = nthr >> 5;
  const int nblk = gridDim.z;     // blocks of the cluster (its z extent)
  const int rank = blockIdx.z;    // this block's rank in it
  const int nsegt = nseg * nblk;  // segments of the cluster
  const int s2n = block_chars(l2p, nseg, nblk);
  int* sval = smem;               // [27 * 27] table, row/col 0 zeroed
  int* s2 = sval + kTabWords;     // [s2n] this block's Seq2 codes * 108
  int* comb = s2 + s2n;           // [nsegt][kComb][32] segment results
  unsigned char* win =            // [kTile + s2n] Seq1 codes * 4
      reinterpret_cast<unsigned char*>(comb + nsegt * kComb * 32);
  cg::cluster_group cluster = cg::this_cluster();

  const int b = blockIdx.x;
  const int t = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int seg = tid >> 5;
  const int n0 = t * kTile;
  const int len2 = lens[b];
  const int nvalid = len1 - len2;  // offsets n < nvalid are candidates
  // The finish kernel may start now: it waits for this grid's results.
  asm volatile("griddepcontrol.launch_dependents;");
  if (VAR != noskip && t > 0 && n0 >= nvalid) return;  // offset-tile skip

  const int len2r = (len2 + 3) & ~3;
  // Chars per segment (kSegChars at least: a shorter row leaves the later
  // segments empty), and this block's chars [lo, hi).
  const int per = max(((len2r / 4 + nsegt - 1) / nsegt) * 4, kSegChars);
  const int lo = min(rank * nseg * per, len2r);
  const int hi = min(lo + nseg * per, len2r);
  const unsigned char* row = rows + static_cast<size_t>(b) * l2p;
  const unsigned char* src = seq1ext + n0 + lo;
  if constexpr (VAR != nostage) {
    for (int j = tid; j < kAlpha * kAlpha; j += nthr) sval[j] = val[j];
    for (int j = lo + tid; j < hi; j += nthr)
      s2[j - lo] = j < len2 ? row[j] * kRowBytes : 0;
    unsigned* win32 = reinterpret_cast<unsigned*>(win);
    for (int w = tid; w < (kTile + hi - lo) / 4; w += nthr) {
      const unsigned char* c = src + 4 * w;
      win32[w] = (c[0] << 2) | (c[1] << 10) | (c[2] << 18) | (c[3] << 26);
    }
  }
  // Staged, and every block of the cluster has started.
  if (nblk > 1) cluster.sync(); else __syncthreads();

  // This warp's char segment [i0, i1), relative to lo, and this lane's
  // diagonals nb .. nb+kR.
  const int gseg = rank * nseg + seg;
  const int i0 = min(gseg * per, len2r) - lo;
  const int i1 = min(gseg * per + per, len2r) - lo;
  const int nb = n0 + kR * lane;
  const bool mine = nb < nvalid || nb == 0;
  int a[kR + 1], m[kR];
#pragma unroll
  for (int j = 0; j <= kR; ++j) a[j] = 0;
#pragma unroll
  for (int j = 0; j < kR; ++j) m[j] = INT_MIN;
  if (mine && i0 < i1) {
    const char* tab =
        reinterpret_cast<const char*>(VAR == nostage ? val : sval);
    const unsigned char* wp = win + kR * lane;
    // nostage: the block's window and Seq2 chars in global memory.
    const unsigned char* gp = src + kR * lane;
    const unsigned char* grow = row + lo;
    int c[kR + 1];
#pragma unroll
    for (int j = 0; j < kR; ++j)
      c[j] = VAR == nostage ? gp[i0 + j] * 4 : wp[i0 + j];
    int d[kR];  // nodiag: each offset's own sum of d1
#pragma unroll
    for (int j = 0; j < kR; ++j) d[j] = 0;
#pragma unroll 2
    for (int i = i0; i < i1; i += 4) {
      int srow[4];
      if constexpr (VAR == nostage) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          srow[u] = lo + i + u < len2 ? grow[i + u] * kRowBytes : 0;
      } else {
        const int4 sv = *reinterpret_cast<const int4*>(s2 + i);
        srow[0] = sv.x;
        srow[1] = sv.y;
        srow[2] = sv.z;
        srow[3] = sv.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        c[kR] = VAR == nostage ? gp[i + u + kR] * 4 : wp[i + u + kR];
        if constexpr (VAR == nolookup) {
#pragma unroll
          for (int j = 0; j <= kR; ++j) a[j] += srow[u] ^ c[j];
        } else if constexpr (VAR == nodiag) {
#pragma unroll
          for (int j = 0; j < kR; ++j) {
            a[j] += look(tab, srow[u], c[j]);
            d[j] += *reinterpret_cast<const volatile int*>(
                tab + (srow[u] + c[j + 1]));
          }
        } else {
#pragma unroll
          for (int j = 0; j <= kR; ++j) a[j] += look(tab, srow[u], c[j]);
        }
        if constexpr (VAR == nodiag) {
#pragma unroll
          for (int j = 0; j < kR; ++j) m[j] = max(m[j], a[j] - d[j]);
        } else if constexpr (VAR != nomax) {
#pragma unroll
          for (int j = 0; j < kR; ++j) m[j] = max(m[j], a[j] - a[j + 1]);
        }
#pragma unroll
        for (int j = 0; j < kR; ++j) c[j] = c[j + 1];
      }
    }
    if constexpr (VAR == nodiag) {  // a[j + 1] = A(nb + j + 1) = sum of d1
#pragma unroll
      for (int j = 0; j < kR; ++j) a[j + 1] = d[j];
    }
    if constexpr (VAR == nomax) {
#pragma unroll
      for (int j = 0; j < kR; ++j) m[j] = a[j] - a[j + 1];
    }
  }
  if constexpr (VAR != nocombine) {
    int* cw = cluster.map_shared_rank(comb, 0) + gseg * kComb * 32 + lane;
#pragma unroll
    for (int j = 0; j <= kR; ++j) cw[j * 32] = a[j];
#pragma unroll
    for (int j = 0; j < kR; ++j) cw[(kR + 1 + j) * 32] = m[j];
    // Block 0 holds every segment's results.
    if (nblk > 1) cluster.sync(); else __syncthreads();
  }
  if (rank != 0 || seg != 0) return;

  // Warp 0: combine the segments in order, then first hit over offsets.
  int s = INT_MIN, bn = 0;
  if (mine) {
    const int nlive = (len2r + per - 1) / per;
    int tot[kR + 1], gm[kR];
#pragma unroll
    for (int j = 0; j <= kR; ++j) tot[j] = 0;
#pragma unroll
    for (int j = 0; j < kR; ++j) gm[j] = len2 == 0 ? 0 : INT_MIN;
    if constexpr (VAR == nocombine) {
      if (nlive > 0) {
#pragma unroll
        for (int j = 0; j <= kR; ++j) tot[j] = a[j];
#pragma unroll
        for (int j = 0; j < kR; ++j) gm[j] = m[j];
      }
    } else {
      for (int q = 0; q < nlive; ++q) {
        const int* cr = comb + q * kComb * 32 + lane;
        int e[kR + 1];
#pragma unroll
        for (int j = 0; j <= kR; ++j) e[j] = cr[j * 32];
#pragma unroll
        for (int j = 0; j < kR; ++j)
          gm[j] = max(gm[j], tot[j] - tot[j + 1] + cr[(kR + 1 + j) * 32]);
#pragma unroll
        for (int j = 0; j <= kR; ++j) tot[j] += e[j];
      }
    }
    if (t == 0 && lane == 0) out[4 * b + 3] = tot[0];  // eq = A(0, len2)
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int sc = tot[j + 1] + gm[j];  // t1(n) + max G(n)
      if constexpr (VAR == noreduce) {
        int* part = partial + 2 * ((static_cast<size_t>(b) * ntiles + t) *
                                   kTile + kR * lane + j);
        part[0] = nb + j < nvalid ? sc : INT_MIN;
        part[1] = nb + j;
      } else if (nb + j < nvalid && sc > s) {
        s = sc;
        bn = nb + j;
      }
    }
  }
  if constexpr (VAR == noreduce) return;
  for (int off = 16; off > 0; off >>= 1) {
    const int os = __shfl_down_sync(0xffffffffu, s, off);
    const int on = __shfl_down_sync(0xffffffffu, bn, off);
    if (better(os, on, s, bn)) {
      s = os;
      bn = on;
    }
  }
  if (lane == 0) {
    int* part = partial + 2 * (static_cast<size_t>(b) * ntiles + t);
    part[0] = s;
    part[1] = bn;
  }
}

// One block per pair: the best partial over the pair's live tiles (tile 0
// always; tile t while t * 128 < len1 - len2), then k of that offset, stored
// raw or finished (finish_rows.cuh).
template <int VAR>
__global__ void __launch_bounds__(kFinish)
finish_kernel(const unsigned char* __restrict__ seq1ext, int len1,
              const unsigned char* __restrict__ rows,
              const int* __restrict__ lens,
              int l2p, const int* __restrict__ val,
              const int* __restrict__ partial, int ntiles,
              int* __restrict__ out, int* __restrict__ done,
              const long long* __restrict__ dst, int row0) {
  constexpr int kWarps = kFinish / 32;
  __shared__ int sval[kAlpha * kAlpha];
  __shared__ int best[2];
  __shared__ int wsum[kWarps], wval[kWarps], wk[kWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len2 = lens[b];
  const int nvalid = len1 - len2;
  // This thread's chunk of chars [i0, i1).  What does not depend on the
  // first kernel is loaded before waiting for it: the table and the
  // chunk's table rows.
  const int chunk = (len2 + kFinish - 1) / kFinish;
  const int i0 = min(tid * chunk, len2);
  const int i1 = min(i0 + chunk, len2);
  const unsigned char* row = rows + static_cast<size_t>(b) * l2p;
  for (int j = tid; j < kAlpha * kAlpha; j += kFinish) sval[j] = val[j];
  int rc[kChunk];
#pragma unroll
  for (int u = 0; u < kChunk; ++u)
    rc[u] = i0 + u < i1 ? row[i0 + u] * kAlpha : 0;
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if constexpr (VAR == noreduce) {
    // No walk: the candidate of offset 0 stands for the winner.
    if (tid == 0) {
      const int* p = partial + 2 * static_cast<size_t>(b) * ntiles * kTile;
      best[0] = p[0];
      best[1] = p[1];
    }
  } else if (warp == 0) {
    int live = nvalid > 0 ? (nvalid + kTile - 1) / kTile : 1;
    if (live > ntiles) live = ntiles;
    const int* p = partial + 2 * static_cast<size_t>(b) * ntiles;
    // Each lane walks its tiles in ascending order with a strict '>'; the
    // lanes then reduce with the smaller n winning ties, which is the same
    // ascending walk over all the tiles.
    int s = INT_MIN, n = 0;
    for (int t = lane; t < live; t += 32) {
      if (p[2 * t] > s) {
        s = p[2 * t];
        n = p[2 * t + 1];
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const int os = __shfl_down_sync(0xffffffffu, s, off);
      const int on = __shfl_down_sync(0xffffffffu, n, off);
      if (better(os, on, s, n)) {
        s = os;
        n = on;
      }
    }
    if (lane == 0) {
      best[0] = s;
      best[1] = n;
    }
  }
  __syncthreads();
  const int s = best[0];
  const int n = best[1];
  if (s == INT_MIN) {  // no valid offset (block-uniform)
    if (tid == 0)
      finish_rows::store(out, done, dst, row0, b, len1, len2, INT_MIN, 0, 0);
    return;
  }

  if constexpr (VAR == nok) {
    if (tid == 0) finish_rows::store(out, done, dst, row0, b, len1, len2, s, n, 0);
    return;
  }

  // G[kappa](n) over this thread's chunk of chars: its sum, and the first
  // max of its running prefix over kappa < len2 (kappa = len2 is k = 0).
  const unsigned char* w = seq1ext + n;
  int run = 0, bv = INT_MIN, bk = 0;
  auto step = [&](int i, int rowoff) {
    const int* vr = sval + rowoff;
    run += vr[w[i]] - vr[w[i + 1]];
    if (i + 1 < len2 && run > bv) {
      bv = run;
      bk = i + 1;
    }
  };
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    if (i0 + u < i1) step(i0 + u, rc[u]);
  }
  for (int i = i0 + kChunk; i < i1; ++i) step(i, row[i] * kAlpha);
  int incl = run;  // inclusive scan of the chunk sums over the block
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int before = incl - run, gend = 0;
  for (int v = 0; v < kWarps; ++v) {
    if (v < warp) before += wsum[v];
    gend += wsum[v];  // G[len2]
  }
  if (bk > 0) bv += before;
  // First hit over kappa: the larger G, then the smaller kappa (chunks
  // ascend with the thread index).
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int ok = __shfl_down_sync(0xffffffffu, bk, off);
    if (better(ov, ok, bv, bk)) {
      bv = ov;
      bk = ok;
    }
  }
  if (lane == 0) {
    wval[warp] = bv;
    wk[warp] = bk;
  }
  __syncthreads();
  if (tid == 0) {
    for (int v = 1; v < kWarps; ++v) {
      if (better(wval[v], wk[v], bv, bk)) {
        bv = wval[v];
        bk = wk[v];
      }
    }
    // k = 0 wins ties
    finish_rows::store(out, done, dst, row0, b, len1, len2, s, n,
                       bv > gend ? bk : 0);
  }
}

// The tile kernel's launch shape at row width l2p: the blocks of a (pair,
// tile) cluster, the segments (warps) a block, and its dynamic shared
// memory, 4 * (732 + s2n + nblk * nseg * 9 * 32) + 128 + s2n bytes with
// s2n = block_chars(l2p, nseg, nblk): 26.9 KB at the Seq2 cap (l2p =
// 2048, 2 x 8 segments), 52.5 KB at l2p = 12288.
struct TileShape {
  int nblk;
  int nseg;
  size_t smem;
};

constexpr size_t kDefaultSmem = 48 * 1024;  // a launch's without opting in

inline TileShape tile_shape(int l2p) {
  // Segments a (pair, tile), and the blocks they are spread over: short
  // rows stay in one block (a second one would stage the table again for
  // a few chars each).
  int nsegt = (l2p + kSegChars - 1) / kSegChars;
  nsegt = nsegt > kMaxSeg * kCluster ? kMaxSeg * kCluster : nsegt;
  const int nblk = nsegt > kMaxSeg ? kCluster : 1;
  const int nseg = (nsegt + nblk - 1) / nblk;
  const int s2n = block_chars(l2p, nseg, nblk);
  const size_t smem =
      sizeof(int) * (kTabWords + s2n + nblk * nseg * kComb * 32) + kTile + s2n;
  return {nblk, nseg, smem};
}

// seq1ext: [ntiles * 128 + l2p + 1] uint8 codes; rows: [batch, l2p] uint8
// codes, l2p a multiple of 4; lens: [batch] int32; val: [27 * 27] int32 with
// row/col 0 zeroed; partial: [batch, ntiles, 2] int32 scratch ([batch,
// ntiles, 128, 2] for noreduce); out: [batch, 4] int32, the raw rows (with
// done, the tile kernel's eq alone).  done: nullptr, or int32 [count, 3]
// that takes each pair's finished row at dst[b] (int64 [batch]) or, with
// dst nullptr, at row0 + b (finish_rows.cuh).  Returns the first CUDA error
// of the launches.
template <int VAR>
cudaError_t launch(const unsigned char* seq1ext, int len1,
                   const unsigned char* rows, const int* lens, int batch,
                   int l2p, int ntiles, const int* val, int* partial,
                   int* out, int* done, const long long* dst, int row0,
                   cudaStream_t stream) {
  if (batch == 0) return cudaSuccess;
  // The 16-byte Seq2 loads and the packed window need whole groups of 4.
  if (l2p % 4 != 0) return cudaErrorInvalidValue;
  const TileShape shape = tile_shape(l2p);
  const int nblk = shape.nblk;
  const int nseg = shape.nseg;
  const size_t smem = shape.smem;
  // Past the 48 KB a launch gets by default (L2P from 11,008 on: the
  // ring's windows lift the Seq2 cap), the kernel opts in to more, up to
  // what the card allows a block (227 KB on the H100: L2P up to 84,224);
  // the wrapper refuses a launch past that before it gets here.
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_kernel<VAR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // The tile kernel: clusters of nblk blocks along z.
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = nblk;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch, ntiles, nblk);
  cfg.blockDim = dim3(nseg * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err =
      cudaLaunchKernelEx(&cfg, tile_kernel<VAR>, seq1ext, len1, rows, lens,
                         l2p, val, partial, out, ntiles);
  if (err != cudaSuccess) return err;
  // The finish kernel: may start before the tile kernel has ended.
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = dim3(batch);
  cfg.blockDim = dim3(kFinish);
  cfg.dynamicSmemBytes = 0;
  const int* scored = partial;
  err = cudaLaunchKernelEx(&cfg, finish_kernel<VAR>, seq1ext, len1, rows,
                           lens, l2p, val, scored, ntiles, out, done, dst,
                           row0);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
}  // namespace fused
