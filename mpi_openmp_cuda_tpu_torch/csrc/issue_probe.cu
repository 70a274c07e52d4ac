// Issue-rate probe for Hopper (sm_90a).
//
// Replaces the TPU kernel bench.py::vpu_probe_gelems (Pallas body `kern`,
// pallas_call at bench.py:454), which chained dependent passes of one
// vector-op class over a VMEM tile to price the TPU kernel's passes.  This
// kernel has the same purpose on the H100: it measures the sustained rate of
// each operation class that the scorer's bound (ops/costs.py) is built
// from, so the bench can put a measured floor under the scorer's time.
//
//   OP      one element                 pipe it measures
//   fma     y = fmaf(y, c, d)           FFMA, the fp32 pipe (reference)
//   arith   y = y * m + a   (int32)     IMAD, the integer multiply-add path
//   lookup  y = tab[y]                  LDS, the shared-memory pipe
//
// arith: m, a (3 and 1) and c, d are kernel arguments, not literals, so the
// compiler can neither fold a chain nor strength-reduce y * 3 + 1 into a
// shift and an add: each element is one IMAD (NVIDIA's arithmetic
// throughput table gives 64 IMAD per clock per SM at compute capability
// 9.0, the int32 peak).  The scorer's own int ops (IADD3, ISETP, SEL) issue
// on the ALU pipe, which has the same 64 lanes per SM.  lookup: the chains
// carry byte offsets into a 729-entry permutation staged in shared memory,
// so a step is one LDS and no address arithmetic; the permutation keeps
// each entry's bank (index mod 32, ops/probe.py::lookup_table) and lane l
// of a warp starts in bank l, so every warp-wide LDS is conflict-free, as
// the scorer's table gathers (fused_scorer.cu:85-86, 27 words of one row)
// are.  chip_smoke.py reads the SASS and fails unless the unrolled loop
// holds kChains * kUnroll instructions of the op.
//
// What bounds it: issue of the op itself.  Each thread carries kChains
// independent dependent chains, so the op's latency is hidden and the loop
// measures throughput; kUnroll steps per chain per trip keep the loop's own
// counter and branch to ~2 % of the issue slots.  The grid is a multiple of
// the card's resident blocks (128 threads a block, up to 16 per SM at <= 32
// registers), and the final values are stored, so no chain is dead.  The
// rate comes from two chain lengths timed with CUDA events (ops/probe.py),
// so launch and the load/store prologue cancel.
//
// Layout: word j = chain * nthreads + thread of `in` and `out` (coalesced).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChains = 8;
constexpr int kUnroll = 16;
constexpr int kTable = 729;

enum Op : int { kFma = 0, kArith = 1, kLookup = 2 };

template <int OP>
__global__ void __launch_bounds__(kThreads, 16)
issue_probe_kernel(const int* __restrict__ perm, const int* __restrict__ in,
                   int* __restrict__ out, int trips, float c, float d,
                   int m, int a) {
  __shared__ int tab[kTable];  // byte offsets of the next entry
  const int nthreads = gridDim.x * kThreads;
  const int gt = blockIdx.x * kThreads + threadIdx.x;
  if constexpr (OP == kLookup) {
    for (int j = threadIdx.x; j < kTable; j += kThreads) tab[j] = perm[j] * 4;
    __syncthreads();
  }
  if constexpr (OP == kFma) {
    float y[kChains];
#pragma unroll
    for (int k = 0; k < kChains; ++k) y[k] = __int_as_float(in[k * nthreads + gt]);
    for (int t = 0; t < trips; ++t) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < kChains; ++k) y[k] = fmaf(y[k], c, d);
      }
    }
#pragma unroll
    for (int k = 0; k < kChains; ++k) out[k * nthreads + gt] = __float_as_int(y[k]);
  } else if constexpr (OP == kArith) {
    // Unsigned: int32 wrap-around without signed-overflow UB.
    unsigned y[kChains];
    const unsigned um = static_cast<unsigned>(m), ua = static_cast<unsigned>(a);
#pragma unroll
    for (int k = 0; k < kChains; ++k) y[k] = static_cast<unsigned>(in[k * nthreads + gt]);
    for (int t = 0; t < trips; ++t) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < kChains; ++k) y[k] = y[k] * um + ua;
      }
    }
#pragma unroll
    for (int k = 0; k < kChains; ++k) out[k * nthreads + gt] = static_cast<int>(y[k]);
  } else {
    const char* base = reinterpret_cast<const char*>(tab);
    int y[kChains];
#pragma unroll
    for (int k = 0; k < kChains; ++k) y[k] = in[k * nthreads + gt] * 4;
    for (int t = 0; t < trips; ++t) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < kChains; ++k) y[k] = *reinterpret_cast<const int*>(base + y[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kChains; ++k) out[k * nthreads + gt] = y[k] >> 2;
  }
}

}  // namespace

// op: 0 fma, 1 arith, 2 lookup; perm: [729] int32 permutation (lookup);
// in, out: [kChains * blocks * 128] 32-bit words; iters: steps per chain,
// a multiple of kUnroll.  Returns cudaGetLastError() after the launch.
extern "C" int issue_probe_launch(int op, const int* perm, const int* in,
                                  int* out, int blocks, int iters, float c,
                                  float d, int m, int a,
                                  cudaStream_t stream) {
  if (blocks <= 0 || iters < 0 || iters % kUnroll != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int trips = iters / kUnroll;
  switch (op) {
    case kFma:
      issue_probe_kernel<kFma><<<blocks, kThreads, 0, stream>>>(perm, in, out, trips, c, d, m, a);
      break;
    case kArith:
      issue_probe_kernel<kArith><<<blocks, kThreads, 0, stream>>>(perm, in, out, trips, c, d, m, a);
      break;
    case kLookup:
      issue_probe_kernel<kLookup><<<blocks, kThreads, 0, stream>>>(perm, in, out, trips, c, d, m, a);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
