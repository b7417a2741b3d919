// Rank pass of the relational merge join: for int64 probes p in a sorted
// int64 table, lo = #{t < p} and hi = #{t <= p} (the probe's insertion
// ranks, searchsorted left and right).
//
// Replaces the TPU kernel src/repro/kernels/merge_join.py:106
// (merge_join_ranks, pallas_call at :131). A TPU has no fast per-lane
// gather, so that kernel counted comparisons against the whole table
// streamed through VMEM, O(M*N) compares on int32 hi/lo planes. Hopper
// gathers and compares int64 directly, so here each probe runs a binary
// search, O(M*log N), on the int64 table itself: no planes, no padding
// sentinel.
//
// Bound on an H100: bytes. The function reads each probe (8 bytes), writes
// one or two int64 ranks, and needs at most ceil(log2(N+1)) table words per
// probe and bound (fewer distinct ones when probes share search paths);
// ~4 integer operations per search step are far below the scalar rate.
//
// Design: one thread per probe, a binary-lifting search per bound (the prefix
// of table entries that satisfy the predicate grows by halving steps, so a
// warp's threads stay converged). The first steps of every search read the
// same few table words, which stay in L1/L2; side selects the bounds
// computed (1 = left only, 2 = right only, 3 = both).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// #{j : table[j] < p} (strict) or #{j : table[j] <= p}, table sorted
template <bool kStrict>
__device__ __forceinline__ long long rank_of(const long long* __restrict__ t,
                                             long long n, long long p,
                                             long long step0) {
  long long pos = 0;
  for (long long step = step0; step > 0; step >>= 1) {
    const long long next = pos + step;
    if (next <= n) {
      const long long v = __ldg(t + next - 1);
      const bool pred = kStrict ? (v < p) : (v <= p);
      pos = pred ? next : pos;
    }
  }
  return pos;
}

__global__ void merge_join_ranks_kernel(const long long* __restrict__ table,
                                        const long long* __restrict__ probes,
                                        long long* __restrict__ lo,
                                        long long* __restrict__ hi,
                                        long long n, long long m,
                                        long long step0, int side) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  const long long p = __ldg(probes + i);
  if (side & 1) lo[i] = rank_of<true>(table, n, p, step0);
  if (side & 2) hi[i] = rank_of<false>(table, n, p, step0);
}

}  // namespace

extern "C" int merge_join_ranks_launch(const void* table, const void* probes,
                                       void* lo, void* hi, long long n,
                                       long long m, int side, void* stream) {
  long long step0 = 1;   // largest power of two <= n
  while (step0 * 2 <= n) step0 *= 2;
  const long long blocks = (m + kThreads - 1) / kThreads;
  merge_join_ranks_kernel<<<(unsigned)blocks, kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const long long*)table, (const long long*)probes, (long long*)lo,
      (long long*)hi, n, m, step0, side);
  return (int)cudaGetLastError();
}
