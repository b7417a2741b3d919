// Rank pass of the relational merge join: for int64 probes p in a sorted
// int64 table, lo = #{t < p} and hi = #{t <= p} (the probe's insertion
// ranks, searchsorted left and right).
//
// Replaces the TPU kernel src/repro/kernels/merge_join.py:106
// (merge_join_ranks, pallas_call at :131). A TPU has no fast per-lane
// gather, so that kernel counted comparisons against the whole table
// streamed through VMEM, O(M*N) compares on int32 hi/lo planes. Hopper
// gathers and compares int64 directly, so here each probe searches the
// int64 table itself, O(M*log N): no planes, no padding sentinel.
//
// Bound on an H100: at the main path's shapes (a table of median N = 6,000
// keys, probes of median M = 304; core/join.py keeps the table on the
// card) the bytes are ~10 KB and the bound is far below the launch floor,
// so the time is latency, twice over. In the kernel: how many dependent
// table loads one probe waits for, and how many SMs take part; a
// thread-per-probe binary search waits for ceil(log2(N+1)) loads a bound
// (13 at N = 6,000, twice for both bounds), and 304 threads fill two of
// 132 SMs. Around it: the host's call, numpy in and out, which costs more
// than the kernel; each copy and each Python step between them adds
// microseconds. So the call is one C function, merge_join_ranks_round_trip
// below: the kernel reads the probes from pinned host memory and writes
// the ranks there, and only a table that is not resident is copied up.
//
// Design: both bounds come from one descent. lo is searched; hi then
// gallops forward from lo over the run of keys equal to the probe (one load
// when the probe is absent, the usual case) and ends with a bounded search
// once the run is long. Two layouts, which the wrapper picks by M:
// - lanes = 32 (small M): one warp a probe runs a 32-ary search. Each step
//   its 32 lanes read 32 table words spread over the open interval and a
//   ballot picks the sub-interval: ceil(log32 N) dependent loads (3 at
//   N = 6,000), and 32x the warps, spread over more SMs. The upper bound's
//   gallop reads the 32 words at lo in one coalesced load.
// - lanes = 1 (large M, where the threads alone fill the card): one thread
//   a probe, a binary-lifting search for lo (the prefix of entries below the
//   probe grows by halving steps, so a warp's threads stay converged and
//   the top levels' words stay in L1), then an exponential gallop for hi.
// out is (2, M) for side 3 (lo in row 0, hi in row 1), else (1, M) with the
// asked bound; side 1 = left, 2 = right, 3 = both.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // lanes = 1: probes per block
constexpr int kWarpBlock = 128;   // lanes = 32: four probes per block

__device__ __forceinline__ bool below(long long v, long long p, bool strict) {
  return strict ? (v < p) : (v <= p);
}

// #{j < n : t[j] < p} (strict) or #{j < n : t[j] <= p}, t sorted
__device__ __forceinline__ long long lift(const long long* __restrict__ t,
                                          long long n, long long p,
                                          bool strict) {
  if (n <= 0) return 0;
  long long pos = 0;
  for (long long step = 1LL << (63 - __clzll(n)); step > 0; step >>= 1) {
    const long long next = pos + step;
    if (next <= n && below(__ldg(t + next - 1), p, strict)) pos = next;
  }
  return pos;
}

// hi = #{t <= p} given lo = #{t < p}: gallop over the run of keys equal to
// p that starts at lo, then a bounded search between the last two probes
__device__ __forceinline__ long long gallop_hi(const long long* __restrict__ t,
                                               long long n, long long p,
                                               long long lo) {
  if (lo >= n || __ldg(t + lo) != p) return lo;
  long long good = lo, bad = n;   // t[good] <= p; bad == n or t[bad] > p
  for (long long step = 1; good + step < n; step <<= 1) {
    if (__ldg(t + good + step) <= p) {
      good += step;
    } else {
      bad = good + step;
      break;
    }
  }
  return good + 1 + lift(t + good + 1, bad - good - 1, p, false);
}

__global__ void __launch_bounds__(kThreads)
merge_join_ranks_kernel_thread(const long long* __restrict__ table,
                               const long long* __restrict__ probes,
                               long long* __restrict__ out, long long n,
                               long long m, int side) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  const long long p = __ldg(probes + i);
  if (side == 2) {
    out[i] = lift(table, n, p, false);
    return;
  }
  const long long lo = lift(table, n, p, true);
  out[i] = lo;
  if (side == 3) out[m + i] = gallop_hi(table, n, p, lo);
}

// 32-ary search over the open interval [L, R): every entry before L
// satisfies the predicate, t[R] does not (or R == n). Returns the first
// index that does not. All 32 lanes of the warp take part.
__device__ __forceinline__ long long warp_search(
    const long long* __restrict__ t, long long L, long long R, long long p,
    bool strict, int lane) {
  while (R > L) {
    const long long s = (R - L + 31) >> 5;          // chunk per lane
    const long long pos = L + (lane + 1) * s - 1;   // last entry of a chunk
    const bool pred = pos < R && below(__ldg(t + pos), p, strict);
    // the predicate holds on a prefix of the lanes: skip those chunks
    L += __popc(__ballot_sync(0xffffffffu, pred)) * s;
    R = min(L + s - 1, R);
  }
  return L;
}

__global__ void __launch_bounds__(kWarpBlock)
merge_join_ranks_kernel_warp(const long long* __restrict__ table,
                             const long long* __restrict__ probes,
                             long long* __restrict__ out, long long n,
                             long long m, int side) {
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * (kWarpBlock / 32) +
                      (threadIdx.x >> 5);
  if (i >= m) return;   // the whole warp leaves together
  const long long p = __ldg(probes + i);
  if (side == 2) {
    const long long hi = warp_search(table, 0, n, p, false, lane);
    if (lane == 0) out[i] = hi;
    return;
  }
  const long long lo = warp_search(table, 0, n, p, true, lane);
  long long hi = lo;
  if (side == 3) {
    // gallop window: the 32 entries from lo, one coalesced read; past it,
    // a 32-ary search over the rest of the run
    const long long j = lo + lane;
    const bool eq = j < n && __ldg(table + j) <= p;
    const int run = __popc(__ballot_sync(0xffffffffu, eq));
    hi = run < 32 ? lo + run : warp_search(table, lo + 32, n, p, false, lane);
  }
  if (lane == 0) {
    out[i] = lo;
    if (side == 3) out[m + i] = hi;
  }
}

}  // namespace

extern "C" int merge_join_ranks_launch(const void* table, const void* probes,
                                       void* out, long long n, long long m,
                                       int side, int lanes, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long* t = (const long long*)table;
  const long long* p = (const long long*)probes;
  long long* o = (long long*)out;
  if (lanes == 32) {
    const long long per = kWarpBlock / 32;
    merge_join_ranks_kernel_warp<<<(unsigned)((m + per - 1) / per),
                                   kWarpBlock, 0, s>>>(t, p, o, n, m, side);
  } else {
    merge_join_ranks_kernel_thread<<<(unsigned)((m + kThreads - 1) /
                                                kThreads),
                                     kThreads, 0, s>>>(t, p, o, n, m, side);
  }
  return (int)cudaGetLastError();
}

// The host's rank call in one C call. `host_in` and `host_out` are pinned
// host memory, which the card reads and writes in place over the bus (one
// address space with the host's, as cudaHostAlloc gives it). With the
// table resident on the card (`table` set), the kernel reads the m probes
// from host_in and writes the (1 or 2, m) ranks into host_out: one launch
// and one synchronise, no copy. Without it, host_in holds the table, then
// the probes: one host-to-device copy of the n + m words into `dev_in`
// comes first. On an H100 a copy costs more than the kernel's own reads of
// a few thousand probes (kernels/ops.py, `_cuda_round_trip`).
extern "C" int merge_join_ranks_round_trip(const void* host_in, void* dev_in,
                                           const void* table, long long n,
                                           long long m, void* host_out,
                                           int side, int lanes, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long* probes = (const long long*)host_in;
  if (table == nullptr) {
    const cudaError_t err = cudaMemcpyAsync(dev_in, host_in, (n + m) * 8,
                                            cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return (int)err;
    table = dev_in;
    probes = (const long long*)dev_in + n;
  }
  const int launched = merge_join_ranks_launch(table, probes, host_out, n, m,
                                               side, lanes, stream);
  if (launched != 0) return launched;
  return (int)cudaStreamSynchronize(s);
}
