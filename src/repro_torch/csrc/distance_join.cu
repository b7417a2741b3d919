// MBR distance join, in two forms that share one body:
// - the matrix: out[i, j] = box_min_dist(driver[i], driven[j]), (M, N) f32,
//   the TPU kernel's own function (kernels/ops.distance_join);
// - the candidate pairs: every (i, j) with box_min_dist <= dist, the f32
//   compare done here (kernels/ops.distance_join_pairs), which is what the
//   engine calls: the join="kernel" backend (core/spatial_join.
//   mbr_distance_join) and the fused join's overflow-row recovery
//   (core/spatial_join.fused_stream_join).
//
// Replaces the TPU kernel src/repro/kernels/distance_join.py:36
// (distance_join, pallas_call at :50), and with the compare its caller's
// mask (src/repro/kernels/ops.py:68, distance_join_mask).
//
// Bound on an H100. The matrix: bytes, 4 bytes of store an element against
// ~12 f32 operations, so the (M, N) output at 3.35 TB/s (5.0 us at 1024 x
// 4096). The pairs: operations, ~15 an element at 67 TFLOP/s (2.6 us over
// the five launches of a 1M-quad kernel-join pass, 12.6 M pairs), since
// only the candidates leave: 9,549 of those 12.6 M on that pass (0.08%).
// At the main path's sizes both are below the launch floor, and what the
// call costs is around the kernel: the host-side copy of an (M, N) f32
// matrix, and a compare and a nonzero over it on the host, was the largest
// block of device time left on a kernel-join pass (50 MB to find 76 KB of
// pairs at 1M quads).
//
// Design. One body (distance_join_kernel<kPairs>): a block of 256 threads
// takes `rows` driver rows x 1,024 columns; each thread holds its 4
// consecutive driven boxes in registers and walks the tile's rows, the
// driver box one broadcast load a row. The matrix epilogue stores the 4
// distances as one 16-byte vector when rows are 16-byte aligned (N % 4 ==
// 0). The pairs epilogue compares each distance with dist; a warp with a
// candidate reserves its slots with one atomic on a device counter (an
// exclusive scan of its lanes' counts by shuffles) and its lanes write
// (i << 32 | j) words straight into pinned host memory, up to `cap` slots,
// compacted in shared memory first so that consecutive lanes write
// consecutive words (the bus takes 8-byte writes from scattered lanes at a
// tenth of its rate).
// The last block to finish (a second counter, after a fence) writes the
// count to the host as well and resets both counters for the next call, so
// a call is one launch and one synchronise, and only the pairs and the
// count cross the bus. The host sorts the words, which restores row-major
// order whatever order the atomics took (kernels/ops.py). A count above
// `cap` means slots were dropped: the host grows its buffer to the count
// and runs the call again, never truncating.
#include <cuda_runtime.h>

#include "box_min_dist.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kColsPerThread = 4;
constexpr int kCols = kThreads * kColsPerThread;   // columns a block
constexpr int kMaxRows = 16;                       // driver rows a block
constexpr long long kGridBlocks = 528;             // four blocks an SM

// counters[0]: pair slots reserved; counters[1]: blocks finished
template <bool kPairs>
__global__ void __launch_bounds__(kThreads)
distance_join_kernel(const float4* __restrict__ driver,
                     const float4* __restrict__ driven, long long m,
                     long long n, int rows, long long col_blocks,
                     float* __restrict__ out, float dist,
                     unsigned long long* __restrict__ counters,
                     unsigned long long* __restrict__ host_out,
                     unsigned long long cap) {
  const long long tile = blockIdx.x / col_blocks;
  const long long c0 = (blockIdx.x - tile * col_blocks) * kCols +
                       threadIdx.x * kColsPerThread;
  float4 col[kColsPerThread];
#pragma unroll
  for (int s = 0; s < kColsPerThread; ++s)
    col[s] = c0 + s < n ? __ldg(driven + c0 + s) : make_float4(0, 0, 0, 0);
  const long long r0 = tile * rows;
  const long long r1 = min(m, r0 + rows);
  const int lane = threadIdx.x & 31;
  for (long long i = r0; i < r1; ++i) {
    const float4 a = __ldg(driver + i);
    float d[kColsPerThread];
#pragma unroll
    for (int s = 0; s < kColsPerThread; ++s) d[s] = box_min_dist(a, col[s]);
    if constexpr (!kPairs) {
      float* row = out + i * n;
      if ((n & 3) == 0) {
        if (c0 < n)
          *reinterpret_cast<float4*>(row + c0) =
              make_float4(d[0], d[1], d[2], d[3]);
      } else {
#pragma unroll
        for (int s = 0; s < kColsPerThread; ++s)
          if (c0 + s < n) row[c0 + s] = d[s];
      }
    } else {
      // a warp's pairs of this row, compacted in order before they go out
      __shared__ unsigned long long stage[kThreads / 32][32 * kColsPerThread];
      unsigned flags = 0;
#pragma unroll
      for (int s = 0; s < kColsPerThread; ++s)
        flags |= (c0 + s < n && d[s] <= dist) ? 1u << s : 0u;
      if (__ballot_sync(0xffffffffu, flags != 0) == 0u) continue;
      const int cnt = __popc(flags);
      int incl = cnt;   // inclusive scan of the lanes' counts
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const int total = __shfl_sync(0xffffffffu, incl, 31);
      unsigned long long* mine = stage[threadIdx.x >> 5];
      int at = incl - cnt;
#pragma unroll
      for (int s = 0; s < kColsPerThread; ++s)
        if (flags >> s & 1u)
          mine[at++] =
              (unsigned long long)i << 32 | (unsigned long long)(c0 + s);
      unsigned long long base = 0;
      if (lane == 0) base = atomicAdd(counters, (unsigned long long)total);
      base = __shfl_sync(0xffffffffu, base, 0);
      __syncwarp();
      // consecutive lanes, consecutive host words: 256-byte writes over
      // the bus, not 8-byte ones
      for (int t = lane; t < total; t += 32)
        if (base + t < cap) host_out[1 + base + t] = mine[t];
      __syncwarp();   // the next row reuses the stage
    }
  }
  if constexpr (kPairs) {
    // every warp's reservation has returned before the barrier, so the
    // last block to count itself finished reads the final count
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      if (atomicAdd(counters + 1, 1ULL) == gridDim.x - 1ULL) {
        host_out[0] = atomicAdd(counters, 0ULL);
        counters[0] = 0;
        counters[1] = 0;
      }
    }
  }
}

struct Plan {
  int rows;
  long long col_blocks, blocks;
};

// rows a block: as many as keep four blocks an SM or more, up to 16
Plan plan(long long m, long long n) {
  Plan p;
  p.col_blocks = (n + kCols - 1) / kCols;
  long long rows = m * p.col_blocks / kGridBlocks;
  p.rows = (int)(rows < 1 ? 1 : rows > kMaxRows ? kMaxRows : rows);
  p.blocks = (m + p.rows - 1) / p.rows * p.col_blocks;
  return p;
}

}  // namespace

extern "C" int distance_join_launch(const void* driver, const void* driven,
                                    void* out, long long m, long long n,
                                    void* stream) {
  const Plan p = plan(m, n);
  distance_join_kernel<false><<<(unsigned)p.blocks, kThreads, 0,
                                (cudaStream_t)stream>>>(
      (const float4*)driver, (const float4*)driven, m, n, p.rows,
      p.col_blocks, (float*)out, 0.0f, nullptr, nullptr, 0);
  return (int)cudaGetLastError();
}

// The pairs kernel alone: `counters` two zeroed device words (the kernel
// leaves them zeroed), `host_out` 1 + cap words of pinned host memory that
// get the count, then the pairs (i << 32 | j) in no fixed order.
extern "C" int distance_join_pairs_launch(const void* driver,
                                          const void* driven, long long m,
                                          long long n, float dist,
                                          void* counters, void* host_out,
                                          long long cap, void* stream) {
  const Plan p = plan(m, n);
  distance_join_kernel<true><<<(unsigned)p.blocks, kThreads, 0,
                               (cudaStream_t)stream>>>(
      (const float4*)driver, (const float4*)driven, m, n, p.rows,
      p.col_blocks, nullptr, dist, (unsigned long long*)counters,
      (unsigned long long*)host_out, (unsigned long long)cap);
  return (int)cudaGetLastError();
}

// The host's pair call in one C call: with `host_in` set, the M driver
// boxes then the N driven boxes staged there (pinned) go up to `dev_in` in
// one copy and are joined from there; else `driver` and `driven` are on the
// card already. One launch, one synchronise.
extern "C" int distance_join_pairs_round_trip(
    const void* host_in, void* dev_in, const void* driver, const void* driven,
    long long m, long long n, float dist, void* counters, void* host_out,
    long long cap, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (host_in != nullptr) {
    const cudaError_t err = cudaMemcpyAsync(dev_in, host_in, (m + n) * 16,
                                            cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return (int)err;
    driver = dev_in;
    driven = (const float4*)dev_in + m;
  }
  const int launched = distance_join_pairs_launch(
      driver, driven, m, n, dist, counters, host_out, cap, stream);
  if (launched != 0) return launched;
  return (int)cudaStreamSynchronize(s);
}
