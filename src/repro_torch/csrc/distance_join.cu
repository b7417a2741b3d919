// Dense MBR min-distance matrix: out[i, j] = box_min_dist(driver[i], driven[j]).
//
// Replaces the TPU kernel src/repro/kernels/distance_join.py:36 (distance_join,
// pallas_call at :50). Callers: the join="kernel" backend
// (core/spatial_join.mbr_distance_join) and the fused join's overflow-row
// recovery (core/spatial_join.fused_stream_join).
//
// Bound on an H100: bytes. Each output element costs 4 bytes of store and
// about 12 f32 operations, so the (M, N) f32 output at 3.35 TB/s dominates
// the 67 TFLOP/s scalar rate.
//
// Design: one thread per output element in a grid-stride loop over the flat
// row-major index, so neighbouring threads write neighbouring addresses
// along N (coalesced stores) and read neighbouring 16-byte driven boxes; the
// driver box of a row is the same address across a warp (one broadcast).
#include <cuda_runtime.h>

#include "box_min_dist.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void distance_join_kernel(const float4* __restrict__ driver,
                                     const float4* __restrict__ driven,
                                     float* __restrict__ out, long long m,
                                     long long n) {
  const long long total = m * n;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += step) {
    const long long i = t / n;
    out[t] = box_min_dist(driver[i], driven[t - i * n]);
  }
}

}  // namespace

extern "C" int distance_join_launch(const void* driver, const void* driven,
                                    void* out, long long m, long long n,
                                    void* stream) {
  const long long total = m * n;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  distance_join_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const float4*)driver, (const float4*)driven, (float*)out, m, n);
  return (int)cudaGetLastError();
}
