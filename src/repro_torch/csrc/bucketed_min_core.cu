// Exact-geometry refinement core: per bucket row, the minimum over its
// m_pad x n_pad point pairs of sum_d (a_d - b_d)^2, for every size-class
// bucket of one refinement call in one launch.
//
// Replaces the TPU kernel src/repro/kernels/geom_refine.py:72
// (bucketed_min_core, pallas_call at :88), which runs one bucket a call.
// dims is 2 (x, y: squared euclid) or 3 (unit-sphere X, Y, Z: squared
// chord, 4 * haversine h). Padding replicates real points, so there are no
// masks. The sum runs v = d0*d0; v = v + d1*d1 [; v = v + d2*d2] with
// every step rounded (the build passes --fmad=false), as the plain torch
// version does; min is exact in any order, so a pair may be visited twice.
//
// Bound on an H100: operations for the wide size classes, bytes for the
// narrow ones. A row reads dims * (m_pad + n_pad) floats and does about
// 3 * dims * m_pad * n_pad f32 operations. At the main path's classes
// (m_pad, n_pad <= 8, ~50-1,000 rows a bucket) a bucket is far under a
// microsecond of either, so the launch itself is the cost: one launch a
// refinement call, where the TPU kernel's port made one a bucket.
//
// Design: the host packs every bucket's planes into one f32 buffer behind
// an int32 descriptor table (per bucket: plane offsets, output offset,
// rows, m_pad, n_pad, first block, layout; see ops.min_core_group). A
// block finds its bucket by a binary search over the first blocks, and the
// bucket's layout, chosen by its class, decides how the block works:
// - THREAD (m_pad * n_pad <= 64, n_pad <= 16): one thread a row, 256 rows a
//   block; the driven points sit in registers (n_pad rounded up to a power
//   of two, the extra slots replicating the last point), the driver points
//   stream past them. No shared memory, no barrier.
// - WARP (m_pad, n_pad <= 32): one warp a row, 8 rows a block. The warp
//   stages the row's driven points in shared memory; each lane keeps one
//   driver point in registers (lane % m_pad, worked out once) and steps
//   over its share of the driven points, with no division a pair. A
//   shuffle reduction takes the warp's minimum.
// - BLOCK (larger classes, up to 128 x 128): one block a row. Both point
//   sets are staged in shared memory, padded to a multiple of 4 by
//   replication; each thread keeps a 4-point driven micro-tile in
//   registers and walks 4-point driver micro-tiles past it (16 pairs for
//   2 * dims float4 loads), then the block reduces.
#include <cuda_runtime.h>
#include <cmath>

namespace {

// descriptor columns, as ops.min_core_group writes them
enum { kAOff, kBOff, kOutOff, kRows, kMPad, kNPad, kFirstBlock, kLayout,
       kDescCols };
enum { kThread = 0, kWarp = 1, kBlock = 2 };
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 768;   // floats: 8 warps x 3 x 32, or 3 x (128 + 128)
constexpr unsigned kFull = 0xffffffffu;

template <int D>
__device__ __forceinline__ float pair_core(const float* a, const float* b) {
  float diff = __fsub_rn(a[0], b[0]);
  float v = __fmul_rn(diff, diff);
#pragma unroll
  for (int d = 1; d < D; ++d) {
    diff = __fsub_rn(a[d], b[d]);
    v = __fadd_rn(v, __fmul_rn(diff, diff));
  }
  return v;
}

// one thread a row; NMAX >= n_pad is a power of two
template <int D, int NMAX>
__device__ void thread_row(const float* __restrict__ a,
                           const float* __restrict__ b, float* out, int nb,
                           int m_pad, int n_pad, int row) {
  float bp[NMAX][D];
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    const int jj = min(j, n_pad - 1);
#pragma unroll
    for (int d = 0; d < D; ++d)
      bp[j][d] = b[((long long)d * nb + row) * n_pad + jj];
  }
  float best = INFINITY;
  for (int i = 0; i < m_pad; ++i) {
    float ai[D];
#pragma unroll
    for (int d = 0; d < D; ++d)
      ai[d] = a[((long long)d * nb + row) * m_pad + i];
#pragma unroll
    for (int j = 0; j < NMAX; ++j) best = fminf(best, pair_core<D>(ai, bp[j]));
  }
  out[row] = best;
}

template <int D>
__device__ void thread_rows(const float* a, const float* b, float* out,
                            int nb, int m_pad, int n_pad, int row) {
  if (row >= nb) return;
  if (n_pad <= 1) thread_row<D, 1>(a, b, out, nb, m_pad, n_pad, row);
  else if (n_pad <= 2) thread_row<D, 2>(a, b, out, nb, m_pad, n_pad, row);
  else if (n_pad <= 4) thread_row<D, 4>(a, b, out, nb, m_pad, n_pad, row);
  else if (n_pad <= 8) thread_row<D, 8>(a, b, out, nb, m_pad, n_pad, row);
  else thread_row<D, 16>(a, b, out, nb, m_pad, n_pad, row);
}

// one warp a row, m_pad and n_pad <= 32
template <int D>
__device__ void warp_row(const float* __restrict__ a,
                         const float* __restrict__ b, float* out, int nb,
                         int m_pad, int n_pad, int row, float* stage) {
  if (row >= nb) return;   // warp-uniform; no block barrier in this layout
  const int lane = threadIdx.x & 31;
  float* sb = stage + (threadIdx.x >> 5) * 3 * 32;   // [D][32]
  if (lane < n_pad) {
#pragma unroll
    for (int d = 0; d < D; ++d)
      sb[d * 32 + lane] = b[((long long)d * nb + row) * n_pad + lane];
  }
  __syncwarp();
  const int groups = 32 / m_pad;
  float best = INFINITY;
  if (lane < groups * m_pad) {
    const int i = lane % m_pad;
    float ai[D];
#pragma unroll
    for (int d = 0; d < D; ++d)
      ai[d] = a[((long long)d * nb + row) * m_pad + i];
    for (int j = lane / m_pad; j < n_pad; j += groups) {
      float bj[D];
#pragma unroll
      for (int d = 0; d < D; ++d) bj[d] = sb[d * 32 + j];
      best = fminf(best, pair_core<D>(ai, bj));
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    best = fminf(best, __shfl_xor_sync(kFull, best, off));
  if (lane == 0) out[row] = best;
}

// one block a row, m_pad and n_pad <= 128
template <int D>
__device__ void block_row(const float* __restrict__ a,
                          const float* __restrict__ b, float* out, int nb,
                          int m_pad, int n_pad, int row, float* stage,
                          float* red) {
  const int m4 = (m_pad + 3) & ~3;
  const int n4 = (n_pad + 3) & ~3;
  float* sa = stage;            // [D][m4]
  float* sb = stage + D * m4;   // [D][n4]
  for (int t = threadIdx.x; t < D * m4; t += kThreads) {
    const int d = t / m4, i = t - d * m4;
    sa[t] = a[((long long)d * nb + row) * m_pad + min(i, m_pad - 1)];
  }
  for (int t = threadIdx.x; t < D * n4; t += kThreads) {
    const int d = t / n4, j = t - d * n4;
    sb[t] = b[((long long)d * nb + row) * n_pad + min(j, n_pad - 1)];
  }
  __syncthreads();
  const int tiles_j = n4 >> 2, tiles_i = m4 >> 2;
  const int step = kThreads / tiles_j;   // tiles_j <= 32, so step >= 8
  const int tj = threadIdx.x % tiles_j, ti0 = threadIdx.x / tiles_j;
  float best = INFINITY;
  if (ti0 < step) {
    float bq[4][D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float4 v = *reinterpret_cast<const float4*>(sb + d * n4 + 4 * tj);
      bq[0][d] = v.x; bq[1][d] = v.y; bq[2][d] = v.z; bq[3][d] = v.w;
    }
    for (int ti = ti0; ti < tiles_i; ti += step) {
      float aq[4][D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float4 v =
            *reinterpret_cast<const float4*>(sa + d * m4 + 4 * ti);
        aq[0][d] = v.x; aq[1][d] = v.y; aq[2][d] = v.z; aq[3][d] = v.w;
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y)
          best = fminf(best, pair_core<D>(aq[x], bq[y]));
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    best = fminf(best, __shfl_xor_sync(kFull, best, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = red[0];
    for (int w = 1; w < kWarps; ++w) v = fminf(v, red[w]);
    out[row] = v;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) bucketed_min_core_kernel(
    const int* __restrict__ desc, int n_groups,
    const float* __restrict__ planes, float* __restrict__ out) {
  __shared__ __align__(16) float stage[kStage];
  __shared__ float red[kWarps];
  // this block's bucket: the last whose first block is <= blockIdx.x
  int lo = 0, hi = n_groups - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (desc[mid * kDescCols + kFirstBlock] <= (int)blockIdx.x) lo = mid;
    else hi = mid - 1;
  }
  const int* g = desc + lo * kDescCols;
  const float* a = planes + g[kAOff];
  const float* b = planes + g[kBOff];
  float* o = out + g[kOutOff];
  const int nb = g[kRows], m_pad = g[kMPad], n_pad = g[kNPad];
  const int local = (int)blockIdx.x - g[kFirstBlock];
  switch (g[kLayout]) {
    case kThread:
      thread_rows<D>(a, b, o, nb, m_pad, n_pad, local * kThreads + threadIdx.x);
      break;
    case kWarp:
      warp_row<D>(a, b, o, nb, m_pad, n_pad,
                  local * kWarps + (threadIdx.x >> 5), stage);
      break;
    default:
      block_row<D>(a, b, o, nb, m_pad, n_pad, local, stage, red);
      break;
  }
}

}  // namespace

extern "C" int bucketed_min_core_launch(const void* desc,
                                        const void* planes, void* out,
                                        int n_groups, int dims, int n_blocks,
                                        void* stream) {
  auto kernel = dims == 3 ? bucketed_min_core_kernel<3>
                          : bucketed_min_core_kernel<2>;
  kernel<<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)desc, n_groups, (const float*)planes, (float*)out);
  return (int)cudaGetLastError();
}
