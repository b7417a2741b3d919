// Streaming Phase-3 join: per driver row, the k best surviving driven columns.
//
// Replaces the TPU kernel src/repro/kernels/fused_topk_join.py:110
// (fused_topk_join, pallas_call at :163). Pair (i, j) survives iff
// box_min_dist(driver[i], driven[j]) <= dist[i] and dk[i] + vk[j] > theta[i]
// and rq[i] == cq[j]. Per row the kernel writes the k best survivors by key
// bound dk[i] + vk[j] (ties to the lowest column), padded with -inf / -1,
// and the exact survivor count, which exceeds k when the row overflowed.
//
// Bound on an H100: operations. Each (i, j) pair costs about 16 f32
// operations and the inputs are 16-byte boxes read once, so the M x N pair
// tests at the 67 TFLOP/s scalar rate dominate the bytes; the per-row top-k
// bookkeeping only runs for pairs that can still enter it.
//
// Design: the TPU kernel carried each row's running partial across the
// sequential inner grid axis. Hopper blocks run in no order, so here one
// block of 256 threads owns one driver row and walks all N columns itself in
// tiles of 256. The row's top-k list lives in shared memory, sorted by
// (score descending, column ascending), double-buffered. Per tile, each
// thread tests one column; the candidates that can still enter (the list is
// not full, or the score is strictly greater than the list's last score, so
// an earlier, lower column wins a tie) are bitonic-sorted in shared memory
// and merged into the list by rank: a new candidate's rank is its position
// among the new ones plus the number of list entries with a score >= its
// own (all of them have lower columns); a list entry's rank is its position
// plus the number of new candidates with a strictly greater score. Entries
// ranked >= k drop out. Tiles with no entering candidate cost one barrier.
// Padding keys of -inf give a bound of -inf, which is never > theta, and
// padding qids never match, so padding never survives.
#include <cuda_runtime.h>
#include <climits>
#include <cmath>

#include "box_min_dist.cuh"

namespace {

constexpr int kThreads = 256;   // threads per block == columns per tile

__device__ __forceinline__ bool precedes(float s1, int j1, float s2, int j2) {
  return s1 > s2 || (s1 == s2 && j1 < j2);
}

__global__ void fused_topk_join_kernel(
    const float4* __restrict__ driver, const float4* __restrict__ driven,
    const float* __restrict__ dk, const float* __restrict__ vk,
    const float* __restrict__ dist, const float* __restrict__ theta,
    const int* __restrict__ rq, const int* __restrict__ cq,
    float* __restrict__ out_s, int* __restrict__ out_i,
    int* __restrict__ out_c, int n, int k) {
  extern __shared__ unsigned char smem[];
  float* list_s[2];
  int* list_i[2];
  list_s[0] = reinterpret_cast<float*>(smem);
  list_i[0] = reinterpret_cast<int*>(list_s[0] + k);
  list_s[1] = reinterpret_cast<float*>(list_i[0] + k);
  list_i[1] = reinterpret_cast<int*>(list_s[1] + k);
  float* cand_s = reinterpret_cast<float*>(list_i[1] + k);
  int* cand_i = reinterpret_cast<int*>(cand_s + kThreads);
  __shared__ int count;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const float4 a = driver[row];
  const float a_key = dk[row];
  const float a_dist = dist[row];
  const float a_theta = theta[row];
  const int a_qid = rq[row];
  if (tid == 0) count = 0;
  __syncthreads();

  int cur = 0;               // which buffer holds the list
  int nl = 0;                // list length, the same in every thread
  float worst = -INFINITY;   // list's last score once nl == k
  int my_count = 0;
  for (int base = 0; base < n; base += kThreads) {
    const int j = base + tid;
    bool valid = false;
    float s = -INFINITY;
    if (j < n) {
      const float d = box_min_dist(a, driven[j]);
      s = __fadd_rn(a_key, vk[j]);
      valid = (d <= a_dist) && (s > a_theta) && (a_qid == cq[j]);
    }
    my_count += valid;
    const bool enter = valid && (nl < k || s > worst);
    cand_s[tid] = enter ? s : -INFINITY;   // sentinels sort last
    cand_i[tid] = enter ? j : INT_MAX;
    const int nc = __syncthreads_count(enter);
    if (nc == 0) continue;
    // bitonic sort of the tile's candidates into precedes-order
    for (int size = 2; size <= kThreads; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const int p = tid ^ stride;
        if (p > tid) {
          const float s1 = cand_s[tid], s2 = cand_s[p];
          const int j1 = cand_i[tid], j2 = cand_i[p];
          const bool up = (tid & size) == 0;
          if (up ? precedes(s2, j2, s1, j1) : precedes(s1, j1, s2, j2)) {
            cand_s[tid] = s2;
            cand_s[p] = s1;
            cand_i[tid] = j2;
            cand_i[p] = j1;
          }
        }
        __syncthreads();
      }
    }
    // merge the sorted candidates into the list by rank
    const float* ls = list_s[cur];
    const int* li = list_i[cur];
    float* ns = list_s[cur ^ 1];
    int* ni = list_i[cur ^ 1];
    if (tid < nc) {
      const float s1 = cand_s[tid];
      int lo = 0, hi = nl;                 // list entries with score >= s1
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (ls[mid] >= s1) lo = mid + 1; else hi = mid;
      }
      const int r = tid + lo;
      if (r < k) {
        ns[r] = s1;
        ni[r] = cand_i[tid];
      }
    }
    for (int q = tid; q < nl; q += kThreads) {
      const float s1 = ls[q];
      int lo = 0, hi = nc;                 // candidates with score > s1
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (cand_s[mid] > s1) lo = mid + 1; else hi = mid;
      }
      const int r = q + lo;
      if (r < k) {
        ns[r] = s1;
        ni[r] = li[q];
      }
    }
    __syncthreads();
    cur ^= 1;
    nl = min(nl + nc, k);
    if (nl == k) worst = list_s[cur][k - 1];
  }
  atomicAdd(&count, my_count);
  __syncthreads();
  const long long off = (long long)row * k;
  for (int r = tid; r < k; r += kThreads) {
    out_s[off + r] = r < nl ? list_s[cur][r] : -INFINITY;
    out_i[off + r] = r < nl ? list_i[cur][r] : -1;
  }
  if (tid == 0) out_c[row] = count;
}

}  // namespace

extern "C" int fused_topk_join_launch(
    const void* driver, const void* driven, const void* dk, const void* vk,
    const void* dist, const void* theta, const void* rq, const void* cq,
    void* out_s, void* out_i, void* out_c, int m, int n, int k,
    void* stream) {
  const size_t smem = (size_t)k * 4 * sizeof(float) + kThreads * 8;
  cudaError_t err = cudaFuncSetAttribute(
      fused_topk_join_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_topk_join_kernel<<<m, kThreads, smem, (cudaStream_t)stream>>>(
      (const float4*)driver, (const float4*)driven, (const float*)dk,
      (const float*)vk, (const float*)dist, (const float*)theta,
      (const int*)rq, (const int*)cq, (float*)out_s, (int*)out_i,
      (int*)out_c, n, k);
  return (int)cudaGetLastError();
}
