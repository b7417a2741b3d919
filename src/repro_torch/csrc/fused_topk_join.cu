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
// tests at the 67 TFLOP/s scalar rate dominate the bytes. At the main
// path's shapes (M = 49-2,116 rows, N = 2-4,096 columns) the bound is well
// under a microsecond, so what a launch costs is latency: how many SMs the
// grid reaches and how long the longest block walks.
//
// Design (the wrapper, ops.fused_plan, picks R rows a block, S column splits
// and the split width so that the grid covers ~2 waves of 132 SMs):
// - A block owns R driver rows, one warp a row, and one of S column ranges.
//   The S blocks of a row group form one thread-block cluster (a plain
//   launch when S = 1).
// - The block stages its range's driven boxes, keys and qids in shared
//   memory 256 columns at a time with cp.async, double-buffered: one block
//   barrier per staged tile, none in a warp's row loop.
// - The distance test compares the squared distance with a per-row
//   threshold (`sqrt_threshold`), exactly equivalent to the square root's
//   compare and branch-free, so a lane tests 4 columns at once and one
//   `__any_sync` skips a 128-column step with no survivor.
// - Otherwise, per 32 columns, `__ballot_sync` counts the survivors and
//   finds the entering ones (the row's list is not full, or the score is
//   strictly greater than its last score: an earlier, lower column wins a
//   tie); they are compacted into lanes 0..nc-1 in column order.
// - If their scores already fall in column order (driven keys sorted in
//   descending order, as the stream join passes them) no sort runs, else a
//   warp bitonic sort through shuffles orders them by (score descending,
//   column ascending). If the first of them ranks after the list's last
//   entry, they are appended. Otherwise they merge in place by rank: a
//   candidate's rank is its position plus the list entries with a score
//   >= its own (all have lower columns); a list entry's is its position
//   plus the candidates with a strictly greater score. Entries move only
//   up, so the warp moves them from the back, 32 at a time, reading a
//   chunk before writing it, then writes the candidates. Ranks >= k drop.
// - The row's list (k scores and columns) lives in the warp's shared
//   memory. After `cluster.sync()` every block ranks its own entries among
//   the other splits' lists through distributed shared memory (a split
//   before this one wins ties, since its columns are lower), by binary
//   search there unless the list's two ends already decide (always, with
//   the stream join's sorted keys), and writes them straight to their
//   final place; split 0 adds the counts and writes the padding. A
//   second `cluster.sync()` keeps the lists alive until every block has
//   read them. One launch, no scratch, no atomics.
// Padding keys of -inf give a bound of -inf, which is never > theta, and
// padding qids never match, so padding never survives.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cfloat>
#include <climits>
#include <cmath>

#include "box_min_dist.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 256;            // driven columns staged a step
constexpr int kGroups = 4;            // 32-column groups a lane tests a step
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool precedes(float s1, int j1, float s2, int j2) {
  return s1 > s2 || (s1 == s2 && j1 < j2);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// box_min_dist(a, b) before its square root: the same rounded steps
__device__ __forceinline__ float box_gap_sq(float4 a, float4 b) {
  const float dx =
      max_nan(0.0f, max_nan(__fsub_rn(a.x, b.z), __fsub_rn(b.x, a.z)));
  const float dy =
      max_nan(0.0f, max_nan(__fsub_rn(a.y, b.w), __fsub_rn(b.y, a.w)));
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// The largest f32 m with __fsqrt_rn(m) <= d. The rounded square root is
// monotone, so for every v >= 0, box_min_dist <= d exactly when its
// squared form v <= m: the pair test needs no square root (which costs a
// MUFU, a Newton step and a branch to a slow path), and being branch-free
// lets a warp keep several columns' tests in flight. NaN d: NaN (no v
// passes); d < 0: -1 (none passes, v >= +0); d = +inf: every v but NaN.
__device__ __noinline__ float sqrt_threshold(float d) {
  if (d != d) return d;
  if (d < 0.f) return -1.f;
  if (d == INFINITY) return INFINITY;
  float m = fminf(__fmul_rn(d, d), FLT_MAX);
  while (m > 0.f && __fsqrt_rn(m) > d)
    m = __int_as_float(__float_as_int(m) - 1);
  while (m < FLT_MAX && __fsqrt_rn(__int_as_float(__float_as_int(m) + 1)) <= d)
    m = __int_as_float(__float_as_int(m) + 1);
  return m;
}

// bitonic sort of one (score, column) pair a lane into precedes-order,
// lane 0 first
__device__ __forceinline__ void warp_sort(float& s, int& j, int lane) {
  for (int size = 2; size <= 32; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float ps = __shfl_xor_sync(kFull, s, stride);
      const int pj = __shfl_xor_sync(kFull, j, stride);
      const bool lower = (lane & stride) == 0;
      const bool up = (lane & size) == 0;
      const bool mine_first = precedes(s, j, ps, pj);
      if (mine_first != (lower == up)) {
        s = ps;
        j = pj;
      }
    }
  }
}

// number of lanes whose s (descending over the 32 lanes) is > x
__device__ __forceinline__ int lanes_greater(float s, float x) {
  int c = 0;
  for (int step = 16; step > 0; step >>= 1)
    if (__shfl_sync(kFull, s, c + step - 1) > x) c += step;
  if (__shfl_sync(kFull, s, 31) > x) c = 32;
  return c;
}

// entries of the sorted list ls[0, nl) with a score >= x (kAbove: > x)
template <bool kAbove = false>
__device__ __forceinline__ int list_rank(const float* ls, int nl, float x) {
  int lo = 0, hi = nl;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (kAbove ? ls[mid] > x : ls[mid] >= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Add one 32-column group's entering candidates (lanes with `enter`, in
// column order; `emask` their ballot) to the warp's list ls/li of nl
// entries: compact them into lanes 0..nc-1 through cs/ci, sort them unless
// their scores already fall in column order, then append them or merge
// them in place by rank (see the note at the top). Out of line: it runs
// only for groups with entering candidates, and keeping it out of the
// unrolled step keeps the kernel small for the launches it never reaches.
// Returns the list's new length and, once full, its last score.
struct ListEnd {
  int nl;
  float worst;
};

__device__ __noinline__ ListEnd insert_candidates(
    float s, int col, bool enter, unsigned emask, int lane, int k, float* ls,
    int* li, float* cs, int* ci, int nl, float worst) {
  const int nc = __popc(emask);
  if (enter) {
    const int pos = __popc(emask & ((1u << lane) - 1u));
    cs[pos] = s;
    ci[pos] = col;
  }
  __syncwarp();
  float s1 = lane < nc ? cs[lane] : -INFINITY;   // sentinels sort last
  int j1 = lane < nc ? ci[lane] : INT_MAX;
  __syncwarp();
  const float prev = __shfl_up_sync(kFull, s1, 1);
  if (__ballot_sync(kFull, lane > 0 && lane < nc && s1 > prev))
    warp_sort(s1, j1, lane);
  const float first = __shfl_sync(kFull, s1, 0);
  if (nl == 0 || first <= ls[nl - 1]) {
    // every candidate ranks after the list: append
    if (lane < nc && nl + lane < k) {
      ls[nl + lane] = s1;
      li[nl + lane] = j1;
    }
  } else {
    const int r1 = lane < nc ? lane + list_rank(ls, nl, s1) : k;
    // entries before the first candidate's place keep theirs
    const int keep = __shfl_sync(kFull, r1, 0);
    for (int top = nl; top > keep; top -= 32) {
      const int q = top - 32 + lane;
      const bool mine = q >= keep;
      const float sq = mine ? ls[q] : INFINITY;
      const int jq = mine ? li[q] : 0;
      const int r = q + lanes_greater(s1, sq);
      __syncwarp();
      if (mine && r < k) {
        ls[r] = sq;
        li[r] = jq;
      }
      __syncwarp();
    }
    if (r1 < k) {
      ls[r1] = s1;
      li[r1] = j1;
    }
  }
  nl = min(nl + nc, k);
  __syncwarp();
  return {nl, nl == k ? ls[k - 1] : worst};
}

__global__ void fused_topk_join_kernel(
    const float4* __restrict__ driver, const float4* __restrict__ driven,
    const float* __restrict__ dk, const float* __restrict__ vk,
    const float* __restrict__ dist, const float* __restrict__ theta,
    const int* __restrict__ rq, const int* __restrict__ cq,
    float* __restrict__ out_s, int* __restrict__ out_i,
    int* __restrict__ out_c, int m, int n, int k, int width) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rows = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float4* sbox = reinterpret_cast<float4*>(smem);                // [2][kTile]
  float* svk = reinterpret_cast<float*>(sbox + 2 * kTile);       // [2][kTile]
  int* scq = reinterpret_cast<int*>(svk + 2 * kTile);            // [2][kTile]
  float* lists_s = reinterpret_cast<float*>(scq + 2 * kTile);    // [R][k]
  int* lists_i = reinterpret_cast<int*>(lists_s + rows * k);     // [R][k]
  float* cand_s = reinterpret_cast<float*>(lists_i + rows * k);  // [R][32]
  int* cand_i = reinterpret_cast<int*>(cand_s + rows * 32);      // [R][32]
  int* row_len = cand_i + rows * 32;                             // [R]
  int* row_cnt = row_len + rows;                                 // [R]

  const int split = static_cast<int>(cluster.block_rank());
  const int n_splits = static_cast<int>(cluster.num_blocks());
  const int row = blockIdx.x * rows + warp;
  const bool live = row < m;
  const int lo = min(n, split * width);
  const int hi = min(n, lo + width);
  float* ls = lists_s + warp * k;
  int* li = lists_i + warp * k;
  float* cs = cand_s + warp * 32;
  int* ci = cand_i + warp * 32;

  auto stage = [&](int buf, int base) {
    for (int c = threadIdx.x; c < kTile; c += blockDim.x) {
      const int col = base + c;
      if (col < hi) {
        cp_async16(&sbox[buf * kTile + c], &driven[col]);
        cp_async4(&svk[buf * kTile + c], &vk[col]);
        cp_async4(&scq[buf * kTile + c], &cq[col]);
      }
    }
    cp_async_commit();
  };

  if (lo < hi) stage(0, lo);

  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  float a_key = 0.f, a_dist = 0.f, a_theta = 0.f;
  int a_qid = 0;
  if (live) {
    a = driver[row];
    a_key = dk[row];
    a_dist = dist[row];
    a_theta = theta[row];
    a_qid = rq[row];
  }
  const float a_max = sqrt_threshold(a_dist);   // while the tile loads

  int nl = 0;                // list length, the same in every lane
  float worst = -INFINITY;   // the list's last score once nl == k
  int count = 0;             // survivors, the same in every lane
  int buf = 0;
  for (int base = lo; base < hi; base += kTile) {
    if (base + kTile < hi) {
      stage(buf ^ 1, base + kTile);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int cols = min(kTile, hi - base);
    for (int t0 = 0; live && t0 < cols; t0 += 32 * kGroups) {
      // kGroups 32-column groups a lane: branch-free tests, all in flight
      float s_g[kGroups];
      bool v_g[kGroups];
      bool any = false;
#pragma unroll
      for (int u = 0; u < kGroups; ++u) {
        const int c = min(t0 + 32 * u + lane, cols - 1);
        const float v = box_gap_sq(a, sbox[buf * kTile + c]);
        s_g[u] = __fadd_rn(a_key, svk[buf * kTile + c]);
        v_g[u] = t0 + 32 * u + lane < cols && v <= a_max &&
                 s_g[u] > a_theta && a_qid == scq[buf * kTile + c];
        any |= v_g[u];
      }
      if (!__any_sync(kFull, any)) continue;   // one vote, no survivor
#pragma unroll
      for (int u = 0; u < kGroups; ++u) {
        const int c = t0 + 32 * u + lane;
        const bool valid = v_g[u];
        const float s = s_g[u];
        const unsigned vmask = __ballot_sync(kFull, valid);
        if (vmask == 0) continue;
        count += __popc(vmask);
        const bool enter = valid && (nl < k || s > worst);
        const unsigned emask = __ballot_sync(kFull, enter);
        if (emask == 0) continue;
        const ListEnd end = insert_candidates(s, base + c, enter, emask,
                                              lane, k, ls, li, cs, ci, nl,
                                              worst);
        nl = end.nl;
        worst = end.worst;
      }
    }
    __syncthreads();   // this buffer is staged again next step
    buf ^= 1;
  }
  if (lane == 0) {
    row_len[warp] = nl;
    row_cnt[warp] = count;
  }

  cluster.sync();
  if (live) {
    const long long off = (long long)row * k;
    // every split's length, count, first and last score for this row,
    // one load a lane
    int my_len = nl, my_cnt = count;
    float my_first = 0.f, my_last = 0.f;
    if (n_splits > 1 && lane < n_splits) {
      my_len = *cluster.map_shared_rank(row_len + warp, lane);
      my_cnt = *cluster.map_shared_rank(row_cnt + warp, lane);
      if (my_len > 0) {
        const float* lane_ls = cluster.map_shared_rank(ls, lane);
        my_first = lane_ls[0];
        my_last = lane_ls[my_len - 1];
      }
    }
    for (int q0 = 0; q0 < nl; q0 += 32) {
      const int q = q0 + lane;
      const float v = q < nl ? ls[q] : 0.f;
      int r = q;
      for (int t = 0; t < n_splits; ++t) {
        const int on = __shfl_sync(kFull, my_len, t);
        const float first = __shfl_sync(kFull, my_first, t);
        const float last = __shfl_sync(kFull, my_last, t);
        if (t == split || q >= nl || on == 0) continue;
        // an earlier split's equal score ranks first (lower columns). With
        // the driven keys in descending order (the stream join) an earlier
        // split's list lies wholly above v and a later one's below, so the
        // ends decide and no search runs
        const float* os = cluster.map_shared_rank(ls, t);
        if (t < split)
          r += last >= v ? on : first < v ? 0 : list_rank(os, on, v);
        else
          r += last > v ? on : first <= v ? 0 : list_rank<true>(os, on, v);
      }
      if (q < nl && r < k) {
        out_s[off + r] = v;
        out_i[off + r] = li[q];
      }
    }
    if (split == 0) {
      int total = lane < n_splits ? my_len : 0;
      int cnt = lane < n_splits ? my_cnt : 0;
      for (int o = 16; o > 0; o >>= 1) {
        total += __shfl_xor_sync(kFull, total, o);
        cnt += __shfl_xor_sync(kFull, cnt, o);
      }
      for (int r = min(total, k) + lane; r < k; r += 32) {
        out_s[off + r] = -INFINITY;
        out_i[off + r] = -1;
      }
      if (lane == 0) out_c[row] = cnt;
    }
  }
  cluster.sync();   // no block leaves while another reads its lists
}

}  // namespace

// shared memory of a block of `rows` warps: the staged tiles, then per row
// its list, its candidate scratch, its length and count
static size_t fused_smem_bytes(int rows, int k) {
  return (size_t)2 * kTile * (sizeof(float4) + sizeof(float) + sizeof(int)) +
         (size_t)rows * ((size_t)k * 8 + 32 * 8 + 8);
}

extern "C" int fused_topk_join_launch(
    const void* driver, const void* driven, const void* dk, const void* vk,
    const void* dist, const void* theta, const void* rq, const void* cq,
    void* out_s, void* out_i, void* out_c, int m, int n, int k, int rows,
    int splits, int width, void* stream) {
  const size_t smem = fused_smem_bytes(rows, k);
  cudaError_t err = cudaFuncSetAttribute(
      fused_topk_join_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // a plain launch where the columns are not split: its blocks are
  // clusters of one all the same
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((m + rows - 1) / rows), (unsigned)splits, 1);
  cfg.blockDim = dim3((unsigned)(rows * 32), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = (unsigned)splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(
      &cfg, fused_topk_join_kernel, (const float4*)driver,
      (const float4*)driven, (const float*)dk, (const float*)vk,
      (const float*)dist, (const float*)theta, (const int*)rq,
      (const int*)cq, (float*)out_s, (int*)out_i, (int*)out_c, m, n, k,
      width);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
