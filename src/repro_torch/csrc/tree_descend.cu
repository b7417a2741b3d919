// Fused Phase-1 candidate-node pass: out[b, n] = cs[n] & any_m hit(b, m, n).
//
// Replaces the TPU kernel src/repro/kernels/tree_descend.py:75
// (tree_descend, pallas_call at :113). hit is the closed interval test
// between node n's MBR and driver box m of block b, on order-isomorphic
// int64 sort keys of the f64 coordinates (kernels/ops.f64_sort_keys), so it
// equals the host's f64 test bit-for-bit. The TPU kernel split each key into
// hi/lo int32 planes only because JAX runs without 64-bit integers; here the
// int64 keys are compared directly.
//
// Bound on an H100: at the main path's shapes (B = 8 driver blocks of
// M ~ 230 boxes over LGD's 1,303 nodes, M ~ 2,100 over the 1M-quad store's
// 1,893; every node on the Bloom path) the bytes are a few hundred KB and
// the work is the box tests: a live node that no box hits tests all M, and
// at these shapes most nodes are such. One test is four int64 compares, ~11
// integer instructions. Testing one node's M boxes in one thread, as the
// first port did, serializes M tests behind each other in ceil(N/256) x B =
// 48 blocks for 132 SMs.
//
// Design: a block takes 32 nodes of one driver block b, one node per lane,
// and its 8 warps split the boxes. The block stages tiles of up to 1,024 of
// b's boxes (32 KB) in shared memory; warp w tests its slice of the tile,
// every lane against the same box at the same time, so one shared-memory
// broadcast feeds 32 tests. The grid, ceil(N/32) x B blocks (328 at LGD's
// shape), spreads the tests over every SM. A lane's node is done once it
// is off the Bloom path (it tests nothing and writes 0) or hit; hits go
// into the block's shared 32-bit mask, which every warp reads between runs
// of 32 boxes, so a node hit in one warp's slice stops the other warps'
// tests too, and the block stops loading tiles once all its nodes are done.
// Padding boxes (kernels/ops.DESCEND_PAD_BOX) never hit.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;          // box slices per tile
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 1024;        // boxes staged per tile
constexpr int kRun = 32;           // boxes between reads of the hit mask

__global__ void __launch_bounds__(kThreads)
tree_descend_kernel(const long long* __restrict__ node_keys,
                    const unsigned char* __restrict__ cs,
                    const long long* __restrict__ box_keys,
                    unsigned char* __restrict__ out, int n, int m) {
  __shared__ __align__(16) long long boxes[kTile * 4];   // x0, y0, x2, y3
  __shared__ unsigned found;                // bit l: node of lane l was hit
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int node = blockIdx.x * 32 + lane;
  const bool live = node < n && cs[node] != 0;
  long long nx0 = 0, ny0 = 0, nx2 = 0, ny3 = 0;
  if (live) {
    nx0 = node_keys[node];
    ny0 = node_keys[n + node];
    nx2 = node_keys[2 * n + node];
    ny3 = node_keys[3 * n + node];
  }
  // the same in every warp: lanes whose node tests nothing
  const unsigned dead = ~__ballot_sync(0xffffffffu, live);
  if (threadIdx.x == 0) found = 0;
  __syncthreads();
  const volatile unsigned* hits = &found;
  const long long* bk = box_keys + (long long)b * m * 4;
  for (int base = 0; dead != 0xffffffffu && base < m; base += kTile) {
    const int cnt = min(kTile, m - base);
    for (int t = threadIdx.x; t < cnt * 4; t += kThreads)
      boxes[t] = bk[(long long)base * 4 + t];
    __syncthreads();
    const int per = (cnt + kWarps - 1) / kWarps;
    const int end = min(cnt, (warp + 1) * per);
    for (int x0 = warp * per; x0 < end; x0 += kRun) {
      // one read for the whole warp, so that every lane sees one mask
      const unsigned done = __shfl_sync(0xffffffffu, dead | *hits, 0);
      if (done == 0xffffffffu) break;
      bool hit = false;
      if (!((done >> lane) & 1u)) {
        const int x1 = min(end, x0 + kRun);
        for (int x = x0; x < x1; ++x) {
          const long long* q = boxes + 4 * x;
          hit |= nx0 <= q[2] && q[0] <= nx2 && ny0 <= q[3] && q[1] <= ny3;
        }
      }
      const unsigned mine = __ballot_sync(0xffffffffu, hit);
      if (lane == 0 && mine) atomicOr(&found, mine);
    }
    // also the barrier before the next tile overwrites `boxes`
    __syncthreads();
    if ((dead | *hits) == 0xffffffffu) break;
  }
  if (warp == 0 && node < n)
    out[(long long)b * n + node] = (live && ((*hits >> lane) & 1u)) ? 1 : 0;
}

}  // namespace

extern "C" int tree_descend_launch(const void* node_keys, const void* cs,
                                   const void* box_keys, void* out, int n,
                                   int b, int m, void* stream) {
  const dim3 grid((n + 31) / 32, b);
  tree_descend_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)node_keys, (const unsigned char*)cs,
      (const long long*)box_keys, (unsigned char*)out, n, m);
  return (int)cudaGetLastError();
}
