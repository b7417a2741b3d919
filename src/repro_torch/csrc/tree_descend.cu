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
// Bound on an H100: bytes at these sizes. Inputs (4N node keys, B*M*4 box
// keys, N path flags) and the (B, N) output are read or written once; the
// box tests stop at a node's first hit, and nodes off the Bloom path test
// nothing.
//
// Design: one thread per (block b, node n), nodes along x, blocks along y.
// A thread block stages tiles of 256 of block b's boxes (8 KB) in shared
// memory, where every thread reads the same box at the same time (one
// broadcast). A thread stops testing at its first hit, and the whole thread
// block leaves the box loop once every thread has a hit or is off the Bloom
// path. Padding boxes (kernels/ops.DESCEND_PAD_BOX) never hit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;   // boxes staged per tile

__global__ void tree_descend_kernel(const long long* __restrict__ node_keys,
                                    const unsigned char* __restrict__ cs,
                                    const long long* __restrict__ box_keys,
                                    unsigned char* __restrict__ out, int n,
                                    int m) {
  __shared__ long long boxes[kTile * 4];
  const int b = blockIdx.y;
  const int node = blockIdx.x * kThreads + threadIdx.x;
  const bool live = node < n && cs[node] != 0;
  long long nx0 = 0, ny0 = 0, nx2 = 0, ny3 = 0;
  if (live) {
    nx0 = node_keys[node];
    ny0 = node_keys[n + node];
    nx2 = node_keys[2 * n + node];
    ny3 = node_keys[3 * n + node];
  }
  bool hit = false;
  const long long* bk = box_keys + (long long)b * m * 4;
  for (int base = 0; base < m; base += kTile) {
    const int cnt = min(kTile, m - base);
    for (int t = threadIdx.x; t < cnt * 4; t += kThreads)
      boxes[t] = bk[(long long)base * 4 + t];
    __syncthreads();
    if (live && !hit) {
      for (int x = 0; x < cnt; ++x) {
        const long long* q = boxes + 4 * x;   // x0, y0, x2, y3
        if (nx0 <= q[2] && q[0] <= nx2 && ny0 <= q[3] && q[1] <= ny3) {
          hit = true;
          break;
        }
      }
    }
    // also the barrier before the next tile overwrites `boxes`
    if (__syncthreads_and(hit || !live)) break;
  }
  if (node < n) out[(long long)b * n + node] = (live && hit) ? 1 : 0;
}

}  // namespace

extern "C" int tree_descend_launch(const void* node_keys, const void* cs,
                                   const void* box_keys, void* out, int n,
                                   int b, int m, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, b);
  tree_descend_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)node_keys, (const unsigned char*)cs,
      (const long long*)box_keys, (unsigned char*)out, n, m);
  return (int)cudaGetLastError();
}
