// Z-order (Morton) interleave of 16-bit cell coordinates: code bit 2i is
// bit i of cx, bit 2i+1 is bit i of cy, both coordinates masked to their low
// 16 bits first; the uint32 code is returned as int32, so codes with bit 31
// set come out negative.
//
// Replaces the TPU kernel src/repro/kernels/morton_kernel.py:31
// (morton_encode, pallas_call at :41), which pads the inputs to (R, 128)
// lane-aligned tiles; here the grid covers n directly and nothing is padded.
//
// Bound on an H100: bytes. 8 bytes read and 4 written a code; the 16 integer
// operations of the two spreads are far below the scalar rate.
//
// Design: one thread per code, in unsigned arithmetic (the shifts and masks
// of the reference's uint32 spread, bit for bit).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned spread(unsigned v) {
  v &= 0xFFFFu;
  v = (v | (v << 8)) & 0x00FF00FFu;
  v = (v | (v << 4)) & 0x0F0F0F0Fu;
  v = (v | (v << 2)) & 0x33333333u;
  v = (v | (v << 1)) & 0x55555555u;
  return v;
}

__global__ void morton_encode_kernel(const int* __restrict__ cx,
                                     const int* __restrict__ cy,
                                     int* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const unsigned code = spread((unsigned)__ldg(cx + i))
                        | (spread((unsigned)__ldg(cy + i)) << 1);
  out[i] = (int)code;
}

}  // namespace

extern "C" int morton_encode_launch(const void* cx, const void* cy, void* out,
                                    long long n, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  morton_encode_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int*)cx, (const int*)cy, (int*)out, n);
  return (int)cudaGetLastError();
}
