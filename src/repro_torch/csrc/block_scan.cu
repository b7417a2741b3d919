// Blocked top-k summary scan: for each row of (nb, B) f32 scores and a
// threshold theta, the row maximum, the count of scores > theta and the
// uint8 survivor mask, all three from one pass over the scores.
//
// Replaces the TPU kernel src/repro/kernels/block_scan.py:27 (block_scan,
// pallas_call at :32), whose grid steps over the rows one (1, B) tile at a
// time. Max and an integer count are order-free, so the result is exact
// whatever order the threads combine in.
//
// Bound on an H100: bytes. The function reads 4 bytes a score and writes one
// mask byte, plus 8 bytes a row; a compare and a max a score are far below
// the scalar rate.
//
// Design: one block per row. Each thread strides over the row (16-byte reads
// and 4-byte mask writes when B is a multiple of 4), keeping its own max and
// count; warp shuffles and one shared-memory pass combine them. A NaN score
// makes the row maximum NaN, as torch's max does.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ void take(float s, float theta, float& mx,
                                     int& cnt, unsigned char& bit) {
  mx = nan_max(mx, s);
  bit = s > theta;
  cnt += bit;
}

__global__ void block_scan_kernel(const float* __restrict__ scores,
                                  float theta, float* __restrict__ block_max,
                                  int* __restrict__ count,
                                  unsigned char* __restrict__ mask, int B) {
  const long long row = blockIdx.x;
  const float* s = scores + row * B;
  unsigned char* mk = mask + row * B;
  float mx = -__int_as_float(0x7f800000);     // -inf
  int cnt = 0;
  if (B % 4 == 0) {
    for (int i = threadIdx.x * 4; i < B; i += kThreads * 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(s + i));
      uchar4 m;
      take(v.x, theta, mx, cnt, m.x);
      take(v.y, theta, mx, cnt, m.y);
      take(v.z, theta, mx, cnt, m.z);
      take(v.w, theta, mx, cnt, m.w);
      *reinterpret_cast<uchar4*>(mk + i) = m;
    }
  } else {
    for (int i = threadIdx.x; i < B; i += kThreads) {
      unsigned char m;
      take(__ldg(s + i), theta, mx, cnt, m);
      mk[i] = m;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  }
  __shared__ float w_max[kThreads / 32];
  __shared__ int w_cnt[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    w_max[warp] = mx;
    w_cnt[warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      mx = nan_max(mx, w_max[w]);
      cnt += w_cnt[w];
    }
    block_max[row] = mx;
    count[row] = cnt;
  }
}

}  // namespace

extern "C" int block_scan_launch(const void* scores, float theta,
                                 void* block_max, void* count, void* mask,
                                 int nb, int B, void* stream) {
  block_scan_kernel<<<nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)scores, theta, (float*)block_max, (int*)count,
      (unsigned char*)mask, B);
  return (int)cudaGetLastError();
}
