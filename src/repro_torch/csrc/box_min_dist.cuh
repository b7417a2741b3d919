// Shared by fused_topk_join.cu and distance_join.cu: the one f32 formula for
// the minimum distance between two boxes (x0, y0, x2, y3).
//
// Every step is rounded on its own (the _rn intrinsics, and the build passes
// --fmad=false): dx = max(0, max(a.x0 - b.x2, b.x0 - a.x2)), the same for dy,
// v = dx*dx; v = v + dy*dy; sqrt(v). That is what numpy, eager torch and the
// reference's geometry.box_min_dist compute, and it makes the matrix kernel
// give bit-for-bit the value the fused kernel tests, which the fused join's
// overflow recovery relies on.
#pragma once

#include <cuda_runtime.h>

// torch.maximum semantics: NaN in, NaN out
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float box_min_dist(float4 a, float4 b) {
  float dx = max_nan(0.0f, max_nan(__fsub_rn(a.x, b.z), __fsub_rn(b.x, a.z)));
  float dy = max_nan(0.0f, max_nan(__fsub_rn(a.y, b.w), __fsub_rn(b.y, a.w)));
  float v = __fmul_rn(dx, dx);
  v = __fadd_rn(v, __fmul_rn(dy, dy));
  return __fsqrt_rn(v);
}
