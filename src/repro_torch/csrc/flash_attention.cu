// GQA forward attention with an online softmax (FlashAttention):
// o[b, h] = softmax(q[b, h] k[b, kvh]^T * D^-0.5 [+ causal mask]) v[b, kvh],
// kvh = h / (Hq / Hkv), for q (B, Hq, S, D) and k, v (B, Hkv, S, D), f32 or
// bf16 in and out, every product and sum in f32.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:76
// (flash_attention, pallas_call at :100). On the TPU the running state
// (m, l, acc) sits in VMEM scratch carried across the sequential kv grid axis.
// Hopper's blocks run in no order, so here one block owns a tile of BQ query
// rows of one (b, head) and walks the kv tiles itself, skipping the tiles
// above the diagonal when causal. As on the TPU, K/V are never repeated for
// GQA: a block reads its kv head's rows (kvh = h / group) directly, and the
// q heads of a group find them in L2. The masked logit is -1e30, the TPU
// kernel's value; the output is acc / l with l == 0 guarded.
//
// Bound on an H100: operations. At the LM prefill shape (B=1, Hq=16,
// S=4096, D=256, causal) the products are 4*B*Hq*S^2*D/2 = 137 GFLOP against
// 134 MB of q/k/v/o: 0.139 ms at the bf16 tensor-core rate, 0.040 ms of HBM.
//
// Design (a first version that is right, not fast): CUDA cores only. Tiles
// are converted to f32 in shared memory (Q: BQ x D, one K or V tile: BK x D,
// P: BQ x BK; 109 KB at D=256, hence dynamic shared memory above 48 KB, two
// blocks an SM). 256 threads as 16 x 16: thread (ty, tx) owns query rows
// ty*4..ty*4+3; it computes the logits of those rows at columns tx and tx+16
// of the kv tile, reduces the row max and sum over the 16 threads of its row
// group with warp shuffles, and keeps its rows' accumulators for D/16 output
// columns in registers (64 f32 at D=256). Shared-memory rows are padded by 4
// floats so that the float4 reads of the two phases meet few bank conflicts.
// The heaviest causal query tiles (the last) are launched first.
//
// What it leaves to later work: the build's --fmad=false (kernels/_build.py,
// right for the STREAK kernels' exact f32 predicates) forbids contracting the
// products into fused multiply-adds, which halves this kernel's f32 rate; no
// tensor cores (mma/wgmma), no TMA or cp.async double-buffering, and K and V
// share one buffer, so loads and math do not overlap. Exponentials use the
// accurate expf, not __expf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 32;        // kv rows a tile
constexpr int kThreads = 256;  // 16 row groups x 16 column threads
constexpr int kPad = 4;        // floats of padding per shared-memory row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

// rows [row0, row0 + n_rows) of a (S, D) matrix into dst (n_rows, D + kPad)
// as f32, 16-byte global reads; rows at or past S become zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int row0, int n_rows, int S) {
  constexpr int kVec = 16 / sizeof(T);       // elements per 16-byte read
  constexpr int kChunks = D / kVec;          // 16-byte reads per row
  for (int idx = threadIdx.x; idx < n_rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * kVec;
    float* out = dst + r * (D + kPad) + c;
    if (row0 + r < S) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + (long long)(row0 + r) * D + c);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[e] = to_f32(vals[e]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[e] = 0.0f;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int Hq, int Hkv, int S, int causal, float scale) {
  constexpr int kCols = D / 16;              // output columns a thread owns
  constexpr int kVec = kCols < 4 ? kCols : 4;
  constexpr int kGroups = kCols / kVec;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // kBQ x (D + kPad)
  float* kv = qs + kBQ * (D + kPad);             // kBK x (D + kPad)
  float* ps = kv + kBK * (D + kPad);             // kBQ x (kBK + kPad)

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - blockIdx.x;          // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const long long q_off = (long long)bh * S * D;
  const long long kv_off = ((long long)b * Hkv + kvh) * S * D;
  const int q0 = qt * kBQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<T, D>(qs, q + q_off, q0, kBQ, S);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  int n_kt = (S + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                             // previous V tile consumed
    load_tile<T, D>(kv, k + kv_off, k0, kBK, S);
    __syncthreads();

    // logits of rows ty*4+i at columns tx and tx+16
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.0f;
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kk[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            qs + (ty * 4 + i) * (D + kPad) + d);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        kk[j] = *reinterpret_cast<const float4*>(
            kv + (tx + 16 * j) * (D + kPad) + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] += qv[i].x * kk[j].x;
          s[i][j] += qv[i].y * kk[j].y;
          s[i][j] += qv[i].z * kk[j].z;
          s[i][j] += qv[i].w * kk[j].w;
        }
    }

    // mask, online softmax over the 16 threads of the row group
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k0 + tx + 16 * j;
        s[i][j] *= scale;
        if (col >= S || (causal && col > row)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty * 4 + i) * (kBK + kPad) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();                             // K tile consumed, P written
    load_tile<T, D>(kv, v + kv_off, k0, kBK, S);
    __syncthreads();

    // acc += P V over the tile's kBK rows, four at a time
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            ps + (ty * 4 + i) * (kBK + kPad) + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = kv + (j + jj) * (D + kPad);
        float vals[kCols];
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const float* src = vrow + g * 16 * kVec + tx * kVec;
          if constexpr (kVec == 4) {
            const float4 t = *reinterpret_cast<const float4*>(src);
            vals[g * 4 + 0] = t.x;
            vals[g * 4 + 1] = t.y;
            vals[g * 4 + 2] = t.z;
            vals[g * 4 + 3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(src);
            vals[g * 2 + 0] = t.x;
            vals[g * 2 + 1] = t.y;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y
                        : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] += p * vals[c];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float inv = 1.0f / (l[i] == 0.0f ? 1.0f : l[i]);
    T* orow = o + q_off + (long long)row * D;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        from_f32(orow + g * 16 * kVec + tx * kVec + e,
                 acc[i][g * kVec + e] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int S, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((kBQ + kBK) * (D + kPad)
                                       + kBQ * (kBK + kPad));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * Hq);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Hq, Hkv, S, causal,
      (float)(1.0 / sqrt((double)D)));           // D**-0.5 rounded once
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int S, int D, int causal, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, Hq, Hkv, S, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Hq, Hkv, S, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Hq, Hkv, S, causal, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, Hq, Hkv, S, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D in {32, 64, 128, 256}
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Hq,
                                      int Hkv, int S, int D, int causal,
                                      int dtype, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, B, Hq, Hkv, S, D, causal, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, S, D, causal, st);
  return (int)cudaErrorInvalidValue;
}
