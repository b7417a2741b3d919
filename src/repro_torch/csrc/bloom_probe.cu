// Batched Bloom membership, in two forms:
// - per row (bloom_probe_kernel): out[b] = all k double-hashed bits of
//   keys[b] are set in the pre-gathered filter row bits[b, :], the TPU
//   kernel's own function (kernels/ops.bloom_probe);
// - per filter over a bank (bloom_probe_any_kernel): out[f] = ANY key of a
//   set has all its k bits set in filter filter_idx[f] of a bank kept on
//   the card (kernels/ops.bloom_probe_any), what the Phase-1 frontier probe
//   asks (core/charsets.BloomBank.contains_any_batch).
//
// Replaces the TPU kernel src/repro/kernels/bloom_probe.py:54 (bloom_probe,
// pallas_call at :66), and with the ANY its caller's gather and reduction
// (src/repro/core/charsets.py:251-270). Bit positions are (h1 + i*h2) mod
// 32W with h1 = hash32(key, 0), h2 = hash32(key, 1) | 1 and hash32 the
// 32-bit murmur3 finalizer pair of core/charsets.py, all in uint32
// arithmetic, so the verdicts equal the host's BloomBank bit for bit. The
// TPU kernel selected each word by a one-hot sum over the W lanes because a
// TPU has no in-row gather; here a thread reads its words directly, or
// takes them from a lane of its warp.
//
// Bound on an H100: bytes, and far below the launch floor at the main
// path's shapes. Per row the per-row form needs its 8-byte key, the words
// it tests (at most k of 4 bytes; a row stops at its first clear bit) and a
// 1-byte verdict; the hashing is ~30 integer operations per key. The
// per-filter form needs a filter index, the words its keys' probes land in
// and a verdict a filter, and the keys once: at LGD's shape (F = 1,303
// nodes, C = 5 keys, W = 8) ~30 KB. What the call cost was around the
// kernel: the host gathered F x C filter rows and tiled the keys F times
// (260 KB), uploaded both, hashed each key F times and took F x C verdicts
// back to reduce them on the host, every query.
//
// Design, per row: one thread per row, the key split into 32-bit halves in
// registers, the k word reads through the read-only cache, and an early
// exit at the first clear bit (absent keys usually miss on the first
// probe).
// Design, per filter: the bank stays on the card (BloomBank keeps one copy
// per device, dropped by `add`); the filter indices and the keys go up in
// one copy from pinned memory, and the F verdict bytes come back straight
// into pinned memory, 8 a write, with one synchronise. A block hashes the
// keys once into shared memory, 256 at a time; each of its 8 warps takes a
// filter, its lanes hold the W <= 32 words of the row, test one key each
// (a word is a shuffle from the lane that holds it) and `__any_sync` gives
// the verdict; a warp stops at its first member key.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAnyWarps = kThreads / 32;   // filters a block
constexpr int kKeyChunk = kThreads;        // keys hashed a step

__device__ __forceinline__ unsigned mix32(unsigned x, unsigned seed) {
  x += 0x9E3779B9u * (seed + 1u);
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ unsigned hash32(unsigned lo, unsigned hi,
                                           unsigned seed) {
  return mix32(lo ^ mix32(hi, seed + 7u), seed);
}

__global__ void bloom_probe_kernel(const unsigned* __restrict__ bits,
                                   const long long* __restrict__ keys,
                                   unsigned char* __restrict__ out,
                                   long long n_rows, int words, int k) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= n_rows) return;
  const unsigned long long key = (unsigned long long)__ldg(keys + row);
  const unsigned lo = (unsigned)key;
  const unsigned hi = (unsigned)(key >> 32);
  const unsigned h1 = hash32(lo, hi, 0u);
  const unsigned h2 = hash32(lo, hi, 1u) | 1u;
  const unsigned nbits = (unsigned)words * 32u;
  const unsigned* r = bits + row * words;
  unsigned char hit = 1;
  for (int i = 0; i < k; ++i) {
    const unsigned pos = (h1 + (unsigned)i * h2) % nbits;
    if (((__ldg(r + (pos >> 5)) >> (pos & 31u)) & 1u) == 0u) {
      hit = 0;
      break;
    }
  }
  out[row] = hit;
}

__global__ void __launch_bounds__(kThreads)
bloom_probe_any_kernel(const unsigned* __restrict__ bits, int words, int k,
                       const long long* __restrict__ filter_idx,
                       long long n_filters,
                       const long long* __restrict__ keys, int n_keys,
                       unsigned char* __restrict__ out) {
  __shared__ unsigned s_h1[kKeyChunk], s_h2[kKeyChunk];
  __shared__ __align__(8) unsigned char s_hit[kAnyWarps];
  const int lane = threadIdx.x & 31;
  const long long f = (long long)blockIdx.x * kAnyWarps + (threadIdx.x >> 5);
  const bool live = f < n_filters;
  const unsigned nbits = (unsigned)words * 32u;
  unsigned word = 0;   // lane l holds word l of the filter's row
  if (live && lane < words)
    word = __ldg(bits + __ldg(filter_idx + f) * words + lane);
  bool hit = false;
  for (int c0 = 0; c0 < n_keys; c0 += kKeyChunk) {
    const int len = min(kKeyChunk, n_keys - c0);
    __syncthreads();   // the previous chunk's hashes are no longer read
    if (threadIdx.x < len) {
      const unsigned long long key =
          (unsigned long long)__ldg(keys + c0 + threadIdx.x);
      const unsigned lo = (unsigned)key, hi = (unsigned)(key >> 32);
      s_h1[threadIdx.x] = hash32(lo, hi, 0u);
      s_h2[threadIdx.x] = hash32(lo, hi, 1u) | 1u;
    }
    __syncthreads();
    if (!live || hit) continue;   // warp-uniform
    // the same trip count on every lane, so the shuffles see all 32
    for (int c = lane; c - lane < len; c += 32) {
      const bool has = c < len;
      const unsigned h1 = has ? s_h1[c] : 0u, h2 = has ? s_h2[c] : 0u;
      bool all = has;
      for (int i = 0; i < k; ++i) {
        const unsigned pos = (h1 + (unsigned)i * h2) % nbits;
        const unsigned w = __shfl_sync(0xffffffffu, word, pos >> 5);
        all = all && ((w >> (pos & 31u)) & 1u);
      }
      if (__any_sync(0xffffffffu, all)) {
        hit = true;
        break;
      }
    }
  }
  // the block's verdicts go out as one 8-byte write where they can: one
  // byte a warp would be a bus write a byte
  if (lane == 0) s_hit[threadIdx.x >> 5] = hit;
  __syncthreads();
  const long long f0 = (long long)blockIdx.x * kAnyWarps;
  if (f0 + kAnyWarps <= n_filters) {
    if (threadIdx.x == 0)
      *reinterpret_cast<unsigned long long*>(out + f0) =
          *reinterpret_cast<const unsigned long long*>(s_hit);
  } else if (threadIdx.x < n_filters - f0) {
    out[f0 + threadIdx.x] = s_hit[threadIdx.x];
  }
}

}  // namespace

extern "C" int bloom_probe_launch(const void* bits, const void* keys,
                                  void* out, long long n_rows, int words,
                                  int k, void* stream) {
  const long long blocks = (n_rows + kThreads - 1) / kThreads;
  bloom_probe_kernel<<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const unsigned*)bits, (const long long*)keys, (unsigned char*)out,
      n_rows, words, k);
  return (int)cudaGetLastError();
}

// The per-filter kernel alone: `idx_keys` holds the n_filters filter
// indices, then the n_keys keys (int64, on the card); `out` n_filters bytes.
extern "C" int bloom_probe_any_launch(const void* bits, int words, int k,
                                      const void* idx_keys,
                                      long long n_filters, int n_keys,
                                      void* out, void* stream) {
  const long long* ik = (const long long*)idx_keys;
  const long long blocks = (n_filters + kAnyWarps - 1) / kAnyWarps;
  bloom_probe_any_kernel<<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const unsigned*)bits, words, k, ik, n_filters, ik + n_filters, n_keys,
      (unsigned char*)out);
  return (int)cudaGetLastError();
}

// The host's per-filter probe in one C call: the indices and keys staged in
// pinned `host_in` go up to `dev_in` in one copy, the kernel writes the
// verdicts into pinned `host_out`, one synchronise.
extern "C" int bloom_probe_any_round_trip(const void* host_in, void* dev_in,
                                          const void* bits, int words, int k,
                                          long long n_filters, int n_keys,
                                          void* host_out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemcpyAsync(
      dev_in, host_in, (n_filters + n_keys) * 8, cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  const int launched = bloom_probe_any_launch(bits, words, k, dev_in,
                                              n_filters, n_keys, host_out,
                                              stream);
  if (launched != 0) return launched;
  return (int)cudaStreamSynchronize(s);
}
