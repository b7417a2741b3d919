// Batched Bloom membership: out[b] = all k double-hashed bits of keys[b]
// are set in the pre-gathered filter row bits[b, :].
//
// Replaces the TPU kernel src/repro/kernels/bloom_probe.py:54 (bloom_probe,
// pallas_call at :66). Bit positions are (h1 + i*h2) mod 32W with
// h1 = hash32(key, 0), h2 = hash32(key, 1) | 1 and hash32 the 32-bit murmur3
// finalizer pair of core/charsets.py, all in uint32 arithmetic, so the
// verdicts equal the host's BloomBank bit for bit. The TPU kernel selected
// each word by a one-hot sum over the W lanes because a TPU has no in-row
// gather; here a thread reads its k words directly.
//
// Bound on an H100: bytes. Per row the function needs its 8-byte key, the
// words it tests (at most k of 4 bytes; a row stops at its first clear bit)
// and a 1-byte verdict; the hashing is ~30 integer operations per key, far
// below the scalar rate.
//
// Design: one thread per row, the key split into 32-bit halves in registers,
// the k word reads through the read-only cache, and an early exit at the
// first clear bit (absent keys usually miss on the first probe). Rows are
// 32-128 bytes, so a warp's reads touch at most 32 rows' sectors.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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
