// GQA forward attention with an online softmax (FlashAttention):
// o[b, h] = softmax(q[b, h] k[b, kvh]^T * D^-0.5 [+ causal mask]) v[b, kvh],
// kvh = h / (Hq / Hkv), for q (B, Hq, S, D) and k, v (B, Hkv, S, D), f32 or
// bf16 in and out, running (m, l, acc) in f32, output rounded once.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:76
// (flash_attention, pallas_call at :100). On the TPU the running state
// (m, l, acc) sits in VMEM scratch carried across the sequential kv grid axis.
// Hopper's blocks run in no order, so here one block owns a tile of query
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
// bf16: Hopper tensor cores (flash_attention_kernel_bf16), the FA3 shape.
// A block owns 128 query rows of one (b, head): two consumer warpgroups of
// 64 rows each and one producer warpgroup (setmaxnreg: 240 registers a
// consumer thread, 24 a producer thread).
// - Loads: one producer thread issues TMA copies (3-d tensor maps over
//   (heads, S, D), 64-column boxes, rows past S and columns past D
//   zero-filled) of Q once and of K and V through a two-stage ring in
//   shared memory, each stage's K and V on their own mbarriers: K of tile
//   j+2 loads as soon as S of tile j is done, V once P V of tile j is done.
//   At D=256: Q 64 KB + 2 x (K 32 + V 32) KB = 192 KB, one block an SM. K/V
//   traffic from L2, 64 KB a tile for every 128 query rows, weighs as much
//   as the tensor cores: fed by 16-byte cp.async from the threads instead
//   of TMA, the kernel kept most of its time with P V removed.
// - S = Q K^T with wgmma m64n64k16, bf16 operands from shared memory in
//   the 128-byte-swizzle layout TMA writes, f32 accumulation: a product of
//   two bf16 values is exact in f32, so only the order of the f32 sums
//   differs from the plain version. The f32 logits are scaled by D^-0.5
//   after the product; log2(e) is folded into exp2f.
// - P V with P kept above bf16 precision: P is split into bf16 hi = rn(P)
//   and lo = rn(P - hi), and both run wgmma m64nDk16 (A from registers, V
//   MN-major from shared memory) into one f32 accumulator, so P carries ~16
//   significant bits. Rounding P to bf16 alone, as a textbook FA2/FA3
//   kernel does, reads 1.9-2.4x the port's one-rounding-step limit
//   |got - want| <= 2^-7 |want| + 1e-3 at causal shapes in a model of this
//   kernel (tests/test_torch_flash_numerics.py); the split reads under 1.
//   The split doubles P V's tensor-core work (the bound above does not
//   count it). l sums the f32 P.
// - Step j of a warpgroup issues S of tile j and P V of tile j-1 together
//   and runs tile j's softmax while the P V wgmmas execute (the loop is
//   peeled so that no wgmma sits under a branch, which ptxas would
//   serialize). A warpgroup keeps its O rows in registers (D/2 f32: 128 at
//   D=256) beside the S tile (32) and the P fragments (32).
// - Causal: the heaviest query tiles are launched first (the grid's y axis
//   is the query tile, reversed; heads run along x), kv tiles above a
//   block's last row are never loaded, a warpgroup skips the tiles above
//   its own rows, and the mask is applied only on tiles that cross the
//   diagonal or S. D=32 runs as D=64 with zero columns.
//
// f32: CUDA cores (flash_attention_kernel_f32), every product and sum in
// f32: TF32 tensor cores would miss the reference's 2e-4. Tiles are
// converted to f32 in shared memory (Q: 64 x D, one K or V tile: 32 x D,
// P: 64 x 32; 109 KB at D=256, two blocks an SM). 256 threads as 16 x 16:
// thread (ty, tx) owns query rows ty*4..ty*4+3; it computes the logits of
// those rows at columns tx and tx+16 of the kv tile, reduces the row max
// and sum over the 16 threads of its row group with warp shuffles, and
// keeps its rows' accumulators for D/16 output columns in registers. K and
// V share one buffer, so loads and math do not overlap. Exponentials use
// the accurate expf.
//
// This source builds without --fmad=false (kernels/_build.py): products
// and sums may contract into fused multiply-adds.
#include <cuda.h>           // CUtensorMap and its enums (no driver link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------- bf16 path --
constexpr int kBQ = 128;       // query rows a block: 2 warpgroups x 64
constexpr int kBK = 64;        // kv rows a tile
constexpr int kConsumers = 256;              // 2 warpgroups
constexpr int kThreads = kConsumers + 128;   // + the producer warpgroup
// registers a thread after setmaxnreg: 128 x 24 + 256 x 240 <= 65,536
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

typedef __nv_bfloat16 bf16;

// Shared-memory tiles are stored as wgmma's 128-byte-swizzle layout: a
// (rows x DP) bf16 tile is cut into 64-column blocks of rows x 128 bytes,
// each 1024-byte aligned, and within a block the 16-byte chunk c of row r
// sits at chunk c ^ (r % 8). The same layout is K-major for Q and K and
// MN-major for V.
template <int D>
__host__ __device__ constexpr int padded_dim() {  // D=32 zero-padded
  return D < 64 ? 64 : D;
}

template <int D>
constexpr int smem_bf16_bytes() {   // Q, two stages of K and V, 9 mbarriers
  return (int)sizeof(bf16) * (kBQ + 4 * kBK) * padded_dim<D>() + 128 + 1024;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// TMA: the box at (column c0, row c1, head c2) of a (heads, S, D) tensor
// into shared memory at dst, 64 columns x the map's box rows, 128-byte
// swizzled as above; rows past S and columns past D land as zeros. The
// bytes are counted on the mbarrier bar.
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(bar) : "memory");
}

// rows [row0, row0 + rows) of head `head` into the swizzled tile at dst:
// one TMA box a 64-column block
template <int D>
__device__ __forceinline__ void load_tile(unsigned dst, const CUtensorMap* map,
                                          int rows, int row0, int head,
                                          unsigned bar) {
#pragma unroll
  for (int cb = 0; cb < padded_dim<D>() / 64; ++cb)
    tma_load(dst + cb * rows * 128, map, cb * 64, row0, head, bar);
}

// mbarriers (PTX ISA, "mbarrier"): a phase completes when `count` arrivals
// have come; waiters name the parity of the phase they wait for
__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("{\n.reg .b64 st;\n"
               "mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
               :: "r"(bar) : "memory");
}
// one arrival that also expects `bytes` more of TMA transfers
__device__ __forceinline__ void mbar_expect(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, int parity) {
  asm volatile("{\n.reg .pred done;\nWAIT:\n"
               "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
               "@!done bra WAIT;\n}\n"
               :: "r"(bar), "r"(parity) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (PTX ISA, "matrix descriptor")
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr, unsigned lbo,
                                               unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16
         | (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of this warpgroup's wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// pins registers an asynchronous wgmma reads or writes in place, so the
// compiler moves no access to them across a fence or a wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
__device__ __forceinline__ void pin(unsigned (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// d (64 x 64, f32) += A (64 x 16) B (16 x 64), both bf16 in shared memory
// through descriptors, K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) B (16 x 64, bf16 in
// shared memory through a descriptor, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                           const unsigned (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 in registers) B (16 x 128, bf16 in
// shared memory through a descriptor, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                           const unsigned (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256, f32) += A (64 x 16, bf16 in registers) B (16 x 256, bf16 in
// shared memory through a descriptor, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                           const unsigned (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const unsigned (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ unsigned pack_bf16(__nv_bfloat162 x) {
  return *reinterpret_cast<unsigned*>(&x);
}

// (x, y) -> bf16 hi = rn(x, y) and lo = rn((x, y) - hi), packed in pairs
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = pack_bf16(h);
  lo = pack_bf16(__floats2bfloat162_rn(x - __low2float(h),
                                       y - __high2float(h)));
}

// Fragment layouts (PTX ISA, wgmma .m64nNk16): warp w of a warpgroup owns
// rows 16w..16w+15; lane = 4 * g + t. Accumulator: d[4j], d[4j+1] at (row
// g, cols 8j+2t, 8j+2t+1), d[4j+2], d[4j+3] at row g+8. A in registers:
// a0 (row g, cols 2t, 2t+1), a1 (row g+8), a2 (row g, cols 8+2t), a3 (row
// g+8, cols 8+2t): two 8-column blocks of an accumulator are one A step.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel_bf16(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            bf16* __restrict__ o, int Hq, int Hkv, int S,
                            int causal, float scale) {
  constexpr int DP = padded_dim<D>();
  constexpr int kQBytes = kBQ * DP * 2;
  constexpr int kTBytes = kBK * DP * 2;        // one K or V tile
  constexpr int kNpv = DP < 256 ? DP : 256;    // N of one P V wgmma
  constexpr int kNb = DP / kNpv;               // P V wgmmas a 16-key step
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_addr(smem_raw);
  const unsigned qs = (raw + 1023) & ~1023u;   // swizzle needs 1 KB
  const unsigned kv0 = qs + kQBytes;           // stage s: K at kv0 + 2 s
                                               // kTBytes, V kTBytes on
  // mbarriers, 8 bytes each: K (V) of stage s landed at k_full + 8 s
  // (v_full + 8 s), consumed at k_free + 8 s (v_free + 8 s); Q landed
  const unsigned k_full = kv0 + 4 * kTBytes, v_full = k_full + 16;
  const unsigned k_free = v_full + 16, v_free = k_free + 16;
  const unsigned q_full = v_free + 16;

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - blockIdx.y;        // heaviest tiles first
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const long long q_off = (long long)bh * S * D;
  const int kv_head = b * Hkv + kvh;
  const int q0 = qt * kBQ;
  const int wg = threadIdx.x / 128;            // warpgroup: 64 query rows;
                                               // wg 2 is the producer
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int w0 = q0 + wg * 64;                 // the warpgroup's first row
  const int row0 = w0 + (threadIdx.x % 128) / 32 * 16 + g;
  const int row1 = row0 + 8;                   // this thread's two rows

  int n_kt = (S + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_free + 8 * s, kConsumers);
      mbar_init(v_free + 8 * s, kConsumers);
    }
  }
  __syncthreads();

  if (wg == 2) {                               // the producer warpgroup:
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"  // one thread
                 :: "n"(kProducerRegs));                   // issues TMA
    if (threadIdx.x != kConsumers) return;
    mbar_expect(q_full, kQBytes);
    load_tile<D>(qs, &q_map, kBQ, q0, bh, q_full);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt & 1, parity = ((kt >> 1) - 1) & 1;
      const unsigned ks = kv0 + s * 2 * kTBytes;
      if (kt >= 2) mbar_wait(k_free + 8 * s, parity);
      mbar_expect(k_full + 8 * s, kTBytes);
      load_tile<D>(ks, &k_map, kBK, kt * kBK, kv_head, k_full + 8 * s);
      if (kt >= 2) mbar_wait(v_free + 8 * s, parity);
      mbar_expect(v_full + 8 * s, kTBytes);
      load_tile<D>(ks + kTBytes, &v_map, kBK, kt * kBK, kv_head,
                   v_full + 8 * s);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));

  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  float oacc[kNb][kNpv / 2], sacc[32];
  unsigned ph[4][4], pl[4][4];               // P of the previous tile
#pragma unroll
  for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
    for (int i = 0; i < kNpv / 2; ++i) oacc[nb][i] = 0.0f;

  auto pin_o = [&] {
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) pin(oacc[nb]);
  };
  auto pin_p = [&] {
#pragma unroll
    for (int s16 = 0; s16 < 4; ++s16) {
      pin(ph[s16]);
      pin(pl[s16]);
    }
  };
  // S = Q K^T of the tile in stage s, over D in steps of 16
  auto issue_s = [&](int s) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = 0.0f;
    pin(sacc);
    const unsigned ks = kv0 + s * 2 * kTBytes;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sacc,
                   sw128_desc(qs + (kk / 4) * kBQ * 128 + wg * 64 * 128
                              + (kk % 4) * 32, 16, 1024),
                   sw128_desc(ks + (kk / 4) * kBK * 128 + (kk % 4) * 32,
                              16, 1024));
    wgmma_commit();
  };
  // O += (P_hi + P_lo) V of the tile in stage s, 16 keys a step
  auto issue_pv = [&](int s) {
    const unsigned vs = kv0 + s * 2 * kTBytes + kTBytes;
#pragma unroll
    for (int s16 = 0; s16 < 4; ++s16)
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb) {
        const uint64_t dv = sw128_desc(
            vs + nb * (kNpv / 64) * kBK * 128 + s16 * 16 * 128, kBK * 128,
            1024);
        wgmma_rs<kNpv>(oacc[nb], ph[s16], dv);
        wgmma_rs<kNpv>(oacc[nb], pl[s16], dv);
      }
    wgmma_commit();
  };
  // logits of tile kt, mask, online softmax over the 4 threads of each
  // row: P = exp(logit - m) in sacc, (m, l) updated, O's factors returned
  auto softmax = [&](int kt, float& alpha0, float& alpha1) {
    const int k0 = kt * kBK;
    const bool masked = k0 + kBK > S || (causal && k0 + kBK - 1 > w0);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = sacc[i] * scale;
      if (masked) {
        const int col = k0 + (i / 4) * 8 + 2 * t + (i & 1);
        const int row = (i & 2) ? row1 : row0;
        if (col >= S || (causal && col > row)) x = kNegInf;
      }
      sacc[i] = x;
      if (i & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    alpha0 = exp2f((m0 - mn0) * kLog2e);
    alpha1 = exp2f((m1 - mn1) * kLog2e);
    const float ms0 = mn0 * kLog2e, ms1 = mn1 * kLog2e;
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sacc[i] = exp2f(fmaf(sacc[i], kLog2e, (i & 2) ? -ms1 : -ms0));
      if (i & 2) sum1 += sacc[i]; else sum0 += sacc[i];
    }
    l0 = alpha0 * l0 + sum0;                 // this thread's share of l
    l1 = alpha1 * l1 + sum1;
  };
  // O *= alpha, then P (in sacc) split into the A fragments ph, pl
  auto rescale_split = [&](float alpha0, float alpha1) {
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
      for (int i = 0; i < kNpv / 2; ++i)
        oacc[nb][i] *= (i & 2) ? alpha1 : alpha0;
#pragma unroll
    for (int s16 = 0; s16 < 4; ++s16)
#pragma unroll
      for (int j = 0; j < 4; ++j) {          // a0..a3 of the step
        const int i = s16 * 8 + (j >> 1) * 4 + (j & 1) * 2;
        split_bf16(sacc[i], sacc[i + 1], ph[s16][j], pl[s16][j]);
      }
  };

  // Tiles past n_act lie above the warpgroup's rows (causal): only their
  // stages are released. Step kt of the loop issues S of tile kt and P V
  // of tile kt-1 together and runs tile kt's softmax while the P V wgmmas
  // execute; tile 0's S comes before it, the last P V after.
  const int n_act = causal ? min(n_kt, (w0 + 63) / kBK + 1) : n_kt;
  float alpha0, alpha1;
  mbar_wait(q_full, 0);
  mbar_wait(k_full, 0);
  wgmma_fence();
  issue_s(0);
  wgmma_wait<0>();
  pin(sacc);
  mbar_arrive(k_free);
  softmax(0, alpha0, alpha1);
  rescale_split(alpha0, alpha1);
  for (int kt = 1; kt < n_act; ++kt) {
    const int s = kt & 1, sp = s ^ 1;        // stages of tiles kt, kt-1
    mbar_wait(k_full + 8 * s, (kt >> 1) & 1);
    mbar_wait(v_full + 8 * sp, ((kt - 1) >> 1) & 1);
    pin_o();
    pin_p();
    wgmma_fence();
    issue_s(s);
    issue_pv(sp);
    wgmma_wait<1>();                         // S of tile kt is done
    pin(sacc);
    mbar_arrive(k_free + 8 * s);
    softmax(kt, alpha0, alpha1);
    wgmma_wait<0>();                         // P V of tile kt-1 is done
    pin_o();
    pin_p();
    mbar_arrive(v_free + 8 * sp);
    rescale_split(alpha0, alpha1);
  }
  {
    const int sp = (n_act - 1) & 1;
    mbar_wait(v_full + 8 * sp, ((n_act - 1) >> 1) & 1);
    pin_o();
    pin_p();
    wgmma_fence();
    issue_pv(sp);
    wgmma_wait<0>();
    pin_o();
    pin_p();
    mbar_arrive(v_free + 8 * sp);
  }
  for (int kt = n_act; kt < n_kt; ++kt) {
    const int s = kt & 1, parity = (kt >> 1) & 1;
    mbar_wait(k_full + 8 * s, parity);
    mbar_arrive(k_free + 8 * s);
    mbar_wait(v_full + 8 * s, parity);
    mbar_arrive(v_free + 8 * s);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.0f / (l0 == 0.0f ? 1.0f : l0);
  const float inv1 = 1.0f / (l1 == 0.0f ? 1.0f : l1);
#pragma unroll
  for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
    for (int i = 0; i < kNpv / 2; i += 4) {
      const int col = nb * kNpv + (i / 4) * 8 + 2 * t;
      if (col >= D) continue;
      if (row0 < S)
        *reinterpret_cast<__nv_bfloat162*>(o + q_off + (long long)row0 * D
                                           + col) =
            __floats2bfloat162_rn(oacc[nb][i] * inv0,
                                  oacc[nb][i + 1] * inv0);
      if (row1 < S)
        *reinterpret_cast<__nv_bfloat162*>(o + q_off + (long long)row1 * D
                                           + col) =
            __floats2bfloat162_rn(oacc[nb][i + 2] * inv1,
                                  oacc[nb][i + 3] * inv1);
    }
}

// the driver's cuTensorMapEncodeTiled, found through the runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// a (heads, S, D) bf16 tensor read in boxes of 64 columns x `rows` rows,
// 128-byte swizzled, zeros out of bounds
bool tensor_map(CUtensorMap* map, const void* ptr, int heads, int S, int D,
                int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int Hq, int Hkv, int S, int causal, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  if (!tensor_map(&q_map, q, B * Hq, S, D, kBQ)
      || !tensor_map(&k_map, k, B * Hkv, S, D, kBK)
      || !tensor_map(&v_map, v, B * Hkv, S, D, kBK))
    return (int)cudaErrorNotSupported;
  const int smem = smem_bf16_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel_bf16<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * Hq, (S + kBQ - 1) / kBQ);
  flash_attention_kernel_bf16<D><<<grid, kThreads, smem, stream>>>(
      q_map, k_map, v_map, (bf16*)o, Hq, Hkv, S, causal,
      (float)(1.0 / sqrt((double)D)));   // D**-0.5 rounded once
  return (int)cudaGetLastError();
}

// -------------------------------------------------------------- f32 path --
constexpr int kBQ32 = 64;      // query rows a block
constexpr int kBK32 = 32;      // kv rows a tile
constexpr int kThreads32 = 256;  // 16 row groups x 16 column threads
constexpr int kPad32 = 4;      // floats of padding per shared-memory row

template <int D>
constexpr int smem_f32_bytes() {
  return (int)sizeof(float) * ((kBQ32 + kBK32) * (D + kPad32)
                               + kBQ32 * (kBK32 + kPad32));
}

// rows [row0, row0 + n_rows) of a (S, D) matrix into dst (n_rows, D +
// kPad32), 16-byte global reads; rows at or past S become zeros
template <int D>
__device__ __forceinline__ void load_tile_f32(float* __restrict__ dst,
                                              const float* __restrict__ src,
                                              int row0, int n_rows, int S) {
  constexpr int kChunks = D / 4;             // 16-byte reads per row
  for (int idx = threadIdx.x; idx < n_rows * kChunks; idx += kThreads32) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 4;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < S)
      val = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * D
                                             + c);
    *reinterpret_cast<float4*>(dst + r * (D + kPad32) + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads32)
flash_attention_kernel_f32(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int Hq, int Hkv, int S, int causal, float scale) {
  constexpr int kCols = D / 16;              // output columns a thread owns
  constexpr int kVec = kCols < 4 ? kCols : 4;
  constexpr int kGroups = kCols / kVec;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);     // kBQ32 x (D + kPad32)
  float* kv = qs + kBQ32 * (D + kPad32);           // kBK32 x (D + kPad32)
  float* ps = kv + kBK32 * (D + kPad32);           // kBQ32 x (kBK32 + kPad32)

  const int n_qt = (S + kBQ32 - 1) / kBQ32;
  const int qt = n_qt - 1 - blockIdx.x;          // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const long long q_off = (long long)bh * S * D;
  const long long kv_off = ((long long)b * Hkv + kvh) * S * D;
  const int q0 = qt * kBQ32;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile_f32<D>(qs, q + q_off, q0, kBQ32, S);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  int n_kt = (S + kBK32 - 1) / kBK32;
  if (causal) n_kt = min(n_kt, (q0 + kBQ32 - 1) / kBK32 + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK32;
    __syncthreads();                             // previous V tile consumed
    load_tile_f32<D>(kv, k + kv_off, k0, kBK32, S);
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
            qs + (ty * 4 + i) * (D + kPad32) + d);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        kk[j] = *reinterpret_cast<const float4*>(
            kv + (tx + 16 * j) * (D + kPad32) + d);
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
        ps[(ty * 4 + i) * (kBK32 + kPad32) + tx + 16 * j] = p;
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
    load_tile_f32<D>(kv, v + kv_off, k0, kBK32, S);
    __syncthreads();

    // acc += P V over the tile's kBK32 rows, four at a time
    for (int j = 0; j < kBK32; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            ps + (ty * 4 + i) * (kBK32 + kPad32) + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = kv + (j + jj) * (D + kPad32);
        float vals[kCols];
#pragma unroll
        for (int gi = 0; gi < kGroups; ++gi) {
          const float* src = vrow + gi * 16 * kVec + tx * kVec;
          if constexpr (kVec == 4) {
            const float4 t4 = *reinterpret_cast<const float4*>(src);
            vals[gi * 4 + 0] = t4.x;
            vals[gi * 4 + 1] = t4.y;
            vals[gi * 4 + 2] = t4.z;
            vals[gi * 4 + 3] = t4.w;
          } else {
            const float2 t2 = *reinterpret_cast<const float2*>(src);
            vals[gi * 2 + 0] = t2.x;
            vals[gi * 2 + 1] = t2.y;
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
    float* orow = o + q_off + (long long)row * D;
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        orow[gi * 16 * kVec + tx * kVec + e] = acc[i][gi * kVec + e] * inv;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int Hq, int Hkv, int S, int causal, cudaStream_t stream) {
  const int smem = smem_f32_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel_f32<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ32 - 1) / kBQ32, B * Hq);
  flash_attention_kernel_f32<D><<<grid, kThreads32, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, Hq, Hkv,
      S, causal, (float)(1.0 / sqrt((double)D)));  // D**-0.5 rounded once
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int S, int causal, int dtype,
           cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, o, B, Hq, Hkv, S, causal, stream);
  if (dtype == 1)
    return launch_bf16<D>(q, k, v, o, B, Hq, Hkv, S, causal, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D in {32, 64, 128, 256}
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Hq,
                                      int Hkv, int S, int D, int causal,
                                      int dtype, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch<32>(q, k, v, o, B, Hq, Hkv, S, causal, dtype, st);
    case 64: return launch<64>(q, k, v, o, B, Hq, Hkv, S, causal, dtype, st);
    case 128: return launch<128>(q, k, v, o, B, Hq, Hkv, S, causal, dtype, st);
    case 256: return launch<256>(q, k, v, o, B, Hq, Hkv, S, causal, dtype, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dynamic shared memory a block of the kernel for (D, dtype) takes, in
// bytes; -1 for a (D, dtype) the launcher does not take
extern "C" int flash_attention_smem_bytes(int D, int dtype) {
  if (dtype != 0 && dtype != 1) return -1;
  switch (D) {
    case 32: return dtype ? smem_bf16_bytes<32>() : smem_f32_bytes<32>();
    case 64: return dtype ? smem_bf16_bytes<64>() : smem_f32_bytes<64>();
    case 128: return dtype ? smem_bf16_bytes<128>() : smem_f32_bytes<128>();
    case 256: return dtype ? smem_bf16_bytes<256>() : smem_f32_bytes<256>();
    default: return -1;
  }
}
