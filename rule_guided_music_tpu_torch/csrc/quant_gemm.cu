// Int8 serving GEMMs for Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel. It computes what XLA fuses around the JAX
// package's int8 `dot_general` in rule_guided_music_tpu/ops/quant.py:82-124
// (`quant_dense_apply`, w8a8, and `wo_dense_apply`, w8a16): the int8 weight
// is read as it is stored, and the dequantization (the per-channel scale,
// the per-token scale, the bias) is applied to the fp32 (w8a16) or int32
// (w8a8) accumulator in registers, so no unscaled product reaches device
// memory. Four kernels, launched by ops/quant.py:
//
// * w8a16, Y(M,N) = (X(M,K) . W_i8(N,K)^T) * scale(N) + bias(N), X in bf16
//   (`w8a16_tma_kernel`) or fp32 (`w8a16_fp32_tma_kernel`, the card-versus-
//   CPU checks and `--dtype float32`: X is split exactly into three bf16
//   parts, hi + mid + lo, each the top bits of what the parts before it
//   left, whose three products over the same weight fragment agree with the
//   fp32 product within a few fp32 ulps; each 64-k tile's three products
//   are summed apart and added to the running sum with one rounding).
// * `quantize_rows_kernel` (w8a8's prologue): per row of X, s = max(max|x|,
//   1e-8) / 127 and x_i8 = clip(rint(x / s), -127, 127), both divisions true
//   ones (__fdiv_rn), as JAX divides. A row is read from device memory once:
//   its threads (1-256, a power of two) keep their 16-byte pieces of it in
//   registers from the amax to the rounding, the row's warps exchanging
//   their partial amax through shared memory; a row too long for registers
//   (K > 16384) is read twice. `quant_route` picks threads a row, rows a
//   block and pieces a thread from K and M, so that the grid fills the SMs.
//   `rgm_w8a8_linear` launches it and the GEMM below from one host call.
// * `w8a8_tma_kernel`: Y = float(X_i8 . W_i8^T) * (s_x(M) * scale(N)) +
//   bias, on s8 x s8 -> s32 wgmma; the int32 sums are exact.
//
// Every epilogue multiplies and adds with __fmul_rn / __fadd_rn, in JAX's
// order, so no FMA contraction changes a rounding, then rounds once to the
// output type. w8a8's result is therefore the plain version's bit for bit;
// w8a16's differs from the plain fp32 product only in the order of the sums.
//
// What bounds them on the H100: the product's 2*M*N*K operations against
// the bytes of X, W and Y read or written once. At the DiT's widths that is
// about 470 operations a byte at 512 tokens and more above: over the ~295 at
// which bf16's tensor cores and not the memory set the floor, so w8a16 is
// bound by operations (989 TFLOP/s) there; w8a8 (1979 TOP/s, ridge ~590) is
// bound by bytes at 512 tokens and by operations at 8192. At a few rows,
// reading the int8 weight once is the floor of both. The quantization is a
// row reduction: its bytes (X read, x_i8 and s written) bound it.
//
// Design of the two TMA kernels (one body, `tma_gemm`). Both compute the
// transposed tile, Y^T = W . X^T, so that the output features are wgmma's M
// (64 a consumer warpgroup, 128 a block) and the tokens its N (BN = 128 or
// 256 a block), which suits the few tokens of a B=2 call:
//   - a block is one producer warpgroup and two consumer warpgroups
//     (setmaxnreg 40 / 232). One thread of the producer keeps a ring of 4-6
//     stages full with TMA copies (tensor maps encoded by the host, 128-byte
//     swizzle for what wgmma reads; rows past M and N and k past K arrive as
//     zeros), each stage's arrival counted on a full mbarrier;
//   - the consumers wait on the full barrier, issue the k-tile's wgmmas,
//     keep one group in flight (wait_group 1) and free the stage of the
//     group before on its empty barrier: no __syncthreads in the k-loop;
//   - w8a16: W's int8 tile (128 x 64 k, 64-byte swizzle) is wgmma's A from
//     registers: each thread reads its fragment's int8 pairs from shared
//     memory and converts them to bf16 in registers (exact: every int8 is a
//     bf16), two register sets in turn so that the next tile converts while
//     this one multiplies; X's bf16 tile is B (m64nBNk16);
//   - w8a8: W's and X's int8 tiles (128 k) are A and B from shared memory
//     (m64nBNk32 s8);
//   - where the output tiles are too few to fill the SMs, the k-tiles are
//     split across a thread-block cluster of 2-4 blocks: each sums its own
//     k range, the others leave their sums in their own shared memory, and
//     the leader adds them in rank order through distributed shared memory
//     (w8a8's int32 sums exactly) and alone runs the epilogue;
//   - the epilogue rescales in registers, stages the tile in shared memory
//     and writes whole 16-byte pieces of Y's rows.
// The route (BN, split) is one function of (M, N, K) and the SM count,
// `pick_route`, fitted to the card's times of every route.
// The fp32 route (`w8a16_fp32_tma_kernel`) has the same block, tile
// orientation, A from registers and k-split, with BN = 128 and two rings:
//   - one thread of the producer warpgroup keeps a 3-stage ring two tiles
//     ahead by TMA with X's fp32 tile (128 tokens x 64 k, unswizzled) and
//     W's int8 tile;
//   - the producer warpgroup's four warps split each X tile once into hi,
//     mid and lo bf16 tiles in the 128-byte swizzle (wgmma's B) of a
//     2-stage ring, fence them for wgmma's async proxy and signal;
//   - the consumers convert W once a tile in registers, as above, and issue
//     three wgmmas a k16 step that share that A (lo, then mid, then hi),
//     into a partial sum that the running sum takes with one rounding
//     (__fadd_rn) once the tile's group is done; the next tile's A
//     converts while this one multiplies. No __syncthreads in the k loop.
// K must be a multiple of 16 (the wrapper raises otherwise); M and N may be
// anything from 1.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libquant_gemm.so quant_gemm.cu
// (no -lcuda: cuTensorMapEncodeTiled is reached through the runtime's
// cudaGetDriverEntryPoint).

#include <cuda.h>   // CUtensorMap and its enums only: nothing of libcuda is linked
#include <cuda_bf16.h>

#include <initializer_list>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "flash_attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// the quantization: at most 8 pieces of 8 elements a thread in registers,
// at most 256 threads a row, blocks of at most 128 threads where a row
// takes fewer
constexpr int kQuantPieces = 8;
constexpr int kQuantMaxThreads = 256;
constexpr int kQuantBlock = 128;
constexpr int kQuantSpread = 512;      // threads an SM below which rows spread
// the TMA kernels: a producer and two consumer warpgroups; 128 output
// features a block, 64 a consumer
constexpr int kTmaThreads = 384;
constexpr int kTmaFeatures = 128;
constexpr int kMaxSplit = 4;                     // blocks of a k-split cluster

// A TMA kernel's shared memory: a ring of stages, each X's tile (BN tokens
// x 128 bytes, 128-byte swizzle) then W's (128 features x kK int8: 64 k in
// a 64-byte swizzle for w8a16, 128 k in the 128-byte one for w8a8), both on
// 1024 bytes; then the full and empty barriers.
template <bool I8, int BN>
struct TmaTile {
  static constexpr int kK = I8 ? 128 : 64;       // k a stage
  static constexpr int kXBytes = BN * 128;
  static constexpr int kWBytes = kTmaFeatures * kK;
  static constexpr int kStage = kXBytes + kWBytes;
  static constexpr int kStages = BN == 128 ? (I8 ? 5 : 6) : (I8 ? 4 : 5);
  static constexpr int kRing = kStages * kStage;
  static constexpr int kSmem = 1024 + kRing + 2 * kStages * 8;
  // the consumers' sums (a k-split's partials) and the output tile reuse
  // the ring
  static_assert(kRing >= 2 * 128 * (BN / 2) * 4, "the partial sums fit the ring");
  static_assert(kRing >= BN * (kTmaFeatures * 4 + 16), "the output tile fits the ring");
};

// The fp32 route's shared memory: a raw ring of kRawStages stages, each X's
// fp32 tile (128 tokens x 64 k, 256-byte rows, no swizzle) then W's int8
// tile (as w8a16's); a split ring of kSplitStages stages, each X's hi, mid
// and lo bf16 tiles (128 tokens x 128 bytes, 128-byte swizzle); then the
// raw ring's full and empty barriers and the split ring's.
struct F32Tile {
  static constexpr int kBN = 128;
  static constexpr int kK = 64;
  static constexpr int kXBytes = kBN * kK * 4;
  static constexpr int kWBytes = kTmaFeatures * kK;
  static constexpr int kRawStage = kXBytes + kWBytes;
  static constexpr int kRawStages = 3;
  static constexpr int kPartBytes = kBN * 128;
  static constexpr int kSplitStage = 3 * kPartBytes;
  static constexpr int kSplitStages = 2;
  static constexpr int kRing = kRawStages * kRawStage + kSplitStages * kSplitStage;
  static constexpr int kSmem = 1024 + kRing + 2 * (kRawStages + kSplitStages) * 8;
  static_assert(kSmem <= 232448, "the rings fit a block's shared memory");
  static_assert(kRing >= 2 * 128 * (kBN / 2) * 4, "the partial sums fit the ring");
  static_assert(kRing >= kBN * (kTmaFeatures * 4 + 16), "the output tile fits the ring");
};

// wgmma's descriptor of a K-major operand in 128-byte-swizzled shared
// memory: the start address, a leading byte offset of 1 (unused when
// swizzled), 1024 bytes from one 8-row group to the next, swizzle mode 1.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// keeps the compiler from moving the accumulators' uses across the wgmma
// fence and waits
template <int n>
__device__ __forceinline__ void fence_operands(float (&d)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int n>
__device__ __forceinline__ void fence_operands(int (&d)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most `PENDING` of this warpgroup's committed groups run
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(PENDING) : "memory");
}

// mbarriers in this block's shared memory (addresses from smem_addr)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n}\n" :: "r"(bar), "r"(parity) : "memory");
}

// One TMA copy of a 2-D box at (c0 inner, c1 rows) into shared memory,
// its bytes counted on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

// orders this thread's writes to shared memory before the reads of the
// async proxy (wgmma) that follow a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the two consumer warpgroups alone (named barrier 1)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// The cluster's barrier, split into its two halves; not .aligned, so that
// the producer and the consumers reach it from their own code.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// the address of this block's shared `addr` in the cluster's block `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void ld_cluster4(uint32_t addr, float (&v)[4]) {
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ld_cluster4(uint32_t addr, int (&v)[4]) {
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3]) : "r"(addr) : "memory");
}

// Two fp32 values -> their bf16x2 hi, mid and lo parts: hi the top 16
// bits of each (its bf16 truncation), mid those of the remainder hi leaves,
// lo those of the remainder mid leaves. The remainders are exact and the
// last has at most 8 significant bits, so hi + mid + lo is the value
// exactly (for any value above about 2^-100). Masks and byte moves, no
// conversion instruction.
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  constexpr uint32_t kTop = 0xffff0000u;
  const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
  hi = __byte_perm(ua, ub, 0x7632);
  const float ra = __fsub_rn(a, __uint_as_float(ua & kTop));
  const float rb = __fsub_rn(b, __uint_as_float(ub & kTop));
  const uint32_t va = __float_as_uint(ra), vb = __float_as_uint(rb);
  mid = __byte_perm(va, vb, 0x7632);
  lo = __byte_perm(__float_as_uint(__fsub_rn(ra, __uint_as_float(va & kTop))),
                   __float_as_uint(__fsub_rn(rb, __uint_as_float(vb & kTop))), 0x7632);
}

// d (64 x 128, this thread's 64) = A (64 x 16 bf16, this thread's four
// registers) * B (16 x 128 bf16, K-major in 128-byte-swizzled shared memory)
// + d where `accumulate`, + 0 where not.
__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[64], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint64_t b,
                                              int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}

// d (64 x 128) += A (64 x 32 s8) * B (32 x 128 s8), both K-major in
// 128-byte-swizzled shared memory; s32 sums (exact).
__device__ __forceinline__ void wgmma_ss_s8(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 256, this thread's 128) += A (64 x 16 bf16, this thread's four
// registers) * B (16 x 256 bf16, K-major in 128-byte-swizzled shared memory).
__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[128], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d (64 x 256) += A (64 x 32 s8) * B (32 x 256 s8), both K-major in
// 128-byte-swizzled shared memory; s32 sums (exact).
__device__ __forceinline__ void wgmma_ss_s8(int (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// Bytes 2h and 2h + 1 of an int8 word, given as u = word ^ 0x80808080 (each
// byte b + 128), -> bf16x2 (low half byte 2h), exactly: b + 128 becomes the
// low mantissa byte of 2^23, the float 2^23 + 128 + b, from which 2^23 + 128
// is subtracted; a float holding an integer of |b| <= 128 is a bf16, so its
// top 16 bits are b in bf16. sel0 = 0x7440 | 2h, sel1 = 0x7440 | (2h + 1).
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t u, uint32_t sel0,
                                                   uint32_t sel1) {
  constexpr float kMagic = 8388736.f;   // 2^23 + 128
  const float f0 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, sel0)), kMagic);
  const float f1 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, sel1)), kMagic);
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// This thread's A fragments of one 64-k tile of W (128 rows x 64 int8 in the
// 64-byte swizzle: 16-byte chunk c of row r at chunk c ^ ((r >> 1) & 3)), in
// bf16: for k16 step kk, a[4kk..4kk+3] hold rows r0 and r0 + 8 at k 16kk +
// 2t, +1 and at 16kk + 2t + 8, +9 (wgmma's A fragment, as mma.sync's),
// t = lane % 4. Two 4-byte loads a row and chunk; thread pairs t = 2j, 2j + 1
// read the same word and convert its two halves.
__device__ __forceinline__ void load_a_frags(const unsigned char* wt, int r0, int t,
                                             uint32_t (&a)[16]) {
  const uint32_t h = static_cast<uint32_t>(t & 1);
  const uint32_t sel0 = 0x7440u | (2 * h);
  const uint32_t sel1 = 0x7440u | (2 * h + 1);
  const int sw = (r0 >> 1) & 3;                  // the same for r0 + 8
  const unsigned char* p0 = wt + r0 * 64 + 4 * (t >> 1);
  const unsigned char* p1 = p0 + 8 * 64;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = (kk ^ sw) * 16;
    const uint32_t lo0 = *reinterpret_cast<const uint32_t*>(p0 + c) ^ 0x80808080u;
    const uint32_t lo1 = *reinterpret_cast<const uint32_t*>(p1 + c) ^ 0x80808080u;
    const uint32_t hi0 = *reinterpret_cast<const uint32_t*>(p0 + c + 8) ^ 0x80808080u;
    const uint32_t hi1 = *reinterpret_cast<const uint32_t*>(p1 + c + 8) ^ 0x80808080u;
    a[4 * kk + 0] = i8x2_to_bf16x2(lo0, sel0, sel1);
    a[4 * kk + 1] = i8x2_to_bf16x2(lo1, sel0, sel1);
    a[4 * kk + 2] = i8x2_to_bf16x2(hi0, sel0, sel1);
    a[4 * kk + 3] = i8x2_to_bf16x2(hi1, sel0, sel1);
  }
}

__device__ __forceinline__ void store_vec16(bf16* out, long long i, const unsigned char* src) {
  *reinterpret_cast<uint4*>(out + i) = *reinterpret_cast<const uint4*>(src);
}
__device__ __forceinline__ void store_vec16(float* out, long long i, const unsigned char* src) {
  *reinterpret_cast<uint4*>(out + i) = *reinterpret_cast<const uint4*>(src);
}
__device__ __forceinline__ void to_out(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void to_out(float* p, float v) { *p = v; }

// The end of a TMA kernel's consumers, once both warpgroups are done with
// the ring: a k-split's sums added in the leader, then the epilogue (see
// the file's head). Thread (g, w, gid, t) holds Y^T rows r0 and r0 + 8 of
// the block's 128 features f0.. and BN tokens m0.., as wgmma left them.
template <bool I8, int BN, typename TA, typename TO>
__device__ __forceinline__ void tma_finish(TA (&acc)[BN / 2], unsigned char* ring,
                                           uint32_t ring_addr, int f0, int m0, int r0,
                                           int t, const float* __restrict__ sx,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias,
                                           TO* __restrict__ out, int M, int N) {
  constexpr int kAcc = BN / 2;
  const int split = static_cast<int>(gridDim.z);
  const int ct = threadIdx.x - 128;              // 0..255
  if (split > 1) {
    // a k-split: the others leave their sums in their own ring, in float4
    // (int4) slots q of 256 threads; the leader adds them in rank order
    const uint32_t rank = cluster_rank();
    if (rank != 0) {
      using V4 = std::conditional_t<I8, int4, float4>;
#pragma unroll
      for (int q = 0; q < kAcc / 4; ++q) {
        V4 v;
        v.x = acc[4 * q];
        v.y = acc[4 * q + 1];
        v.z = acc[4 * q + 2];
        v.w = acc[4 * q + 3];
        *reinterpret_cast<V4*>(ring + (q * 256 + ct) * 16) = v;
      }
    }
    cluster_sync();
    if (rank == 0) {
#pragma unroll 1
      for (int r = 1; r < split; ++r) {
        const uint32_t theirs = map_rank(ring_addr, static_cast<uint32_t>(r));
#pragma unroll
        for (int q = 0; q < kAcc / 4; ++q) {
          TA v[4];
          ld_cluster4(theirs + static_cast<uint32_t>((q * 256 + ct) * 16), v);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * q + e] += v[e];
        }
      }
    }
    cluster_sync();   // the others' sums stay until the leader has read them
    if (rank != 0) return;
  }

  // the epilogue: thread (g, w, gid, t) holds Y^T rows (features) r0 and
  // r0 + 8 (h) at columns (tokens) 8j + 2t + e: acc[4j + 2h + e]. w8a16:
  // acc * scale + bias; w8a8: acc * (s_x * scale) + bias; one rounding to TO
  // into a [BN tokens][128 features] tile in the ring, then rows out.
  constexpr int kPitch = kTmaFeatures * static_cast<int>(sizeof(TO)) + 16;
  float sc[2], bi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = f0 + r0 + 8 * h;
    sc[h] = f < N ? scale[f] : 0.f;
    bi[h] = bias != nullptr && f < N ? bias[f] : 0.f;
  }
#pragma unroll
  for (int jj = 0; jj < BN / 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * jj + 2 * t + e;          // the token in the tile
      float srow = 1.f;
      if constexpr (I8) srow = m0 + c < M ? sx[m0 + c] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const TA v = acc[4 * jj + 2 * h + e];
        float y;
        if constexpr (I8) {
          y = __fmul_rn(__int2float_rn(v), __fmul_rn(srow, sc[h]));
        } else {
          y = __fmul_rn(v, sc[h]);
        }
        if (bias != nullptr) y = __fadd_rn(y, bi[h]);
        to_out(reinterpret_cast<TO*>(ring + c * kPitch) + r0 + 8 * h, y);
      }
    }
  }
  consumer_sync();
  // rows of 128 features: 16-byte pieces, consecutive threads on consecutive
  // pieces of a row; element by element at N's edge or where N's rows do
  // not start on 16 bytes
  constexpr int kPer = 16 / static_cast<int>(sizeof(TO));   // elements a piece
  constexpr int kPieces = kTmaFeatures / kPer;                // pieces a row
  const bool vec = (static_cast<long long>(N) * sizeof(TO)) % 16 == 0;
  const int piece = ct % kPieces;
  const int f = f0 + piece * kPer;
#pragma unroll 1
  for (int c = ct / kPieces; c < BN && m0 + c < M; c += 256 / kPieces) {
    if (f >= N) break;
    const unsigned char* src = ring + c * kPitch + piece * 16;
    const long long i = static_cast<long long>(m0 + c) * N + f;
    if (vec && f + kPer <= N) {
      store_vec16(out, i, src);
    } else {
      for (int e = 0; e < kPer && f + e < N; ++e) {
        out[i + e] = reinterpret_cast<const TO*>(src)[e];
      }
    }
  }
}

// The body of both TMA kernels (see the file's head): this block's 128
// output features from blockIdx.x, BN tokens from blockIdx.y, and its share
// of the k-tiles from blockIdx.z of gridDim.z, the cluster's size.
template <bool I8, int BN, typename TO>
__device__ __forceinline__ void tma_gemm(const CUtensorMap& xmap, const CUtensorMap& wmap,
                                         const float* __restrict__ sx,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ bias,
                                         TO* __restrict__ out, int M, int N, int K) {
  using Tile = TmaTile<I8, BN>;
  using TA = std::conditional_t<I8, int, float>;
  constexpr int S = Tile::kStages;
  constexpr int kAcc = BN / 2;                   // accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  // the swizzles' 8-row groups start on 1024 bytes
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ring_addr = smem_addr(ring);
  const uint32_t full = ring_addr + Tile::kRing;   // S full barriers, then S empty
  const uint32_t empty = full + 8 * S;

  const int f0 = blockIdx.x * kTmaFeatures;
  const int m0 = blockIdx.y * BN;
  const int split = static_cast<int>(gridDim.z);
  const int k_tiles = (K + Tile::kK - 1) / Tile::kK;
  const int kb = static_cast<int>(blockIdx.z) * k_tiles / split;
  const int n_tiles = (static_cast<int>(blockIdx.z) + 1) * k_tiles / split - kb;
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
#pragma unroll 1
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);               // the consumers' 8 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: one thread keeps the ring full
    regs_dec<40>();
    if (threadIdx.x == 0) {
      tma_prefetch(&xmap);
      tma_prefetch(&wmap);
#pragma unroll 1
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % S;
        if (j >= S) mbar_wait(empty + 8 * s, ((j / S) - 1) & 1);
        const uint32_t bar = full + 8 * s;
        const uint32_t st = ring_addr + s * Tile::kStage;
        const int k0 = (kb + j) * Tile::kK;
        mbar_expect_tx(bar, Tile::kStage);
        tma_load_2d(st, &xmap, bar, k0, m0);
        tma_load_2d(st + Tile::kXBytes, &wmap, bar, k0, f0);
      }
    }
    __syncwarp();
    if (split > 1) {   // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // the consumers: warpgroup g takes features 64g..64g+63 of the block's 128
  regs_inc<232>();
  const int g = wg - 1;
  const int w = (threadIdx.x >> 5) & 3;
  const int gid = lane >> 2;
  const int t = lane & 3;
  const int r0 = 64 * g + 16 * w + gid;          // this thread's rows r0, r0 + 8
  TA acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0;

  // k-tile j: wait for its stage, multiply, keep this group in flight and
  // free the stage of the group before
  auto finish = [&](int j) {
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(acc);
    if (j > 0 && lane == 0) mbar_arrive(empty + 8 * ((j - 1) % S));
  };
  if constexpr (I8) {
#pragma unroll 1
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % S;
      mbar_wait(full + 8 * s, (j / S) & 1);
      const unsigned char* st = ring + s * Tile::kStage;
      wgmma_fence();
      fence_operands(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {   // k32 steps: 32 bytes along the rows
        wgmma_ss_s8(acc, sw128_desc(st + Tile::kXBytes + 64 * g * 128 + kk * 32),
                    sw128_desc(st + kk * 32));
      }
      finish(j);
    }
  } else {
    // two register sets of A in turn: tile j + 1 converts while tile j's
    // wgmmas read theirs
    uint32_t a0[16], a1[16];
    auto step = [&](uint32_t (&a)[16], int j) {
      const int s = j % S;
      mbar_wait(full + 8 * s, (j / S) & 1);
      const unsigned char* st = ring + s * Tile::kStage;
      load_a_frags(st + Tile::kXBytes, r0, t, a);
      wgmma_fence();
      fence_operands(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {   // k16 steps: 32 bytes along X's rows
        wgmma_rs_bf16(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                      sw128_desc(st + kk * 32));
      }
      finish(j);
    };
    int j = 0;
#pragma unroll 1
    for (; j + 1 < n_tiles; j += 2) {
      step(a0, j);
      step(a1, j + 1);
    }
    if (j < n_tiles) step(a0, j);
  }
  wgmma_wait<0>();
  fence_operands(acc);
  consumer_sync();   // both warpgroups are done with the ring

  tma_finish<I8, BN>(acc, ring, ring_addr, f0, m0, r0, t, sx, scale, bias, out, M, N);
}

// w8a16 in bf16: Y = (X . W_i8^T) * scale + bias. xmap: X (M, K) bf16, box
// 64 k x BN rows, 128-byte swizzle; wmap: W (N, K) int8, box 64 x 128,
// 64-byte swizzle.
template <int BN>
__global__ void __launch_bounds__(kTmaThreads, 1)
w8a16_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 bf16* __restrict__ out, int M, int N, int K) {
  tma_gemm<false, BN, bf16>(xmap, wmap, nullptr, scale, bias, out, M, N, K);
}

// w8a8: Y = float(X_i8 . W_i8^T) * (s_x * scale) + bias. xmap: X_i8 (M, K),
// box 128 x BN; wmap: W (N, K), box 128 x 128; both 128-byte swizzle.
template <int BN, typename TO>
__global__ void __launch_bounds__(kTmaThreads, 1)
w8a8_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap, const float* __restrict__ sx,
                const float* __restrict__ scale, const float* __restrict__ bias,
                TO* __restrict__ out, int M, int N, int K) {
  tma_gemm<true, BN, TO>(xmap, wmap, sx, scale, bias, out, M, N, K);
}

// w8a16 in fp32 (see the file's head): Y = (X . W_i8^T) * scale + bias with
// X split into three bf16 tiles once a stage. xmap: X (M, K) fp32, box 64 k
// x 128 rows, no swizzle; wmap: W (N, K) int8, box 64 x 128, 64-byte
// swizzle (w8a16's). Blocks as the TMA kernels': 128 features from
// blockIdx.x, 128 tokens from blockIdx.y, a k-split over blockIdx.z.
__global__ void __launch_bounds__(kTmaThreads, 1)
w8a16_fp32_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      float* __restrict__ out, int M, int N, int K) {
  using Tile = F32Tile;
  constexpr int R = Tile::kRawStages;
  constexpr int S = Tile::kSplitStages;
  constexpr int kSplitters = 4;                  // the producer warpgroup's warps
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ring_addr = smem_addr(ring);
  unsigned char* split_ring = ring + R * Tile::kRawStage;
  // the raw ring's full (TMA bytes) and empty (the splitters and the
  // consumers' warps) barriers, then the split ring's full (the splitters)
  // and empty (the consumers' warps)
  const uint32_t raw_full = ring_addr + Tile::kRing;
  const uint32_t raw_empty = raw_full + 8 * R;
  const uint32_t split_full = raw_empty + 8 * R;
  const uint32_t split_empty = split_full + 8 * S;

  const int f0 = blockIdx.x * kTmaFeatures;
  const int m0 = blockIdx.y * Tile::kBN;
  const int split = static_cast<int>(gridDim.z);
  const int k_tiles = (K + Tile::kK - 1) / Tile::kK;
  const int kb = static_cast<int>(blockIdx.z) * k_tiles / split;
  const int n_tiles = (static_cast<int>(blockIdx.z) + 1) * k_tiles / split - kb;
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
#pragma unroll 1
    for (int s = 0; s < R; ++s) {
      mbar_init(raw_full + 8 * s, 1);
      mbar_init(raw_empty + 8 * s, kSplitters + 8);
    }
#pragma unroll 1
    for (int s = 0; s < S; ++s) {
      mbar_init(split_full + 8 * s, kSplitters);
      mbar_init(split_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer warpgroup: its thread 0 keeps the raw ring R - 1 tiles
    // ahead by TMA; all four warps split X. Thread i takes 4 k (piece i %
    // 16) of rows i / 16 + 8n: 16 bytes of the raw tile, 8 of each bf16
    // tile, at a swizzle that is the same for all its rows; consecutive
    // threads read and write consecutive bytes, meeting no bank twice.
    regs_dec<56>();
    auto issue = [&](int j) {
      const int s = j % R;
      if (j >= R) mbar_wait(raw_empty + 8 * s, ((j / R) - 1) & 1);
      const uint32_t bar = raw_full + 8 * s;
      const uint32_t st = ring_addr + s * Tile::kRawStage;
      const int k0 = (kb + j) * Tile::kK;
      mbar_expect_tx(bar, Tile::kRawStage);
      tma_load_2d(st, &xmap, bar, k0, m0);
      tma_load_2d(st + Tile::kXBytes, &wmap, bar, k0, f0);
    };
    const int piece = threadIdx.x & 15;
    const int row0 = threadIdx.x >> 4;           // 0-7: the row's swizzle
    const int sw = (((piece >> 1) ^ row0) << 4) + ((piece & 1) << 3);
    if (threadIdx.x == 0) {
      tma_prefetch(&xmap);
      tma_prefetch(&wmap);
      for (int j = 0; j < R - 1 && j < n_tiles; ++j) issue(j);
    }
#pragma unroll 1
    for (int j = 0; j < n_tiles; ++j) {
      if (threadIdx.x == 0 && j + R - 1 < n_tiles) issue(j + R - 1);
      const int rs = j % R;
      const int ss = j % S;
      mbar_wait(raw_full + 8 * rs, (j / R) & 1);
      if (j >= S) mbar_wait(split_empty + 8 * ss, ((j / S) - 1) & 1);
      const unsigned char* raw = ring + rs * Tile::kRawStage + row0 * 256 + piece * 16;
      unsigned char* parts = split_ring + ss * Tile::kSplitStage + row0 * 128 + sw;
#pragma unroll 4
      for (int n = 0; n < Tile::kBN / 8; ++n) {
        const float4 v = *reinterpret_cast<const float4*>(raw + n * 8 * 256);
        uint32_t hi0, mid0, lo0, hi1, mid1, lo1;
        split3(v.x, v.y, hi0, mid0, lo0);
        split3(v.z, v.w, hi1, mid1, lo1);
        unsigned char* dst = parts + n * 8 * 128;
        *reinterpret_cast<uint2*>(dst) = make_uint2(hi0, hi1);
        *reinterpret_cast<uint2*>(dst + Tile::kPartBytes) = make_uint2(mid0, mid1);
        *reinterpret_cast<uint2*>(dst + 2 * Tile::kPartBytes) = make_uint2(lo0, lo1);
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(split_full + 8 * ss);
        mbar_arrive(raw_empty + 8 * rs);
      }
    }
    if (split > 1) {   // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // the consumers: warpgroup g takes features 64g..64g+63 of the block's 128
  regs_inc<224>();
  const int g = wg - 1;
  const int w = (threadIdx.x >> 5) & 3;
  const int gid = lane >> 2;
  const int t = lane & 3;
  const int r0 = 64 * g + 16 * w + gid;          // this thread's rows r0, r0 + 8
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // tile j's A from W's int8 tile, then the raw stage is free of this warp
  auto convert = [&](uint32_t (&a)[16], int j) {
    const int rs = j % R;
    mbar_wait(raw_full + 8 * rs, (j / R) & 1);
    load_a_frags(ring + rs * Tile::kRawStage + Tile::kXBytes, r0, t, a);
    __syncwarp();
    if (lane == 0) mbar_arrive(raw_empty + 8 * rs);
  };
  // tile j: its twelve wgmmas (lo, mid, hi, four k16 steps each) into
  // `part`; tile j + 1's A converts while they run; then one rounding into
  // the running sum, and the split stage is free
  auto step = [&](uint32_t (&a)[16], uint32_t (&next)[16], int j) {
    const int ss = j % S;
    mbar_wait(split_full + 8 * ss, (j / S) & 1);
    const unsigned char* parts = split_ring + ss * Tile::kSplitStage;
    wgmma_fence();
    fence_operands(part);
#pragma unroll
    for (int p = 2; p >= 0; --p) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {   // k16 steps: 32 bytes along the rows
        wgmma_rs_bf16(part, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                      sw128_desc(parts + p * Tile::kPartBytes + kk * 32),
                      p != 2 || kk != 0);
      }
    }
    wgmma_commit();
    if (j + 1 < n_tiles) convert(next, j + 1);
    wgmma_wait<0>();
    fence_operands(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    if (lane == 0) mbar_arrive(split_empty + 8 * ss);
  };
  uint32_t a0[16], a1[16];
  convert(a0, 0);
  int j = 0;
#pragma unroll 1
  for (; j + 1 < n_tiles; j += 2) {
    step(a0, a1, j);
    step(a1, a0, j + 1);
  }
  if (j < n_tiles) step(a0, a1, j);
  consumer_sync();   // both warpgroups are done with the rings
  tma_finish<false, Tile::kBN>(acc, ring, ring_addr, f0, m0, r0, t, nullptr, scale, bias,
                               out, M, N);
}

// A 16-byte piece of a row: 8 bf16, or 8 fp32 (two 16-byte loads).
template <typename TX>
struct Piece;
template <>
struct Piece<bf16> {
  uint4 u;
  __device__ __forceinline__ void load(const bf16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void get(float (&v)[8]) const {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[e]);
      v[2 * e] = __low2float(h);
      v[2 * e + 1] = __high2float(h);
    }
  }
};
template <>
struct Piece<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void get(float (&v)[8]) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};

template <typename TX>
__device__ __forceinline__ float piece_amax(const Piece<TX>& p, float amax) {
  float v[8];
  p.get(v);
#pragma unroll
  for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
  return amax;
}

// clip(rint(x / s), -127, 127) of a piece's 8 values, as 8 bytes
template <typename TX>
__device__ __forceinline__ uint2 piece_round(const Piece<TX>& p, float s) {
  float v[8];
  p.get(v);
  uint32_t packed[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float r = fminf(fmaxf(rintf(__fdiv_rn(v[e], s)), -127.f), 127.f);
    packed[e >> 2] |= (static_cast<uint32_t>(static_cast<int>(r)) & 0xffu) << (8 * (e & 3));
  }
  return make_uint2(packed[0], packed[1]);
}

// The per-token quantization (see the file's head): `threads` threads a row
// (a power of two, at most kQuantMaxThreads), blockDim.x / threads rows a
// block. PIECES > 0: each thread keeps pieces t, t + threads, ... of its
// row (at most PIECES) in registers from the amax to the rounding, so the
// row is read once; PIECES == 0: the row is read twice. The row's largest
// |x| is exact whatever the order of the fmaxf.
template <typename TX, int PIECES>
__global__ void __launch_bounds__(kQuantMaxThreads)
quantize_rows_kernel(const TX* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ sx, int M, int K, int threads) {
  __shared__ float warp_amax[kQuantMaxThreads / 32];   // a row's warps' partial amax
  const int t = threadIdx.x & (threads - 1);
  const int row = blockIdx.x * (blockDim.x / threads) + threadIdx.x / threads;
  const bool live = row < M;   // every thread reaches the shuffles and the barrier
  const int pieces = K / 8;
  const TX* xr = x + static_cast<long long>(live ? row : 0) * K;

  float amax = 0.f;
  Piece<TX> held[PIECES > 0 ? PIECES : 1];
  if constexpr (PIECES > 0) {
    // every load issued before the first is used
#pragma unroll
    for (int i = 0; i < PIECES; ++i) {
      if (live && t + i * threads < pieces) held[i].load(xr + 8 * (t + i * threads));
    }
#pragma unroll
    for (int i = 0; i < PIECES; ++i) {
      if (live && t + i * threads < pieces) amax = piece_amax(held[i], amax);
    }
  } else {
    for (int c = t; live && c < pieces; c += threads) {
      Piece<TX> p;
      p.load(xr + 8 * c);
      amax = piece_amax(p, amax);
    }
  }
  // the row's threads: lanes by shuffles, then its warps through shared memory
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (o < threads) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  }
  if (threads > 32) {
    if ((threadIdx.x & 31) == 0) warp_amax[threadIdx.x >> 5] = amax;
    __syncthreads();
    const int first = (threadIdx.x / threads) * (threads >> 5);
    for (int i = 0; i < (threads >> 5); ++i) amax = fmaxf(amax, warp_amax[first + i]);
  }
  if (!live) return;
  const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
  int8_t* qr = q + static_cast<long long>(row) * K;
  if constexpr (PIECES > 0) {
#pragma unroll
    for (int i = 0; i < PIECES; ++i) {
      const int c = t + i * threads;
      if (c < pieces) *reinterpret_cast<uint2*>(qr + 8 * c) = piece_round(held[i], s);
    }
  } else {
    for (int c = t; c < pieces; c += threads) {
      Piece<TX> p;
      p.load(xr + 8 * c);
      *reinterpret_cast<uint2*>(qr + 8 * c) = piece_round(p, s);
    }
  }
  if (t == 0) sx[row] = s;
}

// The quantization's route: threads a row, rows a block, pieces a thread
// (0: the row read twice). The fewest threads a row whose pieces fit in
// registers (kQuantPieces of bf16, half as many of fp32: one warp a row at
// K = 1152, four at 4608 in bf16); then, where the rows are few, more
// threads a row, while the whole stays under kQuantSpread threads an SM
// and each thread keeps two pieces or more, so that each thread's chain of
// divisions is short; a row of kQuantMaxThreads read twice past the
// registers (K > 16384 in bf16). kQuantBlock threads a block, fewer rows a
// block (not below a warp) while the blocks are fewer than the SMs.
struct QuantRoute {
  int threads, rows, pieces;
};

QuantRoute quant_route(int M, int K, int elem_bytes, int sms) {
  const int cap = elem_bytes == 2 ? kQuantPieces : kQuantPieces / 2;
  const int pieces = K / 8;
  int threads = 1;
  while (threads < kQuantMaxThreads && (pieces + threads - 1) / threads > cap) threads *= 2;
  while (threads < kQuantMaxThreads && pieces >= 4 * threads &&
         static_cast<long long>(M) * threads < static_cast<long long>(kQuantSpread) * sms) {
    threads *= 2;
  }
  int held = (pieces + threads - 1) / threads;
  if (held > cap) held = 0;
  int rows = threads < kQuantBlock ? kQuantBlock / threads : 1;
  while (rows > 1 && rows * threads > 32 && (M + rows - 1) / rows < sms) rows /= 2;
  return QuantRoute{threads, rows, held};
}

template <typename TX, int PIECES = kQuantPieces>
cudaError_t launch_quantize(const TX* x, int8_t* q, float* sx, int M, int K,
                            const QuantRoute& r, cudaStream_t stream) {
  if constexpr (PIECES > 0) {
    if (r.pieces != PIECES) return launch_quantize<TX, PIECES - 1>(x, q, sx, M, K, r, stream);
  }
  const dim3 grid((M + r.rows - 1) / r.rows);
  quantize_rows_kernel<TX, PIECES><<<grid, r.rows * r.threads, 0, stream>>>(
      x, q, sx, M, K, r.threads);
  return cudaGetLastError();
}

// The TMA kernels' route: BN tokens a block (128 or 256; the fp32 route
// 128 alone) and the blocks of a k-split cluster (1 to kMaxSplit), chosen
// by an estimate of each route's time: its waves of blocks (a cluster's
// blocks share a wave) times one block's time, fitted to the H100's times
// of every route at XL_8's linears at 1-8192 tokens (`tools/kernel_ab.py
// --only quant --routes`): a fixed part (the ring's fill, the epilogue),
// its k-tiles, and for a split the leader's reads of each other block's
// sums. A split pays only where a
// block's k loop is long and the tiles are few (the B=2 trunk's fc2, calls
// of a few rows). w8a16 in bf16 also caps a block's k-tiles at
// kMaxSerialTiles: the tensor cores' fp32 sums drift from an fp32 GEMM's
// with the length of the chain (at K = 4608 one block unsplit differed from
// the plain version in 0.087-0.114% of bf16 outputs, two blocks in
// 0.050-0.071%, against the check's 0.1%); the fp32 route's running sum
// takes each 64-k tile with one rounding, as an fp32 GEMM's chain, and
// needs no cap. A persistent grid (a block an SM walking the tiles, its
// producer loading the next tile while the consumers write one out) was
// timed against these routes: 1% ahead at one shape, behind at every
// other (w8a8 by up to a half); PERF.md keeps the figures.
struct Route {
  int bn, split;
};
Route g_forced{0, 0};   // rgm_quant_gemm_force_route

// the GEMMs: w8a16 with bf16 X, w8a8, w8a16 with fp32 X
enum class Gemm { kW8A16, kW8A8, kF32 };

struct RouteCost {
  double fixed, tile128, tile256, reduce128, reduce256;   // microseconds
};
constexpr RouteCost kW8A16Cost{4.5, 0.37, 0.63, 2.5, 4.0};   // 64-k tiles
constexpr RouteCost kW8A8Cost{4.0, 0.29, 0.72, 2.5, 4.0};    // 128-k tiles
constexpr RouteCost kF32Cost{7.0, 1.58, 0.0, 1.0, 0.0};      // 64-k tiles, BN 128
constexpr int kMaxSerialTiles = 36;                           // w8a16: 2304 k

Route pick_route(int M, int N, int K, Gemm gemm, int sms) {
  const bool i8 = gemm == Gemm::kW8A8;
  const RouteCost& c = i8 ? kW8A8Cost : gemm == Gemm::kF32 ? kF32Cost : kW8A16Cost;
  const int kk = i8 ? 128 : 64;
  const int k_tiles = (K + kk - 1) / kk;
  Route best{128, 1};
  double best_cost = 1e30;
  for (int bn : {128, 256}) {
    if (bn == 256 && (M <= 128 || gemm == Gemm::kF32)) continue;
    const long long tiles = static_cast<long long>((N + kTmaFeatures - 1) / kTmaFeatures) *
                            ((M + bn - 1) / bn);
    const double tile = bn == 128 ? c.tile128 : c.tile256;
    const double reduce = bn == 128 ? c.reduce128 : c.reduce256;
    for (int s = 1; s <= kMaxSplit && s <= k_tiles; ++s) {
      const int per_block = (k_tiles + s - 1) / s;
      if (gemm == Gemm::kW8A16 && per_block > kMaxSerialTiles && s < kMaxSplit &&
          s < k_tiles) {
        continue;
      }
      const long long slots = sms > s ? sms / s * s : s;
      const long long waves = (tiles * s + slots - 1) / slots;
      const double cost = waves * (c.fixed + per_block * tile + (s - 1) * reduce);
      if (cost < best_cost) {
        best_cost = cost;
        best = Route{bn, s};
      }
    }
  }
  return best;
}

Route route_for(int M, int N, int K, Gemm gemm) {
  const int kk = gemm == Gemm::kW8A8 ? 128 : 64;
  const int k_tiles = (K + kk - 1) / kk;
  Route r = pick_route(M, N, K, gemm, sm_count());
  if (g_forced.bn && gemm != Gemm::kF32) r.bn = g_forced.bn;
  if (g_forced.split) r.split = g_forced.split;
  if (r.split > k_tiles) r.split = k_tiles;
  return r;
}

// cuTensorMapEncodeTiled, looked up in libcuda through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 2-D map of a row-major (rows, inner) matrix of `row_bytes` a row, box
// (box_inner, box_rows); out-of-bounds elements arrive as zeros.
cudaError_t encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                      int inner, int rows, long long row_bytes, int box_inner,
                      int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The operands' maps. A map holds only its base, its dims and its box, so
// one encoded for a key stays right for whatever tensor later lies there:
// each is encoded once per (pointer, rows, K, kind, box rows) and kept (a
// weight's for the run; an activation's while the allocator hands its
// buffer out again, as it does call after call), at most kMaxMaps at a time.
enum class MapKind { kW16, kW8, kX16, kX8, kX32 };   // w8a16's / w8a8's weight, input
constexpr size_t kMaxMaps = 4096;

cudaError_t tensor_map(const void* base, int rows, int K, MapKind kind, int box_rows,
                       CUtensorMap* out) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int, int>, CUtensorMap> cache;
  const auto key = std::make_tuple(base, rows, K, static_cast<int>(kind), box_rows);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  cudaError_t err;
  switch (kind) {
    case MapKind::kW16:   // 64 k a row of the box, 64-byte swizzle (read by ld.shared)
      err = encode_2d(out, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, K, rows, K, 64, box_rows,
                      CU_TENSOR_MAP_SWIZZLE_64B);
      break;
    case MapKind::kX16:
      err = encode_2d(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, K, rows, 2LL * K, 64,
                      box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
      break;
    case MapKind::kX32:   // 64 k (256 bytes) a row of the box, read by ld.shared
      err = encode_2d(out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, K, rows, 4LL * K, 64,
                      box_rows, CU_TENSOR_MAP_SWIZZLE_NONE);
      break;
    default:              // w8a8's weight and input: 128 k a row of the box
      err = encode_2d(out, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, K, rows, K, 128, box_rows,
                      CU_TENSOR_MAP_SWIZZLE_128B);
      break;
  }
  if (err != cudaSuccess) return err;
  if (cache.size() >= kMaxMaps) cache.clear();
  cache.emplace(key, *out);
  return cudaSuccess;
}

template <typename Kernel, typename... Args>
cudaError_t launch_tma(Kernel kernel, int smem, int* done, int M, int N, int bn, int split,
                       cudaStream_t stream, Args... args) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    done[dev] = 1;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = static_cast<unsigned>(split);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kTmaFeatures - 1) / kTmaFeatures, (M + bn - 1) / bn,
                     static_cast<unsigned>(split));
  cfg.blockDim = dim3(kTmaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t launch_w8a16_bf16(const void* x, const void* w, const float* scale,
                              const float* bias, bf16* out, int M, int N, int K,
                              cudaStream_t stream) {
  const Route r = route_for(M, N, K, Gemm::kW8A16);
  CUtensorMap xmap, wmap;
  cudaError_t err = tensor_map(w, N, K, MapKind::kW16, kTmaFeatures, &wmap);
  if (err != cudaSuccess) return err;
  err = tensor_map(x, M, K, MapKind::kX16, r.bn, &xmap);
  if (err != cudaSuccess) return err;
  static int done128[kMaxDevices], done256[kMaxDevices];
  if (r.bn == 256) {
    return launch_tma(w8a16_tma_kernel<256>, TmaTile<false, 256>::kSmem, done256, M, N, 256,
                      r.split, stream, xmap, wmap, scale, bias, out, M, N, K);
  }
  return launch_tma(w8a16_tma_kernel<128>, TmaTile<false, 128>::kSmem, done128, M, N, 128,
                    r.split, stream, xmap, wmap, scale, bias, out, M, N, K);
}

template <typename TO>
cudaError_t launch_w8a8(const void* q, const void* w, const float* sx, const float* scale,
                        const float* bias, TO* out, int M, int N, int K,
                        cudaStream_t stream) {
  const Route r = route_for(M, N, K, Gemm::kW8A8);
  CUtensorMap xmap, wmap;
  cudaError_t err = tensor_map(w, N, K, MapKind::kW8, kTmaFeatures, &wmap);
  if (err != cudaSuccess) return err;
  err = tensor_map(q, M, K, MapKind::kX8, r.bn, &xmap);
  if (err != cudaSuccess) return err;
  static int done128[kMaxDevices], done256[kMaxDevices];
  if (r.bn == 256) {
    return launch_tma(w8a8_tma_kernel<256, TO>, TmaTile<true, 256>::kSmem, done256, M, N,
                      256, r.split, stream, xmap, wmap, sx, scale, bias, out, M, N, K);
  }
  return launch_tma(w8a8_tma_kernel<128, TO>, TmaTile<true, 128>::kSmem, done128, M, N, 128,
                    r.split, stream, xmap, wmap, sx, scale, bias, out, M, N, K);
}

cudaError_t launch_w8a16_fp32(const void* x, const void* w, const float* scale,
                              const float* bias, float* out, int M, int N, int K,
                              cudaStream_t stream) {
  const Route r = route_for(M, N, K, Gemm::kF32);
  CUtensorMap xmap, wmap;
  cudaError_t err = tensor_map(w, N, K, MapKind::kW16, kTmaFeatures, &wmap);
  if (err != cudaSuccess) return err;
  err = tensor_map(x, M, K, MapKind::kX32, F32Tile::kBN, &xmap);
  if (err != cudaSuccess) return err;
  static int done[kMaxDevices];
  return launch_tma(w8a16_fp32_tma_kernel, F32Tile::kSmem, done, M, N, F32Tile::kBN,
                    r.split, stream, xmap, wmap, scale, bias, out, M, N, K);
}

template <typename TX>
cudaError_t quantize(const void* x, void* q, void* sx, int M, int K, cudaStream_t stream) {
  return launch_quantize(static_cast<const TX*>(x), static_cast<int8_t*>(q),
                         static_cast<float*>(sx), M, K,
                         quant_route(M, K, sizeof(TX), sm_count()), stream);
}

// every operand's rows start on 16 bytes when K is a multiple of 16
bool valid_shape(int M, int N, int K, std::initializer_list<const void*> ptrs) {
  if (M < 1 || N < 1 || K < 16 || K % 16 != 0) return false;
  for (const void* p : ptrs) {
    if (!aligned16(p)) return false;
  }
  return true;
}

}  // namespace

// dtype codes: 0 bfloat16, 1 float32.

// Y (M, N) of x's dtype = (x (M, K) . w (N, K) int8 ^T) * scale (N) +
// bias (N, or null); scale and bias fp32; every tensor contiguous. Returns
// a cudaError_t.
extern "C" int rgm_w8a16_gemm(const void* x, const void* w, const void* scale,
                              const void* bias, void* out, int M, int N, int K,
                              int dtype, void* stream) {
  if (!valid_shape(M, N, K, {x, w, out})) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  switch (dtype) {
    case 0: return static_cast<int>(launch_w8a16_bf16(x, w, sc, b, static_cast<bf16*>(out), M, N, K, s));
    case 1: return static_cast<int>(launch_w8a16_fp32(x, w, sc, b, static_cast<float*>(out), M, N, K, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q (M, K) int8 and sx (M) fp32 from x (M, K) of `dtype`, contiguous.
extern "C" int rgm_quantize_rows(const void* x, void* q, void* sx, int M, int K,
                                 int dtype, void* stream) {
  if (!valid_shape(M, 1, K, {x, q})) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(quantize<bf16>(x, q, sx, M, K, s));
    case 1: return static_cast<int>(quantize<float>(x, q, sx, M, K, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Y (M, N) of `out_dtype` = float(q (M, K) . w (N, K) ^T) * (sx (M) *
// scale (N)) + bias (N, or null); every tensor contiguous.
extern "C" int rgm_w8a8_gemm(const void* q, const void* w, const void* sx,
                             const void* scale, const void* bias, void* out,
                             int M, int N, int K, int out_dtype, void* stream) {
  if (!valid_shape(M, N, K, {q, w, out})) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sxf = static_cast<const float*>(sx);
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  switch (out_dtype) {
    case 0: return static_cast<int>(launch_w8a8(q, w, sxf, sc, b, static_cast<bf16*>(out), M, N, K, s));
    case 1: return static_cast<int>(launch_w8a8(q, w, sxf, sc, b, static_cast<float*>(out), M, N, K, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// A whole w8a8 linear from one host call: x (M, K) of `dtype` quantized
// into the workspace q (M, K) int8 and sx (M) fp32, then Y (M, N) of
// `out_dtype` as rgm_w8a8_gemm gives it, both kernels on `stream`.
extern "C" int rgm_w8a8_linear(const void* x, const void* w, const void* scale,
                               const void* bias, void* q, void* sx, void* out, int M,
                               int N, int K, int dtype, int out_dtype, void* stream) {
  const int err = rgm_quantize_rows(x, q, sx, M, K, dtype, stream);
  if (err != static_cast<int>(cudaSuccess)) return err;
  return rgm_w8a8_gemm(q, w, sx, scale, bias, out, M, N, K, out_dtype, stream);
}

// Sets the TMA kernels' route for the calls that follow: bn 0 (by shape),
// 128 or 256 tokens a block (the fp32 route keeps 128); split 0 (by shape)
// or 1-4 blocks of a k-split cluster (at most one a k-tile). For the tests
// and the A/B tool that hold the routes against each other; not
// thread-safe. Returns a cudaError_t.
extern "C" int rgm_quant_gemm_force_route(int bn, int split) {
  if ((bn != 0 && bn != 128 && bn != 256) || split < 0 || split > kMaxSplit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  g_forced = Route{bn, split};
  return static_cast<int>(cudaSuccess);
}

// The route a call of this shape takes on the current device: 100 * BN +
// split, for gemm 0 (w8a16 in bf16), 1 (w8a8) or 2 (w8a16 in fp32).
extern "C" int rgm_quant_gemm_route(int M, int N, int K, int gemm) {
  if (gemm < 0 || gemm > 2) return -1;
  const Route r = route_for(M, N, K, static_cast<Gemm>(gemm));
  return 100 * r.bn + r.split;
}

// The quantization's route at (M, K) of `dtype` on the current device:
// 10000 * threads a row + 100 * rows a block + pieces a thread (0: the row
// read twice).
extern "C" int rgm_quantize_rows_route(int M, int K, int dtype) {
  const QuantRoute r = quant_route(M, K, dtype == 0 ? 2 : 4, sm_count());
  return 10000 * r.threads + 100 * r.rows + r.pieces;
}
