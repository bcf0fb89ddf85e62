// Int8 serving GEMMs for Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel. It computes what XLA fuses around the JAX
// package's int8 `dot_general` in rule_guided_music_tpu/ops/quant.py:82-124
// (`quant_dense_apply`, w8a8, and `wo_dense_apply`, w8a16): the int8 weight
// is read as it is stored, and the dequantization (the per-channel scale,
// the per-token scale, the bias) is applied to the fp32 (w8a16) or int32
// (w8a8) accumulator in registers, so no unscaled product reaches device
// memory. Three kernels, launched by ops/quant.py:
//
// * w8a16, Y(M,N) = (X(M,K) . W_i8(N,K)^T) * scale(N) + bias(N), X in bf16
//   or fp32. bf16 (`w8a16_wgmma_kernel`): each k-tile's int8 weight is
//   converted once to bf16 in shared memory (exactly: every int8 value is
//   a bf16) and the product runs on wgmma m64n128k16 with fp32
//   accumulation. fp32 (`w8a16_fp32_kernel`, the card-versus-CPU checks
//   and `--dtype float32`): X is split into three bf16 parts (hi + mid +
//   lo, each the rounding of what the parts before it left), whose three
//   products over the same weight fragment (mma.sync m16n8k16) agree with
//   the fp32 product within a few fp32 ulps; each k-tile's products are
//   summed apart and added to the running sum with one rounding.
// * `quantize_rows_kernel` (w8a8's prologue): per row of X, s = max(max|x|,
//   1e-8) / 127 and x_i8 = clip(rint(x / s), -127, 127), both divisions true
//   ones (__fdiv_rn), as JAX divides; one warp per row.
// * `w8a8_wgmma_kernel`: Y = float(X_i8 . W_i8^T) * (s_x(M) * scale(N)) +
//   bias, on wgmma m64n128k32 s8 x s8 -> s32 straight from the int8 tiles;
//   the int32 sums are exact.
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
// Design of the two wgmma kernels: one block of WG warpgroups (1 or 2,
// picked by the rows and the grid's size) per 64*WG x 128 tile of Y, each
// warpgroup 64 rows; a 3-stage ring of 16-byte cp.async copies of the k-
// tiles (128 bytes of K a row: 64 bf16 or 128 int8) into shared memory in
// the 128-byte-swizzled K-major layout that wgmma reads through its
// descriptors, rows past M and N and chunks past K zero-filled. No warp
// specialisation and no TMA yet: every thread copies, then every
// warpgroup multiplies and waits for its products before the next k-tile.
// The fp32 kernel: 8 warps (2 x 4) per 32*MT x 128 tile, a 4-stage
// cp.async ring, the k index inside a k-tile permuted alike for X and W so
// that a thread reads its fragments with one 8- or 16-byte load a row. K
// must be a multiple of 16 (the wrapper raises otherwise); M and N may be
// anything from 1.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libquant_gemm.so quant_gemm.cu

#include <cuda_bf16.h>

#include <initializer_list>
#include <type_traits>

#include "flash_attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBN = 128;                         // columns of Y a block
constexpr int kQuantRows = 8;                    // rows (warps) a block
// the wgmma kernels: 3 stages of 128 bytes of K a row
constexpr int kWgStages = 3;
constexpr int kRowBytes = 128;
// the fp32 kernel: 2 x 4 warps, 4 stages of 32 k
constexpr int kFp32Threads = 256;
constexpr int kFp32Stages = 4;
constexpr int kFp32BK = 32;
constexpr int kFp32AStride = kFp32BK * 4 + 16;   // 16 more: distinct banks

// Rows [row0, row0 + ROWS) and bytes [kb0, kb0 + ROW_BYTES) of a row-major
// matrix with `ld` bytes a row into a shared tile of `SB` bytes a row (or
// 128-byte rows in wgmma's 128-byte swizzle, chunk c of row r at chunk
// c ^ (r % 8), where SWIZZLE), by 16-byte cp.async copies (the caller
// commits); rows past `rows` and bytes past `kbytes` are zero-filled.
template <int ROWS, int ROW_BYTES, int SB, bool SWIZZLE, int NT>
__device__ __forceinline__ void load_tile(unsigned char* tile,
                                          const unsigned char* g, long long ld,
                                          int row0, int rows, int kb0,
                                          long long kbytes) {
  constexpr int kChunks = ROW_BYTES / 16;
  static_assert(!SWIZZLE || (ROW_BYTES == 128 && SB == 128), "128-byte rows");
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += NT) {
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    const int row = row0 + r;
    const int kb = kb0 + c * 16;
    const bool valid = row < rows && kb < kbytes;
    const unsigned char* src = valid ? g + row * ld + kb : g;
    const int dst = r * SB + (SWIZZLE ? (c ^ (r & 7)) : c) * 16;
    cp_async_16(smem_addr(tile + dst), src, valid ? 16 : 0);
  }
}

// wgmma's descriptor of a K-major operand in 128-byte-swizzled shared
// memory: the start address, a leading byte offset of 1 (unused when
// swizzled), 1024 bytes from one 8-row group to the next, swizzle mode 1.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// writes to shared memory by this thread's generic proxy (st.shared,
// cp.async) made visible to wgmma's async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keeps the compiler from moving the accumulators' uses across the wgmma
// fence and wait
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
__device__ __forceinline__ void fence_operands(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x 128, this thread's 64 of it) += A (64 x 16, bf16) * B (16 x 128,
// bf16), both K-major in 128-byte-swizzled shared memory.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 128) += A (64 x 32, s8) * B (32 x 128, s8), s32 sums (exact).
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a, uint64_t b) {
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

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four int8 (bytes of v) -> two bf16x2 (bytes 0-1, bytes 2-3), exactly:
// each byte b + 128 becomes the low mantissa byte of 2^23, the float
// 2^23 + 128 + b, from which 2^23 + 128 is subtracted; a float holding an
// integer of |b| <= 128 is a bf16, so its top 16 bits are b in bf16.
__device__ __forceinline__ void i8x4_to_bf16x4(uint32_t v, uint32_t& lo,
                                               uint32_t& hi) {
  constexpr float kMagic = 8388736.f;   // 2^23 + 128
  const uint32_t u = v ^ 0x80808080u;
  const float f0 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)), kMagic);
  const float f1 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)), kMagic);
  const float f2 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)), kMagic);
  const float f3 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)), kMagic);
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two fp32 values -> their bf16x2 hi, mid and lo parts (each the rounding
// of the remainder the parts before it left; the remainders are exact).
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float ra = __fsub_rn(a, __low2float(h));
  const float rb = __fsub_rn(b, __high2float(h));
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(__fsub_rn(ra, __low2float(m)),
                                  __fsub_rn(rb, __high2float(m))));
}

__device__ __forceinline__ void store_pair(bf16* out, long long i, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* out, long long i, float a, float b) {
  *reinterpret_cast<float2*>(out + i) = make_float2(a, b);
}
__device__ __forceinline__ void store_one(bf16* out, long long i, float a) {
  out[i] = __float2bfloat16_rn(a);
}
__device__ __forceinline__ void store_one(float* out, long long i, float a) {
  out[i] = a;
}

// Y[r, c] and Y[r, c + 1], c even; nothing past M or N.
template <typename TO>
__device__ __forceinline__ void store2(TO* out, int r, int c, int M, int N,
                                       float a, float b) {
  if (r >= M) return;
  const long long i = static_cast<long long>(r) * N + c;
  if (c + 1 < N && (N & 1) == 0) {
    store_pair(out, i, a, b);
  } else {
    if (c < N) store_one(out, i, a);
    if (c + 1 < N) store_one(out, i + 1, b);
  }
}

// The wgmma kernels' epilogue. Thread (warp w of warpgroup g, lane gid*4
// + t) holds, for each 8-column group j, Y rows 16w + gid (e 0, 1) and +8
// (e 2, 3) at columns 8j + 2t (+1) of its warpgroup's 64 x 128 tile.
// w8a16: acc * scale + bias; w8a8: acc * (s_x * scale) + bias.
template <typename TO, typename TA>
__device__ __forceinline__ void wgmma_epilogue(const TA (&acc)[64], const float* sx,
                                               const float* scale, const float* bias,
                                               TO* out, int m0, int n0, int M, int N) {
  const int lane = threadIdx.x & 31;
  const int row0 = m0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  float sr[2] = {1.f, 1.f};
  if (sx != nullptr) {
    sr[0] = row0 < M ? sx[row0] : 0.f;
    sr[1] = row0 + 8 < M ? sx[row0 + 8] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = n0 + j * 8 + 2 * (lane & 3);
    const float s[2] = {c < N ? scale[c] : 0.f, c + 1 < N ? scale[c + 1] : 0.f};
    const float b[2] = {bias != nullptr && c < N ? bias[c] : 0.f,
                        bias != nullptr && c + 1 < N ? bias[c + 1] : 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const TA v = acc[j * 4 + 2 * h + e];
        if constexpr (std::is_same_v<TA, int>) {   // w8a8's int32 sums
          y[e] = __fmul_rn(__int2float_rn(v), __fmul_rn(sr[h], s[e]));
        } else {
          y[e] = __fmul_rn(v, s[e]);
        }
        if (bias != nullptr) y[e] = __fadd_rn(y[e], b[e]);
      }
      store2(out, row0 + 8 * h, c, M, N, y[0], y[1]);
    }
  }
}

// w8a16 in bf16: per k-tile, X's (64 WG x 64 bf16) and W's int8 (128 x 64)
// tiles land by cp.async; W's is converted to bf16 into one swizzled tile,
// which every warpgroup multiplies with its 64 rows of X in four k16 steps.
template <int WG>
__global__ void __launch_bounds__(128 * WG)
w8a16_wgmma_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   bf16* __restrict__ out, int M, int N, int K) {
  constexpr int NT = 128 * WG;
  constexpr int BM = 64 * WG;
  constexpr int BK = kRowBytes / 2;              // 64 k
  constexpr int kA = BM * kRowBytes;             // swizzled bf16 X tile
  constexpr int kB8 = kBN * BK;                  // plain int8 W tile
  constexpr int kStage = kA + kB8;               // a multiple of 1024
  extern __shared__ unsigned char smem_raw[];
  // the swizzle's 8-row groups start on 1024 bytes
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* b16 = smem;                     // the bf16 W tile, swizzled
  unsigned char* stages = smem + kBN * kRowBytes;

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;
  const int k_tiles = (K + BK - 1) / BK;
  const long long x_ld = 2LL * K;
  const unsigned char* xg = reinterpret_cast<const unsigned char*>(x);
  const unsigned char* wg = reinterpret_cast<const unsigned char*>(w);
  auto load = [&](int kt, int slot) {
    unsigned char* st = stages + slot * kStage;
    load_tile<BM, kRowBytes, kRowBytes, true, NT>(st, xg, x_ld, m0, M, kt * kRowBytes, x_ld);
    load_tile<kBN, BK, BK, false, NT>(st + kA, wg, K, n0, N, kt * BK, K);
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < k_tiles) load(s, s);
    cp_async_commit();
  }
  const int g = threadIdx.x >> 7;
#pragma unroll 1
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kWgStages - 2>();
    fence_proxy_async();
    __syncthreads();   // tile kt landed; every warpgroup is done with kt - 1
    if (kt + kWgStages - 1 < k_tiles) load(kt + kWgStages - 1, (kt + kWgStages - 1) % kWgStages);
    cp_async_commit();
    const unsigned char* st = stages + (kt % kWgStages) * kStage;
    // W's 16-byte int8 chunk (row r, k 16c..16c+15) -> bf16 chunks 2c, 2c + 1
    for (int idx = threadIdx.x; idx < kBN * (BK / 16); idx += NT) {
      const int r = idx >> 2;
      const int c = idx & 3;
      const uint4 v = *reinterpret_cast<const uint4*>(st + kA + r * BK + c * 16);
      uint4 lo, hi;
      i8x4_to_bf16x4(v.x, lo.x, lo.y);
      i8x4_to_bf16x4(v.y, lo.z, lo.w);
      i8x4_to_bf16x4(v.z, hi.x, hi.y);
      i8x4_to_bf16x4(v.w, hi.z, hi.w);
      *reinterpret_cast<uint4*>(b16 + r * kRowBytes + (((2 * c) ^ (r & 7)) << 4)) = lo;
      *reinterpret_cast<uint4*>(b16 + r * kRowBytes + (((2 * c + 1) ^ (r & 7)) << 4)) = hi;
    }
    fence_proxy_async();
    __syncthreads();
    wgmma_fence();
    fence_operands(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {   // k16 steps: 32 bytes along the row
      wgmma_bf16(acc, sw128_desc(st + g * 64 * kRowBytes + kk * 32),
                 sw128_desc(b16 + kk * 32));
    }
    wgmma_commit_and_wait();
    fence_operands(acc);
  }
  cp_async_wait<0>();
  wgmma_epilogue(acc, nullptr, scale, bias, out, m0 + g * 64, n0, M, N);
}

// w8a8: per k-tile (128 int8 of K), the X_i8 and W_i8 tiles land swizzled
// and wgmma reads both as they are, in four k32 steps.
template <int WG, typename TO>
__global__ void __launch_bounds__(128 * WG)
w8a8_wgmma_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ w,
                  const float* __restrict__ sx, const float* __restrict__ scale,
                  const float* __restrict__ bias, TO* __restrict__ out, int M,
                  int N, int K) {
  constexpr int NT = 128 * WG;
  constexpr int BM = 64 * WG;
  constexpr int kA = BM * kRowBytes;
  constexpr int kStage = kA + kBN * kRowBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* stages = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;
  const int k_tiles = (K + kRowBytes - 1) / kRowBytes;
  const unsigned char* qg = reinterpret_cast<const unsigned char*>(q);
  const unsigned char* wg = reinterpret_cast<const unsigned char*>(w);
  auto load = [&](int kt, int slot) {
    unsigned char* st = stages + slot * kStage;
    load_tile<BM, kRowBytes, kRowBytes, true, NT>(st, qg, K, m0, M, kt * kRowBytes, K);
    load_tile<kBN, kRowBytes, kRowBytes, true, NT>(st + kA, wg, K, n0, N, kt * kRowBytes, K);
  };

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
#pragma unroll
  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < k_tiles) load(s, s);
    cp_async_commit();
  }
  const int g = threadIdx.x >> 7;
#pragma unroll 1
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kWgStages - 2>();
    fence_proxy_async();
    __syncthreads();
    if (kt + kWgStages - 1 < k_tiles) load(kt + kWgStages - 1, (kt + kWgStages - 1) % kWgStages);
    cp_async_commit();
    const unsigned char* st = stages + (kt % kWgStages) * kStage;
    wgmma_fence();
    fence_operands(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {   // k32 steps: 32 bytes along the row
      wgmma_s8(acc, sw128_desc(st + g * 64 * kRowBytes + kk * 32),
               sw128_desc(st + kA + kk * 32));
    }
    wgmma_commit_and_wait();
    fence_operands(acc);
  }
  cp_async_wait<0>();
  wgmma_epilogue(acc, sx, scale, bias, out, m0 + g * 64, n0, M, N);
}

// w8a16 in fp32 on mma.sync: three bf16 parts of X a k-tile. The k index
// inside a 32-k tile is permuted alike for X and W: thread t of a quad
// reads the 8 k at 8t, which stand for mma k {2t, 2t+1, 2t+8, 2t+9} of the
// first k16 step and the same of the second; the sums are the same.
template <int MT>
__global__ void __launch_bounds__(kFp32Threads)
w8a16_fp32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  float* __restrict__ out, int M, int N, int K) {
  constexpr int BM = 32 * MT;
  constexpr int kAStage = BM * kFp32AStride;
  constexpr int kBStage = kBN * kFp32BK;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* as = smem;
  unsigned char* bs = smem + kFp32Stages * kAStage;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  const int gid = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;
  const int k_tiles = (K + kFp32BK - 1) / kFp32BK;
  const long long a_ld = 4LL * K;
  const unsigned char* xg = reinterpret_cast<const unsigned char*>(x);
  const unsigned char* wg = reinterpret_cast<const unsigned char*>(w);
  auto load = [&](int kt, int slot) {
    load_tile<BM, kFp32BK * 4, kFp32AStride, false, kFp32Threads>(
        as + slot * kAStage, xg, a_ld, m0, M, kt * kFp32BK * 4, a_ld);
    load_tile<kBN, kFp32BK, kFp32BK, false, kFp32Threads>(
        bs + slot * kBStage, wg, K, n0, N, kt * kFp32BK, K);
  };

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
#pragma unroll
  for (int s = 0; s < kFp32Stages - 1; ++s) {
    if (s < k_tiles) load(s, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kFp32Stages - 2>();
    __syncthreads();
    if (kt + kFp32Stages - 1 < k_tiles) load(kt + kFp32Stages - 1, (kt + kFp32Stages - 1) % kFp32Stages);
    cp_async_commit();
    const int slot = kt % kFp32Stages;
    const unsigned char* at = as + slot * kAStage + (wm * 16 * MT) * kFp32AStride;
    const unsigned char* bt = bs + slot * kBStage + (wn * 32) * kFp32BK;

    uint32_t bf[4][4];   // per n8 tile: k16 step 0's b0, b1, step 1's b0, b1
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint2 wv = *reinterpret_cast<const uint2*>(bt + (j * 8 + gid) * kFp32BK + 8 * t);
      i8x4_to_bf16x4(wv.x, bf[j][0], bf[j][1]);
      i8x4_to_bf16x4(wv.y, bf[j][2], bf[j][3]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float* r0 = reinterpret_cast<const float*>(at + (i * 16 + gid) * kFp32AStride) + 8 * t;
      const float* r1 = reinterpret_cast<const float*>(at + (i * 16 + gid + 8) * kFp32AStride) + 8 * t;
      const float4 u0 = *reinterpret_cast<const float4*>(r0);
      const float4 u1 = *reinterpret_cast<const float4*>(r0 + 4);
      const float4 v0 = *reinterpret_cast<const float4*>(r1);
      const float4 v1 = *reinterpret_cast<const float4*>(r1 + 4);
      uint32_t a[3][2][4];   // [hi, mid, lo][k16 step][mma A register]
      split3(u0.x, u0.y, a[0][0][0], a[1][0][0], a[2][0][0]);
      split3(v0.x, v0.y, a[0][0][1], a[1][0][1], a[2][0][1]);
      split3(u0.z, u0.w, a[0][0][2], a[1][0][2], a[2][0][2]);
      split3(v0.z, v0.w, a[0][0][3], a[1][0][3], a[2][0][3]);
      split3(u1.x, u1.y, a[0][1][0], a[1][1][0], a[2][1][0]);
      split3(v1.x, v1.y, a[0][1][1], a[1][1][1], a[2][1][1]);
      split3(u1.z, u1.w, a[0][1][2], a[1][1][2], a[2][1][2]);
      split3(v1.z, v1.w, a[0][1][3], a[1][1][3], a[2][1][3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int p = 2; p >= 0; --p) {   // lo, mid, hi
          mma_bf16(part, a[p][0], bf[j][0], bf[j][1]);
          mma_bf16(part, a[p][1], bf[j][2], bf[j][3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = __fadd_rn(acc[i][j][e], part[e]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = n0 + wn * 32 + j * 8 + 2 * t;
    const float s0 = c < N ? scale[c] : 0.f;
    const float s1 = c + 1 < N ? scale[c + 1] : 0.f;
    const float b0 = bias != nullptr && c < N ? bias[c] : 0.f;
    const float b1 = bias != nullptr && c + 1 < N ? bias[c + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm * 16 * MT + i * 16 + gid + 8 * h;
        float y0 = __fmul_rn(acc[i][j][2 * h], s0);
        float y1 = __fmul_rn(acc[i][j][2 * h + 1], s1);
        if (bias != nullptr) {
          y0 = __fadd_rn(y0, b0);
          y1 = __fadd_rn(y1, b1);
        }
        store2(out, r, c, M, N, y0, y1);
      }
    }
  }
}

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[e]);
    v[2 * e] = __low2float(h);
    v[2 * e + 1] = __high2float(h);
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// One warp per row: amax, then the scale and the int8 row (read twice: the
// second read of a row of at most 18 KB comes from L1/L2).
template <typename TX>
__global__ void __launch_bounds__(32 * kQuantRows)
quantize_rows_kernel(const TX* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ sx, int M, int K) {
  const int row = blockIdx.x * kQuantRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const TX* xr = x + static_cast<long long>(row) * K;
  float amax = 0.f;
  for (int k = lane * 8; k < K; k += 32 * 8) {
    float v[8];
    load8(xr + k, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
  int8_t* qr = q + static_cast<long long>(row) * K;
  for (int k = lane * 8; k < K; k += 32 * 8) {
    float v[8];
    load8(xr + k, v);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float r = fminf(fmaxf(rintf(__fdiv_rn(v[e], s)), -127.f), 127.f);
      packed[e >> 2] |= (static_cast<uint32_t>(static_cast<int>(r)) & 0xffu) << (8 * (e & 3));
    }
    *reinterpret_cast<uint2*>(qr + k) = make_uint2(packed[0], packed[1]);
  }
  if (lane == 0) sx[row] = s;
}

// Warpgroups a wgmma block (64 rows each): 2 where 128-row blocks fill the
// SMs, else 1.
bool two_warpgroups(int M, int N) {
  return static_cast<long long>((M + 127) / 128) * ((N + kBN - 1) / kBN) >= sm_count();
}

template <int WG>
cudaError_t launch_w8a16_bf16(const bf16* x, const int8_t* w, const float* scale,
                              const float* bias, bf16* out, int M, int N, int K,
                              cudaStream_t stream) {
  constexpr int kSmem = 1024 + kBN * kRowBytes + kWgStages * (64 * WG * kRowBytes + kBN * 64);
  static int done[kMaxDevices];
  const cudaError_t err = allow_smem_once(w8a16_wgmma_kernel<WG>, kSmem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + 64 * WG - 1) / (64 * WG));
  w8a16_wgmma_kernel<WG><<<grid, 128 * WG, kSmem, stream>>>(x, w, scale, bias, out, M, N, K);
  return cudaGetLastError();
}

template <int MT>
cudaError_t launch_w8a16_fp32(const float* x, const int8_t* w, const float* scale,
                              const float* bias, float* out, int M, int N, int K,
                              cudaStream_t stream) {
  constexpr int BM = 32 * MT;
  constexpr int kSmem = kFp32Stages * (BM * kFp32AStride + kBN * kFp32BK);
  static int done[kMaxDevices];
  const cudaError_t err = allow_smem_once(w8a16_fp32_kernel<MT>, kSmem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM);
  w8a16_fp32_kernel<MT><<<grid, kFp32Threads, kSmem, stream>>>(x, w, scale, bias, out, M, N, K);
  return cudaGetLastError();
}

template <int WG, typename TO>
cudaError_t launch_w8a8(const int8_t* q, const int8_t* w, const float* sx,
                        const float* scale, const float* bias, TO* out, int M,
                        int N, int K, cudaStream_t stream) {
  constexpr int kSmem = 1024 + kWgStages * (64 * WG + kBN) * kRowBytes;
  static int done[kMaxDevices];
  const cudaError_t err = allow_smem_once(w8a8_wgmma_kernel<WG, TO>, kSmem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + 64 * WG - 1) / (64 * WG));
  w8a8_wgmma_kernel<WG, TO><<<grid, 128 * WG, kSmem, stream>>>(q, w, sx, scale, bias, out,
                                                                 M, N, K);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch_w8a8_pick(const void* q, const void* w, const void* sx,
                             const void* scale, const void* bias, void* out, int M,
                             int N, int K, cudaStream_t stream) {
  const int8_t* qi = static_cast<const int8_t*>(q);
  const int8_t* wi = static_cast<const int8_t*>(w);
  const float* s = static_cast<const float*>(sx);
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  TO* o = static_cast<TO*>(out);
  return two_warpgroups(M, N) ? launch_w8a8<2>(qi, wi, s, sc, b, o, M, N, K, stream)
                              : launch_w8a8<1>(qi, wi, s, sc, b, o, M, N, K, stream);
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
  const int8_t* wi = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0) {
    const bf16* xa = static_cast<const bf16*>(x);
    bf16* o = static_cast<bf16*>(out);
    return static_cast<int>(two_warpgroups(M, N)
                                ? launch_w8a16_bf16<2>(xa, wi, sc, b, o, M, N, K, s)
                                : launch_w8a16_bf16<1>(xa, wi, sc, b, o, M, N, K, s));
  }
  if (dtype == 1) {
    const float* xa = static_cast<const float*>(x);
    float* o = static_cast<float*>(out);
    return static_cast<int>(M <= 32 ? launch_w8a16_fp32<1>(xa, wi, sc, b, o, M, N, K, s)
                                    : launch_w8a16_fp32<2>(xa, wi, sc, b, o, M, N, K, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// q (M, K) int8 and sx (M) fp32 from x (M, K) of `dtype`, contiguous.
extern "C" int rgm_quantize_rows(const void* x, void* q, void* sx, int M, int K,
                                 int dtype, void* stream) {
  if (!valid_shape(M, 1, K, {x, q})) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + kQuantRows - 1) / kQuantRows);
  switch (dtype) {
    case 0:
      quantize_rows_kernel<bf16><<<grid, 32 * kQuantRows, 0, s>>>(
          static_cast<const bf16*>(x), static_cast<int8_t*>(q),
          static_cast<float*>(sx), M, K);
      break;
    case 1:
      quantize_rows_kernel<float><<<grid, 32 * kQuantRows, 0, s>>>(
          static_cast<const float*>(x), static_cast<int8_t*>(q),
          static_cast<float*>(sx), M, K);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Y (M, N) of `out_dtype` = float(q (M, K) . w (N, K) ^T) * (sx (M) *
// scale (N)) + bias (N, or null); every tensor contiguous.
extern "C" int rgm_w8a8_gemm(const void* q, const void* w, const void* sx,
                             const void* scale, const void* bias, void* out,
                             int M, int N, int K, int out_dtype, void* stream) {
  if (!valid_shape(M, N, K, {q, w, out})) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0: return static_cast<int>(launch_w8a8_pick<bf16>(q, w, sx, scale, bias, out, M, N, K, s));
    case 1: return static_cast<int>(launch_w8a8_pick<float>(q, w, sx, scale, bias, out, M, N, K, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
