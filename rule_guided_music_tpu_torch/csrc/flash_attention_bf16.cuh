// The bf16 kernels' helpers (ldmatrix, mma.sync m16n8k16, 16-byte tile
// loads), shared by the bf16 forward (flash_attention.cu) and the bf16
// backward (flash_attention_bwd.cu).

#pragma once

#include <cuda_bf16.h>

#include "flash_attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;       // queries per block = keys per tile
constexpr int kWarps = 4;       // 16 query rows each
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [row0, row0 + 64) of one (batch, head) slice into a [64][DP + 8]
// shared tile, zero past N and past D. vec: 16-byte cp.async copies (the
// caller commits the group); else element by element.
template <int DP, int NT = kThreads>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* base,
                                          long long row_stride, int row0,
                                          int N, int D, bool vec) {
  constexpr int P = DP + 8;
  constexpr int kChunks = DP / 8;
  if (vec) {
    for (int idx = threadIdx.x; idx < kTile * kChunks; idx += NT) {
      const int r = idx / kChunks;
      const int c = idx - r * kChunks;
      const int row = row0 + r;
      const bool valid = row < N && c * 8 < D;
      const bf16* src = valid ? base + row * row_stride + c * 8 : base;
      cp_async_16(smem_addr(tile + r * P + c * 8), src, valid ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < kTile * DP; idx += NT) {
      const int r = idx / DP;
      const int d = idx - r * DP;
      const int row = row0 + r;
      tile[r * P + d] = (row < N && d < D) ? base[row * row_stride + d]
                                           : __float2bfloat16(0.f);
    }
  }
}


}  // namespace
