// Flash attention in fp32 for Hopper (sm_90a), forward and backward, plain C
// interface.
//
// Replaces the Pallas TPU kernel rule_guided_music_tpu/ops/pallas_attention.py
// (`flash_attention`, body `_flash_kernel`) for float32 tensors: non-causal
// softmax attention over (B, N, H, D), scale D^-0.5 on the true D, online
// softmax with fp32 running max, sum and accumulator, keys past N masked;
// and its exact gradient (the Pallas kernel has none: the JAX package
// differentiates the XLA formulation). The bf16 kernels are in
// flash_attention.cu and flash_attention_bwd.cu.
//
// The arithmetic: every product on the tensor cores as three TF32 products
// (the 3xTF32 split). Each fp32 operand x becomes big = x rounded to TF32
// (10 mantissa bits, to nearest) and small = x - big (exact in fp32), which
// enters the tensor cores with its low 13 bits dropped; a b is taken as
// small(a) big(b) + big(a) small(b) + big(a) big(b) by mma.sync m16n8k8
// .tf32 with fp32 accumulation, the small terms first. What is lost is
// small(a) small(b) and the residue below small's 11 bits, about 2^-21 of
// |a b|: a few fp32 ulps, where one TF32 product would lose 2^-11 and break
// the 1e-4 agreement that fp32 callers (the card-versus-CPU checks, train
// step checks at 1e-5) rely on. The SIMT kernels this replaces (scalar
// fmaf on the fp32 pipes, 67 TFLOP/s at most) reached 19% of that pipe's
// bound and lost 2.0x (forward) and 2.3x (backward) to PyTorch's fp32 SDPA.
//
// What bounds it on the H100: three TF32 products over the tensor cores'
// 495 TFLOP/s (dense) against the bytes over 3.35 TB/s: at the DiT shape
// (N = 256, D = 72) the forward's three products do ~190 operations per
// byte, over the TF32 ridge (~150), so the tensor cores; mma.sync issues
// them (wgmma would need the split operands in shared memory), and every
// B operand is split by the warp that reads it (four integer or fp32
// operations an element), so issue slots and latency, with two blocks of
// four warps an SM, set the time (24.6% of the bound at train_dit's
// shape, PERF.md).
//
// Forward (`flash_fwd_tf32x3_kernel<DP>`): FlashAttention-2's shape, as the
// bf16 kernel: one block per (batch*head, 64-query tile), four warps of 16
// query rows; Q in registers (fp32, split per use), K and V in fp32 64-key
// tiles double-buffered by 16-byte cp.async; S = Q K^T on the fragments,
// the online softmax on the accumulator once per key tile (quad shuffles
// for the row max, the row sums reduced once at the end), the accumulator
// rescaled only when the max grows; P split in registers and reused as the
// A operand of O += P V. The m16n8k8 .tf32 A fragment holds columns t and
// t + 4 where the accumulator holds 2t and 2t + 1, so every product's
// reduction index is permuted within each group of 8 (logical t is index
// 2t, logical t + 4 is 2t + 1): the sum is the same, P needs no shuffle,
// and rows read as float2. Q's tile is staged in the second K buffer.
//
// Backward: three launches, no atomics, five products each done once; the
// same bits from run to run (a trainer's resume relies on it).
//   1. `flash_bwd_delta_fp32_kernel`: Di = rowsum(dO o O), a warp a row.
//   2. `flash_bwd_dkdv_tf32x3_kernel<DP, NW>`: a block of NW warps keeps its
//      16 NW keys' K and V in shared memory and walks 32-query tiles (Q, dO
//      double-buffered by cp.async; LSE and Di beside them): S^T = K Q^T,
//      P^T from the recorded LSE, dV += P^T dO, dP^T = V dO^T, dS^T = P^T o
//      (dP^T - Di), dK += dS^T Q; it writes dS^T (fp32, (B*H, N keys, NP
//      queries)) to a scratch buffer.
//   3. `flash_bwd_dq_tf32x3_kernel<DP>`: dQ = dS K, a block of two warps
//      per 32 queries over 64-key tiles of dS^T and K, in key order.
// The scratch costs 8 N^2 bytes per (batch, head) of traffic (0.08 ms of
// the memory rate at train_dit's (32,256,16,72), in L2 at smaller shapes)
// where a dQ kernel that recomputed S and dP would cost two products more.
// The route by grid size: NW = 2 where 4-warp blocks would not fill the SMs (the
// classifiers' (2,257,6,64): 108 blocks where 4 warps give 60), else NW = 4.
// The tensor cores' fp32 accumulation truncates, so each product sums a few
// k-steps into a partial and adds it to its total in fp32 (`flush`).
//
// D is zero-padded in shared memory to DP (16, 32, 48, 64, 72, 96 or 128:
// the main shapes' D = 64 and 72 pad nothing), padded columns never
// stored; the ragged last tile zero-filled and masked (keys to -inf in S, P
// to 0 in the backward); rows that are not 16-byte aligned (D not a multiple
// of 4, odd strides) loaded element by element into the same layout.
// Shared-memory pitches: tiles read as float2 along rows take DP (+ 8)
// (8 or 24 mod 32 words: a half-warp's four rows on distinct banks); tiles
// read down columns take DP + 4 (4 or 12 mod 16: the rows 2t, 2t + 1 of a
// fragment on distinct banks).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_fp32.so flash_attention_fp32.cu

#include <initializer_list>
#include <type_traits>

#include "flash_attention_common.cuh"

namespace {

constexpr int kTileQ = 64;     // forward: queries per block = keys per tile
constexpr int kWarpsF = 4;     // forward: 16 query rows a warp
constexpr int kBwdQ = 32;      // dK/dV kernel: queries per tile
constexpr int kDqQ = 32;       // dQ kernel: queries per block (two warps)
constexpr int kDqK = 64;       // dQ kernel: keys per tile

// pitch of a tile read as float2 along its rows, of one read down columns
template <int DP>
__host__ __device__ constexpr int pitch_rows() { return DP % 16 == 8 ? DP : DP + 8; }
template <int DP>
__host__ __device__ constexpr int pitch_cols() { return DP + 4; }

// x = big + small: big rounded to TF32 (to nearest, ties away), small the
// exact rest, rounded the same way when the tensor cores drop its low bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], big[i], small[i]);
}

// c += a (16x8, row) * b (8x8, col), TF32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in three TF32 products, the small terms first; b = (b0, b1) fp32
__device__ __forceinline__ void mma_3x(float (&c)[4], const uint32_t (&ab)[4],
                                       const uint32_t (&as)[4], float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

// The tensor cores' fp32 accumulation truncates (toward zero): chained over
// a whole product (dK, dV over 1024 queries, S over 9 k-steps) its bias
// reached 1.2e-5 of the largest gradient, past the fp32 gradient tolerance
// of 1e-5. So every product sums a few k-steps into a partial `t` on the
// tensor cores and adds the partial to its total `c` in fp32, to nearest,
// and zeroes it: each chain of truncations is short and starts from zero.
template <int NT>
__device__ __forceinline__ void flush(float (&c)[NT][4], float (&t)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      c[j][e] += t[j][e];
      t[j][e] = 0.f;
    }
  }
}
template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}
// k-steps summed on the tensor cores before a flush: over D (S, dP), and
// over keys or queries (P V, dV, dK, dQ)
constexpr int kFlushD = 3;
constexpr int kFlushN = 4;

// Fragments with the permuted reduction index (lane = 4 g + t; logical
// column t is 2t, t + 4 is 2t + 1 within each group of 8):
// A (16 x 8) from a row-major [m][k] tile at (m0, k0): two float2
__device__ __forceinline__ void frag_a_rows(float (&a)[4], const float* tile, int pitch,
                                            int m0, int k0, int lane) {
  const float* p = tile + (m0 + (lane >> 2)) * pitch + k0 + 2 * (lane & 3);
  const float2 x = *reinterpret_cast<const float2*>(p);
  const float2 y = *reinterpret_cast<const float2*>(p + 8 * pitch);
  a[0] = x.x;
  a[1] = y.x;
  a[2] = x.y;
  a[3] = y.y;
}
// A (16 x 8) from a [k][m] tile (its transpose) at (m0, k0): four scalars
__device__ __forceinline__ void frag_a_cols(float (&a)[4], const float* tile, int pitch,
                                            int m0, int k0, int lane) {
  const float* p = tile + (k0 + 2 * (lane & 3)) * pitch + m0 + (lane >> 2);
  a[0] = p[0];
  a[1] = p[8];
  a[2] = p[pitch];
  a[3] = p[pitch + 8];
}
// A from an accumulator fragment (the 8 columns of one n-tile as k)
__device__ __forceinline__ void frag_a_acc(float (&a)[4], const float (&c)[4]) {
  a[0] = c[0];
  a[1] = c[2];
  a[2] = c[1];
  a[3] = c[3];
}
// B (8 x 8) from an [n][k] tile (B^T row-major) at (n0, k0): one float2
__device__ __forceinline__ float2 frag_b_rows(const float* tile, int pitch, int n0,
                                              int k0, int lane) {
  return *reinterpret_cast<const float2*>(tile + (n0 + (lane >> 2)) * pitch + k0
                                          + 2 * (lane & 3));
}
// B (8 x 8) from a [k][n] tile at (k0, n0): two scalars
__device__ __forceinline__ float2 frag_b_cols(const float* tile, int pitch, int k0,
                                              int n0, int lane) {
  const float* p = tile + (k0 + 2 * (lane & 3)) * pitch + n0 + (lane >> 2);
  return make_float2(p[0], p[pitch]);
}

// Rows [row0, row0 + R) of one (batch, head) slice into an [R][P] shared
// tile, zero past N and past D (up to DP). vec: 16-byte cp.async copies
// (the caller commits the group); else element by element.
template <int R, int DP, int P, int NT>
__device__ __forceinline__ void load_rows(float* tile, const float* base,
                                          long long row_stride, int row0, int N,
                                          int D, bool vec) {
  constexpr int kChunks = DP / 4;
  if (vec) {
    for (int idx = threadIdx.x; idx < R * kChunks; idx += NT) {
      const int r = idx / kChunks;
      const int c = idx - r * kChunks;
      const int row = row0 + r;
      const bool valid = row < N && c * 4 < D;
      const float* src = valid ? base + row * row_stride + c * 4 : base;
      cp_async_16(smem_addr(tile + r * P + c * 4), src, valid ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < R * DP; idx += NT) {
      const int r = idx / DP;
      const int d = idx - r * DP;
      const int row = row0 + r;
      tile[r * P + d] = (row < N && d < D) ? base[row * row_stride + d] : 0.f;
    }
  }
}

// A warp's 16 rows of an accumulator times `mul`, stored to rows [row0,
// row0 + 16) of `dst` below N and D (pairs where vec: D a multiple of 4)
template <int DP>
__device__ __forceinline__ void store_acc(const float (&acc)[DP / 8][4], float mul,
                                          float* dst, long long row_stride, int row0,
                                          int N, int D, int vec, int lane) {
  const int g = lane >> 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= N) continue;
    float* out = dst + row * row_stride;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      const float x0 = acc[j][2 * r] * mul;
      const float x1 = acc[j][2 * r + 1] * mul;
      if (vec) {
        if (col < D) *reinterpret_cast<float2*>(out + col) = make_float2(x0, x1);
      } else {
        if (col < D) out[col] = x0;
        if (col + 1 < D) out[col + 1] = x1;
      }
    }
  }
}

// ---------------------------------------------------------------- forward ----

// Shared memory: K in two buffers [64][pitch_rows] (the second holds Q's
// tile first), then V in two [64][pitch_cols].
template <int DP>
constexpr int fwd_smem_bytes() {
  return 2 * kTileQ * (pitch_rows<DP>() + pitch_cols<DP>()) * static_cast<int>(sizeof(float));
}

template <int DP>
__global__ void __launch_bounds__(32 * kWarpsF)
flash_fwd_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int H, int N, int D, Strides st,
                        float scale_log2, int vec) {
  constexpr int kT = 32 * kWarpsF;
  constexpr int PK = pitch_rows<DP>();
  constexpr int PV = pitch_cols<DP>();
  constexpr int KD = DP / 8;    // k-steps of Q K^T, n-tiles of P V
  extern __shared__ __align__(16) float smem_f[];
  float* ks = smem_f;
  float* vs = ks + 2 * kTileQ * PK;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int q0 = blockIdx.y * kTileQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;
  const int n_tiles = (N + kTileQ - 1) / kTileQ;

  load_rows<kTileQ, DP, PK, kT>(ks + kTileQ * PK, q + b * st.qb + h * st.qh, st.qn, q0,
                                N, D, vec);
  load_rows<kTileQ, DP, PK, kT>(ks, kb, st.kn, 0, N, D, vec);
  load_rows<kTileQ, DP, PV, kT>(vs, vb, st.vn, 0, N, D, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    frag_a_rows(qf[kk], ks + kTileQ * PK, PK, warp * 16, kk * 8, lane);
  }
  __syncthreads();   // the second K buffer is free for tile 1

  float acc[KD][4];
#pragma unroll
  for (int j = 0; j < KD; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // this thread's two rows: lane / 4 and lane / 4 + 8 of the warp's 16
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};   // this thread's share of the row sums

#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {   // the next tile's copy overlaps this tile's math
      load_rows<kTileQ, DP, PK, kT>(ks + (buf ^ 1) * kTileQ * PK, kb, st.kn,
                                    (t + 1) * kTileQ, N, D, vec);
      load_rows<kTileQ, DP, PV, kT>(vs + (buf ^ 1) * kTileQ * PV, vb, st.vn,
                                    (t + 1) * kTileQ, N, D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + buf * kTileQ * PK;
    const float* vt = vs + buf * kTileQ * PV;

    // S = Q K^T: this warp's 16 rows by 64 keys, eight n-tiles of 8 keys
    float s[8][4], part[8][4];
    zero(s);
    zero(part);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qb[4], qs[4];
      split4(qf[kk], qb, qs);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 kf = frag_b_rows(kt, PK, 8 * j, 8 * kk, lane);
        mma_3x(part[j], qb, qs, kf.x, kf.y);
      }
      if (kk % kFlushD == kFlushD - 1 || kk == KD - 1) flush(s, part);
    }
    const int k0 = t * kTileQ;
    if (k0 + kTileQ > N) {   // the ragged last tile: keys past N to -inf
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k0 + 8 * j + 2 * (lane & 3) + (e & 1) >= N) s[j][e] = -INFINITY;
        }
      }
    }

    // online softmax on the fragments: elements 0,1 are row lane/4,
    // elements 2,3 row lane/4 + 8; a row's 64 keys lie on one lane quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * scale_log2);
      if (m_new > m[r]) {   // the max grows: rescale what was summed so far
        const float alpha = exp2f(m[r] - m_new);   // 0 on the first tile
        l[r] *= alpha;
#pragma unroll
        for (int j = 0; j < KD; ++j) {
          acc[j][2 * r] *= alpha;
          acc[j][2 * r + 1] *= alpha;
        }
        m[r] = m_new;
      }
    }
    // P = exp2(S * scale * log2(e) - m) in fp32; O += P V, n-tile j of S
    // being k-step j of P V
    float po[KD][4];
    zero(po);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(fmaf(s[j][e], scale_log2, -m[e >> 1]));
      }
      l[0] += s[j][0] + s[j][1];
      l[1] += s[j][2] + s[j][3];
      float pa[4];
      uint32_t pb[4], ps[4];
      frag_a_acc(pa, s[j]);
      split4(pa, pb, ps);
#pragma unroll
      for (int dj = 0; dj < KD; ++dj) {
        const float2 vf = frag_b_cols(vt, PV, 8 * j, 8 * dj, lane);
        mma_3x(po[dj], pb, ps, vf.x, vf.y);
      }
      if (j % kFlushN == kFlushN - 1) flush(acc, po);
    }
    __syncthreads();   // this buffer is free for the copy two tiles on
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  const int row0 = q0 + warp * 16;
  if (lse != nullptr && (lane & 3) == 0) {   // m is in log2 units
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + (lane >> 2) + 8 * r;
      if (row < N) lse[blockIdx.x * N + row] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
#pragma unroll
  for (int j = 0; j < KD; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= inv[e >> 1];
  }
  store_acc<DP>(acc, 1.f, o + b * st.ob + h * st.oh, st.on, row0, N, D, vec, lane);
}

template <int DP>
cudaError_t launch_fwd_dp(const float* q, const float* k, const float* v, float* o,
                          float* lse, int B, int H, int N, int D, const Strides& st,
                          float scale, bool vec, cudaStream_t stream) {
  constexpr int kSmem = fwd_smem_bytes<DP>();
  static int done[kMaxDevices];
  const cudaError_t err = allow_smem_once(flash_fwd_tf32x3_kernel<DP>, kSmem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (N + kTileQ - 1) / kTileQ);
  flash_fwd_tf32x3_kernel<DP><<<grid, 32 * kWarpsF, kSmem, stream>>>(
      q, k, v, o, lse, H, N, D, st, scale * kLog2e, vec ? 1 : 0);
  return cudaGetLastError();
}

// The padded head dims built: those of the port's models (64, 72, 96,
// 128) and 16, 32, 48 below them; each is a large instantiation of every
// kernel, and the build is card time on every run
template <typename F>
cudaError_t by_dp(int D, F&& f) {
  if (D <= 16) return f(std::integral_constant<int, 16>());
  if (D <= 32) return f(std::integral_constant<int, 32>());
  if (D <= 48) return f(std::integral_constant<int, 48>());
  if (D <= 64) return f(std::integral_constant<int, 64>());
  if (D <= 72) return f(std::integral_constant<int, 72>());
  if (D <= 96) return f(std::integral_constant<int, 96>());
  return f(std::integral_constant<int, 128>());
}

// 16-byte copies need D a multiple of 4, every stride a multiple of 4
// elements and 16-byte aligned base pointers
bool vec_ok(int D, std::initializer_list<const void*> ptrs,
            std::initializer_list<long long> strides) {
  bool vec = D % 4 == 0;
  for (const void* p : ptrs) vec = vec && aligned16(p);
  for (long long s : strides) vec = vec && s % 4 == 0;
  return vec;
}

// --------------------------------------------------------------- backward ----

__global__ void __launch_bounds__(256)
flash_bwd_delta_fp32_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                            float* __restrict__ delta, int H, int N, int D,
                            BwdStrides st, int rows) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int bh = row / N;
  const int i = row - bh * N;
  const int b = bh / H;
  const int h = bh - b * H;
  const float* orow = o + b * st.ob + h * st.oh + i * st.on;
  const float* drow = dout + b * st.db + h * st.dh + i * st.dn;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(drow[d], orow[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// Shared memory of the dK/dV kernel: K and V [16 NW][pitch_rows], Q and dO
// in two buffers [32][pitch_cols], then LSE (log2 units) and Di, two x 32.
template <int DP, int NW>
constexpr int dkdv_smem_bytes() {
  return (2 * 16 * NW * pitch_rows<DP>() + 4 * kBwdQ * pitch_cols<DP>() + 4 * kBwdQ) *
         static_cast<int>(sizeof(float));
}

template <int DP, int NW>
__global__ void __launch_bounds__(32 * NW)
flash_bwd_dkdv_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta, float* __restrict__ dk,
                             float* __restrict__ dv, float* __restrict__ ds, int H,
                             int N, int D, int NP, BwdStrides st, float scale,
                             float scale_log2, int vec) {
  constexpr int kT = 32 * NW;
  constexpr int kKeys = 16 * NW;
  constexpr int PK = pitch_rows<DP>();
  constexpr int PB = pitch_cols<DP>();
  constexpr int KD = DP / 8;
  constexpr int QJ = kBwdQ / 8;   // n-tiles of S^T, k-steps of dV and dK
  extern __shared__ __align__(16) float smem_f[];
  float* ks = smem_f;
  float* vs = ks + kKeys * PK;
  float* qs = vs + kKeys * PK;
  float* dos = qs + 2 * kBwdQ * PB;
  float* ls = dos + 2 * kBwdQ * PB;
  float* dls = ls + 2 * kBwdQ;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * kKeys;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const float* qb = q + b * st.qb + h * st.qh;
  const float* db = dout + b * st.db + h * st.dh;
  const float* lb = lse + static_cast<long long>(bh) * N;
  const float* deb = delta + static_cast<long long>(bh) * N;
  const int n_tiles = (N + kBwdQ - 1) / kBwdQ;

  load_rows<kKeys, DP, PK, kT>(ks, k + b * st.kb + h * st.kh, st.kn, k0, N, D, vec);
  load_rows<kKeys, DP, PK, kT>(vs, v + b * st.vb + h * st.vh, st.vn, k0, N, D, vec);
  load_rows<kBwdQ, DP, PB, kT>(qs, qb, st.qn, 0, N, D, vec);
  load_rows<kBwdQ, DP, PB, kT>(dos, db, st.dn, 0, N, D, vec);
  cp_async_commit();
  for (int i = threadIdx.x; i < kBwdQ; i += kT) {
    ls[i] = i < N ? lb[i] * kLog2e : 0.f;
    dls[i] = i < N ? deb[i] : 0.f;
  }
  float dka[KD][4], dva[KD][4];
#pragma unroll
  for (int j = 0; j < KD; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  }
  // this thread's keys: rows g and g + 8 of the warp's 16
  const int kr[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float* dsb = ds + static_cast<long long>(bh) * N * NP;

#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {   // the next query tile's copy overlaps this one's math
      const int q1 = (t + 1) * kBwdQ;
      load_rows<kBwdQ, DP, PB, kT>(qs + (buf ^ 1) * kBwdQ * PB, qb, st.qn, q1, N, D, vec);
      load_rows<kBwdQ, DP, PB, kT>(dos + (buf ^ 1) * kBwdQ * PB, db, st.dn, q1, N, D, vec);
      cp_async_commit();
      for (int i = threadIdx.x; i < kBwdQ; i += kT) {
        ls[(buf ^ 1) * kBwdQ + i] = q1 + i < N ? lb[q1 + i] * kLog2e : 0.f;
        dls[(buf ^ 1) * kBwdQ + i] = q1 + i < N ? deb[q1 + i] : 0.f;
      }
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* qt = qs + buf * kBwdQ * PB;
    const float* dt = dos + buf * kBwdQ * PB;
    const float* lt = ls + buf * kBwdQ;
    const float* dlt = dls + buf * kBwdQ;
    const int q0 = t * kBwdQ;

    // S^T = K Q^T: this warp's 16 keys by 32 queries
    float s[QJ][4], part[QJ][4];
    zero(s);
    zero(part);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      float a[4];
      uint32_t ab[4], as[4];
      frag_a_rows(a, ks, PK, warp * 16, 8 * kk, lane);
      split4(a, ab, as);
#pragma unroll
      for (int j = 0; j < QJ; ++j) {
        const float2 f = frag_b_rows(qt, PB, 8 * j, 8 * kk, lane);
        mma_3x(part[j], ab, as, f.x, f.y);
      }
      if (kk % kFlushD == kFlushD - 1 || kk == KD - 1) flush(s, part);
    }
    // P^T (queries or keys past N: 0)
#pragma unroll
    for (int j = 0; j < QJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * (lane & 3) + (e & 1);
        float p = exp2f(fmaf(s[j][e], scale_log2, -lt[col]));
        if (q0 + col >= N || kr[e >> 1] >= N) p = 0.f;
        s[j][e] = p;
      }
    }
    // dV += P^T dO, the tile's 4 k-steps in one partial
    float pd[KD][4];
    zero(pd);
#pragma unroll
    for (int j = 0; j < QJ; ++j) {
      float a[4];
      uint32_t ab[4], as[4];
      frag_a_acc(a, s[j]);
      split4(a, ab, as);
#pragma unroll
      for (int dj = 0; dj < KD; ++dj) {
        const float2 f = frag_b_cols(dt, PB, 8 * j, 8 * dj, lane);
        mma_3x(pd[dj], ab, as, f.x, f.y);
      }
    }
    flush(dva, pd);
    // dP^T = V dO^T
    float dp[QJ][4];
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      float a[4];
      uint32_t ab[4], as[4];
      frag_a_rows(a, vs, PK, warp * 16, 8 * kk, lane);
      split4(a, ab, as);
#pragma unroll
      for (int j = 0; j < QJ; ++j) {
        const float2 f = frag_b_rows(dt, PB, 8 * j, 8 * kk, lane);
        mma_3x(part[j], ab, as, f.x, f.y);
      }
      if (kk % kFlushD == kFlushD - 1 || kk == KD - 1) flush(dp, part);
    }
    // dS^T = P^T o (dP^T - Di), written to the scratch (rows: keys below
    // N; columns: the queries of this tile); dK += dS^T Q in one partial
    zero(pd);
#pragma unroll
    for (int j = 0; j < QJ; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= dp[j][e] - dlt[col + (e & 1)];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (kr[r] < N) {
          *reinterpret_cast<float2*>(dsb + static_cast<long long>(kr[r]) * NP + q0 + col) =
              make_float2(s[j][2 * r], s[j][2 * r + 1]);
        }
      }
      float a[4];
      uint32_t ab[4], as[4];
      frag_a_acc(a, s[j]);
      split4(a, ab, as);
#pragma unroll
      for (int dj = 0; dj < KD; ++dj) {
        const float2 f = frag_b_cols(qt, PB, 8 * j, 8 * dj, lane);
        mma_3x(pd[dj], ab, as, f.x, f.y);
      }
    }
    flush(dka, pd);
    __syncthreads();   // these buffers are free for the copy two tiles on
  }
  const long long gbase = b * st.gb + h * st.gh;
  store_acc<DP>(dka, scale, dk + gbase, st.gn, k0 + warp * 16, N, D, vec, lane);
  store_acc<DP>(dva, 1.f, dv + gbase, st.gn, k0 + warp * 16, N, D, vec, lane);
}

// Shared memory of the dQ kernel: dS^T in two buffers [64 keys][32 + 4],
// then K in two [64][pitch_cols].
template <int DP>
constexpr int dq_smem_bytes() {
  return 2 * kDqK * ((kDqQ + 4) + pitch_cols<DP>()) * static_cast<int>(sizeof(float));
}

template <int DP>
__global__ void __launch_bounds__(2 * 32)
flash_bwd_dq_tf32x3_kernel(const float* __restrict__ k, const float* __restrict__ ds,
                           float* __restrict__ dq, int H, int N, int D, int NP,
                           BwdStrides st, float scale, int vec) {
  constexpr int kT = 64;
  constexpr int PS = kDqQ + 4;
  constexpr int PB = pitch_cols<DP>();
  constexpr int KD = DP / 8;
  extern __shared__ __align__(16) float smem_f[];
  float* dss = smem_f;
  float* ks = dss + 2 * kDqK * PS;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * kDqQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* kb = k + b * st.kb + h * st.kh;
  // dS^T's columns q0 .. q0 + 31, in rows of NP (the scratch is 16-byte
  // aligned and NP a multiple of 32): always 16-byte copies
  const float* dsb = ds + static_cast<long long>(bh) * N * NP + q0;
  const int n_tiles = (N + kDqK - 1) / kDqK;

  load_rows<kDqK, kDqQ, PS, kT>(dss, dsb, NP, 0, N, kDqQ, true);
  load_rows<kDqK, DP, PB, kT>(ks, kb, st.kn, 0, N, D, vec);
  cp_async_commit();
  float acc[KD][4], part[KD][4];
  zero(acc);
  zero(part);

#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_rows<kDqK, kDqQ, PS, kT>(dss + (buf ^ 1) * kDqK * PS, dsb, NP, (t + 1) * kDqK,
                                    N, kDqQ, true);
      load_rows<kDqK, DP, PB, kT>(ks + (buf ^ 1) * kDqK * PB, kb, st.kn, (t + 1) * kDqK,
                                  N, D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* st_ = dss + buf * kDqK * PS;
    const float* kt = ks + buf * kDqK * PB;
    // dQ += dS K over this tile's 64 keys (keys past N: zero rows of both)
#pragma unroll
    for (int kk = 0; kk < kDqK / 8; ++kk) {
      float a[4];
      uint32_t ab[4], as[4];
      frag_a_cols(a, st_, PS, warp * 16, 8 * kk, lane);
      split4(a, ab, as);
#pragma unroll
      for (int dj = 0; dj < KD; ++dj) {
        const float2 f = frag_b_cols(kt, PB, 8 * kk, 8 * dj, lane);
        mma_3x(part[dj], ab, as, f.x, f.y);
      }
      if (kk % kFlushN == kFlushN - 1) flush(acc, part);
    }
    __syncthreads();   // this buffer is free for the copy two tiles on
  }
  store_acc<DP>(acc, scale, dq + b * st.gb + h * st.gh, st.gn, q0 + warp * 16, N, D, vec,
                lane);
}

template <int DP, int NW>
cudaError_t launch_dkdv(const BwdArgs& a, float* ds, int NP, const BwdStrides& st,
                        float scale, bool vec, cudaStream_t stream) {
  constexpr int kSmem = dkdv_smem_bytes<DP, NW>();
  static int done[kMaxDevices];
  const cudaError_t err = allow_smem_once(flash_bwd_dkdv_tf32x3_kernel<DP, NW>, kSmem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.N + 16 * NW - 1) / (16 * NW));
  flash_bwd_dkdv_tf32x3_kernel<DP, NW><<<grid, 32 * NW, kSmem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), ds, a.H, a.N, a.D, NP, st,
      scale, scale * kLog2e, vec ? 1 : 0);
  return cudaGetLastError();
}

// The three launches. The dK/dV kernel's width by grid size: blocks of 4
// warps (64 keys) where they are at least as many as the SMs, else blocks
// of 2 (32 keys), twice as many (built for DP 64 and 72 only, the head
// dims of the port's small gradient grids: the classifiers, DPS); a
// function of the shape and the card's SM count, so a repeat gives the
// same bits.
template <int DP>
cudaError_t launch_bwd_dp(const BwdArgs& a, float* ds, int NP, const BwdStrides& st,
                          float scale, bool vec, cudaStream_t stream) {
  const int rows = a.B * a.H * a.N;
  flash_bwd_delta_fp32_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const float*>(a.o), static_cast<const float*>(a.dout), a.delta, a.H,
      a.N, a.D, st, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long blocks4 = static_cast<long long>(a.B) * a.H * ((a.N + 63) / 64);
  err = cudaSuccess;
  if constexpr (DP == 64 || DP == 72) {
    if (blocks4 < sm_count()) err = launch_dkdv<DP, 2>(a, ds, NP, st, scale, vec, stream);
    else err = launch_dkdv<DP, 4>(a, ds, NP, st, scale, vec, stream);
  } else {
    err = launch_dkdv<DP, 4>(a, ds, NP, st, scale, vec, stream);
  }
  if (err != cudaSuccess) return err;
  constexpr int kSmem = dq_smem_bytes<DP>();
  static int done[kMaxDevices];
  err = allow_smem_once(flash_bwd_dq_tf32x3_kernel<DP>, kSmem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.N + kDqQ - 1) / kDqQ);
  flash_bwd_dq_tf32x3_kernel<DP><<<grid, 64, kSmem, stream>>>(
      static_cast<const float*>(a.k), ds, static_cast<float*>(a.dq), a.H, a.N, a.D, NP,
      st, scale, vec ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// fp32 q, k, v, o; strides are in elements; the last (D) axis of every
// tensor must be contiguous. lse: null, or an fp32 (B, H, N) tensor that
// receives the row log-sum-exp. Returns a cudaError_t.
extern "C" int rgm_flash_attention_fp32_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int N, int D, long long sqb, long long sqn, long long sqh,
    long long skb, long long skn, long long skh, long long svb, long long svn,
    long long svh, long long sob, long long son, long long soh, float scale,
    void* stream) {
  if (B < 1 || H < 1 || N < 1 || D < 1 || D > kMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides st{sqb, sqn, sqh, skb, skn, skh, svb, svn, svh, sob, son, soh};
  const bool vec = vec_ok(D, {q, k, v, o}, {sqb, sqn, sqh, skb, skn, skh, svb, svn, svh,
                                            sob, son, soh});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_dp(D, [&](auto dp) {
    return launch_fwd_dp<decltype(dp)::value>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse),
        B, H, N, D, st, scale, vec, s);
  }));
}

// The gradient of the forward above: q, k, v (strided as there), o and dout
// (the forward's output and its cotangent), lse (fp32 (B, H, N), from the
// forward); scratch: delta (fp32 (B, H, N)) and ds (fp32 (B*H, N, NP), NP =
// N rounded up to a multiple of 32, 16-byte aligned); dq, dk, dv
// (contiguous (B, N, H, D), written). Three launches on `stream`. Returns a
// cudaError_t.
extern "C" int rgm_flash_attention_fp32_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* ds, void* dq, void* dk,
    void* dv, int B, int H, int N, int D, long long sqb, long long sqn,
    long long sqh, long long skb, long long skn, long long skh, long long svb,
    long long svn, long long svh, long long sob, long long son, long long soh,
    long long sdb, long long sdn, long long sdh, float scale, void* stream) {
  if (B < 1 || H < 1 || N < 1 || D < 1 || D > kMaxD || lse == nullptr ||
      delta == nullptr || ds == nullptr || !aligned16(ds)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int NP = (N + 31) / 32 * 32;
  const long long gh = D;
  const long long gn = static_cast<long long>(H) * D;
  const long long gb = gn * N;
  const BwdStrides st{sqb, sqn, sqh, skb, skn, skh, svb, svn, svh,
                      sob, son, soh, sdb, sdn, sdh, gb, gn, gh};
  const BwdArgs a{q, k, v, o, dout, static_cast<const float*>(lse),
                  static_cast<float*>(delta), dq, dk, dv, B, H, N, D};
  const bool vec = vec_ok(D, {q, k, v, o, dout, dq, dk, dv},
                          {sqb, sqn, sqh, skb, skn, skh, svb, svn, svh, sob, son, soh,
                           sdb, sdn, sdh, gb, gn, gh});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_dp(D, [&](auto dp) {
    return launch_bwd_dp<decltype(dp)::value>(a, static_cast<float*>(ds), NP, st, scale,
                                              vec, s);
  }));
}
