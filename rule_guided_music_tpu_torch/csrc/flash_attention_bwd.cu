// Flash-attention backward in bf16 for Hopper (sm_90a), plain C interface.
//
// The backward (`rgm_flash_attention_bwd`): the exact gradient of kernel 1
// (flash_attention.cu), dQ, dK and dV. The Pallas kernel has no backward
// (the JAX package differentiates the XLA formulation); the kernels below
// take the place of that VJP on the card. What bounds it: it reads q, k,
// v, o, dO and writes dq, dk, dv (8 N D bf16 values per (batch, head)) for
// five products, 10 N^2 D operations, about 120 operations per byte at N =
// 256, D = 72: under the ridge, so device memory is the floor, and the time
// goes to the tensor-core instructions and to waiting on loads unless both
// are kept busy. No atomics anywhere: the gradient is the same from run to
// run (a trainer's resume relies on it).
//   N <= 512, by grid size: `flash_bwd_cluster_bf16_kernel<DP, NW>`, one
//   thread-block cluster per (batch, head) of NW-warp blocks, 16 keys a
//   warp (NW = 4: T = ceil(N / 64) blocks, at most 8, the portable size;
//   NW = 8: ceil(N / 128)):
//     - block r keeps its keys' K and V in shared memory and walks the
//       64-query tiles, Q and dO double-buffered by cp.async so the next
//       tile's copy overlaps this tile's math: S^T = K Q^T, P^T from the
//       recorded LSE, dV += P^T dO, dP^T = V dO^T, dS^T = P^T o (dP^T -
//       Di), dK += dS^T Q. Each product is done once (the two-kernel
//       split recomputed S and dP for dQ: seven products);
//     - Di = rowsum(dO o O) of the queries block r owns is taken once, by
//       block r, and read by the others through distributed shared memory,
//       a tile ahead, as LSE is from device memory;
//     - block r stores dS^T of query tile t (bf16, as it enters dK's
//       product) into the shared memory of t's owner: stores, which do not
//       stall, where a pull after the loop would wait on each tile. After one
//       cluster barrier, block r takes the dQ of its queries = sum over r'
//       in rank order of dS_{r,r'} K_r' from its own slots (ldmatrix.trans
//       turns dS^T into dS's A fragments), the other blocks' K brought by
//       cp.async into a ring of slots (the free Q and dO buffers) while
//       the barrier completes and dK and dV are written;
//     - NW: two 4-warp blocks fit on an SM (255 registers a thread, 105 KB
//       of shared memory at D = 72, N = 256), but two on one SM take about
//       twice as long as one; clusters of four such blocks must share a
//       GPC. 8-warp blocks (one an SM, clusters of two at N = 256; built
//       for D 49-80 only) share each Q and dO tile between 8 warps.
//       `launch_bwd_bf16_pick` takes 4-warp blocks for grids of at most
//       half the SMs, 8-warp blocks past the SMs, and the two-kernel path
//       between (see there). Both widths sum in the same order
//       (tests/test_torch_gpu.py holds their bits equal).
//   What still bounds it: mma.sync's issue rate (well under the tensor
//   cores' peak) and each block's serial start (its first loads, Di, the
//   first cluster barrier); wgmma with TMA is the next step.
//   Where the cluster kernel loses (DPS's B=2, ragged N past the SMs,
//   D outside 49-80 past the SMs) or does not fit (N > 512): two
//   launches. A dQ kernel per 64-query tile (Di = rowsum(dO o O) in its
//   prologue, written to device memory; P recomputed from LSE, dP = dO V^T,
//   dS = P o (dP - Di), dQ += dS K), then a dK/dV kernel per 64-key tile
//   (K and V resident, Q, dO, LSE and Di double-buffered).
//   Every product on mma.sync m16n8k16 with fp32 accumulation; P and
//   dS are rounded to bf16 only where they enter an mma (P for dV, dS for
//   dQ and dK), as P is in the forward; D is zero-padded to DP as there.
//
// The fp32 backward is in csrc/flash_attention_fp32.cu.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_bwd.so flash_attention_bwd.cu

#include <cooperative_groups.h>

#include <initializer_list>

#include "flash_attention_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

// ldmatrix addresses in a [rows][P] bf16 tile. A (16 x 16) at (row0, col0);
// B non-transposed from a [n][k] tile: n-tiles n0/8 and n0/8 + 1 at k-step
// k0 (r[0], r[1] and r[2], r[3]); B transposed from a [k][n] tile, the same
// two n-tiles from k-step k0.
template <int P>
__device__ __forceinline__ void ldsm_a(uint32_t (&r)[4], const bf16* t,
                                       int row0, int col0, int lane) {
  ldmatrix_x4(r, smem_addr(t + (row0 + (lane & 15)) * P + col0 + (lane >> 4) * 8));
}
template <int P>
__device__ __forceinline__ void ldsm_b(uint32_t (&r)[4], const bf16* t, int n0,
                                       int k0, int lane) {
  ldmatrix_x4(r, smem_addr(t + (n0 + (lane >> 4) * 8 + (lane & 7)) * P + k0
                           + ((lane >> 3) & 1) * 8));
}
template <int P>
__device__ __forceinline__ void ldsm_bt(uint32_t (&r)[4], const bf16* t, int k0,
                                        int n0, int lane) {
  ldmatrix_x4_trans(r, smem_addr(t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P
                                 + n0 + (lane >> 4) * 8));
}

// The warp's 16 rows of an accumulator times `mul`, rounded to bf16 and
// staged in `stage` (the warp's own 16 rows of a tile), stored to rows
// [row0, row0 + 16) of `dst` below N and D.
template <int DP>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 8][4],
                                           float mul, bf16* stage, bf16* dst,
                                           long long row_stride, int row0,
                                           int N, int D, int vec, int lane) {
  constexpr int P = DP + 8;
  constexpr int ND = DP / 8;
  const int g = lane >> 2;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int col = j * 8 + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(stage + g * P + col) =
        pack_bf16(acc[j][0] * mul, acc[j][1] * mul);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * P + col) =
        pack_bf16(acc[j][2] * mul, acc[j][3] * mul);
  }
  __syncwarp();
  if (vec) {
    for (int idx = lane; idx < 16 * ND; idx += 32) {
      const int r = idx / ND;
      const int c = idx - r * ND;
      if (row0 + r < N && c * 8 < D) {
        *reinterpret_cast<uint4*>(dst + (row0 + r) * row_stride + c * 8) =
            *reinterpret_cast<const uint4*>(stage + r * P + c * 8);
      }
    }
  } else {
    for (int idx = lane; idx < 16 * DP; idx += 32) {
      const int r = idx / DP;
      const int d = idx - r * DP;
      if (row0 + r < N && d < D) dst[(row0 + r) * row_stride + d] = stage[r * P + d];
    }
  }
}

// dQ: one block per (batch*head, 64-query tile), each warp 16 query rows.
// Shared memory: Q, dO, then K and V in two buffers each (K's second
// buffer holds O while Di is taken), every tile [64][DP + 8]; then Di of
// the block's 64 rows.
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ o,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse, float* __restrict__ delta,
                         bf16* __restrict__ dq, int H, int N, int D,
                         BwdStrides st, float scale, float scale_log2, int vec) {
  constexpr int P = DP + 8;
  constexpr int kTileElems = kTile * P;
  constexpr int KD = DP / 16;
  constexpr int ND = DP / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kTileElems;
  bf16* ks = dos + kTileElems;
  bf16* vs = ks + 2 * kTileElems;
  float* drow = reinterpret_cast<float*>(vs + 2 * kTileElems);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bf16* kb = k + b * st.kb + h * st.kh;
  const bf16* vb = v + b * st.vb + h * st.vh;
  const int n_tiles = (N + kTile - 1) / kTile;

  load_tile<DP>(qs, q + b * st.qb + h * st.qh, st.qn, q0, N, D, vec);
  load_tile<DP>(dos, dout + b * st.db + h * st.dh, st.dn, q0, N, D, vec);
  load_tile<DP>(ks + kTileElems, o + b * st.ob + h * st.oh, st.on, q0, N, D, vec);
  load_tile<DP>(ks, kb, st.kn, 0, N, D, vec);
  load_tile<DP>(vs, vb, st.vn, 0, N, D, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  {  // Di = rowsum(dO o O) in fp32: two lanes per row of the warp's 16
    const int r = warp * 16 + (lane >> 1);
    const int c0 = (lane & 1) * (DP / 2);
    const bf16* os = ks + kTileElems;
    float acc = 0.f;
#pragma unroll 8
    for (int c = c0; c < c0 + DP / 2; ++c) {
      acc = fmaf(__bfloat162float(dos[r * P + c]), __bfloat162float(os[r * P + c]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((lane & 1) == 0) {
      drow[r] = acc;
      if (q0 + r < N) delta[bh * N + q0 + r] = acc;
    }
  }
  __syncthreads();   // Di complete; O's buffer is free for the next K tile
  // this thread's rows lane / 4 and lane / 4 + 8: LSE in log2 units, Di
  const int g = lane >> 2;
  float lse2[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    lse2[r] = row < N ? lse[bh * N + row] * kLog2e : 0.f;
    di[r] = drow[warp * 16 + g + 8 * r];
  }
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_tile<DP>(ks + (buf ^ 1) * kTileElems, kb, st.kn, (t + 1) * kTile, N, D, vec);
      load_tile<DP>(vs + (buf ^ 1) * kTileElems, vb, st.vn, (t + 1) * kTile, N, D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + buf * kTileElems;
    const bf16* vt = vs + buf * kTileElems;

    // S = Q K^T and dP = dO V^T: 16 rows by 64 keys each
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], da[4];
      ldsm_a<P>(qa, qs, warp * 16, kk * 16, lane);
      ldsm_a<P>(da, dos, warp * 16, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t f[4];
        ldsm_b<P>(f, kt, j * 16, kk * 16, lane);
        mma_16816(s[2 * j], qa, f[0], f[1]);
        mma_16816(s[2 * j + 1], qa, f[2], f[3]);
        ldsm_b<P>(f, vt, j * 16, kk * 16, lane);
        mma_16816(dp[2 * j], da, f[0], f[1]);
        mma_16816(dp[2 * j + 1], da, f[2], f[3]);
      }
    }
    // P from the recorded LSE (keys past N: 0); dS = P o (dP - Di),
    // rounded to bf16 as the A fragments of dS K
    const int k0 = t * kTile;
    const bool ragged = k0 + kTile > N;
    uint32_t dsa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[j][e], scale_log2, -lse2[e >> 1]));
        if (ragged && k0 + 8 * j + 2 * (lane & 3) + (e & 1) >= N) p = 0.f;
        s[j][e] = p * (dp[j][e] - di[e >> 1]);
      }
      dsa[j >> 1][(j & 1) * 2] = pack_bf16(s[j][0], s[j][1]);
      dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[j][2], s[j][3]);
    }
    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dj = 0; dj < DP / 16; ++dj) {
        uint32_t f[4];
        ldsm_bt<P>(f, kt, kk * 16, dj * 16, lane);
        mma_16816(acc[2 * dj], dsa[kk], f[0], f[1]);
        mma_16816(acc[2 * dj + 1], dsa[kk], f[2], f[3]);
      }
    }
    __syncthreads();   // this buffer is free for the copy two tiles on
  }
  store_rows<DP>(acc, scale, qs + warp * 16 * P, dq + b * st.gb + h * st.gh,
                 st.gn, q0 + warp * 16, N, D, vec, lane);
}

// dK, dV: one block per (batch*head, 64-key tile), each warp 16 keys; K and
// V resident, Q and dO double-buffered, with LSE (log2 units) and D of the
// tile's queries. Shared memory: K, V, Q x 2, dO x 2, then LSE x 2, D x 2.
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                           int N, int D, BwdStrides st, float scale,
                           float scale_log2, int vec) {
  constexpr int P = DP + 8;
  constexpr int kTileElems = kTile * P;
  constexpr int KD = DP / 16;
  constexpr int ND = DP / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kTileElems;
  bf16* qs = vs + kTileElems;
  bf16* dos = qs + 2 * kTileElems;
  float* ls = reinterpret_cast<float*>(dos + 2 * kTileElems);
  float* dls = ls + 2 * kTile;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bf16* qb = q + b * st.qb + h * st.qh;
  const bf16* db = dout + b * st.db + h * st.dh;
  const float* lb = lse + bh * N;
  const float* deb = delta + bh * N;
  const int n_tiles = (N + kTile - 1) / kTile;

  load_tile<DP>(ks, k + b * st.kb + h * st.kh, st.kn, k0, N, D, vec);
  load_tile<DP>(vs, v + b * st.vb + h * st.vh, st.vn, k0, N, D, vec);
  load_tile<DP>(qs, qb, st.qn, 0, N, D, vec);
  load_tile<DP>(dos, db, st.dn, 0, N, D, vec);
  cp_async_commit();
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    ls[i] = i < N ? lb[i] * kLog2e : 0.f;
    dls[i] = i < N ? deb[i] : 0.f;
  }
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  }

#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {   // the next query tile's copy overlaps this one's math
      const int q1 = (t + 1) * kTile;
      load_tile<DP>(qs + (buf ^ 1) * kTileElems, qb, st.qn, q1, N, D, vec);
      load_tile<DP>(dos + (buf ^ 1) * kTileElems, db, st.dn, q1, N, D, vec);
      cp_async_commit();
      for (int i = threadIdx.x; i < kTile; i += kThreads) {
        ls[(buf ^ 1) * kTile + i] = q1 + i < N ? lb[q1 + i] * kLog2e : 0.f;
        dls[(buf ^ 1) * kTile + i] = q1 + i < N ? deb[q1 + i] : 0.f;
      }
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qt = qs + buf * kTileElems;
    const bf16* dt = dos + buf * kTileElems;
    const float* lt = ls + buf * kTile;
    const float* dlt = dls + buf * kTile;
    const int q0 = t * kTile;
    const bool ragged = q0 + kTile > N;

    // S^T = K Q^T: this warp's 16 keys by 64 queries
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4];
      ldsm_a<P>(ka, ks, warp * 16, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t f[4];
        ldsm_b<P>(f, qt, j * 16, kk * 16, lane);
        mma_16816(s[2 * j], ka, f[0], f[1]);
        mma_16816(s[2 * j + 1], ka, f[2], f[3]);
      }
    }
    // P^T (queries past N: 0), rounded to bf16 as the A fragments of P^T dO
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * (lane & 3) + (e & 1);
        float p = exp2f(fmaf(s[j][e], scale_log2, -lt[col]));
        if (ragged && q0 + col >= N) p = 0.f;
        s[j][e] = p;
      }
      pa[j >> 1][(j & 1) * 2] = pack_bf16(s[j][0], s[j][1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[j][2], s[j][3]);
    }
    // dV += P^T dO
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dj = 0; dj < DP / 16; ++dj) {
        uint32_t f[4];
        ldsm_bt<P>(f, dt, kk * 16, dj * 16, lane);
        mma_16816(dva[2 * dj], pa[kk], f[0], f[1]);
        mma_16816(dva[2 * dj + 1], pa[kk], f[2], f[3]);
      }
    }
    // dP^T = V dO^T; dS^T = P^T o (dP^T - D), rounded to bf16 for dS^T Q
    float dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t va[4];
      ldsm_a<P>(va, vs, warp * 16, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t f[4];
        ldsm_b<P>(f, dt, j * 16, kk * 16, lane);
        mma_16816(dp[2 * j], va, f[0], f[1]);
        mma_16816(dp[2 * j + 1], va, f[2], f[3]);
      }
    }
    uint32_t dsa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= dp[j][e] - dlt[8 * j + 2 * (lane & 3) + (e & 1)];
      }
      dsa[j >> 1][(j & 1) * 2] = pack_bf16(s[j][0], s[j][1]);
      dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[j][2], s[j][3]);
    }
    // dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dj = 0; dj < DP / 16; ++dj) {
        uint32_t f[4];
        ldsm_bt<P>(f, qt, kk * 16, dj * 16, lane);
        mma_16816(dka[2 * dj], dsa[kk], f[0], f[1]);
        mma_16816(dka[2 * dj + 1], dsa[kk], f[2], f[3]);
      }
    }
    __syncthreads();   // these buffers are free for the copy two tiles on
  }
  // K's and V's rows of this warp are read by no other warp: stage there
  const long long gbase = b * st.gb + h * st.gh;
  store_rows<DP>(dka, scale, ks + warp * 16 * P, dk + gbase, st.gn,
                 k0 + warp * 16, N, D, vec, lane);
  store_rows<DP>(dva, 1.f, vs + warp * 16 * P, dv + gbase, st.gn,
                 k0 + warp * 16, N, D, vec, lane);
}

// The split phases of the cluster barrier: arrive, then wait later.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

constexpr int kMaxClusterBlocks = 8;        // the portable cluster size
constexpr int kMaxClusterKeys = 512;        // N <= 512 in the cluster kernel
constexpr int kMaxSmem = 227 * 1024;
constexpr int kDsPitch = kTile + 8;         // a dS^T slot: [16 NW keys][64 queries + 8]

// until at most `pending` (0-3) of this thread's copy groups are in flight
__device__ __forceinline__ void cp_async_wait_n(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// Elements of the cluster kernel's dS^T slots (NW / 4 per block of the
// cluster: one per query tile the block owns, 16 NW keys each), which hold
// O and dO of the block's 16 NW queries while it takes Di
template <int DP, int NW>
__host__ __device__ constexpr int cluster_dss_elems(int blocks) {
  return (NW / 4) * blocks * 16 * NW * kDsPitch > 2 * 16 * NW * (DP + 8)
             ? (NW / 4) * blocks * 16 * NW * kDsPitch
             : 2 * 16 * NW * (DP + 8);
}

// Shared memory of the cluster kernel, in bytes: K and V ([16 NW][DP + 8]
// each), Q x 2 and dO x 2 ([64][DP + 8] each), the dS^T slots, then LSE x
// 2, Di x 2 (64 each) and this block's Di (16 NW).
template <int DP, int NW>
constexpr int cluster_smem_bytes(int blocks) {
  return (2 * 16 * NW * (DP + 8) + 4 * kTile * (DP + 8) + cluster_dss_elems<DP, NW>(blocks)) *
             static_cast<int>(sizeof(bf16)) +
         (4 * kTile + 16 * NW) * static_cast<int>(sizeof(float));
}

// One thread-block cluster per (batch, head), T = ceil(N / 16 NW) blocks
// of NW warps (4 or 8); block r owns keys [16 NW r, 16 NW (r + 1)) and the
// NW / 4 query tiles from NW r / 4 (64 queries each), each warp 16 keys
// and, for dQ, 16 queries. Block r keeps K_r and V_r resident and walks the query tiles t
// (Q_t and dO_t double-buffered by cp.async; LSE_t from device memory and
// Di_t from its owner's shared memory, a tile ahead in registers): S^T =
// K_r Q_t^T, P^T, dV += P^T dO_t, dP^T = V_r dO_t^T, dS^T = P^T o (dP^T -
// Di_t), dK += dS^T Q_t; it stores dS^T (bf16, as it enters dK's product)
// into the owner of tile t (block t / (NW / 4)), slot (r, t % (NW / 4)), through
// distributed shared memory: stores, which do not stall. After one cluster
// barrier (the only one after the start), block r takes the dQ of its
// queries = sum over r' = 0 .. T-1, in rank order, of dS_{r, r'} K_r' from
// its own slots (ldmatrix.trans turns dS^T into dS's A fragments) and the
// other blocks' K, which cp.async brought into the free Q and dO buffers
// while the barrier completed. Five products, each done once; no atomics,
// so the gradient is the same from run to run.
template <int DP, int NW>
__global__ void __launch_bounds__(32 * NW)
flash_bwd_cluster_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ o,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse, bf16* __restrict__ dq,
                              bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                              int N, int D, BwdStrides st, float scale,
                              float scale_log2, int vec) {
  constexpr int kCThreads = 32 * NW;
  constexpr int kCKeys = 16 * NW;           // keys of a block
  constexpr int kOwn = NW / 4;              // query tiles a block owns
  constexpr int kRing = 4 / kOwn;           // K slots of the dQ phase
  constexpr int P = DP + 8;
  constexpr int kTileElems = kTile * P;     // 64 rows
  constexpr int kKeyElems = kCKeys * P;
  constexpr int kSlotElems = kCKeys * kDsPitch;
  constexpr int KD = DP / 16;
  constexpr int ND = DP / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int T = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kKeyElems;
  bf16* qs = vs + kKeyElems;
  bf16* dos = qs + 2 * kTileElems;
  bf16* dss = dos + 2 * kTileElems;   // slot (r', h): dS^T of block r' for query tile kOwn r + h
  float* ls = reinterpret_cast<float*>(dss + cluster_dss_elems<DP, NW>(T));
  float* dls = ls + 2 * kTile;
  float* di_own = dls + 2 * kTile;

  const int bh = blockIdx.x / T;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = r * kCKeys;
  const int n_tiles = (N + kTile - 1) / kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bf16* qb = q + b * st.qb + h * st.qh;
  const bf16* kb = k + b * st.kb + h * st.kh;
  const bf16* db = dout + b * st.db + h * st.dh;
  const float* lb = lse + static_cast<long long>(bh) * N;

  // 1. O and dO of this block's 16 NW queries, for Di (4 warps: into the
  // second Q and dO buffers; 8 warps: into the still unused slots); then
  // K_r, V_r and the first query tile; LSE_0 meanwhile
  const bf16* ob = o + b * st.ob + h * st.oh;
  const bf16* vb = v + b * st.vb + h * st.vh;
  bf16* os_r = kOwn == 1 ? qs + kTileElems : dss;
  bf16* dos_r = kOwn == 1 ? dos + kTileElems : dss + kKeyElems;
#pragma unroll
  for (int part = 0; part < kOwn; ++part) {
    load_tile<DP, kCThreads>(os_r + part * kTileElems, ob, st.on, k0 + part * kTile, N, D, vec);
    load_tile<DP, kCThreads>(dos_r + part * kTileElems, db, st.dn, k0 + part * kTile, N, D, vec);
  }
  cp_async_commit();
#pragma unroll
  for (int part = 0; part < kOwn; ++part) {
    load_tile<DP, kCThreads>(ks + part * kTileElems, kb, st.kn, k0 + part * kTile, N, D, vec);
    load_tile<DP, kCThreads>(vs + part * kTileElems, vb, st.vn, k0 + part * kTile, N, D, vec);
  }
  load_tile<DP, kCThreads>(qs, qb, st.qn, 0, N, D, vec);
  load_tile<DP, kCThreads>(dos, db, st.dn, 0, N, D, vec);
  cp_async_commit();
  if (tid < kTile) ls[tid] = tid < N ? lb[tid] * kLog2e : 0.f;
  cp_async_wait<1>();
  __syncthreads();
  {  // Di = rowsum(dO o O) in fp32: two threads per row
    const int row = tid >> 1;
    const int c0 = (tid & 1) * (DP / 2);
    float acc = 0.f;
#pragma unroll 8
    for (int c = c0; c < c0 + DP / 2; ++c) {
      acc = fmaf(__bfloat162float(dos_r[row * P + c]), __bfloat162float(os_r[row * P + c]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) di_own[row] = acc;
  }
  __syncthreads();    // O's and dO's buffers are free
  cluster_arrive();   // this block's Di is published; it has started
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  }
  cp_async_wait<0>();

  // 2. the query tiles
  const int g = lane >> 2;
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    float l_next = 0.f, d_next = 0.f;
    if (t + 1 < n_tiles) {   // the next query tile's copy overlaps this one's math
      const int q1 = (t + 1) * kTile;
      load_tile<DP, kCThreads>(qs + (buf ^ 1) * kTileElems, qb, st.qn, q1, N, D, vec);
      load_tile<DP, kCThreads>(dos + (buf ^ 1) * kTileElems, db, st.dn, q1, N, D, vec);
      cp_async_commit();
      if (tid < kTile) l_next = q1 + tid < N ? lb[q1 + tid] * kLog2e : 0.f;
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qt = qs + buf * kTileElems;
    const bf16* dt = dos + buf * kTileElems;
    const float* lt = ls + buf * kTile;
    const float* dlt = dls + buf * kTile;
    const int q0 = t * kTile;
    const bool ragged = q0 + kTile > N;

    // S^T = K Q^T: this warp's 16 keys by 64 queries
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4];
      ldsm_a<P>(ka, ks, warp * 16, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t f[4];
        ldsm_b<P>(f, qt, j * 16, kk * 16, lane);
        mma_16816(s[2 * j], ka, f[0], f[1]);
        mma_16816(s[2 * j + 1], ka, f[2], f[3]);
      }
    }
    // P^T (queries past N: 0), rounded to bf16 as the A fragments of P^T dO
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * (lane & 3) + (e & 1);
        float p = exp2f(fmaf(s[j][e], scale_log2, -lt[col]));
        if (ragged && q0 + col >= N) p = 0.f;
        s[j][e] = p;
      }
      pa[j >> 1][(j & 1) * 2] = pack_bf16(s[j][0], s[j][1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[j][2], s[j][3]);
    }
    // dV += P^T dO
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dj = 0; dj < DP / 16; ++dj) {
        uint32_t f[4];
        ldsm_bt<P>(f, dt, kk * 16, dj * 16, lane);
        mma_16816(dva[2 * dj], pa[kk], f[0], f[1]);
        mma_16816(dva[2 * dj + 1], pa[kk], f[2], f[3]);
      }
    }
    // dP^T = V dO^T; dS^T = P^T o (dP^T - Di), rounded to bf16 for dS^T Q
    // and stored into the owner of these queries
    float dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t va[4];
      ldsm_a<P>(va, vs, warp * 16, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t f[4];
        ldsm_b<P>(f, dt, j * 16, kk * 16, lane);
        mma_16816(dp[2 * j], va, f[0], f[1]);
        mma_16816(dp[2 * j + 1], va, f[2], f[3]);
      }
    }
    if (t == 0) {   // Di_0: the barrier's wait overlaps the first products
      cluster_wait();   // every block has started and published its Di
      if (tid < kTile) dls[tid] = cluster.map_shared_rank(di_own, 0)[tid];
      __syncthreads();
    }
    if (t + 1 < n_tiles && tid < kTile) {
      d_next = cluster.map_shared_rank(di_own, (t + 1) / kOwn)[((t + 1) % kOwn) * kTile + tid];
    }
    uint32_t dsa[4][4];
    bf16* dst = cluster.map_shared_rank(dss + (kOwn * r + t % kOwn) * kSlotElems, t / kOwn) +
                (warp * 16 + g) * kDsPitch + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= dp[j][e] - dlt[8 * j + 2 * (lane & 3) + (e & 1)];
      }
      dsa[j >> 1][(j & 1) * 2] = pack_bf16(s[j][0], s[j][1]);
      dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[j][2], s[j][3]);
      *reinterpret_cast<uint32_t*>(dst + 8 * j) = dsa[j >> 1][(j & 1) * 2];
      *reinterpret_cast<uint32_t*>(dst + 8 * kDsPitch + 8 * j) = dsa[j >> 1][(j & 1) * 2 + 1];
    }
    // dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dj = 0; dj < DP / 16; ++dj) {
        uint32_t f[4];
        ldsm_bt<P>(f, qt, kk * 16, dj * 16, lane);
        mma_16816(dka[2 * dj], dsa[kk], f[0], f[1]);
        mma_16816(dka[2 * dj + 1], dsa[kk], f[2], f[3]);
      }
    }
    if (t + 1 < n_tiles && tid < kTile) {   // landed by now
      ls[(buf ^ 1) * kTile + tid] = l_next;
      dls[(buf ^ 1) * kTile + tid] = d_next;
    }
    __syncthreads();   // these buffers are free for the copy two tiles on
  }
  cluster_arrive();   // this block's dS^T stores are done

  // 3. the other blocks' K, in rank order, into a ring of kRing slots (the
  // free Q and dO buffers) while the barrier completes; dK and dV of this
  // block's keys, staged in the warp's own rows of V
  const int n_remote = T - 1;                  // remote i is rank i + (i >= r)
  int issued = 0;
  for (; issued < n_remote && issued < kRing; ++issued) {
    const int kr = (issued + (issued >= r)) * kCKeys;
#pragma unroll
    for (int part = 0; part < kOwn; ++part) {
      load_tile<DP, kCThreads>(qs + (issued * kOwn + part) * kTileElems, kb, st.kn,
                               kr + part * kTile, N, D, vec);
    }
    cp_async_commit();
  }
  const long long gbase = b * st.gb + h * st.gh;
  bf16* stage = vs + warp * 16 * P;
  store_rows<DP>(dva, 1.f, stage, dv + gbase, st.gn, k0 + warp * 16, N, D, vec, lane);
  __syncwarp();
  store_rows<DP>(dka, scale, stage, dk + gbase, st.gn, k0 + warp * 16, N, D, vec, lane);

  // 4. dQ of this warp's 16 queries (tile kOwn r + half, rows qrow ..):
  // dS_{., r'} K_r' over r' in rank order
  const int half = warp >> 2;
  const int qrow = (warp & 3) * 16;
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  cluster_wait();   // every block's dS^T is in its owner's slots
#pragma unroll 1
  for (int rr = 0; rr < T; ++rr) {
    const bf16* kt = ks;
    const int i = rr - (rr > r);
    if (rr != r) {
      cp_async_wait_n(issued - 1 - i);
      __syncthreads();   // remote K i has landed for every thread
      kt = qs + (i % kRing) * kOwn * kTileElems;
    }
    const bf16* dsr = dss + (kOwn * rr + half) * kSlotElems;
#pragma unroll
    for (int kk = 0; kk < kCKeys / 16; ++kk) {
      uint32_t a[4];   // dS (16 queries x 16 keys) from dS^T by ldmatrix.trans
      ldmatrix_x4_trans(a, smem_addr(dsr + (kk * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * kDsPitch
                                     + qrow + ((lane >> 3) & 1) * 8));
#pragma unroll
      for (int dj = 0; dj < DP / 16; ++dj) {
        uint32_t f[4];
        ldsm_bt<P>(f, kt, kk * 16, dj * 16, lane);
        mma_16816(acc[2 * dj], a, f[0], f[1]);
        mma_16816(acc[2 * dj + 1], a, f[2], f[3]);
      }
    }
    if (rr != r && i + kRing < n_remote) {   // the ring slot takes remote K i + kRing
      __syncthreads();
      const int kr = (i + kRing + (i + kRing >= r)) * kCKeys;
#pragma unroll
      for (int part = 0; part < kOwn; ++part) {
        load_tile<DP, kCThreads>(qs + ((i % kRing) * kOwn + part) * kTileElems, kb, st.kn,
                                 kr + part * kTile, N, D, vec);
      }
      cp_async_commit();
      ++issued;
    }
  }
  __syncwarp();
  store_rows<DP>(acc, scale, stage, dq + gbase, st.gn, (kOwn * r + half) * kTile + qrow, N, D,
                 vec, lane);
  // no barrier: after the loop's, no block reads another's shared memory
}

template <int DP>
cudaError_t launch_bwd_bf16_dp(const BwdArgs& a, const BwdStrides& st,
                               float scale, bool vec, cudaStream_t stream) {
  constexpr int kTiles = 6 * kTile * (DP + 8) * static_cast<int>(sizeof(bf16));
  constexpr int kSmemDq = kTiles + kTile * static_cast<int>(sizeof(float));
  constexpr int kSmemDkdv = kTiles + 4 * kTile * static_cast<int>(sizeof(float));
  static int done_dq[kMaxDevices];
  static int done_dkdv[kMaxDevices];
  cudaError_t err = allow_smem_once(flash_bwd_dq_bf16_kernel<DP>, kSmemDq, done_dq);
  if (err != cudaSuccess) return err;
  err = allow_smem_once(flash_bwd_dkdv_bf16_kernel<DP>, kSmemDkdv, done_dkdv);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.N + kTile - 1) / kTile);
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const float scale_log2 = scale * kLog2e;
  flash_bwd_dq_bf16_kernel<DP><<<grid, kThreads, kSmemDq, stream>>>(
      q, k, v, static_cast<const bf16*>(a.o), dout, a.lse, a.delta,
      static_cast<bf16*>(a.dq), a.H, a.N, a.D, st, scale, scale_log2, vec ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_bf16_kernel<DP><<<grid, kThreads, kSmemDkdv, stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.H, a.N, a.D, st, scale, scale_log2, vec ? 1 : 0);
  return cudaGetLastError();
}


// Whether the cluster kernel of NW warps takes (N, DP): N <= 512, at most 8
// blocks, and its shared memory fits.
template <int DP, int NW>
bool cluster_fits(int N) {
  const int blocks = (N + 16 * NW - 1) / (16 * NW);
  return N <= kMaxClusterKeys && blocks <= kMaxClusterBlocks &&
         cluster_smem_bytes<DP, NW>(blocks) <= kMaxSmem;
}

template <int DP, int NW>
cudaError_t launch_bwd_cluster_dp(const BwdArgs& a, const BwdStrides& st,
                                  float scale, bool vec, cudaStream_t stream) {
  const int blocks = (a.N + 16 * NW - 1) / (16 * NW);
  auto kernel = flash_bwd_cluster_bf16_kernel<DP, NW>;
  static int done[kMaxDevices];
  cudaError_t err = allow_smem_once(kernel, kMaxSmem, done);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.B * a.H * blocks));
  cfg.blockDim = dim3(32 * NW);
  cfg.dynamicSmemBytes = cluster_smem_bytes<DP, NW>(blocks);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(a.q),
                           static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
                           static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout),
                           a.lse, static_cast<bf16*>(a.dq), static_cast<bf16*>(a.dk),
                           static_cast<bf16*>(a.dv), a.H, a.N, a.D, st, scale,
                           scale * kLog2e, vec ? 1 : 0);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Which bf16 backward runs: kRoutePick lets launch_bwd_bf16_pick choose
// by shape; the others ask for one (rgm_flash_attention_bwd_route, for the
// card tests that hold the routes against each other).
constexpr int kRoutePick = 0;
constexpr int kRoutePair = 1;         // the dQ and dK/dV kernels
constexpr int kRouteCluster4 = 4;     // the cluster kernel, 4-warp blocks
constexpr int kRouteCluster8 = 8;     // the cluster kernel, 8-warp blocks
int g_bwd_route = kRoutePick;

// bf16, by the grid's size against the SMs (chosen from tools/kernel_ab.py
// --backward runs of each route on the H100, PERF.md):
//   - at most half as many 4-warp blocks as SMs (the classifiers' B=2):
//     the cluster kernel of 4-warp blocks, short blocks, one an SM;
//   - more 4-warp blocks than SMs, with the last 8-warp block at least half
//     full (train_dit, the EDM ring): 8-warp blocks, one an SM, each Q and
//     dO tile shared by 8 warps; 4-warp blocks would share SMs two by two;
//   - between (DPS's B=2 at 128 such blocks: clusters of four must share a
//     GPC, so some SMs take two blocks, and one block an SM needs a second
//     wave) and where the last 8-warp block is nearly empty (N = 257 past
//     the SMs), the dQ and dK/dV kernels, whose blocks schedule one by one.
// 8-warp blocks are built only for DP 64 and 80 (head dims 64 and 72, the
// only ones a port path differentiates past the SMs): each width of each
// DP is a large instantiation, and the build is card time on every run.
// Elsewhere, and past N = 512, the dQ and dK/dV kernels. The route is a
// function of the shape and the card's SM count, so a trainer's repeat of
// a step on one card gives the same bits.
template <int DP>
cudaError_t launch_bwd_bf16_pick(const BwdArgs& a, const BwdStrides& st,
                                 float scale, bool vec, cudaStream_t stream) {
  int route = g_bwd_route;
  if (route == kRoutePick) {
    const long long blocks4 = static_cast<long long>(a.B) * a.H * ((a.N + kTile - 1) / kTile);
    const int tail8 = a.N % (2 * kTile);
    if (2 * blocks4 <= sm_count()) {
      route = kRouteCluster4;
    } else if (blocks4 > sm_count() && (tail8 == 0 || tail8 >= kTile)) {
      route = kRouteCluster8;
    } else {
      route = kRoutePair;
    }
  }
  if constexpr (DP == 64 || DP == 80) {
    if (route == kRouteCluster8 && cluster_fits<DP, 8>(a.N)) {
      return launch_bwd_cluster_dp<DP, 8>(a, st, scale, vec, stream);
    }
  }
  if (route == kRouteCluster4 && cluster_fits<DP, 4>(a.N)) {
    return launch_bwd_cluster_dp<DP, 4>(a, st, scale, vec, stream);
  }
  return launch_bwd_bf16_dp<DP>(a, st, scale, vec, stream);
}

cudaError_t launch_bwd_bf16(const BwdArgs& a, const BwdStrides& st, float scale,
                            cudaStream_t stream) {
  bool vec = a.D % 8 == 0;
  for (const void* p : {a.q, a.k, a.v, a.o, a.dout,
                        static_cast<const void*>(a.dq),
                        static_cast<const void*>(a.dk),
                        static_cast<const void*>(a.dv)}) {
    vec = vec && aligned16(p);
  }
  for (long long s : {st.qb, st.qn, st.qh, st.kb, st.kn, st.kh, st.vb, st.vn,
                      st.vh, st.ob, st.on, st.oh, st.db, st.dn, st.dh, st.gb,
                      st.gn, st.gh}) {
    vec = vec && s % 8 == 0;
  }
  switch ((a.D + 15) / 16) {
    case 1: return launch_bwd_bf16_pick<16>(a, st, scale, vec, stream);
    case 2: return launch_bwd_bf16_pick<32>(a, st, scale, vec, stream);
    case 3: return launch_bwd_bf16_pick<48>(a, st, scale, vec, stream);
    case 4: return launch_bwd_bf16_pick<64>(a, st, scale, vec, stream);
    case 5: return launch_bwd_bf16_pick<80>(a, st, scale, vec, stream);
    case 6: return launch_bwd_bf16_pick<96>(a, st, scale, vec, stream);
    case 7: return launch_bwd_bf16_pick<112>(a, st, scale, vec, stream);
    default: return launch_bwd_bf16_pick<128>(a, st, scale, vec, stream);
  }
}

}  // namespace

// The gradient of kernel 1's bf16 forward: q, k, v (strided as there), o
// and dout (the forward's output and its cotangent), lse (fp32 (B, H, N),
// from the forward), delta (fp32 (B, H, N) scratch, written by the dQ
// kernel), and dq, dk, dv (contiguous (B, N, H, D), written). One launch
// on `stream` (the cluster kernel) or two. Returns a cudaError_t.
extern "C" int rgm_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int N, int D, long long sqb, long long sqn,
    long long sqh, long long skb, long long skn, long long skh, long long svb,
    long long svn, long long svh, long long sob, long long son, long long soh,
    long long sdb, long long sdn, long long sdh, float scale, void* stream) {
  if (B < 1 || H < 1 || N < 1 || D < 1 || D > kMaxD || lse == nullptr ||
      delta == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long gh = D;
  const long long gn = static_cast<long long>(H) * D;
  const long long gb = gn * N;
  const BwdStrides st{sqb, sqn, sqh, skb, skn, skh, svb, svn, svh,
                      sob, son, soh, sdb, sdn, sdh, gb, gn, gh};
  const BwdArgs a{q, k, v, o, dout, static_cast<const float*>(lse),
                  static_cast<float*>(delta), dq, dk, dv, B, H, N, D};
  return static_cast<int>(launch_bwd_bf16(a, st, scale, static_cast<cudaStream_t>(stream)));
}

// Sets the bf16 backward's route for the calls that follow: 0 = by shape
// (the default), 1 = the dQ and dK/dV kernels, 4 or 8 = the cluster kernel
// with blocks of that many warps where it fits and is built, else the dQ
// and dK/dV kernels. For tests that hold the routes against each other;
// not thread-safe. Returns a cudaError_t.
extern "C" int rgm_flash_attention_bwd_route(int route) {
  if (route != kRoutePick && route != kRoutePair && route != kRouteCluster4 &&
      route != kRouteCluster8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  g_bwd_route = route;
  return static_cast<int>(cudaSuccess);
}
