// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel rule_guided_music_tpu/ops/pallas_attention.py
// (`flash_attention`, body `_flash_kernel`): non-causal softmax attention
// over (B, N, H, D) tensors, scale D^-0.5 on the true D, online softmax with
// fp32 running max, sum and accumulator, keys past N masked. The (N, N)
// scores never reach device memory, as the Pallas kernel keeps them out of
// HBM.
//
// Two kernels, chosen by dtype alone (the only dispatch, fixed here and not
// discovered at run time):
//
// * bfloat16 -> `flash_fwd_bf16_kernel`, on the tensor cores. What bounds
//   it: at the DiT shapes (N = 256, D = 72) a (batch, head) pair moves
//   4*N*D bf16 values and does 4*N*N*D operations, about 128 operations per
//   byte, under the ~295 at which the bf16 tensor cores would bind, so the
//   memory rate is the card's floor. The design (FlashAttention-2's shape)
//   keeps the instruction rate under that floor:
//     - one block per (batch*head, 64-query tile), four warps, each warp
//       owning 16 query rows; Q is loaded once and held in registers as
//       mma A-fragments (ldmatrix);
//     - K and V stream through shared memory in 64-key bf16 tiles, brought
//       in by 16-byte cp.async copies and double-buffered, so the next
//       tile's copy overlaps this tile's math;
//     - S = Q K^T by mma.sync m16n8k16 (bf16 in, fp32 accumulate); the
//       online softmax runs on the accumulator fragments (quad shuffles
//       for the row max; each thread's row sums are reduced once at the
//       end) and rescales the accumulator only when the max grows;
//     - P is rounded to bf16 in registers and reused directly as the A
//       operand of O += P V (ldmatrix.trans for V): P never touches shared
//       memory. O / l is staged through the warp's own Q rows in shared
//       memory and written as 16-byte rows.
//   D is zero-padded in shared memory to the next multiple of 16 (the mma
//   k-depth; 72 -> 80), and padded columns are never stored. The ragged
//   last key tile is zero-filled (its V rows too) and masked to -inf in S;
//   rows past N are never stored. Rows that are not 16-byte aligned (D not
//   a multiple of 8, odd strides) are loaded element by element into the
//   same shared layout. mma.sync rather than wgmma: below the ridge its
//   rate is many times what the memory floor needs, and it builds in
//   seconds; wgmma with TMA is the next step if instructions bound it.
//
// * float32 -> `flash_fwd_fp32_kernel`, the SIMT kernel: two threads per
//   query, keys one at a time with scalar fmaf on the fp32 pipes, K and V
//   in fp32 shared tiles of 32 keys. It stays for fp32 because the tensor
//   cores take fp32 only as TF32, whose 10-bit mantissa would break the
//   1e-4 agreement that fp32 callers (the card-versus-CPU checks) rely on.
//
// Where a gradient is wanted, both forwards also write the row log-sum-exp
// LSE = m + log(l) (natural log, fp32, (B, H, N)); inference passes a null
// pointer and writes nothing more.
//
// The backward (`rgm_flash_attention_bwd`): the exact gradient of the same
// function, dQ, dK and dV. The Pallas kernel has no backward (the JAX
// package differentiates the XLA formulation); the kernels below take the
// place of that VJP on the card. What bounds it: it reads q, k, v, o, dO
// and writes dq, dk, dv (8 N D bf16 values per (batch, head)) for five
// products, 10 N^2 D operations, about 120 operations per byte at N = 256,
// D = 72: under the ridge, so device memory is the floor, and the time
// goes to the tensor-core instructions and to waiting on loads unless
// both are kept busy. No atomics anywhere: the gradient is the same from
// run to run (a trainer's resume relies on it).
//   bf16, N <= 512, by grid size: `flash_bwd_cluster_bf16_kernel<DP, NW>`, one
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
//   bf16 where the cluster kernel loses (DPS's B=2, ragged N past the SMs,
//   D outside 49-80 past the SMs) or does not fit (N > 512), and fp32: two
//   launches. A dQ kernel per 64-query tile (Di = rowsum(dO o O) in its
//   prologue, written to device memory; P recomputed from LSE, dP = dO V^T,
//   dS = P o (dP - Di), dQ += dS K), then a dK/dV kernel per 64-key tile
//   (K and V resident, Q, dO, LSE and Di double-buffered).
//   bf16: every product on mma.sync m16n8k16 with fp32 accumulation; P and
//   dS are rounded to bf16 only where they enter an mma (P for dV, dS for
//   dQ and dK), as P is in the forward; D is zero-padded to DP as there.
//   fp32: the two-launch split on the SIMT pipes (fp32 FMA, no TF32), four
//   threads per row, for the fp32 card-versus-CPU checks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o librgm_flash_attention.so flash_attention.cu

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxD = 128;
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Raises `kernel`'s dynamic shared memory limit to `bytes` once per device
// (`done` is the caller's, one per kernel instantiation) rather than on
// every launch. A second thread racing here sets the same value again.
template <typename Kernel>
cudaError_t allow_smem_once(Kernel kernel, int bytes, int (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    done[dev] = 1;
  }
  return cudaSuccess;
}

struct Strides {
  long long qb, qn, qh, kb, kn, kh, vb, vn, vh, ob, on, oh;
};

// ---------------------------------------------------------------- fp32 ----

constexpr int kF32BlockQ = 64;               // queries per block
constexpr int kF32BlockK = 32;               // keys per shared-memory tile
constexpr int kF32Threads = 2 * kF32BlockQ;  // two threads per query
constexpr int kF32Pitch = kMaxD + 4;         // shared row pitch, float4-aligned

// HALF: register slots per thread, a multiple of 4, >= the half split of D.
template <int HALF>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int H, int N, int D, Strides st,
                      float scale) {
  __shared__ __align__(16) float ks[kF32BlockK][kF32Pitch];
  __shared__ __align__(16) float vs[kF32BlockK][kF32Pitch];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int tid = threadIdx.x;
  const int qi = blockIdx.y * kF32BlockQ + (tid >> 1);
  const int d_split = (((D + 1) >> 1) + 3) & ~3;   // multiple of 4
  const int d_pad = 2 * d_split;                   // padded row width
  const int d0 = (tid & 1) ? d_split : 0;
  const int nd = min(d_split, D - d0);             // may be <= 0
  const bool q_valid = qi < N;

  const float* qb = q + b * st.qb + h * st.qh;
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;

  float qr[HALF];
  float acc[HALF];
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    qr[i] = (q_valid && i < nd) ? qb[qi * st.qn + d0 + i] * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < N; k0 += kF32BlockK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < kF32BlockK * d_pad; idx += kF32Threads) {
      const int j = idx / d_pad;
      const int d = idx - j * d_pad;
      const int kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < N && d < D) {
        kv = kb[kj * st.kn + d];
        vv = vb[kj * st.vn + d];
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();

    const int kn = min(kF32BlockK, N - k0);   // the same for the whole block
#pragma unroll 1
    for (int j = 0; j < kn; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(&ks[j][d0]);
      float s = 0.f;
#pragma unroll
      for (int i4 = 0; i4 < HALF / 4; ++i4) {
        if (4 * i4 < nd) {
          const float4 kk = kr[i4];
          s = fmaf(qr[4 * i4 + 0], kk.x, s);
          s = fmaf(qr[4 * i4 + 1], kk.y, s);
          s = fmaf(qr[4 * i4 + 2], kk.z, s);
          s = fmaf(qr[4 * i4 + 3], kk.w, s);
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (s > m) {  // the max grows: rescale what was summed so far
        const float alpha = expf(m - s);   // 0 for the first key
        l *= alpha;
#pragma unroll
        for (int i = 0; i < HALF; ++i) acc[i] *= alpha;
        m = s;
      }
      const float p = expf(s - m);
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(&vs[j][d0]);
#pragma unroll
      for (int i4 = 0; i4 < HALF / 4; ++i4) {
        if (4 * i4 < nd) {
          const float4 vv = vr[i4];
          acc[4 * i4 + 0] = fmaf(p, vv.x, acc[4 * i4 + 0]);
          acc[4 * i4 + 1] = fmaf(p, vv.y, acc[4 * i4 + 1]);
          acc[4 * i4 + 2] = fmaf(p, vv.z, acc[4 * i4 + 2]);
          acc[4 * i4 + 3] = fmaf(p, vv.w, acc[4 * i4 + 3]);
        }
      }
    }
  }

  if (q_valid) {
    const float inv = 1.f / l;
    float* ob = o + b * st.ob + h * st.oh + qi * st.on + d0;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      if (i < nd) ob[i] = acc[i] * inv;
    }
    if (lse != nullptr && (tid & 1) == 0) lse[blockIdx.x * N + qi] = m + logf(l);
  }
}

cudaError_t launch_fp32(const float* q, const float* k, const float* v,
                        float* o, float* lse, int B, int H, int N, int D,
                        const Strides& st, float scale, cudaStream_t stream) {
  const dim3 grid(B * H, (N + kF32BlockQ - 1) / kF32BlockQ);
  const dim3 block(kF32Threads);
  const int d_split = (((D + 1) >> 1) + 3) & ~3;
  if (d_split <= 32) {
    flash_fwd_fp32_kernel<32><<<grid, block, 0, stream>>>(q, k, v, o, lse, H, N, D, st, scale);
  } else if (d_split <= 36) {
    flash_fwd_fp32_kernel<36><<<grid, block, 0, stream>>>(q, k, v, o, lse, H, N, D, st, scale);
  } else {
    flash_fwd_fp32_kernel<64><<<grid, block, 0, stream>>>(q, k, v, o, lse, H, N, D, st, scale);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 ----

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;       // queries per block = keys per tile
constexpr int kWarps = 4;       // 16 query rows each
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING));
}

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

// DP: D padded to a multiple of 16. Shared memory: Q, then K and V in two
// buffers each, every tile [64][DP + 8] (the pad keeps ldmatrix's eight row
// addresses on distinct banks).
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int H, int N, int D, Strides st,
                      float scale_log2, int vec) {
  constexpr int P = DP + 8;
  constexpr int kTileElems = kTile * P;
  constexpr int KD = DP / 16;   // k-steps of Q K^T
  constexpr int ND = DP / 8;    // n-tiles of P V
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kTileElems;
  bf16* vs = ks + 2 * kTileElems;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int q0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bf16* qb = q + b * st.qb + h * st.qh;
  const bf16* kb = k + b * st.kb + h * st.kh;
  const bf16* vb = v + b * st.vb + h * st.vh;
  const int n_tiles = (N + kTile - 1) / kTile;

  load_tile<DP>(qs, qb, st.qn, q0, N, D, vec);
  load_tile<DP>(ks, kb, st.kn, 0, N, D, vec);
  load_tile<DP>(vs, vb, st.vn, 0, N, D, vec);
  cp_async_commit();

  uint32_t qf[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // this thread's two rows: lane / 4 and lane / 4 + 8 of the warp's 16
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};   // this thread's share of the row sums

#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {   // the next tile's copy overlaps this tile's math
      load_tile<DP>(ks + (buf ^ 1) * kTileElems, kb, st.kn, (t + 1) * kTile, N, D, vec);
      load_tile<DP>(vs + (buf ^ 1) * kTileElems, vb, st.vn, (t + 1) * kTile, N, D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        ldmatrix_x4(qf[kk], smem_addr(qs + (warp * 16 + (lane & 15)) * P
                                      + kk * 16 + (lane >> 4) * 8));
      }
    }
    const bf16* kt = ks + buf * kTileElems;
    const bf16* vt = vs + buf * kTileElems;

    // S = Q K^T: this warp's 16 rows by 64 keys, eight n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t kf[4];
        ldmatrix_x4(kf, smem_addr(kt + (j * 16 + (lane >> 4) * 8 + (lane & 7)) * P
                                  + kk * 16 + ((lane >> 3) & 1) * 8));
        mma_16816(s[2 * j], qf[kk], kf[0], kf[1]);
        mma_16816(s[2 * j + 1], qf[kk], kf[2], kf[3]);
      }
    }
    const int k0 = t * kTile;
    if (k0 + kTile > N) {   // the ragged last tile: keys past N to -inf
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
        for (int j = 0; j < ND; ++j) {
          acc[j][2 * r] *= alpha;
          acc[j][2 * r + 1] *= alpha;
        }
        m[r] = m_new;
      }
    }
    // P = exp2(S * scale * log2(e) - m), rounded to bf16 as the A fragments
    // of P V: the n-tiles 2kk and 2kk + 1 of S form k-step kk
    uint32_t pf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2f(fmaf(s[j][0], scale_log2, -m[0]));
      const float p1 = exp2f(fmaf(s[j][1], scale_log2, -m[0]));
      const float p2 = exp2f(fmaf(s[j][2], scale_log2, -m[1]));
      const float p3 = exp2f(fmaf(s[j][3], scale_log2, -m[1]));
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    // O += P V
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dj = 0; dj < DP / 16; ++dj) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_addr(vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P
                                        + dj * 16 + (lane >> 4) * 8));
        mma_16816(acc[2 * dj], pf[kk], vf[0], vf[1]);
        mma_16816(acc[2 * dj + 1], pf[kk], vf[2], vf[3]);
      }
    }
    __syncthreads();   // this buffer is free for the copy two tiles on
  }

  // O / l in bf16, staged in this warp's own 16 rows of the Q tile
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  const int g = lane >> 2;
  if (lse != nullptr && (lane & 3) == 0) {   // m is in log2 units
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + 8 * r;
      if (row < N) lse[blockIdx.x * N + row] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
  bf16* os = qs + warp * 16 * P;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int col = j * 8 + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(os + g * P + col) =
        pack_bf16(acc[j][0] * inv[0], acc[j][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * P + col) =
        pack_bf16(acc[j][2] * inv[1], acc[j][3] * inv[1]);
  }
  __syncwarp();
  bf16* ob = o + b * st.ob + h * st.oh;
  const int row0 = q0 + warp * 16;
  if (vec) {
    for (int idx = lane; idx < 16 * ND; idx += 32) {
      const int r = idx / ND;
      const int c = idx - r * ND;
      if (row0 + r < N && c * 8 < D) {
        *reinterpret_cast<uint4*>(ob + (row0 + r) * st.on + c * 8) =
            *reinterpret_cast<const uint4*>(os + r * P + c * 8);
      }
    }
  } else {
    for (int idx = lane; idx < 16 * DP; idx += 32) {
      const int r = idx / DP;
      const int d = idx - r * DP;
      if (row0 + r < N && d < D) ob[(row0 + r) * st.on + d] = os[r * P + d];
    }
  }
}

template <int DP>
cudaError_t launch_bf16_dp(const bf16* q, const bf16* k, const bf16* v,
                           bf16* o, float* lse, int B, int H, int N, int D,
                           const Strides& st, float scale, bool vec,
                           cudaStream_t stream) {
  constexpr int kSmem = 5 * kTile * (DP + 8) * static_cast<int>(sizeof(bf16));
  // above 48 KB only after this, once per device
  static int done[kMaxDevices];
  const cudaError_t err = allow_smem_once(flash_fwd_bf16_kernel<DP>, kSmem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (N + kTile - 1) / kTile);
  flash_fwd_bf16_kernel<DP><<<grid, kThreads, kSmem, stream>>>(
      q, k, v, o, lse, H, N, D, st, scale * kLog2e, vec ? 1 : 0);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                        float* lse, int B, int H, int N, int D, const Strides& st,
                        float scale, cudaStream_t stream) {
  // 16-byte copies need every row start on 16 bytes: D, all strides a
  // multiple of 8 elements, and 16-byte aligned base pointers
  bool vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
             aligned16(o);
  for (long long s : {st.qb, st.qn, st.qh, st.kb, st.kn, st.kh, st.vb, st.vn,
                      st.vh, st.ob, st.on, st.oh}) {
    vec = vec && s % 8 == 0;
  }
  switch ((D + 15) / 16) {
    case 1: return launch_bf16_dp<16>(q, k, v, o, lse, B, H, N, D, st, scale, vec, stream);
    case 2: return launch_bf16_dp<32>(q, k, v, o, lse, B, H, N, D, st, scale, vec, stream);
    case 3: return launch_bf16_dp<48>(q, k, v, o, lse, B, H, N, D, st, scale, vec, stream);
    case 4: return launch_bf16_dp<64>(q, k, v, o, lse, B, H, N, D, st, scale, vec, stream);
    case 5: return launch_bf16_dp<80>(q, k, v, o, lse, B, H, N, D, st, scale, vec, stream);
    case 6: return launch_bf16_dp<96>(q, k, v, o, lse, B, H, N, D, st, scale, vec, stream);
    case 7: return launch_bf16_dp<112>(q, k, v, o, lse, B, H, N, D, st, scale, vec, stream);
    default: return launch_bf16_dp<128>(q, k, v, o, lse, B, H, N, D, st, scale, vec, stream);
  }
}

// ------------------------------------------------------------ backward ----

// Strides in elements of the backward's inputs (q, k, v, o, dO) and of its
// contiguous (B, N, H, D) outputs dq, dk, dv (g*).
struct BwdStrides {
  long long qb, qn, qh, kb, kn, kh, vb, vn, vh, ob, on, oh, db, dn, dh, gb, gn, gh;
};

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, H, N, D;
};

// fp32: four threads per row (a query for dQ, a key for dK/dV), each
// holding a quarter of D in registers; the other operand streams through
// shared tiles of 32 rows.
constexpr int kF32BwdRows = 64;
constexpr int kF32BwdThreads = 4 * kF32BwdRows;
constexpr int kF32BwdTile = 32;

__device__ __forceinline__ float quad_sum(float s) {
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

// this thread's share of row . r over its nd (<= PART) slots
template <int PART>
__device__ __forceinline__ float dot_part(const float (&r)[PART],
                                          const float* row, int nd) {
  const float4* rr = reinterpret_cast<const float4*>(row);
  float s = 0.f;
#pragma unroll
  for (int i4 = 0; i4 < PART / 4; ++i4) {
    if (4 * i4 < nd) {
      const float4 t = rr[i4];
      s = fmaf(r[4 * i4 + 0], t.x, s);
      s = fmaf(r[4 * i4 + 1], t.y, s);
      s = fmaf(r[4 * i4 + 2], t.z, s);
      s = fmaf(r[4 * i4 + 3], t.w, s);
    }
  }
  return s;
}

// acc += a * row over this thread's slots
template <int PART>
__device__ __forceinline__ void axpy_part(float (&acc)[PART], float a,
                                          const float* row, int nd) {
  const float4* rr = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i4 = 0; i4 < PART / 4; ++i4) {
    if (4 * i4 < nd) {
      const float4 t = rr[i4];
      acc[4 * i4 + 0] = fmaf(a, t.x, acc[4 * i4 + 0]);
      acc[4 * i4 + 1] = fmaf(a, t.y, acc[4 * i4 + 1]);
      acc[4 * i4 + 2] = fmaf(a, t.z, acc[4 * i4 + 2]);
      acc[4 * i4 + 3] = fmaf(a, t.w, acc[4 * i4 + 3]);
    }
  }
}

// rows [r0, r0 + 32) of two (batch, head) slices into [32][kF32Pitch]
// shared tiles, zero past N and past D (up to d_pad)
__device__ __forceinline__ void load_f32_pair(
    float (*as)[kF32Pitch], float (*bs)[kF32Pitch], const float* a,
    long long a_stride, const float* b, long long b_stride, int r0, int N,
    int D, int d_pad) {
  for (int idx = threadIdx.x; idx < kF32BwdTile * d_pad; idx += kF32BwdThreads) {
    const int j = idx / d_pad;
    const int d = idx - j * d_pad;
    const int row = r0 + j;
    float av = 0.f, bv = 0.f;
    if (row < N && d < D) {
      av = a[row * a_stride + d];
      bv = b[row * b_stride + d];
    }
    as[j][d] = av;
    bs[j][d] = bv;
  }
}

template <int PART>
__global__ void __launch_bounds__(kF32BwdThreads)
flash_bwd_dq_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ o,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse, float* __restrict__ delta,
                         float* __restrict__ dq, int H, int N, int D,
                         BwdStrides st, float scale) {
  __shared__ __align__(16) float ks[kF32BwdTile][kF32Pitch];
  __shared__ __align__(16) float vs[kF32BwdTile][kF32Pitch];
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int qi = blockIdx.y * kF32BwdRows + (tid >> 2);
  const int d_part = (((D + 3) >> 2) + 3) & ~3;   // multiple of 4
  const int d_pad = 4 * d_part;
  const int d0 = (tid & 3) * d_part;
  const int nd = min(d_part, D - d0);             // may be <= 0
  const bool valid = qi < N;
  const float* qb = q + b * st.qb + h * st.qh + qi * st.qn + d0;
  const float* ob = o + b * st.ob + h * st.oh + qi * st.on + d0;
  const float* dob = dout + b * st.db + h * st.dh + qi * st.dn + d0;
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;

  // this row's q and dO, and Di = rowsum(dO o O)
  float qr[PART], dr[PART], acc[PART];
  float di = 0.f;
#pragma unroll
  for (int i = 0; i < PART; ++i) {
    float qv = 0.f, dv = 0.f;
    if (valid && i < nd) {
      qv = qb[i];
      dv = dob[i];
      di = fmaf(dv, ob[i], di);
    }
    qr[i] = qv;
    dr[i] = dv;
    acc[i] = 0.f;
  }
  di = quad_sum(di);
  if (valid && (tid & 3) == 0) delta[bh * N + qi] = di;
  const float l = valid ? lse[bh * N + qi] : 0.f;

  for (int k0 = 0; k0 < N; k0 += kF32BwdTile) {
    __syncthreads();   // the previous tile is fully consumed
    load_f32_pair(ks, vs, kb, st.kn, vb, st.vn, k0, N, D, d_pad);
    __syncthreads();
    const int kn = min(kF32BwdTile, N - k0);   // the same for the whole block
#pragma unroll 1
    for (int j = 0; j < kn; ++j) {
      const float s = quad_sum(dot_part(qr, &ks[j][d0], nd));
      const float p = expf(fmaf(s, scale, -l));
      const float dp = quad_sum(dot_part(dr, &vs[j][d0], nd));
      axpy_part(acc, p * (dp - di), &ks[j][d0], nd);
    }
  }
  if (valid) {
    float* out = dq + b * st.gb + h * st.gh + qi * st.gn + d0;
#pragma unroll
    for (int i = 0; i < PART; ++i) {
      if (i < nd) out[i] = acc[i] * scale;
    }
  }
}

template <int PART>
__global__ void __launch_bounds__(kF32BwdThreads)
flash_bwd_dkdv_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int H, int N, int D, BwdStrides st, float scale) {
  __shared__ __align__(16) float qs[kF32BwdTile][kF32Pitch];
  __shared__ __align__(16) float dos[kF32BwdTile][kF32Pitch];
  __shared__ float ls[kF32BwdTile];
  __shared__ float dls[kF32BwdTile];
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int kj = blockIdx.y * kF32BwdRows + (tid >> 2);
  const int d_part = (((D + 3) >> 2) + 3) & ~3;
  const int d_pad = 4 * d_part;
  const int d0 = (tid & 3) * d_part;
  const int nd = min(d_part, D - d0);
  const bool valid = kj < N;
  const float* kb = k + b * st.kb + h * st.kh + kj * st.kn + d0;
  const float* vb = v + b * st.vb + h * st.vh + kj * st.vn + d0;
  const float* qb = q + b * st.qb + h * st.qh;
  const float* dob = dout + b * st.db + h * st.dh;

  float kr[PART], vr[PART], dka[PART], dva[PART];
#pragma unroll
  for (int i = 0; i < PART; ++i) {
    kr[i] = (valid && i < nd) ? kb[i] : 0.f;
    vr[i] = (valid && i < nd) ? vb[i] : 0.f;
    dka[i] = 0.f;
    dva[i] = 0.f;
  }

  for (int q0 = 0; q0 < N; q0 += kF32BwdTile) {
    __syncthreads();
    load_f32_pair(qs, dos, qb, st.qn, dob, st.dn, q0, N, D, d_pad);
    if (tid < kF32BwdTile) {
      const int row = q0 + tid;
      ls[tid] = row < N ? lse[bh * N + row] : 0.f;
      dls[tid] = row < N ? delta[bh * N + row] : 0.f;
    }
    __syncthreads();
    const int qn = min(kF32BwdTile, N - q0);
#pragma unroll 1
    for (int j = 0; j < qn; ++j) {
      const float s = quad_sum(dot_part(kr, &qs[j][d0], nd));
      const float p = expf(fmaf(s, scale, -ls[j]));
      axpy_part(dva, p, &dos[j][d0], nd);
      const float dp = quad_sum(dot_part(vr, &dos[j][d0], nd));
      axpy_part(dka, p * (dp - dls[j]), &qs[j][d0], nd);
    }
  }
  if (valid) {
    float* dko = dk + b * st.gb + h * st.gh + kj * st.gn + d0;
    float* dvo = dv + b * st.gb + h * st.gh + kj * st.gn + d0;
#pragma unroll
    for (int i = 0; i < PART; ++i) {
      if (i < nd) {
        dko[i] = dka[i] * scale;
        dvo[i] = dva[i];
      }
    }
  }
}

template <int PART>
cudaError_t launch_bwd_fp32_part(const BwdArgs& a, const BwdStrides& st,
                                 float scale, cudaStream_t stream) {
  const dim3 grid(a.B * a.H, (a.N + kF32BwdRows - 1) / kF32BwdRows);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  flash_bwd_dq_fp32_kernel<PART><<<grid, kF32BwdThreads, 0, stream>>>(
      q, k, v, static_cast<const float*>(a.o), dout, a.lse, a.delta,
      static_cast<float*>(a.dq), a.H, a.N, a.D, st, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_fp32_kernel<PART><<<grid, kF32BwdThreads, 0, stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.H, a.N, a.D, st, scale);
  return cudaGetLastError();
}

cudaError_t launch_bwd_fp32(const BwdArgs& a, const BwdStrides& st, float scale,
                            cudaStream_t stream) {
  const int d_part = (((a.D + 3) >> 2) + 3) & ~3;
  if (d_part <= 8) return launch_bwd_fp32_part<8>(a, st, scale, stream);
  if (d_part <= 16) return launch_bwd_fp32_part<16>(a, st, scale, stream);
  if (d_part <= 24) return launch_bwd_fp32_part<24>(a, st, scale, stream);
  return launch_bwd_fp32_part<32>(a, st, scale, stream);
}

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

// The SMs of the current device, read once per device.
int sm_count() {
  static int counts[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (counts[dev] == 0) {
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  return counts[dev];
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

// dtype: 0 = float32 (SIMT kernel), 1 = bfloat16 (tensor-core kernel).
// Strides are in elements; the last (D) axis of every tensor must be
// contiguous. lse: null, or an fp32 (B, H, N) tensor that receives the row
// log-sum-exp. Returns a cudaError_t.
extern "C" int rgm_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int N, int D, long long sqb, long long sqn, long long sqh,
    long long skb, long long skn, long long skh, long long svb, long long svn,
    long long svh, long long sob, long long son, long long soh, int dtype,
    float scale, void* stream) {
  if (B < 1 || H < 1 || N < 1 || D < 1 || D > kMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides st{sqb, sqn, sqh, skb, skn, skh, svb, svn, svh, sob, son, soh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_fp32(static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(v), static_cast<float*>(o), l,
                      B, H, N, D, st, scale, s);
  } else if (dtype == 1) {
    err = launch_bf16(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v), static_cast<bf16*>(o), l,
                      B, H, N, D, st, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The gradient of the forward above: q, k, v (strided as there), o and dout
// (the forward's output and its cotangent), lse (fp32 (B, H, N), from the
// forward), delta (fp32 (B, H, N) scratch, written by the dQ kernel), and
// dq, dk, dv (contiguous (B, N, H, D), written). One launch on `stream`
// (the bf16 cluster kernel) or two. Returns a cudaError_t.
extern "C" int rgm_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int N, int D, long long sqb, long long sqn,
    long long sqh, long long skb, long long skn, long long skh, long long svb,
    long long svn, long long svh, long long sob, long long son, long long soh,
    long long sdb, long long sdn, long long sdh, int dtype, float scale,
    void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_bwd_fp32(a, st, scale, s);
  } else if (dtype == 1) {
    err = launch_bwd_bf16(a, st, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
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
