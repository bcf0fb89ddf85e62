// Flash-attention forward in bf16 for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel rule_guided_music_tpu/ops/pallas_attention.py
// (`flash_attention`, body `_flash_kernel`): non-causal softmax attention
// over (B, N, H, D) tensors, scale D^-0.5 on the true D, online softmax with
// fp32 running max, sum and accumulator, keys past N masked. The (N, N)
// scores never reach device memory, as the Pallas kernel keeps them out of
// HBM.
//
// Kernel 1 is three libraries, one per source, chosen by the wrapper
// (ops/flash_attention.py) from the dtype and the direction alone: this one
// (the bf16 forward), flash_attention_bwd.cu (the bf16 backward) and
// flash_attention_fp32.cu (the fp32 forward and backward, on the tensor
// cores with the 3xTF32 split). Each builds on its own, in parallel.
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
// Where a gradient is wanted, the kernel also writes the row log-sum-exp
// LSE = m + log(l) (natural log, fp32, (B, H, N)); inference passes a null
// pointer and writes nothing more.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu

#include <initializer_list>

#include "flash_attention_bf16.cuh"

namespace {

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

}  // namespace

// bf16 q, k, v, o; strides are in elements; the last (D) axis of every
// tensor must be contiguous. lse: null, or an fp32 (B, H, N) tensor that
// receives the row log-sum-exp. Returns a cudaError_t.
extern "C" int rgm_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int N, int D, long long sqb, long long sqn, long long sqh,
    long long skb, long long skn, long long skh, long long svb, long long svn,
    long long svh, long long sob, long long son, long long soh, float scale,
    void* stream) {
  if (B < 1 || H < 1 || N < 1 || D < 1 || D > kMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides st{sqb, sqn, sqh, skb, skn, skh, svb, svn, svh, sob, son, soh};
  return static_cast<int>(launch_bf16(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse),
      B, H, N, D, st, scale, static_cast<cudaStream_t>(stream)));
}
