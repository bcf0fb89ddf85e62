// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel rule_guided_music_tpu/ops/pallas_attention.py
// (`flash_attention`, body `_flash_kernel`): non-causal softmax attention
// over (B, N, H, D) tensors, scale D^-0.5 on the true D, online softmax with
// fp32 running max, sum and accumulator, keys past N masked.
//
// What bounds it: at the DiT shapes (N = 256, D = 72) a (batch, head) pair
// moves 4*N*D bf16 values (q, k, v in, o out) and does 4*N*N*D operations,
// about 128 operations per byte, under the ~295 at which the H100's bf16
// tensor cores would bound it: at the roofline the memory rate bounds it.
// This first version does its products on the fp32 pipes (no wgmma, no
// TMA), so in practice the fp32 rate bounds it. The design keeps the
// (N, N) scores out of device memory, as the Pallas kernel keeps them out
// of HBM.
//
// Design: one block per (batch*head, 64-query tile), 128 threads, two
// threads per query, each owning one half of D (rounded up to a multiple of
// 4) in registers: its slice of q and of the fp32 accumulator. K and V
// stream through shared memory in 32-key tiles, converted to fp32 on load
// and zero-padded past D, so each thread reads its slice as float4s. Keys
// are taken one at a time with the online-softmax update (the running max
// and sum rescale the accumulator only when the max grows); the two halves
// of a query combine their partial dot products with one warp shuffle. The
// key loop is not unrolled, which keeps the code, and the nvcc build,
// small. Rows past N are neither loaded nor stored. Rotary stays outside
// the kernel, as in the JAX package.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o librgm_flash_attention.so flash_attention.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;             // queries per block
constexpr int kBlockK = 32;             // keys per shared-memory tile
constexpr int kThreads = 2 * kBlockQ;   // two threads per query
constexpr int kMaxD = 128;
constexpr int kPitch = kMaxD + 4;       // shared row pitch, float4-aligned

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Strides {
  long long qb, qn, qh, kb, kn, kh, vb, vn, vh, ob, on, oh;
};

// HALF: register slots per thread, a multiple of 4, >= the half split of D.
template <typename T, int HALF>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int N,
                 int D, Strides st, float scale) {
  __shared__ __align__(16) float ks[kBlockK][kPitch];
  __shared__ __align__(16) float vs[kBlockK][kPitch];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int tid = threadIdx.x;
  const int qi = blockIdx.y * kBlockQ + (tid >> 1);
  const int d_split = (((D + 1) >> 1) + 3) & ~3;   // multiple of 4
  const int d_pad = 2 * d_split;                   // padded row width
  const int d0 = (tid & 1) ? d_split : 0;
  const int nd = min(d_split, D - d0);             // may be <= 0
  const bool q_valid = qi < N;

  const T* qb = q + b * st.qb + h * st.qh;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;

  float qr[HALF];
  float acc[HALF];
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    qr[i] = (q_valid && i < nd) ? load_f32(qb + qi * st.qn + d0 + i) * scale
                                : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < N; k0 += kBlockK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < kBlockK * d_pad; idx += kThreads) {
      const int j = idx / d_pad;
      const int d = idx - j * d_pad;
      const int kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < N && d < D) {
        kv = load_f32(kb + kj * st.kn + d);
        vv = load_f32(vb + kj * st.vn + d);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();

    const int kn = min(kBlockK, N - k0);   // the same for the whole block
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
    T* ob = o + b * st.ob + h * st.oh + qi * st.on + d0;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      if (i < nd) store_f32(ob + i, acc[i] * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int N, int D, const Strides& st, float scale,
                   cudaStream_t stream) {
  const dim3 grid(B * H, (N + kBlockQ - 1) / kBlockQ);
  const dim3 block(kThreads);
  const int d_split = (((D + 1) >> 1) + 3) & ~3;
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(o);
  if (d_split <= 32) {
    flash_fwd_kernel<T, 32><<<grid, block, 0, stream>>>(qq, kk, vv, oo, H, N, D, st, scale);
  } else if (d_split <= 36) {
    flash_fwd_kernel<T, 36><<<grid, block, 0, stream>>>(qq, kk, vv, oo, H, N, D, st, scale);
  } else {
    flash_fwd_kernel<T, 64><<<grid, block, 0, stream>>>(qq, kk, vv, oo, H, N, D, st, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last (D)
// axis of every tensor must be contiguous. Returns a cudaError_t.
extern "C" int rgm_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H, int N,
    int D, long long sqb, long long sqn, long long sqh, long long skb,
    long long skn, long long skh, long long svb, long long svn, long long svh,
    long long sob, long long son, long long soh, int dtype, float scale,
    void* stream) {
  if (B < 1 || H < 1 || N < 1 || D < 1 || D > kMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides st{sqb, sqn, sqh, skb, skn, skh, svb, svn, svh, sob, son, soh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, k, v, o, B, H, N, D, st, scale, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k, v, o, B, H, N, D, st, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
