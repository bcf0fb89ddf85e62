// Fused GroupNorm + affine + swish for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel rule_guided_music_tpu/ops/pallas_groupnorm.py
// (`groupnorm_swish`, body `_gn_swish_kernel`), which serves every decoder
// ResnetBlock norm1/norm2 and the norm_out of the KL-VAE decoder:
// y = swish(x * a + b) with a = inv * w[c] and b = bias[c] - mean * a, the
// statistics taken over one (example, group).
//
// What bounds it on the H100: a few operations per element and no product,
// so device memory; the least the card can do is read x once and write y
// once. In NCHW one (n, g) is one contiguous span of (C/G)*H*W elements, up
// to 256 KB in bf16 at the decoder's (256, 128, 128) stage: too large for
// one block's shared memory, and too many spans in flight for the 50 MB L2
// to keep x between a statistics pass and a normalise pass. The design
// reads x once anyway:
//   - the span is cut into S slices of at most 64 KB (S a power of two, at
//     most 8, the portable cluster size; planned by the Python wrapper), one
//     block per slice and one thread-block cluster of S blocks per (n, g);
//   - each block copies its slice into shared memory once with 16-byte
//     cp.async copies, each thread its own chunks in four commit groups;
//     a thread takes the (count, mean, M2) of each group in fp32 as soon
//     as it lands (mean first, then M2 about it: well-conditioned, unlike
//     the one-pass E[x^2] - mean^2) while the later groups are in flight;
//   - the partials are combined with Chan's formula: the groups of a
//     thread, the lanes of a warp (shuffles), the warps of a block, and
//     then the S blocks through distributed shared memory
//     (cluster.map_shared_rank, cluster.sync), in rank order in every
//     block, so all blocks hold the same mean and inverse std;
//   - each block writes y from its shared slice. A thread reads back only
//     what it copied, so only the reductions take a barrier.
// A 64 KB slice leaves room for three blocks on an SM, so one block's
// copies overlap another's math. Spans that are not a multiple of 16 bytes
// or whose channels are not (misaligned, odd H*W) are copied element by
// element into the same layout.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o librgm_groupnorm_swish.so groupnorm_swish.cu

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kMaxSliceBytes = 64 * 1024;
// a thread copies at most 16 chunks of 16 bytes, committed in 4 groups, so
// its statistics start on the first group while the others are in flight
constexpr int kChunksPerThread = kMaxSliceBytes / 16 / kThreads;
constexpr int kGroups = 4;
constexpr int kPerGroup = kChunksPerThread / kGroups;

// 16 bytes of T to and from E floats; one T to and from a float
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int E = 4;
  static __device__ __forceinline__ void load(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 store(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  static __device__ __forceinline__ float one(float v) { return v; }
  static __device__ __forceinline__ float put(float v) { return v; }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  static __device__ __forceinline__ void load(const uint4& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 t = __bfloat1622float2(h[k]);
      f[2 * k] = t.x;
      f[2 * k + 1] = t.y;
    }
  }
  static __device__ __forceinline__ uint4 store(const float* f) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    return r;
  }
  static __device__ __forceinline__ float one(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 put(float v) { return __float2bfloat16(v); }
};
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src));
}

// until at most `pending` of this thread's copy groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
}

// (count, mean, M2) of a set of values, and Chan's combine of two sets
struct Stats {
  float n, mean, m2;
};

__device__ __forceinline__ Stats chan(const Stats& a, const Stats& b) {
  if (b.n == 0.f) return a;
  const float n = a.n + b.n;
  const float delta = b.mean - a.mean;
  return {n, a.mean + delta * (b.n / n),
          a.m2 + b.m2 + delta * delta * (a.n * b.n / n)};
}

__device__ __forceinline__ float swish(float y) {
  return __fdividef(y, 1.f + __expf(-y));
}

// One block per slice, one cluster of S blocks per (n, g); blockIdx.x =
// (n * groups + g) * S + rank. Offsets inside a span fit in int (the
// wrapper checks span < 2^31); the span's base is 64-bit. Each thread
// reads back from shared memory only what it copied there itself, so only
// the reductions need a barrier.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_swish_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ bias, T* __restrict__ y, int groups,
                int cpg, int hw, int span, int slice_len, float eps, int vec) {
  using V = Vec<T>;
  constexpr int E = V::E;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  __shared__ Stats warp_part[kWarps];
  __shared__ Stats part;   // this block's partial, read by the whole cluster

  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long ng = blockIdx.x / S;
  const int g = static_cast<int>(ng % groups);
  const int start = rank * slice_len;
  const int len = min(slice_len, span - start);
  const T* xg = x + ng * span + start;
  T* yg = y + ng * span + start;
  const int tid = threadIdx.x;

  // 1. the slice into shared memory (the one read of x from device
  // memory), and this thread's (count, mean, M2) of what it copied
  Stats st = {0.f, 0.f, 0.f};
  if (vec) {   // len % E == 0; this thread's chunk j starts at (tid + j * kThreads) * E
#pragma unroll
    for (int grp = 0; grp < kGroups; ++grp) {
#pragma unroll
      for (int j = 0; j < kPerGroup; ++j) {
        const int i = (tid + (grp * kPerGroup + j) * kThreads) * E;
        if (i < len) cp_async_16(xs + i, xg + i);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    }
#pragma unroll
    for (int grp = 0; grp < kGroups; ++grp) {
      cp_async_wait(kGroups - 1 - grp);
      float v[kPerGroup * E];
      int cnt = 0;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kPerGroup; ++j) {
        const int i = (tid + (grp * kPerGroup + j) * kThreads) * E;
        if (i < len) {
          V::load(*reinterpret_cast<const uint4*>(xs + i), v + j * E);
#pragma unroll
          for (int e = 0; e < E; ++e) sum += v[j * E + e];
          cnt += E;
        }
      }
      if (cnt > 0) {
        const float mean_g = sum / static_cast<float>(cnt);
        float m2_g = 0.f;
#pragma unroll
        for (int j = 0; j < kPerGroup; ++j) {
          if ((tid + (grp * kPerGroup + j) * kThreads) * E < len) {
#pragma unroll
            for (int e = 0; e < E; ++e) {
              const float d = v[j * E + e] - mean_g;
              m2_g = fmaf(d, d, m2_g);
            }
          }
        }
        st = chan(st, {static_cast<float>(cnt), mean_g, m2_g});
      }
    }
  } else {
    float sum = 0.f;
    int cnt = 0;
    for (int i = tid; i < len; i += kThreads) {
      xs[i] = xg[i];
      sum += V::one(xs[i]);
      ++cnt;
    }
    if (cnt > 0) {
      const float mean_t = sum / static_cast<float>(cnt);
      float m2_t = 0.f;
      for (int i = tid; i < len; i += kThreads) {
        const float d = V::one(xs[i]) - mean_t;
        m2_t = fmaf(d, d, m2_t);
      }
      st = {static_cast<float>(cnt), mean_t, m2_t};
    }
  }

  // 2. the block's partial: Chan over the warp's lanes, then over the warps
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Stats other = {__shfl_xor_sync(0xffffffffu, st.n, o),
                         __shfl_xor_sync(0xffffffffu, st.mean, o),
                         __shfl_xor_sync(0xffffffffu, st.m2, o)};
    st = chan(st, other);
  }
  if ((tid & 31) == 0) warp_part[tid >> 5] = st;
  __syncthreads();
  if (tid == 0) {
    Stats b = warp_part[0];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) b = chan(b, warp_part[k]);
    part = b;
  }

  // 3. Chan's combine of the S partials, read through distributed shared
  // memory in rank order, so every block of the cluster gets the same
  cluster.sync();
  Stats tot = {0.f, 0.f, 0.f};
  for (int r = 0; r < S; ++r) tot = chan(tot, *cluster.map_shared_rank(&part, r));
  cluster.sync();   // no block leaves while another still reads its partial
  const float inv = 1.f / sqrtf(tot.m2 / static_cast<float>(span) + eps);
  const float mean = tot.mean;

  // 4. y = swish(x * a + b) from the shared slice
  const int c0 = g * cpg;
  if (vec) {   // hw % E == 0: a chunk lies in one channel
#pragma unroll 4
    for (int j = 0; j < kChunksPerThread; ++j) {
      const int i = (tid + j * kThreads) * E;
      if (i >= len) break;
      const int c = c0 + (start + i) / hw;
      const float a = inv * V::one(w[c]);
      const float b = V::one(bias[c]) - mean * a;
      float f[E];
      V::load(*reinterpret_cast<const uint4*>(xs + i), f);
#pragma unroll
      for (int e = 0; e < E; ++e) f[e] = swish(fmaf(f[e], a, b));
      *reinterpret_cast<uint4*>(yg + i) = V::store(f);
    }
  } else {
    for (int i = tid; i < len; i += kThreads) {
      const int c = c0 + (start + i) / hw;
      const float a = inv * V::one(w[c]);
      const float b = V::one(bias[c]) - mean * a;
      yg[i] = V::put(swish(fmaf(V::one(xs[i]), a, b)));
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   long long n_spans, int groups, int cpg, int hw, int span,
                   int clusters, int slice_len, float eps, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int vec = span % E == 0 && hw % E == 0 && slice_len % E == 0 &&
                  aligned16(x) && aligned16(y);
  const int smem = slice_len * static_cast<int>(sizeof(T));
  auto kernel = gn_swish_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_spans * clusters));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                           static_cast<const T*>(w), static_cast<const T*>(b),
                           static_cast<T*>(y), groups, cpg, hw, span,
                           slice_len, eps, vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x, y: contiguous (N, C, H, W); w, b: (C,), all of one dtype: 0 = float32,
// 1 = bfloat16.
// clusters (S) and slice_len come from the wrapper's planner: S a power of
// two <= 8, slice_len * sizeof(x) <= 64 KB, and S slices of slice_len, the
// last one shorter, cover the span with none empty. Returns a cudaError_t.
extern "C" int rgm_groupnorm_swish_fwd(
    const void* x, const void* w, const void* b, void* y, long long n_spans,
    int groups, int cpg, int hw, int span, int clusters, int slice_len,
    int dtype, float eps, void* stream) {
  const int size = dtype == 0 ? 4 : 2;
  if (n_spans < 1 || groups < 1 || cpg < 1 || hw < 1 || span != cpg * hw ||
      clusters < 1 || clusters > kMaxCluster || (clusters & (clusters - 1)) ||
      slice_len < 1 || slice_len * size > kMaxSliceBytes ||
      static_cast<long long>(clusters) * slice_len < span ||
      static_cast<long long>(clusters - 1) * slice_len >= span ||
      n_spans * clusters >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ns = n_spans;
  switch (dtype) {
    case 0: return launch<float>(x, w, b, y, ns, groups, cpg, hw, span, clusters, slice_len, eps, s);
    case 1: return launch<__nv_bfloat16>(x, w, b, y, ns, groups, cpg, hw, span, clusters, slice_len, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
