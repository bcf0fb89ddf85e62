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
// The backward (`rgm_groupnorm_swish_bwd`) is the VJP that the JAX
// package's `_fgs_bwd` takes (jax.vjp of `_gn_swish_ref`): with
// xh = (x - mean) * inv, z = w[c] xh + bias[c] and
// g = dy * sigmoid(z) * (1 + z (1 - sigmoid(z))),
//   dbias[c] = sum_{n, hw} g,  dw[c] = sum_{n, hw} g xh,
//   dx = inv * (h - mean_span(h) - xh * mean_span(h xh)),  h = w[c] g.
// What bounds it on the H100: it reads x and dy and writes dx, three times
// the forward's bytes, and does a few dozen operations per element, two of
// them (an exp and a reciprocal) on the special-function unit: device
// memory still sets the bound, but only if the block's phases overlap.
// The design:
//   - a plan of its own: slices of at most 32 KB of x and as much of dy
//     per block (the Python wrapper's plan_bwd_slices; S <= 16 blocks per
//     span, past 8 a non-portable cluster), 64 KB of shared memory and at
//     most 80 registers a thread, so three blocks (24 warps) fit on an
//     SM: one block's copies and cluster barriers overlap another's math;
//   - warp w owns a contiguous run of the slice, in rows of 32 16-byte
//     chunks; x lands in two cp.async groups and dy in a third, the
//     statistics start on the first group, and each thread reads back
//     only what it copied;
//   - the span statistics are recomputed as the forward takes them (x is
//     in shared memory, so that costs no bytes; the forward writes none);
//   - one pass evaluates g once per element and sums h and h xh per
//     thread and, where the weight and bias gradients are wanted, g and
//     g xh per channel as the warp goes: a chunk lies in one channel, a
//     warp's channels come in order, so each lane sums the rows wholly in
//     the warp's current channel and a row that crosses a channel is
//     summed by segments; a channel that warps or slices share adds their
//     sums in warp order, then in rank order, into an fp32 (N, C)
//     partial, which a second small launch sums over N in a fixed order;
//   - a second pass evaluates g again and writes dx: x and dy read once,
//     dx written once, every sum in a fixed order, so the gradients are
//     the same from run to run;
//   - three cluster barriers (statistics; sums; leaving), the last one
//     split so that the dx pass runs between its arrive and its wait.
// Where no weight or bias gradient is wanted (DPS differentiates with
// respect to x only), the per-channel sums and the second launch are
// skipped. Odd H*W or misaligned tensors take the same design element by
// element.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o librgm_groupnorm_swish.so groupnorm_swish.cu

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kMaxSliceBytes = 64 * 1024;
// the backward's per-channel sums of g and g xh: 2 * cpg floats
constexpr int kMaxChannelBytes = 32 * 1024;
constexpr int kMaxDevices = 64;
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

// The slice into shared memory (the one read of x from device memory), and
// this thread's (count, mean, M2) of what it copied. vec: len % E == 0 and
// this thread's chunk j starts at (tid + j * kThreads) * E; else element i
// = tid + j * kThreads. Copies the caller committed before this call are
// complete when it returns.
template <typename T>
__device__ __forceinline__ Stats load_slice(T* xs, const T* xg, int len, int vec) {
  using V = Vec<T>;
  constexpr int E = V::E;
  const int tid = threadIdx.x;
  Stats st = {0.f, 0.f, 0.f};
  if (vec) {
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
  return st;
}

// The span's (count, mean, M2): Chan over the warp's lanes, then over the
// warps (the block's partial in `part`), then over the S partials read
// through distributed shared memory in rank order, so every block of the
// cluster gets the same. Ends with every block of the cluster past it.
__device__ __forceinline__ Stats cluster_stats(Stats st, Stats* warp_part,
                                               Stats* part,
                                               cg::cluster_group& cluster) {
  const int tid = threadIdx.x;
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
    *part = b;
  }
  cluster.sync();
  Stats tot = {0.f, 0.f, 0.f};
  const int S = static_cast<int>(cluster.num_blocks());
  for (int r = 0; r < S; ++r) tot = chan(tot, *cluster.map_shared_rank(part, r));
  cluster.sync();   // no block leaves while another still reads its partial
  return tot;
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

  // 1-3. the slice in shared memory; the span's statistics
  const Stats tot = cluster_stats(load_slice(xs, xg, len, vec), warp_part,
                                  &part, cluster);
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

// ---------------------------------------------------------------- backward

// Each block of the backward holds its slice of x and of dy in shared
// memory, at most 32 KB each: three blocks (24 warps) fit on an SM, so one
// block's copies and barriers overlap another's math. S <= 16 slices per
// span (past 8, a non-portable cluster: fp32 spans of 256-512 KB).
constexpr int kBwdSliceBytes = 32 * 1024;
constexpr int kBwdMaxCluster = 16;
constexpr int kBwdBlocksPerSM = 3;

// A unit is what a thread takes at once: a 16-byte chunk of E elements in
// the vector layout (it lies in one channel: hw % E == 0), else one
// element. Warp w owns the units [w R 32, (w + 1) R 32) of its slice, in
// rows of 32 (row j: units (w R + j) 32 + lane), so its channels come in
// order, row after row and lane after lane.
template <typename T, bool VEC>
struct BwdUnit {
  static constexpr int U = VEC ? Vec<T>::E : 1;
  static constexpr int R = kBwdSliceBytes / static_cast<int>(sizeof(T)) / U / kThreads;
  static __device__ __forceinline__ void load(const T* s, float* f) {
    if constexpr (VEC) {
      Vec<T>::load(*reinterpret_cast<const uint4*>(s), f);
    } else {
      f[0] = Vec<T>::one(*s);
    }
  }
};

__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

// g = dy * d swish(z) / dz at z = w xh + b; also returns xh. One __expf
// and one reciprocal, both on the special-function unit.
struct GradAt {
  float mean, inv;
  __device__ __forceinline__ float operator()(float xv, float dyv, float wc,
                                              float bc, float& xh) const {
    xh = (xv - mean) * inv;
    const float z = fmaf(xh, wc, bc);
    const float sg = rcp_approx(1.f + __expf(-z));
    return dyv * sg * fmaf(z, 1.f - sg, 1.f);
  }
};

__device__ __forceinline__ float2 warp_sum2(float2 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  return v;
}

// p / hw for 0 <= p < span, from a float estimate (off by at most one:
// the quotient is below cpg < 2^20) and one correction each way
__device__ __forceinline__ int div_hw(int p, int hw, float rhw) {
  int q = static_cast<int>(static_cast<float>(p) * rhw);
  q -= static_cast<unsigned>(q) * static_cast<unsigned>(hw) > static_cast<unsigned>(p);
  q += static_cast<unsigned>(q + 1) * static_cast<unsigned>(hw) <= static_cast<unsigned>(p);
  return q;
}

// the split phases of the cluster barrier: arrive, then wait later
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The warp's sums of g and g xh per channel, in the order its units come.
// The warp keeps the channel it is in (`c`, warp-uniform) and its sum so
// far (`run`); each lane adds its units of rows that lie wholly in that
// channel to its own `acc`. A row that does not is summed by segments (a
// segmented tree over the lanes, whose channels never decrease), after the
// lanes' `acc` are folded into `run`. A channel the warp leaves goes to
// shared memory: the first one to `first` (the previous warp or slice may
// share it), the others to `chs[c]` (no one else holds any of it); the
// last one, when the rows end, to `last` (unless it is also the first).
struct ChannelRun {
  int c = -1;          // the open channel (-1: none yet)
  int closed = 0;      // channels closed so far
  float2 run = {0.f, 0.f};
  float2 acc = {0.f, 0.f};

  __device__ __forceinline__ void close(float2* chs, float2* first) {
    if (c >= 0 && (threadIdx.x & 31) == 0) {
      if (closed == 0) {
        *first = run;
      } else {
        chs[c] = run;
      }
    }
    closed += c >= 0;
  }

  // one row: this lane's unit's channel (INT_MAX past the slice) and sums
  __device__ __forceinline__ void add_row(int cu, float2 v, float2* chs,
                                          float2* first) {
    if (__all_sync(0xffffffffu, cu == c)) {
      acc.x += v.x;
      acc.y += v.y;
      return;
    }
    const float2 a = warp_sum2(acc);
    run.x += a.x;
    run.y += a.y;
    acc = make_float2(0.f, 0.f);
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {   // each lane: its unit to its segment's end
      const float vx = __shfl_down_sync(0xffffffffu, v.x, o);
      const float vy = __shfl_down_sync(0xffffffffu, v.y, o);
      const int co = __shfl_down_sync(0xffffffffu, cu, o);
      if (lane + o < 32 && co == cu) {
        v.x += vx;
        v.y += vy;
      }
    }
    const int prev = __shfl_up_sync(0xffffffffu, cu, 1);
    unsigned heads = __ballot_sync(0xffffffffu,
                                   cu != INT_MAX && (lane == 0 || prev != cu));
    while (heads) {   // the segments in lane order
      const int hl = __ffs(heads) - 1;
      heads &= heads - 1;
      const float sx = __shfl_sync(0xffffffffu, v.x, hl);
      const float sy = __shfl_sync(0xffffffffu, v.y, hl);
      const int hc = __shfl_sync(0xffffffffu, cu, hl);
      if (hc == c) {
        run.x += sx;
        run.y += sy;
      } else {
        close(chs, first);
        c = hc;
        run = make_float2(sx, sy);
      }
    }
  }

  __device__ __forceinline__ void finish(float2* chs, float2* first, float2* last) {
    const float2 a = warp_sum2(acc);
    run.x += a.x;
    run.y += a.y;
    if (c >= 0 && (threadIdx.x & 31) == 0) {
      if (closed == 0) {
        *first = run;
      } else {
        *last = run;
      }
    }
  }
};

// The backward, one cluster of S blocks per (n, g), a slice of at most
// 32 KB of x and of dy per block. Shared memory: x's slice, dy's slice,
// then (where ch_part != 0) the (sum g, sum g xh) of each channel of the
// group, cpg float2. ch_part: null, or the fp32 (2, N, C) scratch of
// per-(n, c) sums of g and g xh. Each thread reads back from shared memory
// only what it copied, so only the reductions take a barrier.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSM)
gn_swish_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ bias, const T* __restrict__ dy,
                    T* __restrict__ dx, float* __restrict__ ch_part,
                    long long n_spans, int groups, int cpg, int hw, int span,
                    int slice_len, float eps) {
  using V = Vec<T>;
  using B = BwdUnit<T, VEC>;
  constexpr int U = B::U;
  constexpr int R = B::R;
  constexpr int kWarpUnits = R * 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* dys = xs + slice_len;
  float2* chs = reinterpret_cast<float2*>(dys + slice_len);
  __shared__ Stats warp_part[kWarps];
  __shared__ Stats part;    // this block's (count, mean, M2)
  __shared__ float2 warp_sums[kWarps];
  __shared__ float2 edges[kWarps][2];
  __shared__ float2 sums;   // this block's sums of h and h xh

  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long ng = blockIdx.x / S;
  const int g = static_cast<int>(ng % groups);
  const int start = rank * slice_len;
  const int len = min(slice_len, span - start);
  const long long off = ng * span + start;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c0 = g * cpg;
  const int u0 = warp * kWarpUnits + lane;   // this thread's unit in row 0
  const float rhw = 1.f / static_cast<float>(hw);
  const bool params = ch_part != nullptr;

  // 1. the slices of x (two copy groups) and dy (a third) into shared
  // memory, and this thread's (count, mean, M2) of its x as it lands
  Stats st = {0.f, 0.f, 0.f};
  if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int i = (u0 + 32 * j) * U;
      if (i < len) cp_async_16(xs + i, x + off + i);
      if (j == R / 2 - 1 || j == R - 1) asm volatile("cp.async.commit_group;\n" ::);
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int i = (u0 + 32 * j) * U;
      if (i < len) cp_async_16(dys + i, dy + off + i);
    }
    asm volatile("cp.async.commit_group;\n" ::);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      cp_async_wait(2 - half);
      float v[R / 2 * U];
      int cnt = 0;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < R / 2; ++j) {
        const int i = (u0 + 32 * (half * R / 2 + j)) * U;
        if (i < len) {
          B::load(xs + i, v + j * U);
#pragma unroll
          for (int e = 0; e < U; ++e) sum += v[j * U + e];
          cnt += U;
        }
      }
      if (cnt > 0) {
        const float mean_g = sum / static_cast<float>(cnt);
        float m2_g = 0.f;
#pragma unroll
        for (int j = 0; j < R / 2; ++j) {
          if ((u0 + 32 * (half * R / 2 + j)) * U < len) {
#pragma unroll
            for (int e = 0; e < U; ++e) {
              const float d = v[j * U + e] - mean_g;
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
    for (int j = 0; j < R; ++j) {
      const int i = u0 + 32 * j;
      if (i < len) {
        xs[i] = x[off + i];
        dys[i] = dy[off + i];
        sum += V::one(xs[i]);
        ++cnt;
      }
    }
    if (cnt > 0) {
      const float mean_t = sum / static_cast<float>(cnt);
      float m2_t = 0.f;
      for (int j = 0; j < R; ++j) {
        const int i = u0 + 32 * j;
        if (i < len) {
          const float d = V::one(xs[i]) - mean_t;
          m2_t = fmaf(d, d, m2_t);
        }
      }
      st = {static_cast<float>(cnt), mean_t, m2_t};
    }
  }
  if (params) {
    for (int c = tid; c < cpg; c += kThreads) chs[c] = make_float2(0.f, 0.f);
  }

  // 2. the span's statistics: Chan over the lanes, the warps (thread 0)
  // and the S blocks (distributed shared memory, rank order)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Stats other = {__shfl_xor_sync(0xffffffffu, st.n, o),
                         __shfl_xor_sync(0xffffffffu, st.mean, o),
                         __shfl_xor_sync(0xffffffffu, st.m2, o)};
    st = chan(st, other);
  }
  if (lane == 0) warp_part[warp] = st;
  __syncthreads();
  if (tid == 0) {
    Stats b = warp_part[0];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) b = chan(b, warp_part[k]);
    part = b;
  }
  cluster_arrive();
  cluster_wait();
  Stats tot = {0.f, 0.f, 0.f};
  for (int r = 0; r < S; ++r) tot = chan(tot, *cluster.map_shared_rank(&part, r));
  const GradAt grad{tot.mean, 1.f / sqrtf(tot.m2 / static_cast<float>(span) + eps)};
  if constexpr (VEC) cp_async_wait(0);   // dy: this thread's own copies

  // 3. one pass: this thread's sums of h = w g and h xh (the span's sums),
  // and, where wanted, the warp's sums of g and g xh per channel
  float2 th = make_float2(0.f, 0.f);
  ChannelRun chr;
#pragma unroll 2
  for (int j = 0; j < R; ++j) {
    if ((u0 - lane + 32 * j) * U >= len) break;   // warp-uniform: past the slice
    const int i = (u0 + 32 * j) * U;
    float2 v = make_float2(0.f, 0.f);
    int cu = INT_MAX;
    if (i < len) {
      cu = div_hw(start + i, hw, rhw);
      const float wc = V::one(w[c0 + cu]);
      const float bc = V::one(bias[c0 + cu]);
      float xf[U], df[U];
      B::load(xs + i, xf);
      B::load(dys + i, df);
#pragma unroll
      for (int e = 0; e < U; ++e) {
        float xh;
        const float gg = grad(xf[e], df[e], wc, bc, xh);
        v.x += gg;
        v.y = fmaf(gg, xh, v.y);
      }
      th.x = fmaf(wc, v.x, th.x);   // h = w g, and w is the unit's
      th.y = fmaf(wc, v.y, th.y);
    }
    if (params) chr.add_row(cu, v, chs, &edges[warp][0]);
  }
  if (params) chr.finish(chs, &edges[warp][0], &edges[warp][1]);
  th = warp_sum2(th);
  if (lane == 0) warp_sums[warp] = th;
  __syncthreads();
  if (tid == 0) {
    float2 b = warp_sums[0];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) {
      b.x += warp_sums[k].x;
      b.y += warp_sums[k].y;
    }
    sums = b;
    if (params) {   // the channels the warps share, in warp order
      for (int k = 0; k < kWarps; ++k) {
        const int a = k * kWarpUnits * U;
        if (a >= len) break;
        const int c_first = div_hw(start + a, hw, rhw);
        const int c_last = div_hw(start + min(a + kWarpUnits * U, len) - 1, hw, rhw);
        chs[c_first].x += edges[k][0].x;
        chs[c_first].y += edges[k][0].y;
        if (c_last != c_first) {
          chs[c_last].x += edges[k][1].x;
          chs[c_last].y += edges[k][1].y;
        }
      }
    }
  }
  cluster_arrive();
  cluster_wait();

  // 4. the span's sums of h and h xh, in rank order; where wanted, this
  // rank's share of the channels, summed over the S slices in rank order
  float2 tot_h = make_float2(0.f, 0.f);
  for (int r = 0; r < S; ++r) {
    const float2 p = *cluster.map_shared_rank(&sums, r);
    tot_h.x += p.x;
    tot_h.y += p.y;
  }
  if (params) {
    const long long C = static_cast<long long>(groups) * cpg;
    const long long n = ng / groups;
    for (int c = rank + tid * S; c < cpg; c += kThreads * S) {
      float sg = 0.f, sgx = 0.f;
      for (int r = 0; r < S; ++r) {
        const float2 p = cluster.map_shared_rank(chs, r)[c];
        sg += p.x;
        sgx += p.y;
      }
      ch_part[n * C + c0 + c] = sg;
      ch_part[(n_spans / groups + n) * C + c0 + c] = sgx;
    }
  }
  cluster_arrive();   // this block reads no other block's memory from here on
  const float mean_h = tot_h.x / static_cast<float>(span);
  const float mean_hx = tot_h.y / static_cast<float>(span);

  // 5. dx = inv (h - mean(h) - xh mean(h xh)) from the shared slices
  T* dxg = dx + off;
#pragma unroll 2
  for (int j = 0; j < R; ++j) {
    if ((u0 - lane + 32 * j) * U >= len) break;
    const int i = (u0 + 32 * j) * U;
    if (i < len) {
      const int c = c0 + div_hw(start + i, hw, rhw);
      const float wc = V::one(w[c]);
      const float bc = V::one(bias[c]);
      float xf[U], df[U];
      B::load(xs + i, xf);
      B::load(dys + i, df);
#pragma unroll
      for (int e = 0; e < U; ++e) {
        float xh;
        const float h = wc * grad(xf[e], df[e], wc, bc, xh);
        xf[e] = grad.inv * (h - mean_h - xh * mean_hx);
      }
      if constexpr (VEC) {
        *reinterpret_cast<uint4*>(dxg + i) = V::store(xf);
      } else {
        dxg[i] = V::put(xf[0]);
      }
    }
  }
  cluster_wait();   // no block leaves while another still reads its sums
}

// dw[c] = sum_n (g xh)[n, c], dbias[c] = sum_n g[n, c]: 32 channels per
// block, N cut into 8 runs, each summed in order by one warp, the runs
// added in order
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_param_reduce_kernel(const float* __restrict__ ch_part, T* __restrict__ dw,
                       T* __restrict__ db, int n, int C) {
  __shared__ float2 runs[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int run = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int per = (n + kWarps - 1) / kWarps;
  const int i1 = min(n, (run + 1) * per);
  const long long nc = static_cast<long long>(n) * C;
  float2 s = make_float2(0.f, 0.f);
  if (c < C) {
    for (int i = run * per; i < i1; ++i) {
      s.x += ch_part[static_cast<long long>(i) * C + c];
      s.y += ch_part[nc + static_cast<long long>(i) * C + c];
    }
  }
  runs[run][lane] = s;
  __syncthreads();
  if (run == 0 && c < C) {
#pragma unroll
    for (int k = 1; k < kWarps; ++k) {
      s.x += runs[k][lane].x;
      s.y += runs[k][lane].y;
    }
    dw[c] = Vec<T>::put(s.y);
    db[c] = Vec<T>::put(s.x);
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
  // every slice fits the 64 KB limit set once per device
  static int done[kMaxDevices];
  cudaError_t err = allow_smem_once(kernel, kMaxSliceBytes, done);
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

template <typename T, bool VEC>
cudaError_t launch_bwd_vec(const void* x, const void* w, const void* b,
                           const void* dy, void* dx, float* ch_part,
                           long long n_spans, int groups, int cpg, int hw,
                           int span, int clusters, int slice_len, float eps,
                           cudaStream_t stream) {
  const int smem = 2 * slice_len * static_cast<int>(sizeof(T)) +
                   (ch_part != nullptr ? cpg * static_cast<int>(sizeof(float2)) : 0);
  auto kernel = gn_swish_bwd_kernel<T, VEC>;
  // every plan fits 2 x 32 KB of slices and 32 KB of channel sums, set once
  // per device with the permission for clusters of 16
  static int done[kMaxDevices];
  cudaError_t err = allow_smem_once(kernel, 2 * kBwdSliceBytes + kMaxChannelBytes,
                                    done);
  if (err != cudaSuccess) return err;
  static int done16[kMaxDevices];
  if (clusters > kMaxCluster) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (!done16[dev]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
      done16[dev] = 1;
    }
  }
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
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                            static_cast<const T*>(w), static_cast<const T*>(b),
                            static_cast<const T*>(dy), static_cast<T*>(dx),
                            ch_part, n_spans, groups, cpg, hw, span, slice_len,
                            eps);
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* w, const void* b,
                       const void* dy, void* dx, float* ch_part, void* dw,
                       void* db, long long n_spans, int groups, int cpg, int hw,
                       int span, int clusters, int slice_len, float eps,
                       cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const bool vec = span % E == 0 && hw % E == 0 && slice_len % E == 0 &&
                   aligned16(x) && aligned16(dy) && aligned16(dx);
  cudaError_t err = (vec ? launch_bwd_vec<T, true> : launch_bwd_vec<T, false>)(
      x, w, b, dy, dx, ch_part, n_spans, groups, cpg, hw, span, clusters,
      slice_len, eps, stream);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess || ch_part == nullptr) return err;
  const int C = groups * cpg;
  gn_param_reduce_kernel<T><<<(C + 31) / 32, kThreads, 0, stream>>>(
      ch_part, static_cast<T*>(dw), static_cast<T*>(db),
      static_cast<int>(n_spans / groups), C);
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

// The backward of the forward above, on a plan of its own: x, w, b as
// there, dy (contiguous, x's shape and dtype) in, dx out. clusters (S) and
// slice_len: S a power of two <= 16, slice_len * sizeof(x) <= 32 KB, and S
// slices of slice_len, the last one shorter, cover the span with none
// empty. ch_part, dw and db: all null (no weight or bias gradient), or an
// fp32 (2, N, C) scratch and the (C,) gradients of w and b in x's dtype (a
// second launch). Returns a cudaError_t.
extern "C" int rgm_groupnorm_swish_bwd(
    const void* x, const void* w, const void* b, const void* dy, void* dx,
    void* ch_part, void* dw, void* db, long long n_spans, int groups, int cpg,
    int hw, int span, int clusters, int slice_len, int dtype, float eps,
    void* stream) {
  const int size = dtype == 0 ? 4 : 2;
  const bool params = ch_part != nullptr;
  if (n_spans < 1 || groups < 1 || cpg < 1 || hw < 1 || span != cpg * hw ||
      n_spans % groups != 0 || cpg >= (1 << 20) ||
      clusters < 1 || clusters > kBwdMaxCluster || (clusters & (clusters - 1)) ||
      slice_len < 1 || slice_len % 8 != 0 || slice_len * size > kBwdSliceBytes ||
      static_cast<long long>(clusters) * slice_len < span ||
      static_cast<long long>(clusters - 1) * slice_len >= span ||
      n_spans * clusters >= (1LL << 31) ||
      (params && (dw == nullptr || db == nullptr ||
                  cpg * 8 > kMaxChannelBytes))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(ch_part);
  switch (dtype) {
    case 0: return launch_bwd<float>(x, w, b, dy, dx, part, dw, db, n_spans, groups, cpg, hw, span, clusters, slice_len, eps, s);
    case 1: return launch_bwd<__nv_bfloat16>(x, w, b, dy, dx, part, dw, db, n_spans, groups, cpg, hw, span, clusters, slice_len, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
