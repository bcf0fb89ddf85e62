// Shared by kernel 1's sources (flash_attention.cu, flash_attention_bwd.cu,
// flash_attention_fp32.cu) and the int8 GEMMs (quant_gemm.cu): constants,
// the stride structs of the plain-C entry points, cp.async, and the
// per-device caches of the launchers. All
// of it lies in an anonymous namespace, so every library keeps its own
// copy.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

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

// The SMs of the current device, read once per device.
inline int sm_count() {
  static int counts[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (counts[dev] == 0) {
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  return counts[dev];
}

}  // namespace
