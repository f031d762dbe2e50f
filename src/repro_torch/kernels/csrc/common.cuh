// Shared helpers for the attention kernels: f32 <-> storage-type
// conversion, 16-byte vector loads, warp reductions, and the one-time
// shared-memory opt-in of a kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// x rounded to T's precision and widened back: the `p.astype(v.dtype)`
// of the Pallas body before the P.V product.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// Elements of T in one 16-byte load.
template <typename T> __host__ __device__ constexpr int vec_width() {
  return 16 / static_cast<int>(sizeof(T));
}

// Load vec_width<T>() contiguous elements (16-byte aligned) as f32.
template <typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ src, float* dst) {
  constexpr int V = vec_width<T>();
  uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < V; ++i) dst[i] = to_f32<T>(e[i]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

constexpr int kMaxDevices = 64;

// Raise `kernel`'s dynamic shared-memory limit to `smem` bytes, once per
// device: `done` is the caller's per-kernel record of the devices already
// set, so later launches skip the driver call.
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t smem,
                                      bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

}  // namespace repro_torch
