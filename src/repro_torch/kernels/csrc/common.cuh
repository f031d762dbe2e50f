// Shared helpers for the kernels: f32 <-> storage-type conversion, 16-byte
// vector loads, asynchronous copies (cp.async), bf16 tensor-core fragments
// (ldmatrix, mma.sync), f32 products on the tensor cores in the 3xTF32
// split, warp reductions, and the one-time shared-memory opt-in of a kernel.
#pragma once

#include <stdint.h>

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

// Asynchronous 16-byte copy global -> shared (cp.async, L2 only).  With
// `full` false nothing is read and the 16 bytes are zero-filled, so a
// tile's rows past the end need no second pass.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(n)
               : "memory");
}

// Asynchronous 4-byte copy global -> shared (through L1); zero-filled when
// `full` is false.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool full) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = full ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory; lane l gives the row address
// of matrix l/8, row l%8.  `trans` loads each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a (16x16 bf16, row-major) * b (16x8 bf16, column-major), f32 sums.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 (nearest even), `lo` in the low half: the
// element order of an mma fragment register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------- 3xTF32 --
// f32 products on the tensor cores: mma.sync m16n8k8 TF32 with f32 sums, each
// operand split as x = big + small with big = tf32(x), small = tf32(x - big),
// and small*big + big*small + big*big summed (the small*small term, ~2^-22 of
// the product, is dropped).  One TF32 pass keeps 11 bits of each operand,
// about 1e-3 of a product; the split keeps ~22.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// An m16n8k8 A fragment (rows g, g+8; columns q, q+4; g = lane / 4,
// q = lane % 4) and a B fragment (rows q, q+4; column g), each element split
// into big + small TF32 parts.  The accumulator holds rows g, g+8 and
// columns 2q, 2q+1.
struct FragA { uint32_t big[4], small[4]; };
struct FragB { uint32_t big[2], small[2]; };

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));   // x - big is exact
}

// a0 = (g, q), a1 = (g + 8, q), a2 = (g, q + 4), a3 = (g + 8, q + 4)
__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split(a0, f.big[0], f.small[0]);
  split(a1, f.big[1], f.small[1]);
  split(a2, f.big[2], f.small[2]);
  split(a3, f.big[3], f.small[3]);
  return f;
}

// b0 = (q, g), b1 = (q + 4, g)
__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split(b0, f.big[0], f.small[0]);
  split(b1, f.big[1], f.small[1]);
  return f;
}

// d += a (16x8, row-major) * b (8x8, column-major), TF32 in, f32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[n] += a * b[n] in 3xTF32: the two small cross terms, then big*big
template <int N>
__device__ __forceinline__ void mma3(float (&acc)[N][4], const FragA& a,
                                     const FragB (&b)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], a.small, b[n].big);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], a.big, b[n].small);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], a.big, b[n].big);
}

// The same with big*big summed in acc and the two small cross terms in lo
// (the caller adds lo to acc at the end): the tensor cores' sums truncate
// rather than round, and a long chain of them in one accumulator biases it;
// lo stays ~2^-10 of acc, where that bias is negligible.
template <int N>
__device__ __forceinline__ void mma3_lo(float (&acc)[N][4], float (&lo)[N][4], const FragA& a,
                                        const FragB (&b)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(lo[n], a.small, b[n].big);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(lo[n], a.big, b[n].small);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], a.big, b[n].big);
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
