// What flash_prefill's two backward sources share: the launches' arguments,
// the flattened-row indexing, the tile walk (which key tiles a block of rows
// visits, which q tiles a key tile's block visits), the output stores, and
// the third launch that sums split dK/dV partials.  flash_prefill_bwd.cu
// holds the f32 kernels and the C entry point; flash_prefill_bwd_bf16.cu the
// bf16 kernels.  The element masks are written out in each kernel: passed
// through a shared helper they changed the f32 kernels' registers.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace bwd {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

template <typename E>
struct Args {
  const E* q;
  const E* k;
  const E* v;
  const E* o;
  const E* dout;
  const float* lse;
  float* delta;
  E* dq;
  E* dk;
  E* dv;
  float* part;  // (2, n_split, B, S, Hkv, D) partial dK, dV; null at n_split 1
  int B, T, S, Hq, Hkv, G, causal, window, n_split;
  float scale;
};

// element offset of flattened row r (position r / G, head r % G of kv
// head h) in a (B, T, Hq, D) tensor, and its index in a (B, Hq, T) one
template <typename E>
__device__ __forceinline__ size_t row_offset(const Args<E>& a, int b, int h, int r, int D) {
  const int t = r / a.G, g = r % a.G;
  return ((size_t)(b * a.T + t) * a.Hq + h * a.G + g) * D;
}
template <typename E>
__device__ __forceinline__ size_t stat_index(const Args<E>& a, int b, int h, int r) {
  const int t = r / a.G, g = r % a.G;
  return ((size_t)b * a.Hq + h * a.G + g) * a.T + t;
}

// Launch 1: the key tiles of BK keys that rows rb .. rb + R - 1 (clipped
// at T*G) can see, positions t_lo .. t_hi
struct DqRange {
  int t_lo, t_hi, k_begin, n_tiles;
};
template <typename E>
__device__ __forceinline__ DqRange dq_range(const Args<E>& a, int rb, int R, int BK) {
  const int TG = a.T * a.G;
  DqRange r;
  r.t_lo = rb / a.G;
  r.t_hi = (min(rb + R, TG) - 1) / a.G;
  const int k_end = a.causal ? min(a.S, r.t_hi + 1) : a.S;
  r.k_begin = (a.window > 0 ? max(0, r.t_lo - a.window + 1) : 0) / BK * BK;
  r.n_tiles = k_end > r.k_begin ? (k_end - r.k_begin + BK - 1) / BK : 0;
  return r;
}

// Launch 2: the first of the q tiles (of BQ flattened rows) that can see
// keys k0 .. k0 + BK - 1, in range sp of n_split, and how many there are
struct KvRange {
  int rt_lo, n_tiles;
};
template <typename E>
__device__ __forceinline__ KvRange kv_range(const Args<E>& a, int k0, int sp, int BK, int BQ) {
  const int k_last = min(k0 + BK, a.S) - 1;
  const int t_begin = a.causal ? k0 : 0;
  const int t_end = a.window > 0 ? min(a.T, k_last + a.window) : a.T;
  const int rt_begin = t_begin * a.G / BQ;
  const int rt_end = t_end > t_begin ? (t_end * a.G + BQ - 1) / BQ : rt_begin;
  const int n_rt = rt_end - rt_begin;
  KvRange r;
  r.rt_lo = rt_begin + n_rt * sp / a.n_split;
  r.n_tiles = rt_begin + n_rt * (sp + 1) / a.n_split - r.rt_lo;
  return r;
}

namespace {

// two adjacent outputs of a lane, as T
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
}

// four f32 as four T at p (16-byte aligned for f32, 8 for bf16)
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(bf16* p, float4 x) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
}

// Launch 3 (n_split > 1): dK = scale * sum of the partials, dV = their sum,
// in range order; n4 = B*S*Hkv*D / 4
template <typename E>
__global__ void __launch_bounds__(256) sum_parts_kernel(Args<E> a, size_t n4) {
  const float4* pk = reinterpret_cast<const float4*>(a.part);
  const float4* pv = pk + (size_t)a.n_split * n4;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 sk = pk[i], sv = pv[i];
    for (int p = 1; p < a.n_split; ++p) {
      const float4 x = pk[p * n4 + i], y = pv[p * n4 + i];
      sk.x += x.x; sk.y += x.y; sk.z += x.z; sk.w += x.w;
      sv.x += y.x; sv.y += y.y; sv.z += y.z; sv.w += y.w;
    }
    store4(a.dk + 4 * i,
           make_float4(sk.x * a.scale, sk.y * a.scale, sk.z * a.scale, sk.w * a.scale));
    store4(a.dv + 4 * i, sv);
  }
}

// Launch 3 at head dim D, where launch 2 was split
template <typename E>
int sum_parts(const Args<E>& a, int D, cudaStream_t stream) {
  if (a.n_split == 1) return 0;
  const size_t n4 = (size_t)a.B * a.S * a.Hkv * D / 4;
  const unsigned blocks = (unsigned)((n4 + 255) / 256 < 1024 ? (n4 + 255) / 256 : 1024);
  sum_parts_kernel<E><<<blocks, 256, 0, stream>>>(a, n4);
  return (int)cudaGetLastError();
}

}  // namespace

// The bf16 launches (flash_prefill_bwd_bf16.cu): cudaError_t, 0 on success
int launch_bf16(const Args<bf16>& a, int D, cudaStream_t stream);

}  // namespace bwd
}  // namespace repro_torch
