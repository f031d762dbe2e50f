// decode_attention: one new token per sequence attends over its KV cache.
//
// Replaces the TPU kernel `decode_attention`
// (src/repro/kernels/decode_attention.py, `_decode_kernel`).  Same function:
// q (B,Hq,D) against caches (B,S,Hkv,D), keys masked at the per-sequence
// `lengths[b]`, online softmax with f32 m/l/acc, p rounded to the cache
// dtype before P.V, output in q's dtype.  A sequence with length 0 returns
// zeros (as `repro.kernels.ref` does for empty prefill rows; the Pallas
// kernel returns the mean of V).  The serving engine never asks for one: a
// free slot attends over min(0 + 1, S) = 1 position.
//
// Layout.  One thread block per (kv head, batch) serves the G grouped query
// heads together, so each cache row is read exactly once.  The TPU grid's
// sequential S axis becomes a loop over 32-key tiles inside the block, and
// only the tiles below lengths[b] are visited.
//
// What bounds it on the H100: bytes.  At B=8 with 1024 valid positions the
// valid K+V is 2*8*1024*8*128*2 B = 33.5 MB, ~10 us at 3.35 TB/s.  The
// (Hkv, B) grid is 64 blocks on 132 SMs and each block waits on one tile at
// a time, so this version reaches a fraction of that rate; a split-S pass
// plus a reduction (flash-decoding) is the later fix.
//
// Threads: max(128, D), so that every column has a thread in P.V (4 warps
// at D 64 and 128, 8 at D 256).  Scores: lane j holds key j of the tile,
// warp w the heads w, w + warps, ...; P.V: thread (head group, d) owns
// column d.  At recurrentgemma-2b's decode (Hkv 1, B 8) the grid is 8
// blocks: under a tenth of the SMs, which a split-S pass addresses.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kGMax = 16;                    // query heads per kv head
constexpr int kBS = 32;                      // keys per tile, one per lane

template <int D>
constexpr int threads() {
  return D > 128 ? D : 128;
}

template <int D>
constexpr size_t smem_floats() {
  return kGMax * D          // q rows
         + kBS * (D + 1)    // K tile, padded
         + kBS * D          // V tile
         + kGMax * kBS      // P tile
         + 2 * kGMax;       // alpha, l
}

template <typename T, int D, int kThreads>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int S, int Hq, int Hkv, int G, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kGMax * D;
  float* Vs = Ks + kBS * (D + 1);
  float* Ps = Vs + kBS * D;
  float* alpha_s = Ps + kGMax * kBS;
  float* l_s = alpha_s + kGMax;

  constexpr int V = vec_width<T>();
  constexpr int kWarps = kThreads / 32;
  constexpr int kHeadsPerWarp = kGMax / kWarps;
  constexpr int kRG = kThreads / D;        // head groups in the P.V stage
  constexpr int kAccRows = kGMax / kRG;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = min(max(lengths[b], 0), S);

  // the G heads of kv head h are G*D contiguous values
  const int q_chunks = G * D / V;
  for (int c = tid; c < q_chunks; c += kThreads)
    load_vec(q + ((size_t)b * Hq + h * G) * D + c * V, Qs + c * V);

  float m_r[kHeadsPerWarp], l_r[kHeadsPerWarp];
#pragma unroll
  for (int i = 0; i < kHeadsPerWarp; ++i) {
    m_r[i] = -INFINITY;
    l_r[i] = 0.f;
  }
  const int d = tid % D, rg = tid / D;
  float acc[kAccRows];
#pragma unroll
  for (int i = 0; i < kAccRows; ++i) acc[i] = 0.f;

  const int k_chunks = D / V;
  for (int k0 = 0; k0 < len; k0 += kBS) {
    __syncthreads();
    for (int c = tid; c < kBS * k_chunks; c += kThreads) {
      const int j = c / k_chunks, cc = c % k_chunks;
      float tk[V], tv[V];
      if (k0 + j < len) {
        const size_t off = ((size_t)(b * S + k0 + j) * Hkv + h) * D + cc * V;
        load_vec(kc + off, tk);
        load_vec(vc + off, tv);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) tk[e] = tv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        Ks[j * (D + 1) + cc * V + e] = tk[e];
        Vs[j * D + cc * V + e] = tv[e];
      }
    }
    __syncthreads();

    const float* krow = Ks + lane * (D + 1);
    const bool ok = k0 + lane < len;
#pragma unroll
    for (int i = 0; i < kHeadsPerWarp; ++i) {
      const int g = warp + kWarps * i;
      if (g >= G) break;  // warp-uniform
      float s = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < D; ++dd) s = fmaf(Qs[g * D + dd], krow[dd], s);
      const float sv = ok ? s * scale : -INFINITY;
      const float m_new = fmaxf(m_r[i], warp_max(sv));
      // k0 < len, so key k0 is valid and m_new is finite
      const float p = ok ? expf(sv - m_new) : 0.f;
      const float alpha = expf(m_r[i] - m_new);
      l_r[i] = alpha * l_r[i] + warp_sum(p);
      m_r[i] = m_new;
      Ps[g * kBS + lane] = round_to<T>(p);
      if (lane == 0) alpha_s[g] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kAccRows; ++i) {
      const int g = rg + kRG * i;
      if (g < G) acc[i] *= alpha_s[g];
    }
#pragma unroll 4
    for (int j = 0; j < kBS; ++j) {
      const float vv = Vs[j * D + d];
#pragma unroll
      for (int i = 0; i < kAccRows; ++i) {
        const int g = rg + kRG * i;
        if (g < G) acc[i] = fmaf(Ps[g * kBS + j], vv, acc[i]);
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kHeadsPerWarp; ++i) l_s[warp + kWarps * i] = l_r[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kAccRows; ++i) {
    const int g = rg + kRG * i;
    if (g < G) {
      const float l = l_s[g];
      const float o = l > 0.f ? acc[i] / l : 0.f;
      out[((size_t)b * Hq + h * G + g) * D + d] = from_f32<T>(o);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* kc, const void* vc, const void* lengths,
           void* out, int B, int S, int Hq, int Hkv, float scale,
           cudaStream_t stream) {
  constexpr int kThreads = threads<D>();
  static bool smem_set[kMaxDevices] = {};
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = allow_dynamic_smem(decode_attention_kernel<T, D, kThreads>,
                                       smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hkv, B);
  decode_attention_kernel<T, D, kThreads><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(lengths),
      static_cast<T*>(out), S, Hq, Hkv, Hq / Hkv, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Plain C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// q (B,Hq,D), caches (B,S,Hkv,D) contiguous, lengths (B,) int32 on the
// device; D is 64, 128 or 256; Hq/Hkv <= 16.  Returns the launch's cudaError_t.
extern "C" int decode_attention_launch(const void* q, const void* k_cache,
                                       const void* v_cache,
                                       const void* lengths, void* out, int B,
                                       int S, int Hq, int Hkv, int D,
                                       float scale, int dtype, void* stream) {
  using namespace repro_torch;
  if (B == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kGMax) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k_cache, v_cache, lengths, out, B, S, Hq, Hkv, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k_cache, v_cache, lengths, out, B, S, Hq, Hkv, scale, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k_cache, v_cache, lengths, out, B, S, Hq, Hkv, scale, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k_cache, v_cache, lengths, out, B, S, Hq, Hkv, scale, st);
  if (dtype == 0 && D == 256)
    return launch<float, 256>(q, k_cache, v_cache, lengths, out, B, S, Hq, Hkv, scale, st);
  if (dtype == 1 && D == 256)
    return launch<__nv_bfloat16, 256>(q, k_cache, v_cache, lengths, out, B, S, Hq, Hkv, scale, st);
  return (int)cudaErrorInvalidValue;
}
