// flash_prefill: GQA prefill attention with an online softmax, for Hopper.
//
// Replaces the TPU kernel `flash_prefill` (src/repro/kernels/flash_prefill.py,
// `_flash_kernel`).  Same function: q (B,T,Hq,D) attends over k, v
// (B,S,Hkv,D) with causal / sliding-window / q_offset masks and keys masked
// at S; m, l and the accumulator stay in f32; p is rounded to v's dtype
// before P.V; the output is in q's dtype.  A row with no valid key returns
// zeros (as `repro.kernels.ref.flash_prefill_ref` does; the Pallas kernel
// returns the mean of V there because its NEG_INF is finite).
//
// Layout.  One thread block per (q tile, kv head, batch).  The tile holds
// the G = Hq/Hkv query heads of that kv head for block_q = 64/G query
// positions, stacked as rows (row = i*G + g), so K/V are read once per
// tile and never repeated.  The TPU grid's sequential kv axis, with m/l/acc
// in VMEM scratch, becomes a loop over 32-key tiles inside the block; only
// the key tiles that the causal and window masks leave open are visited.
//
// What bounds it on the H100: at llama3-8b (T=1024, causal) the work is
// ~8.6 GFLOP, ~9 us at the 989 TFLOP/s bf16 tensor-core peak, against
// ~21 MB (~6 us at 3.35 TB/s): operations.  This first version does the
// products as IEEE f32 FMAs on the CUDA cores (f32 inputs keep full
// precision, no TF32), so it is far from the tensor-core bound; moving
// QK^T and PV onto wgmma is the later fix.
//
// Threads: 256 (8 warps).  Scores: lane j holds key j of the tile and warp
// w the rows w, w+8, ...; each warp does its rows' softmax update with
// shuffles.  P.V: thread (row group, d) owns column d of 64/(256/D) rows.
// At D=256 (recurrentgemma-2b: Hq 10, Hkv 1, so G=10 and block_q = 6, 60 of
// the 64 rows used) the tiles take 140 KB of shared memory (one block per
// SM) and each thread holds the accumulator of one column over all 64 rows.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;                     // G * block_q rows per tile
constexpr int kBK = 32;                       // keys per tile, one per lane
constexpr int kRowsPerWarp = kRows / kWarps;  // score rows per warp

template <int D>
constexpr size_t smem_floats() {
  return kRows * D          // Q tile
         + kBK * (D + 1)    // K tile, padded: lane j reads row j conflict-free
         + kBK * D          // V tile
         + kRows * kBK      // P tile
         + 2 * kRows;       // alpha, l
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int T_len,
                     int S, int Hq, int Hkv, int G, int block_q, int causal,
                     int window, int q_offset, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kRows * D;
  float* Vs = Ks + kBK * (D + 1);
  float* Ps = Vs + kBK * D;
  float* alpha_s = Ps + kRows * kBK;
  float* l_s = alpha_s + kRows;

  constexpr int V = vec_width<T>();
  constexpr int kRG = kThreads / D;       // row groups in the P.V stage
  constexpr int kAccRows = kRows / kRG;   // rows per thread in P.V

  const int t0 = blockIdx.x * block_q;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nt = min(block_q, T_len - t0);  // query positions in this tile
  const int rows = nt * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Q tile: for query i the G heads of kv head h are G*D contiguous values.
  const int q_chunks = G * D / V;
  for (int c = tid; c < block_q * q_chunks; c += kThreads) {
    const int i = c / q_chunks, cc = c % q_chunks;
    float* dst = Qs + i * G * D + cc * V;
    if (i < nt) {
      load_vec(q + ((size_t)(b * T_len + t0 + i) * Hq + h * G) * D + cc * V, dst);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) dst[e] = 0.f;
    }
  }

  float m_r[kRowsPerWarp], l_r[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_r[i] = -INFINITY;
    l_r[i] = 0.f;
  }
  const int d = tid % D, rg = tid / D;
  float acc[kAccRows];
#pragma unroll
  for (int i = 0; i < kAccRows; ++i) acc[i] = 0.f;

  // keys that the masks can leave open for this tile's query positions
  const int p_lo = q_offset + t0, p_hi = q_offset + t0 + nt - 1;
  const int k_end = causal ? min(S, p_hi + 1) : S;
  int k_begin = window > 0 ? max(0, p_lo - window + 1) : 0;
  k_begin = (k_begin / kBK) * kBK;

  const int k_chunks = D / V;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // previous tile's Ks/Vs/Ps reads are done
    for (int c = tid; c < kBK * k_chunks; c += kThreads) {
      const int j = c / k_chunks, cc = c % k_chunks;
      float tk[V], tv[V];
      if (k0 + j < S) {
        const size_t off = ((size_t)(b * S + k0 + j) * Hkv + h) * D + cc * V;
        load_vec(k + off, tk);
        load_vec(v + off, tv);
      } else {  // zeros, so that p = 0 never meets a NaN of stale memory
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

    // scores for (row, key lane), then the online-softmax update per row
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const float* krow = Ks + lane * (D + 1);
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      const float kv = krow[dd];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        s[i] = fmaf(Qs[(warp + kWarps * i) * D + dd], kv, s[i]);
    }
    const int kp = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = warp + kWarps * i;
      const int qp = q_offset + t0 + row / G;
      bool ok = kp < S && row < rows;
      if (causal) ok = ok && kp <= qp;
      if (window > 0) ok = ok && kp > qp - window;
      const float sv = ok ? s[i] * scale : -INFINITY;
      const float m_new = fmaxf(m_r[i], warp_max(sv));
      float p = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {
        p = ok ? expf(sv - m_new) : 0.f;
        alpha = expf(m_r[i] - m_new);
      }
      l_r[i] = alpha * l_r[i] + warp_sum(p);
      m_r[i] = m_new;
      Ps[row * kBK + lane] = round_to<T>(p);
      if (lane == 0) alpha_s[row] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P.V
#pragma unroll
    for (int i = 0; i < kAccRows; ++i) acc[i] *= alpha_s[rg + kRG * i];
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float vv = Vs[j * D + d];
#pragma unroll
      for (int i = 0; i < kAccRows; ++i)
        acc[i] = fmaf(Ps[(rg + kRG * i) * kBK + j], vv, acc[i]);
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) l_s[warp + kWarps * i] = l_r[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kAccRows; ++i) {
    const int row = rg + kRG * i;
    if (row < rows) {
      const int qi = row / G, g = row % G;
      const float l = l_s[row];
      const float o = l > 0.f ? acc[i] / l : 0.f;
      out[((size_t)(b * T_len + t0 + qi) * Hq + h * G + g) * D + d] = from_f32<T>(o);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int T_len, int S, int Hq, int Hkv, int causal, int window,
           int q_offset, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int block_q = kRows / G;
  static bool smem_set[kMaxDevices] = {};
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err =
      allow_dynamic_smem(flash_prefill_kernel<T, D>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_len + block_q - 1) / block_q, Hkv, B);
  flash_prefill_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), T_len, S, Hq, Hkv, G,
      block_q, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Plain C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Tensors are contiguous in the JAX layouts; D is 64, 128 or 256; Hq/Hkv <= 64.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* out, int B, int T,
                                    int S, int Hq, int Hkv, int D, int causal,
                                    int window, int q_offset, float scale,
                                    int dtype, void* stream) {
  using namespace repro_torch;
  if (B == 0 || T == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kRows) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, out, B, T, S, Hq, Hkv, causal, window, q_offset, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, out, B, T, S, Hq, Hkv, causal, window, q_offset, scale, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, B, T, S, Hq, Hkv, causal, window, q_offset, scale, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, B, T, S, Hq, Hkv, causal, window, q_offset, scale, st);
  if (dtype == 0 && D == 256)
    return launch<float, 256>(q, k, v, out, B, T, S, Hq, Hkv, causal, window, q_offset, scale, st);
  if (dtype == 1 && D == 256)
    return launch<__nv_bfloat16, 256>(q, k, v, out, B, T, S, Hq, Hkv, causal, window, q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}
