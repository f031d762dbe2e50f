// decode_attention: one new token per sequence attends over its KV cache,
// split over the cache's rows (flash-decoding), for Hopper.
//
// Replaces the TPU kernel `decode_attention`
// (src/repro/kernels/decode_attention.py, `_decode_kernel`).  Same function:
// q (B,Hq,D) against caches (B,S,Hkv,D), keys masked at the per-sequence
// `lengths[b]`, softmax with f32 m/l/acc, p rounded to the cache dtype
// before P.V while l sums the unrounded p, output in q's dtype.  A sequence
// with length 0 returns zeros (as `repro.kernels.ref` does for empty
// prefill rows; the Pallas kernel returns the mean of V).  The serving
// engine never asks for one: a free slot attends over min(0 + 1, S) = 1
// position.
//
// What bounds it on the H100: bytes.  At llama3-8b (B=8, 1024 valid rows of
// 2048, Hkv 8, D 128) the valid K+V is 33.5 MB, ~10 us at 3.35 TB/s; at
// recurrentgemma-2b (B=8, Hkv 1, D 256) 8.4 MB, ~2.5 us.  A grid of one
// block per (kv head, batch) is 64 and 8 blocks against 132 SMs, each
// waiting on one tile at a time, so the design is about enough loads in
// flight:
//
// Pass 1, grid (split, Hkv, B): each block reads one contiguous slice of
// `chunk` cache rows (a multiple of 128; the wrapper picks it from the
// shapes and the SM count alone, never from `lengths`, so the call needs
// no host sync) with cp.async (16 bytes a thread) into a 2-stage ring of
// K/V tiles kept in the cache's dtype, so that the copy of tile j+1 runs
// under the arithmetic of tile j.  It serves the G query heads of its kv
// head together (each row is read once) and writes f32 partials m, l and
// acc[D] per head into scratch that the wrapper allocates.  A slice wholly
// past lengths[b] exits at once with m = -inf, l = 0.
//
// bf16 (`tc::`, every served path): 64-row tiles; each of the 4 warps is a
// flash-decoding worker over 16 rows of every tile, with the G heads as
// the rows of one m16n8k16 tile (G <= 16, padded with zeros): q.K^T and P.V
// on the tensor cores (bf16 operands, f32 sums), the softmax in the 4 lanes
// that hold a head, as in flash_prefill.  At the end the warps' (m, l, acc)
// are merged in shared memory into the split's partial.  Tensor cores,
// because on the CUDA cores the G FMAs per cached element (10 at
// recurrentgemma-2b) and their conversions, not the bytes, set the time.
//
// f32 (`f32::`, no served path; the models' f32 parity runs): IEEE f32 FMAs
// on the CUDA cores (no TF32) over 32-row tiles; lane j holds key j of the
// tile, warp w the heads w, w+4, ...; in P.V thread (8-column group, head
// group) owns 8 columns of its heads.
//
// Pass 2, one group of threads per (batch, query head): combines the
// splits in split order, so that results are identical run to run:
// o = sum_i exp(m_i - m) acc_i / sum_i exp(m_i - m) l_i, with m the largest
// m_i; an empty split (m_i = -inf) adds nothing, and a sequence with no
// valid row gives zeros.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8) and the dynamic shared memory of
// each instantiation; no static shared memory, no spills in any:
//   tc<64>             64 registers,  39,168 B
//   tc<128>           124 registers,  73,984 B (3 blocks per SM)
//   tc<256>           167 registers, 143,616 B (1 block per SM)
//   f32<64,  G<=4/16>  40 / 62 registers,  36,384 / 41,088 B
//   f32<128, G<=4/16>  40 / 64 registers,  70,176 / 77,952 B
//   f32<256, G<=4/16>  40 / 90 registers, 137,760 / 151,680 B
//   combine (all)      32 registers, none
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;  // 4 warps, both passes
constexpr int kWarps = kThreads / 32;

// ---------------------------------------------------------------- f32 --
namespace f32 {

constexpr int kTK = 32;        // cache rows per tile, one per lane
constexpr int kStages = 2;
constexpr int kLP = kTK + 1;  // P row stride: heads of a warp hit other banks

// GM is the head bound of one instantiation: 4 (llama3-8b's G) or 16
template <int GM, int D>
constexpr size_t smem_bytes() {
  return (size_t)kStages * 2 * kTK * (D + 4) * sizeof(float)  // K/V ring
         + (size_t)GM * D * sizeof(float)                     // q rows
         + (size_t)GM * kLP * sizeof(float)                   // P tile
         + (size_t)GM * sizeof(float);                        // alpha
}

// 8 contiguous floats (16-byte aligned, in shared memory)
__device__ __forceinline__ void load8(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  *reinterpret_cast<float4*>(dst + 4) = *reinterpret_cast<const float4*>(src + 4);
}

template <int D, int GM>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const float* __restrict__ q, const float* __restrict__ kc,
                    const float* __restrict__ vc, const int* __restrict__ lengths,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int S, int Hq, int Hkv, int G,
                    int chunk, int n_split, float scale) {
  using T = float;
  constexpr int V = vec_width<T>();
  constexpr int LD = D + V;            // elements per ring row (16-byte pad)
  constexpr int CH = D / V;            // 16-byte chunks per row
  constexpr int NCG = D / 8;           // 8-column groups in P.V
  constexpr int NHG = kThreads / NCG;  // head groups in P.V
  constexpr int HPT = (GM + NHG - 1) / NHG;  // heads per thread in P.V
  constexpr int HPW = GM / kWarps;     // heads per warp in the score stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);   // [kStages][kTK][LD]
  T* Vs = Ks + kStages * kTK * LD;          // [kStages][kTK][LD]
  float* Qs = reinterpret_cast<float*>(Vs + kStages * kTK * LD);  // [GM][D]
  float* Ps = Qs + GM * D;                  // [GM][kLP]
  float* alpha_s = Ps + GM * kLP;           // [GM]

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = min(max(lengths[b], 0), S);
  const int r_begin = split * chunk;
  const int r_end = min(r_begin + chunk, len);
  // partials of head g of this kv head: index part0 + g * n_split
  const size_t part0 = ((size_t)b * Hq + h * G) * n_split + split;
  if (r_begin >= r_end) {  // the slice lies wholly past the valid rows
    for (int g = tid; g < G; g += kThreads) {
      part_m[part0 + (size_t)g * n_split] = -INFINITY;
      part_l[part0 + (size_t)g * n_split] = 0.f;
    }
    return;
  }
  const int n_tiles = (r_end - r_begin + kTK - 1) / kTK;

  auto load_tile = [&](int tile, int stage) {
    const int r0 = r_begin + tile * kTK;
    T* ks = Ks + stage * kTK * LD;
    T* vs = Vs + stage * kTK * LD;
    for (int c = tid; c < kTK * CH; c += kThreads) {
      const int j = c / CH, cc = c % CH;
      const bool ok = r0 + j < r_end;   // rows past the slice: zeros
      const size_t off = ok ? ((size_t)(b * S + r0 + j) * Hkv + h) * D + cc * V : 0;
      cp_async16(ks + j * LD + cc * V, kc + off, ok);
      cp_async16(vs + j * LD + cc * V, vc + off, ok);
    }
  };
  // one commit group per tile (empty past the last): the wait below always
  // leaves exactly the next tile in flight
  load_tile(0, 0);
  cp_async_commit();
  if (n_tiles > 1) load_tile(1, 1);
  cp_async_commit();

  // the G heads of kv head h are G*D contiguous values; heads past G are 0
  for (int c = tid; c < GM * CH; c += kThreads) {
    const int g = c / CH;
    float* dst = Qs + c * V;
    if (g < G) {
      load_vec(q + ((size_t)b * Hq + h * G) * D + c * V, dst);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) dst[e] = 0.f;
    }
  }

  float m_r[HPW], l_r[HPW];
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    m_r[i] = -INFINITY;
    l_r[i] = 0.f;
  }
  const int cg = tid % NCG, hg = tid / NCG;
  float acc[HPT][8];
#pragma unroll
  for (int i = 0; i < HPT; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<1>();
    __syncthreads();  // tile `it` has landed (and q is in shared memory)
    const T* ks = Ks + (it & 1) * kTK * LD;
    const T* vs = Vs + (it & 1) * kTK * LD;

    // scores of key `lane` for this warp's heads
    float s[HPW];
#pragma unroll
    for (int i = 0; i < HPW; ++i) s[i] = 0.f;
    const T* krow = ks + lane * LD;
#pragma unroll 4
    for (int c = 0; c < D / 8; ++c) {
      float kf[8];
      load8(krow + c * 8, kf);
#pragma unroll
      for (int i = 0; i < HPW; ++i) {
        if (warp + kWarps * i < G) {  // warp-uniform
          const float4* qv = reinterpret_cast<const float4*>(Qs + (warp + kWarps * i) * D + c * 8);
          const float4 q0 = qv[0], q1 = qv[1];
          s[i] = fmaf(q0.x, kf[0], s[i]);
          s[i] = fmaf(q0.y, kf[1], s[i]);
          s[i] = fmaf(q0.z, kf[2], s[i]);
          s[i] = fmaf(q0.w, kf[3], s[i]);
          s[i] = fmaf(q1.x, kf[4], s[i]);
          s[i] = fmaf(q1.y, kf[5], s[i]);
          s[i] = fmaf(q1.z, kf[6], s[i]);
          s[i] = fmaf(q1.w, kf[7], s[i]);
        }
      }
    }
    // online softmax over the tile; key 0 of every tile is valid, so m is
    // finite after the first
    const bool valid = r_begin + it * kTK + lane < r_end;
#pragma unroll
    for (int i = 0; i < HPW; ++i) {
      const int g = warp + kWarps * i;
      if (g < G) {
        const float sv = valid ? s[i] * scale : -INFINITY;
        const float m_new = fmaxf(m_r[i], warp_max(sv));
        const float p = valid ? expf(sv - m_new) : 0.f;
        const float alpha = expf(m_r[i] - m_new);
        l_r[i] = alpha * l_r[i] + warp_sum(p);
        m_r[i] = m_new;
        Ps[g * kLP + lane] = p;  // f32: the rounding to the cache dtype is exact
        if (lane == 0) alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P.V over 8 columns of this thread's heads
#pragma unroll
    for (int i = 0; i < HPT; ++i) {
      const int g = hg + NHG * i;
      if (g < G) {
        const float a = alpha_s[g];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] *= a;
      }
    }
#pragma unroll 4
    for (int j = 0; j < kTK; ++j) {
      float vf[8];
      load8(vs + j * LD + cg * 8, vf);
#pragma unroll
      for (int i = 0; i < HPT; ++i) {
        const int g = hg + NHG * i;
        if (g < G) {
          const float p = Ps[g * kLP + j];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(p, vf[e], acc[i][e]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage and P
    if (it + 2 < n_tiles) load_tile(it + 2, it & 1);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int g = warp + kWarps * i;
    if (g < G && lane == 0) {
      part_m[part0 + (size_t)g * n_split] = m_r[i];
      part_l[part0 + (size_t)g * n_split] = l_r[i];
    }
  }
#pragma unroll
  for (int i = 0; i < HPT; ++i) {
    const int g = hg + NHG * i;
    if (g < G) {
      float4* dst = reinterpret_cast<float4*>(part_acc + (part0 + (size_t)g * n_split) * D + cg * 8);
      dst[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      dst[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

template <int D, int GM>
int launch_split(const void* q, const void* kc, const void* vc, const void* lengths,
                 float* part_m, float* part_l, float* part_acc, int B, int S, int Hq,
                 int Hkv, int chunk, int n_split, float scale, cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {};
  constexpr size_t smem = smem_bytes<GM, D>();
  cudaError_t err = allow_dynamic_smem(decode_split_kernel<D, GM>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_split, Hkv, B);
  decode_split_kernel<D, GM><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kc), static_cast<const float*>(vc),
      static_cast<const int*>(lengths), part_m, part_l, part_acc, S, Hq, Hkv, Hq / Hkv,
      chunk, n_split, scale);
  return (int)cudaGetLastError();
}

}  // namespace f32

// --------------------------------------------------------------- bf16 --
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBK = 64;  // keys per tile: 16 for each warp

template <int D>
constexpr size_t smem_bytes() {
  // a 2-stage ring of K and V tiles and the q rows (G padded to 16), bf16,
  // rows padded by 16 bytes; the warps' partials reuse the ring at the end
  return (size_t)(2 * 2 * kBK + 16) * (D + 8) * sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_split_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                       const bf16* __restrict__ vc, const int* __restrict__ lengths,
                       float* __restrict__ part_m, float* __restrict__ part_l,
                       float* __restrict__ part_acc, int S, int Hq, int Hkv, int G,
                       int chunk, int n_split, float scale) {
  constexpr int LD = D + 8;   // bf16 per shared-memory row
  constexpr int CH = D / 8;   // 16-byte chunks per row
  constexpr int KS = D / 16;  // k-steps of q.K^T
  constexpr int ND = D / 8;   // 8-wide column blocks of the output
  constexpr int LO = D + 4;   // f32 per row of a warp's staged output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [2][kBK][LD]
  bf16* Vs = Ks + 2 * kBK * LD;                  // [2][kBK][LD]
  bf16* Qs = Vs + 2 * kBK * LD;                  // [16][LD]

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float scale_log2 = scale * 1.4426950408889634f;
  const int len = min(max(lengths[b], 0), S);
  const int r_begin = split * chunk;
  const int r_end = min(r_begin + chunk, len);
  const size_t part0 = ((size_t)b * Hq + h * G) * n_split + split;
  if (r_begin >= r_end) {  // the slice lies wholly past the valid rows
    for (int g = tid; g < G; g += kThreads) {
      part_m[part0 + (size_t)g * n_split] = -INFINITY;
      part_l[part0 + (size_t)g * n_split] = 0.f;
    }
    return;
  }
  const int n_tiles = (r_end - r_begin + kBK - 1) / kBK;

  // q rows: the G heads of kv head h (contiguous); rows past G are zero
  for (int c = tid; c < 16 * CH; c += kThreads) {
    const int g = c / CH, cc = c % CH;
    const bool ok = g < G;
    cp_async16(Qs + g * LD + cc * 8, ok ? q + ((size_t)b * Hq + h * G + g) * D + cc * 8 : q,
               ok);
  }
  auto load_tile = [&](int tile, int stage) {
    const int r0 = r_begin + tile * kBK;
    bf16* ks = Ks + stage * kBK * LD;
    bf16* vs = Vs + stage * kBK * LD;
    for (int c = tid; c < kBK * CH; c += kThreads) {
      const int j = c / CH, cc = c % CH;
      const bool ok = r0 + j < r_end;  // rows past the slice: zeros
      const size_t off = ok ? ((size_t)(b * S + r0 + j) * Hkv + h) * D + cc * 8 : 0;
      cp_async16(ks + j * LD + cc * 8, kc + off, ok);
      cp_async16(vs + j * LD + cc * 8, vc + off, ok);
    }
  };
  // one commit group per tile (empty past the last): the wait below always
  // leaves exactly the next tile in flight
  load_tile(0, 0);
  cp_async_commit();
  if (n_tiles > 1) load_tile(1, 1);
  cp_async_commit();

  // each warp is a flash-decoding worker over keys [16w, 16w + 16) of every
  // tile: its own m, l and output for rows (heads) lane/4 and lane/4 + 8
  const int kc0 = 2 * (lane & 3);
  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  const bf16* qrow = Qs + (lane & 15) * LD + (lane >> 4) * 8;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<1>();
    __syncthreads();  // tile `it` (and q) has landed for every thread
    const bf16* ks = Ks + (it & 1) * kBK * LD + warp * 16 * LD;
    const bf16* vs = Vs + (it & 1) * kBK * LD + warp * 16 * LD;

    // s = q K^T over this warp's 16 keys (two 8-key blocks)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const bf16* krow = ks + (((lane >> 4) << 3) + (lane & 7)) * LD + (((lane >> 3) & 1) << 3);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4], kb[4];
      ldmatrix_x4(a, qrow + kk * 16);
      ldmatrix_x4(kb, krow + kk * 16);
      mma_bf16_16816(s[0], a, kb[0], kb[1]);
      mma_bf16_16816(s[1], a, kb[2], kb[3]);
    }
    const int k0 = r_begin + it * kBK + warp * 16;
    if (k0 + 16 > r_end) {  // keys past the slice's valid rows
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + nb * 8 + kc0 + (e & 1) >= r_end) s[nb][e] = -INFINITY;
    }

    // online softmax; a warp with no valid key yet keeps m = -inf, p = 0
    float mx[2], msc[2], alpha[2];
    mx[0] = fmaxf(m_r[0], fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1])));
    mx[1] = fmaxf(m_r[1], fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3])));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      msc[i] = mx[i] == -INFINITY ? 0.f : mx[i] * scale_log2;
      alpha[i] = exp2f(m_r[i] * scale_log2 - msc[i]);
      m_r[i] = mx[i];
    }
    float p[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nb][e] = exp2f(fmaf(s[nb][e], scale_log2, -msc[e >> 1]));
    l_r[0] = alpha[0] * l_r[0] + (p[0][0] + p[0][1] + p[1][0] + p[1][1]);
    l_r[1] = alpha[1] * l_r[1] + (p[0][2] + p[0][3] + p[1][2] + p[1][3]);
    // P.V's A fragment: p rounded to bf16
    const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                            pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
    const bf16* vrow = vs + ((((lane >> 3) & 1) << 3) + (lane & 7)) * LD + ((lane >> 4) << 3);
#pragma unroll
    for (int nd = 0; nd < ND; nd += 2) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vrow + nd * 8);
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
      o[nd + 1][0] *= alpha[0];
      o[nd + 1][1] *= alpha[0];
      o[nd + 1][2] *= alpha[1];
      o[nd + 1][3] *= alpha[1];
      mma_bf16_16816(o[nd], pa, vb[0], vb[1]);
      mma_bf16_16816(o[nd + 1], pa, vb[2], vb[3]);
    }
    __syncthreads();  // every warp is done with this stage
    if (it + 2 < n_tiles) load_tile(it + 2, it & 1);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the warps' partials there

  float* Os = reinterpret_cast<float*>(smem_raw);  // [4][16][LO]
  float* Ms = Os + kWarps * 16 * LO;               // [4][16]
  float* Ls = Ms + kWarps * 16;                    // [4][16]
  const int r0 = lane >> 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
  if ((lane & 3) == 0) {
    Ms[warp * 16 + r0] = m_r[0];
    Ms[warp * 16 + r0 + 8] = m_r[1];
    Ls[warp * 16 + r0] = l_r[0];
    Ls[warp * 16 + r0 + 8] = l_r[1];
  }
  float* orow = Os + (warp * 16 + r0) * LO + kc0;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    *reinterpret_cast<float2*>(orow + nd * 8) = make_float2(o[nd][0], o[nd][1]);
    *reinterpret_cast<float2*>(orow + 8 * LO + nd * 8) = make_float2(o[nd][2], o[nd][3]);
  }
  __syncthreads();

  // merge the 4 warps into this split's partial: m in units of s * scale
  for (int c = tid; c < G * (D / 4); c += kThreads) {
    const int g = c / (D / 4), d = (c % (D / 4)) * 4;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, Ms[w * 16 + g]);
    // the slice has a valid row, so m is finite
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f((Ms[w * 16 + g] - m) * scale_log2);  // -inf: 0
      const float4 x = *reinterpret_cast<const float4*>(Os + (w * 16 + g) * LO + d);
      l = fmaf(wt, Ls[w * 16 + g], l);
      acc.x = fmaf(wt, x.x, acc.x);
      acc.y = fmaf(wt, x.y, acc.y);
      acc.z = fmaf(wt, x.z, acc.z);
      acc.w = fmaf(wt, x.w, acc.w);
    }
    const size_t pi = part0 + (size_t)g * n_split;
    *reinterpret_cast<float4*>(part_acc + pi * D + d) = acc;
    if (d == 0) {
      part_m[pi] = m * scale;
      part_l[pi] = l;
    }
  }
}

template <int D>
int launch_split(const void* q, const void* kc, const void* vc, const void* lengths,
                 float* part_m, float* part_l, float* part_acc, int B, int S, int Hq,
                 int Hkv, int chunk, int n_split, float scale, cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {};
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = allow_dynamic_smem(decode_split_tc_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_split, Hkv, B);
  decode_split_tc_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kc), static_cast<const bf16*>(vc),
      static_cast<const int*>(lengths), part_m, part_l, part_acc, S, Hq, Hkv, Hq / Hkv, chunk,
      n_split, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

// Pass 2: D/4 threads per (batch, query head) row, 4 columns each.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, T* __restrict__ out,
                      int n_rows, int n_split) {
  constexpr int TPR = D / 4;            // threads per row
  constexpr int RPB = kThreads / TPR;   // rows per block
  const int row = blockIdx.x * RPB + threadIdx.x / TPR;
  const int c = (threadIdx.x % TPR) * 4;
  if (row >= n_rows) return;
  const float* pm = part_m + (size_t)row * n_split;
  const float* pl = part_l + (size_t)row * n_split;
  const float* pa = part_acc + (size_t)row * n_split * D + c;
  float m = -INFINITY;
#pragma unroll 8
  for (int i = 0; i < n_split; ++i) m = fmaxf(m, pm[i]);
  float den = 0.f;
  float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
  // in split order; branch-free, so that the unrolled loads are in flight
  // together.  An empty split (m_i = -inf) adds exactly nothing: its weight
  // and values are 0, and its acc (never written) is not read.
#pragma unroll 8
  for (int i = 0; i < n_split; ++i) {
    const float mi = pm[i];
    const bool live = mi != -INFINITY;
    const float w = live ? expf(mi - m) : 0.f;
    const float li = live ? pl[i] : 0.f;
    const float4 a = live ? __ldg(reinterpret_cast<const float4*>(pa + (size_t)i * D))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    den = fmaf(w, li, den);
    num.x = fmaf(w, a.x, num.x);
    num.y = fmaf(w, a.y, num.y);
    num.z = fmaf(w, a.z, num.z);
    num.w = fmaf(w, a.w, num.w);
  }
  T* o = out + (size_t)row * D + c;
  const bool any = den > 0.f;  // no valid row: zeros
  o[0] = from_f32<T>(any ? num.x / den : 0.f);
  o[1] = from_f32<T>(any ? num.y / den : 0.f);
  o[2] = from_f32<T>(any ? num.z / den : 0.f);
  o[3] = from_f32<T>(any ? num.w / den : 0.f);
}

template <typename T, int D>
int launch(const void* q, const void* kc, const void* vc, const void* lengths, void* out,
           void* scratch, int B, int S, int Hq, int Hkv, int chunk, float scale,
           cudaStream_t stream) {
  const int n_split = (S + chunk - 1) / chunk;
  const int n_rows = B * Hq;
  // scratch: acc (B*Hq, n_split, D), then m and l (B*Hq, n_split)
  float* part_acc = static_cast<float*>(scratch);
  float* part_m = part_acc + (size_t)n_rows * n_split * D;
  float* part_l = part_m + (size_t)n_rows * n_split;
  if (n_split > 0) {
    int err;
    if constexpr (sizeof(T) == 2)
      err = tc::launch_split<D>(q, kc, vc, lengths, part_m, part_l, part_acc, B, S, Hq, Hkv,
                                chunk, n_split, scale, stream);
    else if (Hq / Hkv <= 4)
      err = f32::launch_split<D, 4>(q, kc, vc, lengths, part_m, part_l, part_acc, B, S,
                                       Hq, Hkv, chunk, n_split, scale, stream);
    else
      err = f32::launch_split<D, 16>(q, kc, vc, lengths, part_m, part_l, part_acc, B, S,
                                        Hq, Hkv, chunk, n_split, scale, stream);
    if (err != 0) return err;
  }
  constexpr int RPB = kThreads / (D / 4);
  decode_combine_kernel<T, D><<<(n_rows + RPB - 1) / RPB, kThreads, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), n_rows, n_split);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Plain C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// q (B,Hq,D), caches (B,S,Hkv,D) contiguous, lengths (B,) int32 on the
// device; D is 64, 128 or 256; Hq/Hkv <= 16; `chunk` (cache rows per
// block of pass 1) a positive multiple of 64 (the wrapper gives 128s); `scratch` holds
// B*Hq*ceil(S/chunk)*(D+2) f32.  Launches the two passes on `stream`;
// returns the cudaError_t of the launches (0 on success).
extern "C" int decode_attention_launch(const void* q, const void* k_cache,
                                       const void* v_cache, const void* lengths,
                                       void* out, void* scratch, int B, int S, int Hq,
                                       int Hkv, int D, int chunk, float scale, int dtype,
                                       void* stream) {
  using namespace repro_torch;
  if (B == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > 16 || chunk <= 0 || chunk % tc::kBK != 0 ||
      S < 0 || B > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k_cache, v_cache, lengths, out, scratch, B, S, Hq, Hkv, chunk, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k_cache, v_cache, lengths, out, scratch, B, S, Hq, Hkv, chunk, scale, st);
  if (dtype == 0 && D == 256)
    return launch<float, 256>(q, k_cache, v_cache, lengths, out, scratch, B, S, Hq, Hkv, chunk, scale, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k_cache, v_cache, lengths, out, scratch, B, S, Hq, Hkv, chunk, scale, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k_cache, v_cache, lengths, out, scratch, B, S, Hq, Hkv, chunk, scale, st);
  if (dtype == 1 && D == 256)
    return launch<__nv_bfloat16, 256>(q, k_cache, v_cache, lengths, out, scratch, B, S, Hq, Hkv, chunk, scale, st);
  return (int)cudaErrorInvalidValue;
}
