// flash_prefill_bwd: the gradient of flash_prefill in f32, for Hopper.
//
// No TPU kernel corresponds: the JAX package has no custom_vjp and trains
// by differentiating `blockwise_attention` (src/repro/models/layers.py),
// the jnp attention that its forward calls; in the port that call is
// flash_prefill's kernel, so its gradient is a kernel too.
//
// Function: given q (B,T,Hq,D), k, v (B,S,Hkv,D), the forward's output o,
// its gradient dO and the forward's row log-sum-exp lse (B,Hq,T, -inf for a
// row with no valid key), compute dQ, dK, dV of softmax(scale*Q K^T + mask) V
// with causal / sliding-window masks and keys masked at S (q_offset 0: a
// training forward never sets it).  P is recomputed tile by tile as
// exp(scale*s - lse); the (T, S) matrix is never stored:
//   delta = rowsum(dO * O),  dP = dO V^T,  dS = P * (dP - delta),
//   dV = P^T dO,  dK = scale * dS^T Q,  dQ = scale * dS K.
//
// Layout.  For kv head h the G = Hq/Hkv query heads are flattened into
// T*G rows, row r = t*G + g, so a 64-row tile holds any G and K/V are
// never repeated.  Key tiles hold BK = 64 keys, 32 at D 256 (below).  Two
// launches, no atomics (results are the same bits on every run):
//   1. dq_kernel, one block per (64-row q tile, kv head, batch): computes
//      delta for its rows (written out for launch 2), then loops over the
//      key tiles its rows can see: S, dP, dS in registers, dS to shared
//      memory (transposed), dQ += dS K.
//   2. dkdv_kernel, one block per (BK-key tile, kv head, batch): loops over
//      the q tiles (all G heads of the kv head) that can see its keys:
//      S, P, dP, dS in registers, P and dS to shared memory, then
//      dV += P^T dO and dK += dS^T Q, held in registers until the end.
// Only the tiles the causal and window masks leave open are visited; the
// element masks apply everywhere.
//
// What bounds it on the H100: operations.  The function needs about 10 D
// operations per open (query, key) pair and head (4 D forward recomputed
// and 6 D of products); this design does 14 D (S and dP are computed in
// both launches), as IEEE f32 FMAs on the CUDA cores (67 TFLOP/s; no
// TF32, so that training holds the f32 reference).  Each thread owns a
// 4 x BK/16 micro-tile of S and dP (rows ty + 16i, keys tx + 16j) and reads
// its operands as 16-byte vectors from shared memory (8 FMAs per load);
// rows are padded by 4 floats so that 8 consecutive rows fall on 8
// distinct 16-byte bank groups.  Simple by design: a later PR can move
// the products to the tensor cores.
//
// Head dim 256 (recurrentgemma-2b): with 64-key tiles both launches would
// need ~266 KB of shared memory (over the 227 KB a block may take), and
// dkdv 128 accumulators a thread for dK and dV.  So key tiles hold 32 keys
// at D 256: dq's tiles take 209 KB and dkdv's 219 KB, and a dkdv thread
// owns 2 keys x 16 columns of each of dK and dV (64 accumulators).
//
// ptxas (-Xptxas -v, sm_90a), registers and dynamic shared memory, no
// spills: dq<64> 122, 87,552 B; dq<80> 128, 103,936 B; dq<128> 166,
// 153,088 B; dkdv<64> 168, 104,960 B; dkdv<80> 168, 121,344 B; dkdv<128>
// 204, 170,496 B; dq<256> 166, 208,896 B; dkdv<256> 168, 218,624 B (1
// block of 8 warps per SM, except dq<64> and dq<80>: 2).
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {
namespace bwd {

constexpr int kThreads = 256;
constexpr int kBQ = 64;       // flattened (position, head) rows per q tile
constexpr int kLQ = kBQ + 4;  // padded row of a [key][row] score tile

template <int D>
struct Tile {
  static constexpr int LD = D + 4;   // padded row of a Q / dO / K / V tile
  static constexpr int NC = D / 16;  // output columns a thread owns
  static constexpr int BK = D > 128 ? 32 : 64;  // keys per kv tile
  static constexpr int MJ = BK / 16;  // keys of a thread's score micro-tile
  static constexpr int LK = BK + 4;   // padded row of a [row][key] score tile
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;
  float* delta;
  float* dq;
  float* dk;
  float* dv;
  int T, S, Hq, Hkv, G, causal, window;
  float scale;
};

// element offset of flattened row r (position r / G, head r % G of kv
// head h) in a (B, T, Hq, D) tensor, and its index in a (B, Hq, T) one
__device__ __forceinline__ size_t row_offset(const Args& a, int b, int h, int r, int D) {
  const int t = r / a.G, g = r % a.G;
  return ((size_t)(b * a.T + t) * a.Hq + h * a.G + g) * D;
}
__device__ __forceinline__ size_t stat_index(const Args& a, int b, int h, int r) {
  const int t = r / a.G, g = r % a.G;
  return ((size_t)b * a.Hq + h * a.G + g) * a.T + t;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows r0 .. r0+63 of a (B, T, Hq, D) tensor into a padded tile; zeros past
// T*G
template <int D>
__device__ __forceinline__ void load_q_rows(float* dst, const float* __restrict__ src,
                                            const Args& a, int b, int h, int r0) {
  constexpr int LD = Tile<D>::LD, CH = D / 4;
  const int TG = a.T * a.G;
  for (int c = threadIdx.x; c < kBQ * CH; c += kThreads) {
    const int i = c / CH, cc = c % CH;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + i < TG)
      x = __ldg(reinterpret_cast<const float4*>(src + row_offset(a, b, h, r0 + i, D)) + cc);
    *reinterpret_cast<float4*>(dst + i * LD + cc * 4) = x;
  }
}

// keys k0 .. k0+BK-1 of kv head h of a (B, S, Hkv, D) tensor; zeros past S
template <int D>
__device__ __forceinline__ void load_k_rows(float* dst, const float* __restrict__ src,
                                            const Args& a, int b, int h, int k0) {
  constexpr int LD = Tile<D>::LD, CH = D / 4;
  for (int c = threadIdx.x; c < Tile<D>::BK * CH; c += kThreads) {
    const int j = c / CH, cc = c % CH;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k0 + j < a.S)
      x = __ldg(reinterpret_cast<const float4*>(
                    src + ((size_t)(b * a.S + k0 + j) * a.Hkv + h) * D) + cc);
    *reinterpret_cast<float4*>(dst + j * LD + cc * 4) = x;
  }
}

// s = Q K^T and dp = dO V^T on the thread's micro-tile: rows ty + 16i,
// keys tx + 16j; sums over d in order
template <int D>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs, const float* Ks,
                                       const float* Vs, int ty, int tx,
                                       float (&s)[4][Tile<D>::MJ],
                                       float (&dp)[4][Tile<D>::MJ]) {
  constexpr int LD = Tile<D>::LD, MJ = Tile<D>::MJ;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 qv[4], ov[4], kv[MJ], vv[MJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = ld4(Qs + (ty + 16 * i) * LD + d);
      ov[i] = ld4(dOs + (ty + 16 * i) * LD + d);
    }
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      kv[j] = ld4(Ks + (tx + 16 * j) * LD + d);
      vv[j] = ld4(Vs + (tx + 16 * j) * LD + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
        s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
        s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
        s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        dp[i][j] = fmaf(ov[i].x, vv[j].x, dp[i][j]);
        dp[i][j] = fmaf(ov[i].y, vv[j].y, dp[i][j]);
        dp[i][j] = fmaf(ov[i].z, vv[j].z, dp[i][j]);
        dp[i][j] = fmaf(ov[i].w, vv[j].w, dp[i][j]);
      }
  }
}

// whether flattened row r (position r / G) sees key kp
__device__ __forceinline__ bool visible(const Args& a, int r, int kp) {
  const int t = r / a.G;
  bool ok = r < a.T * a.G && kp < a.S;
  if (a.causal) ok = ok && kp <= t;
  if (a.window > 0) ok = ok && kp > t - a.window;
  return ok;
}

template <int D>
constexpr size_t dq_smem_floats() {
  return (size_t)(2 * kBQ + 2 * Tile<D>::BK) * Tile<D>::LD + Tile<D>::BK * kLQ + 2 * kBQ;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(Args a) {
  constexpr int LD = Tile<D>::LD, NC = Tile<D>::NC;
  constexpr int BK = Tile<D>::BK, MJ = Tile<D>::MJ;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kBQ * LD;
  float* Ks = dOs + kBQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSt = Vs + BK * LD;       // [key][row]
  float* lse_s = dSt + BK * kLQ;
  float* delta_s = lse_s + kBQ;

  const int n_qt = gridDim.x;
  // under a causal mask the last q tiles see the most keys: launch them first
  const int qt = a.causal ? n_qt - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int TG = a.T * a.G;
  const int r0 = qt * kBQ;
  const int tid = threadIdx.x;

  load_q_rows<D>(Qs, a.q, a, b, h, r0);
  load_q_rows<D>(dOs, a.dout, a, b, h, r0);
  {  // delta = rowsum(dO * O) and lse of this tile's rows, 4 threads a row
    const int i = tid >> 2, part = tid & 3;
    const int r = r0 + i;
    float sum = 0.f;
    if (r < TG) {
      const size_t off = row_offset(a, b, h, r, D);
      for (int d = 4 * part; d < D; d += 16) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(a.o + off + d));
        const float4 y = __ldg(reinterpret_cast<const float4*>(a.dout + off + d));
        sum = fmaf(x.x, y.x, sum);
        sum = fmaf(x.y, y.y, sum);
        sum = fmaf(x.z, y.z, sum);
        sum = fmaf(x.w, y.w, sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      float l = 0.f;
      if (r < TG) {
        const size_t si = stat_index(a, b, h, r);
        l = a.lse[si];
        a.delta[si] = sum;
      }
      lse_s[i] = l;
      delta_s[i] = sum;
    }
  }

  // keys this tile's positions can see
  const int t_lo = r0 / a.G, t_hi = (min(r0 + kBQ, TG) - 1) / a.G;
  const int k_end = a.causal ? min(a.S, t_hi + 1) : a.S;
  const int k_begin = (a.window > 0 ? max(0, t_lo - a.window + 1) : 0) / BK * BK;

  const int ty = tid >> 4, tx = tid & 15;  // score stage: rows ty+16i, keys tx+16j
  const int rq = tid >> 4, cy = tid & 15;  // dQ stage: rows 4rq..4rq+3, columns cy+16m
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < NC; ++m) acc[i][m] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's Ks / dSt reads are done
    load_k_rows<D>(Ks, a.k, a, b, h, k0);
    load_k_rows<D>(Vs, a.v, a, b, h, k0);
    __syncthreads();
    float s[4][MJ], dp[4][MJ];
    scores<D>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        const int key = tx + 16 * j;
        const float p = visible(a, r0 + row, k0 + key)
                            ? expf(fmaf(s[i][j], a.scale, -lse_s[row])) : 0.f;
        dSt[key * kLQ + row] = p * (dp[i][j] - delta_s[row]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 ds = ld4(dSt + j * kLQ + 4 * rq);
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const float kv = Ks[j * LD + cy + 16 * m];
        acc[0][m] = fmaf(ds.x, kv, acc[0][m]);
        acc[1][m] = fmaf(ds.y, kv, acc[1][m]);
        acc[2][m] = fmaf(ds.z, kv, acc[2][m]);
        acc[3][m] = fmaf(ds.w, kv, acc[3][m]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * rq + i;
    if (r < TG) {
      float* dst = a.dq + row_offset(a, b, h, r, D);
#pragma unroll
      for (int m = 0; m < NC; ++m) dst[cy + 16 * m] = acc[i][m] * a.scale;
    }
  }
}

template <int D>
constexpr size_t dkdv_smem_floats() {
  return (size_t)(2 * kBQ + 2 * Tile<D>::BK) * Tile<D>::LD + 2 * kBQ * Tile<D>::LK + 2 * kBQ;
}

// KPT contiguous floats of a score tile's row (16 bytes or 8)
template <int KPT>
__device__ __forceinline__ void ld_keys(const float* p, float (&x)[KPT]) {
  if constexpr (KPT == 4) {
    const float4 v = ld4(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    static_assert(KPT == 2, "4 or 2 keys a thread");
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) dkdv_kernel(Args a) {
  constexpr int LD = Tile<D>::LD, NC = Tile<D>::NC;
  constexpr int BK = Tile<D>::BK, MJ = Tile<D>::MJ, LK = Tile<D>::LK;
  constexpr int KPT = BK / 16;     // keys a thread owns in the dK/dV stage
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + kBQ * LD;
  float* Ps = dOs + kBQ * LD;     // [row][key]
  float* dSs = Ps + kBQ * LK;     // [row][key]
  float* lse_s = dSs + kBQ * LK;
  float* delta_s = lse_s + kBQ;

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y, b = blockIdx.z;
  const int TG = a.T * a.G;
  const int tid = threadIdx.x;
  load_k_rows<D>(Ks, a.k, a, b, h, k0);
  load_k_rows<D>(Vs, a.v, a, b, h, k0);

  // positions that can see this tile's keys, as flattened row tiles
  const int k_last = min(k0 + BK, a.S) - 1;
  const int t_begin = a.causal ? k0 : 0;
  const int t_end = a.window > 0 ? min(a.T, k_last + a.window) : a.T;
  const int rt_begin = t_begin * a.G / kBQ;
  const int rt_end = t_end > t_begin ? (t_end * a.G + kBQ - 1) / kBQ : rt_begin;

  const int ty = tid >> 4, tx = tid & 15;  // score stage: rows ty+16i, keys tx+16j
  const int kx = tid >> 4, cy = tid & 15;  // dK/dV stage: keys KPT kx + i, columns cy+16m
  float dk[KPT][NC], dv[KPT][NC];
#pragma unroll
  for (int i = 0; i < KPT; ++i)
#pragma unroll
    for (int m = 0; m < NC; ++m) dk[i][m] = dv[i][m] = 0.f;

  for (int rt = rt_begin; rt < rt_end; ++rt) {
    const int r0 = rt * kBQ;
    __syncthreads();  // the previous tile's Qs / dOs / Ps / dSs reads are done
    load_q_rows<D>(Qs, a.q, a, b, h, r0);
    load_q_rows<D>(dOs, a.dout, a, b, h, r0);
    if (tid < kBQ) {
      const int r = r0 + tid;
      const bool ok = r < TG;
      const size_t si = ok ? stat_index(a, b, h, r) : 0;
      lse_s[tid] = ok ? a.lse[si] : 0.f;
      delta_s[tid] = ok ? a.delta[si] : 0.f;
    }
    __syncthreads();
    float s[4][MJ], dp[4][MJ];
    scores<D>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        const int key = tx + 16 * j;
        const float p = visible(a, r0 + row, k0 + key)
                            ? expf(fmaf(s[i][j], a.scale, -lse_s[row])) : 0.f;
        Ps[row * LK + key] = p;
        dSs[row * LK + key] = p * (dp[i][j] - delta_s[row]);
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < kBQ; ++r) {
      float pk[KPT], dsk[KPT];
      ld_keys<KPT>(Ps + r * LK + KPT * kx, pk);
      ld_keys<KPT>(dSs + r * LK + KPT * kx, dsk);
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const float o = dOs[r * LD + cy + 16 * m];
        const float qv = Qs[r * LD + cy + 16 * m];
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          dv[i][m] = fmaf(pk[i], o, dv[i][m]);
          dk[i][m] = fmaf(dsk[i], qv, dk[i][m]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int key = k0 + KPT * kx + i;
    if (key < a.S) {
      const size_t off = ((size_t)(b * a.S + key) * a.Hkv + h) * D;
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        a.dk[off + cy + 16 * m] = dk[i][m] * a.scale;
        a.dv[off + cy + 16 * m] = dv[i][m];
      }
    }
  }
}

template <int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  static bool dq_set[kMaxDevices] = {}, dkdv_set[kMaxDevices] = {};
  constexpr size_t dq_smem = dq_smem_floats<D>() * sizeof(float);
  constexpr size_t dkdv_smem = dkdv_smem_floats<D>() * sizeof(float);
  cudaError_t err = allow_dynamic_smem(dq_kernel<D>, dq_smem, dq_set);
  if (err != cudaSuccess) return (int)err;
  err = allow_dynamic_smem(dkdv_kernel<D>, dkdv_smem, dkdv_set);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (a.T * a.G + kBQ - 1) / kBQ;
  const int n_kt = (a.S + Tile<D>::BK - 1) / Tile<D>::BK;
  if (n_qt > 0) {  // dQ, and delta for launch 2
    dq_kernel<D><<<dim3(n_qt, a.Hkv, B), kThreads, dq_smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_kt > 0)
    dkdv_kernel<D><<<dim3(n_kt, a.Hkv, B), kThreads, dkdv_smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace bwd
}  // namespace
}  // namespace repro_torch

// Plain C entry point, bound with ctypes.  All tensors f32 and contiguous:
// q, o, dout, dq (B,T,Hq,D); k, v, dk, dv (B,S,Hkv,D); lse and the scratch
// delta (B,Hq,T).  D is 64, 80, 128 or 256; Hq a multiple of Hkv; q_offset 0.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int flash_prefill_bwd_launch(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse,
                                        void* delta, void* dq, void* dk, void* dv, int B,
                                        int T, int S, int Hq, int Hkv, int D, int causal,
                                        int window, float scale, void* stream) {
  using namespace repro_torch;
  if (B == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || T < 0 || S < 0) return (int)cudaErrorInvalidValue;
  bwd::Args a{static_cast<const float*>(q),   static_cast<const float*>(k),
              static_cast<const float*>(v),   static_cast<const float*>(o),
              static_cast<const float*>(dout), static_cast<const float*>(lse),
              static_cast<float*>(delta),     static_cast<float*>(dq),
              static_cast<float*>(dk),        static_cast<float*>(dv),
              T, S, Hq, Hkv, Hq / Hkv, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return bwd::launch<64>(a, B, st);
  if (D == 80) return bwd::launch<80>(a, B, st);
  if (D == 128) return bwd::launch<128>(a, B, st);
  if (D == 256) return bwd::launch<256>(a, B, st);
  return (int)cudaErrorInvalidValue;
}
