// flash_prefill_bwd: the gradient of flash_prefill in f32, for Hopper, and
// the C entry point of both dtypes (bf16: flash_prefill_bwd_bf16.cu, its
// products on wgmma).  What the two sources share (arguments, row indexing,
// the tile ranges, the third launch) is in flash_prefill_bwd.cuh.
//
// No TPU kernel corresponds: the JAX package has no custom_vjp and trains
// by differentiating `blockwise_attention` (src/repro/models/layers.py),
// the jnp attention that its forward calls; in the port that call is
// flash_prefill's kernel, so its gradient is a kernel too.
//
// Function: given q (B,T,Hq,D), k, v (B,S,Hkv,D), the forward's output o,
// its gradient dO and the forward's row log-sum-exp lse (B,Hq,T, f32, -inf
// for a row with no valid key), compute dQ, dK, dV of softmax(scale*Q K^T +
// mask) V with causal / sliding-window masks and keys masked at S (q_offset
// 0: a training forward never sets it).  P is recomputed tile by tile as
// exp(scale*s - lse); the (T, S) matrix is never stored:
//   delta = rowsum(dO * O),  dP = dO V^T,  dS = P * (dP - delta),
//   dV = P^T dO,  dK = scale * dS^T Q,  dQ = scale * dS K.
// q, k, v, o, dO and the gradients are all f32 here; lse, delta and every
// sum are f32.
//
// Layout.  For kv head h the G = Hq/Hkv query heads are flattened into
// T*G rows, row r = t*G + g, so a tile holds any G and K/V are never
// repeated.  Two launches of 8 warps, no atomics (two calls give the same
// bits):
//   1. dq_kernel, one block per (q tile of 128 rows, 64 at D 256; kv head;
//      batch), heaviest causal tiles first: delta for its rows (written out
//      for launch 2), then a loop over the key tiles (32 keys, 16 at D 256)
//      its rows can see, K/V copied with cp.async into a 2-stage ring: each
//      warp owns 16 rows and computes S = Q K^T and dP = dO V^T, then P and
//      dS in registers, then dQ += dS K.
//   2. dkdv_kernel, one block per (key tile of 128 keys, 64 at D 256; range
//      of q tiles; kv head; batch): K and V stay in shared memory; q tiles
//      of 32 rows (16 at D >= 128: registers) stream through a 2-stage
//      cp.async ring with their lse and delta.  Each warp owns 16 keys and
//      computes S^T = K Q^T and dP^T = V dO^T, then P^T and dS^T in
//      registers, then dV += P^T dO and dK += dS^T Q, held in registers to
//      the end.
// At D 256 a warp's accumulated gradient (16 x 256) would take 128
// registers a lane beside the rest, and Q/dO (launch 1) or K/V (launch 2)
// fill the shared memory: so two warps share each 16 rows (16 keys), each
// summing S and dP over its half of D and owning that half of dQ (dK, dV);
// the halves of S and dP are swapped through shared memory and added, the
// same bits in both warps.
// Only the tiles the causal and window masks leave open are visited; the
// element masks apply on the tiles that straddle them.  The bf16 kernels
// walk the same ranges on their own tiles.
//
// A full card.  Where launch 2 would have fewer than two waves of blocks
// (n_kt * Hkv * B < 2 * SMs: recurrentgemma-2b's 64 key tiles at T 4096,
// Hkv 1, B 1), the wrapper splits each key tile's q tiles into n_split =
// min(4, ceil(2 * SMs / blocks)) contiguous ranges (flash_prefill.py,
// `bwd_split`); each range's block writes its partial dK and dV (unscaled,
// f32) into scratch (2, n_split, B, S, Hkv, D), and a third launch sums the
// partials in range order, scales dK and writes both in the inputs' dtype.
//
// What bounds it on the H100: operations.  The function needs about 10 D
// operations per open (query, key) pair and head (4 D forward recomputed
// and 6 D of products); this design does 14 D (S and dP are computed in
// both launches).
//
// Products: all on the tensor cores as mma.sync m16n8k8 TF32 in
// the 3xTF32 split (common.cuh: three TF32 products each, ~22 bits of each
// operand kept, so that training holds the f32 reference; one TF32 pass
// misses the gradient limit 28-53 times: tests/test_torch_attention_
// design.py).  Operands are split into big and small parts as the
// fragments are read from shared memory (a split tile would not fit at D
// 256).  Every tile's rows are padded to D + 4 floats, so that the lanes of
// a fragment load, read along rows (Q, dO, K, V as A or as K^T-style B) or
// across them (K in dS K, dO and Q in P^T dO and dS^T Q, the key or row
// order permuted to the accumulator's so that P and dS pass from
// accumulator to A fragment in registers), hit 32 banks.
//
// The tensor cores' sums truncate rather than round.  Chained in one
// accumulator over a long loop, that bias grows with the loop: over the
// 768 mma's of dQ's keys at recurrentgemma-2b's shape, or the 96 of S and
// dP at D 256, it took the f32 dQ past its limit.  So each tile's dS K, P^T
// dO and dS^T Q is summed in a fresh accumulator and added in f32 (round to
// nearest), and the small cross terms of S and dP are summed apart from
// big*big (mma3_lo).
//
// ptxas (-Xptxas -v, sm_90a), registers and dynamic shared memory, no
// spills, 1 block of 8 warps per SM: dq<f32,64> 164, 105,472 B;
// dq<f32,80> 172, 130,048 B; dq<f32,128> 214, 203,776 B; dq<f32,256> 195,
// 216,576 B; dkdv<f32,64> 219, 104,960 B; dkdv<f32,80> 253, 129,536 B;
// dkdv<f32,128> 255, 169,216 B; dkdv<f32,256> 255, 216,320 B; sum_parts
// 42, none.  The element masks and edge tests stay written out here: passed
// through helpers shared with the bf16 kernels they changed the registers
// of three of these instantiations.
#include <math.h>
#include <stdint.h>

#include "flash_prefill_bwd.cuh"

namespace repro_torch {
namespace bwd {
namespace {

// Both launches run 8 warps, each owning 16 rows (launch 1) or 16 keys
// (launch 2); at D 256 DS = 2 warps share them, each summing S and dP over
// its half of D and owning that half of the accumulated gradient.
constexpr int kThreads = 256;
template <int D>
struct Split {
  static constexpr int DS = D > 128 ? 2 : 1;
};

// Launch 1's tiles: kRows rows, kBK keys a step.
template <int D>
struct DqTile {
  static constexpr int kRows = 16 * 8 / Split<D>::DS;
  static constexpr int kBK = D > 128 ? 16 : 32;
};

// Launch 2's tiles: kBK keys, kBQ rows a step.
template <int D>
struct KvTile {
  static constexpr int kBK = 16 * 8 / Split<D>::DS;
  static constexpr int kBQ = D > 80 ? 16 : 32;
};

// The padded row of every tile (elements), and each lane's offset in a
// tile for a fragment read along rows (row g, column q) or across them
// (rows 2q, 2q + 1, column g, read one element at a time).  The kernels
// are templates on the element type E, which this file instantiates for
// f32 only.
template <typename E, int D>
struct Cols;
template <int D>
struct Cols<float, D> {
  static constexpr int LD = D + 4;
  static_assert(D % 8 == 0 && (LD % 32 == 4 || LD % 32 == 20),
                "flash_prefill_bwd: unsupported head_dim");
  static __device__ __forceinline__ int along(int lane) { return (lane >> 2) * LD + (lane & 3); }
  static __device__ __forceinline__ int across(int lane) {
    return 2 * (lane & 3) * LD + (lane >> 2);
  }
};

// rows r0 .. r0+R-1 of a (B, T, Hq, D) tensor into a padded tile, zeros
// past T*G (cp.async; the caller commits)
template <typename E, int D, int R, int kThreads>
__device__ __forceinline__ void load_rows(E* dst, const E* __restrict__ src, const Args<E>& a,
                                          int b, int h, int r0) {
  constexpr int LD = Cols<E, D>::LD, V = vec_width<E>(), CH = D / V;
  const int TG = a.T * a.G;
  for (int c = threadIdx.x; c < R * CH; c += kThreads) {
    const int i = c / CH, cc = c % CH;
    const bool ok = r0 + i < TG;
    cp_async16(dst + i * LD + cc * V, ok ? src + row_offset(a, b, h, r0 + i, D) + cc * V : src,
               ok);
  }
}

// keys k0 .. k0+N-1 of kv head h of a (B, S, Hkv, D) tensor, zeros past S
template <typename E, int D, int N, int kThreads>
__device__ __forceinline__ void load_keys(E* dst, const E* __restrict__ src, const Args<E>& a,
                                          int b, int h, int k0) {
  constexpr int LD = Cols<E, D>::LD, V = vec_width<E>(), CH = D / V;
  for (int c = threadIdx.x; c < N * CH; c += kThreads) {
    const int j = c / CH, cc = c % CH;
    const bool ok = k0 + j < a.S;
    cp_async16(dst + j * LD + cc * V,
               ok ? src + ((size_t)(b * a.S + k0 + j) * a.Hkv + h) * D + cc * V : src, ok);
  }
}

// acc[N][4] += A (16 x 8K) * B (8K x 8N) where A is an accumulator-layout
// tile s (16 x 8K, k-step kk in s[kk]) and B's rows 8kk + 2q, 8kk + 2q + 1
// are read at `b` + (8kk + 2q) * LD + 8n: the accumulator's column order
// (2q, 2q + 1) taken as the A fragment's (q, q + 4), B's rows permuted
// alike.  Each call's product is summed in a fresh accumulator and added
// to acc in f32 (round to nearest): the tensor cores' own sums truncate,
// and chained over a long loop (dQ over 2048 keys: 768 mma's) that bias
// took dQ past the gradient limit.
template <int K, int N, int LD>
__device__ __forceinline__ void acc_times_rows(float (&acc)[N][4], const float (&s)[K][4],
                                               const float* b) {
  constexpr int NC = N % 4 == 0 ? 4 : 5;
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += NC) {
    float t[NC][4];
#pragma unroll
    for (int n = 0; n < NC; ++n) t[n][0] = t[n][1] = t[n][2] = t[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const FragA a = frag_a(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
      const float* bk = b + 8 * kk * LD + 8 * n0;
      FragB bf[NC];
#pragma unroll
      for (int n = 0; n < NC; ++n) bf[n] = frag_b(bk[8 * n], bk[LD + 8 * n]);
      mma3(t, a, bf);
    }
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + n][e] += t[n][e];
  }
}

// s (16 x 8N) = A B^T and dp = A2 B2^T over K k-steps of 8 columns: A, A2
// rows of 16 read at a, a2 (lane offset included), B, B2 rows of 8N at b,
// b2.  big*big and the small cross terms are summed apart (mma3_lo): in
// one accumulator, the truncation of 96 chained mma's (D 256) biased dP
// enough to take dQ past its limit.
template <int LD, int K, int N>
__device__ __forceinline__ void two_products(float (&s)[N][4], float (&dp)[N][4],
                                             const float* a, const float* a2, const float* b,
                                             const float* b2) {
  float s_lo[N][4], dp_lo[N][4];
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = s_lo[j][e] = dp_lo[j][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < K; ++kk) {
    const float* x = a + 8 * kk;
    const float* y = a2 + 8 * kk;
    const FragA fa = frag_a(x[0], x[8 * LD], x[4], x[8 * LD + 4]);
    const FragA fa2 = frag_a(y[0], y[8 * LD], y[4], y[8 * LD + 4]);
    FragB fb[N], fb2[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float* u = b + 8 * j * LD + 8 * kk;
      const float* w = b2 + 8 * j * LD + 8 * kk;
      fb[j] = frag_b(u[0], u[4]);
      fb2[j] = frag_b(w[0], w[4]);
    }
    mma3_lo(s, s_lo, fa, fb);
    mma3_lo(dp, dp_lo, fa2, fb2);
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] += s_lo[j][e];
      dp[j][e] += dp_lo[j][e];
    }
}

// Where two warps (w and w ^ 4) each summed s and dp over half of D: add
// the other warp's halves through shared memory xs (2 N float4 a lane and
// warp); x + y == y + x, so both warps hold the same bits after.  Contains
// a __syncthreads.
template <int N>
__device__ __forceinline__ void add_other_half(float (&s)[N][4], float (&dp)[N][4],
                                               float4* xs, int warp, int lane) {
  float4* mine = xs + warp * 2 * N * 32 + lane;
  const float4* other = xs + (warp ^ 4) * 2 * N * 32 + lane;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    mine[j * 32] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
    mine[(N + j) * 32] = make_float4(dp[j][0], dp[j][1], dp[j][2], dp[j][3]);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float4 x = other[j * 32], y = other[(N + j) * 32];
    s[j][0] += x.x; s[j][1] += x.y; s[j][2] += x.z; s[j][3] += x.w;
    dp[j][0] += y.x; dp[j][1] += y.y; dp[j][2] += y.z; dp[j][3] += y.w;
  }
}

// floats of add_other_half's exchange for N column tiles, or none
template <int D, int N>
constexpr int exchange_floats() { return Split<D>::DS > 1 ? 8 * 2 * N * 32 * 4 : 0; }

template <typename E, int D>
constexpr size_t dq_smem_bytes() {
  using Tl = DqTile<D>;
  return (size_t)(2 * Tl::kRows + 4 * Tl::kBK) * Cols<E, D>::LD * sizeof(E) +
         (size_t)(2 * Tl::kRows + exchange_floats<D, Tl::kBK / 8>()) * sizeof(float);
}

template <typename E, int D>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(Args<E> a, int n_qt) {
  using Tl = DqTile<D>;
  using C = Cols<E, D>;
  constexpr int kRows = Tl::kRows, BK = Tl::kBK, DS = Split<D>::DS;
  constexpr int LD = C::LD, NT = BK / 8, DW = D / DS, NW = DW / 8;
  constexpr int TPR = kThreads / kRows;  // threads a row in the delta pass
  constexpr int V = vec_width<E>();
  extern __shared__ float4 smem4[];
  E* Qs = reinterpret_cast<E*>(smem4);
  E* dOs = Qs + kRows * LD;
  E* Ks = dOs + kRows * LD;     // [2] stages
  E* Vs = Ks + 2 * BK * LD;     // [2] stages
  float* lse_s = reinterpret_cast<float*>(Vs + 2 * BK * LD);  // lse * log2(e)
  float* delta_s = lse_s + kRows;
  float4* xs = reinterpret_cast<float4*>(delta_s + kRows);  // add_other_half

  const int hb = a.Hkv * a.B;
  const int rank = blockIdx.x / hb;
  // under a causal mask the last q tiles see the most keys: launch them first
  const int qt = a.causal ? n_qt - 1 - rank : rank;
  const int h = (blockIdx.x % hb) % a.Hkv, b = (blockIdx.x % hb) / a.Hkv;
  const int TG = a.T * a.G;
  const int rb = qt * kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q4 = lane & 3;

  // keys this tile's positions can see
  const DqRange kr = dq_range(a, rb, kRows, BK);
  const int t_lo = kr.t_lo, t_hi = kr.t_hi, k_begin = kr.k_begin, n_tiles = kr.n_tiles;

  load_rows<E, D, kRows, kThreads>(Qs, a.q, a, b, h, rb);
  load_rows<E, D, kRows, kThreads>(dOs, a.dout, a, b, h, rb);
  auto load_kv = [&](int tile, int stage) {
    const int k0 = k_begin + tile * BK;
    load_keys<E, D, BK, kThreads>(Ks + stage * BK * LD, a.k, a, b, h, k0);
    load_keys<E, D, BK, kThreads>(Vs + stage * BK * LD, a.v, a, b, h, k0);
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();
  if (n_tiles > 1) load_kv(1, 1);
  cp_async_commit();

  {  // delta = rowsum(dO * O) and lse of this tile's rows, TPR threads a row
    const int i = tid / TPR, part = tid % TPR;
    const int r = rb + i;
    float sum = 0.f;
    if (r < TG) {
      const size_t off = row_offset(a, b, h, r, D);
      for (int d = V * part; d < D; d += V * TPR) {
        float x[V], y[V];
        load_vec<E>(a.o + off + d, x);
        load_vec<E>(a.dout + off + d, y);
#pragma unroll
        for (int e = 0; e < V; ++e) sum = fmaf(x[e], y[e], sum);
      }
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (part == 0) {
      float l = 0.f;
      if (r < TG) {
        const size_t si = stat_index(a, b, h, r);
        l = a.lse[si] * kLog2e;
        a.delta[si] = sum;
      }
      lse_s[i] = l;
      delta_s[i] = sum;
    }
  }

  const int dh = warp / (8 / DS);  // this warp's half of D (DS = 2)
  const int rw = warp % (8 / DS) * 16;  // this warp's first row of the tile
  const int r0 = rw + g;  // this lane's rows r0, r0 + 8 of the tile
  const int c0 = dh * DW;
  const int tp0 = (rb + r0) / a.G, tp1 = (rb + r0 + 8) / a.G;
  const float scale_log2 = a.scale * kLog2e;
  float acc[NW][4];
#pragma unroll
  for (int n = 0; n < NW; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<1>();
    __syncthreads();  // (the first also publishes lse_s and delta_s)
    const E* ks = Ks + (it & 1) * BK * LD;
    const E* vs = Vs + (it & 1) * BK * LD;
    float s[NT][4], dp[NT][4];
    two_products<LD, DW / 8, NT>(s, dp, Qs + rw * LD + c0 + C::along(lane),
                                 dOs + rw * LD + c0 + C::along(lane), ks + c0 + C::along(lane),
                                 vs + c0 + C::along(lane));
    if constexpr (DS == 2) add_other_half(s, dp, xs, warp, lane);
    const float l2[2] = {lse_s[r0], lse_s[r0 + 8]};
    const float dl[2] = {delta_s[r0], delta_s[r0 + 8]};
    const int k0 = k_begin + it * BK;
    const bool edge = k0 + BK > a.S || (a.causal && k0 + BK - 1 > t_lo) ||
                      (a.window > 0 && k0 <= t_hi - a.window);
    // dS in place of S: element e of column tile j is (row r0 + 8 (e >> 1),
    // key k0 + 8 j + 2 q + (e & 1))
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool ok = true;
        if (edge) {
          const int kp = k0 + 8 * j + 2 * q4 + (e & 1);
          const int tp = e < 2 ? tp0 : tp1;
          ok = kp < a.S;
          if (a.causal) ok = ok && kp <= tp;
          if (a.window > 0) ok = ok && kp > tp - a.window;
        }
        const float p = ok ? exp2f(fmaf(s[j][e], scale_log2, -l2[e >> 1])) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[e >> 1]);
      }
    }
    // dQ += dS K: K's rows read across, in the accumulator's key order
    acc_times_rows<NT, NW, LD>(acc, s, ks + c0 + C::across(lane));
    __syncthreads();  // every warp is done with this stage
    if (it + 2 < n_tiles) load_kv(it + 2, it & 1);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rb + r0 + 8 * i;
    if (r >= TG) continue;
    E* dst = a.dq + row_offset(a, b, h, r, D) + c0 + 2 * q4;
#pragma unroll
    for (int n = 0; n < NW; ++n)
      store2(dst + 8 * n, acc[n][2 * i] * a.scale, acc[n][2 * i + 1] * a.scale);
  }
}

template <typename E, int D>
constexpr size_t dkdv_smem_bytes() {
  using Tl = KvTile<D>;
  return (size_t)(2 * Tl::kBK + 4 * Tl::kBQ) * Cols<E, D>::LD * sizeof(E) +
         (size_t)(4 * Tl::kBQ + exchange_floats<D, Tl::kBQ / 8>()) * sizeof(float);
}

template <typename E, int D>
__global__ void __launch_bounds__(kThreads, 1) dkdv_kernel(Args<E> a) {
  using Tl = KvTile<D>;
  using C = Cols<E, D>;
  constexpr int BK = Tl::kBK, BQ = Tl::kBQ, DS = Split<D>::DS, KG = 8 / DS;
  constexpr int LD = C::LD, NQ = BQ / 8, DW = D / DS, NW = DW / 8;
  extern __shared__ float4 smem4[];
  E* Ks = reinterpret_cast<E*>(smem4);
  E* Vs = Ks + BK * LD;
  E* Qs = Vs + BK * LD;         // [2] stages
  E* dOs = Qs + 2 * BQ * LD;    // [2] stages
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * LD);  // [2] stages
  float* delta_s = lse_s + 2 * BQ;  // [2] stages
  float4* xs = reinterpret_cast<float4*>(delta_s + 2 * BQ);  // add_other_half

  const int hb = a.Hkv * a.B;
  const int rank = blockIdx.x / hb;  // key tile, then range: key tile 0 first
  const int kt = rank / a.n_split, sp = rank % a.n_split;
  const int h = (blockIdx.x % hb) % a.Hkv, b = (blockIdx.x % hb) / a.Hkv;
  const int k0 = kt * BK;
  const int TG = a.T * a.G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q4 = lane & 3;

  // q tiles (of BQ flattened rows) that can see this key tile, and this
  // block's contiguous range of them
  const KvRange qr = kv_range(a, k0, sp, BK, BQ);
  const int rt_lo = qr.rt_lo, n_tiles = qr.n_tiles;

  load_keys<E, D, BK, kThreads>(Ks, a.k, a, b, h, k0);
  load_keys<E, D, BK, kThreads>(Vs, a.v, a, b, h, k0);
  auto load_q = [&](int tile, int stage) {
    const int r0 = (rt_lo + tile) * BQ;
    load_rows<E, D, BQ, kThreads>(Qs + stage * BQ * LD, a.q, a, b, h, r0);
    load_rows<E, D, BQ, kThreads>(dOs + stage * BQ * LD, a.dout, a, b, h, r0);
    if (tid < 2 * BQ) {  // the rows' lse and delta (zeros past T*G)
      const int i = tid % BQ, r = r0 + i;
      const bool ok = r < TG;
      const float* src = tid < BQ ? a.lse : a.delta;
      cp_async4((tid < BQ ? lse_s : delta_s) + stage * BQ + i,
                ok ? src + stat_index(a, b, h, r) : src, ok);
    }
  };
  if (n_tiles > 0) load_q(0, 0);
  cp_async_commit();
  if (n_tiles > 1) load_q(1, 1);
  cp_async_commit();

  const int kg = warp % KG, dh = warp / KG;
  const int kr = 16 * kg + g;  // this lane's keys kr, kr + 8 of the tile
  const int kp[2] = {k0 + kr, k0 + kr + 8};
  const float scale_log2 = a.scale * kLog2e;
  float dk[NW][4], dv[NW][4];
#pragma unroll
  for (int n = 0; n < NW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<1>();
    __syncthreads();
    const int stage = it & 1;
    const E* qs = Qs + stage * BQ * LD;
    const E* os = dOs + stage * BQ * LD;
    const float* ls = lse_s + stage * BQ;
    const float* ds = delta_s + stage * BQ;
    const int r0 = (rt_lo + it) * BQ;
    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys by the tile's
    // rows, summed over this warp's DW of the D columns
    float s[NQ][4], dp[NQ][4];
    const int c0 = dh * DW + C::along(lane);
    two_products<LD, DW / 8, NQ>(s, dp, Ks + 16 * kg * LD + c0, Vs + 16 * kg * LD + c0, qs + c0,
                                 os + c0);
    if constexpr (DS == 2) add_other_half(s, dp, xs, warp, lane);
    const bool edge = k0 + BK > a.S || r0 + BQ > TG ||
                      (a.causal && k0 + BK - 1 > r0 / a.G) ||
                      (a.window > 0 && k0 <= (r0 + BQ - 1) / a.G - a.window);
    // P^T in s, dS^T in dp: element e of column tile j is (key kp[e >> 1],
    // row r0 + 8 j + 2 q + (e & 1))
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int row = 8 * j + 2 * q4 + c;
        const float l2 = ls[row] * kLog2e, dl = ds[row];
        const int tp = (r0 + row) / a.G;
#pragma unroll
        for (int kh = 0; kh < 2; ++kh) {
          const int e = 2 * kh + c;
          bool ok = true;
          if (edge) {
            ok = kp[kh] < a.S && r0 + row < TG;
            if (a.causal) ok = ok && kp[kh] <= tp;
            if (a.window > 0) ok = ok && kp[kh] > tp - a.window;
          }
          const float p = ok ? exp2f(fmaf(s[j][e], scale_log2, -l2)) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dl);
        }
      }
    }
    // dV += P^T dO, dK += dS^T Q over this warp's DW columns: dO's and Q's
    // rows read across, in the accumulator's row order
    acc_times_rows<NQ, NW, LD>(dv, s, os + dh * DW + C::across(lane));
    acc_times_rows<NQ, NW, LD>(dk, dp, qs + dh * DW + C::across(lane));
    __syncthreads();  // every warp is done with this stage
    if (it + 2 < n_tiles) load_q(it + 2, stage);
    cp_async_commit();
  }
  cp_async_wait<0>();

  const size_t N = (size_t)a.B * a.S * a.Hkv * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kp[i] >= a.S) continue;
    const size_t off = ((size_t)(b * a.S + kp[i]) * a.Hkv + h) * D + dh * DW + 2 * q4;
#pragma unroll
    for (int n = 0; n < NW; ++n) {
      if (a.n_split == 1) {
        store2(a.dk + off + 8 * n, dk[n][2 * i] * a.scale, dk[n][2 * i + 1] * a.scale);
        store2(a.dv + off + 8 * n, dv[n][2 * i], dv[n][2 * i + 1]);
      } else {
        store2(a.part + sp * N + off + 8 * n, dk[n][2 * i], dk[n][2 * i + 1]);
        store2(a.part + (a.n_split + sp) * N + off + 8 * n, dv[n][2 * i], dv[n][2 * i + 1]);
      }
    }
  }
}

template <typename E, int D>
int launch(const Args<E>& a, cudaStream_t stream) {
  static bool dq_set[kMaxDevices] = {}, dkdv_set[kMaxDevices] = {};
  constexpr size_t dq_smem = dq_smem_bytes<E, D>();
  constexpr size_t dkdv_smem = dkdv_smem_bytes<E, D>();
  cudaError_t err = allow_dynamic_smem(dq_kernel<E, D>, dq_smem, dq_set);
  if (err != cudaSuccess) return (int)err;
  err = allow_dynamic_smem(dkdv_kernel<E, D>, dkdv_smem, dkdv_set);
  if (err != cudaSuccess) return (int)err;
  const long long hb = (long long)a.Hkv * a.B;
  const int n_qt = (a.T * a.G + DqTile<D>::kRows - 1) / DqTile<D>::kRows;
  const int n_kt = (a.S + KvTile<D>::kBK - 1) / KvTile<D>::kBK;
  const long long dq_blocks = n_qt * hb, kv_blocks = (long long)n_kt * a.n_split * hb;
  if (dq_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (dq_blocks > 0) {  // dQ, and delta for launch 2
    dq_kernel<E, D><<<(unsigned)dq_blocks, kThreads, dq_smem, stream>>>(a, n_qt);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (kv_blocks == 0) return 0;
  dkdv_kernel<E, D><<<(unsigned)kv_blocks, kThreads, dkdv_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_parts(a, D, stream);
}

template <typename E>
Args<E> make_args(const void* q, const void* k, const void* v, const void* o, const void* o32,
                  const void* dout, const void* lse, void* delta, void* dq, void* dk, void* dv,
                  void* part, int B, int T_len, int S, int Hq, int Hkv, int causal, int window,
                  int n_split, float scale) {
  return Args<E>{static_cast<const E*>(q),    static_cast<const E*>(k),
                 static_cast<const E*>(v),    static_cast<const E*>(o),
                 static_cast<const E*>(dout), static_cast<const float*>(lse),
                 static_cast<float*>(delta),  static_cast<E*>(dq),
                 static_cast<E*>(dk),         static_cast<E*>(dv),
                 static_cast<float*>(part),   static_cast<const float*>(o32),
                 B,                           T_len,
                 S,                           Hq,
                 Hkv,                         Hq / Hkv,
                 causal,                      window,
                 n_split,                     scale};
}

}  // namespace
}  // namespace bwd
}  // namespace repro_torch

// Plain C entry point, bound with ctypes.  dtype: 0 = float32, 1 =
// bfloat16, the type of q, k, v, dout and the gradients, all contiguous:
// q, dout, dq (B,T,Hq,D); k, v, dk, dv (B,S,Hkv,D); the forward's output,
// (B,T,Hq,D): o in f32 (dtype 0; o32 null), or o32, f32 before its bf16
// rounding (dtype 1; o null); lse and the scratch delta (B,Hq,T), f32;
// part: null at n_split 1, else the f32 scratch (2, n_split, B, S, Hkv, D)
// of launch 2's partial sums.  D is 64, 80 (f32
// only), 128 or 256; Hq a multiple of Hkv; q_offset 0; n_split in 1..4.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int flash_prefill_bwd_launch(const void* q, const void* k, const void* v,
                                        const void* o, const void* o32, const void* dout,
                                        const void* lse, void* delta, void* dq, void* dk,
                                        void* dv, void* part, int B, int T, int S, int Hq,
                                        int Hkv, int D, int causal, int window, int n_split,
                                        float scale, int dtype, void* stream) {
  using namespace repro_torch;
  if (B == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || T < 0 || S < 0 || n_split < 1 || n_split > 4 ||
      (n_split > 1 && part == nullptr) || (dtype == 1) != (o32 != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const auto a = bwd::make_args<float>(q, k, v, o, nullptr, dout, lse, delta, dq, dk, dv, part,
                                         B, T, S, Hq, Hkv, causal, window, n_split, scale);
    if (D == 64) return bwd::launch<float, 64>(a, st);
    if (D == 80) return bwd::launch<float, 80>(a, st);
    if (D == 128) return bwd::launch<float, 128>(a, st);
    if (D == 256) return bwd::launch<float, 256>(a, st);
  } else if (dtype == 1) {
    const auto a = bwd::make_args<bwd::bf16>(q, k, v, nullptr, o32, dout, lse, delta, dq, dk, dv,
                                             part, B, T, S, Hq, Hkv, causal, window, n_split,
                                             scale);
    return bwd::launch_bf16(a, D, st);
  }
  return (int)cudaErrorInvalidValue;
}
