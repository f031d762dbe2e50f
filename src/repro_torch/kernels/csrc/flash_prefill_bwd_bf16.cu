// flash_prefill_bwd_bf16: the gradient of flash_prefill in bf16, for
// Hopper, its five products on wgmma.
//
// No TPU kernel corresponds (see flash_prefill_bwd.cu, which holds the f32
// kernels and the C entry point that calls launch_bf16 here).  Function:
// dQ, dK, dV of softmax(scale*Q K^T + mask) V from q, k, v, its gradient
// dO (all bf16), the forward's output O in f32 (before its bf16 rounding:
// from the bf16 output delta is off by ~2^-9 |dO| |O|, a large share of
// dP - delta in a row with a few keys, where dQ then missed its limit at
// T 16384) and its row log-sum-exp lse (f32, -inf for a row with no valid
// key), P recomputed tile by tile:
//   delta = rowsum(dO * O),  dP = dO V^T,  dS = P * (dP - delta),
//   dV = P^T dO,  dK = scale * dS^T Q,  dQ = scale * dS K,
// every sum in f32; P and dS rounded to bf16 only as operands of dV, dK
// and dQ; the gradients written in bf16.
//
// What bounds it on the H100: operations.  The function needs 10 D
// operations per open (query, key) pair and head; this design does 14 D (S
// and dP in both launches): 0.1217 ms at 989 TFLOP/s for llama3-8b's
// training shape (B 4, T = S = 1024, Hq 32, Hkv 8, D 128, causal), 0.2281
// ms for recurrentgemma-2b's (B 1, T = S = 4096, Hq 10, Hkv 1, D 256,
// causal, window 2048), against ~40 and ~50 MB of inputs and outputs (12
// and 15 us at 3.35 TB/s).
//
// Design.  The walk is the f32 kernel's (the ranges in
// flash_prefill_bwd.cuh): the G query heads of a kv head flattened into T*G
// rows (row t*G + g), only the tiles the causal and window masks leave open
// visited, element masks only on the tiles that straddle them, heaviest
// tiles first, no atomics (two calls give the same bits), and the dK/dV
// launch split into q-tile ranges summed in order by a third launch where
// it would fill under one wave (flash_prefill.py, bwd_split).  Blocks of
// two warpgroups (256 threads, one block an SM); each product is issued by
// one warpgroup as wgmma (wgmma.cuh) on 64-row tiles, operands bf16 in
// shared memory in the 128-byte-swizzled layout, read K-major where they
// come from memory so and MN-major (transposed) where the product wants
// their other side, so no transpose is written.  P (P^T) and dS (dS^T)
// pass from the score accumulators to the register A operand in place: the
// m64nN accumulator's layout is the A operand's.
//   1. dq_kernel: 128 flattened rows a block, 64 a warpgroup (Q and dO kept
//      in shared memory), heaviest causal q tiles first.  It computes delta
//      for its rows (written out for launch 2), then walks the key tiles of
//      64 keys (32 at D 256) its rows can see; a warpgroup: S = Q K^T and
//      dP = dO V^T (ss, N = the keys), P while dP runs, dS, then dQ += dS K
//      (rs, K read MN-major, N = D).  A warpgroup whose rows see none of a
//      tile skips it.
//   2. dkdv_kernel: 128 keys a block, 64 a warpgroup (K and V kept), over
//      q steps of 64 rows with their lse and delta; a warpgroup: S^T = K Q^T
//      and dP^T = V dO^T (ss, N = 64 rows), P^T while dP^T runs, dV += P^T
//      dO (rs, dO MN-major, N = D) while dS^T is formed, then dK += dS^T Q,
//      which runs on into the next step.  At D 256 one warpgroup cannot hold
//      64 x 256 of both dK and dV (256 f32 a thread): both warpgroups take
//      the same 64 keys, one computing S^T, P^T and dV, the other dP^T and,
//      from P^T passed through shared memory in f32, dS^T and dK.  Each
//      holds 128 accumulators of its gradient, 32 of its scores and 16 of
//      its A operand; the tensor work splits evenly.
// The exponentials run on the special-function unit as ex2.approx.ftz
// (exp2f's denormal-safe form was the longest phase of a step), masks
// compare keys with rows (kp * G <= r) and rows divide by G through a
// precomputed reciprocal, so no integer division (which also takes the
// special-function unit) is left in the loops.
//
// Shared memory (bytes, with 1 KB to align the base to the swizzle's
// 1024-byte period): launch 1: Q and dO 2 x 128 rows, a 2-stage ring of K
// and V (64 keys; 32 at D 256), lse and delta: D 64 67,584; D 128 133,120;
// D 256 198,656.  Launch 2: K and V (128 keys; 64 at D 256), a 4-stage ring
// of Q and dO (64 rows) with their lse and delta, 2 stages at D 256 with
// the 16 KB P^T exchange: D 64 101,376; D 128 199,680; D 256 215,040.
// Registers (launch 2, D 128, a thread): dK and dV 64 f32 each, S^T and
// dP^T 32 each, P^T and dS^T 16 each.
//
// Copies.  Every tile comes in by cp.async (16 bytes a thread, zero-filled
// past T*G or S, so masked elements never meet stale memory), with the
// proxy fence that hands the copies to wgmma, as the forward does.  The
// flattened Q/dO rows of launch 2 are whole positions only where G divides
// the tile (not at recurrentgemma-2b's G 10), so they stay cp.async; TMA
// for launch 1's key tiles is left for a later change.  With the lock step
// of the two warpgroups (one barrier a step, so exponentials and copies
// leave the tensor cores idle), the copies are what holds the kernel back
// most: launch 2 at D 256 re-reads 64 KB of Q and dO a step for every 64
// keys (1.35 GB at recurrentgemma-2b's training shape).
//
// Sums.  dQ, dK and dV accumulate in the wgmma accumulators across all
// tiles (scale_d 1).  The tensor cores' sums truncate: the bias of a chained
// f32 sum is about n_steps * 2^-24 of it, ~1.5e-5 over llama3-8b's 256
// 16-row steps of dK/dV and ~8e-5 over recurrentgemma-2b's ~1280 (~320 a
// range), far below the bf16 gradient limit (0.2 of the rms plus 2^-6 of
// |plain|): the f32 kernel sums each tile apart for f32's 1e-4 limit, this
// one need not.
//
// ptxas (-Xptxas -v, sm_90a), registers, no spills and no wgmma
// serialized, one block of 256 threads an SM: dq<64> 200, dq<128> 228,
// dq<256> 226; dkdv<64> 219, dkdv<128> 252, dkdv<256> 240; sum_parts 44.
#include <math.h>
#include <stdint.h>

#include "flash_prefill_bwd.cuh"
#include "wgmma.cuh"

namespace repro_torch {
namespace bwd {
namespace {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kWg = 64;        // rows (keys) a warpgroup's product covers

// Launch 1's tiles: kRows flattened rows a block, kBK keys a step (K and V
// in a 2-stage ring).
template <int D>
struct DqTiles {
  static constexpr int kRows = 2 * kWg;
  static constexpr int kBK = D > 128 ? 32 : 64;
};

// Launch 2's tiles: kBK keys a block, kBQ rows a step; at D 256 (kShared)
// both warpgroups take the same 64 keys.
template <int D>
struct KvTiles {
  static constexpr bool kShared = D > 128;
  static constexpr int kBK = kShared ? kWg : 2 * kWg;
  static constexpr int kBQ = 64;
  static constexpr int kStages = kShared ? 2 : 4;  // of the Q/dO ring (shared memory)
};

// The rings.  Launch 1 (and launch 2 at D 256, where shared memory holds 2
// stages only) keeps two tiles in flight in 2 stages: a step waits for its
// last product, and its stage is refilled after a second barrier.  Launch
// 2 at D <= 128 lets a step's last product (dK += dS^T Q, which reads the
// step's stage) run on into the next step, under its barrier and first
// products, so a stage is refilled two steps after its tile's use: kStages
// - 2 tiles in flight ahead of the one in use, their copies issued while
// the step's first products run.  (Launch 1 so pipelined was slower: ptxas
// serialized its products for want of registers.)

// Flattened row r as (position r / G, head r % G) without an integer
// division, whose reciprocal would take the special-function unit the
// exponentials need: g_mul = floor((2^32 - 1) / G) + 1 (from the host) and
// r / G = (r * g_mul) >> 32, exact for r < 2^32 / G (launch() keeps T*G
// below 2^26).
__device__ __forceinline__ int div_g(int r, uint64_t g_mul) {
  return (int)(((uint64_t)(uint32_t)r * g_mul) >> 32);
}
__device__ __forceinline__ size_t row_offset_m(const Args<bf16>& a, int b, int h, int r, int D,
                                               uint64_t g_mul) {
  const int t = div_g(r, g_mul), g = r - t * a.G;
  return ((size_t)(b * a.T + t) * a.Hq + h * a.G + g) * D;
}
__device__ __forceinline__ size_t stat_index_m(const Args<bf16>& a, int b, int h, int r,
                                               uint64_t g_mul) {
  const int t = div_g(r, g_mul), g = r - t * a.G;
  return ((size_t)b * a.Hq + h * a.G + g) * a.T + t;
}

// Whether keys k0 .. k0 + BK - 1 against positions t_lo .. t_hi straddle
// a mask (or S), so that element masks apply
__device__ __forceinline__ bool edge_tile(const Args<bf16>& a, int k0, int BK, int t_lo, int t_hi) {
  return k0 + BK > a.S || (a.causal && k0 + BK - 1 > t_lo) ||
         (a.window > 0 && k0 <= t_hi - a.window);
}

// Whether any key of k0 .. k1 - 1 is open to any of positions t_lo ..
// t_hi: a warpgroup whose part of a tile is closed skips its products
__device__ __forceinline__ bool any_open(const Args<bf16>& a, int k0, int k1, int t_lo, int t_hi) {
  return k0 < a.S && t_lo <= t_hi && (!a.causal || k0 <= t_hi) &&
         (a.window <= 0 || k1 - 1 > t_lo - a.window);
}

// Whether key kp is open to flattened row r (position r / G): kp < S,
// causal kp <= r / G as kp * G <= r, window kp > r / G - window as r < (kp
// + window) * G, so that the element masks need no division.
__device__ __forceinline__ bool visible_row(const Args<bf16>& a, int kp, int r) {
  bool ok = kp < a.S;
  if (a.causal) ok = ok && kp * a.G <= r;
  if (a.window > 0) ok = ok && r < (kp + a.window) * a.G;
  return ok;
}

// 2^x by the special-function unit alone (results below 2^-126 flush to 0,
// a P that rounds to 0 in bf16 all the same)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  using Tl = DqTiles<D>;
  return (size_t)(2 * Tl::kRows + 2 * 2 * Tl::kBK) * D * sizeof(bf16) +
         2 * Tl::kRows * sizeof(float) + 1024;
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  using Tl = KvTiles<D>;
  return (size_t)(2 * Tl::kBK + 2 * Tl::kStages * Tl::kBQ) * D * sizeof(bf16) +
         (2 * Tl::kStages * Tl::kBQ + (Tl::kShared ? kWg * Tl::kBQ : 0)) * sizeof(float) + 1024;
}

// Byte offset of 16-byte chunk c of row i of an R-row tile, kept as pieces
// of min(R, 64) rows in the swizzled layout (a warpgroup's 64 rows are one
// piece).
template <int D, int R>
__device__ __forceinline__ uint32_t tile_offset(int i, int c) {
  constexpr int P = R < kWg ? R : kWg;
  return (uint32_t)((i / P) * (P * D * (int)sizeof(bf16))) + swizzled<P>(i % P, c);
}

// rows r0 .. r0+R-1 of a (B, T, Hq, D) tensor into a tile, zeros past T*G
// (cp.async; the caller commits)
template <int D, int R>
__device__ __forceinline__ void load_rows(unsigned char* dst, const bf16* __restrict__ src,
                                          const Args<bf16>& a, int b, int h, int r0,
                                          uint64_t g_mul) {
  constexpr int CH = D / 8;
  const int TG = a.T * a.G;
#pragma unroll
  for (int c = threadIdx.x; c < R * CH; c += kThreads) {
    const int i = c / CH, cc = c % CH;
    const bool ok = r0 + i < TG;
    cp_async16(dst + tile_offset<D, R>(i, cc),
               ok ? src + row_offset_m(a, b, h, r0 + i, D, g_mul) + cc * 8 : src, ok);
  }
}

// keys k0 .. k0+R-1 of kv head h of a (B, S, Hkv, D) tensor, zeros past S
template <int D, int R>
__device__ __forceinline__ void load_keys(unsigned char* dst, const bf16* __restrict__ src,
                                          const Args<bf16>& a, int b, int h, int k0) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int c = threadIdx.x; c < R * CH; c += kThreads) {
    const int j = c / CH, cc = c % CH;
    const bool ok = k0 + j < a.S;
    cp_async16(dst + tile_offset<D, R>(j, cc),
               ok ? src + ((size_t)(b * a.S + k0 + j) * a.Hkv + h) * D + cc * 8 : src, ok);
  }
}

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 32) wgmma_m64n32k16_ss(d, da, db, scale_d);
  if constexpr (N == 64) wgmma_m64n64k16_ss(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_m64n64k16_rs(d, a, db);
  if constexpr (N == 128) wgmma_m64n128k16_rs(d, a, db);
  if constexpr (N == 256) wgmma_m64n256k16_rs(d, a, db);
}

// d (64 x N) = A B^T over D columns: A a 64-row piece at shared address
// a, B an N-row tile (one piece) at b, both read K-major.
template <int D, int N>
__device__ __forceinline__ void product_ss(float (&d)[N / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t ka = (kk >> 2) * (kWg * 128) + (kk & 3) * 32;
    const uint32_t kb = (kk >> 2) * (N * 128) + (kk & 3) * 32;
    mma_ss<N>(d, make_desc(a + ka, 16, 1024), make_desc(b + kb, 16, 1024), kk > 0);
  }
}

// d (64 x N) += A (64 x K in registers, K / 16 k-steps) B: B a K-row tile
// (one piece) at b, N = D columns, read MN-major.
template <int K, int N>
__device__ __forceinline__ void product_rs(float (&d)[N / 2], const uint32_t (&a)[K / 16][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) mma_rs<N>(d, a[kk], make_desc(b + kk * 16 * 128, K * 128, 1024));
}

// An m64nN accumulator as the register A operand of the next product,
// rounded to bf16: k-step kk is its columns 16kk .. 16kk + 15.
template <int N>
__device__ __forceinline__ void to_operand(uint32_t (&pa)[N / 16][4], const float (&s)[N / 2]) {
#pragma unroll
  for (int nb = 0; nb < N / 8; ++nb) {
    pa[nb / 2][(nb & 1) * 2] = pack_bf16(s[4 * nb], s[4 * nb + 1]);
    pa[nb / 2][(nb & 1) * 2 + 1] = pack_bf16(s[4 * nb + 2], s[4 * nb + 3]);
  }
}

// Keep a register A operand alive (and unmoved) until here: the product
// that reads it runs asynchronously, so its registers must not be reused
// before the wait that retires it.
template <int K>
__device__ __forceinline__ void keep_operand(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(kThreads) : "memory");
}
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(kThreads) : "memory");
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(Args<bf16> a, int n_qt, uint64_t g_mul) {
  using Tl = DqTiles<D>;
  constexpr int kRows = Tl::kRows, BK = Tl::kBK;
  constexpr int TPR = kThreads / kRows;  // threads a row in the delta pass
  constexpr uint32_t kQ = kRows * D * sizeof(bf16), kKV = BK * D * sizeof(bf16);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* Qs = smem_raw + ((1024 - (raw & 1023)) & 1023);
  unsigned char* dOs = Qs + kQ;
  unsigned char* Ks = dOs + kQ;     // [2] stages
  unsigned char* Vs = Ks + 2 * kKV;  // [2] stages
  float* lse_s = reinterpret_cast<float*>(Vs + 2 * kKV);  // lse * log2(e)
  float* delta_s = lse_s + kRows;
  const uint32_t q_addr = static_cast<uint32_t>(__cvta_generic_to_shared(Qs));
  const uint32_t do_addr = q_addr + kQ, k_addr = q_addr + 2 * kQ, v_addr = k_addr + 2 * kKV;

  const int hb = a.Hkv * a.B;
  const int rank = blockIdx.x / hb;
  // under a causal mask the last q tiles see the most keys: launch them first
  const int qt = a.causal ? n_qt - 1 - rank : rank;
  const int h = (blockIdx.x % hb) % a.Hkv, b = (blockIdx.x % hb) / a.Hkv;
  const int TG = a.T * a.G;
  const int rb = qt * kRows;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;

  const DqRange kr = dq_range(a, rb, kRows, BK);  // keys this tile's positions can see
  load_rows<D, kRows>(Qs, a.q, a, b, h, rb, g_mul);
  load_rows<D, kRows>(dOs, a.dout, a, b, h, rb, g_mul);
  auto load_kv = [&](int tile, int stage) {
    const int k0 = kr.k_begin + tile * BK;
    load_keys<D, BK>(Ks + stage * kKV, a.k, a, b, h, k0);
    load_keys<D, BK>(Vs + stage * kKV, a.v, a, b, h, k0);
  };
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    if (t < kr.n_tiles) load_kv(t, t);
    cp_async_commit();
  }

  {  // delta = rowsum(dO * O) and lse of this tile's rows, TPR threads a row
    const int i = tid / TPR, part = tid % TPR;
    const int r = rb + i;
    float sum = 0.f;
    if (r < TG) {
      const size_t off = row_offset_m(a, b, h, r, D, g_mul);
      for (int d = 8 * part; d < D; d += 8 * TPR) {
        float x[8], y[8];
        load_vec<float>(a.o32 + off + d, x);
        load_vec<float>(a.o32 + off + d + 4, x + 4);
        load_vec<bf16>(a.dout + off + d, y);
#pragma unroll
        for (int e = 0; e < 8; ++e) sum = fmaf(x[e], y[e], sum);
      }
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (part == 0) {
      float l = 0.f;
      if (r < TG) {
        const size_t si = stat_index_m(a, b, h, r, g_mul);
        l = a.lse[si] * kLog2e;
        a.delta[si] = sum;
      }
      lse_s[i] = l;
      delta_s[i] = sum;
    }
  }

  // this warpgroup's rows rw .. rw + 63 of the tile (positions tw_lo ..
  // tw_hi), this lane's rows r0 and r0 + 8
  const int rw = kWg * wg;
  const int r0 = rw + 16 * warp + (lane >> 2);
  const int tw_lo = div_g(rb + rw, g_mul), tw_hi = div_g(min(rb + rw + kWg, TG) - 1, g_mul);
  const int q2 = 2 * (lane & 3);
  const uint32_t qw = q_addr + wg * (kWg * D * sizeof(bf16));
  const uint32_t dow = do_addr + wg * (kWg * D * sizeof(bf16));
  const float scale_log2 = a.scale * kLog2e;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < kr.n_tiles; ++it) {
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();  // (the first also publishes lse_s and delta_s)
    const int stage = it & 1;
    const uint32_t ks = k_addr + stage * kKV, vs = v_addr + stage * kKV;
    const int k0 = kr.k_begin + it * BK;
    if (any_open(a, k0, k0 + BK, tw_lo, tw_hi)) {
      float s[BK / 2], dp[BK / 2];
      wgmma_fence();
      product_ss<D, BK>(s, qw, ks);
      wgmma_commit();
      product_ss<D, BK>(dp, dow, vs);
      wgmma_commit();
      wgmma_wait<1>();
      fence_operands(s);
      // P in place of S while dP = dO V^T runs: element e of column block
      // nb is (row r0 + 8 (e >> 1), key k0 + 8 nb + q2 + (e & 1))
      const float l2[2] = {lse_s[r0], lse_s[r0 + 8]};
      if (edge_tile(a, k0, BK, tw_lo, tw_hi)) {
#pragma unroll
        for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[4 * nb + e] = visible_row(a, k0 + 8 * nb + q2 + (e & 1), rb + r0 + 8 * (e >> 1))
                                ? exp2_ftz(fmaf(s[4 * nb + e], scale_log2, -l2[e >> 1]))
                                : 0.f;
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          s[i] = exp2_ftz(fmaf(s[i], scale_log2, -l2[(i >> 1) & 1]));
      }
      wgmma_wait<0>();
      fence_operands(dp);
      const float dl[2] = {delta_s[r0], delta_s[r0 + 8]};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) dp[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]);
      uint32_t da[BK / 16][4];
      to_operand<BK>(da, dp);
      // dQ += dS K, K read MN-major
      fence_operands(acc);
      wgmma_fence();
      product_rs<BK, D>(acc, da, ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
    }
    __syncthreads();  // every warp is done with this stage
    if (it + 2 < kr.n_tiles) load_kv(it + 2, stage);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rb + r0 + 8 * i;
    if (r >= TG) continue;
    bf16* dst = a.dq + row_offset_m(a, b, h, r, D, g_mul) + q2;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      store2(dst + 8 * nb, acc[4 * nb + 2 * i] * a.scale, acc[4 * nb + 2 * i + 1] * a.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) dkdv_kernel(Args<bf16> a, uint64_t g_mul) {
  using Tl = KvTiles<D>;
  constexpr bool kShared = Tl::kShared;
  constexpr int BK = Tl::kBK, BQ = Tl::kBQ, NS = Tl::kStages;
  constexpr int AHEAD = kShared ? 2 : NS - 2;  // tiles in flight ahead of the one in use
  constexpr int NA = kShared ? 1 : 2;  // gradients a warpgroup holds
  constexpr uint32_t kK = BK * D * sizeof(bf16), kQ = BQ * D * sizeof(bf16);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* Ks = smem_raw + ((1024 - (raw & 1023)) & 1023);
  unsigned char* Vs = Ks + kK;
  unsigned char* Qs = Vs + kK;        // [NS] stages
  unsigned char* dOs = Qs + NS * kQ;  // [NS] stages
  float* lse_s = reinterpret_cast<float*>(dOs + NS * kQ);  // [NS] stages
  float* delta_s = lse_s + NS * BQ;                        // [NS] stages
  float* xs = delta_s + NS * BQ;  // P^T passed between the warpgroups (kShared)
  const uint32_t k_addr = static_cast<uint32_t>(__cvta_generic_to_shared(Ks));
  const uint32_t v_addr = k_addr + kK, q_addr = k_addr + 2 * kK, do_addr = q_addr + NS * kQ;

  const int hb = a.Hkv * a.B;
  const int rank = blockIdx.x / hb;  // key tile, then range: key tile 0 first
  const int kt = rank / a.n_split, sp = rank % a.n_split;
  const int h = (blockIdx.x % hb) % a.Hkv, b = (blockIdx.x % hb) / a.Hkv;
  const int k0 = kt * BK;
  const int TG = a.T * a.G;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, warp = wt >> 5, lane = tid & 31;

  // q tiles (of BQ flattened rows) that can see this key tile, and this
  // block's contiguous range of them
  const KvRange qr = kv_range(a, k0, sp, BK, BQ);
  load_keys<D, BK>(Ks, a.k, a, b, h, k0);
  load_keys<D, BK>(Vs, a.v, a, b, h, k0);
  auto load_q = [&](int tile, int stage) {
    const int r0 = (qr.rt_lo + tile) * BQ;
    load_rows<D, BQ>(Qs + stage * kQ, a.q, a, b, h, r0, g_mul);
    load_rows<D, BQ>(dOs + stage * kQ, a.dout, a, b, h, r0, g_mul);
    if (tid < 2 * BQ) {  // the rows' lse and delta (zeros past T*G)
      const int i = tid % BQ, r = r0 + i;
      const bool ok = r < TG;
      const float* src = tid < BQ ? a.lse : a.delta;
      cp_async4((tid < BQ ? lse_s : delta_s) + stage * BQ + i,
                ok ? src + stat_index_m(a, b, h, r, g_mul) : src, ok);
    }
  };
#pragma unroll
  for (int t = 0; t < AHEAD; ++t) {
    if (t < qr.n_tiles) load_q(t, t);
    cp_async_commit();
  }

  // this warpgroup's keys kw .. kw + 63 (its piece of K and V), this
  // lane's keys kp[0], kp[1]
  const int kw = kShared ? k0 : k0 + kWg * wg;
  const uint32_t piece = kShared ? 0 : wg * (kWg * D * sizeof(bf16));
  const int kp[2] = {kw + 16 * warp + (lane >> 2), kw + 16 * warp + (lane >> 2) + 8};
  const int q2 = 2 * (lane & 3);
  const float scale_log2 = a.scale * kLog2e;
  // D <= 128: acc[0] dV, acc[1] dK; kShared: dV in warpgroup 0, dK in 1
  float acc[NA][D / 2];
#pragma unroll
  for (int j = 0; j < NA; ++j)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[j][i] = 0.f;
  uint32_t pa[BQ / 16][4], da[BQ / 16][4];  // P^T and dS^T as A operands

  for (int it = 0; it < qr.n_tiles; ++it) {
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();  // (and every warp is done with xs)
    const int stage = it % NS;
    const uint32_t qs = q_addr + stage * kQ, dos = do_addr + stage * kQ;
    const float* ls = lse_s + stage * BQ;
    const float* ds = delta_s + stage * BQ;
    const int r0 = (qr.rt_lo + it) * BQ;
    const int t_lo = div_g(r0, g_mul), t_hi = div_g(min(r0 + BQ, TG) - 1, g_mul);
    const bool edge = r0 + BQ > TG || edge_tile(a, kw, kWg, t_lo, t_hi);
    // element e of column block nb of an S^T-shaped accumulator is (key
    // kp[e >> 1], row r0 + 8 nb + q2 + (e & 1)); P^T in place of S^T
    auto p_t = [&](float (&s)[BQ / 2]) {
      if (edge) {
#pragma unroll
        for (int nb = 0; nb < BQ / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = r0 + 8 * nb + q2 + (e & 1);
            s[4 * nb + e] = row < TG && visible_row(a, kp[e >> 1], row)
                                ? exp2_ftz(fmaf(s[4 * nb + e], scale_log2,
                                                -ls[8 * nb + q2 + (e & 1)] * kLog2e))
                                : 0.f;
          }
      } else {
#pragma unroll
        for (int nb = 0; nb < BQ / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[4 * nb + e] = exp2_ftz(fmaf(s[4 * nb + e], scale_log2,
                                          -ls[8 * nb + q2 + (e & 1)] * kLog2e));
      }
    };
    if constexpr (!kShared) {
      // a step closed to this warpgroup's keys is all masked
      float s[BQ / 2], dp[BQ / 2];
      wgmma_fence();
      product_ss<D, BQ>(s, k_addr + piece, qs);  // S^T = K Q^T
      wgmma_commit();
      product_ss<D, BQ>(dp, v_addr + piece, dos);  // dP^T = V dO^T
      wgmma_commit();
      if (it + AHEAD < qr.n_tiles) load_q(it + AHEAD, (it + AHEAD) % NS);
      cp_async_commit();
      wgmma_wait<1>();  // the step before's dK product and S^T are in
      keep_operand(da);
      fence_operands(s);
      p_t(s);
      to_operand<BQ>(pa, s);
      fence_operands(acc[0]);
      wgmma_fence();
      product_rs<BQ, D>(acc[0], pa, dos);  // dV += P^T dO
      wgmma_commit();
      wgmma_wait<1>();  // dP^T is in; dV may still run
      fence_operands(dp);
#pragma unroll
      for (int nb = 0; nb < BQ / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * nb + e] = s[4 * nb + e] * (dp[4 * nb + e] - ds[8 * nb + q2 + (e & 1)]);
      to_operand<BQ>(da, dp);
      wgmma_wait<0>();  // dV is in
      keep_operand(pa);
      fence_operands(acc[0]);
      fence_operands(acc[1]);
      wgmma_fence();
      product_rs<BQ, D>(acc[1], da, qs);  // dK += dS^T Q, on into the next step
      wgmma_commit();
    } else if (any_open(a, k0, k0 + BK, t_lo, t_hi)) {
      // warpgroup 0: S^T = K Q^T, P^T, dV += P^T dO; warpgroup 1: dP^T = V
      // dO^T, dS^T from warpgroup 0's P^T, dK += dS^T Q
      float s[BQ / 2];
      wgmma_fence();
      product_ss<D, BQ>(s, wg == 0 ? k_addr : v_addr, wg == 0 ? qs : dos);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(s);
      if (wg == 0) {
        p_t(s);
#pragma unroll
        for (int j = 0; j < BQ / 2; ++j) xs[j * 128 + wt] = s[j];
        bar_arrive(1);
      } else {
        bar_sync(1);  // warpgroup 0's P^T is in xs
#pragma unroll
        for (int nb = 0; nb < BQ / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[4 * nb + e] = xs[(4 * nb + e) * 128 + wt] * (s[4 * nb + e] - ds[8 * nb + q2 + (e & 1)]);
      }
      to_operand<BQ>(pa, s);
      fence_operands(acc[0]);
      wgmma_fence();
      product_rs<BQ, D>(acc[0], pa, wg == 0 ? dos : qs);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc[0]);
    }
    if constexpr (kShared) {
      __syncthreads();  // every warp is done with this stage
      if (it + 2 < qr.n_tiles) load_q(it + 2, stage);
      cp_async_commit();
    }
  }
  wgmma_wait<0>();
  keep_operand(da);
  fence_operands(acc[NA - 1]);
  cp_async_wait<0>();

  const size_t N = (size_t)a.B * a.S * a.Hkv * D;
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    const bool is_dk = kShared ? wg == 1 : j == 1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (kp[i] >= a.S) continue;
      const size_t off = ((size_t)(b * a.S + kp[i]) * a.Hkv + h) * D + q2;
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb) {
        const float x = acc[j][4 * nb + 2 * i], y = acc[j][4 * nb + 2 * i + 1];
        if (a.n_split > 1)
          store2(a.part + ((is_dk ? 0 : a.n_split) + sp) * N + off + 8 * nb, x, y);
        else if (is_dk)
          store2(a.dk + off + 8 * nb, x * a.scale, y * a.scale);
        else
          store2(a.dv + off + 8 * nb, x, y);
      }
    }
  }
}

template <int D>
int launch(const Args<bf16>& a, cudaStream_t stream) {
  static bool dq_set[kMaxDevices] = {}, dkdv_set[kMaxDevices] = {};
  constexpr size_t dq_smem = dq_smem_bytes<D>(), dkdv_smem = dkdv_smem_bytes<D>();
  static_assert(dq_smem <= 232448 && dkdv_smem <= 232448, "flash_prefill_bwd bf16: shared memory");
  cudaError_t err = allow_dynamic_smem(dq_kernel<D>, dq_smem, dq_set);
  if (err != cudaSuccess) return (int)err;
  err = allow_dynamic_smem(dkdv_kernel<D>, dkdv_smem, dkdv_set);
  if (err != cudaSuccess) return (int)err;
  if ((long long)a.T * a.G >= (1LL << 26)) return (int)cudaErrorInvalidValue;  // div_g
  const uint64_t g_mul = 0xffffffffull / (uint32_t)a.G + 1;
  const long long hb = (long long)a.Hkv * a.B;
  const int n_qt = (a.T * a.G + DqTiles<D>::kRows - 1) / DqTiles<D>::kRows;
  const int n_kt = (a.S + KvTiles<D>::kBK - 1) / KvTiles<D>::kBK;
  const long long dq_blocks = n_qt * hb, kv_blocks = (long long)n_kt * a.n_split * hb;
  if (dq_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (dq_blocks > 0) {  // dQ, and delta for launch 2
    dq_kernel<D><<<(unsigned)dq_blocks, kThreads, dq_smem, stream>>>(a, n_qt, g_mul);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (kv_blocks == 0) return 0;
  dkdv_kernel<D><<<(unsigned)kv_blocks, kThreads, dkdv_smem, stream>>>(a, g_mul);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_parts(a, D, stream);
}

}  // namespace

int launch_bf16(const Args<bf16>& a, int D, cudaStream_t stream) {
  if (D == 64) return launch<64>(a, stream);
  if (D == 128) return launch<128>(a, stream);
  if (D == 256) return launch<256>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace bwd
}  // namespace repro_torch
