// rwkv6_scan: the WKV6 recurrence of RWKV-6 (Finch) over a whole prompt.
//
// Replaces the TPU kernel `rwkv6_scan` (src/repro/kernels/rwkv6_scan.py,
// `_rwkv6_kernel`) and `rwkv6_scan_with_state`.  Per (batch, head), with a
// (D x D) state S, data-dependent decay w_t in (0, 1] and bonus u:
//
//     o_t = r_t^T (diag(u) k_t v_t^T + S_{t-1})
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// Inputs r, k, v, w are read in the model's (B, T, H, D) f32 layout in
// place; the kernel forms log2(max(w, 1e-12)) itself and writes o
// (B, T, H, D) and the final state (B, H, D, D), starting from s0 or zero.
// Steps past T are identity steps (w = 1, r = k = v = 0): nothing is padded.
//
// What bounds it on the H100: bytes, narrowly.  At B=1, T=1024, H=40, D=64
// the function moves ~53 MB (r, k, v, w in, o and the state out: ~16 us at
// 3.35 TB/s) against ~1.0 GFLOP of products at c = 64 (~15 us at the f32
// CUDA-core peak of 67 TFLOP/s).  The TPU grid (B, H, t_blocks) carries the
// state across its sequential time axis; a block that walks every chunk in
// turn leaves the card with 160 blocks and 16 dependent chunk steps each.
// So the time axis is cut into chunks of c = 64 steps, and the form is the
// chunked one of FlashLinearAttention, in three launches on one stream:
//
//   (a) rwkv6_chunk_state, one block per (chunk, 64 state columns, head,
//       batch): the chunk's decay exp(C_end) (C: inclusive sums of log w
//       from the chunk start) and its state delta dS = k_end^T v, with
//       k_end = k exp(C_end - C), into scratch (B, H, n, D, D) + (B, H, n, D);
//   (b) rwkv6_state_scan, one thread per (4 state entries, head, batch):
//       walks the n chunks in order from s0 or zero, S_in[c] = S,
//       S = diag(dec_c) S + dS_c, storing S_in[c] over dS_c and the last S
//       as the state output.  The only sequential part: n elementwise steps;
//   (c) rwkv6_chunk_out, one block per (chunk, 64 output columns, head,
//       batch): o = (A o causal) v + r_dec S_in[c], r_dec = r exp(E) (E: the
//       exclusive sums), A the chunk's score tile with u on its diagonal.
//
// At rwkv6-3b's shape (a) and (c) are 640 blocks each, five (38 KB of
// shared memory) and three (73 KB) resident per SM; v, and S_in in (c),
// take the places of tiles that are read no more.  The three passes move
// ~127 MB (the inputs twice, the chunk states three times), much of it
// through the 50 MB L2.  On an H100 (700 W) they take ~25, ~7 and ~52 us;
// removing any one stage of (c) removes its time, so (c) is bound by its
// instruction issue (the per-entry exps of the sub-blocks, the 3xTF32
// operand splits) as much as by bytes, and more resident blocks gave
// nothing.  The products (k_end^T v, the cross-sub-block scores, A v and
// r_dec S_in) run on the tensor cores as mma.sync m16n8k8 TF32 in the
// 3xTF32 split: x = big + small with big = tf32(x), small = tf32(x - big),
// and small*big + big*small + big*big summed in f32, which keeps ~22 bits
// of each operand.  One TF32 pass keeps 11, about 1e-3 of each product:
// more than the port's 1e-4 of the output's rms.  Operands are read out of
// shared memory into fragments with pitches chosen so that the 32 lanes of
// a fragment load hit 32 banks.
//
// Offsets into the (B, T, H, D) inputs, the scratch and the states are
// 64-bit (rwkv6-3b's 524288-step prefill: 1.3e9 elements an input, 1.4e9
// floats of scratch); the grid is (chunks x column blocks, H, B), and the
// launch refuses H or B past 65535.
//
// The score tile, per chunk split into four sub-blocks of 16 steps:
//   inside a sub-block, s < t:  A[t,s] = sum_d r_t k_s exp(E_t - C_s), one
//                               exp per (t, s, d) on the CUDA cores, two
//                               of the 480 entries a thread;
//                        s = t: A[t,t] = sum_d r_t u k_t;
//   sub-block j before t's:     A[t,s] = sum_d (r_t exp(E_t - Y_j))
//                                            (k_s exp(Y_j - C_s)),
//                               Y_j = C at the end of sub-block j: a product
//                               on the tensor cores.
//
// Overflow.  The reference (rwkv6_chunked_jnp, layers.py, and the Pallas
// body) forms k exp(-cum) over a 128-step chunk, which overflows f32 once a
// channel's log-decay sum in a chunk falls below about -88 (trained RWKV
// weights reach that; `init_rwkv6` ones do not).  Every exponent here is a
// difference of cumulative sums over a later minus an earlier step, so it
// is <= 0 and each factor is <= 1: the kernel is finite wherever its inputs
// are, and equals the reference wherever the reference is finite.  The
// sums are taken in log2 and raised with ex2.approx (relative error ~2^-22,
// denormal results flushed to zero, which a factor below 2^-126 is).
//
// Deterministic: no atomics, every sum in a fixed order; two calls on the
// same inputs give the same bits.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;                  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;                     // time steps per chunk
constexpr int kSub = 16;                       // steps per sub-block
constexpr int kNSub = kChunk / kSub;           // 4
constexpr int kPairs = kNSub * (kNSub - 1) / 2;  // sub-block pairs j < i
constexpr int kDV = 64;                        // state columns per block
constexpr int kPB = kDV + 8;                   // pitch of v and S tiles
constexpr int kPS = kChunk + 4;                // pitch of the score tile
constexpr int kScanThreads = 256;              // pass (b)
constexpr int kScanAhead = 8;                  // pass (b): chunks loaded ahead
static_assert(kPairs <= kWarps, "cross scores: one warp per pair");
static_assert(kWarps == (kChunk / 16) * (kDV / 32), "(c): one tile a warp");

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Pair p of the score entries s < t inside the chunk's sub-blocks, row by
// row: sub-block p / 120, then (1,0), (2,0), (2,1), (3,0), ...
__device__ __forceinline__ void pair(int p, int& t, int& s) {
  constexpr int kTri = kSub * (kSub - 1) / 2;
  const int q = p / kTri, l = p % kTri;
  // tl (tl - 1) / 2 <= l < tl (tl + 1) / 2; sqrtf is exact on the squares
  const int tl = (int)((1.f + sqrtf(1.f + 8.f * l)) * 0.5f);
  t = q * kSub + tl;
  s = q * kSub + l - tl * (tl - 1) / 2;
}

// Rows t < tv of a (kChunk x cols) tile of a (B, T, H, cols-wide) tensor,
// 16 bytes a thread, into shared memory at `pitch`; rows past tv read
// nothing and are zero-filled.
__device__ __forceinline__ void load_rows(float* dst, int pitch,
                                          const float* src, size_t step,
                                          int cols, int tv, int tid) {
  const int c4 = cols / 4;
  for (int i = tid; i < kChunk * c4; i += kThreads) {
    const int t = i / c4, c = (i % c4) * 4;
    const bool ok = t < tv;
    cp_async16(dst + t * pitch + c, src + (ok ? (size_t)t * step + c : 0), ok);
  }
}

// -------------------------------------------------- (a) chunk state deltas --
// v takes the place of w once the sums are done: 38 KB at D 64, five
// blocks a SM.
template <int D>
struct StateSmem {
  static constexpr int PK = D + 8;             // k read as a transposed A
  static constexpr int K = 0;                  // k, then k_end
  static constexpr int W = K + kChunk * PK;    // w, partial sums, then v
  static constexpr int TOT = W + (D > kPB ? kChunk * D : kChunk * kPB);
  static constexpr int kFloats = TOT + kThreads;   // each part's total
};

template <int D>
__global__ void __launch_bounds__(kThreads, 5)
rwkv6_chunk_state(const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ w, float* __restrict__ dstate,
                  float* __restrict__ ddec, int T, int H, int n) {
  using L = StateSmem<D>;
  constexpr int PK = L::PK;
  constexpr int NE = D / kDV;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem + L::K;
  float* Ws = smem + L::W;
  float* Vs = smem + L::W;
  float* Tot = smem + L::TOT;

  const int chunk = blockIdx.x / NE, e0 = (blockIdx.x % NE) * kDV;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q4 = lane % 4;
  const int t0 = chunk * kChunk, tv = min(kChunk, T - t0);
  const size_t step = (size_t)H * D;
  const size_t base = (((size_t)b * T + t0) * H + h) * D;   // (b, t0, h, 0)

  load_rows(Ks, PK, k + base, step, D, tv, tid);
  load_rows(Ws, D, w + base, step, D, tv, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // G[s] = sum over t > s of log2 w_t, in Q parts of the chunk, then
  // k_end = k 2^G and the chunk's decay 2^(sum of all)
  {
    constexpr int Q = kThreads / D, LEN = kChunk / Q;
    const int d = tid % D, q = tid / D;
    float run = 0.f;
    for (int i = LEN - 1; i >= 0; --i) {
      const int t = q * LEN + i;
      const float lw = t < tv ? log2f(fmaxf(Ws[t * D + d], 1e-12f)) : 0.f;
      Ws[t * D + d] = run;
      run += lw;
    }
    Tot[q * D + d] = run;
    __syncthreads();
    float off = 0.f;
    for (int p = Q - 1; p > q; --p) off += Tot[p * D + d];
    for (int i = 0; i < LEN; ++i) {
      const int t = q * LEN + i;
      Ks[t * PK + d] *= exp2_ftz(Ws[t * D + d] + off);
    }
    if (q == 0 && e0 == 0)
      ddec[(((size_t)b * H + h) * n + chunk) * D + d] = exp2_ftz(off + run);
  }
  __syncthreads();                             // the sums are read no more
  load_rows(Vs, kPB, v + base + e0, step, kDV, tv, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // dS[d, e] = sum_s k_end[s, d] v[s, e]: 16-row x 32-column tiles of dS
  const int s_steps = (tv + 7) / 8;
  float* out = dstate + (((size_t)b * H + h) * n + chunk) * D * D + e0;
  for (int job = warp; job < (D / 16) * (kDV / 32); job += kWarps) {
    const int dr = (job / (kDV / 32)) * 16 + g, nc = (job % (kDV / 32)) * 32;
    float acc[4][4] = {};
    for (int ks = 0; ks < s_steps; ++ks) {
      const int sa = ks * 8 + q4, sb = sa + 4;
      const FragA a = frag_a(Ks[sa * PK + dr], Ks[sa * PK + dr + 8],
                             Ks[sb * PK + dr], Ks[sb * PK + dr + 8]);
      FragB bf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = nc + j * 8 + g;
        bf[j] = frag_b(Vs[sa * kPB + e], Vs[sb * kPB + e]);
      }
      mma3(acc, a, bf);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = nc + j * 8 + 2 * q4;
      *reinterpret_cast<float2*>(out + (size_t)dr * D + e) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(out + (size_t)(dr + 8) * D + e) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
}

// ------------------------------------------------- (b) the carried states --
__global__ void __launch_bounds__(kScanThreads)
rwkv6_state_scan(float* __restrict__ dstate, const float* __restrict__ ddec,
                 const float* __restrict__ s0, float* __restrict__ s_out,
                 int BH, int D, int n) {
  const int dd4 = D * D / 4;
  const size_t i = (size_t)blockIdx.x * kScanThreads + threadIdx.x;
  if (i >= (size_t)BH * dd4) return;
  const size_t bh = i / dd4;
  const int r = (int)(i % dd4), d = r / (D / 4);
  float4 S = s0 != nullptr ? reinterpret_cast<const float4*>(s0)[i]
                           : make_float4(0.f, 0.f, 0.f, 0.f);
  float4* st = reinterpret_cast<float4*>(dstate) + bh * n * dd4 + r;
  const float* dc = ddec + bh * n * D + d;
  for (int c0 = 0; c0 < n; c0 += kScanAhead) {
    float4 ds[kScanAhead];
    float de[kScanAhead];
#pragma unroll
    for (int j = 0; j < kScanAhead; ++j)
      if (c0 + j < n) {
        ds[j] = st[(size_t)(c0 + j) * dd4];
        de[j] = dc[(size_t)(c0 + j) * D];
      }
#pragma unroll
    for (int j = 0; j < kScanAhead; ++j)
      if (c0 + j < n) {
        st[(size_t)(c0 + j) * dd4] = S;          // S_in of chunk c0 + j
        S.x = fmaf(de[j], S.x, ds[j].x);
        S.y = fmaf(de[j], S.y, ds[j].y);
        S.z = fmaf(de[j], S.z, ds[j].z);
        S.w = fmaf(de[j], S.w, ds[j].w);
      }
  }
  reinterpret_cast<float4*>(s_out)[i] = S;
}

// --------------------------------------------------------- (c) the output --
// v and S_in take the places of k and the sums once the scores are done,
// which keeps a block at 73 KB at D 64: three blocks a SM.
template <int D>
struct OutSmem {
  static constexpr int PA = D + 4;             // rows read along d
  static constexpr int R = 0;                  // r, then r_dec
  static constexpr int K = R + kChunk * PA;    // k, then v (pitch kPB)
  static constexpr int CX =                    // row t: E_t; row t + 1: C_t;
      K + (PA > kPB ? kChunk * PA : kChunk * kPB);   // then S_in[:, e0:e0+64]
  static constexpr int A =                     // the score tile
      CX + ((kChunk + 1) * PA > D * kPB ? (kChunk + 1) * PA : D * kPB);
  static constexpr int U = A + kChunk * kPS;
  static constexpr int TOT = U + D;            // each scan part's total
  static constexpr int kFloats = TOT + kThreads;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 3)
rwkv6_chunk_out(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s_in,
                float* __restrict__ o, int T, int H, int n) {
  using L = OutSmem<D>;
  constexpr int PA = L::PA;
  constexpr int NE = D / kDV;
  extern __shared__ __align__(16) float smem[];
  float* Rs = smem + L::R;
  float* Ks = smem + L::K;
  float* Cx = smem + L::CX;
  float* Vs = smem + L::K;
  float* Ss = smem + L::CX;
  float* As = smem + L::A;
  float* Us = smem + L::U;
  float* Tot = smem + L::TOT;

  const int chunk = blockIdx.x / NE, e0 = (blockIdx.x % NE) * kDV;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q4 = lane % 4;
  const int t0 = chunk * kChunk, tv = min(kChunk, T - t0);
  const size_t step = (size_t)H * D;
  const size_t base = (((size_t)b * T + t0) * H + h) * D;   // (b, t0, h, 0)

  load_rows(Rs, PA, r + base, step, D, tv, tid);
  load_rows(Ks, PA, k + base, step, D, tv, tid);
  load_rows(Cx + PA, PA, w + base, step, D, tv, tid);
  for (int i = tid; i < D / 4; i += kThreads)
    cp_async16(Us + 4 * i, u + (size_t)h * D + 4 * i, true);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // inclusive sums of log2 w from the chunk start: Cx[t + 1] = C_t, and
  // Cx[t] = E_t (Cx[0] = 0), so E_t equals C_{t-1} bit for bit; the parts'
  // offsets are summed in order, so Cx falls monotonically and every
  // exponent formed below is <= 0
  {
    constexpr int Q = kThreads / D, LEN = kChunk / Q;
    const int d = tid % D, q = tid / D;
    float run = 0.f;
    for (int i = 0; i < LEN; ++i) {
      const int t = q * LEN + i;
      float* p = Cx + (t + 1) * PA + d;
      run += t < tv ? log2f(fmaxf(*p, 1e-12f)) : 0.f;
      *p = run;
    }
    Tot[q * D + d] = run;
    if (q == 0) Cx[d] = 0.f;
    __syncthreads();
    if (q > 0) {
      float off = 0.f;
      for (int p = 0; p < q; ++p) off += Tot[p * D + d];
      for (int i = 0; i < LEN; ++i) Cx[(q * LEN + i + 1) * PA + d] += off;
    }
  }
  __syncthreads();

  // scores inside each sub-block on the CUDA cores, two entries a thread:
  // warps 0-6 two of the 480 pairs s < t, warp 7 one pair and two entries
  // of the diagonal (r u k); entries above the diagonal are zero
  {
    constexpr int kTri = kSub * (kSub - 1) / 2;      // pairs a sub-block
    constexpr int kLower = kNSub * kTri;
    static_assert(kLower == 2 * kThreads - 32 && kChunk == 2 * 32,
                  "warps 0-6: two pairs; warp 7: a pair, two diagonal rows");
    int ta, sa, tb, sb;
    pair(tid, ta, sa);
    const bool diag = tid + kThreads >= kLower;      // warp 7
    if (diag) {
      tb = 2 * (tid + kThreads - kLower);
      sb = tb + 1;                                   // the next diagonal row
    } else {
      pair(tid + kThreads, tb, sb);
    }
    float acc_a = 0.f, acc_b = 0.f, acc_c = 0.f;
    for (int d = 0; d < D; d += 4) {
      const float4 ra = ld4(Rs + ta * PA + d), ea = ld4(Cx + ta * PA + d);
      const float4 ka = ld4(Ks + sa * PA + d);
      const float4 ca = ld4(Cx + (sa + 1) * PA + d);
      acc_a = fmaf(ra.x, ka.x * exp2_ftz(ea.x - ca.x), acc_a);
      acc_a = fmaf(ra.y, ka.y * exp2_ftz(ea.y - ca.y), acc_a);
      acc_a = fmaf(ra.z, ka.z * exp2_ftz(ea.z - ca.z), acc_a);
      acc_a = fmaf(ra.w, ka.w * exp2_ftz(ea.w - ca.w), acc_a);
      if (diag) {
        const float4 uv = ld4(Us + d);
        const float4 r0 = ld4(Rs + tb * PA + d), k0 = ld4(Ks + tb * PA + d);
        const float4 r1 = ld4(Rs + sb * PA + d), k1 = ld4(Ks + sb * PA + d);
        acc_b = fmaf(r0.x, uv.x * k0.x, acc_b);
        acc_b = fmaf(r0.y, uv.y * k0.y, acc_b);
        acc_b = fmaf(r0.z, uv.z * k0.z, acc_b);
        acc_b = fmaf(r0.w, uv.w * k0.w, acc_b);
        acc_c = fmaf(r1.x, uv.x * k1.x, acc_c);
        acc_c = fmaf(r1.y, uv.y * k1.y, acc_c);
        acc_c = fmaf(r1.z, uv.z * k1.z, acc_c);
        acc_c = fmaf(r1.w, uv.w * k1.w, acc_c);
      } else {
        const float4 rb = ld4(Rs + tb * PA + d), eb = ld4(Cx + tb * PA + d);
        const float4 kb = ld4(Ks + sb * PA + d);
        const float4 cb = ld4(Cx + (sb + 1) * PA + d);
        acc_b = fmaf(rb.x, kb.x * exp2_ftz(eb.x - cb.x), acc_b);
        acc_b = fmaf(rb.y, kb.y * exp2_ftz(eb.y - cb.y), acc_b);
        acc_b = fmaf(rb.z, kb.z * exp2_ftz(eb.z - cb.z), acc_b);
        acc_b = fmaf(rb.w, kb.w * exp2_ftz(eb.w - cb.w), acc_b);
      }
    }
    As[ta * kPS + sa] = acc_a;
    if (diag) {
      As[tb * kPS + tb] = acc_b;
      As[sb * kPS + sb] = acc_c;
    } else {
      As[tb * kPS + sb] = acc_b;
    }
    for (int i = tid; i < kNSub * kSub * kSub; i += kThreads) {
      const int q = i / (kSub * kSub), tl = i / kSub % kSub, sl = i % kSub;
      if (sl > tl) As[(q * kSub + tl) * kPS + q * kSub + sl] = 0.f;
    }
  }

  // scores across sub-blocks j < i on the tensor cores, one warp a pair:
  // (r 2^(E - Y_j)) (k 2^(Y_j - C))^T, Y_j = C at the end of sub-block j
  if (warp < kPairs) {
    int i = 1, j = warp;
    while (j >= i) j -= i++;                   // warp -> (i, j), j < i
    if (i * kSub < tv) {
      const float* Y = Cx + (j + 1) * kSub * PA;
      const int ta = i * kSub + g, tb = ta + 8;
      float acc[2][4] = {};
      for (int d0 = 0; d0 < D; d0 += 8) {
        const int da = d0 + q4, db = da + 4;
        const FragA a = frag_a(
            Rs[ta * PA + da] * exp2_ftz(Cx[ta * PA + da] - Y[da]),
            Rs[tb * PA + da] * exp2_ftz(Cx[tb * PA + da] - Y[da]),
            Rs[ta * PA + db] * exp2_ftz(Cx[ta * PA + db] - Y[db]),
            Rs[tb * PA + db] * exp2_ftz(Cx[tb * PA + db] - Y[db]));
        FragB bf[2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int s = j * kSub + nt * 8 + g;
          bf[nt] = frag_b(
              Ks[s * PA + da] * exp2_ftz(Y[da] - Cx[(s + 1) * PA + da]),
              Ks[s * PA + db] * exp2_ftz(Y[db] - Cx[(s + 1) * PA + db]));
        }
        mma3(acc, a, bf);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int s = j * kSub + nt * 8 + 2 * q4;
        As[ta * kPS + s] = acc[nt][0];
        As[ta * kPS + s + 1] = acc[nt][1];
        As[tb * kPS + s] = acc[nt][2];
        As[tb * kPS + s + 1] = acc[nt][3];
      }
    }
  }

  __syncthreads();             // the score tile is whole; k is read no more

  // v into k's place; r_dec = r 2^E into r's; then S_in into the sums'
  // place, landing under the A v product
  load_rows(Vs, kPB, v + base + e0, step, kDV, tv, tid);
  cp_async_commit();
  for (int i = tid; i < kChunk * D; i += kThreads) {
    const int t = i / D, d = i % D;
    Rs[t * PA + d] *= exp2_ftz(Cx[t * PA + d]);
  }
  __syncthreads();                             // the sums are read no more
  {
    const float* src = s_in + (((size_t)b * H + h) * n + chunk) * D * D + e0;
    for (int i = tid; i < D * (kDV / 4); i += kThreads) {
      const int d = i / (kDV / 4), c = (i % (kDV / 4)) * 4;
      cp_async16(Ss + d * kPB + c, src + (size_t)d * D + c, true);
    }
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();                             // v has landed

  // o = A v + r_dec S_in: warp (16 rows, 32 columns)
  const int mt = warp / 2, nc = (warp % 2) * 32;
  const int ta = mt * 16 + g, tb = ta + 8;
  const bool live = mt * 16 < tv;
  float acc[4][4] = {};
  if (live) {
    for (int s0 = 0; s0 < (mt + 1) * 16; s0 += 8) {
      const int sa = s0 + q4, sb = sa + 4;
      const FragA a = frag_a(As[ta * kPS + sa], As[tb * kPS + sa],
                             As[ta * kPS + sb], As[tb * kPS + sb]);
      FragB bf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = nc + j * 8 + g;
        bf[j] = frag_b(Vs[sa * kPB + e], Vs[sb * kPB + e]);
      }
      mma3(acc, a, bf);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                             // S_in has landed
  if (!live) return;
  for (int d0 = 0; d0 < D; d0 += 8) {
    const int da = d0 + q4, db = da + 4;
    const FragA a = frag_a(Rs[ta * PA + da], Rs[tb * PA + da],
                           Rs[ta * PA + db], Rs[tb * PA + db]);
    FragB bf[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = nc + j * 8 + g;
      bf[j] = frag_b(Ss[da * kPB + e], Ss[db * kPB + e]);
    }
    mma3(acc, a, bf);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = e0 + nc + j * 8 + 2 * q4;
    if (ta < tv)
      *reinterpret_cast<float2*>(o + base + (size_t)ta * step + e) =
          make_float2(acc[j][0], acc[j][1]);
    if (tb < tv)
      *reinterpret_cast<float2*>(o + base + (size_t)tb * step + e) =
          make_float2(acc[j][2], acc[j][3]);
  }
}

template <int D>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* o, float* s_out,
           float* scratch, int B, int T, int H, cudaStream_t stream) {
  static bool state_set[kMaxDevices] = {}, out_set[kMaxDevices] = {};
  const size_t state_smem = StateSmem<D>::kFloats * sizeof(float);
  const size_t out_smem = OutSmem<D>::kFloats * sizeof(float);
  cudaError_t err =
      allow_dynamic_smem(rwkv6_chunk_state<D>, state_smem, state_set);
  if (err == cudaSuccess)
    err = allow_dynamic_smem(rwkv6_chunk_out<D>, out_smem, out_set);
  if (err != cudaSuccess) return (int)err;
  const int n = (T + kChunk - 1) / kChunk;
  // the grid's y (heads) and z (batch) take at most 65535 each
  if (H > 65535 || B > 65535 || (long long)n * (D / kDV) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  float* dstate = scratch;                              // (B, H, n, D, D)
  float* ddec = scratch + (size_t)B * H * n * D * D;    // (B, H, n, D)
  const dim3 grid(n * (D / kDV), H, B);
  if (n > 0) {
    rwkv6_chunk_state<D><<<grid, kThreads, state_smem, stream>>>(
        k, v, w, dstate, ddec, T, H, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const size_t quads = (size_t)B * H * D * D / 4;
  rwkv6_state_scan<<<(unsigned)((quads + kScanThreads - 1) / kScanThreads),
                     kScanThreads, 0, stream>>>(dstate, ddec, s0, s_out, B * H,
                                                D, n);
  if ((err = cudaGetLastError()) != cudaSuccess || n == 0) return (int)err;
  rwkv6_chunk_out<D><<<grid, kThreads, out_smem, stream>>>(r, k, v, w, u,
                                                           dstate, o, T, H, n);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Plain C entry point, bound with ctypes.  r, k, v, w, o (B,T,H,D), u (H,D),
// s0 and s_out (B,H,D,D): contiguous float32 on the device, 16-byte
// aligned; s0 may be null (zero state); scratch holds B*H*n*(D*D + D)
// floats, n = ceil(T / 64), 16-byte aligned; D is 64 or 128.  Returns the
// first failing launch's cudaError_t (0 on success).
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, const void* s0,
                                 void* o, void* s_out, void* scratch, int B,
                                 int T, int H, int D, void* stream) {
  using namespace repro_torch;
  if (B == 0 || H == 0) return 0;
  decltype(&launch<64>) fn =
      D == 64 ? &launch<64> : D == 128 ? &launch<128> : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  return fn(f(r), f(k), f(v), f(w), f(u), f(s0), static_cast<float*>(o),
            static_cast<float*>(s_out), static_cast<float*>(scratch), B, T, H,
            static_cast<cudaStream_t>(stream));
}
