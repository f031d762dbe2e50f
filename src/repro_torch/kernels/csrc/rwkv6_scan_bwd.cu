// rwkv6_scan_bwd: the gradient of the WKV6 recurrence, for Hopper.
//
// No TPU kernel corresponds: the JAX package has no custom_vjp and trains by
// differentiating `rwkv6_chunked_jnp` (src/repro/models/layers.py), the jnp
// form its forward calls; in the port that call is the rwkv6_scan kernel
// (csrc/rwkv6_scan.cu), so its gradient is a kernel too.
//
// Function.  Per (batch, head), with S_t = diag(w_t) S_{t-1} + k_t v_t^T and
// o_t = r_t^T (diag(u) k_t v_t^T + S_{t-1}), given do (B,T,H,D) and the
// final state's cotangent dS_T (or zero), with dS_t the gradient of S_t:
//   dS_{t-1} = diag(w_t) dS_t + r_t do_t^T,          ds0 = dS_0,
//   dr_t = S_{t-1} do_t + u k_t (v_t . do_t),
//   dk_t = dS_t v_t + u r_t (v_t . do_t),
//   dv_t = dS_t^T k_t + (r_t . u k_t) do_t,
//   d log w_t = w_t diag(dS_t S_{t-1}^T),  du = sum_t r_t k_t (v_t . do_t),
// and dw = d log w / w where w >= 1e-12, 0 below: the forward forms
// log(max(w, 1e-12)), which passes no gradient under the clamp, as the
// reference's jnp.maximum does not.
//
// Chunked, on the forward's 64-step chunks.  In a chunk, with C_t the
// inclusive sums of log w from its start, E_t = C_{t-1} and Z = C at its end
// (steps past T are identity steps, as in the forward):
//   dS_in = diag(2^Z) dS_out + sum_t (r_t 2^E_t) do_t^T,
//   dr_t  = 2^E_t (S_in do_t) + sum_{s<t} dA[t,s] k_s 2^(E_t - C_s)
//           + u k_t dA[t,t],
//   dk_s  = 2^(Z - C_s) (dS_out v_s) + sum_{t>s} dA[t,s] r_t 2^(E_t - C_s)
//           + u r_s dA[s,s],
//   dv_s  = sum_{t>=s} A[t,s] do_t + dS_out^T (k_s 2^(Z - C_s)),
// with dA[t,s] = do_t . v_s and A the forward's score tile (u on its
// diagonal).  The decay's gradient, w_j diag(dS_j S_{j-1}^T) expanded:
//   d log w_j = 2^Z diag(S_in dS_out^T)                  (the whole decay)
//             + sum_{t>j} r_t 2^E_t (S_in do_t)         (reverse sum)
//             + sum_{s<j} k_s 2^(Z - C_s) (dS_out v_s)  (forward sum)
//             + sum_{s<j<t} dA[t,s] r_t k_s 2^(E_t - C_s).
// Every term carries w_j in its factor, so the sum has no cancellation:
// the shorter form sum_{t>j} r_t dr'_t - sum_{s>=j} k_s dk'_s + ... (dr',
// dk' without their u terms) cancels terms of order 1 to leave one of order
// w_j, and at strong decay misses the port's limit once divided by w_j.
// (Factors written 2^x are e^x of natural-log sums; the kernel sums in log2.)
//
// Sub-blocks.  Each chunk is cut into four sub-blocks of 16 steps, as the
// forward cuts it.  A pair s < t inside one sub-block is summed on the CUDA
// cores, 4 x 120 pairs a chunk where the whole chunk has 2016: the
// diagonal tiles of A with one exp per (t, s, d), as the forward forms
// them, and dr's, dk's and d log w's pair sums in one loop per (sub-block,
// channel) whose decay over s < m < t is a running product of
// max(w_m, 1e-12), each factor <= 1 (one multiply a pair where an exp took
// an add and an ex2, and exact to the f32 product's rounding, where the
// exponent of a long cumulative sum carries that sum's rounding).  A pair
// across sub-blocks
// factors through a cumulative sum Y between s and t, 2^(E_t - C_s) =
// 2^(E_t - Y) 2^(Y - C_s), both exponents <= 0, and runs as a product on
// the tensor cores:
//   A^T, s in sub-block j, t in i > j:  (k 2^(Y_j - C))_j (r 2^(E - Y_j))_i^T,
//       Y_j = C at the end of sub-block j (the forward's cross scores);
//   dr, t in sub-block i: 2^(E_t - Y') (dA[t, :16i] (k 2^(Y' - C))[:16i]),
//       Y' = C at the end of sub-block i - 1: one product for every s before;
//   dk, s in sub-block j: 2^(Y_j - C_s) (dA[16(j+1):, s]^T
//       (r 2^(E - Y_j))[16(j+1):]), walked last sub-block first.
// The pair sum of d log w_j, j in sub-block c, splits by where s and t lie:
// both inside c (the intra loop's prefix sums); s before c, t inside c after
// j (a suffix sum over t of r_t times dr's cross term); s inside c before j,
// t after c (a prefix sum over s of k_s times dk's cross term); s before c,
// t after c (the same for every j in c: k_s times dk's cross term summed
// over s, taken from the dk product part way along its t walk).  Each piece
// still spans j, so each still carries w_j.
//
// Four launches on one stream, no atomics (the same bits on every call):
//   (a) rwkv6_bwd_chunk_dstate, one block per (chunk, head, batch): each
//       chunk's local term sum_t (r_t 2^E_t) do_t^T (a product) and its
//       decay 2^Z, into scratch (B, H, n, D, D) + (B, H, n, D);
//   (b) rwkv6_bwd_state_scan, one thread per (4 state entries, head, batch):
//       the chunks last to first from dS_T (or 0), dS_out[c] = dS,
//       dS = diag(2^Z_c) dS + local_c, storing dS_out[c] over local_c, and
//       the last dS as ds0;
//   (c) rwkv6_bwd_chunk_grads, one block per (chunk, head, batch), in six
//       tiles of shared memory that later terms take over: A^T's diagonal
//       tiles, dv = A^T do + (k 2^(Z - C)) dS_out; dA = do v^T and the k
//       state terms 2^(Z - C) (v dS_out^T); the r state terms
//       2^E (do S_in^T) (S_in: the forward's pass (b) scratch, which the
//       autograd Function saves); the cross terms of dr and dk added to the
//       state terms; then per (sub-block, channel) one thread: the intra
//       pairs, dr, dk, d log w, dw and the chunk's share of du;
//   (d) rwkv6_bwd_du: du summed over batches and chunks in order.
// Every product (the local term, A^T's cross tiles, A^T do, (k 2^(Z-C))
// dS_out, dA, the two state terms, the two cross terms) runs on the tensor
// cores as mma.sync m16n8k8 TF32 in common.cuh's 3xTF32 split (its
// rounding done in integer operations, split_rna below), each in a fresh
// accumulator of at most 8 k-steps, added to the others in f32.
//
// Overflow.  Every exponent formed is a later cumulative sum minus an
// earlier one (E_t - C_s for s < t, Z - C_s, E_t, and the Y factorings
// above), so it is <= 0 and every factor <= 1, as in the forward kernel:
// the kernel is finite wherever its inputs are, where the reference's
// k exp(-cum) overflows under strong decay.
//
// What bounds it on the H100: bytes.  At rwkv6-3b's training shape (B 4,
// T 1024, H 40, D 64) it moves ~0.38 GB (r, k, v, w, do in; dr, dk, dv, dw
// out; ~0.11 ms at 3.35 TB/s) against ~8.8 GFLOP of products (~0.05 ms at
// 165 TFLOP/s, the 3xTF32 rate).  Launch (c) holds 113 KB of shared memory
// and 128 registers a thread (ptxas, no spills), so two blocks of 8 warps
// share an SM; (a) 56 KB and 52 registers.  D is 64 (rwkv6-3b's).  On an
// NVIDIA H100 80GB HBM3 at 700 W the four launches take 0.563 ms at that
// shape (20% of the bound): (a) 0.078, (b) 0.036, (c) 0.436, (d) 0.008.
// Variants with one stage of (c) cut out, timed side by side, put the most
// time in the intra loop and in dv, then in dA with the k state terms,
// A^T's diagonal tiles and the cross terms: (c) is bound by instruction
// issue and latency (fragment loads with their exps and TF32 splits, the
// intra loop), not by its bytes.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {
namespace wkv_bwd {

constexpr int kThreads = 256;                  // 8 warps
constexpr int kChunk = 64;                     // the forward's chunk
constexpr int kSub = 16;                       // steps per sub-block
constexpr int kNSub = kChunk / kSub;           // 4
constexpr int kD = 64;                         // head dim
constexpr int kP = kD + 4;                     // (c): pitch of every tile
constexpr int kTile = kChunk * kP;             // floats of a 64-row tile
constexpr int kPT = kD + 8;                    // (a): pitch, tiles read down
constexpr int kPD = 20;                        // (c): pitch of A^T's diagonal
constexpr int kScanThreads = 256;              // pass (b)
constexpr int kScanAhead = 8;                  // pass (b): chunks loaded ahead
static_assert(kChunk == kD && kThreads == kNSub * kD, "one thread a (sub, d)");
static_assert(kThreads / 32 == 2 * kNSub, "(c): a warp a (16 rows, 32 cols)");

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The 3xTF32 split of common.cuh's frag_a / frag_b, with cvt.rna's rounding
// (to nearest, ties away from zero) done in two integer operations on the
// bit pattern: the same bits for finite x, where cvt.rna.tf32.f32 compiles
// to a longer sequence that also handles NaN and infinity (launch (c) ran
// clearly slower with it, in variants timed side by side).
__device__ __forceinline__ void split_rna(float x, uint32_t& big,
                                          uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ FragA int_frag_a(float a0, float a1, float a2,
                                            float a3) {
  FragA f;
  split_rna(a0, f.big[0], f.small[0]);
  split_rna(a1, f.big[1], f.small[1]);
  split_rna(a2, f.big[2], f.small[2]);
  split_rna(a3, f.big[3], f.small[3]);
  return f;
}

__device__ __forceinline__ FragB int_frag_b(float b0, float b1) {
  FragB f;
  split_rna(b0, f.big[0], f.small[0]);
  split_rna(b1, f.big[1], f.small[1]);
  return f;
}

// Pair p of the entries s < t inside the chunk's sub-blocks, row by row:
// sub-block p / 120, then (1,0), (2,0), (2,1), (3,0), ... (the forward's)
__device__ __forceinline__ void pair(int p, int& t, int& s) {
  constexpr int kTri = kSub * (kSub - 1) / 2;
  const int q = p / kTri, l = p % kTri;
  // tl (tl - 1) / 2 <= l < tl (tl + 1) / 2; sqrtf is exact on the squares
  const int tl = (int)((1.f + sqrtf(1.f + 8.f * l)) * 0.5f);
  t = q * kSub + tl;
  s = q * kSub + l - tl * (tl - 1) / 2;
}

// Rows t < tv of a (kChunk x kD) tile of a (B, T, H, kD) tensor into shared
// memory at `pitch`, 16 bytes a thread; rows past tv are zero-filled.
__device__ __forceinline__ void load_rows(float* dst, int pitch,
                                          const float* src, size_t step,
                                          int tv, int tid) {
  constexpr int c4 = kD / 4;
  for (int i = tid; i < kChunk * c4; i += kThreads) {
    const int t = i / c4, c = (i % c4) * 4;
    const bool ok = t < tv;
    cp_async16(dst + t * pitch + c, src + (ok ? (size_t)t * step + c : 0), ok);
  }
}

// A (kD x kD) state at pitch kP.
__device__ __forceinline__ void load_state(float* dst, const float* src,
                                           int tid) {
  constexpr int c4 = kD / 4;
  for (int i = tid; i < kD * c4; i += kThreads) {
    const int d = i / c4, c = (i % c4) * 4;
    cp_async16(dst + d * kP + c, src + (size_t)d * kD + c, true);
  }
}

// Cx[t + 1] = C_t, the inclusive sums of log2 max(w, 1e-12) from the chunk
// start, in place over w loaded at rows 1..kChunk, and Cx[0] = 0 (so
// Cx[t] = E_t), in four parts of 16 steps whose offsets are summed in
// order: the forward's pass (c) sums, bit for bit.
__device__ __forceinline__ void cum_sums(float* Cx, int pitch, float* Tot,
                                         int tv, int tid) {
  constexpr int Q = kThreads / kD, LEN = kChunk / Q;
  const int d = tid % kD, q = tid / kD;
  float run = 0.f;
  for (int i = 0; i < LEN; ++i) {
    const int t = q * LEN + i;
    float* p = Cx + (t + 1) * pitch + d;
    run += t < tv ? log2f(fmaxf(*p, 1e-12f)) : 0.f;
    *p = run;
  }
  Tot[q * kD + d] = run;
  if (q == 0) Cx[d] = 0.f;
  __syncthreads();
  if (q > 0) {
    float off = 0.f;
    for (int p = 0; p < q; ++p) off += Tot[p * kD + d];
    for (int i = 0; i < LEN; ++i) Cx[(q * LEN + i + 1) * pitch + d] += off;
  }
}

// The sum over the 16 rows of a warp's accumulator tile (rows g, g + 8 of
// each lane, g = lane / 4) of x[n][i]: on return every lane with g = 0
// holds its columns' sums.
__device__ __forceinline__ void col_sums(float (&x)[4][2]) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      x[n][c] += __shfl_xor_sync(0xffffffffu, x[n][c], 4);
      x[n][c] += __shfl_xor_sync(0xffffffffu, x[n][c], 8);
      x[n][c] += __shfl_xor_sync(0xffffffffu, x[n][c], 16);
    }
}

// ------------------------------------- (a) each chunk's local state term --
// r (then r 2^E), do, and w (then the sums) at pitch kPT, read down their
// columns as the product's operands: 56 KB, four blocks a SM.
constexpr int kDstateFloats = 3 * kChunk * kPT + kPT + kThreads;

__global__ void __launch_bounds__(kThreads)
rwkv6_bwd_chunk_dstate(const float* __restrict__ r, const float* __restrict__ w,
                       const float* __restrict__ dout, float* __restrict__ local,
                       float* __restrict__ ddec, int T, int H, int n) {
  extern __shared__ __align__(16) float smem[];
  float* Rs = smem;                    // r, then r 2^E
  float* Os = Rs + kChunk * kPT;       // do
  float* Cx = Os + kChunk * kPT;       // (kChunk + 1) rows
  float* Tot = Cx + (kChunk + 1) * kPT;

  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q4 = lane % 4;
  const int t0 = chunk * kChunk, tv = min(kChunk, T - t0);
  const size_t step = (size_t)H * kD;
  const size_t base = (((size_t)b * T + t0) * H + h) * kD;

  load_rows(Rs, kPT, r + base, step, tv, tid);
  load_rows(Os, kPT, dout + base, step, tv, tid);
  load_rows(Cx + kPT, kPT, w + base, step, tv, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  cum_sums(Cx, kPT, Tot, tv, tid);
  __syncthreads();
  for (int i = tid; i < kChunk * kD; i += kThreads) {
    const int t = i / kD, d = i % kD;
    Rs[t * kPT + d] *= exp2_ftz(Cx[t * kPT + d]);
  }
  const size_t bhc = ((size_t)b * H + h) * n + chunk;
  if (tid < kD) ddec[bhc * kD + tid] = exp2_ftz(Cx[kChunk * kPT + tid]);
  __syncthreads();

  // local[d, e] = sum_t r_dec[t, d] do[t, e]: warp (16 rows d, 32 columns)
  const int d0 = (warp / 2) * 16, nc = (warp % 2) * 32;
  float acc[4][4] = {};
  for (int ts = 0; ts < tv; ts += 8) {
    const int ta = ts + q4, tb = ta + 4;
    const FragA a = int_frag_a(Rs[ta * kPT + d0 + g], Rs[ta * kPT + d0 + g + 8],
                           Rs[tb * kPT + d0 + g], Rs[tb * kPT + d0 + g + 8]);
    FragB bf[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = nc + j * 8 + g;
      bf[j] = int_frag_b(Os[ta * kPT + e], Os[tb * kPT + e]);
    }
    mma3(acc, a, bf);
  }
  float* out = local + bhc * kD * kD;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = nc + j * 8 + 2 * q4;
    *reinterpret_cast<float2*>(out + (size_t)(d0 + g) * kD + e) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(out + (size_t)(d0 + g + 8) * kD + e) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// ------------------------- (b) the state gradients, last chunk to first --
__global__ void __launch_bounds__(kScanThreads)
rwkv6_bwd_state_scan(float* __restrict__ local, const float* __restrict__ ddec,
                     const float* __restrict__ ds_final,
                     float* __restrict__ ds0, int BH, int n) {
  constexpr int dd4 = kD * kD / 4;
  const size_t i = (size_t)blockIdx.x * kScanThreads + threadIdx.x;
  if (i >= (size_t)BH * dd4) return;
  const size_t bh = i / dd4;
  const int rr = (int)(i % dd4), d = rr / (kD / 4);
  float4 S = ds_final != nullptr ? reinterpret_cast<const float4*>(ds_final)[i]
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
  float4* st = reinterpret_cast<float4*>(local) + bh * n * dd4 + rr;
  const float* dc = ddec + bh * n * kD + d;
  for (int c0 = n - 1; c0 >= 0; c0 -= kScanAhead) {
    float4 ls[kScanAhead];
    float de[kScanAhead];
#pragma unroll
    for (int j = 0; j < kScanAhead; ++j)
      if (c0 - j >= 0) {
        ls[j] = st[(size_t)(c0 - j) * dd4];
        de[j] = dc[(size_t)(c0 - j) * kD];
      }
#pragma unroll
    for (int j = 0; j < kScanAhead; ++j)
      if (c0 - j >= 0) {
        st[(size_t)(c0 - j) * dd4] = S;          // dS_out of chunk c0 - j
        S.x = fmaf(de[j], S.x, ls[j].x);
        S.y = fmaf(de[j], S.y, ls[j].y);
        S.z = fmaf(de[j], S.z, ls[j].z);
        S.w = fmaf(de[j], S.w, ls[j].w);
      }
  }
  if (ds0 != nullptr) reinterpret_cast<float4*>(ds0)[i] = S;
}

// ------------------------------------------- (c) each chunk's gradients --
// Six tiles at pitch kP: r, k, the sums Cx (kChunk + 1 rows), and three
// that later terms take over: do then RX (dr's state and cross terms), v
// then dA, dS_out then S_in then KX (dk's state and cross terms, then d log
// w's sums over s inside each sub-block); then A^T's diagonal tiles (first
// the sums' part totals, last du's parts), u, diag(S_in dS_out^T), the
// sub-blocks' sums of r RX's state part and of k KX's, and the three pair
// sums that span a whole sub-block.  113 KB: two blocks a SM.
struct GradSmem {
  static constexpr int R = 0, K = R + kTile, CX = K + kTile;
  static constexpr int S4 = CX + kTile + kP, S5 = S4 + kTile, S6 = S5 + kTile;
  static constexpr int ATD = S6 + kTile;
  static constexpr int U = ATD + kNSub * kSub * kPD;
  static constexpr int GZ = U + kD, RSUM = GZ + kD, KSUM = RSUM + kNSub * kD;
  static constexpr int SPAN = KSUM + kNSub * kD;
  static constexpr int kFloats = SPAN + 3 * kD;
};
static_assert(kNSub * kSub * kPD >= kThreads, "ATD holds the part totals");

__global__ void __launch_bounds__(kThreads, 2)
rwkv6_bwd_chunk_grads(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, const float* __restrict__ dout,
                      const float* __restrict__ s_in,
                      const float* __restrict__ ds_out, float* __restrict__ dr,
                      float* __restrict__ dk, float* __restrict__ dv,
                      float* __restrict__ dw, float* __restrict__ du_part,
                      int T, int H, int n) {
  using L = GradSmem;
  extern __shared__ __align__(16) float smem[];
  float* Rs = smem + L::R;
  float* Ks = smem + L::K;
  float* Cx = smem + L::CX;    // Cx[t] = E_t, Cx[t + 1] = C_t, Cx[kChunk] = Z
  float* Os = smem + L::S4;    // do, then RX
  float* RX = smem + L::S4;
  float* Vs = smem + L::S5;    // v, then dA (rows t, columns s)
  float* dAs = smem + L::S5;
  float* So = smem + L::S6;    // dS_out, then S_in, then KX
  float* Si = smem + L::S6;
  float* KX = smem + L::S6;
  float* ATd = smem + L::ATD;  // ATd[(16 j + s) kPD + t] = A[16j + t, 16j + s]
  float* Us = smem + L::U;
  float* Gz = smem + L::GZ;    // diag(S_in dS_out^T)
  float* Rsum = smem + L::RSUM;
  float* Ksum = smem + L::KSUM;
  float* Span = smem + L::SPAN;

  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q4 = lane % 4;
  const int t0 = chunk * kChunk, tv = min(kChunk, T - t0);
  const size_t step = (size_t)H * kD;
  const size_t base = (((size_t)b * T + t0) * H + h) * kD;
  const size_t bhc = ((size_t)b * H + h) * n + chunk;
  const float* sin_c = s_in + bhc * kD * kD;
  // the products' warp tile: 16 rows (sub-block mt), columns nc..nc + 31
  const int mt = warp / 2, nc = (warp % 2) * 32;
  const float* Z = Cx + kChunk * kP;

  // r, k, w and u first; do, v and dS_out land under the sums and A^T's
  // diagonal tiles
  load_rows(Rs, kP, r + base, step, tv, tid);
  load_rows(Ks, kP, k + base, step, tv, tid);
  load_rows(Cx + kP, kP, w + base, step, tv, tid);
  for (int i = tid; i < kD / 4; i += kThreads)
    cp_async16(Us + 4 * i, u + (size_t)h * kD + 4 * i, true);
  cp_async_commit();
  load_rows(Os, kP, dout + base, step, tv, tid);
  load_rows(Vs, kP, v + base, step, tv, tid);
  load_state(So, ds_out + bhc * kD * kD, tid);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  cum_sums(Cx, kP, ATd, tv, tid);
  __syncthreads();

  // A^T's diagonal tiles on the CUDA cores, two entries a thread: warps 0-6
  // two of the 480 pairs s < t, warp 7 one pair and two entries of the
  // diagonal (r u k); zero where s > t
  {
    constexpr int kLower = kNSub * kSub * (kSub - 1) / 2;
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
    for (int d = 0; d < kD; d += 4) {
      const float4 ra = ld4(Rs + ta * kP + d), ea = ld4(Cx + ta * kP + d);
      const float4 ka = ld4(Ks + sa * kP + d);
      const float4 ca = ld4(Cx + (sa + 1) * kP + d);
      acc_a = fmaf(ra.x, ka.x * exp2_ftz(ea.x - ca.x), acc_a);
      acc_a = fmaf(ra.y, ka.y * exp2_ftz(ea.y - ca.y), acc_a);
      acc_a = fmaf(ra.z, ka.z * exp2_ftz(ea.z - ca.z), acc_a);
      acc_a = fmaf(ra.w, ka.w * exp2_ftz(ea.w - ca.w), acc_a);
      if (diag) {
        const float4 uv = ld4(Us + d);
        const float4 r0 = ld4(Rs + tb * kP + d), k0 = ld4(Ks + tb * kP + d);
        const float4 r1 = ld4(Rs + sb * kP + d), k1 = ld4(Ks + sb * kP + d);
        acc_b = fmaf(r0.x, uv.x * k0.x, acc_b);
        acc_b = fmaf(r0.y, uv.y * k0.y, acc_b);
        acc_b = fmaf(r0.z, uv.z * k0.z, acc_b);
        acc_b = fmaf(r0.w, uv.w * k0.w, acc_b);
        acc_c = fmaf(r1.x, uv.x * k1.x, acc_c);
        acc_c = fmaf(r1.y, uv.y * k1.y, acc_c);
        acc_c = fmaf(r1.z, uv.z * k1.z, acc_c);
        acc_c = fmaf(r1.w, uv.w * k1.w, acc_c);
      } else {
        const float4 rb = ld4(Rs + tb * kP + d), eb = ld4(Cx + tb * kP + d);
        const float4 kb = ld4(Ks + sb * kP + d);
        const float4 cb = ld4(Cx + (sb + 1) * kP + d);
        acc_b = fmaf(rb.x, kb.x * exp2_ftz(eb.x - cb.x), acc_b);
        acc_b = fmaf(rb.y, kb.y * exp2_ftz(eb.y - cb.y), acc_b);
        acc_b = fmaf(rb.z, kb.z * exp2_ftz(eb.z - cb.z), acc_b);
        acc_b = fmaf(rb.w, kb.w * exp2_ftz(eb.w - cb.w), acc_b);
      }
    }
    // (t, s) of one chunk -> ATd row 16 q + s_local, column t_local
    auto at = [&](int t, int s) {
      return ATd + ((t / kSub) * kSub + s % kSub) * kPD + t % kSub;
    };
    *at(ta, sa) = acc_a;
    if (diag) {
      *at(tb, tb) = acc_b;
      *at(sb, sb) = acc_c;
    } else {
      *at(tb, sb) = acc_b;
    }
    for (int i = tid; i < kNSub * kSub * kSub; i += kThreads) {
      const int q = i / (kSub * kSub), tl = i / kSub % kSub, sl = i % kSub;
      if (sl > tl) ATd[(q * kSub + sl) * kPD + tl] = 0.f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // dv_s = sum_{t>=s} A[t,s] do_t + dS_out^T (k_s 2^(Z - C_s)): warp (16
  // rows s of sub-block j, 32 columns e), with j = 0, 1, 3, 2 for warps
  // 0-1, 2-3, 4-5, 6-7, so that warps w and w + 4 (one scheduler's) have
  // 3 cross tiles between them.  A^T's cross tiles (j, i),
  // i > j, are products through Y_j that share their k operand, formed once
  // a k-step; each passes on in registers as the A operand of its product
  // with do, whose rows are taken in the accumulator's column order
  {
    const int j = warp < 4 ? mt : 5 - mt, sa = j * kSub + g, sb = sa + 8;
    const float* Y = Cx + (j + 1) * kSub * kP;
    float at[kNSub - 1][2][4] = {};      // A^T[s, 16i + 8m + 2q], i = j + 1 + x
    for (int d0 = 0; d0 < kD; d0 += 8) {
      const int da = d0 + q4, db = da + 4;
      const FragA fa = int_frag_a(
          Ks[sa * kP + da] * exp2_ftz(Y[da] - Cx[(sa + 1) * kP + da]),
          Ks[sb * kP + da] * exp2_ftz(Y[da] - Cx[(sb + 1) * kP + da]),
          Ks[sa * kP + db] * exp2_ftz(Y[db] - Cx[(sa + 1) * kP + db]),
          Ks[sb * kP + db] * exp2_ftz(Y[db] - Cx[(sb + 1) * kP + db]));
#pragma unroll
      for (int x = 0; x < kNSub - 1; ++x) {
        if (j + 1 + x >= kNSub) break;
        FragB bf[2];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int t = (j + 1 + x) * kSub + m * 8 + g;
          bf[m] = int_frag_b(
              Rs[t * kP + da] * exp2_ftz(Cx[t * kP + da] - Y[da]),
              Rs[t * kP + db] * exp2_ftz(Cx[t * kP + db] - Y[db]));
        }
        mma3(at[x], fa, bf);
      }
    }
    float acc[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < kSub; kk += 8) {           // the diagonal tile
      const float* a = ATd + (j * kSub + g) * kPD + kk + q4;
      const FragA fa = int_frag_a(a[0], a[8 * kPD], a[4], a[8 * kPD + 4]);
      const int ta = j * kSub + kk + q4, tb = ta + 4;
      FragB bf[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int e = nc + nt * 8 + g;
        bf[nt] = int_frag_b(Os[ta * kP + e], Os[tb * kP + e]);
      }
      mma3(acc, fa, bf);
    }
#pragma unroll
    for (int x = 0; x < kNSub - 1; ++x) {
      if (j + 1 + x >= kNSub) break;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        // k = q4 -> t = 16i + 8m + 2 q4, k = q4 + 4 -> the next t
        const FragA fa =
            int_frag_a(at[x][m][0], at[x][m][2], at[x][m][1], at[x][m][3]);
        const int ta = (j + 1 + x) * kSub + m * 8 + 2 * q4, tb = ta + 1;
        FragB bf[4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int e = nc + nt * 8 + g;
          bf[nt] = int_frag_b(Os[ta * kP + e], Os[tb * kP + e]);
        }
        mma3(acc, fa, bf);
      }
    }
    float acc_k[4][4] = {};
    for (int d0 = 0; d0 < kD; d0 += 8) {
      const int da = d0 + q4, db = da + 4;
      const FragA fa = int_frag_a(
          Ks[sa * kP + da] * exp2_ftz(Z[da] - Cx[(sa + 1) * kP + da]),
          Ks[sb * kP + da] * exp2_ftz(Z[da] - Cx[(sb + 1) * kP + da]),
          Ks[sa * kP + db] * exp2_ftz(Z[db] - Cx[(sa + 1) * kP + db]),
          Ks[sb * kP + db] * exp2_ftz(Z[db] - Cx[(sb + 1) * kP + db]));
      FragB bf[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int e = nc + nt * 8 + g;
        bf[nt] = int_frag_b(So[da * kP + e], So[db * kP + e]);
      }
      mma3(acc_k, fa, bf);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int e = nc + nt * 8 + 2 * q4;
      if (sa < tv)
        *reinterpret_cast<float2*>(dv + base + (size_t)sa * step + e) =
            make_float2(acc[nt][0] + acc_k[nt][0], acc[nt][1] + acc_k[nt][1]);
      if (sb < tv)
        *reinterpret_cast<float2*>(dv + base + (size_t)sb * step + e) =
            make_float2(acc[nt][2] + acc_k[nt][2], acc[nt][3] + acc_k[nt][3]);
    }
  }

  // dA = do v^T (rows t of sub-block mt, columns s) and the k state terms
  // v dS_out^T (rows s, columns d), both held in registers; diag(S_in
  // dS_out^T), four threads a row, S_in read from device memory
  float da_acc[4][4] = {}, ks_acc[4][4] = {};
  {
    const int ra = mt * kSub + g, rb = ra + 8;
    // dA's n-tiles nt hold columns s of sub-block 2 (warp % 2) + nt / 2;
    // those right of the diagonal sub-block are never read
    const int n_da = nc / 16 > mt ? 0 : nc / 16 + 1 > mt ? 2 : 4;
    for (int e0 = 0; e0 < kD; e0 += 8) {
      const int ea = e0 + q4, eb = ea + 4;
      const FragA fo = int_frag_a(Os[ra * kP + ea], Os[rb * kP + ea],
                                  Os[ra * kP + eb], Os[rb * kP + eb]);
      const FragA fv = int_frag_a(Vs[ra * kP + ea], Vs[rb * kP + ea],
                                  Vs[ra * kP + eb], Vs[rb * kP + eb]);
      FragB bv[4], bs[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = nc + nt * 8 + g;
        if (nt < n_da) bv[nt] = int_frag_b(Vs[c * kP + ea], Vs[c * kP + eb]);
        bs[nt] = int_frag_b(So[c * kP + ea], So[c * kP + eb]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        if (nt < n_da) {               // mma3's three passes, one n-tile
          mma_tf32(da_acc[nt], fo.small, bv[nt].big);
          mma_tf32(da_acc[nt], fo.big, bv[nt].small);
          mma_tf32(da_acc[nt], fo.big, bv[nt].big);
        }
      mma3(ks_acc, fv, bs);
    }
    const int d = tid / 4, part = tid % 4;
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int e = part * 16 + 4 * m;
      acc = dot4(__ldg(reinterpret_cast<const float4*>(sin_c + d * kD + e)),
                 ld4(So + d * kP + e), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) Gz[d] = acc;
  }
  __syncthreads();                     // v and dS_out are read no more

  // S_in over dS_out; dA over v
  load_state(Si, sin_c, tid);
  cp_async_commit();
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int s = nc + nt * 8 + 2 * q4, t = mt * kSub + g;
    *reinterpret_cast<float2*>(dAs + t * kP + s) =
        make_float2(da_acc[nt][0], da_acc[nt][1]);
    *reinterpret_cast<float2*>(dAs + (t + 8) * kP + s) =
        make_float2(da_acc[nt][2], da_acc[nt][3]);
  }
  cp_async_wait<0>();
  __syncthreads();

  // The r state terms 2^E_t (S_in do_t): rows t of sub-block mt, columns d
  float rs_acc[4][4] = {};
  {
    const int ra = mt * kSub + g, rb = ra + 8;
    for (int e0 = 0; e0 < kD; e0 += 8) {
      const int ea = e0 + q4, eb = ea + 4;
      const FragA fo = int_frag_a(Os[ra * kP + ea], Os[rb * kP + ea],
                              Os[ra * kP + eb], Os[rb * kP + eb]);
      FragB bf[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int d = nc + nt * 8 + g;
        bf[nt] = int_frag_b(Si[d * kP + ea], Si[d * kP + eb]);
      }
      mma3(rs_acc, fo, bf);
    }
  }
  __syncthreads();                     // do and S_in are read no more

  // RX = 2^E (S_in do) over do and KX = 2^(Z - C) (dS_out v) over S_in,
  // and the sums over each sub-block of r RX and k KX
  {
    const int ra = mt * kSub + g, rb = ra + 8;
    float rsum[4][2], ksum[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int d = nc + nt * 8 + 2 * q4;
      float x[4], y[4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        x[c] = exp2_ftz(Cx[ra * kP + d + c]) * rs_acc[nt][c];
        x[c + 2] = exp2_ftz(Cx[rb * kP + d + c]) * rs_acc[nt][c + 2];
        y[c] = exp2_ftz(Z[d + c] - Cx[(ra + 1) * kP + d + c]) * ks_acc[nt][c];
        y[c + 2] =
            exp2_ftz(Z[d + c] - Cx[(rb + 1) * kP + d + c]) * ks_acc[nt][c + 2];
        rsum[nt][c] = fmaf(Rs[ra * kP + d + c], x[c],
                           Rs[rb * kP + d + c] * x[c + 2]);
        ksum[nt][c] = fmaf(Ks[ra * kP + d + c], y[c],
                           Ks[rb * kP + d + c] * y[c + 2]);
      }
      *reinterpret_cast<float2*>(RX + ra * kP + d) = make_float2(x[0], x[1]);
      *reinterpret_cast<float2*>(RX + rb * kP + d) = make_float2(x[2], x[3]);
      *reinterpret_cast<float2*>(KX + ra * kP + d) = make_float2(y[0], y[1]);
      *reinterpret_cast<float2*>(KX + rb * kP + d) = make_float2(y[2], y[3]);
    }
    col_sums(rsum);
    col_sums(ksum);
    if (g == 0) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int d = nc + nt * 8 + 2 * q4 + c;
          Rsum[mt * kD + d] = rsum[nt][c];
          Ksum[mt * kD + d] = ksum[nt][c];
        }
    }
  }
  __syncthreads();

  // The cross terms, warp (sub-block mt, 32 columns d): dr's for t in
  // sub-block i = mt through Y' = C at the end of sub-block i - 1, and dk's
  // for s in sub-block j = mt through Y_j = C at its end, its t walked from
  // the last sub-block back, with the sums over s of k_s 2^(Y_j - C_s) times
  // the part walked so far kept where they span a whole sub-block
  if (mt > 0) {
    const int i = mt, ta = i * kSub + g, tb = ta + 8;
    const float* Yp = Cx + i * kSub * kP;
    float acc[4][4] = {};
    for (int s0 = 0; s0 < i * kSub; s0 += 8) {
      const int sa = s0 + q4, sb = sa + 4;
      const FragA fa = int_frag_a(dAs[ta * kP + sa], dAs[tb * kP + sa],
                              dAs[ta * kP + sb], dAs[tb * kP + sb]);
      FragB bf[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int d = nc + nt * 8 + g;
        bf[nt] = int_frag_b(Ks[sa * kP + d] * exp2_ftz(Yp[d] - Cx[(sa + 1) * kP + d]),
                        Ks[sb * kP + d] * exp2_ftz(Yp[d] - Cx[(sb + 1) * kP + d]));
      }
      mma3(acc, fa, bf);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int d = nc + nt * 8 + 2 * q4;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        RX[ta * kP + d + c] +=
            exp2_ftz(Cx[ta * kP + d + c] - Yp[d + c]) * acc[nt][c];
        RX[tb * kP + d + c] +=
            exp2_ftz(Cx[tb * kP + d + c] - Yp[d + c]) * acc[nt][c + 2];
      }
    }
  }
  if (mt < kNSub - 1) {
    const int j = mt, sa = j * kSub + g, sb = sa + 8;
    const float* Y = Cx + (j + 1) * kSub * kP;
    float f[4][4];                     // 2^(Y_j - C_s) at the lane's entries
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int d = nc + nt * 8 + 2 * q4;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        f[nt][c] = exp2_ftz(Y[d + c] - Cx[(sa + 1) * kP + d + c]);
        f[nt][c + 2] = exp2_ftz(Y[d + c] - Cx[(sb + 1) * kP + d + c]);
      }
    }
    float acc[4][4] = {};
    for (int lo = kNSub - 1; lo > j; --lo) {
#pragma unroll
      for (int kk = 0; kk < kSub; kk += 8) {
        const int ta = lo * kSub + kk + q4, tb = ta + 4;
        const FragA fa = int_frag_a(dAs[ta * kP + sa], dAs[ta * kP + sb],
                                dAs[tb * kP + sa], dAs[tb * kP + sb]);
        FragB bf[4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int d = nc + nt * 8 + g;
          bf[nt] = int_frag_b(Rs[ta * kP + d] * exp2_ftz(Cx[ta * kP + d] - Y[d]),
                          Rs[tb * kP + d] * exp2_ftz(Cx[tb * kP + d] - Y[d]));
        }
        mma3(acc, fa, bf);
      }
      if (lo > j + 1) {                // pairs that span sub-block lo - 1
        float x[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int d = nc + nt * 8 + 2 * q4;
#pragma unroll
          for (int c = 0; c < 2; ++c)
            x[nt][c] = fmaf(Ks[sa * kP + d + c] * f[nt][c], acc[nt][c],
                            Ks[sb * kP + d + c] * f[nt][c + 2] * acc[nt][c + 2]);
        }
        col_sums(x);
        // (j, lo): (0, 2) spans sub-block 1; (0, 3) and (1, 3) sub-block 2
        const int slot = lo == 2 ? 0 : 1 + j;
        if (g == 0) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              Span[slot * kD + nc + nt * 8 + 2 * q4 + c] = x[nt][c];
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int d = nc + nt * 8 + 2 * q4;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        KX[sa * kP + d + c] += f[nt][c] * acc[nt][c];
        KX[sb * kP + d + c] += f[nt][c + 2] * acc[nt][c + 2];
      }
    }
  }
  __syncthreads();

  // Thread (sub-block c, channel d): the pairs inside the sub-block, the
  // decay between them the running product of max(w, 1e-12) over s < m < t
  // (w read again from device memory), for dr's, dk's and d log w's sums;
  // dk with s ascending, each
  // d log w_j's terms before j (the forward sums of k KX, the intra pairs'
  // prefix sums) stored over KX_{j-1}, read no more; then dr, d log w and dw
  // with j descending, adding the suffix sums of r RX
  {
    const int c = tid / kD, d = tid % kD, c0 = c * kSub;
    const float* dA_c = dAs + c0 * kP + c0;
    const float ud = Us[d];
    float base_c = exp2_ftz(Z[d]) * Gz[d];
    for (int i = c + 1; i < kNSub; ++i) base_c += Rsum[i * kD + d];
    for (int i = 0; i < c; ++i) base_c += Ksum[i * kD + d];
    if (c == 1) base_c += Span[d];
    if (c == 2) base_c += Span[kD + d] + Span[2 * kD + d];
    float wv[kSub], rr[kSub], dri[kSub];
#pragma unroll
    for (int t = 0; t < kSub; ++t) {
      wv[t] = c0 + t < tv ? fmaxf(w[base + (size_t)(c0 + t) * step + d], 1e-12f)
                          : 1.f;
      rr[t] = Rs[(c0 + t) * kP + d];
      dri[t] = 0.f;
    }
    float fw = 0.f;
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      const float ks = Ks[(c0 + s) * kP + d];
      float dki = 0.f, f = 1.f;        // the decay over s < m < t
#pragma unroll
      for (int t = s + 1; t < kSub; ++t) {
        if (t > s + 1) f *= wv[t - 1];
        const float x = dA_c[t * kP + s] * f;
        dri[t] = fmaf(x, ks, dri[t]);
        dki = fmaf(x, rr[t], dki);
      }
      float* kx = KX + (c0 + s) * kP + d;
      const float kxs = *kx;
      if (c0 + s < tv)
        dk[base + (size_t)(c0 + s) * step + d] =
            fmaf(ud * rr[s], dA_c[s * kP + s], kxs + dki);
      fw = fmaf(ks, kxs, fw);
      // the intra pairs s' <= s < s + 1 < t: r_t times dr's sum so far
      float p = 0.f;
#pragma unroll
      for (int t = s + 2; t < kSub; ++t) p = fmaf(rr[t], dri[t], p);
      *kx = fw + p;                    // d log w_{s+1}'s terms before it
    }
    float suf = 0.f, du = 0.f;
#pragma unroll
    for (int j = kSub - 1; j >= 0; --j) {
      const float rx = RX[(c0 + j) * kP + d], kj = Ks[(c0 + j) * kP + d];
      const float djj = dA_c[j * kP + j];
      if (c0 + j < tv) {
        const size_t at = base + (size_t)(c0 + j) * step + d;
        dr[at] = fmaf(ud * kj, djj, rx + dri[j]);
        const float lam =
            base_c + (j > 0 ? KX[(c0 + j - 1) * kP + d] : 0.f) + suf;
        const float wj = w[at];
        dw[at] = wj >= 1e-12f ? lam / wj : 0.f;
      }
      suf = fmaf(rr[j], rx, suf);
      du = fmaf(rr[j] * kj, djj, du);
    }
    ATd[c * kD + d] = du;              // A^T's diagonal is read no more
  }
  __syncthreads();
  if (tid < kD)
    du_part[bhc * kD + tid] = ((ATd[tid] + ATd[kD + tid]) + ATd[2 * kD + tid]) +
                              ATd[3 * kD + tid];
}

// ------------------------------------------------ (d) du, in fixed order --
__global__ void rwkv6_bwd_du(const float* __restrict__ du_part,
                             float* __restrict__ du, int B, int H, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * kD) return;
  const int h = i / kD, d = i % kD;
  float acc = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < n; ++c)
      acc += du_part[(((size_t)b * H + h) * n + c) * kD + d];
  du[i] = acc;
}

constexpr size_t kDstateSmem = kDstateFloats * sizeof(float);
constexpr size_t kGradSmem = GradSmem::kFloats * sizeof(float);

int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* dout, const float* ds_final,
           const float* s_in, float* dr, float* dk,
           float* dv, float* dw, float* du, float* ds0, float* scratch, int B,
           int T, int H, cudaStream_t stream) {
  static bool dstate_set[kMaxDevices] = {}, grads_set[kMaxDevices] = {};
  cudaError_t err =
      allow_dynamic_smem(rwkv6_bwd_chunk_dstate, kDstateSmem, dstate_set);
  if (err == cudaSuccess)
    err = allow_dynamic_smem(rwkv6_bwd_chunk_grads, kGradSmem, grads_set);
  if (err != cudaSuccess) return (int)err;
  const int n = (T + kChunk - 1) / kChunk;
  float* local = scratch;                                // (B, H, n, D, D)
  float* ddec = local + (size_t)B * H * n * kD * kD;     // (B, H, n, D)
  float* du_part = ddec + (size_t)B * H * n * kD;        // (B, H, n, D)
  const dim3 grid(n, H, B);
  if (n > 0) {
    rwkv6_bwd_chunk_dstate<<<grid, kThreads, kDstateSmem, stream>>>(
        r, w, dout, local, ddec, T, H, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const size_t quads = (size_t)B * H * kD * kD / 4;
  rwkv6_bwd_state_scan<<<(unsigned)((quads + kScanThreads - 1) / kScanThreads),
                         kScanThreads, 0, stream>>>(local, ddec, ds_final, ds0,
                                                    B * H, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (n > 0) {
    rwkv6_bwd_chunk_grads<<<grid, kThreads, kGradSmem, stream>>>(
        r, k, v, w, u, dout, s_in, local, dr, dk, dv, dw, du_part, T, H, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  rwkv6_bwd_du<<<(H * kD + 255) / 256, 256, 0, stream>>>(du_part, du, B, H, n);
  return (int)cudaGetLastError();
}

}  // namespace wkv_bwd
}  // namespace
}  // namespace repro_torch

// Plain C entry point, bound with ctypes.  r, k, v, w, dout, dr, dk, dv, dw
// (B,T,H,D); u, du (H,D); ds_final, ds0 (B,H,D,D); s_in: the
// forward's scratch, whose first B*H*n*D*D floats hold the state entering
// each chunk (n = ceil(T / 64)); scratch holds B*H*n*(D*D + 2D) floats.  All
// contiguous float32 on the device, 16-byte aligned; ds_final may be null
// (a zero cotangent), ds0 null (not wanted).  D is 64.  Returns the first
// failing launch's cudaError_t (0 on success).
extern "C" int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    const void* dout, const void* ds_final, const void* s_in, void* dr,
    void* dk, void* dv, void* dw, void* du, void* ds0, void* scratch, int B,
    int T, int H, int D, void* stream) {
  using namespace repro_torch;
  if (B == 0 || H == 0) return 0;
  if (D != wkv_bwd::kD) return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  return wkv_bwd::launch(f(r), f(k), f(v), f(w), f(u), f(dout), f(ds_final),
                         f(s_in), m(dr), m(dk), m(dv), m(dw),
                         m(du), m(ds0), m(scratch), B, T, H,
                         static_cast<cudaStream_t>(stream));
}
