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
// Four launches on one stream, no atomics (the same bits on every call):
//   (a) rwkv6_bwd_chunk_dstate, one block per (chunk, head, batch): each
//       chunk's local term sum_t (r_t 2^E_t) do_t^T and its decay 2^Z, into
//       scratch (B, H, n, D, D) + (B, H, n, D);
//   (b) rwkv6_bwd_state_scan, one thread per (4 state entries, head, batch):
//       the chunks last to first from dS_T (or 0), dS_out[c] = dS,
//       dS = diag(2^Z_c) dS + local_c, storing dS_out[c] over local_c, and
//       the last dS as ds0;
//   (c) rwkv6_bwd_chunk_grads, one block per (chunk, head, batch): A and dA,
//       then dv, dr, dk from the chunk's inputs, S_in (the forward's pass (b)
//       scratch, which the autograd Function saves) and dS_out, then d log w
//       (the last sum over pairs s < j < t kept as prefix sums over s, one
//       per row t and state row d, walked along j) and dw, and the chunk's
//       share of du;
//   (d) rwkv6_bwd_du: du summed over batches and chunks in order.
//
// Overflow.  Every exponent formed is a later cumulative sum minus an
// earlier one (E_t - C_s for s < t, Z - C_s, E_t), so it is <= 0 and every
// factor <= 1, as in the forward kernel: the kernel is finite wherever its
// inputs are, where the reference's k exp(-cum) overflows under strong decay.
//
// What bounds it on the H100: operations, on paper.  At rwkv6-3b's training
// shape (B 4, T 1024, H 40, D 64) it moves ~0.38 GB (r, k, v, w, do in; dr,
// dk, dv, dw out; ~0.11 ms at 3.35 TB/s) against ~8.8 GFLOP of products
// (~0.13 ms at the f32 CUDA-core peak).  This first kernel is simple, not
// fast: f32 FMAs on the CUDA cores (no TF32), one exp per (t, s, d) of the
// four intra-chunk sums, one block of 8 warps a chunk with its whole working
// set in 176 KB of shared memory (one block a SM).  D is 64 (rwkv6-3b's).
// On an H100 (700 W) the four launches take 1.83 ms at that shape (7% of
// the bound), (c) 1.58 ms of it; ptxas: (c) 118 registers, no spills.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {
namespace wkv_bwd {

constexpr int kThreads = 256;                  // 8 warps
constexpr int kChunk = 64;                     // the forward's chunk
constexpr int kD = 64;                         // head dim
constexpr int kP = kD + 4;                     // pitch of every tile
constexpr int kTile = kChunk * kP;             // floats of a 64-row tile
constexpr int kScanThreads = 256;              // pass (b)
constexpr int kScanAhead = 8;                  // pass (b): chunks loaded ahead
static_assert(kChunk == kD && kD * kD == 16 * kThreads, "16 outputs a thread");

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

// Rows t < tv of a (kChunk x kD) tile of a (B, T, H, kD) tensor into shared
// memory at pitch kP, 16 bytes a thread; rows past tv are zero-filled.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          size_t step, int tv, int tid) {
  constexpr int c4 = kD / 4;
  for (int i = tid; i < kChunk * c4; i += kThreads) {
    const int t = i / c4, c = (i % c4) * 4;
    const bool ok = t < tv;
    cp_async16(dst + t * kP + c, src + (ok ? (size_t)t * step + c : 0), ok);
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
// start, and Cx[0] = 0 (so Cx[t] = E_t), from w at pitch kP, in four parts
// of 16 steps whose offsets are summed in order: the forward's pass (c)
// sums, bit for bit.
__device__ __forceinline__ void cum_sums(float* Cx, const float* Ws,
                                         float* Tot, int tv, int tid) {
  constexpr int Q = kThreads / kD, LEN = kChunk / Q;
  const int d = tid % kD, q = tid / kD;
  float run = 0.f;
  for (int i = 0; i < LEN; ++i) {
    const int t = q * LEN + i;
    run += t < tv ? log2f(fmaxf(Ws[t * kP + d], 1e-12f)) : 0.f;
    Cx[(t + 1) * kP + d] = run;
  }
  Tot[q * kD + d] = run;
  if (q == 0) Cx[d] = 0.f;
  __syncthreads();
  if (q > 0) {
    float off = 0.f;
    for (int p = 0; p < q; ++p) off += Tot[p * kD + d];
    for (int i = 0; i < LEN; ++i) Cx[(q * LEN + i + 1) * kP + d] += off;
  }
}

// ------------------------------------- (a) each chunk's local state term --
__global__ void __launch_bounds__(kThreads)
rwkv6_bwd_chunk_dstate(const float* __restrict__ r, const float* __restrict__ w,
                       const float* __restrict__ dout, float* __restrict__ local,
                       float* __restrict__ ddec, int T, int H, int n) {
  extern __shared__ __align__(16) float smem[];
  float* Rs = smem;                    // r, then r 2^E
  float* Os = Rs + kTile;              // do
  float* Ws = Os + kTile;              // w
  float* Cx = Ws + kTile;              // (kChunk + 1) rows
  float* Tot = Cx + kTile + kP;

  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int t0 = chunk * kChunk, tv = min(kChunk, T - t0);
  const size_t step = (size_t)H * kD;
  const size_t base = (((size_t)b * T + t0) * H + h) * kD;

  load_rows(Rs, r + base, step, tv, tid);
  load_rows(Os, dout + base, step, tv, tid);
  load_rows(Ws, w + base, step, tv, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  cum_sums(Cx, Ws, Tot, tv, tid);
  __syncthreads();
  for (int i = tid; i < kChunk * kD; i += kThreads) {
    const int t = i / kD, d = i % kD;
    Rs[t * kP + d] *= exp2_ftz(Cx[t * kP + d]);
  }
  const size_t bhc = ((size_t)b * H + h) * n + chunk;
  if (tid < kD) ddec[bhc * kD + tid] = exp2_ftz(Cx[kChunk * kP + tid]);
  __syncthreads();

  // local[d, e] = sum_t r_dec[t, d] do[t, e]: row d, 16 columns a thread
  const int d = tid / 4, e0 = (tid % 4) * 16;
  float acc[16] = {};
  for (int t = 0; t < tv; ++t) {
    const float a = Rs[t * kP + d];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float4 o = ld4(Os + t * kP + e0 + 4 * m);
      acc[4 * m] = fmaf(a, o.x, acc[4 * m]);
      acc[4 * m + 1] = fmaf(a, o.y, acc[4 * m + 1]);
      acc[4 * m + 2] = fmaf(a, o.z, acc[4 * m + 2]);
      acc[4 * m + 3] = fmaf(a, o.w, acc[4 * m + 3]);
    }
  }
  float* out = local + bhc * kD * kD + (size_t)d * kD + e0;
#pragma unroll
  for (int m = 0; m < 4; ++m)
    *reinterpret_cast<float4*>(out + 4 * m) =
        make_float4(acc[4 * m], acc[4 * m + 1], acc[4 * m + 2], acc[4 * m + 3]);
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
// Tiles at pitch kP: r, k, v (then the forward sums of d log w), do, w;
// S_in (then its k-state terms), dS_out; A (then its r-state terms), dA;
// the sums Cx (kChunk + 1 rows); u; diag(S_in dS_out^T); part totals.
constexpr int kGradFloats = 9 * kTile + (kTile + kP) + 2 * kD + kThreads;

__global__ void __launch_bounds__(kThreads, 1)
rwkv6_bwd_chunk_grads(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, const float* __restrict__ dout,
                      const float* __restrict__ s_in,
                      const float* __restrict__ ds_out, float* __restrict__ dr,
                      float* __restrict__ dk, float* __restrict__ dv,
                      float* __restrict__ dw, float* __restrict__ du_part,
                      int T, int H, int n) {
  extern __shared__ __align__(16) float smem[];
  float* Rs = smem;
  float* Ks = Rs + kTile;
  float* Vs = Ks + kTile;
  float* Os = Vs + kTile;
  float* Ws = Os + kTile;
  float* Si = Ws + kTile;      // S_in[d][e]; then k_s 2^(Z - C_s) (dS_out v_s)
  float* So = Si + kTile;      // dS_out[d][e]
  float* As = So + kTile;      // A[t][s]; then r_t 2^E_t (S_in do_t)
  float* dAs = As + kTile;     // dA[t][s], zero above the diagonal
  float* Cx = dAs + kTile;     // Cx[t] = E_t, Cx[t + 1] = C_t, Cx[kChunk] = Z
  float* Us = Cx + kTile + kP;
  float* Gz = Us + kD;         // diag(S_in dS_out^T)
  float* Tot = Gz + kD;

  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int t0 = chunk * kChunk, tv = min(kChunk, T - t0);
  const size_t step = (size_t)H * kD;
  const size_t base = (((size_t)b * T + t0) * H + h) * kD;
  const size_t bhc = ((size_t)b * H + h) * n + chunk;

  load_rows(Rs, r + base, step, tv, tid);
  load_rows(Ks, k + base, step, tv, tid);
  load_rows(Vs, v + base, step, tv, tid);
  load_rows(Os, dout + base, step, tv, tid);
  load_rows(Ws, w + base, step, tv, tid);
  load_state(Si, s_in + bhc * kD * kD, tid);
  load_state(So, ds_out + bhc * kD * kD, tid);
  for (int i = tid; i < kD / 4; i += kThreads)
    cp_async16(Us + 4 * i, u + (size_t)h * kD + 4 * i, true);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  cum_sums(Cx, Ws, Tot, tv, tid);

  // diag(S_in dS_out^T): row d, four threads a row
  {
    const int d = tid / 4, part = tid % 4;
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int e = part * 16 + 4 * m;
      acc = dot4(ld4(Si + d * kP + e), ld4(So + d * kP + e), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) Gz[d] = acc;
  }
  __syncthreads();

  // A[t, s] = sum_d r_t k_s 2^(E_t - C_s) (s < t), r_t u k_t (s = t);
  // dA[t, s] = do_t . v_s (s <= t); both 0 above the diagonal
  for (int i = tid; i < kChunk * kChunk; i += kThreads) {
    const int t = i / kChunk, s = i % kChunk;
    float a = 0.f, da = 0.f;
    if (s < t) {
      for (int d = 0; d < kD; d += 4) {
        const float4 rv = ld4(Rs + t * kP + d), kv = ld4(Ks + s * kP + d);
        const float4 e = ld4(Cx + t * kP + d), c = ld4(Cx + (s + 1) * kP + d);
        a = fmaf(rv.x, kv.x * exp2_ftz(e.x - c.x), a);
        a = fmaf(rv.y, kv.y * exp2_ftz(e.y - c.y), a);
        a = fmaf(rv.z, kv.z * exp2_ftz(e.z - c.z), a);
        a = fmaf(rv.w, kv.w * exp2_ftz(e.w - c.w), a);
        da = dot4(ld4(Os + t * kP + d), ld4(Vs + s * kP + d), da);
      }
    } else if (s == t) {
      for (int d = 0; d < kD; d += 4) {
        const float4 rv = ld4(Rs + t * kP + d), kv = ld4(Ks + t * kP + d);
        const float4 uv = ld4(Us + d);
        a = fmaf(rv.x, uv.x * kv.x, a);
        a = fmaf(rv.y, uv.y * kv.y, a);
        a = fmaf(rv.z, uv.z * kv.z, a);
        a = fmaf(rv.w, uv.w * kv.w, a);
        da = dot4(ld4(Os + t * kP + d), ld4(Vs + t * kP + d), da);
      }
    }
    As[t * kP + s] = a;
    dAs[t * kP + s] = da;
  }
  __syncthreads();

  // The (row, column) outputs: thread (p, g) takes rows p and 63 - p (so
  // every thread walks 63 pair steps) and columns g + 8i
  const int p = warp * 4 + lane / 8, g = lane % 8;

  // dv_s = sum_{t>=s} A[t,s] do_t + dS_out^T (k_s 2^(Z - C_s))
  for (int half = 0; half < 2; ++half) {
    const int s = half ? kChunk - 1 - p : p;
    float acc[8] = {};
    for (int t = s; t < tv; ++t) {
      const float a = As[t * kP + s];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(a, Os[t * kP + g + 8 * i], acc[i]);
    }
    for (int d = 0; d < kD; ++d) {
      const float ke = Ks[s * kP + d] *
                       exp2_ftz(Cx[kChunk * kP + d] - Cx[(s + 1) * kP + d]);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(ke, So[d * kP + g + 8 * i], acc[i]);
    }
    if (s < tv) {
#pragma unroll
      for (int i = 0; i < 8; ++i) dv[base + (size_t)s * step + g + 8 * i] = acc[i];
    }
  }
  __syncthreads();                     // A is read no more

  // dr_t = 2^E_t (S_in do_t) + sum_{s<t} dA[t,s] k_s 2^(E_t - C_s) + u k_t dA[t,t]
  for (int half = 0; half < 2; ++half) {
    const int t = half ? kChunk - 1 - p : p;
    float e[8], acc[8] = {}, st[8] = {};
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = Cx[t * kP + g + 8 * i];
    for (int s = 0; s < t; ++s) {
      const float f = dAs[t * kP + s];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int d = g + 8 * i;
        acc[i] = fmaf(f * Ks[s * kP + d], exp2_ftz(e[i] - Cx[(s + 1) * kP + d]),
                      acc[i]);
      }
    }
    for (int c = 0; c < kD; ++c) {
      const float o = Os[t * kP + c];
#pragma unroll
      for (int i = 0; i < 8; ++i) st[i] = fmaf(Si[(g + 8 * i) * kP + c], o, st[i]);
    }
    const float dd = dAs[t * kP + t];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int d = g + 8 * i;
      const float sp = exp2_ftz(e[i]) * st[i];
      acc[i] += sp;
      As[t * kP + d] = Rs[t * kP + d] * sp;
      if (t < tv)
        dr[base + (size_t)t * step + d] = fmaf(Us[d] * Ks[t * kP + d], dd, acc[i]);
    }
  }
  __syncthreads();                     // S_in is read no more

  // dk_s = 2^(Z - C_s) (dS_out v_s) + sum_{t>s} dA[t,s] r_t 2^(E_t - C_s)
  //        + u r_s dA[s,s]
  for (int half = 0; half < 2; ++half) {
    const int s = half ? kChunk - 1 - p : p;
    float cs[8], acc[8] = {}, st[8] = {};
#pragma unroll
    for (int i = 0; i < 8; ++i) cs[i] = Cx[(s + 1) * kP + g + 8 * i];
    for (int t = s + 1; t < tv; ++t) {
      const float f = dAs[t * kP + s];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int d = g + 8 * i;
        acc[i] = fmaf(f * Rs[t * kP + d], exp2_ftz(Cx[t * kP + d] - cs[i]),
                      acc[i]);
      }
    }
    for (int c = 0; c < kD; ++c) {
      const float x = Vs[s * kP + c];
#pragma unroll
      for (int i = 0; i < 8; ++i) st[i] = fmaf(So[(g + 8 * i) * kP + c], x, st[i]);
    }
    const float dd = dAs[s * kP + s];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int d = g + 8 * i;
      const float sp = exp2_ftz(Cx[kChunk * kP + d] - cs[i]) * st[i];
      acc[i] += sp;
      Si[s * kP + d] = Ks[s * kP + d] * sp;
      if (s < tv)
        dk[base + (size_t)s * step + d] = fmaf(Us[d] * Rs[s * kP + d], dd, acc[i]);
    }
  }
  __syncthreads();

  // the forward sums of d log w_j (over s < j) into v's place: thread (d,
  // q) keeps, for its rows t = q + 4m, the prefix sums over s < j of
  // dA[t,s] r_t k_s 2^(E_t - C_s), and adds those of its rows t > j; four
  // lanes a d
  {
    const int d = tid / 4, q = tid % 4;
    float e[16], rr[16], pre[16] = {}, run = 0.f;
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      e[m] = Cx[(q + 4 * m) * kP + d];
      rr[m] = Rs[(q + 4 * m) * kP + d];
    }
    for (int j = 0; j < tv; ++j) {
      if (j > 0) {
        const int s = j - 1;
        const float ks = Ks[s * kP + d], cs = Cx[(s + 1) * kP + d];
#pragma unroll
        for (int m = 0; m < 16; ++m)
          if (q + 4 * m > s)
            pre[m] = fmaf(exp2_ftz(e[m] - cs) * ks * rr[m],
                          dAs[(q + 4 * m) * kP + s], pre[m]);
        run += Si[s * kP + d];
      }
      float part = 0.f;
#pragma unroll
      for (int m = 0; m < 16; ++m)
        if (q + 4 * m > j) part += pre[m];
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (q == 0) Vs[j * kP + d] = part + run;
    }
  }
  __syncthreads();

  // d log w_j = the whole decay's term + the reverse sum over t > j + the
  // forward sums, last step first; dw = d log w / w above the clamp; the
  // chunk's share of du
  if (tid < kD) {
    const int d = tid;
    const float whole = exp2_ftz(Cx[kChunk * kP + d]) * Gz[d];
    float run = 0.f, du = 0.f;
    for (int j = tv - 1; j >= 0; --j) {
      const float lam = whole + run + Vs[j * kP + d];
      const float wj = Ws[j * kP + d];
      dw[base + (size_t)j * step + d] = wj >= 1e-12f ? lam / wj : 0.f;
      run += As[j * kP + d];
      du = fmaf(Rs[j * kP + d] * Ks[j * kP + d], dAs[j * kP + j], du);
    }
    du_part[bhc * kD + d] = du;
  }
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

constexpr size_t kDstateSmem = (3 * kTile + kTile + kP + kThreads) * sizeof(float);
constexpr size_t kGradSmem = kGradFloats * sizeof(float);

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
