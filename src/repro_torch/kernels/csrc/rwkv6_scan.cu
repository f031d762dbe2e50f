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
// place; the kernel forms log(max(w, 1e-12)) itself and writes o
// (B, T, H, D) and the final state (B, H, D, D), starting from s0 or zero.
// Steps past T are identity steps (w = 1, r = k = v = 0): nothing is padded.
//
// Layout.  The TPU grid (B, H, t_blocks) carries the state across its
// sequential time axis in VMEM.  Here the loop over time chunks runs inside
// one block, which keeps its slice of the state in shared memory.  Column e
// of S depends only on v[:, e], so one block per (16 state columns, head,
// batch) owns S[:, e0:e0+16]: at rwkv6-3b's H = 40, D = 64 that is 160
// blocks on 132 SMs, two resident per SM (96.5 KB of shared memory each).
// The price is that every column block recomputes the chunk's (c x c)
// score tile.
//
// Per chunk of c = 64 steps, split into four sub-blocks of 16:
//   (a) load r, k, log w (c x D) and v (c x 16);
//   (b) inclusive (C) and exclusive (E = C shifted by one step) sums of
//       log w per channel, from the chunk start;
//   (c) score entries inside a sub-block, s < t:
//           A[t,s] = sum_d r_t k_s exp(E_t - C_s),  A[t,t] = sum_d r_t u k_t;
//   (d) r^ = r exp(E - E[sub-block start]), r_dec = r exp(E),
//       k^ = k exp(C[sub-block end] - C), k_end = k exp(C[chunk end] - C);
//   (e) score entries across sub-blocks j < i:
//           A[t,s] = sum_d r^_t exp(E[start of i] - C[end of j]) k^_s;
//   (f) o_t = r_dec,t S + sum_{s<=t} A[t,s] v_s;
//   (g) S = diag(exp(C[chunk end])) S + k_end^T v.
//
// Overflow.  The reference (rwkv6_chunked_jnp, layers.py, and the Pallas
// body) forms k exp(-cum) over a 128-step chunk, which overflows f32 once a
// channel's log-decay sum in a chunk falls below about -88 (trained RWKV
// weights reach that; `init_rwkv6` ones do not).  Every exponent here is a
// difference of cumulative sums over a later minus an earlier step, so it
// is <= 0 and each factor is <= 1: the kernel is finite wherever its inputs
// are, and equals the reference wherever the reference is finite.  The
// price is the per-entry exp inside sub-blocks (step c).
//
// What bounds it on the H100: bytes, narrowly.  At B=1, T=1024, H=40, D=64
// the function moves ~53 MB (r, k, v, w in, o and the state out: ~16 us at
// 3.35 TB/s) and needs ~1.0 GFLOP of f32 work at c = 64 (per step and head
// 4 D^2 for the state in and out, per causal (t, s) pair 4 D for the score
// and A.V: ~15 us at 67 TFLOP/s).  This first version does its products as
// f32 FMAs (never TF32) on the CUDA cores out of shared memory, recomputes
// the score tile in each of the D/16 column blocks, and spends an accurate
// expf per score entry inside sub-blocks; tensor cores are the later fix.
//
// Threads: 256.  Step (c): 64 threads per sub-block, each 4 entries of one
// row; (e): thread (t, s) of a 16 x 16 sub-block pair, all six pairs; (f)
// and (g): thread (row group, state column) with 4 rows each (D/16 in g).
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;                     // time steps per chunk
constexpr int kSub = 16;                       // steps per sub-block
constexpr int kNSub = kChunk / kSub;           // 4
constexpr int kPairs = kNSub * (kNSub - 1) / 2;  // sub-block pairs j < i
constexpr int kDV = 16;                        // state columns per block
constexpr int kAP = kChunk + 1;                // pitch of the score tile
static_assert(kThreads == kNSub * 64, "step (c): 64 threads per sub-block");
static_assert(kThreads == kSub * kSub, "step (e): one thread per (t, s)");
static_assert(kThreads == kDV * kSub, "step (f): 16 row groups x 16 columns");

// Shared-memory layout, in floats.  The (c x D) tiles are padded to an odd
// pitch so that threads reading one column of different rows hit
// different banks.
template <int D>
struct Smem {
  static constexpr int P = D + 1;
  static constexpr int R = 0;                  // r, then r^
  static constexpr int K = R + kChunk * P;     // k, then k^
  static constexpr int E = K + kChunk * P;     // exclusive sums, then r_dec
  static constexpr int C = E + kChunk * P;     // log w, inclusive sums, k_end
  static constexpr int V = C + kChunk * P;     // v[:, e0:e0+16]
  static constexpr int A = V + kChunk * kDV;   // scores, upper triangle 0
  static constexpr int S = A + kChunk * kAP;   // state columns (D x 16)
  static constexpr int U = S + D * kDV;        // bonus u[h]
  static constexpr int TOT = U + D;            // per-sub-block sums
  static constexpr int X = TOT + kNSub * D;    // E at each sub-block start
  static constexpr int Y = X + kNSub * D;      // C at each sub-block end
  static constexpr int M = Y + kNSub * D;      // exp(X_i - Y_j), j < i
  static constexpr int DCL = M + kPairs * D;   // exp(C at the chunk end)
  static constexpr int kFloats = DCL + D;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  float* __restrict__ o, float* __restrict__ s_out, int T,
                  int H) {
  using L = Smem<D>;
  constexpr int P = L::P;
  constexpr int V4 = D / 4;
  extern __shared__ float smem[];
  float* Rs = smem + L::R;
  float* Ks = smem + L::K;
  float* Es = smem + L::E;
  float* Cs = smem + L::C;
  float* Vs = smem + L::V;
  float* As = smem + L::A;
  float* Ss = smem + L::S;
  float* Us = smem + L::U;
  float* Tot = smem + L::TOT;
  float* Xs = smem + L::X;
  float* Ys = smem + L::Y;
  float* Ms = smem + L::M;
  float* Dcl = smem + L::DCL;

  const int e0 = blockIdx.x * kDV;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t step = (size_t)H * D;                  // floats per time step
  const size_t base = ((size_t)b * T * H + h) * D;    // (b, 0, h, 0)
  const size_t sbase = ((size_t)b * H + h) * D * D;   // (b, h, 0, 0)

  for (int d = tid; d < D; d += kThreads) Us[d] = u[h * D + d];
  for (int i = tid; i < D * kDV; i += kThreads) {
    const int d = i / kDV, e = i % kDV;
    Ss[i] = s0 != nullptr ? s0[sbase + (size_t)d * D + e0 + e] : 0.f;
  }
  for (int i = tid; i < kChunk * kAP; i += kThreads) As[i] = 0.f;

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    __syncthreads();  // the previous chunk's readers are done

    // (a) load; steps past T are identity steps
    for (int i = tid; i < kChunk * V4; i += kThreads) {
      const int t = i / V4, c = (i % V4) * 4;
      float4 rr = make_float4(0.f, 0.f, 0.f, 0.f), kk = rr, lw = rr;
      if (t0 + t < T) {
        const size_t off = base + (size_t)(t0 + t) * step + c;
        rr = __ldg(reinterpret_cast<const float4*>(r + off));
        kk = __ldg(reinterpret_cast<const float4*>(k + off));
        const float4 ww = __ldg(reinterpret_cast<const float4*>(w + off));
        lw = make_float4(logf(fmaxf(ww.x, 1e-12f)), logf(fmaxf(ww.y, 1e-12f)),
                         logf(fmaxf(ww.z, 1e-12f)), logf(fmaxf(ww.w, 1e-12f)));
      }
      float* rp = Rs + t * P + c;
      float* kp = Ks + t * P + c;
      float* cp = Cs + t * P + c;
      rp[0] = rr.x; rp[1] = rr.y; rp[2] = rr.z; rp[3] = rr.w;
      kp[0] = kk.x; kp[1] = kk.y; kp[2] = kk.z; kp[3] = kk.w;
      cp[0] = lw.x; cp[1] = lw.y; cp[2] = lw.z; cp[3] = lw.w;
    }
    for (int i = tid; i < kChunk * (kDV / 4); i += kThreads) {
      const int t = i / (kDV / 4), c = (i % (kDV / 4)) * 4;
      float4 vv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t0 + t < T)
        vv = __ldg(reinterpret_cast<const float4*>(
            v + base + (size_t)(t0 + t) * step + e0 + c));
      float* vp = Vs + t * kDV + c;
      vp[0] = vv.x; vp[1] = vv.y; vp[2] = vv.z; vp[3] = vv.w;
    }
    __syncthreads();

    // (b) sums of log w: within each sub-block, then offset by the
    // sub-blocks before it.  E[t] equals C[t-1] bit for bit, and both fall
    // monotonically, so every exponent formed below is <= 0.
    for (int i = tid; i < kNSub * D; i += kThreads) {
      const int q = i / D, d = i % D;
      float run = 0.f;
      for (int t = q * kSub; t < (q + 1) * kSub; ++t) {
        const float lw = Cs[t * P + d];
        Es[t * P + d] = run;
        run += lw;
        Cs[t * P + d] = run;
      }
      Tot[q * D + d] = run;
    }
    __syncthreads();
    for (int i = tid; i < kNSub * D; i += kThreads) {
      const int q = i / D, d = i % D;
      float off = 0.f;
      for (int p = 0; p < q; ++p) off += Tot[p * D + d];
      for (int t = q * kSub; t < (q + 1) * kSub; ++t) {
        Es[t * P + d] += off;
        Cs[t * P + d] += off;
      }
      Xs[q * D + d] = off;
      Ys[q * D + d] = off + Tot[q * D + d];
    }
    __syncthreads();

    // (c) scores inside each sub-block (and the bonus on the diagonal),
    // one exp per (t, s, d); then the cross-sub-block decay factors
    {
      const int q = tid / 64, l = tid % 64;
      const int tl = l / 4, sg = (l % 4) * 4;
      const int t = q * kSub + tl;
      if (sg <= tl) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int d = 0; d < D; ++d) {
          const float rv = Rs[t * P + d], ev = Es[t * P + d];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int s = q * kSub + sg + m;
            const float kv = Ks[s * P + d];
            if (sg + m < tl)
              acc[m] = fmaf(rv, kv * expf(ev - Cs[s * P + d]), acc[m]);
            else if (sg + m == tl)
              acc[m] = fmaf(rv, Us[d] * kv, acc[m]);
          }
        }
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (sg + m <= tl) As[t * kAP + q * kSub + sg + m] = acc[m];
      }
    }
    for (int i = tid; i < kPairs * D; i += kThreads) {
      const int p = i / D, d = i % D;
      int qi = 1;
      while (p >= qi * (qi + 1) / 2) ++qi;       // p = qi (qi - 1) / 2 + qj
      const int qj = p - qi * (qi - 1) / 2;
      Ms[p * D + d] = expf(Xs[qi * D + d] - Ys[qj * D + d]);
    }
    for (int d = tid; d < D; d += kThreads)
      Dcl[d] = expf(Ys[(kNSub - 1) * D + d]);
    __syncthreads();

    // (d) decayed r and k, each factor <= 1
    for (int i = tid; i < kChunk * D; i += kThreads) {
      const int t = i / D, d = i % D, q = t / kSub;
      const float rv = Rs[t * P + d], ev = Es[t * P + d];
      const float kv = Ks[t * P + d], cv = Cs[t * P + d];
      Rs[t * P + d] = rv * expf(ev - Xs[q * D + d]);
      Es[t * P + d] = rv * expf(ev);
      Ks[t * P + d] = kv * expf(Ys[q * D + d] - cv);
      Cs[t * P + d] = kv * expf(Ys[(kNSub - 1) * D + d] - cv);
    }
    __syncthreads();

    // (e) scores across sub-blocks j < i
    {
      const int tl = tid / kSub, sl = tid % kSub;
      float acc[kPairs];
#pragma unroll
      for (int p = 0; p < kPairs; ++p) acc[p] = 0.f;
      for (int d = 0; d < D; ++d) {
        float kh[kNSub - 1];
#pragma unroll
        for (int j = 0; j < kNSub - 1; ++j) kh[j] = Ks[(j * kSub + sl) * P + d];
#pragma unroll
        for (int i = 1; i < kNSub; ++i) {
          const float rv = Rs[(i * kSub + tl) * P + d];
#pragma unroll
          for (int j = 0; j < i; ++j) {
            const int p = i * (i - 1) / 2 + j;
            acc[p] = fmaf(rv * Ms[p * D + d], kh[j], acc[p]);
          }
        }
      }
#pragma unroll
      for (int i = 1; i < kNSub; ++i)
#pragma unroll
        for (int j = 0; j < i; ++j)
          As[(i * kSub + tl) * kAP + j * kSub + sl] = acc[i * (i - 1) / 2 + j];
    }
    __syncthreads();

    // (f) outputs: carried state plus the causal scores times v
    {
      const int e = tid % kDV, tg = tid / kDV;
      float acc[kNSub];
#pragma unroll
      for (int q = 0; q < kNSub; ++q) acc[q] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float sv = Ss[d * kDV + e];
#pragma unroll
        for (int q = 0; q < kNSub; ++q)
          acc[q] = fmaf(Es[(tg + q * kSub) * P + d], sv, acc[q]);
      }
      for (int s = 0; s < kChunk; ++s) {
        const float vv = Vs[s * kDV + e];
#pragma unroll
        for (int q = 0; q < kNSub; ++q)
          acc[q] = fmaf(As[(tg + q * kSub) * kAP + s], vv, acc[q]);
      }
#pragma unroll
      for (int q = 0; q < kNSub; ++q) {
        const int t = t0 + tg + q * kSub;
        if (t < T) o[base + (size_t)t * step + e0 + e] = acc[q];
      }
    }
    __syncthreads();

    // (g) state to the chunk end
    {
      constexpr int kRows = D * kDV / kThreads;
      const int e = tid % kDV, dg = tid / kDV;
      float acc[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int d = dg + q * (kThreads / kDV);
        acc[q] = Ss[d * kDV + e] * Dcl[d];
      }
      for (int s = 0; s < kChunk; ++s) {
        const float vv = Vs[s * kDV + e];
#pragma unroll
        for (int q = 0; q < kRows; ++q)
          acc[q] = fmaf(Cs[s * P + dg + q * (kThreads / kDV)], vv, acc[q]);
      }
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        Ss[(dg + q * (kThreads / kDV)) * kDV + e] = acc[q];
    }
  }
  __syncthreads();
  for (int i = tid; i < D * kDV; i += kThreads) {
    const int d = i / kDV, e = i % kDV;
    s_out[sbase + (size_t)d * D + e0 + e] = Ss[i];
  }
}

template <int D>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* o, float* s_out, int B,
           int T, int H, cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {};
  const size_t smem = Smem<D>::kFloats * sizeof(float);
  cudaError_t err = allow_dynamic_smem(rwkv6_scan_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(D / kDV, H, B);
  rwkv6_scan_kernel<D><<<grid, kThreads, smem, stream>>>(r, k, v, w, u, s0, o,
                                                         s_out, T, H);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Plain C entry point, bound with ctypes.  r, k, v, w, o (B,T,H,D), u (H,D),
// s0 and s_out (B,H,D,D): contiguous float32 on the device, r/k/v/w 16-byte
// aligned; s0 may be null (zero state); D is 64 or 128.  Returns the
// launch's cudaError_t.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, const void* s0,
                                 void* o, void* s_out, int B, int T, int H,
                                 int D, void* stream) {
  using namespace repro_torch;
  if (B == 0 || H == 0) return 0;
  decltype(&launch<64>) fn =
      D == 64 ? &launch<64> : D == 128 ? &launch<128> : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  return fn(f(r), f(k), f(v), f(w), f(u), f(s0), static_cast<float*>(o),
            static_cast<float*>(s_out), B, T, H,
            static_cast<cudaStream_t>(stream));
}
