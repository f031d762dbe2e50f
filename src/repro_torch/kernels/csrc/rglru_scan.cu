// rglru_scan: the RG-LRU linear recurrence h_t = exp(log_a_t) * h_{t-1} + b_t,
// elementwise over channels, for Hopper.
//
// Replaces the TPU kernel `rglru_scan` (src/repro/kernels/rglru_scan.py,
// `_rglru_kernel`).  Same function: log_a, b (B,T,d) f32, optional h0 (B,d)
// f32 (zeros when absent); every h_t is written, in f32.
//
// What bounds it on the H100: bytes.  Per element it reads log_a and b once
// and writes h once (12 bytes) against one exp and two flops: at B=1, T=1024,
// d=2560 that is 31.5 MB, ~9.4 us at 3.35 TB/s.  The Pallas grid (B,
// d_blocks, t_blocks) carries h in VMEM across its sequential time blocks; a
// thread per channel walking all T steps gives the card only B*d threads
// (2560 at B=1), too few loads in flight for that rate.  So time is split as
// well as channels, in two launches on one stream:
//
// Pass 1, grid (channel block, time chunk, batch) over every chunk but the
// last: each thread scans its channels over its chunk of `len` steps from
// h = 0, and writes the chunk's aggregate: the product P of its exp(log_a)
// (<= 1, rounded step by step) and the local h.
//
// Pass 2, grid (channel block, time chunk, batch) over every chunk: each
// thread composes the h entering its chunk from h0 (or 0) and the aggregates
// of the chunks before it, in chunk order (h = P_j h + h_j), then rescans
// its chunk from that h with the plain version's step, two roundings and no
// FMA (__fmul_rn(expf(la), h) + b), writing every h.  Within a chunk the
// steps are the plain version's; only the carried h differs from it, by the
// rounding of the composed products (a few ulp of |h|).
//
// Loads: neighbouring threads take neighbouring channels (d is contiguous),
// 16 bytes (4 channels) a thread when d is a multiple of 4 and the pointers
// are 16-byte aligned, else 4; each thread loads 16 (32) steps of log_a
// and b before the dependent steps that use them, so those loads are all in
// flight together, and the carry's aggregates a batch at a time likewise.  Steps past T are identity steps (log_a = 0, b = 0) and
// are not written.  Deterministic: no atomics, the carry in chunk order.
//
// Offsets are 64-bit from the batch index on (recurrentgemma-2b's
// 524288-step prefill: 1.3e9 elements an input); the grid is (channel
// blocks, time chunks, B), and the launch refuses chunks or B past 65535.
#include <math.h>
#include <stdint.h>

#include <cuda_runtime.h>

namespace repro_torch {
namespace {

constexpr int kThreads = 64;   // channel groups per block

// Steps (and carried chunks) whose loads are issued together, before the
// dependent steps that use them: 32 float4 or 32 floats a thread.
template <int V> __host__ __device__ constexpr int ahead() {
  return V == 4 ? 16 : 32;
}

template <int V> struct Vec;
template <> struct Vec<4> {
  static __device__ __forceinline__ void get(const float* p, float (&x)[4]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  static __device__ __forceinline__ void put(float* p, const float (&x)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};
template <> struct Vec<1> {
  static __device__ __forceinline__ void get(const float* p, float (&x)[1]) {
    x[0] = __ldg(p);
  }
  static __device__ __forceinline__ void put(float* p, const float (&x)[1]) {
    p[0] = x[0];
  }
};

// N steps of V channels from h: loads first, then the dependent steps, two
// roundings each (no FMA), as the plain version's exp(la) * h + b.  With
// kAgg, also the product P of the decays; else every h is written.
template <int V, int N, bool kAgg>
__device__ __forceinline__ void steps(const float* la_p, const float* b_p,
                                      float* out, size_t d, int n,
                                      float (&h)[V], float (&P)[V]) {
  float la[N][V], bb[N][V];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < n) {
      Vec<V>::get(la_p + i * d, la[i]);
      Vec<V>::get(b_p + i * d, bb[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < n) {
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const float a = expf(la[i][c]);
        h[c] = __fmul_rn(a, h[c]) + bb[i][c];
        if (kAgg) P[c] = __fmul_rn(a, P[c]);
      }
      if (!kAgg) Vec<V>::put(out + i * d, h);
    }
  }
}

// Steps [t0, t1): whole batches of ahead<V>() steps, then the rest.
template <int V, bool kAgg>
__device__ __forceinline__ void scan(const float* la_p, const float* b_p,
                                     float* out, size_t d, int t0, int t1,
                                     float (&h)[V], float (&P)[V]) {
  constexpr int N = ahead<V>();
  int t = t0;
  for (; t + N <= t1; t += N)
    steps<V, N, kAgg>(la_p + t * d, b_p + t * d, out + t * d, d, N, h, P);
  if (t < t1)
    steps<V, N, kAgg>(la_p + t * d, b_p + t * d, out + t * d, d, t1 - t, h, P);
}

// Pass 1: the aggregates (P, local h) of chunks 0 .. n-2, each (B, n-1, d).
template <int V>
__global__ void __launch_bounds__(kThreads)
rglru_chunk_agg(const float* __restrict__ log_a, const float* __restrict__ b,
                float* __restrict__ agg_p, float* __restrict__ agg_h, int T,
                int d, int len) {
  const int c0 = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (c0 >= d) return;
  const int chunk = blockIdx.y, bi = blockIdx.z, n1 = gridDim.y;
  const size_t base = (size_t)bi * T * d + c0;
  float h[V], P[V];
#pragma unroll
  for (int c = 0; c < V; ++c) h[c] = 0.f, P[c] = 1.f;
  const int t0 = chunk * len;
  scan<V, true>(log_a + base, b + base, nullptr, d, t0, min(T, t0 + len), h,
                P);
  const size_t a = ((size_t)bi * n1 + chunk) * d + c0;
  Vec<V>::put(agg_p + a, P);
  Vec<V>::put(agg_h + a, h);
}

// Pass 2: the carry into each chunk (the aggregates before it, loaded a
// batch at a time, composed in chunk order), then its h.
template <int V>
__global__ void __launch_bounds__(kThreads)
rglru_chunk_scan(const float* __restrict__ log_a, const float* __restrict__ b,
                 const float* __restrict__ h0,
                 const float* __restrict__ agg_p,
                 const float* __restrict__ agg_h, float* __restrict__ out,
                 int T, int d, int len) {
  constexpr int N = ahead<V>() / 2;
  const int c0 = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (c0 >= d) return;
  const int chunk = blockIdx.y, bi = blockIdx.z, n1 = gridDim.y - 1;
  float h[V];
  if (h0 != nullptr) {
    Vec<V>::get(h0 + (size_t)bi * d + c0, h);
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c) h[c] = 0.f;
  }
  const size_t agg = (size_t)bi * n1 * d + c0;
  for (int j0 = 0; j0 < chunk; j0 += N) {
    float P[N][V], hl[N][V];
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j0 + j < chunk) {
        Vec<V>::get(agg_p + agg + (size_t)(j0 + j) * d, P[j]);
        Vec<V>::get(agg_h + agg + (size_t)(j0 + j) * d, hl[j]);
      }
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j0 + j < chunk) {
#pragma unroll
        for (int c = 0; c < V; ++c) h[c] = __fmul_rn(P[j][c], h[c]) + hl[j][c];
      }
  }
  const size_t base = (size_t)bi * T * d + c0;
  const int t0 = chunk * len;
  float unused[V];
  scan<V, false>(log_a + base, b + base, out + base, d, t0, min(T, t0 + len),
                 h, unused);
}

template <int V>
int launch(const float* log_a, const float* b, const float* h0, float* out,
           float* scratch, int B, int T, int d, int len, cudaStream_t stream) {
  const int n = (T + len - 1) / len;
  const int blocks = (d + kThreads * V - 1) / (kThreads * V);
  // the grid's y (time chunks) and z (batch) take at most 65535 each
  if (n > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  float* agg_p = scratch;                              // (B, n-1, d)
  float* agg_h = scratch + (size_t)B * (n - 1) * d;    // (B, n-1, d)
  if (n > 1) {
    rglru_chunk_agg<V><<<dim3(blocks, n - 1, B), kThreads, 0, stream>>>(
        log_a, b, agg_p, agg_h, T, d, len);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  rglru_chunk_scan<V><<<dim3(blocks, n, B), kThreads, 0, stream>>>(
      log_a, b, h0, agg_p, agg_h, out, T, d, len);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- backward --
// Given dy = dL/dh and the forward's h, with a_t = exp(log_a_t):
//   g_t = dy_t + a_{t+1} g_{t+1}  (g past T is 0),   db_t = g_t,
//   dlog_a_t = g_t h_{t-1} a_t    (h_{-1} = h0 or 0), dh0 = a_0 g_0.
// The carry c_t = a_t g_t, what step t passes back to step t - 1, runs
// backward as c = a_t (dy_t + c): the forward's recurrence in reverse, with
// the decay applied after the sum.  So the split is the forward's, in
// reverse chunk order: pass 1 writes each chunk's aggregate (the product P
// of its a and its c from zero) for every chunk but the first; pass 2
// composes the carry entering each chunk from the chunks after it (c =
// P_k c + c_k, last chunk first) and rescans its chunk backward, writing
// db and dlog_a (and dh0 from the first chunk).  Roundings are those of
// autograd through the plain version: (g h_{t-1}) a and a g, two products.
// Bound by bytes (log_a, h, dy read once, dlog_a and db written once: 210
// MB at B=1, T=4096, d=2560, 0.063 ms); on an H100 (700 W) 0.112 ms there.

// N steps [ts, ts + n) of V channels, loaded first, then walked backward
// from the carry c.  With kAgg, also the product P of the decays; else db
// and dlog_a of every step are written (hp: h_{t-1}, h0v where t = 0).
template <int V, int N, bool kAgg>
__device__ __forceinline__ void steps_bwd(const float* la_p, const float* dy_p,
                                          const float* h_p, const float (&h0v)[V],
                                          float* db_p, float* dla_p, size_t d,
                                          int ts, int n, float (&c)[V],
                                          float (&P)[V]) {
  float la[N][V], dy[N][V], hp[kAgg ? 1 : N][V];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < n) {
      const size_t at = (size_t)(ts + i) * d;
      Vec<V>::get(la_p + at, la[i]);
      Vec<V>::get(dy_p + at, dy[i]);
      if (!kAgg) {
        if (ts + i > 0) {
          Vec<V>::get(h_p + at - d, hp[kAgg ? 0 : i]);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) hp[kAgg ? 0 : i][k] = h0v[k];
        }
      }
    }
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    if (i < n) {
      float db[V], dla[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float a = expf(la[i][k]);
        const float g = dy[i][k] + c[k];
        if (!kAgg) {
          db[k] = g;
          dla[k] = __fmul_rn(__fmul_rn(g, hp[kAgg ? 0 : i][k]), a);
        }
        c[k] = __fmul_rn(a, g);
        if (kAgg) P[k] = __fmul_rn(a, P[k]);
      }
      if (!kAgg) {
        const size_t at = (size_t)(ts + i) * d;
        Vec<V>::put(db_p + at, db);
        Vec<V>::put(dla_p + at, dla);
      }
    }
  }
}

// Steps [t0, t1) backward: whole batches of ahead<V>() steps from the end,
// then the rest.
template <int V, bool kAgg>
__device__ __forceinline__ void scan_bwd(const float* la_p, const float* dy_p,
                                         const float* h_p, const float (&h0v)[V],
                                         float* db_p, float* dla_p, size_t d,
                                         int t0, int t1, float (&c)[V],
                                         float (&P)[V]) {
  constexpr int N = ahead<V>() / 2;
  int t = t1;
  for (; t - N >= t0; t -= N)
    steps_bwd<V, N, kAgg>(la_p, dy_p, h_p, h0v, db_p, dla_p, d, t - N, N, c, P);
  if (t > t0)
    steps_bwd<V, N, kAgg>(la_p, dy_p, h_p, h0v, db_p, dla_p, d, t0, t - t0, c,
                          P);
}

// Backward pass 1: the aggregates (P, local carry) of chunks 1 .. n-1, at
// index chunk - 1 of (B, n-1, d).
template <int V>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_chunk_agg(const float* __restrict__ log_a,
                    const float* __restrict__ dy, float* __restrict__ agg_p,
                    float* __restrict__ agg_c, int T, int d, int len) {
  const int c0 = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (c0 >= d) return;
  const int chunk = blockIdx.y + 1, bi = blockIdx.z, n1 = gridDim.y;
  const size_t base = (size_t)bi * T * d + c0;
  float c[V], P[V], none[V];
#pragma unroll
  for (int k = 0; k < V; ++k) c[k] = 0.f, P[k] = 1.f, none[k] = 0.f;
  const int t0 = chunk * len;
  scan_bwd<V, true>(log_a + base, dy + base, nullptr, none, nullptr, nullptr,
                    d, t0, min(T, t0 + len), c, P);
  const size_t a = ((size_t)bi * n1 + blockIdx.y) * d + c0;
  Vec<V>::put(agg_p + a, P);
  Vec<V>::put(agg_c + a, c);
}

// Backward pass 2: the carry entering each chunk (the aggregates after it,
// last chunk first), then its db and dlog_a; the first chunk writes dh0.
template <int V>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_chunk_scan(const float* __restrict__ log_a,
                     const float* __restrict__ h, const float* __restrict__ h0,
                     const float* __restrict__ dy,
                     const float* __restrict__ agg_p,
                     const float* __restrict__ agg_c, float* __restrict__ dla,
                     float* __restrict__ db, float* __restrict__ dh0, int T,
                     int d, int len) {
  constexpr int N = ahead<V>() / 2;
  const int c0 = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (c0 >= d) return;
  const int chunk = blockIdx.y, bi = blockIdx.z, n = gridDim.y;
  float c[V], h0v[V];
#pragma unroll
  for (int k = 0; k < V; ++k) c[k] = 0.f, h0v[k] = 0.f;
  if (chunk == 0 && h0 != nullptr) Vec<V>::get(h0 + (size_t)bi * d + c0, h0v);
  const size_t agg = (size_t)bi * (n - 1) * d + c0;
  // chunks n-1 .. chunk+1 (aggregate index k - 1), a batch of loads at a time
  for (int k0 = n - 1; k0 > chunk; k0 -= N) {
    float P[N][V], cl[N][V];
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (k0 - j > chunk) {
        Vec<V>::get(agg_p + agg + (size_t)(k0 - j - 1) * d, P[j]);
        Vec<V>::get(agg_c + agg + (size_t)(k0 - j - 1) * d, cl[j]);
      }
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (k0 - j > chunk) {
#pragma unroll
        for (int k = 0; k < V; ++k) c[k] = __fmul_rn(P[j][k], c[k]) + cl[j][k];
      }
  }
  const size_t base = (size_t)bi * T * d + c0;
  const int t0 = chunk * len;
  float unused[V];
  scan_bwd<V, false>(log_a + base, dy + base, h + base, h0v, db + base,
                     dla + base, d, t0, min(T, t0 + len), c, unused);
  if (chunk == 0 && dh0 != nullptr) Vec<V>::put(dh0 + (size_t)bi * d + c0, c);
}

template <int V>
int launch_bwd(const float* log_a, const float* h, const float* h0,
               const float* dy, float* dla, float* db, float* dh0,
               float* scratch, int B, int T, int d, int len,
               cudaStream_t stream) {
  const int n = (T + len - 1) / len;
  const int blocks = (d + kThreads * V - 1) / (kThreads * V);
  if (n > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  float* agg_p = scratch;                              // (B, n-1, d)
  float* agg_c = scratch + (size_t)B * (n - 1) * d;    // (B, n-1, d)
  if (n > 1) {
    rglru_bwd_chunk_agg<V><<<dim3(blocks, n - 1, B), kThreads, 0, stream>>>(
        log_a, dy, agg_p, agg_c, T, d, len);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  rglru_bwd_chunk_scan<V><<<dim3(blocks, n, B), kThreads, 0, stream>>>(
      log_a, h, h0, dy, agg_p, agg_c, dla, db, dh0, T, d, len);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace
}  // namespace repro_torch

// Plain C entry point, bound with ctypes.  log_a, b, out (B,T,d) and h0 (B,d)
// or null: contiguous float32 on the device; scratch holds 2*B*(n-1)*d
// floats, n = ceil(T / len), len > 0 the steps of a time chunk.  Returns the
// first failing launch's cudaError_t (0 on success).
extern "C" int rglru_scan_launch(const void* log_a, const void* b,
                                 const void* h0, void* out, void* scratch,
                                 int B, int T, int d, int len, void* stream) {
  using namespace repro_torch;
  if (B == 0 || T == 0 || d == 0) return 0;
  if (len <= 0) return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const bool vec4 = d % 4 == 0 && aligned16(log_a) && aligned16(b) &&
                    aligned16(h0) && aligned16(out) && aligned16(scratch);
  return (vec4 ? &launch<4> : &launch<1>)(
      f(log_a), f(b), f(h0), static_cast<float*>(out),
      static_cast<float*>(scratch), B, T, d, len,
      static_cast<cudaStream_t>(stream));
}

// Plain C entry point of the backward, bound with ctypes.  log_a, h (the
// forward's output), dy, dla, db (B,T,d); h0 and dh0 (B,d) or null (dh0 is
// written only with h0): contiguous float32 on the device; scratch as the
// forward's.  Returns the first failing launch's cudaError_t (0 on success).
extern "C" int rglru_scan_bwd_launch(const void* log_a, const void* h,
                                     const void* h0, const void* dy, void* dla,
                                     void* db, void* dh0, void* scratch, int B,
                                     int T, int d, int len, void* stream) {
  using namespace repro_torch;
  if (B == 0 || T == 0 || d == 0) return 0;
  if (len <= 0) return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  const bool vec4 = d % 4 == 0 && aligned16(log_a) && aligned16(h) &&
                    aligned16(h0) && aligned16(dy) && aligned16(dla) &&
                    aligned16(db) && aligned16(dh0) && aligned16(scratch);
  return (vec4 ? &launch_bwd<4> : &launch_bwd<1>)(
      f(log_a), f(h), f(h0), f(dy), m(dla), m(db), m(dh0), m(scratch), B, T,
      d, len, static_cast<cudaStream_t>(stream));
}
