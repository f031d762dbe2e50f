// rglru_scan: the RG-LRU linear recurrence h_t = exp(log_a_t) * h_{t-1} + b_t,
// elementwise over channels, for Hopper.
//
// Replaces the TPU kernel `rglru_scan` (src/repro/kernels/rglru_scan.py,
// `_rglru_kernel`).  Same function: log_a, b (B,T,d) f32, optional h0 (B,d)
// f32 (zeros when absent); every h_t is written, in f32.
//
// Layout.  The Pallas grid (B, d_blocks, t_blocks) carries h in VMEM across
// its sequential time blocks.  Here the channel axis lies across threads, one
// thread per (channel, batch row), so the 32 lanes of a warp read 32
// neighbouring channels of one step (d is contiguous: one 128-byte load per
// warp and step), and the time axis is a loop inside the thread with h in a
// register.  The loop runs in chunks of kChunk steps: the chunk's log_a and b
// are loaded first (they do not depend on h, so the loads are all in flight
// together), then the kChunk dependent steps run out of registers.  Steps
// past T in the last chunk are identity steps (log_a = 0, b = 0) and are not
// written; channels past d have no thread.
//
// What bounds it on the H100: bytes.  Per element it reads log_a and b once
// and writes h once (12 bytes) against one exp and two flops: at B=1, T=1024,
// d=2560 that is 31.5 MB, ~9.4 us at 3.35 TB/s.  This first version has only
// B*d threads (2560 at B=1: 40 blocks of 64) walking T dependent steps each,
// so it keeps far too few loads in flight to reach that rate; a split-T pass
// (local scans per time chunk with decays formed as exp(later sum - earlier
// sum) <= 1, then a carry fix-up) is the later fix.
#include <math.h>
#include <stdint.h>

#include <cuda_runtime.h>

namespace repro_torch {
namespace {

constexpr int kThreads = 64;   // channels per block
constexpr int kChunk = 16;     // time steps loaded ahead of their use

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ log_a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ out,
                  int T, int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int bi = blockIdx.y;
  if (c >= d) return;
  const size_t base = (size_t)bi * T * d + c;
  float h = h0 != nullptr ? h0[(size_t)bi * d + c] : 0.f;
  for (int t0 = 0; t0 < T; t0 += kChunk) {
    float la[kChunk], bb[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const bool ok = t0 + i < T;
      const size_t off = base + (size_t)(t0 + i) * d;
      la[i] = ok ? __ldg(log_a + off) : 0.f;
      bb[i] = ok ? __ldg(b + off) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      // two roundings (no FMA), as the plain version's exp(la) * h + b
      h = __fmul_rn(expf(la[i]), h) + bb[i];
      if (t0 + i < T) out[base + (size_t)(t0 + i) * d] = h;
    }
  }
}

}  // namespace
}  // namespace repro_torch

// Plain C entry point, bound with ctypes.  log_a, b, out (B,T,d) and h0 (B,d)
// or null: contiguous float32 on the device.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int rglru_scan_launch(const void* log_a, const void* b,
                                 const void* h0, void* out, int B, int T,
                                 int d, void* stream) {
  using namespace repro_torch;
  if (B == 0 || T == 0 || d == 0) return 0;
  const dim3 grid((d + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(out), T, d);
  return (int)cudaGetLastError();
}
