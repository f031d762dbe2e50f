// flash_prefill: GQA prefill attention with an online softmax, for Hopper.
//
// Replaces the TPU kernel `flash_prefill` (src/repro/kernels/flash_prefill.py,
// `_flash_kernel`).  Same function: q (B,T,Hq,D) attends over k, v
// (B,S,Hkv,D) with causal / sliding-window / q_offset masks and keys masked
// at S; m, l and the accumulator stay in f32; p is rounded to v's dtype
// before P.V while l sums the unrounded p; the output is in q's dtype.  A
// row with no valid key returns zeros (as
// `repro.kernels.ref.flash_prefill_ref` does; the Pallas kernel returns the
// mean of V there because its NEG_INF is finite).
//
// Layout (both kernels).  One thread block per (q tile, kv head, batch).
// The tile holds the G = Hq/Hkv query heads of that kv head for
// block_q = 64/G query positions, stacked as rows (row = i*G + g), so K/V
// are read once per tile and never repeated; rows past G*block_q are
// masked (G 10 uses 60 of 64).  The TPU grid's sequential kv axis, with
// m/l/acc in VMEM scratch, becomes a loop over key tiles inside the block;
// only the key tiles that the causal and window masks leave open are
// visited, and the masks are applied only on the tiles that straddle them.
//
// What bounds it on the H100: operations.  At llama3-8b (T=1024, causal)
// the work is ~8.6 GFLOP, ~9 us at the 989 TFLOP/s bf16 tensor-core peak,
// against ~21 MB (~6 us at 3.35 TB/s).
//
// bf16 (`tc::`, every served path): QK^T and P.V on the tensor cores with
// wgmma (bf16 operands, f32 sums), one warpgroup per block, warp w owning
// rows 16w..16w+15: S = Q K^T is m64n64k16 with Q and K read from shared
// memory through matrix descriptors; O += P V is m64nDk16 with P from
// registers (the score accumulators, rounded to bf16 there; l sums them
// unrounded) and V read transposed (MN-major) from shared memory.  The
// softmax of a row stays in the 4 lanes that hold it (two shuffles).  Q, K
// and V stay bf16 in shared memory, in wgmma's 128-byte-swizzled layout
// (which also keeps the cp.async stores free of bank conflicts); 64-key
// K/V tiles are copied with cp.async into a 2-stage ring, so the copy of
// tile j+1 runs under the products of tile j (a proxy fence hands the
// generic-proxy copies to wgmma's async proxy).  Each tile's two GEMMs are
// issued and waited for in turn; overlapping one tile's softmax with the
// next tile's Q K^T (two warpgroups in ping-pong, TMA loads) is the next
// step.  Under causal masks the heaviest q tiles are launched first (the
// q-tile index is the slowest-moving part of a flat grid, reversed).
//
// f32 (`f32::`, no served path; the models' f32 parity runs): products are
// IEEE f32 FMAs on the CUDA cores (no TF32), 32-key tiles widened to f32 in
// shared memory, 256 threads: lane j holds key j of the tile and warp w the
// rows w, w+8, ...; in P.V thread (row group, d) owns column d.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8) and the dynamic shared memory of
// each instantiation; no static shared memory:
//   tc<64>   117 registers, no spills,  41,984 B
//   tc<128>  150 registers, no spills,  82,944 B (2 blocks per SM)
//   tc<256>  213 registers, no spills, 164,864 B (1 block per SM)
//   f32<64>   92 registers, no spills,  41,600 B
//   f32<128> 128 registers, no spills,  74,368 B
//   f32<256> 128 registers, 88 B of spill stores and loads, 139,904 B
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

// ---------------------------------------------------------------- f32 --
namespace f32 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;                     // G * block_q rows per tile
constexpr int kBK = 32;                       // keys per tile, one per lane
constexpr int kRowsPerWarp = kRows / kWarps;  // score rows per warp

template <int D>
constexpr size_t smem_floats() {
  return kRows * D          // Q tile
         + kBK * (D + 1)    // K tile, padded: lane j reads row j conflict-free
         + kBK * D          // V tile
         + kRows * kBK      // P tile
         + 2 * kRows;       // alpha, l
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int T_len,
                     int S, int Hq, int Hkv, int G, int block_q, int causal,
                     int window, int q_offset, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kRows * D;
  float* Vs = Ks + kBK * (D + 1);
  float* Ps = Vs + kBK * D;
  float* alpha_s = Ps + kRows * kBK;
  float* l_s = alpha_s + kRows;

  constexpr int V = vec_width<T>();
  constexpr int kRG = kThreads / D;       // row groups in the P.V stage
  constexpr int kAccRows = kRows / kRG;   // rows per thread in P.V

  const int t0 = blockIdx.x * block_q;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nt = min(block_q, T_len - t0);  // query positions in this tile
  const int rows = nt * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Q tile: for query i the G heads of kv head h are G*D contiguous values.
  const int q_chunks = G * D / V;
  for (int c = tid; c < block_q * q_chunks; c += kThreads) {
    const int i = c / q_chunks, cc = c % q_chunks;
    float* dst = Qs + i * G * D + cc * V;
    if (i < nt) {
      load_vec(q + ((size_t)(b * T_len + t0 + i) * Hq + h * G) * D + cc * V, dst);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) dst[e] = 0.f;
    }
  }

  float m_r[kRowsPerWarp], l_r[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_r[i] = -INFINITY;
    l_r[i] = 0.f;
  }
  const int d = tid % D, rg = tid / D;
  float acc[kAccRows];
#pragma unroll
  for (int i = 0; i < kAccRows; ++i) acc[i] = 0.f;

  // keys that the masks can leave open for this tile's query positions
  const int p_lo = q_offset + t0, p_hi = q_offset + t0 + nt - 1;
  const int k_end = causal ? min(S, p_hi + 1) : S;
  int k_begin = window > 0 ? max(0, p_lo - window + 1) : 0;
  k_begin = (k_begin / kBK) * kBK;

  const int k_chunks = D / V;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // previous tile's Ks/Vs/Ps reads are done
    for (int c = tid; c < kBK * k_chunks; c += kThreads) {
      const int j = c / k_chunks, cc = c % k_chunks;
      float tk[V], tv[V];
      if (k0 + j < S) {
        const size_t off = ((size_t)(b * S + k0 + j) * Hkv + h) * D + cc * V;
        load_vec(k + off, tk);
        load_vec(v + off, tv);
      } else {  // zeros, so that p = 0 never meets a NaN of stale memory
#pragma unroll
        for (int e = 0; e < V; ++e) tk[e] = tv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        Ks[j * (D + 1) + cc * V + e] = tk[e];
        Vs[j * D + cc * V + e] = tv[e];
      }
    }
    __syncthreads();

    // scores for (row, key lane), then the online-softmax update per row
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const float* krow = Ks + lane * (D + 1);
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      const float kv = krow[dd];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        s[i] = fmaf(Qs[(warp + kWarps * i) * D + dd], kv, s[i]);
    }
    const int kp = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = warp + kWarps * i;
      const int qp = q_offset + t0 + row / G;
      bool ok = kp < S && row < rows;
      if (causal) ok = ok && kp <= qp;
      if (window > 0) ok = ok && kp > qp - window;
      const float sv = ok ? s[i] * scale : -INFINITY;
      const float m_new = fmaxf(m_r[i], warp_max(sv));
      float p = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {
        p = ok ? expf(sv - m_new) : 0.f;
        alpha = expf(m_r[i] - m_new);
      }
      l_r[i] = alpha * l_r[i] + warp_sum(p);
      m_r[i] = m_new;
      Ps[row * kBK + lane] = round_to<T>(p);
      if (lane == 0) alpha_s[row] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P.V
#pragma unroll
    for (int i = 0; i < kAccRows; ++i) acc[i] *= alpha_s[rg + kRG * i];
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float vv = Vs[j * D + d];
#pragma unroll
      for (int i = 0; i < kAccRows; ++i)
        acc[i] = fmaf(Ps[(rg + kRG * i) * kBK + j], vv, acc[i]);
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) l_s[warp + kWarps * i] = l_r[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kAccRows; ++i) {
    const int row = rg + kRG * i;
    if (row < rows) {
      const int qi = row / G, g = row % G;
      const float l = l_s[row];
      const float o = l > 0.f ? acc[i] / l : 0.f;
      out[((size_t)(b * T_len + t0 + qi) * Hq + h * G + g) * D + d] = from_f32<T>(o);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int T_len, int S, int Hq, int Hkv, int causal, int window,
           int q_offset, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int block_q = kRows / G;
  static bool smem_set[kMaxDevices] = {};
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err =
      allow_dynamic_smem(flash_prefill_kernel<T, D>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_len + block_q - 1) / block_q, Hkv, B);
  flash_prefill_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), T_len, S, Hq, Hkv, G,
      block_q, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace f32


// --------------------------------------------------------------- bf16 --
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;  // one warpgroup: warp w owns rows 16w..16w+15
constexpr int kRows = 64;
constexpr int kBK = 64;        // keys per K/V tile

// d (64 x 64, f32) (+)= A (64 x 16) * B (64 x 16)^T, both K-major in shared
// memory (128-byte swizzle); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers: each warp's 16 rows
// in the m16n8k16 A-fragment layout) * B (16 x 64, MN-major in shared
// memory, 128-byte swizzle).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 in registers: each warp's 16 rows
// in the m16n8k16 A-fragment layout) * B (16 x 128, MN-major in shared
// memory, 128-byte swizzle).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 256, f32) += A (64 x 16, bf16 in registers: each warp's 16 rows
// in the m16n8k16 A-fragment layout) * B (16 x 256, MN-major in shared
// memory, 128-byte swizzle).
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// cp.async writes shared memory through the generic proxy; wgmma reads it
// through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk c of row r in a 64-row tile of D bf16 kept
// in wgmma's canonical 128-byte-swizzled layout: D/64 column blocks of
// 64 rows x 128 bytes, chunk c of row r at chunk (c ^ r) % 8 of its row.
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (uint32_t)((c >> 3) * (kRows * 128) + r * 128 + (((c ^ r) & 7) << 4));
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (in 16-byte units).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

template <int D>
constexpr size_t smem_bytes() {
  // Q, and a 2-stage ring of K and V tiles; 1 KB to align the base to the
  // swizzle's 1024-byte period
  return (size_t)5 * kRows * D * sizeof(bf16) + 1024;
}

template <int D>
__device__ __forceinline__ void pv_wgmma(float (&o)[D / 2], const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  if constexpr (D == 64) wgmma_m64n64k16_rs(o, a, desc_v);
  if constexpr (D == 128) wgmma_m64n128k16_rs(o, a, desc_v);
  if constexpr (D == 256) wgmma_m64n256k16_rs(o, a, desc_v);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ out, int B,
                        int T_len, int S, int Hq, int Hkv, int G, int block_q,
                        int n_qt, int causal, int window, int q_offset,
                        float scale_log2) {
  constexpr int CH = D / 8;      // 16-byte chunks per row
  constexpr int KS = D / 16;     // k-steps of Q.K^T
  constexpr int ND = D / 8;      // 8-wide column blocks of the output
  constexpr uint32_t kTile = kRows * D * sizeof(bf16);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* Qs = smem_raw + ((1024 - (raw & 1023)) & 1023);
  unsigned char* Ks = Qs + kTile;      // [2] tiles
  unsigned char* Vs = Ks + 2 * kTile;  // [2] tiles
  const uint32_t q_addr = static_cast<uint32_t>(__cvta_generic_to_shared(Qs));
  const uint32_t k_addr = q_addr + kTile, v_addr = q_addr + 3 * kTile;

  const int hb = Hkv * B;
  const int rank = blockIdx.x / hb;
  const int qt = causal ? n_qt - 1 - rank : rank;
  const int h = (blockIdx.x % hb) % Hkv;
  const int b = (blockIdx.x % hb) / Hkv;
  const int t0 = qt * block_q;
  const int nt = min(block_q, T_len - t0);
  const int rows = nt * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int p_lo = q_offset + t0, p_hi = p_lo + nt - 1;
  const int k_end = causal ? min(S, p_hi + 1) : S;
  int k_begin = window > 0 ? max(0, p_lo - window + 1) : 0;
  k_begin = (k_begin / kBK) * kBK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  for (int c = tid; c < kRows * CH; c += kThreads) {
    const int r = c / CH, cc = c % CH;
    const bool ok = r < rows;
    const bf16* src =
        ok ? q + ((size_t)(b * T_len + t0 + r / G) * Hq + h * G + r % G) * D + cc * 8 : q;
    cp_async16(Qs + swizzled(r, cc), src, ok);
  }
  auto load_kv = [&](int tile, int stage) {
    const int k0 = k_begin + tile * kBK;
    for (int c = tid; c < kBK * CH; c += kThreads) {
      const int j = c / CH, cc = c % CH;
      const bool ok = k0 + j < S;
      const size_t off = ok ? ((size_t)(b * S + k0 + j) * Hkv + h) * D + cc * 8 : 0;
      cp_async16(Ks + stage * kTile + swizzled(j, cc), k + off, ok);
      cp_async16(Vs + stage * kTile + swizzled(j, cc), v + off, ok);
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();
  if (n_tiles > 1) load_kv(1, 1);
  cp_async_commit();

  const int r0 = warp * 16 + (lane >> 2);
  const int qp0 = q_offset + t0 + r0 / G, qp1 = q_offset + t0 + (r0 + 8) / G;
  const int kc = 2 * (lane & 3);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const uint32_t ks = k_addr + (it & 1) * kTile;
    const uint32_t vs = v_addr + (it & 1) * kTile;

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t off = (kk >> 2) * (kRows * 128) + (kk & 3) * 32;
      wgmma_m64n64k16_ss(s, make_desc(q_addr + off, 16, 1024), make_desc(ks + off, 16, 1024),
                         kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s);

    const int k0 = k_begin + it * kBK;
    const bool edge = k0 + kBK > S || (causal && k0 + kBK - 1 > p_lo) ||
                      (window > 0 && k0 <= p_hi - window);
    if (edge) {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + nb * 8 + kc + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          bool ok = kp < S;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          if (!ok) s[4 * nb + e] = -INFINITY;
        }
      }
    }
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * nb], s[4 * nb + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * nb + 2], s[4 * nb + 3]));
    }
    float msc[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      msc[i] = mx[i] == -INFINITY ? 0.f : mx[i] * scale_log2;
      alpha[i] = exp2f(m_r[i] * scale_log2 - msc[i]);
      m_r[i] = mx[i];
    }
    uint32_t pa[4][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float p0 = exp2f(fmaf(s[4 * nb], scale_log2, -msc[0]));
      const float p1 = exp2f(fmaf(s[4 * nb + 1], scale_log2, -msc[0]));
      const float p2 = exp2f(fmaf(s[4 * nb + 2], scale_log2, -msc[1]));
      const float p3 = exp2f(fmaf(s[4 * nb + 3], scale_log2, -msc[1]));
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pa[nb / 2][(nb & 1) * 2] = pack_bf16(p0, p1);
      pa[nb / 2][(nb & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = alpha[i] * l_r[i] + rs[i];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[4 * nd] *= alpha[0];
      o[4 * nd + 1] *= alpha[0];
      o[4 * nd + 2] *= alpha[1];
      o[4 * nd + 3] *= alpha[1];
    }
    fence_operands(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      pv_wgmma<D>(o, pa[kk], make_desc(vs + kk * 16 * 128, kRows * 128, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(o);
    __syncthreads();  // every warp is done with this stage
    if (it + 2 < n_tiles) load_kv(it + 2, it & 1);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();

  // O / l, staged through the (now free) K ring, rows padded by 16 bytes
  constexpr int LD = D + 8;
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    inv[i] = l_r[i] > 0.f ? 1.f / l_r[i] : 0.f;
  }
  bf16* Os = reinterpret_cast<bf16*>(Ks);
  bf16* stage_row = Os + r0 * LD + kc;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    *reinterpret_cast<uint32_t*>(stage_row + nd * 8) =
        pack_bf16(o[4 * nd] * inv[0], o[4 * nd + 1] * inv[0]);
    *reinterpret_cast<uint32_t*>(stage_row + 8 * LD + nd * 8) =
        pack_bf16(o[4 * nd + 2] * inv[1], o[4 * nd + 3] * inv[1]);
  }
  __syncwarp();
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = warp * 16 + c / CH, cc = c % CH;
    if (r < rows) {
      const size_t dst = ((size_t)(b * T_len + t0 + r / G) * Hq + h * G + r % G) * D + cc * 8;
      *reinterpret_cast<uint4*>(out + dst) = *reinterpret_cast<const uint4*>(Os + r * LD + cc * 8);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int T_len,
           int S, int Hq, int Hkv, int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int block_q = kRows / G;
  const int n_qt = (T_len + block_q - 1) / block_q;
  const long long blocks = (long long)n_qt * Hkv * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  static bool smem_set[kMaxDevices] = {};
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = allow_dynamic_smem(flash_prefill_tc_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  flash_prefill_tc_kernel<D><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), B, T_len, S, Hq, Hkv, G,
      block_q, n_qt, causal, window, q_offset, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace
}  // namespace repro_torch

// Plain C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Tensors are contiguous in the JAX layouts; D is 64, 128 or 256; Hq/Hkv <= 64.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* out, int B, int T,
                                    int S, int Hq, int Hkv, int D, int causal,
                                    int window, int q_offset, float scale,
                                    int dtype, void* stream) {
  using namespace repro_torch;
  if (B == 0 || T == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > tc::kRows) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return f32::launch<float, 64>(q, k, v, out, B, T, S, Hq, Hkv, causal, window, q_offset, scale, st);
  if (dtype == 0 && D == 128)
    return f32::launch<float, 128>(q, k, v, out, B, T, S, Hq, Hkv, causal, window, q_offset, scale, st);
  if (dtype == 0 && D == 256)
    return f32::launch<float, 256>(q, k, v, out, B, T, S, Hq, Hkv, causal, window, q_offset, scale, st);
  if (dtype == 1 && D == 64)
    return tc::launch<64>(q, k, v, out, B, T, S, Hq, Hkv, causal, window, q_offset, scale, st);
  if (dtype == 1 && D == 128)
    return tc::launch<128>(q, k, v, out, B, T, S, Hq, Hkv, causal, window, q_offset, scale, st);
  if (dtype == 1 && D == 256)
    return tc::launch<256>(q, k, v, out, B, T, S, Hq, Hkv, causal, window, q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}
