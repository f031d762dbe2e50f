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
// block_q = R/G query positions (R = 64 rows, 128 for f32 below D 256),
// stacked as rows (row = i*G + g), so K/V are read once per tile and never
// repeated; rows past G*block_q are not written (G 10 uses 60 of 64).  The
// TPU grid's sequential kv axis, with m/l/acc in VMEM scratch, becomes a
// loop over key tiles inside the block; only the key tiles that the causal
// and window masks leave open are visited, and the masks are applied only
// on the tiles that straddle them.  Under causal masks the heaviest q tiles
// are launched first (the q-tile index is the slowest-moving part of a flat
// grid, reversed).
//
// What bounds it on the H100: operations.  At llama3-8b (T=1024, causal)
// the work is ~8.6 GFLOP, ~9 us at the 989 TFLOP/s bf16 tensor-core peak,
// against ~21 MB (~6 us at 3.35 TB/s); in f32 at the f32-accurate rate of
// the tensor cores (3xTF32, 495 / 3 TFLOP/s) ~52 us.
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
// step.  On request it writes each row's log-sum-exp, as the f32 kernel
// does (the bf16 backward reads it).  The wgmma products, fences, swizzled
// layout and descriptors are in wgmma.cuh, shared with the bf16 backward.
//
// f32 (`f32::`, no served path; the models' f32 parity runs and training,
// head_dim 64, 80, 128, 256): both products on the tensor cores as
// mma.sync m16n8k8 TF32 in the 3xTF32 split (common.cuh), which keeps ~22
// bits of each operand and so the f32 limit (one TF32 pass misses it 17-55
// times: tests/test_torch_attention_design.py).  8 warps (4 at D 256), warp
// w owning rows 16w..16w+15; Q and a 2-stage cp.async ring of 64-key K/V
// tiles (32 at D 256, where shared memory and the 128-register output
// accumulator run out) stay f32 in shared memory, rows padded to D + 4
// floats so that the lanes of each fragment load hit 32 banks; operands
// are split into big and small TF32 parts as the fragments are loaded (a
// split tile would not fit at D 256).  The softmax of a row stays in the 4
// lanes that hold it; P passes from the score accumulator to the A
// fragment of P V in registers, its key order taken as the fragment's
// column order (keys 2q, 2q+1 as columns q, q+4) and V's rows read alike.
// Each tile's P V is summed in a fresh accumulator and added to O in f32
// (round to nearest): the tensor cores' own sums truncate, and chained over
// every key tile that bias grows with S.  On request it writes each row's
// log-sum-exp m + log l (f32, (B, Hq, T); -inf for a row with no valid
// key), which flash_prefill_bwd.cu reads.  wgmma in TF32 (it wants both
// operands K-major, so V transposed in shared memory) is the next step.
//
// ptxas (-Xptxas -v, sm_90a) and the dynamic shared memory of each
// instantiation; no static shared memory:
//   tc<64>   117 registers, no spills,  41,984 B
//   tc<128>  151 registers, no spills,  82,944 B (2 blocks per SM)
//   tc<256>  213 registers, no spills, 164,864 B (1 block per SM)
//   f32<64>  182 registers, no spills, 104,448 B (1 block of 8 warps per SM)
//   f32<80>  195 registers, no spills, 129,024 B (1 block of 8 warps)
//   f32<128> 255 registers, no spills, 202,752 B (1 block of 8 warps)
//   f32<256> 255 registers, no spills, 199,680 B (1 block of 4 warps)
//
// Offsets.  Every offset into q, k, v, the outputs and the log-sum-exp is
// formed in 64 bits from the batch index on (the long_500k prefills' q is
// 524288 x 40 x 128 = 2.7e9 elements, past 2^31); positions, heads and
// tile indices stay int.  The grid is one-dimensional (up to 2^31 - 1
// blocks; the launch refuses more).
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace repro_torch {
namespace {

// ---------------------------------------------------------------- f32 --
namespace f32 {

// The block's shape at head_dim D: warps of 16 rows each, K/V tiles of kBK
// keys in a 2-stage ring, every tile's rows padded to LD floats (LD = 4 or
// 20 mod 32, so that the 32 lanes of a fragment load hit 32 banks).  At D
// 256 the ring and the Q tile fill the shared memory with 4 warps and
// 32-key tiles, and a warp's output accumulator takes 128 registers a lane.
template <int D>
struct Tile {
  static constexpr int kWarps = D > 128 ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;  // G * block_q rows
  static constexpr int kBK = D > 128 ? 32 : 64;
  static constexpr int LD = D + 4;
  static constexpr int NT = kBK / 8;    // 8-key column tiles of S
  static constexpr int ND = D / 8;      // 8-column tiles of O
  // O column tiles summed per pass over a key tile (registers)
  static constexpr int NC = ND <= 10 ? ND : (D > 128 ? 4 : 8);
  static_assert(D % 8 == 0 && ND % NC == 0 && (LD % 32 == 4 || LD % 32 == 20),
                "f32 flash_prefill: unsupported head_dim");
};

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(Tile<D>::kRows + 4 * Tile<D>::kBK) * Tile<D>::LD * sizeof(float);
}

// lse (nullable): the f32 (B, Hq, T) log-sum-exp m + log l of each row's
// scaled scores, -inf for a row with no valid key (the backward's input).
template <int D>
__global__ void __launch_bounds__(Tile<D>::kThreads, 1)
flash_prefill_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int B, int T_len, int S, int Hq,
                     int Hkv, int G, int block_q, int n_qt, int causal, int window,
                     int q_offset, float scale) {
  using Tl = Tile<D>;
  constexpr int kThreads = Tl::kThreads, kRows = Tl::kRows, BK = Tl::kBK;
  constexpr int LD = Tl::LD, NT = Tl::NT, ND = Tl::ND, NC = Tl::NC;
  constexpr int CH = D / 4;  // 16-byte chunks a row
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kRows * LD;      // [2] stages of BK rows
  float* Vs = Ks + 2 * BK * LD;     // [2] stages of BK rows

  const int hb = Hkv * B;
  const int rank = blockIdx.x / hb;
  const int qt = causal ? n_qt - 1 - rank : rank;  // heaviest causal tiles first
  const int h = (blockIdx.x % hb) % Hkv;
  const int b = (blockIdx.x % hb) / Hkv;
  const int t0 = qt * block_q;
  const int nt = min(block_q, T_len - t0);
  const int rows = nt * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q4 = lane & 3;

  // keys that the masks can leave open for this tile's query positions
  const int p_lo = q_offset + t0, p_hi = p_lo + nt - 1;
  const int k_end = causal ? min(S, p_hi + 1) : S;
  int k_begin = window > 0 ? max(0, p_lo - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  // Q rows (row r: position t0 + r / G, head h * G + r % G), zeros past
  // `rows`; K/V rows zero past S, so that p = 0 never meets stale memory
  for (int c = tid; c < kRows * CH; c += kThreads) {
    const int r = c / CH, cc = c % CH;
    const bool ok = r < rows;
    const float* src =
        ok ? q + (((size_t)b * T_len + t0 + r / G) * Hq + h * G + r % G) * D + cc * 4 : q;
    cp_async16(Qs + r * LD + cc * 4, src, ok);
  }
  auto load_kv = [&](int tile, int stage) {
    const int k0 = k_begin + tile * BK;
    for (int c = tid; c < BK * CH; c += kThreads) {
      const int j = c / CH, cc = c % CH;
      const bool ok = k0 + j < S;
      const size_t off = ok ? (((size_t)b * S + k0 + j) * Hkv + h) * D + cc * 4 : 0;
      cp_async16(Ks + (stage * BK + j) * LD + cc * 4, k + off, ok);
      cp_async16(Vs + (stage * BK + j) * LD + cc * 4, v + off, ok);
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();
  if (n_tiles > 1) load_kv(1, 1);
  cp_async_commit();

  // this lane's rows r0 and r0 + 8 of the warp's 16
  const int r0 = warp * 16 + g;
  const int qp0 = q_offset + t0 + r0 / G, qp1 = q_offset + t0 + (r0 + 8) / G;
  const float* qa = Qs + r0 * LD + q4;
  const float scale_log2 = scale * 1.4426950408889634f;
  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<1>();
    __syncthreads();
    const float* ks = Ks + (it & 1) * BK * LD;
    const float* vs = Vs + (it & 1) * BK * LD;

    // S = Q K^T: A = Q rows, B = K rows read as columns
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D / 8; ++kk) {
      const float* qk = qa + 8 * kk;
      const FragA a = frag_a(qk[0], qk[8 * LD], qk[4], qk[8 * LD + 4]);
      FragB bf[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* kr = ks + (8 * j + g) * LD + 8 * kk + q4;
        bf[j] = frag_b(kr[0], kr[4]);
      }
      mma3(s, a, bf);
    }

    // masks, only on the tiles that straddle them
    const int k0 = k_begin + it * BK;
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > p_lo) ||
                      (window > 0 && k0 <= p_hi - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + 2 * q4 + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          bool ok = kp < S;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          if (!ok) s[j][e] = -INFINITY;
        }
      }
    }
    // online softmax: a row's 4 lanes hold its scores
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
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
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = exp2f(fmaf(s[j][e], scale_log2, -msc[e >> 1]));
      rs[0] += s[j][0] + s[j][1];
      rs[1] += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = alpha[i] * l_r[i] + rs[i];

    // O = alpha O + P V.  The accumulator holds keys 2q, 2q+1 of each 8-key
    // tile where an A fragment wants q, q+4: so k-step kk takes key 8kk + 2q
    // as its column q and 8kk + 2q + 1 as q + 4, and V's rows in that
    // order.  Each tile's product is summed in a fresh accumulator and
    // added in f32 (round to nearest): the tensor cores' own sums truncate,
    // and chained over every key tile that bias would grow with S.
    FragA pa[NT];
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) pa[kk] = frag_a(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
#pragma unroll
    for (int n0 = 0; n0 < ND; n0 += NC) {
      float t[NC][4];
#pragma unroll
      for (int n = 0; n < NC; ++n) t[n][0] = t[n][1] = t[n][2] = t[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        const float* va = vs + (8 * kk + 2 * q4) * LD + 8 * n0 + g;
        FragB bf[NC];
#pragma unroll
        for (int n = 0; n < NC; ++n) bf[n] = frag_b(va[8 * n], va[LD + 8 * n]);
        mma3(t, pa[kk], bf);
      }
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[n0 + n][e] = fmaf(o[n0 + n][e], alpha[e >> 1], t[n][e]);
    }
    __syncthreads();  // every warp is done with this stage
    if (it + 2 < n_tiles) load_kv(it + 2, it & 1);
    cp_async_commit();
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    inv[i] = l_r[i] > 0.f ? 1.f / l_r[i] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= rows) continue;
    const int qi = r / G, gi = r % G;
    float* dst = out + (((size_t)b * T_len + t0 + qi) * Hq + h * G + gi) * D + 2 * q4;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(o[n][2 * i] * inv[i], o[n][2 * i + 1] * inv[i]);
    if (lse != nullptr && q4 == 0)
      lse[((size_t)b * Hq + h * G + gi) * T_len + t0 + qi] =
          l_r[i] > 0.f ? m_r[i] * scale + logf(l_r[i]) : -INFINITY;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int T_len, int S, int Hq, int Hkv, int causal, int window,
           int q_offset, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int block_q = Tile<D>::kRows / G;
  const int n_qt = (T_len + block_q - 1) / block_q;
  const long long blocks = (long long)n_qt * Hkv * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  static bool smem_set[kMaxDevices] = {};
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = allow_dynamic_smem(flash_prefill_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  flash_prefill_kernel<D><<<(unsigned)blocks, Tile<D>::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, B, T_len, S, Hq,
      Hkv, G, block_q, n_qt, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace f32


// --------------------------------------------------------------- bf16 --
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;  // one warpgroup: warp w owns rows 16w..16w+15
constexpr int kRows = 64;
constexpr int kBK = 64;        // keys per K/V tile

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

// lse (nullable): as the f32 kernel's, the f32 (B, Hq, T) natural-log
// log-sum-exp m * scale + log l of each row's scaled scores (the softmax
// runs in base 2; m and l are in registers at the end), -inf for a row
// with no valid key.  out32 (nullable): the output in f32 as well, before
// its rounding to bf16, for the backward's delta = rowsum(dO * O): from
// the bf16 output delta is off by ~2^-9 |dO| |O|, which in a row with a
// few keys is a large share of dP - delta.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ out,
                        float* __restrict__ lse, float* __restrict__ out32, int B, int T_len,
                        int S, int Hq, int Hkv,
                        int G, int block_q, int n_qt, int causal, int window, int q_offset,
                        float scale, float scale_log2) {
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
        ok ? q + (((size_t)b * T_len + t0 + r / G) * Hq + h * G + r % G) * D + cc * 8 : q;
    cp_async16(Qs + swizzled(r, cc), src, ok);
  }
  auto load_kv = [&](int tile, int stage) {
    const int k0 = k_begin + tile * kBK;
    for (int c = tid; c < kBK * CH; c += kThreads) {
      const int j = c / CH, cc = c % CH;
      const bool ok = k0 + j < S;
      const size_t off = ok ? (((size_t)b * S + k0 + j) * Hkv + h) * D + cc * 8 : 0;
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
  if (lse != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r < rows)
        lse[((size_t)b * Hq + h * G + r % G) * T_len + t0 + r / G] =
            l_r[i] > 0.f ? m_r[i] * scale + logf(l_r[i]) : -INFINITY;
    }
  }
  if (out32 != nullptr) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r < rows) {
        float* dst = out32 + (((size_t)b * T_len + t0 + r / G) * Hq + h * G + r % G) * D + kc;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd)
          *reinterpret_cast<float2*>(dst + nd * 8) =
              make_float2(o[4 * nd + 2 * i] * inv[i], o[4 * nd + 2 * i + 1] * inv[i]);
      }
    }
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
      const size_t dst = (((size_t)b * T_len + t0 + r / G) * Hq + h * G + r % G) * D + cc * 8;
      *reinterpret_cast<uint4*>(out + dst) = *reinterpret_cast<const uint4*>(Os + r * LD + cc * 8);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, float* out32,
           int B, int T_len, int S, int Hq, int Hkv, int causal, int window, int q_offset,
           float scale, cudaStream_t stream) {
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
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, out32, B, T_len, S, Hq, Hkv, G,
      block_q, n_qt, causal, window, q_offset, scale, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace
}  // namespace repro_torch

// Plain C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Tensors are contiguous in the JAX layouts; D is 64, 80 (f32 only), 128 or
// 256; Hq/Hkv <= 64.  lse: null, or the (B, Hq, T) f32 row log-sum-exp
// written beside the output (either dtype).  out32: null, or (bf16 only)
// the output in f32 before its rounding, written beside it.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    void* out32, int B, int T, int S, int Hq, int Hkv,
                                    int D, int causal, int window,
                                    int q_offset, float scale, int dtype,
                                    void* stream) {
  using namespace repro_torch;
  if (B == 0 || T == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > tc::kRows) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* o32 = static_cast<float*>(out32);
  if (dtype == 0 && o32 != nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 64)
    return f32::launch<64>(q, k, v, out, l, B, T, S, Hq, Hkv, causal, window, q_offset, scale, st);
  if (dtype == 0 && D == 80)
    return f32::launch<80>(q, k, v, out, l, B, T, S, Hq, Hkv, causal, window, q_offset, scale, st);
  if (dtype == 0 && D == 128)
    return f32::launch<128>(q, k, v, out, l, B, T, S, Hq, Hkv, causal, window, q_offset, scale, st);
  if (dtype == 0 && D == 256)
    return f32::launch<256>(q, k, v, out, l, B, T, S, Hq, Hkv, causal, window, q_offset, scale, st);
  if (dtype == 1 && D == 64)
    return tc::launch<64>(q, k, v, out, l, o32, B, T, S, Hq, Hkv, causal, window, q_offset, scale,
                           st);
  if (dtype == 1 && D == 128)
    return tc::launch<128>(q, k, v, out, l, o32, B, T, S, Hq, Hkv, causal, window, q_offset, scale,
                           st);
  if (dtype == 1 && D == 256)
    return tc::launch<256>(q, k, v, out, l, o32, B, T, S, Hq, Hkv, causal, window, q_offset, scale,
                           st);
  return (int)cudaErrorInvalidValue;
}
