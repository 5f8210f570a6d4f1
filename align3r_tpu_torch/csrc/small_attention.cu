// K6: softmax attention for short sequences, for Hopper.
//
// Replaces align3r_tpu/ops/small_attention.py: _call (:69-94) ->
// _kernel_unrolled (:47-65) / _kernel (:31-44). For q (BH, Nq, D) and k, v
// (BH, Nk, D), any Nq, Nk >= 1, D <= 128 with D % 8 == 0, per head:
//   logits = (q k^T) * D^-1/2 in fp32; m = exact row max over all keys;
//   p = exp(logits - m) in fp32; s = sum of the unrounded fp32 p;
//   out = (p rounded to v's dtype) v accumulated in fp32, divided by s,
//   rounded to q's dtype.
// RoPE is applied outside (as in the JAX package). The backward is not a
// kernel: ops/small_attention.py differentiates a plain twin, as the JAX
// custom VJP (_small_bwd, :167-170) does.
//
// What bounds it on the H100: at the training shapes (4, 16, 576, 64) the
// two products take 4 * 64 * 576^2 * 64 = 5.4 GFLOP against 19 MB of q, k, v
// and o, about 5.5 us at either peak (989 TFLOP/s bf16, 3.35 TB/s), so
// operations and bytes bound it about equally; the exact max costs a third
// product (q k^T again) and the 21 M exponentials take about as long as the
// products on the SMs' exp units. The (Nq, Nk) logits never reach device
// memory.
//
// Design:
//   bf16: the warpgroup-MMA core of sm90_attention.cuh (EXACT policy): one
//     block per (head, 64-query tile), a TMA-fed ring of 64-key tiles; the
//     first pass streams K alone and keeps the exact fp32 row max in
//     registers, the second streams K and V, forms p against that max in
//     registers, sums it unrounded and feeds it as bf16 to P V from
//     registers. The normalisation is applied to the output at the end, so
//     P is rounded before it, exactly as _kernel_unrolled does; an online
//     softmax would round P against a running max and differ. D is padded to
//     16, 32, 64 or 128 by the copy engine's zero fill (32-, 64- or 128-byte
//     swizzle). At the training shapes, 576 tokens are 9 query tiles: 576
//     blocks for the encoder's 64 heads, 432 for the decoder's 48. At D = 64
//     a block takes 42 KB of shared memory and, at 90 registers a thread,
//     5 fit an SM: 660 at once on 132 SMs, so either grid is one wave.
//   fp32: two passes with scalar FMA (the TPU kernel's fp32 path is off the
//     training recipe's bf16 main path), one block per (head, 32-query
//     tile), four threads per query row.
#include "common.cuh"
#include "sm90_attention.cuh"

namespace a3r {

constexpr int SK = 64;         // keys per tile
constexpr int STHREADS = 128;

// the EXACT policy of sm90_attention.cuh, at padded head dim DP
template <int DP, int MINB>
__global__ void __launch_bounds__(sm90::THREADS, MINB)
small_attention_sm90(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                     float* __restrict__ lse, int Nq, int Nk, int D, int H, int ld,
                     float scale_log2) {
  sm90::attention_fwd<DP, SK, true>(tq, tk, tv, o, lse, Nq, Nk, D, H, ld, scale_log2);
}

// ------------------------------------------------------------------- fp32

constexpr int FQ = 32;   // query rows per block, four threads each
constexpr int FMAXD = 128;

__host__ __device__ constexpr int f32_smem_bytes(int D) {
  return (FQ * (D + 1) + SK * (D + 1) + SK * D + FQ * (SK + 1)) * 4;
}

__global__ void __launch_bounds__(STHREADS)
small_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, int Nq,
                    int Nk, int D, float scale) {
  extern __shared__ __align__(16) float fsm[];
  const int LQ = D + 1;
  float* Qs = fsm;                    // FQ x (D + 1)
  float* Ks = Qs + FQ * LQ;           // SK x (D + 1)
  float* Vs = Ks + SK * LQ;           // SK x D
  float* Ps = Vs + SK * D;            // FQ x (SK + 1)
  const int tid = threadIdx.x, r = tid >> 2, g = tid & 3;
  const int bh = blockIdx.x, q0 = blockIdx.y * FQ;
  const float* qb = q + (size_t)bh * Nq * D;
  const float* kb = k + (size_t)bh * Nk * D;
  const float* vb = v + (size_t)bh * Nk * D;

  for (int i = tid; i < FQ * D; i += STHREADS) {
    const int rr = i / D, cc = i - rr * D;
    Qs[rr * LQ + cc] = q0 + rr < Nq ? qb[(size_t)(q0 + rr) * D + cc] : 0.f;
  }
  auto load_kv = [&](int k0, bool with_v) {
    for (int i = tid; i < SK * D; i += STHREADS) {
      const int rr = i / D, cc = i - rr * D;
      const bool ok = k0 + rr < Nk;
      Ks[rr * LQ + cc] = ok ? kb[(size_t)(k0 + rr) * D + cc] : 0.f;
      if (with_v) Vs[rr * D + cc] = ok ? vb[(size_t)(k0 + rr) * D + cc] : 0.f;
    }
    __syncthreads();
  };
  // logit of this thread's row against key j of the resident tile
  auto logit = [&](int j) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(Qs[r * LQ + d], Ks[j * LQ + d], s);
    return s * scale;
  };
  const int n_tiles = (Nk + SK - 1) / SK;

  float mrow = -INFINITY;
  for (int t = 0; t < n_tiles; ++t) {
    load_kv(t * SK, false);
    for (int j = g; j < SK && t * SK + j < Nk; j += 4) mrow = fmaxf(mrow, logit(j));
    __syncthreads();
  }
  mrow = fmaxf(mrow, __shfl_xor_sync(0xffffffffu, mrow, 1));
  mrow = fmaxf(mrow, __shfl_xor_sync(0xffffffffu, mrow, 2));

  float acc[FMAXD / 4];
#pragma unroll
  for (int i = 0; i < FMAXD / 4; ++i) acc[i] = 0.f;
  float lrow = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    load_kv(t * SK, true);
    for (int j = g; j < SK; j += 4) {
      const float p = t * SK + j < Nk ? expf(logit(j) - mrow) : 0.f;
      lrow += p;
      Ps[r * (SK + 1) + j] = p;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < FMAXD / 4; ++i) {
      const int c = g + 4 * i;
      if (c < D) {
        float a = acc[i];
        for (int j = 0; j < SK; ++j) a = fmaf(Ps[r * (SK + 1) + j], Vs[j * D + c], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }
  lrow += __shfl_xor_sync(0xffffffffu, lrow, 1);
  lrow += __shfl_xor_sync(0xffffffffu, lrow, 2);
  if (q0 + r < Nq) {
    float* orow = o + (size_t)bh * Nq * D + (size_t)(q0 + r) * D;
#pragma unroll
    for (int i = 0; i < FMAXD / 4; ++i) {
      const int c = g + 4 * i;
      if (c < D) orow[c] = acc[i] / lrow;
    }
  }
}

// blocks per SM: 4 up to DP = 64 (40 KB of tiles each), 2 at DP = 128
template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int BH, int Nq,
                        int Nk, int D, float scale, cudaStream_t s) {
  return sm90::launch<DP, SK, small_attention_sm90<DP, DP == 128 ? 2 : 4>>(
      q, k, v, o, nullptr, BH, Nq, Nk, D, scale, s);
}

}  // namespace a3r

using namespace a3r;

A3R_EXPORT int a3r_small_attention(const void* q, const void* k, const void* v,
                                   void* o, int BH, int Nq, int Nk, int D,
                                   int is_bf16, float scale, void* stream) {
  if (D <= 0 || D > 128 || D % 8 || Nq <= 0 || Nk <= 0 || BH <= 0 ||
      (Nq + sm90::BQ - 1) / sm90::BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    if (D <= 16) return (int)launch_bf16<16>(q, k, v, o, BH, Nq, Nk, D, scale, s);
    if (D <= 32) return (int)launch_bf16<32>(q, k, v, o, BH, Nq, Nk, D, scale, s);
    if (D <= 64) return (int)launch_bf16<64>(q, k, v, o, BH, Nq, Nk, D, scale, s);
    return (int)launch_bf16<128>(q, k, v, o, BH, Nq, Nk, D, scale, s);
  }
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(small_attention_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         f32_smem_bytes(FMAXD));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid(BH, (Nq + FQ - 1) / FQ);
  small_attention_f32<<<grid, STHREADS, f32_smem_bytes(D), s>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, Nq, Nk, D, scale);
  return (int)cudaGetLastError();
}
