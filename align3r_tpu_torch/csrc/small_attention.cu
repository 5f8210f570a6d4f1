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
// products on the SMs' exp units. In fp32 the same products at fp32 accuracy
// are 16.3 GFLOP of TF32 (3xTF32: 33 us at 494.7 TFLOP/s). The (Nq, Nk)
// logits never reach device memory.
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
//   fp32: the fp32 operand policy of the same core
//     (sm90_attention_tf32.cuh): every product as three TF32 wgmma products
//     of split operands (3xTF32, about 2^-21 relative), one online-softmax
//     pass (in fp32 the rounding of P is the identity, so the exact-max pass
//     is not needed), a pre-pass that splits K and writes V^T split, 32-key
//     stages, 2 blocks per SM at D <= 64. The TPU kernel's fp32 path is off
//     the training recipe's bf16 main path.
#include "common.cuh"
#include "sm90_attention.cuh"
#include "sm90_attention_tf32.cuh"

namespace a3r {

constexpr int SK = 64;   // keys per bf16 tile

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

__global__ void __launch_bounds__(256)
small_attention_tf32_split(const float* __restrict__ k, const float* __restrict__ v,
                           float* __restrict__ kh, float* __restrict__ kl,
                           float* __restrict__ vth, float* __restrict__ vtl, int Nk, int Nkp,
                           int D) {
  sm90::tf32_split_kv<>(k, v, kh, kl, vth, vtl, Nk, Nkp, D);
}

// the fp32 operand policy (3xTF32) at padded head dim DP; MINB blocks per SM
template <int DP, int MINB>
__global__ void __launch_bounds__(sm90::THREADS, MINB)
small_attention_tf32(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tkh,
                     const __grid_constant__ CUtensorMap tkl,
                     const __grid_constant__ CUtensorMap tvh,
                     const __grid_constant__ CUtensorMap tvl, float* __restrict__ o,
                     float* __restrict__ lse, int Nq, int Nk, int D, float scale_log2) {
  sm90::attention_fwd_tf32<DP, sm90::F32_BK, sm90::STAGES>(tq, tkh, tkl, tvh, tvl, o, lse, Nq,
                                                           Nk, D, scale_log2);
}

// blocks per SM: 4 at DP = 32 (49 KB of shared memory each), 2 at 64 (97 KB),
// 1 at 128 (193 KB)
template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, void* scratch,
                       int BH, int Nq, int Nk, int D, float scale, cudaStream_t s) {
  constexpr int MINB = DP == 32 ? 4 : DP == 64 ? 2 : 1;
  return sm90::launch_f32<DP, sm90::F32_BK, sm90::STAGES, small_attention_tf32_split,
                          small_attention_tf32<DP, MINB>>(q, k, v, o, nullptr, scratch, BH, Nq,
                                                          Nk, D, scale, s);
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

// q (BH, Nq, D), k and v (BH, Nk, D), o like q, in one dtype (bf16 or fp32),
// contiguous and 16-byte aligned. fp32 takes scratch of 2 BH D (Nk + Nkp)
// floats, Nkp = 8 ceil(Nk / 8) (K and V^T split to TF32 hi and lo); bf16
// none.

A3R_EXPORT int a3r_small_attention(const void* q, const void* k, const void* v,
                                   void* o, void* scratch, int BH, int Nq, int Nk, int D,
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
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (D <= 32) return (int)launch_f32<32>(q, k, v, o, scratch, BH, Nq, Nk, D, scale, s);
  if (D <= 64) return (int)launch_f32<64>(q, k, v, o, scratch, BH, Nq, Nk, D, scale, s);
  return (int)launch_f32<128>(q, k, v, o, scratch, BH, Nq, Nk, D, scale, s);
}
