// K1 (attention site) and K2 (MLP site) for Hopper, as several launches.
//
// Replaces align3r_tpu/ops/fused_site.py:
//   K1  _call (:170-221) -> _kernel (:78): [LN] -> q/k/v projection + bias ->
//       RoPE2D -> fp32 softmax(q k^T D^-1/2) with P rounded to bf16 before
//       PV -> out-projection + bias [+ residual].
//   K2  _mlp_call (:257-286) -> _mlp_kernel (:242) and _mlp_call_fblocked
//       (:321-360) -> _mlp_fblock_kernel (:289): LN -> fc1 + bias -> exact
//       GELU -> fc2 + bias -> + residual. The F-blocked form only existed to
//       fit TPU VMEM; one GEMM pair covers both here.
//
// The TPU kernel's (C, N)-transposed layout and head streaming exist for
// sublane tiling and are not carried over. Here a site is:
//   layernorm_kernel (one warp per token row, fp32 statistics, eps 1e-6)
//   gemm_sm90<EPI_BIAS_ROPE> for q and k, gemm_sm90<EPI_BIAS> for v
//   site_attention_sm90 (one warpgroup per (row, head, 64-query tile))
//   gemm_sm90<EPI_BIAS_RESID | EPI_BIAS> for the out-projection,
// and an MLP site is layernorm -> gemm_sm90<EPI_BIAS_GELU> ->
// gemm_sm90<EPI_BIAS_RESID | EPI_BIAS>.
//
// GELU uses erff (CUDA's erf, max error 2 ulp); the TPU kernel used the
// Abramowitz-Stegun polynomial (fused_site.py:224-239, |err| < 1.5e-7), so
// the two differ by at most about 1.5e-7 before rounding to bf16.
//
// What bounds it on the H100: the projections and MLP products are
// operations-bound GEMMs, about 85% of a site's FLOPs. They run on the
// Hopper GEMM core of gemm.cuh (persistent and ping-pong: a TMA-fed ring,
// wgmma with register accumulators, the epilogues in registers, TMA stores);
// what bounds that core is written there. Attention at N = 576, D = 64 is small (about 15% of a
// site's FLOPs) and runs on the EXACT policy of sm90_attention.cuh, K6's per-block code on the
// (rows, N, C) layout: two passes over TMA-fed 64-key tiles, the exact row
// max from the first, P rounded to bf16 against it in registers in the
// second, exactly as _kernel:139-145 does, at the price of computing q k^T
// twice. The heads lie side by side, so a 3-D tensor map (C, N, rows) reads
// head h's 64 columns and the epilogue writes them back at row stride C; no
// permuted copy of q, k, v or o is made.
#include "common.cuh"
#include "gemm.cuh"
#include "sm90_attention.cuh"

namespace a3r {

// ------------------------------------------------------------- layernorm

__global__ void layernorm_kernel(const bf16* __restrict__ x,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ bias,
                                 bf16* __restrict__ y, long long rows_per_g,
                                 long long rows, int C, float eps) {
  constexpr int MAXV = 32;  // C <= 1024
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int g = (int)(row / rows_per_g);
  const bf16* xr = x + row * C;
  float v[MAXV];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int c = i * 32 + lane;
    v[i] = c < C ? __bfloat162float(xr[c]) : 0.f;
    s += v[i];
  }
  const float mu = warp_sum(s) / C;
  float s2 = 0.f;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int c = i * 32 + lane;
    const float d = c < C ? v[i] - mu : 0.f;
    s2 += d * d;
  }
  const float rs = rsqrtf(warp_sum(s2) / C + eps);
  const float* sc = scale + (size_t)g * C;
  const float* bi = bias + (size_t)g * C;
  bf16* yr = y + row * C;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int c = i * 32 + lane;
    if (c < C) yr[c] = __float2bfloat16((v[i] - mu) * rs * sc[c] + bi[c]);
  }
}

// ------------------------------------------------------------- attention

constexpr int AK = 64;   // keys per tile: K6's SK, so the two give the same bits

// the EXACT policy of sm90_attention.cuh on K1's (rows, N, C) layout, one
// head per 64 columns: K6's per-block code (small_attention_sm90<64, 4>)
template <int MINB>
__global__ void __launch_bounds__(sm90::THREADS, MINB)
site_attention_sm90(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                    float* __restrict__ lse, int Nq, int Nk, int D, int H, int ld,
                    float scale_log2) {
  sm90::attention_fwd<64, AK, true>(tq, tk, tv, o, lse, Nq, Nk, D, H, ld, scale_log2);
}

}  // namespace a3r

using namespace a3r;

A3R_EXPORT int a3r_layernorm(const void* x, const void* scale, const void* bias,
                             void* y, long long rows_per_g, long long rows,
                             int C, float eps, void* stream) {
  if (C > 1024) return (int)cudaErrorInvalidValue;
  const int warps = 8;
  const long long blocks = (rows + warps - 1) / warps;
  layernorm_kernel<<<(unsigned)blocks, warps * 32, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)scale, (const float*)bias, (bf16*)y,
      rows_per_g, rows, C, eps);
  return (int)cudaGetLastError();
}

// C (G, M, N) = epilogue(A (G, M, K) @ W (G, K, N)) on gemm.cuh's core, all
// bf16, contiguous and 16-byte aligned; bias (G, N) fp32, 16-byte aligned (a
// bulk copy brings each tile's slice); resid like C (EPI_BIAS_RESID); cos,
// sin (rope_n, 64) bf16 (EPI_BIAS_ROPE, rope_d = 64). K % 64 == 0 and
// N % 128 == 0; any M >= 1.
A3R_EXPORT int a3r_gemm(const void* A, const void* W, const void* bias,
                        const void* resid, void* C, const void* cos,
                        const void* sin, int G, int M, int N, int K, int epi,
                        int rope_d, int rope_n, void* stream) {
  if (G < 1 || M < 1 || K < GBK || K % GBK || N < GBN || N % GBN || bias == nullptr ||
      (uintptr_t)bias % 16 || (long long)G * ((M + GBM - 1) / GBM) * (N / GBN) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (epi == EPI_BIAS_ROPE &&
      (rope_d != GEMM_ROPE_D || rope_n < 1 || cos == nullptr || sin == nullptr))
    return (int)cudaErrorInvalidValue;
  if (epi == EPI_BIAS_RESID && resid == nullptr) return (int)cudaErrorInvalidValue;
  const GemmArgs p{(const float*)bias, (const bf16*)resid, (const bf16*)cos,
                   (const bf16*)sin, G, M, N, K, rope_n};
  cudaStream_t s = (cudaStream_t)stream;
  switch (epi) {
    case EPI_BIAS: return (int)launch_gemm<EPI_BIAS>(A, W, C, p, s);
    case EPI_BIAS_ROPE: return (int)launch_gemm<EPI_BIAS_ROPE>(A, W, C, p, s);
    case EPI_BIAS_GELU: return (int)launch_gemm<EPI_BIAS_GELU>(A, W, C, p, s);
    case EPI_BIAS_RESID: return (int)launch_gemm<EPI_BIAS_RESID>(A, W, C, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q, k, v, o (rows, N, C) bf16, contiguous and 16-byte aligned, head h at
// columns 64 h .. 64 h + 63 (D = 64 only)
A3R_EXPORT int a3r_attention(const void* q, const void* k, const void* v,
                             void* o, int rows, int N, int C, int H,
                             float scale, void* stream) {
  if (C != H * 64 || rows <= 0 || N <= 0 || (N + sm90::BQ - 1) / sm90::BQ > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)sm90::launch<64, AK, site_attention_sm90<4>>(
      q, k, v, o, nullptr, rows * H, N, N, 64, scale, (cudaStream_t)stream, H, C);
}
