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
//   layernorm_kernel (a persistent grid, one warp per token row at a time,
//     16-byte loads and stores, fp32 statistics, eps 1e-6; bytes-bound)
//   gemm_sm90<EPI_BIAS_ROPE> for q and k, gemm_sm90<EPI_BIAS> for v
//   site_attention_sm90 (one warpgroup per (row, head, 64-query tile))
//   gemm_sm90<EPI_BIAS_RESID | EPI_BIAS> for the out-projection,
// and an MLP site is layernorm -> gemm_sm90<EPI_BIAS_GELU> ->
// gemm_sm90<EPI_BIAS_RESID | EPI_BIAS>.
//
// Tensor parallelism (replaces no TPU kernel: JAX's tp path partitions XLA's
// einsums instead, align3r_tpu/inference/engine.py:210-261): on a rank of a
// model group of m, a site runs the same launches on its H / m heads or F / m
// hidden units (q/k/v and fc1 N = C / m or F / m wide, a 64-wide last tile
// where that is an odd multiple of 64), ends in gemm_sm90<EPI_PARTIAL> (the
// fp32 product of depth C / m or F / m, no bias), and after the all-reduce
// over the group, finish_kernel writes bf16(resid + bf16(sum + bias)) or
// bf16(sum + bias): EPI_BIAS_RESID's and EPI_BIAS's function up to the order
// of the fp32 sums. It is bytes-bound (12 bytes an element with the
// residual) and moves 16 bytes a thread-load.
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

constexpr int LN_THREADS = 256;

// bf16 x8 <-> fp32
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// y = (x - mean) rsqrt(var + eps) scale + bias per row of C, the statistics
// in fp32 (the mean, then the mean of the centred squares), one rounding to
// bf16; row r takes stream r / rows_per_g's scale and bias. A persistent
// grid: each warp walks rows warp, warp + warps, ..., its lanes holding 16
// bytes (8 channels) of each of NV blocks of 256 channels (lane l: channels
// 256 i + 8 l..), with the next row's loads in flight during this row's
// reductions, and the scale and bias of its channels in registers until
// the stream changes.
template <int NV>
__global__ void __launch_bounds__(LN_THREADS)
layernorm_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, bf16* __restrict__ y, long long rows_per_g,
                 long long rows, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (LN_THREADS / 32);
  long long row = (long long)blockIdx.x * (LN_THREADS / 32) + (threadIdx.x >> 5);
  bool on[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) on[i] = 256 * i + 8 * lane < C;
  const auto load = [&](long long r, uint4 (&v)[NV]) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
      v[i] = on[i] && r < rows
                 ? *reinterpret_cast<const uint4*>(x + r * C + 256 * i + 8 * lane)
                 : make_uint4(0u, 0u, 0u, 0u);
  };
  uint4 cur[NV], nxt[NV];
  float sc[NV][8], bi[NV][8];
  long long g = -1;
  load(row, cur);
  for (; row < rows; row += warps) {
    load(row + warps, nxt);
    if (row / rows_per_g != g) {
      g = row / rows_per_g;
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int k = 0; k < 8; k += 4) {
          const size_t at = (size_t)g * C + 256 * i + 8 * lane + k;
          const float4 s = on[i] ? *reinterpret_cast<const float4*>(scale + at)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
          const float4 b = on[i] ? *reinterpret_cast<const float4*>(bias + at)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
          sc[i][k] = s.x, sc[i][k + 1] = s.y, sc[i][k + 2] = s.z, sc[i][k + 3] = s.w;
          bi[i][k] = b.x, bi[i][k + 1] = b.y, bi[i][k + 2] = b.z, bi[i][k + 3] = b.w;
        }
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float v[8];
      unpack8(cur[i], v);
#pragma unroll
      for (int k = 0; k < 8; ++k) s += v[k];
    }
    const float mu = warp_sum(s) / C;
    float s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float v[8];
      unpack8(cur[i], v);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float d = on[i] ? v[k] - mu : 0.f;
        s2 += d * d;
      }
    }
    const float rs = rsqrtf(warp_sum(s2) / C + eps);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (!on[i]) continue;
      float v[8];
      unpack8(cur[i], v);
      uint32_t o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        o[k] = sm90::pack_bf16((v[2 * k] - mu) * rs * sc[i][2 * k] + bi[i][2 * k],
                               (v[2 * k + 1] - mu) * rs * sc[i][2 * k + 1] + bi[i][2 * k + 1]);
      *reinterpret_cast<uint4*>(y + row * C + 256 * i + 8 * lane) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) cur[i] = nxt[i];
  }
}

// blocks of one instance that fill the card: the blocks an SM holds x SMs
template <int NV>
int layernorm_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, layernorm_kernel<NV>,
                                                      LN_THREADS, 0) != cudaSuccess)
      return 0;
    blocks = per_sm * sm_count();
  }
  return blocks;
}

template <int NV>
cudaError_t launch_layernorm(const bf16* x, const float* scale, const float* bias, bf16* y,
                             long long rows_per_g, long long rows, int C, float eps,
                             cudaStream_t s) {
  const long long fill = layernorm_blocks<NV>();
  if (fill <= 0) return cudaErrorInvalidDevice;
  const long long need = (rows + LN_THREADS / 32 - 1) / (LN_THREADS / 32);
  layernorm_kernel<NV><<<(unsigned)(need < fill ? need : fill), LN_THREADS, 0, s>>>(
      x, scale, bias, y, rows_per_g, rows, C, eps);
  return cudaGetLastError();
}

// ------------------------------------------------------------- finishing

constexpr int FIN_THREADS = 256;

// y = bf16(resid + bf16(s + bias)), or bf16(s + bias) without resid, on
// (rows, N), row r taking stream r / rows_per_g's bias; 8 elements a thread
// and step (two 16-byte fp32 loads, one 16-byte bf16 load and store).
__global__ void __launch_bounds__(FIN_THREADS)
finish_kernel(const float* __restrict__ s, const float* __restrict__ bias,
              const bf16* __restrict__ resid, bf16* __restrict__ y, long long rows_per_g,
              long long n8, int N) {
  for (long long i = (long long)blockIdx.x * FIN_THREADS + threadIdx.x; i < n8;
       i += (long long)gridDim.x * FIN_THREADS) {
    const long long e = 8 * i, row = e / N;
    const int col = (int)(e - row * N);
    const float* b = bias + (row / rows_per_g) * N + col;
    const float4 s0 = *reinterpret_cast<const float4*>(s + e);
    const float4 s1 = *reinterpret_cast<const float4*>(s + e + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(b);
    const float4 b1 = *reinterpret_cast<const float4*>(b + 4);
    float t[8] = {s0.x + b0.x, s0.y + b0.y, s0.z + b0.z, s0.w + b0.w,
                  s1.x + b1.x, s1.y + b1.y, s1.z + b1.z, s1.w + b1.w};
    if (resid != nullptr) {
      float r[8];
      unpack8(*reinterpret_cast<const uint4*>(resid + e), r);
#pragma unroll
      for (int k = 0; k < 8; ++k) t[k] = r[k] + bf16r(t[k]);
    }
    *reinterpret_cast<uint4*>(y + e) =
        make_uint4(sm90::pack_bf16(t[0], t[1]), sm90::pack_bf16(t[2], t[3]),
                   sm90::pack_bf16(t[4], t[5]), sm90::pack_bf16(t[6], t[7]));
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

// x, y (rows, C) bf16, scale and bias (rows / rows_per_g, C) fp32, all
// contiguous and 16-byte aligned; C % 8 == 0, C <= 1024
A3R_EXPORT int a3r_layernorm(const void* x, const void* scale, const void* bias,
                             void* y, long long rows_per_g, long long rows,
                             int C, float eps, void* stream) {
  if (C < 8 || C > 1024 || C % 8 || rows < 1 || rows_per_g < 1 ||
      ((uintptr_t)x | (uintptr_t)scale | (uintptr_t)bias | (uintptr_t)y) % 16)
    return (int)cudaErrorInvalidValue;
  const auto xx = (const bf16*)x;
  const auto sc = (const float*)scale, bi = (const float*)bias;
  const auto yy = (bf16*)y;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((C + 255) / 256) {
    case 1: return (int)launch_layernorm<1>(xx, sc, bi, yy, rows_per_g, rows, C, eps, s);
    case 2: return (int)launch_layernorm<2>(xx, sc, bi, yy, rows_per_g, rows, C, eps, s);
    case 3: return (int)launch_layernorm<3>(xx, sc, bi, yy, rows_per_g, rows, C, eps, s);
    default: return (int)launch_layernorm<4>(xx, sc, bi, yy, rows_per_g, rows, C, eps, s);
  }
}

// C (G, M, N) = epilogue(A (G, M, K) @ W (G, K, N)) on gemm.cuh's core, all
// bf16, contiguous and 16-byte aligned; bias (G, N) fp32, 16-byte aligned (a
// bulk copy brings each tile's slice); resid like C (EPI_BIAS_RESID); cos,
// sin (rope_n, 64) bf16 (EPI_BIAS_ROPE, rope_d = 64). EPI_PARTIAL: C fp32,
// no bias (may be null). K % 64 == 0; N % 64 == 0 for EPI_BIAS, EPI_BIAS_ROPE
// and EPI_PARTIAL (their TAIL instances), N % 128 == 0 for the others; any
// M >= 1.
A3R_EXPORT int a3r_gemm(const void* A, const void* W, const void* bias,
                        const void* resid, void* C, const void* cos,
                        const void* sin, int G, int M, int N, int K, int epi,
                        int rope_d, int rope_n, void* stream) {
  const bool tail = N % GBN != 0;
  if (G < 1 || M < 1 || K < GBK || K % GBK || N < GBN_TAIL || N % GBN_TAIL ||
      (tail && epi != EPI_BIAS && epi != EPI_BIAS_ROPE && epi != EPI_PARTIAL) ||
      (epi != EPI_PARTIAL && bias == nullptr) || (uintptr_t)bias % 16 ||
      (long long)G * ((M + GBM - 1) / GBM) * ((N + GBN - 1) / GBN) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (epi == EPI_BIAS_ROPE &&
      (rope_d != GEMM_ROPE_D || rope_n < 1 || cos == nullptr || sin == nullptr))
    return (int)cudaErrorInvalidValue;
  if (epi == EPI_BIAS_RESID && resid == nullptr) return (int)cudaErrorInvalidValue;
  const GemmArgs p{(const float*)bias, (const bf16*)resid, (const bf16*)cos,
                   (const bf16*)sin, epi == EPI_PARTIAL ? (float*)C : nullptr, G, M, N, K,
                   rope_n};
  cudaStream_t s = (cudaStream_t)stream;
  switch (epi) {
    case EPI_BIAS:
      return (int)(tail ? launch_gemm<EPI_BIAS, true>(A, W, C, p, s)
                        : launch_gemm<EPI_BIAS, false>(A, W, C, p, s));
    case EPI_BIAS_ROPE:
      return (int)(tail ? launch_gemm<EPI_BIAS_ROPE, true>(A, W, C, p, s)
                        : launch_gemm<EPI_BIAS_ROPE, false>(A, W, C, p, s));
    case EPI_BIAS_GELU: return (int)launch_gemm<EPI_BIAS_GELU, false>(A, W, C, p, s);
    case EPI_BIAS_RESID: return (int)launch_gemm<EPI_BIAS_RESID, false>(A, W, C, p, s);
    case EPI_PARTIAL: return (int)launch_gemm<EPI_PARTIAL, true>(A, W, C, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// y (rows, N) bf16 = bf16(resid + bf16(s + bias)), or bf16(s + bias) with
// resid null; s (rows, N) fp32, bias (rows / rows_per_g, N) fp32, resid like
// y; all contiguous and 16-byte aligned, N % 8 == 0
A3R_EXPORT int a3r_finish(const void* s, const void* bias, const void* resid, void* y,
                          long long rows_per_g, long long rows, int N, void* stream) {
  if (N < 8 || N % 8 || rows < 1 || rows_per_g < 1 || s == nullptr || bias == nullptr ||
      ((uintptr_t)s | (uintptr_t)bias | (uintptr_t)resid | (uintptr_t)y) % 16)
    return (int)cudaErrorInvalidValue;
  const long long n8 = rows * N / 8, need = (n8 + FIN_THREADS - 1) / FIN_THREADS;
  const long long fill = 8LL * sm_count();
  if (fill <= 0) return (int)cudaErrorInvalidDevice;
  finish_kernel<<<(unsigned)(need < fill ? need : fill), FIN_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)s, (const float*)bias, (const bf16*)resid, (bf16*)y, rows_per_g, n8, N);
  return (int)cudaGetLastError();
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
