// K6: softmax attention for short sequences, for Hopper.
//
// Replaces align3r_tpu/ops/small_attention.py: _call (:69-94) ->
// _kernel_unrolled (:47-65) / _kernel (:31-44). For q (BH, Nq, D) and k, v
// (BH, Nk, D), per head:
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
// operations and bytes bound it about equally. The (Nq, Nk) logits never
// reach device memory: they live in shared memory one 64 x 64 tile at a time.
//
// Design (a simple, exact kernel first):
//   bf16: one block of 4 warps per (head, 64-query tile). Pass 1 streams the
//     key tiles and keeps the exact fp32 row max; pass 2 streams them again,
//     forms p against that max, sums it in fp32, rounds it to bf16 and
//     accumulates P V with WMMA (mma.sync) in fp32. The normalisation is
//     applied to the (64, D) output at the end, so P is rounded before it,
//     exactly as _kernel_unrolled does. q k^T is computed twice; an online
//     softmax would round P against a running max and differ. D is padded
//     to 16, 32, 64 or 128 in shared memory with zeros.
//   fp32: the same two passes with scalar FMA (the TPU kernel's fp32 path is
//     off the training recipe's bf16 main path), one block per (head,
//     32-query tile), four threads per query row.
#include "common.cuh"

#include <mma.h>

namespace a3r {

constexpr int SQ = 64;         // bf16: query rows per block (4 warps x 16)
constexpr int SK = 64;         // keys per tile
constexpr int STHREADS = 128;

template <int DP>
struct SmallSmem {
  static constexpr int LDT = DP + 8;                        // bf16 Q/K/V row stride
  static constexpr int LDS = (SK > DP ? SK : DP) + 4;       // fp32 S / O row stride
  static constexpr int LDP = SK + 8;                        // bf16 P row stride
  static constexpr int Q = 0;
  static constexpr int K = Q + SQ * LDT * 2;
  static constexpr int V = K + SK * LDT * 2;
  static constexpr int S = V + SK * LDT * 2;
  static constexpr int P = S + 4 * 16 * LDS * 4;
  static constexpr int L = P + 4 * 16 * LDP * 2;
  static constexpr int BYTES = L + 4 * 16 * 4;
};

template <int DP>
__global__ void __launch_bounds__(STHREADS)
small_attention_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int Nq,
                     int Nk, int D, float scale) {
  using namespace nvcuda;
  using L = SmallSmem<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::V);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* Sw = reinterpret_cast<float*>(smem + L::S) + warp * 16 * L::LDS;
  bf16* Pw = reinterpret_cast<bf16*>(smem + L::P) + warp * 16 * L::LDP;
  float* Lw = reinterpret_cast<float*>(smem + L::L) + warp * 16;

  const int bh = blockIdx.x, q0 = blockIdx.y * SQ;
  const bf16* qb = q + (size_t)bh * Nq * D;
  const bf16* kb = k + (size_t)bh * Nk * D;
  const bf16* vb = v + (size_t)bh * Nk * D;
  constexpr int CH = DP / 8;  // 16-byte chunks per padded row

  // rows past the end and the padded columns D..DP-1 are zero-filled
  for (int c = tid; c < SQ * CH; c += STHREADS) {
    const int r = c / CH, dc = (c % CH) * 8, g = q0 + r;
    const bool ok = g < Nq && dc < D;
    cp_async16(Qs + r * L::LDT + dc, ok ? qb + (size_t)g * D + dc : qb, ok ? 16 : 0);
  }
  auto load_kv = [&](int k0, bool with_v) {
    for (int c = tid; c < SK * CH; c += STHREADS) {
      const int r = c / CH, dc = (c % CH) * 8, g = k0 + r;
      const bool ok = g < Nk && dc < D;
      const size_t off = ok ? (size_t)g * D + dc : 0;
      cp_async16(Ks + r * L::LDT + dc, kb + off, ok ? 16 : 0);
      if (with_v) cp_async16(Vs + r * L::LDT + dc, vb + off, ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  };
  // S (16 x 64) = this warp's 16 query rows against the resident key tile
  auto scores = [&]() {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> s[SK / 16];
#pragma unroll
    for (int j = 0; j < SK / 16; ++j) wmma::fill_fragment(s[j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Qs + warp * 16 * L::LDT + kk, L::LDT);
#pragma unroll
      for (int j = 0; j < SK / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, Ks + j * 16 * L::LDT + kk, L::LDT);
        wmma::mma_sync(s[j], a, b, s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < SK / 16; ++j)
      wmma::store_matrix_sync(Sw + j * 16, s[j], L::LDS, wmma::mem_row_major);
    __syncwarp();
  };

  // each lane owns row r = lane / 2 of the warp's 16 rows, 32 of the columns
  const int r = lane >> 1, c0 = (lane & 1) * 32;
  const int n_tiles = (Nk + SK - 1) / SK;

  // pass 1: exact row max of the scaled fp32 logits
  float mrow = -INFINITY;
  for (int t = 0; t < n_tiles; ++t) {
    load_kv(t * SK, false);
    scores();
    const int lim = Nk - t * SK - c0;
    for (int c = 0; c < 32 && c < lim; ++c)
      mrow = fmaxf(mrow, Sw[r * L::LDS + c0 + c] * scale);
    __syncthreads();
  }
  mrow = fmaxf(mrow, __shfl_xor_sync(0xffffffffu, mrow, 1));

  // pass 2: p = exp(logit - max) in fp32, summed unrounded; rounded to bf16
  // for P V
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[DP / 16];
#pragma unroll
  for (int j = 0; j < DP / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
  float lrow = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    load_kv(t * SK, true);
    scores();
    const int lim = Nk - t * SK - c0;
    for (int c = 0; c < 32; ++c) {
      const float pv = c < lim ? expf(Sw[r * L::LDS + c0 + c] * scale - mrow) : 0.f;
      lrow += pv;
      Pw[r * L::LDP + c0 + c] = __float2bfloat16(pv);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < SK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Pw + kk, L::LDP);
#pragma unroll
      for (int j = 0; j < DP / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, Vs + kk * L::LDT + j * 16, L::LDT);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();
  }
  lrow += __shfl_xor_sync(0xffffffffu, lrow, 1);
  if ((lane & 1) == 0) Lw[r] = lrow;
#pragma unroll
  for (int j = 0; j < DP / 16; ++j)
    wmma::store_matrix_sync(Sw + j * 16, acc[j], L::LDS, wmma::mem_row_major);
  __syncwarp();
  // the warp's 16 output rows are 16 * D contiguous values
  const int row0 = q0 + warp * 16;
  const int rows = Nq - row0 < 16 ? Nq - row0 : 16;
  bf16* ob = o + (size_t)bh * Nq * D + (size_t)row0 * D;
  for (int i = lane; i < rows * D; i += 32) {
    const int rr = i / D, cc = i - rr * D;
    ob[i] = __float2bfloat16(Sw[rr * L::LDS + cc] / Lw[rr]);
  }
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

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int BH, int Nq, int Nk, int D, float scale,
                        cudaStream_t s) {
  using L = SmallSmem<DP>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(small_attention_bf16<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::BYTES);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid(BH, (Nq + SQ - 1) / SQ);
  small_attention_bf16<DP><<<grid, STHREADS, L::BYTES, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, Nq, Nk, D, scale);
  return cudaGetLastError();
}

}  // namespace a3r

using namespace a3r;

A3R_EXPORT int a3r_small_attention(const void* q, const void* k, const void* v,
                                   void* o, int BH, int Nq, int Nk, int D,
                                   int is_bf16, float scale, void* stream) {
  if (D <= 0 || D > 128 || D % 8 || Nq <= 0 || Nk <= 0 || BH <= 0 ||
      (Nq + SQ - 1) / SQ > 65535)
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
