// K9: flash attention, forward and backward, for Hopper.
//
// Replaces align3r_tpu/ops/attention.py: stock_flash_attention (:44-68), which
// runs JAX's library Pallas TPU flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py: forward kernel
// _flash_attention_kernel_single_batch :342, dK/dV kernel :796, dQ kernel
// :1146). For q, k, v (BH, N, D), D in {64, 128, 256}, Nq == Nk == N, any N:
//   forward: per key tile of BK keys, S = (q k^T) * D^-1/2 in fp32; keys >= N
//     masked to -inf (every tile holds a valid key, so no row is all -inf;
//     the TPU kernel adds a large negative mask_value instead, and both give
//     exp() == 0); online row max m and sum l of the unrounded
//     p = exp(S - m_running); P rounded to v's dtype before P V
//     (flash_attention.py:447, 470-471), fp32 accumulation. O = acc / l in
//     q's dtype, and the fp32 log-sum-exp m + log(l) per row.
//   backward: Di = sum(O * dO) in fp32 (:273); P = exp(S - LSE) recomputed;
//     dV += P^T dO with P rounded to dO's dtype (:900); dS = (dO V^T - Di) * P
//     * D^-1/2 rounded to dO's dtype before dK += dS^T Q and dQ += dS K
//     (:918, :1255). One kernel per key tile for dK/dV (looping over query
//     tiles) and one per query tile for dQ (looping over key tiles): no
//     atomics, so the result is deterministic.
// The JAX wrapper pads N to a multiple of 128 with segment ids; these kernels
// mask the ragged last tile themselves and make no padded copy.
//
// What bounds it on the H100: at the 512x512 training shapes (4, 16, 1024, 64)
// the forward does 4 * 64 * 1024^2 * 64 = 17.2 GFLOP against 33.6 MB of q, k,
// v and o: 17 us of bf16 tensor-core time against 10 us of memory, so
// operations bound it. Its 67 M exponentials take about as long again on the
// SMs' 16-per-clock exp units, so the softmax has to overlap the products.
// The backward's bound is 5 products (2.5x the forward's operations, 43 us);
// it runs 7 (S and dP in both of its kernels) and exponentiates P twice. The
// (N, N) scores never reach device memory.
//
// Design:
//   bf16 forward: the warpgroup-MMA core of sm90_attention.cuh (ONLINE
//     policy): TMA-fed K/V ring, S and O in registers, P to the second
//     product from registers, BK = 128 keys at D = 64 (64 at D = 128 and 256,
//     where O's registers and the tiles' shared memory leave no room for
//     128). Up to 3 blocks share an SM, so one block's softmax overlaps
//     another's products.
//   bf16 backward: the same core's two backward roles (flash_bwd_dkv_sm90,
//     flash_bwd_dq_sm90) after flash_bwd_prep, which writes Di and
//     lse * log2(e) padded to 64-row tiles. Every product is a wgmma with its
//     accumulator in registers (dK and dV, or dQ, for the whole loop); P^T,
//     dS^T and dS go from accumulator fragments to the next product's A
//     operand in registers; Q and dO (dK/dV) or K and V (dQ) stream through a
//     TMA ring. Two kernels and no atomics keep the result deterministic; the
//     price is S and dP computed in both. At D = 256 the dK/dV block is two
//     warpgroups, each owning half of dK's and dV's columns and reducing S^T
//     and dP^T over its half of D (the partials summed through shared
//     memory), and dQ streams 32-key tiles to two query tiles a block, so
//     that no accumulator passes 128 registers a thread.
//   fp32 forward and backward (simple and right first): 4 warps per block;
//     every product is a set of 16 x 16 output tiles accumulated in fp32 in
//     shared memory by one warp with scalar FMA (warp_tile below), without
//     TF32. Tiles are staged with 16-byte cp.async, sized per D in
//     Tiles<float, D> so the shared memory stays within the 227 KB a block
//     may opt in to; D = 256 takes smaller key or query tiles. They are off
//     the bf16 training recipes (D = 64).
#include "common.cuh"
#include "sm90_attention.cuh"

#include <type_traits>

namespace a3r {
namespace fa {

constexpr int THREADS = 128;   // 4 warps
constexpr int SMEM_MAX = 232448;

struct RowMajor {};
struct ColMajor {};

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

// C (16 x 16 fp32, row stride ldc) = (zero ? 0 : C) + A (16 x kdim) B (kdim x
// 16) in fp32 with scalar FMA, computed by the calling warp. A's element
// (i, k) is A[i * lda + k] (RowMajor) or A[i + k * lda] (ColMajor); B's (k, j)
// is B[k * ldb + j] (RowMajor) or B[k + j * ldb] (ColMajor).
template <typename LA, typename LB>
__device__ __forceinline__ void warp_tile(float* C, int ldc, const float* A, int lda,
                                          const float* B, int ldb, int kdim, bool zero) {
  // each lane owns row lane / 2, columns (lane & 1) * 8 .. + 8
  const int lane = threadIdx.x & 31, i = lane >> 1, j0 = (lane & 1) * 8;
  float c[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) c[j] = zero ? 0.f : C[i * ldc + j0 + j];
  for (int k = 0; k < kdim; ++k) {
    const float a = std::is_same<LA, RowMajor>::value ? A[i * lda + k] : A[i + k * lda];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float b = std::is_same<LB, RowMajor>::value ? B[k * ldb + j0 + j]
                                                        : B[k + (j0 + j) * ldb];
      c[j] = fmaf(a, b, c[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) C[i * ldc + j0 + j] = c[j];
  __syncwarp();
}

// rows [r0, r0 + rows) of a (N, D) matrix into a shared tile of row stride
// ld; rows past N are zero-filled. Does not commit or wait.
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, int r0, int rows,
                                          int N) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = D / EPC;
  for (int c = threadIdx.x; c < rows * CPR; c += THREADS) {
    const int r = c / CPR, dc = (c % CPR) * EPC, g = r0 + r;
    const bool ok = g < N;
    cp_async16(dst + r * ld + dc, ok ? src + (size_t)g * D + dc : src, ok ? 16 : 0);
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, const float* src, int ld, int r0,
                                           int rows, int N) {
  for (int e = threadIdx.x; e < rows * D; e += THREADS) {
    const int r = e / D, c = e - r * D;
    if (r0 + r < N) dst[(size_t)(r0 + r) * D + c] = from_f32<T>(src[r * ld + c]);
  }
}

// ------------------------------------------------------- bf16 forward

// the ONLINE policy of sm90_attention.cuh (Nq == Nk == N); MINB blocks per SM
template <int D, int BK, int MINB>
__global__ void __launch_bounds__(sm90::THREADS, MINB)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
               float* __restrict__ lse, int Nq, int Nk, int Dv, int H, int ld,
               float scale_log2) {
  sm90::attention_fwd<D, BK, false>(tq, tk, tv, o, lse, Nq, Nk, Dv, H, ld, scale_log2);
}

// ------------------------------------------------------- fp32 forward

template <int D, int BK>
struct FwdLayout {
  static constexpr int BQ = 64;                     // 4 warps x 16 query rows
  static constexpr int LDT = D + 4;                 // Q, K, V rows
  static constexpr int LDS = BK + 4;                // S, P rows
  static constexpr int LDO = D + 4;                 // O rows
  static constexpr int Q = 0;
  static constexpr int K = align128(Q + BQ * LDT * 4);
  static constexpr int V = align128(K + BK * LDT * 4);
  static constexpr int S = align128(V + BK * LDT * 4);
  static constexpr int P = align128(S + BQ * LDS * 4);
  static constexpr int O = align128(P + BQ * LDS * 4);
  static constexpr int L = align128(O + BQ * LDO * 4);
  static constexpr int BYTES = L + BQ * 4;
  static_assert(BYTES <= SMEM_MAX, "forward tiles exceed shared memory");
};

template <int D, int BK>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              int N, float scale) {
  using Lay = FwdLayout<D, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + Lay::Q);
  float* Ks = reinterpret_cast<float*>(smem + Lay::K);
  float* Vs = reinterpret_cast<float*>(smem + Lay::V);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* Sw = reinterpret_cast<float*>(smem + Lay::S) + warp * 16 * Lay::LDS;
  float* Pw = reinterpret_cast<float*>(smem + Lay::P) + warp * 16 * Lay::LDS;
  float* Ow = reinterpret_cast<float*>(smem + Lay::O) + warp * 16 * Lay::LDO;
  float* Lw = reinterpret_cast<float*>(smem + Lay::L) + warp * 16;
  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * Lay::BQ;
  const float* qb = q + bh * N * D;
  const float* kb = k + bh * N * D;
  const float* vb = v + bh * N * D;

  load_rows<float, D>(Qs, Lay::LDT, qb, q0, Lay::BQ, N);
  for (int i = lane; i < 16 * D; i += 32) Ow[(i / D) * Lay::LDO + i % D] = 0.f;

  // each lane owns row r of the warp's 16 and one half of the tile's columns
  constexpr int HC = BK / 2, HD = D / 2;
  const int r = lane >> 1, half = lane & 1;
  float m_run = -INFINITY, l_run = 0.f;
  const int n_tiles = (N + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    load_rows<float, D>(Ks, Lay::LDT, kb, k0, BK, N);
    load_rows<float, D>(Vs, Lay::LDT, vb, k0, BK, N);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      warp_tile<RowMajor, ColMajor>(Sw + j * 16, Lay::LDS, Qs + warp * 16 * Lay::LDT,
                                    Lay::LDT, Ks + j * 16 * Lay::LDT, Lay::LDT, D, true);

    const int lim = N - k0 - half * HC;      // valid columns in this lane's half
    const float* srow = Sw + r * Lay::LDS + half * HC;
    float tmax = -INFINITY;
    for (int c = 0; c < HC && c < lim; ++c) tmax = fmaxf(tmax, srow[c] * scale);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m_run, tmax);
    const float alpha = expf(m_run - m_new);   // 0 on the first tile
    float psum = 0.f;
    float* prow = Pw + r * Lay::LDS + half * HC;
    for (int c = 0; c < HC; ++c) {
      const float p = c < lim ? expf(srow[c] * scale - m_new) : 0.f;
      psum += p;
      prow[c] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    float* orow = Ow + r * Lay::LDO + half * HD;
    for (int c = 0; c < HD; ++c) orow[c] *= alpha;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      warp_tile<RowMajor, RowMajor>(Ow + j * 16, Lay::LDO, Pw, Lay::LDS, Vs + j * 16,
                                    Lay::LDT, BK, false);
    __syncthreads();   // K and V are overwritten by the next tile
  }
  if (half == 0) Lw[r] = l_run;
  __syncwarp();
  for (int i = lane; i < 16 * D; i += 32) {
    const int rr = i / D, cc = i - rr * D;
    Ow[rr * Lay::LDO + cc] /= Lw[rr];
  }
  const int row = q0 + warp * 16 + r;
  if (half == 0 && row < N) lse[bh * N + row] = m_run + logf(l_run);
  __syncthreads();   // the block's 64 rows of O, stored by all its threads
  store_rows<float, D>(o + bh * N * D, reinterpret_cast<float*>(smem + Lay::O), Lay::LDO, q0,
                   Lay::BQ, N);
}

// ------------------------------------------------------- bf16 backward

// The sm90 backward's rows (sm90::BwdRows): per head Np = 64 * ceil(N / 64)
// rows of Di = sum over d of o * do and lse2 = lse * log2(e), in fp32; the
// padded rows take Di = 0 and lse2 = +inf. One warp per row.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep(const bf16* __restrict__ o, const bf16* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ lse2, float* __restrict__ di,
               int N, int Np, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int bh = (int)(row / Np), i = (int)(row - (long long)bh * Np);
  float s = 0.f;
  if (i < N) {
    const size_t off = ((size_t)bh * N + i) * D;
    for (int c = lane; c < D; c += 32) s += to_f32(o[off + c]) * to_f32(dout[off + c]);
  }
  s = warp_sum(s);
  if (lane == 0) {
    di[row] = s;
    lse2[row] = i < N ? lse[(size_t)bh * N + i] * sm90::LOG2E : INFINITY;
  }
}

// dK/dV per (head, 64-key tile) on NWG warpgroups and dQ per (head, NQ
// 64-query tiles) on NQ, on the warpgroup-MMA core of sm90_attention.cuh
template <int D, int BQK, int NWG, int MINB>
__global__ void __launch_bounds__(sm90::THREADS * NWG, MINB)
flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo, const sm90::BwdRows rows,
                   bf16* __restrict__ dk, bf16* __restrict__ dv) {
  sm90::attention_bwd_dkv<D, BQK, NWG>(tq, tk, tv, tdo, rows, dk, dv);
}

template <int D, int BK, int NQ, int MINB>
__global__ void __launch_bounds__(sm90::THREADS * NQ, MINB)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo, const sm90::BwdRows rows,
                  bf16* __restrict__ dq) {
  sm90::attention_bwd_dq<D, BK, NQ>(tq, tk, tv, tdo, rows, dq);
}

// ------------------------------------------------------- fp32 backward

// Di = sum over d of o * do, in fp32: one warp per row
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_di(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ di,
             long long rows) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.f;
  for (int c = lane; c < D; c += 32)
    s += to_f32(o[row * D + c]) * to_f32(dout[row * D + c]);
  s = warp_sum(s);
  if (lane == 0) di[row] = s;
}

// the tile layout shared by the dK/dV and dQ kernels: a resident (R rows) side
// and a streamed (SR rows) side
template <typename T, int D, int R, int SR>
struct BwdLayout {
  static constexpr int PADT = 16 / sizeof(T);
  static constexpr int LDT = D + PADT;
  static constexpr int LDO = D + 4;
  static constexpr int R0 = 0;                                          // 2 resident tiles
  static constexpr int S0 = align128(R0 + 2 * R * LDT * (int)sizeof(T));  // 2 streamed tiles
  static constexpr int END = align128(S0 + 2 * SR * LDT * (int)sizeof(T));
};

template <typename T, int D, int BKB, int BQB>
struct DkvLayout {
  using B = BwdLayout<T, D, BKB, BQB>;
  static constexpr int LDS = BKB + 4;               // S, dP (fp32), BQB rows
  static constexpr int LDP = BKB + B::PADT;         // P, dS (T), BQB rows
  static constexpr int S = B::END;
  static constexpr int DP = align128(S + BQB * LDS * 4);
  static constexpr int P = align128(DP + BQB * LDS * 4);
  static constexpr int DS = align128(P + BQB * LDP * (int)sizeof(T));
  static constexpr int LS = align128(DS + BQB * LDP * (int)sizeof(T));
  static constexpr int DI = align128(LS + BQB * 4);
  static constexpr int DK = align128(DI + BQB * 4);
  static constexpr int DV = align128(DK + BKB * B::LDO * 4);
  static constexpr int BYTES = DV + BKB * B::LDO * 4;
  static_assert(BYTES <= SMEM_MAX, "dK/dV tiles exceed shared memory");
};

// one block per (head, BKB-key tile): dK, dV accumulated over every query tile
template <typename T, int D, int BKB, int BQB>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const float* __restrict__ lse, const T* __restrict__ dout,
              const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv,
              int N, float scale) {
  using Lay = DkvLayout<T, D, BKB, BQB>;
  using B = typename Lay::B;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + B::R0);
  T* Vs = Ks + BKB * B::LDT;
  T* Qs = reinterpret_cast<T*>(smem + B::S0);
  T* dOs = Qs + BQB * B::LDT;
  float* S = reinterpret_cast<float*>(smem + Lay::S);
  float* dP = reinterpret_cast<float*>(smem + Lay::DP);
  T* P = reinterpret_cast<T*>(smem + Lay::P);
  T* dS = reinterpret_cast<T*>(smem + Lay::DS);
  float* Ls = reinterpret_cast<float*>(smem + Lay::LS);
  float* Ds = reinterpret_cast<float*>(smem + Lay::DI);
  float* dKs = reinterpret_cast<float*>(smem + Lay::DK);
  float* dVs = reinterpret_cast<float*>(smem + Lay::DV);
  const int tid = threadIdx.x, warp = tid >> 5;
  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * BKB;
  const size_t off = bh * N * D;

  load_rows<T, D>(Ks, B::LDT, k + off, k0, BKB, N);
  load_rows<T, D>(Vs, B::LDT, v + off, k0, BKB, N);
  for (int e = tid; e < BKB * B::LDO; e += THREADS) dKs[e] = dVs[e] = 0.f;

  constexpr int SJ = BKB / 16, NS = (BQB / 16) * SJ, OJ = D / 16, NO = (BKB / 16) * OJ;
  for (int q0 = 0; q0 < N; q0 += BQB) {
    load_rows<T, D>(Qs, B::LDT, q + off, q0, BQB, N);
    load_rows<T, D>(dOs, B::LDT, dout + off, q0, BQB, N);
    cp_async_commit();
    for (int i = tid; i < BQB; i += THREADS) {
      const bool ok = q0 + i < N;
      Ls[i] = ok ? lse[bh * N + q0 + i] : 0.f;
      Ds[i] = ok ? di[bh * N + q0 + i] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    for (int f = warp; f < NS; f += 4) {       // S = Q K^T, dP = dO V^T
      const int fi = f / SJ, fj = f % SJ;
      warp_tile<RowMajor, ColMajor>(S + fi * 16 * Lay::LDS + fj * 16, Lay::LDS,
                                    Qs + fi * 16 * B::LDT, B::LDT, Ks + fj * 16 * B::LDT,
                                    B::LDT, D, true);
      warp_tile<RowMajor, ColMajor>(dP + fi * 16 * Lay::LDS + fj * 16, Lay::LDS,
                                    dOs + fi * 16 * B::LDT, B::LDT, Vs + fj * 16 * B::LDT,
                                    B::LDT, D, true);
    }
    __syncthreads();
    for (int e = tid; e < BQB * BKB; e += THREADS) {
      const int i = e / BKB, j = e - i * BKB;
      const bool ok = q0 + i < N && k0 + j < N;
      const float p = ok ? expf(S[i * Lay::LDS + j] * scale - Ls[i]) : 0.f;
      const float ds = (dP[i * Lay::LDS + j] - Ds[i]) * p * scale;
      P[i * Lay::LDP + j] = from_f32<T>(p);
      dS[i * Lay::LDP + j] = from_f32<T>(ds);
    }
    __syncthreads();
    for (int f = warp; f < NO; f += 4) {       // dV += P^T dO, dK += dS^T Q
      const int fi = f / OJ, fj = f % OJ;
      warp_tile<ColMajor, RowMajor>(dVs + fi * 16 * B::LDO + fj * 16, B::LDO,
                                    P + fi * 16, Lay::LDP, dOs + fj * 16, B::LDT, BQB, false);
      warp_tile<ColMajor, RowMajor>(dKs + fi * 16 * B::LDO + fj * 16, B::LDO,
                                    dS + fi * 16, Lay::LDP, Qs + fj * 16, B::LDT, BQB, false);
    }
    __syncthreads();   // Q, dO, P and dS are overwritten by the next query tile
  }
  store_rows<T, D>(dk + off, dKs, B::LDO, k0, BKB, N);
  store_rows<T, D>(dv + off, dVs, B::LDO, k0, BKB, N);
}

template <typename T, int D, int BQ, int BKB>
struct DqLayout {
  using B = BwdLayout<T, D, BQ, BKB>;
  static constexpr int LDS = BKB + 4;
  static constexpr int LDP = BKB + B::PADT;
  static constexpr int S = B::END;
  static constexpr int DP = align128(S + BQ * LDS * 4);
  static constexpr int DS = align128(DP + BQ * LDS * 4);
  static constexpr int LS = align128(DS + BQ * LDP * (int)sizeof(T));
  static constexpr int DI = align128(LS + BQ * 4);
  static constexpr int DQ = align128(DI + BQ * 4);
  static constexpr int BYTES = DQ + BQ * B::LDO * 4;
  static_assert(BYTES <= SMEM_MAX, "dQ tiles exceed shared memory");
};

// one block per (head, BQ-query tile): dQ accumulated over every key tile
template <typename T, int D, int BQ, int BKB>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const float* __restrict__ lse, const T* __restrict__ dout,
             const float* __restrict__ di, T* __restrict__ dq, int N, float scale) {
  using Lay = DqLayout<T, D, BQ, BKB>;
  using B = typename Lay::B;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + B::R0);
  T* dOs = Qs + BQ * B::LDT;
  T* Ks = reinterpret_cast<T*>(smem + B::S0);
  T* Vs = Ks + BKB * B::LDT;
  float* S = reinterpret_cast<float*>(smem + Lay::S);
  float* dP = reinterpret_cast<float*>(smem + Lay::DP);
  T* dS = reinterpret_cast<T*>(smem + Lay::DS);
  float* Ls = reinterpret_cast<float*>(smem + Lay::LS);
  float* Ds = reinterpret_cast<float*>(smem + Lay::DI);
  float* dQs = reinterpret_cast<float*>(smem + Lay::DQ);
  const int tid = threadIdx.x, warp = tid >> 5;
  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const size_t off = bh * N * D;

  load_rows<T, D>(Qs, B::LDT, q + off, q0, BQ, N);
  load_rows<T, D>(dOs, B::LDT, dout + off, q0, BQ, N);
  for (int i = tid; i < BQ; i += THREADS) {
    const bool ok = q0 + i < N;
    Ls[i] = ok ? lse[bh * N + q0 + i] : 0.f;
    Ds[i] = ok ? di[bh * N + q0 + i] : 0.f;
  }
  for (int e = tid; e < BQ * B::LDO; e += THREADS) dQs[e] = 0.f;

  constexpr int SJ = BKB / 16, NS = (BQ / 16) * SJ, OJ = D / 16, NO = (BQ / 16) * OJ;
  for (int k0 = 0; k0 < N; k0 += BKB) {
    load_rows<T, D>(Ks, B::LDT, k + off, k0, BKB, N);
    load_rows<T, D>(Vs, B::LDT, v + off, k0, BKB, N);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int f = warp; f < NS; f += 4) {
      const int fi = f / SJ, fj = f % SJ;
      warp_tile<RowMajor, ColMajor>(S + fi * 16 * Lay::LDS + fj * 16, Lay::LDS,
                                    Qs + fi * 16 * B::LDT, B::LDT, Ks + fj * 16 * B::LDT,
                                    B::LDT, D, true);
      warp_tile<RowMajor, ColMajor>(dP + fi * 16 * Lay::LDS + fj * 16, Lay::LDS,
                                    dOs + fi * 16 * B::LDT, B::LDT, Vs + fj * 16 * B::LDT,
                                    B::LDT, D, true);
    }
    __syncthreads();
    for (int e = tid; e < BQ * BKB; e += THREADS) {
      const int i = e / BKB, j = e - i * BKB;
      const bool ok = q0 + i < N && k0 + j < N;
      const float p = ok ? expf(S[i * Lay::LDS + j] * scale - Ls[i]) : 0.f;
      dS[i * Lay::LDP + j] = from_f32<T>((dP[i * Lay::LDS + j] - Ds[i]) * p * scale);
    }
    __syncthreads();
    for (int f = warp; f < NO; f += 4) {       // dQ += dS K
      const int fi = f / OJ, fj = f % OJ;
      warp_tile<RowMajor, RowMajor>(dQs + fi * 16 * B::LDO + fj * 16, B::LDO,
                                    dS + fi * 16 * Lay::LDP, Lay::LDP, Ks + fj * 16,
                                    B::LDT, BKB, false);
    }
    __syncthreads();   // K, V and dS are overwritten by the next key tile
  }
  store_rows<T, D>(dq + off, dQs, B::LDO, q0, BQ, N);
}

// ------------------------------------------------------------------ launch

template <typename Kern>
cudaError_t opt_in(Kern kern, int bytes) {
  // one attribute call per instantiation; above 48 KB only as opted-in
  // dynamic shared memory
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Tile sizes: forward (64 queries, BK keys); the fp32 backward's dK/dV (DKV_K
// keys, DKV_Q queries) and dQ (DQ_Q queries, DQ_K keys). The forward's BK is
// the key-block width of the plain version in ops/flash_attention.py
// (block_k(); the CPU tests read it from this text). bf16: 128 keys at
// D = 64; at D = 128 and 256, 64, where a 128-key ring leaves one block per
// SM (D = 128) or O takes 128 registers a thread (D = 256). FWD_BLOCKS is the
// bf16 forward's blocks per SM. The sm90 backward takes 64 keys by SM90_Q
// queries in dK/dV (32 at D = 128 and 256, where a 64-query S^T and dP^T
// beside dK and dV would spill) on SM90_WG warpgroups (2 at D = 256: 128 of
// dK's and dV's columns each), and SM90_QT tiles of 64 queries by SM90_K
// keys in dQ (at D = 256 two query tiles, a warpgroup each, and 32 keys,
// beside dQ's 128 accumulator registers); DKV_BLOCKS and DQ_BLOCKS are their
// blocks per SM.
template <typename T, int D>
struct Tiles;
template <int D>
struct Tiles<bf16, D> {
  static constexpr int BK = D == 64 ? 128 : 64;
  static constexpr int FWD_BLOCKS = D == 64 ? 3 : D == 128 ? 2 : 1;
  static constexpr int SM90_Q = D == 64 ? 64 : 32;
  static constexpr int SM90_WG = D == 256 ? 2 : 1;
  static constexpr int SM90_K = D == 256 ? 32 : 64;
  static constexpr int SM90_QT = D == 256 ? 2 : 1;
  static constexpr int DKV_BLOCKS = D == 256 ? 1 : 2;
  static constexpr int DQ_BLOCKS = D == 64 ? 3 : D == 128 ? 2 : 1;
};
template <int D>
struct Tiles<float, D> {
  static constexpr int BK = D == 256 ? 32 : 64;
  static constexpr int DKV_K = D == 64 ? 64 : 32, DKV_Q = D == 256 ? 32 : 64;
  static constexpr int DQ_Q = D == 256 ? 32 : 64, DQ_K = D == 64 ? 64 : 32;
};

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                       int BH, int N, float scale, cudaStream_t s) {
  using Tl = Tiles<T, D>;
  if constexpr (std::is_same<T, bf16>::value) {
    return sm90::launch<D, Tl::BK, flash_fwd_sm90<D, Tl::BK, Tl::FWD_BLOCKS>>(
        q, k, v, o, lse, BH, N, N, D, scale, s);
  } else {
    using Lay = FwdLayout<D, Tl::BK>;
    static bool configured = false;
    if (!configured) {
      cudaError_t e = opt_in(flash_fwd_f32<D, Tl::BK>, Lay::BYTES);
      if (e != cudaSuccess) return e;
      configured = true;
    }
    dim3 grid(BH, (N + Lay::BQ - 1) / Lay::BQ);
    flash_fwd_f32<D, Tl::BK><<<grid, THREADS, Lay::BYTES, s>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse, N, scale);
    return cudaGetLastError();
  }
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* lse, const void* dout, void* dq, void* dk, void* dv,
                       void* di, int BH, int N, float scale, cudaStream_t s) {
  using Tl = Tiles<T, D>;
  using LKV = DkvLayout<T, D, Tl::DKV_K, Tl::DKV_Q>;
  using LQ = DqLayout<T, D, Tl::DQ_Q, Tl::DQ_K>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = opt_in(flash_bwd_dkv<T, D, Tl::DKV_K, Tl::DKV_Q>, LKV::BYTES);
    if (e == cudaSuccess) e = opt_in(flash_bwd_dq<T, D, Tl::DQ_Q, Tl::DQ_K>, LQ::BYTES);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const long long rows = (long long)BH * N;
  flash_bwd_di<T, D><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      (const T*)o, (const T*)dout, (float*)di, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dim3 gkv(BH, (N + Tl::DKV_K - 1) / Tl::DKV_K);
  flash_bwd_dkv<T, D, Tl::DKV_K, Tl::DKV_Q><<<gkv, THREADS, LKV::BYTES, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)lse, (const T*)dout,
      (const float*)di, (T*)dk, (T*)dv, N, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dim3 gq(BH, (N + Tl::DQ_Q - 1) / Tl::DQ_Q);
  flash_bwd_dq<T, D, Tl::DQ_Q, Tl::DQ_K><<<gq, THREADS, LQ::BYTES, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)lse, (const T*)dout,
      (const float*)di, (T*)dq, N, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_by_d(int D, const void* q, const void* k, const void* v, void* o,
                     void* lse, int BH, int N, float scale, cudaStream_t s) {
  if (D == 64) return launch_fwd<T, 64>(q, k, v, o, lse, BH, N, scale, s);
  if (D == 128) return launch_fwd<T, 128>(q, k, v, o, lse, BH, N, scale, s);
  return launch_fwd<T, 256>(q, k, v, o, lse, BH, N, scale, s);
}

// The bf16 backward: the prep kernel, then dK/dV and dQ on the sm90 core.
// scratch holds 2 BH Np fp32 (Di, then lse2).
template <int D>
cudaError_t launch_bwd_sm90(const void* q, const void* k, const void* v, const void* o,
                            const void* lse, const void* dout, void* dq, void* dk, void* dv,
                            void* scratch, int BH, int N, float scale, cudaStream_t s) {
  using Tl = Tiles<bf16, D>;
  constexpr int BQK = Tl::SM90_Q, NWG = Tl::SM90_WG, BKQ = Tl::SM90_K, NQ = Tl::SM90_QT;
  using LKV = sm90::DkvSmem<D, BQK, NWG>;
  using LQ = sm90::BwdSmem<D, sm90::BQ * NQ, BKQ, false>;
  constexpr auto dkv = flash_bwd_dkv_sm90<D, BQK, NWG, Tl::DKV_BLOCKS>;
  constexpr auto dqk = flash_bwd_dq_sm90<D, BKQ, NQ, Tl::DQ_BLOCKS>;
  cudaError_t e = sm90::configure<dkv>(LKV::BYTES);
  if (e == cudaSuccess) e = sm90::configure<dqk>(LQ::BYTES);
  if (e != cudaSuccess) return e;
  const int Np = (N + 63) / 64 * 64;
  float* di = (float*)scratch;
  float* lse2 = di + (size_t)BH * Np;
  const long long rows = (long long)BH * Np;
  flash_bwd_prep<D><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      (const bf16*)o, (const bf16*)dout, (const float*)lse, lse2, di, N, Np, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // 64-row boxes of the resident tiles; BQK-row boxes of the streamed Q and
  // dO (dK/dV), BKQ-row boxes of the streamed K and V (dQ)
  CUtensorMap tq, tk, tv, tdo, tqs, tdos, tks, tvs;
  if (!sm90::make_map<D>(&tq, q, BH, N, D, D, 64) || !sm90::make_map<D>(&tk, k, BH, N, D, D, 64) ||
      !sm90::make_map<D>(&tv, v, BH, N, D, D, 64) ||
      !sm90::make_map<D>(&tdo, dout, BH, N, D, D, 64) ||
      !sm90::make_map<D>(&tqs, q, BH, N, D, D, BQK) ||
      !sm90::make_map<D>(&tdos, dout, BH, N, D, D, BQK) ||
      !sm90::make_map<D>(&tks, k, BH, N, D, D, BKQ) ||
      !sm90::make_map<D>(&tvs, v, BH, N, D, D, BKQ))
    return cudaErrorInvalidValue;
  const sm90::BwdRows a{lse2, di, N, Np, D, scale, scale * sm90::LOG2E};
  const dim3 grid(BH, (N + 63) / 64), grid_q(BH, (N + 64 * NQ - 1) / (64 * NQ));
  dkv<<<grid, sm90::THREADS * NWG, LKV::BYTES, s>>>(tqs, tk, tv, tdos, a, (bf16*)dk, (bf16*)dv);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dqk<<<grid_q, sm90::THREADS * NQ, LQ::BYTES, s>>>(tq, tks, tvs, tdo, a, (bf16*)dq);
  return cudaGetLastError();
}

cudaError_t bwd_bf16(int D, const void* q, const void* k, const void* v, const void* o,
                     const void* lse, const void* dout, void* dq, void* dk, void* dv,
                     void* scratch, int BH, int N, float scale, cudaStream_t s) {
  if (D == 64)
    return launch_bwd_sm90<64>(q, k, v, o, lse, dout, dq, dk, dv, scratch, BH, N, scale, s);
  if (D == 128)
    return launch_bwd_sm90<128>(q, k, v, o, lse, dout, dq, dk, dv, scratch, BH, N, scale, s);
  return launch_bwd_sm90<256>(q, k, v, o, lse, dout, dq, dk, dv, scratch, BH, N, scale, s);
}

cudaError_t bwd_f32(int D, const void* q, const void* k, const void* v, const void* o,
                    const void* lse, const void* dout, void* dq, void* dk, void* dv,
                    void* di, int BH, int N, float scale, cudaStream_t s) {
  if (D == 64)
    return launch_bwd<float, 64>(q, k, v, o, lse, dout, dq, dk, dv, di, BH, N, scale, s);
  if (D == 128)
    return launch_bwd<float, 128>(q, k, v, o, lse, dout, dq, dk, dv, di, BH, N, scale, s);
  return launch_bwd<float, 256>(q, k, v, o, lse, dout, dq, dk, dv, di, BH, N, scale, s);
}

bool bad_args(int BH, int N, int D) {
  return BH <= 0 || N <= 0 || !(D == 64 || D == 128 || D == 256) || (N + 31) / 32 > 65535;
}

}  // namespace fa
}  // namespace a3r

using namespace a3r::fa;

// q, k, v, o (BH, N, D) in one dtype (bf16 or fp32), contiguous and 16-byte
// aligned; lse (BH, N) fp32.
A3R_EXPORT int a3r_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, int BH, int N, int D, int is_bf16, float scale,
                             void* stream) {
  if (bad_args(BH, N, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_bf16 ? fwd_by_d<bf16>(D, q, k, v, o, lse, BH, N, scale, s)
                       : fwd_by_d<float>(D, q, k, v, o, lse, BH, N, scale, s));
}

// dq, dk, dv (BH, N, D) in the inputs' dtype; scratch: 2 BH Np fp32, Np =
// 64 * ceil(N / 64) (Di and lse2 of the bf16 backward; the fp32 kernels use
// the first BH N as Di).
A3R_EXPORT int a3r_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                             const void* lse, const void* dout, void* dq, void* dk,
                             void* dv, void* scratch, int BH, int N, int D, int is_bf16,
                             float scale, void* stream) {
  if (bad_args(BH, N, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_bf16
                   ? bwd_bf16(D, q, k, v, o, lse, dout, dq, dk, dv, scratch, BH, N, scale, s)
                   : bwd_f32(D, q, k, v, o, lse, dout, dq, dk, dv, scratch, BH, N, scale, s));
}
