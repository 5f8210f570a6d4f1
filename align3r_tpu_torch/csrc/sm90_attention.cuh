// The Hopper core of the bf16 attention kernels: K9's forward and backward
// (flash_attention.cu), K6 (small_attention.cu) and K1's attention launch
// (fused_site.cu) are roles and softmax policies of one design.
//
// Forward. For q (BH, Nq, D) and k, v (BH, Nk, D) in bf16, D <= DP (DP = 16,
// 32, 64, 128 or 256; the columns past D are zero-filled), one block of one
// warpgroup (128 threads) per (head, 64-query tile):
//   - TMA brings Q once and keeps a ring of STAGES (K, V) key tiles of BK
//     keys in flight, behind full mbarriers. One thread refills a stage as
//     soon as all four warps have passed the products that read it, so the
//     next tile loads while this one is computed. The maps are 3-D
//     (cols, rows, planes) with 32/64/128-byte swizzle, so a box past the
//     last row of a head, or past D, is zero-filled by the copy engine.
//   - S = Q K^T is wgmma.m64n{BK}k16 with both operands in shared memory
//     (K-major descriptors) and S in registers.
//   - The softmax runs on those registers: a thread holds two rows (r, r + 8)
//     of its warp's 16; a row's values sit in the 4 lanes of a quad, so a row
//     max or sum takes two shfl_xor. p = exp2(s * D^-1/2 * log2(e) - m) in
//     fp32; keys >= Nk are masked to -inf.
//   - P is rounded to bf16 in registers: the m64nN accumulator fragment,
//     packed in pairs, is the A fragment of the next product's k16 slices.
//     O += P V is wgmma.m64n{DP}k16 with A from registers and V from shared
//     memory as an N-major operand (the transpose bit for B), O in registers.
//   - The epilogue divides by the row sum in registers and stores bf16 O for
//     rows < Nq (and K9's fp32 log-sum-exp).
// Layouts: head bh is plane bh / H at columns (bh % H) * D. H = 1 is the
// per-head (BH, N, D) layout of K6 and K9; K1's (rows, N, C), heads side by
// side, is H = C / 64 with a map (C, N, rows) whose box column is h * 64 and
// an epilogue row stride of C. A 64-column box never crosses into the next
// head, so K1's attention runs K6's per-block code and gives its bits.
//
// Softmax policies:
//   ONLINE (K9): per key tile, the running row max m and sum l of the
//     unrounded p = exp(s - m_running); O and l rescaled by exp(m_old - m_new);
//     P rounded against the running max; lse = m + log(l).
//   EXACT (K6, K1): a first pass over the key tiles (K only) takes the exact
//     row max; the second pass forms p against it, sums the unrounded p and
//     runs P V. S is computed twice: 1.5x the products of one pass.
//
// Backward (K9, bf16, D = DP = 64, 128 or 256), from lse2 = lse * log2(e) and
// Di = sum(O * dO) per row (fp32; padded to 64-row tiles with lse2 = +inf,
// Di = 0, so padded rows give P = dS = 0), in two kernels with no atomics:
//   - dK/dV: one warpgroup per (head, 64-key tile), the key tile the wgmma
//     M. K and V are resident (loaded once by TMA); each query tile of BQK
//     rows of Q and dO, with its lse2 and Di (bulk copies), streams through
//     the ring as K and V do in the forward. S^T = K Q^T and dP^T = V dO^T
//     have both operands K-major; P^T and dS^T = P^T (dP^T - Di) D^-1/2 are
//     formed in registers (lse2 and Di per column, read from the staged
//     tile) and packed to bf16 A fragments; dV += P^T dO and dK += dS^T Q take
//     B N-major (dO, Q). dK and dV stay in registers: four products per query
//     tile, none through shared memory. BQK = 64 at D = 64, 32 at D = 128
//     and 256 (m64n32: S^T and dP^T beside dK and dV would spill at 64). At
//     D = 256, dK and dV of 64 keys are 256 fp32 registers a thread for one
//     warpgroup, so the block has NWG = 2 warpgroups (256 threads), each
//     owning 128 of the 256 columns of dK and dV (128 accumulator
//     registers): each reduces S^T and dP^T over its own 128 columns of D
//     and the two partials are summed through shared memory.
//   - dQ: one warpgroup per (head, 64-query tile), Q and dO resident, K and V
//     through the ring in tiles of BK keys: S = Q K^T, dP = dO V^T, dS in
//     registers (the row's lse2 and Di in registers, keys >= N masked),
//     dQ += dS K with K N-major. At D = 256, BK = 32 (dQ's accumulator is 128
//     registers) and a block holds NQ = 2 query tiles, a warpgroup each, on
//     one stream of K and V (128 KB of Q and dO: one block an SM, so the two
//     warpgroups are what overlaps one's softmax with the other's products).
// P is rounded to bf16 before dV and dS before dK and dQ, as the stock TPU
// backward does; two launches give the same bits.
//
// What bounds them on the H100: at the training shapes (4, 16, 1024, 64)
// the forward's two products are 17.2 GFLOP (17 us of bf16 tensor cores
// against 10 us for its 33.6 MB), and its 67 M exponentials take about as
// long again on the SMs' exp units (16 a clock per SM), so operations bound
// it and the softmax has to hide behind the products. The backward's bound
// is 5 products (S, dP, dV, dK, dQ: 43 us); the two kernels run 7 (S and dP
// in both, so neither needs atomics or a second pass over a shared dQ) and
// 2 x 67 M exponentials. One warpgroup per block, with 2-3 blocks per SM, is
// what overlaps one block's softmax with another's products; there is no
// producer warp or ping-pong of two consumer warpgroups yet.
#pragma once

#include "sm90_ptx.cuh"

namespace a3r {
namespace sm90 {

constexpr int BQ = 64;         // query rows per block: the wgmma M of one warpgroup
constexpr int THREADS = 128;   // one warpgroup
constexpr int STAGES = 2;      // depth of the K/V ring
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Columns of a (rows x DP) bf16 tile in shared memory: NCB blocks of CB
// columns, each block rows x SW bytes as TMA writes it with an SW-byte
// swizzle (the 16-byte chunk index XOR the row's bits), 1024-byte aligned.
template <int DP>
struct Cols {
  static constexpr int CB = DP < 64 ? DP : 64;
  static constexpr int NCB = DP / CB;
  static constexpr int SW = CB * 2;   // 32, 64 or 128
  // the wgmma descriptor's layout type for that swizzle
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
};

template <int DP, int BK>
struct Smem {
  static constexpr int QB = BQ * DP * 2;             // Q tile bytes
  static constexpr int KB = BK * DP * 2;             // one K or V tile
  static constexpr int K0 = QB;                      // stage s: K at K0 + 2 s KB, V after it
  static constexpr int BAR = K0 + STAGES * 2 * KB;   // STAGES full barriers, then Q's
  static constexpr int BYTES = BAR + (STAGES + 1) * 8 + 1024;   // + the base's alignment
  static_assert(QB % 1024 == 0 && KB % 1024 == 0, "tiles must keep 1024-byte alignment");
};

// ------------------------------------------------- block order, descriptors

// This block's (head, tile) on a (heads, tiles) grid, numbered so that the
// tiles of one head are consecutive blocks: blocks that run together share
// that head's streamed tiles in L2 (a grid of many heads, as K1's decoder
// sites, would otherwise read each head's K and V from device memory once
// per query tile).
__device__ __forceinline__ void head_tile(int& bh, int& tile) {
  const int lin = blockIdx.y * gridDim.x + blockIdx.x;
  bh = lin / gridDim.y;
  tile = lin - bh * gridDim.y;
}

// K-major operand: a (ROWS x DP) tile, reduced along DP; k16 slice kk. The
// 8-row groups are 8 SW bytes apart; within a swizzle row, a slice starts 32
// bytes after the previous one (the hardware applies the XOR).
template <int DP, int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using C = Cols<DP>;
  const int col = kk * 16;
  return make_desc(tile + (col / C::CB) * ROWS * C::SW + (col % C::CB) * 2, 16, 8 * C::SW,
                   C::LAYOUT);
}

// N-major operand: a (ROWS keys x DP) tile reduced along the keys (V in P V);
// k16 slice ks is 16 rows down. Column blocks are ROWS * SW bytes apart (the
// leading offset), 8-row groups 8 SW bytes (the stride offset).
template <int DP, int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int ks) {
  using C = Cols<DP>;
  return make_desc(tile + ks * 16 * C::SW, ROWS * C::SW, 8 * C::SW, C::LAYOUT);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}


// ------------------------------------------------------------ the kernel

// The body of a kernel of THREADS threads launched by launch() below; the
// maps are the kernel's __grid_constant__ parameters. Each caller wraps it in
// a __global__ of its own name (flash_fwd_sm90, small_attention_sm90,
// site_attention_sm90), so a profile tells them apart. Head bh is plane
// bh / H of its tensors, at columns (bh % H) * D .. + D, rows ld elements
// apart: H = 1, ld = D is the per-head (BH, rows, D) layout of K6 and K9; K1's
// (rows, N, C) with the heads side by side is H = C / D, ld = C (D == DP).
template <int DP, int BK, bool EXACT>
__device__ __forceinline__ void attention_fwd(const CUtensorMap& tq, const CUtensorMap& tk,
                                              const CUtensorMap& tv, bf16* __restrict__ o,
                                              float* __restrict__ lse, int Nq, int Nk, int D,
                                              int H, int ld, float scale_log2) {
  using C = Cols<DP>;
  using L = Smem<DP, BK>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, bars = base + L::BAR, qbar = bars + 8 * STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int bh, qt;
  head_tile(bh, qt);
  const int q0 = qt * BQ, plane = bh / H, col0 = (bh - plane * H) * D;
  const int n_tiles = (Nk + BK - 1) / BK;
  const int n_iter = EXACT ? 2 * n_tiles : n_tiles;

  // iteration i reads key tile i % n_tiles from stage i % STAGES, with V
  // only where P V follows (every tile of ONLINE, the second pass of EXACT)
  auto fill = [&](int i) {
    const int s = i % STAGES, k0 = (i % n_tiles) * BK;
    const bool with_v = !EXACT || i >= n_tiles;
    const uint32_t sk = base + L::K0 + s * 2 * L::KB, full = bars + 8 * s;
    mbar_expect_tx(full, (with_v ? 2 : 1) * L::KB);
#pragma unroll
    for (int b = 0; b < C::NCB; ++b) {
      tma_load(sk + b * BK * C::SW, &tk, full, col0 + b * C::CB, k0, plane);
      if (with_v) tma_load(sk + L::KB + b * BK * C::SW, &tv, full, col0 + b * C::CB, k0, plane);
    }
  };
  if (tid == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, L::QB);
#pragma unroll
    for (int b = 0; b < C::NCB; ++b)
      tma_load(sq + b * BQ * C::SW, &tq, qbar, col0 + b * C::CB, q0, plane);
    for (int i = 0; i < STAGES && i < n_iter; ++i) fill(i);
  }
  // after every warp's products have read the stage of iteration i
  auto release = [&](int i) {
    __syncthreads();
    if (tid == 0 && i + STAGES < n_iter) fill(i + STAGES);
  };

  float acc[DP / 2];
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) acc[e] = 0.f;
  // rows r and r + 8 of the thread: max (log2 units, scaled) and sum of p
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);

  for (int i = 0; i < n_iter; ++i) {
    const int s = i % STAGES, k0 = (i % n_tiles) * BK;
    const bool pv = !EXACT || i >= n_tiles;   // this tile feeds P V
    const uint32_t sk = base + L::K0 + s * 2 * L::KB;
    if (EXACT && i == n_tiles) {   // the first pass's exact row max
      m[0] = quad_max(m[0]) * scale_log2;
      m[1] = quad_max(m[1]) * scale_log2;
    }
    mbar_wait(bars + 8 * s, (i / STAGES) & 1);

    float sc[BK / 2];   // S = Q K^T (unscaled)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      Wgmma<BK>::ss(sc, desc_k<DP, BQ>(sq, kk), desc_k<DP, BK>(sk, kk), kk);
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);
    if (k0 + BK > Nk) {   // the ragged last tile: keys >= Nk take no weight
      const int c0 = k0 + 2 * (lane & 3);
#pragma unroll
      for (int e = 0; e < BK / 2; ++e)
        if (c0 + 8 * (e / 4) + (e & 1) >= Nk) sc[e] = -INFINITY;
    }
    if (!pv) {   // EXACT's first pass: the row max only (unscaled: the scale is > 0)
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) m[(e >> 1) & 1] = fmaxf(m[(e >> 1) & 1], sc[e]);
      release(i);
      continue;
    }
    if (!EXACT) {   // ONLINE: the new running max, and the rescale of l and O
      float t[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) t[(e >> 1) & 1] = fmaxf(t[(e >> 1) & 1], sc[e]);
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], quad_max(t[h]) * scale_log2);
        alpha[h] = exp2f(m[h] - m_new);   // 0 on the first tile
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int e = 0; e < DP / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];
    }
    // p in fp32, summed unrounded; rounded to bf16 pairs as the A fragments
    // of P V's k16 slices (slice ks holds S's columns 16 ks .. 16 ks + 15)
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int e = 0; e < BK / 2; e += 2) {
      const int h = (e >> 1) & 1;
      const float p0 = exp2f(fmaf(sc[e], scale_log2, -m[h]));
      const float p1 = exp2f(fmaf(sc[e + 1], scale_log2, -m[h]));
      l[h] += p0 + p1;
      pa[e / 8][(e / 2) % 4] = pack_bf16(p0, p1);
    }
    wgmma_fence();   // acc and pa were written by ordinary instructions
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      Wgmma<DP>::rs(acc, pa[ks], desc_mn<DP, BK>(sk + L::KB, ks));
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    release(i);
  }

  const int r0 = q0 + warp * 16 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lh = quad_sum(l[h]);
    const int row = r0 + 8 * h;
    if (row >= Nq) continue;
    bf16* orow = o + ((size_t)plane * Nq + row) * ld + col0;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] / lh, acc[4 * j + 2 * h + 1] / lh);
    if (!EXACT && (lane & 3) == 0) lse[(size_t)bh * Nq + row] = (m[h] + log2f(lh)) * LN2;
  }
}

// ------------------------------------------------------------ backward

// The backward's shared memory: two resident (R x DP) tiles, a ring of
// STAGES pairs of streamed (S x DP) tiles and, with VEC, two fp32 row
// vectors of S entries per stage (the streamed rows' lse2 and Di); XB bytes
// through which warpgroups exchange partial products; then the STAGES full
// barriers and the resident tiles' barrier.
template <int DP, int R, int S, bool VEC, int XB = 0>
struct BwdSmem {
  static constexpr int RB = R * DP * 2;                  // one resident tile
  static constexpr int SB = S * DP * 2;                  // one streamed tile
  static constexpr int S0 = 2 * RB;                      // stage s: S0 + 2 s SB, then + SB
  static constexpr int VB = VEC ? S * 4 : 0;             // one row vector
  static constexpr int V0 = S0 + STAGES * 2 * SB;        // stage s: V0 + 2 s VB, then + VB
  static constexpr int X0 = V0 + STAGES * 2 * VB;
  static constexpr int BAR = X0 + XB;
  static constexpr int BYTES = BAR + (STAGES + 1) * 8 + 1024;   // + the base's alignment
  static_assert(RB % 1024 == 0 && SB % 1024 == 0, "tiles must keep 1024-byte alignment");
};

// The backward's inputs beside the tensor maps: per head, Np = 64 * ceil(N /
// 64) rows of lse2 = lse * log2(e) and of Di = sum(O * dO), fp32; rows >= N
// hold lse2 = +inf and Di = 0, so their P and dS are 0.
struct BwdRows {
  const float* lse2;
  const float* di;
  int N, Np, D;
  float scale, scale_log2;
};

// dK/dV's shared memory: with NWG = 2 warpgroups, each thread's S^T and dP^T
// partials (BQK fp32) per warpgroup for the exchange
template <int DP, int BQK, int NWG>
using DkvSmem = BwdSmem<DP, BQ, BQK, true, NWG == 1 ? 0 : NWG * THREADS * BQK * 4>;

// dK and dV of one (head, 64-key tile), the key tile the wgmma M, on NWG
// warpgroups, warpgroup g owning columns g DP / NWG .. (g + 1) DP / NWG of dK
// and dV: K and V resident, the query tiles (BQK rows of Q and dO, their lse2
// and Di) through the ring. Per query tile four products:
//   S^T = K Q^T and dP^T = V dO^T, both operands K-major; with NWG = 2 each
//   warpgroup reduces over its own columns of D and the two partials meet
//   through shared memory (thread t of either warpgroup holds the same
//   elements, and a + b == b + a, so both hold the same S^T and dP^T);
//   P^T = exp2(S^T * scale_log2 - lse2[column]) and
//   dS^T = P^T (dP^T - Di[column]) * scale in registers (lse2 and Di read
//   from the staged vectors), each packed to bf16 as A fragments;
//   dV += P^T dO and dK += dS^T Q with A from registers and B (dO, Q) N-major,
//   on the warpgroup's columns.
template <int DP, int BQK, int NWG>
__device__ __forceinline__ void attention_bwd_dkv(const CUtensorMap& tq, const CUtensorMap& tk,
                                                  const CUtensorMap& tv, const CUtensorMap& tdo,
                                                  const BwdRows& a, bf16* __restrict__ dk,
                                                  bf16* __restrict__ dv) {
  using C = Cols<DP>;
  using L = DkvSmem<DP, BQK, NWG>;
  constexpr int DW = DP / NWG;   // this warpgroup's columns of dK, dV and of S^T's sum
  static_assert(DW % C::CB == 0, "a warpgroup's columns are whole column blocks");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), base = (raw + 1023u) & ~1023u;
  const float* vecs = reinterpret_cast<const float*>(smem_raw + (base - raw) + L::V0);
  const uint32_t sk = base, sv = base + L::RB, bars = base + L::BAR, rbar = bars + 8 * STAGES;
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31;
  const int wg = NWG == 1 ? 0 : tid >> 7;
  // the warpgroup's first column block of a streamed (BQK x DP) tile
  const uint32_t wcol = wg * (DW / C::CB) * BQK * C::SW;
  float4* xch = reinterpret_cast<float4*>(smem_raw + (base - raw) + L::X0);
  int bh, kt;
  head_tile(bh, kt);
  const int k0 = kt * BQ, n_tiles = (a.N + BQK - 1) / BQK;

  auto fill = [&](int i) {
    const int s = i % STAGES, q0 = i * BQK;
    const uint32_t sq = base + L::S0 + s * 2 * L::SB, full = bars + 8 * s;
    const uint32_t sl = base + L::V0 + s * 2 * L::VB;
    mbar_expect_tx(full, 2 * L::SB + 2 * L::VB);
#pragma unroll
    for (int b = 0; b < C::NCB; ++b) {
      tma_load(sq + b * BQK * C::SW, &tq, full, b * C::CB, q0, bh);
      tma_load(sq + L::SB + b * BQK * C::SW, &tdo, full, b * C::CB, q0, bh);
    }
    bulk_load(sl, a.lse2 + (size_t)bh * a.Np + q0, L::VB, full);
    bulk_load(sl + L::VB, a.di + (size_t)bh * a.Np + q0, L::VB, full);
  };
  if (tid == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(rbar, 2 * L::RB);
#pragma unroll
    for (int b = 0; b < C::NCB; ++b) {
      tma_load(sk + b * BQ * C::SW, &tk, rbar, b * C::CB, k0, bh);
      tma_load(sv + b * BQ * C::SW, &tv, rbar, b * C::CB, k0, bh);
    }
    for (int i = 0; i < STAGES && i < n_tiles; ++i) fill(i);
  }
  // the staged lse2 and Di were read by ordinary loads: fenced before the
  // copy engine refills the stage
  auto release = [&](int i) {
    __syncthreads();
    if (tid == 0 && i + STAGES < n_tiles) {
      fence_proxy_async();
      fill(i + STAGES);
    }
  };

  float dka[DW / 2], dva[DW / 2];
#pragma unroll
  for (int e = 0; e < DW / 2; ++e) dka[e] = dva[e] = 0.f;
  const int c = 2 * (lane & 3);   // the thread's first column in each 8-column group
  mbar_wait(rbar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const uint32_t sq = base + L::S0 + s * 2 * L::SB, sdo = sq + L::SB;
    const float* vl = vecs + s * 2 * BQK;   // lse2, then Di
    mbar_wait(bars + 8 * s, (i / STAGES) & 1);

    float st[BQK / 2], dpt[BQK / 2];   // S^T, dP^T (unscaled): keys x queries
    constexpr int KS = DW / 16;        // k16 slices of this warpgroup's columns
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      Wgmma<BQK>::ss(st, desc_k<DP, BQ>(sk, wg * KS + kk), desc_k<DP, BQK>(sq, wg * KS + kk), kk);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      Wgmma<BQK>::ss(dpt, desc_k<DP, BQ>(sv, wg * KS + kk), desc_k<DP, BQK>(sdo, wg * KS + kk),
                     kk);
    wgmma_commit();
    wgmma_wait_all();
    pin(st);
    pin(dpt);
    if constexpr (NWG == 2) {   // S^T and dP^T: this warpgroup's partial + the other's
      constexpr int F4 = BQK / 8;   // float4s of st (and of dpt) a thread
      const int t = tid & (THREADS - 1);
#pragma unroll
      for (int j = 0; j < F4; ++j) {
        xch[(wg * 2 * F4 + j) * THREADS + t] =
            make_float4(st[4 * j], st[4 * j + 1], st[4 * j + 2], st[4 * j + 3]);
        xch[(wg * 2 * F4 + F4 + j) * THREADS + t] =
            make_float4(dpt[4 * j], dpt[4 * j + 1], dpt[4 * j + 2], dpt[4 * j + 3]);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < F4; ++j) {
        const float4 x = xch[((1 - wg) * 2 * F4 + j) * THREADS + t];
        const float4 y = xch[((1 - wg) * 2 * F4 + F4 + j) * THREADS + t];
        st[4 * j] += x.x, st[4 * j + 1] += x.y, st[4 * j + 2] += x.z, st[4 * j + 3] += x.w;
        dpt[4 * j] += y.x, dpt[4 * j + 1] += y.y, dpt[4 * j + 2] += y.z, dpt[4 * j + 3] += y.w;
      }
    }

    // P^T and dS^T in fp32, rounded to bf16 pairs as the A fragments of the
    // next products' k16 slices (slice ks holds queries 16 ks .. 16 ks + 15)
    uint32_t pa[BQK / 16][4], da[BQK / 16][4];
#pragma unroll
    for (int e = 0; e < BQK / 2; e += 2) {
      const int col = 8 * (e / 4) + c;
      const float2 l2 = *reinterpret_cast<const float2*>(vl + col);
      const float2 d2 = *reinterpret_cast<const float2*>(vl + BQK + col);
      const float p0 = exp2f(fmaf(st[e], a.scale_log2, -l2.x));
      const float p1 = exp2f(fmaf(st[e + 1], a.scale_log2, -l2.y));
      pa[e / 8][(e / 2) % 4] = pack_bf16(p0, p1);
      da[e / 8][(e / 2) % 4] =
          pack_bf16((dpt[e] - d2.x) * p0 * a.scale, (dpt[e + 1] - d2.y) * p1 * a.scale);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BQK / 16; ++ks)
      Wgmma<DW>::rs(dva, pa[ks], desc_mn<DP, BQK>(sdo + wcol, ks));
#pragma unroll
    for (int ks = 0; ks < BQK / 16; ++ks)
      Wgmma<DW>::rs(dka, da[ks], desc_mn<DP, BQK>(sq + wcol, ks));
    wgmma_commit();
    wgmma_wait_all();
    pin(dva);
    pin(dka);
    release(i);
  }

  const int r0 = k0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= a.N) continue;
    const size_t off = ((size_t)bh * a.N + row) * a.D + wg * DW + c;
#pragma unroll
    for (int j = 0; j < DW / 8; ++j)
      if (wg * DW + 8 * j < a.D) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
            __floats2bfloat162_rn(dka[4 * j + 2 * h], dka[4 * j + 2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
            __floats2bfloat162_rn(dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
      }
  }
}

// dQ of NQ (head, 64-query tile)s, one warpgroup each, on one stream of key
// tiles: Q and dO resident (NQ 64-row tiles), the key tiles (BK rows of K and
// V) through the ring, as the forward's loop. Per key tile three products:
// S = Q K^T and dP = dO V^T (K-major), dS = P (dP - Di) * scale in registers
// (the row's lse2 and Di held in registers; keys >= N masked), and
// dQ += dS K with A from registers and K N-major.
template <int DP, int BK, int NQ>
__device__ __forceinline__ void attention_bwd_dq(const CUtensorMap& tq, const CUtensorMap& tk,
                                                 const CUtensorMap& tv, const CUtensorMap& tdo,
                                                 const BwdRows& a, bf16* __restrict__ dq) {
  constexpr int R = BQ * NQ;   // resident rows
  using C = Cols<DP>;
  using L = BwdSmem<DP, R, BK, false>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31;
  const int wg = NQ == 1 ? 0 : tid >> 7;
  // this warpgroup's 64 rows of the resident Q and dO
  const uint32_t sq = base + wg * BQ * C::SW, sdo = sq + L::RB;
  const uint32_t bars = base + L::BAR, rbar = bars + 8 * STAGES;
  int bh, qt;
  head_tile(bh, qt);
  const int q0 = qt * R + wg * BQ, n_tiles = (a.N + BK - 1) / BK;

  auto fill = [&](int i) {
    const int s = i % STAGES, k0 = i * BK;
    const uint32_t sk = base + L::S0 + s * 2 * L::SB, full = bars + 8 * s;
    mbar_expect_tx(full, 2 * L::SB);
#pragma unroll
    for (int b = 0; b < C::NCB; ++b) {
      tma_load(sk + b * BK * C::SW, &tk, full, b * C::CB, k0, bh);
      tma_load(sk + L::SB + b * BK * C::SW, &tv, full, b * C::CB, k0, bh);
    }
  };
  if (tid == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(rbar, 2 * L::RB);
#pragma unroll
    for (int w = 0; w < NQ; ++w)
#pragma unroll
      for (int b = 0; b < C::NCB; ++b) {
        const uint32_t at = base + b * R * C::SW + w * BQ * C::SW;
        tma_load(at, &tq, rbar, b * C::CB, qt * R + w * BQ, bh);
        tma_load(at + L::RB, &tdo, rbar, b * C::CB, qt * R + w * BQ, bh);
      }
    for (int i = 0; i < STAGES && i < n_tiles; ++i) fill(i);
  }
  auto release = [&](int i) {
    __syncthreads();
    if (tid == 0 && i + STAGES < n_tiles) fill(i + STAGES);
  };

  float acc[DP / 2];
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) acc[e] = 0.f;
  const int r0 = q0 + warp * 16 + (lane >> 2), c = 2 * (lane & 3);
  // rows r0 and r0 + 8: the padded rows (< Np) have P = 0, and so do the rows
  // of a warpgroup's tile past Np (NQ > 1)
  float lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = NQ == 1 || r0 + 8 * h < a.Np;
    lr[h] = in ? a.lse2[(size_t)bh * a.Np + r0 + 8 * h] : INFINITY;
    dr[h] = in ? a.di[(size_t)bh * a.Np + r0 + 8 * h] : 0.f;
  }
  mbar_wait(rbar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES, k0 = i * BK;
    const uint32_t sk = base + L::S0 + s * 2 * L::SB, sv = sk + L::SB;
    mbar_wait(bars + 8 * s, (i / STAGES) & 1);

    float sc[BK / 2], dp[BK / 2];   // S, dP (unscaled): queries x keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      Wgmma<BK>::ss(sc, desc_k<DP, R>(sq, kk), desc_k<DP, BK>(sk, kk), kk);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      Wgmma<BK>::ss(dp, desc_k<DP, R>(sdo, kk), desc_k<DP, BK>(sv, kk), kk);
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);
    pin(dp);
    if (k0 + BK > a.N) {   // the ragged last tile: keys >= N take no weight
#pragma unroll
      for (int e = 0; e < BK / 2; ++e)
        if (k0 + 8 * (e / 4) + c + (e & 1) >= a.N) sc[e] = -INFINITY;
    }
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int e = 0; e < BK / 2; e += 2) {
      const int h = (e >> 1) & 1;
      const float p0 = exp2f(fmaf(sc[e], a.scale_log2, -lr[h]));
      const float p1 = exp2f(fmaf(sc[e + 1], a.scale_log2, -lr[h]));
      da[e / 8][(e / 2) % 4] =
          pack_bf16((dp[e] - dr[h]) * p0 * a.scale, (dp[e + 1] - dr[h]) * p1 * a.scale);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) Wgmma<DP>::rs(acc, da[ks], desc_mn<DP, BK>(sk, ks));
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    release(i);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= a.N) continue;
    bf16* out = dq + ((size_t)bh * a.N + row) * a.D + c;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < a.D)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// ------------------------------------------------------------ host side

// The map of a contiguous (planes, rows, ld) bf16 tensor as (cols, rows,
// planes), cols <= ld, with boxes of CB columns x box_rows rows of one plane:
// a box past a plane's last row or past cols is zero-filled, never read from
// the next plane. The per-head layout (BH, rows, D) is planes = BH,
// cols = ld = D; K1's (rows, N, C) is planes = rows, cols = ld = C.
template <int DP>
inline bool make_map(CUtensorMap* map, const void* ptr, int planes, int rows, int cols, int ld,
                     int box_rows) {
  using C = Cols<DP>;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)rows * ld * 2};
  const cuuint32_t box[3] = {(cuuint32_t)C::CB, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw = C::SW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : C::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}


// Launches KERN, a __global__ wrapping attention_fwd<DP, BK, ...> with the
// signature (tq, tk, tv, o, lse, Nq, Nk, D, H, ld, scale_log2), on q
// (BH, Nq, D), k and v (BH, Nk, D), o like q, all bf16, contiguous and
// 16-byte aligned; lse (BH, Nq) fp32 or null. With H > 1 the tensors are
// (BH / H, N, ld) instead, head bh at columns (bh % H) * D (D == DP). The
// tensor maps are encoded on the host per call and passed by value.
template <int DP, int BK, auto KERN>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                   int Nq, int Nk, int D, float scale, cudaStream_t stream, int H = 1,
                   int ld = 0) {
  using L = Smem<DP, BK>;
  if (ld == 0) ld = D;
  cudaError_t e = configure<KERN>(L::BYTES);
  if (e != cudaSuccess) return e;
  const int planes = BH / H, cols = H * D;
  CUtensorMap tq, tk, tv;
  if (!make_map<DP>(&tq, q, planes, Nq, cols, ld, BQ) ||
      !make_map<DP>(&tk, k, planes, Nk, cols, ld, BK) ||
      !make_map<DP>(&tv, v, planes, Nk, cols, ld, BK))
    return cudaErrorInvalidValue;
  const dim3 grid(BH, (Nq + BQ - 1) / BQ);
  const auto kern = KERN;
  kern<<<grid, THREADS, L::BYTES, stream>>>(tq, tk, tv, (bf16*)o, (float*)lse, Nq, Nk, D, H, ld,
                                            scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace a3r
