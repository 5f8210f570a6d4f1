// The fp32 operand policy of the attention core (sm90_attention.cuh): fp32
// attention on the tensor cores at fp32 accuracy, by 3xTF32 split products.
// K6's fp32 forward (small_attention.cu) and K9's fp32 forward and backward
// (flash_attention.cu) run it.
//
// 3xTF32. A TF32 product keeps 10 mantissa bits of each operand (unit
// roundoff 2^-11), which is not the fp32 function of the JAX package. Each
// fp32 operand x is split as hi = tf32(x) (cvt.rna: to nearest, ties away)
// and lo = tf32(x - hi); a product is lo hi + hi lo + hi hi with fp32
// accumulation (lo lo, below 2^-22 relative, is dropped), about 2^-21 of the
// product's magnitude: three wgmma.m64nNk8 tf32 products for each fp32 one.
//
// TF32 wgmma has no transpose bit: every shared-memory operand is K-major
// along its product's reduction dimension. Where a product reduces over
// keys or queries, a pre-pass writes a transposed copy, split, with each
// group of 8 keys (or queries) in the order 0 2 4 6 1 3 5 7: an accumulator
// fragment holds columns (2t, 2t + 1) of a k8 slice where an A fragment wants
// k = (t, t + 4), so P, P^T, dS and dS^T feed the next product from
// registers with the reduction index permuted the same way on both operands.
// Tiles are TMA boxes with a 128-byte swizzle (32 fp32 columns a swizzle
// row), or 64-byte for a 16-column transposed tile.
//
// Forward. For q (BH, Nq, D) and k, v (BH, Nk, D) fp32, D <= DP (DP = 32, 64,
// 128 or 256), one block of one warpgroup per (head, 64-query tile):
//   - tf32_split_kv (a pre-pass) writes K's hi and lo (BH, Nk, D) and V^T's
//     (BH, D, Nkp), Nkp = 8 ceil(Nk / 8), in the key order above; keys >= Nk
//     are zero.
//   - TMA brings Q once into the hi tile; the block splits it in place (lo
//     into the tile beside it, the same swizzled layout) and fences it for
//     the tensor cores. Two rings of BK-key tiles stream behind full
//     mbarriers: NS stages of K (hi, lo) and NS of V^T (hi, lo). One thread
//     refills a K stage once all four warps have passed S's products, and a
//     V^T stage once they have passed P V's, after a fence.proxy.async, so
//     the next tile's K loads during this tile's softmax and P V.
//   - S = Q K^T as Q_lo K_hi + Q_hi K_lo + Q_hi K_hi (wgmma.m64n{BK}k8, both
//     operands K-major in shared memory), S in registers; keys >= Nk masked
//     to -inf.
//   - One online-softmax pass: running row max m and sum l of the unrounded
//     p = exp2(s * D^-1/2 * log2(e) - m); O and l rescaled by
//     exp2(m_old - m_new). In fp32 "P rounded to v's dtype" is the identity,
//     so the running max gives K6's exact-max function up to fp32 rounding,
//     and K9's function exactly.
//   - p split to hi and lo in registers: O += P_lo V_hi + P_hi V_lo +
//     P_hi V_hi (wgmma.m64n{DP}k8, A from registers, V^T K-major).
//   - The epilogue divides by l and stores fp32 O for rows < Nq, and K9's
//     fp32 log-sum-exp (m + log2 l) ln 2 where lse is given.
//   BK = 32 and NS = 2 up to DP = 128 (K6's 97 KB at DP = 64, 193 KB at
//   128); at DP = 256 Q's hi and lo alone are 128 KB, so BK = 16 and NS = 1
//   (192 KB; the K ring refills during P V, the V^T ring during S), and O is
//   128 accumulator registers a thread, as in the bf16 D = 256 forward.
//
// Backward (K9), from lse2 = lse log2(e) and Di = sum(O dO) per row (padded
// to 64-row tiles with lse2 = +inf and Di = 0, so padded rows give P = dS = 0),
// in two kernels with no atomics, the roles of the bf16 backward:
//   - dK/dV: one warpgroup per (head, 64-key tile). K and V (hi, lo) are
//     resident; each query tile of BQK queries streams through two rings:
//     the A ring holds Q and dO (hi, lo; BQK x D) with the rows' lse2 and Di
//     (bulk copies), the B ring Q^T and dO^T (hi, lo; D x BQK, the query
//     order above). S^T = K Q^T and dP^T = V dO^T reduce over D (A from the
//     resident tiles, B the A ring's); P^T = exp2(S^T * scale_log2 -
//     lse2[query]) and dS^T = P^T (dP^T - Di[query]) D^-1/2 are formed and
//     split in registers; dV += P^T dO and dK += dS^T Q reduce over the
//     queries (A from registers, B the B ring's transposed tiles). dK and dV
//     stay in registers. The A ring's stage is refilled once S^T and dP^T
//     are done, the B ring's once dV and dK are.
//   - dQ: one warpgroup per (head, 64-query tile). Q and dO (hi, lo) are
//     resident; each key tile of BK keys streams K and V (hi, lo) through
//     the A ring and K^T (hi, lo; D x BK, the key order above) through the
//     B ring: S = Q K^T, dP = dO V^T, dS = P (dP - Di) D^-1/2 in registers
//     (the row's lse2 and Di held in registers, keys >= N masked), and
//     dQ += dS K with B the transposed tile.
//   tf32_bwd_prep (the pre-pass) writes Di, lse2, the hi and lo of q, k, v
//   and dO (BH, N, D) and of q^T, dO^T and k^T (BH, D, Nt), Nt = 8 ceil(N /
//   8). Two launches give the same bits.
//   At D = 256 the resident tiles alone (K and V, or Q and dO, in hi and lo)
//   would take 256 KB, and dK with dV 256 registers a thread. Each block is
//   then a cluster of CS = 2 CTAs, CTA h holding columns 128 h .. 128 h + 127
//   of every operand (its resident and streamed tiles are the D = 128
//   kernels') and producing those of dK and dV, or dQ; S^T and dP^T (S and
//   dP) are partial sums over its columns, which the two CTAs exchange
//   through each other's shared memory (cluster_sum: 16-byte stores to the
//   peer, one cluster barrier a tile, two buffers) and add, each in the
//   order own + peer, so both hold the same bits.
//
// What bounds it on the H100: at (4, 16, 1024, 64) the forward's two
// products are 17.2 GFLOP, 51.5 GFLOP as 3xTF32 (104 us at 494.7 TFLOP/s
// dense TF32), against 34 MB of q, k, v and o (10 us at 3.35 TB/s); the
// backward's five products 43 GFLOP, 129 as 3xTF32 (260 us); it runs seven
// (S and dP in both kernels) and its pre-pass moves about 370 MB (110 us).
// One warpgroup runs the products and the softmax in turns; at DP = 64 the
// forward's block takes 97 KB, so 2 blocks share an SM and one's softmax
// overlaps the other's products. The backward's blocks take 160-226 KB:
// one an SM, the rings overlapping its loads with its products; at D = 256 a
// tile's two CTAs also wait on each other once a tile.
#pragma once

#include "sm90_attention.cuh"

namespace a3r {
namespace sm90 {

constexpr int F32_BK = 32;     // K6's keys per stage
constexpr int F32_CB = 32;     // fp32 columns per 128-byte swizzle row

// The fp32 forward's shared memory: Q's hi and lo tiles (BQ x DP), NS
// stages of K (hi, lo: BK x DP), NS stages of V^T (hi, lo: DP x BK), then
// the 2 NS full barriers and Q's. A (rows x DP) tile is DP / 32 column
// blocks of rows x 128 bytes; a V^T tile one column block of DP rows x 4 BK
// bytes.
template <int DP, int BK, int NS>
struct F32Smem {
  static constexpr int QB = BQ * DP * 4;
  static constexpr int KB = BK * DP * 4;   // one K or V^T tile
  static constexpr int K0 = 2 * QB;        // K stage s: K0 + 2 s KB (hi, lo)
  static constexpr int V0 = K0 + NS * 2 * KB;   // V^T stage s: V0 + 2 s KB
  static constexpr int BAR = V0 + NS * 2 * KB;
  static constexpr int BYTES = BAR + (2 * NS + 1) * 8 + 1024;   // + the base's alignment
  static_assert(QB % 1024 == 0 && KB % 1024 == 0, "tiles must keep 1024-byte alignment");
  static_assert(BYTES <= 232448, "the forward's tiles exceed shared memory");
};

// K-major fp32 operand: a (ROWS x K) tile reduced along K, in column blocks
// of CB fp32 (a CB * 4-byte swizzle: 32 -> 128 bytes, 16 -> 64), k8 slice kk
// (32 bytes); 8-row groups 8 CB * 4 bytes apart
template <int ROWS, int CB = F32_CB>
__device__ __forceinline__ uint64_t desc_k_f32(uint32_t tile, int kk) {
  static_assert(CB == 32 || CB == 16, "128- or 64-byte swizzle");
  const int col = kk * 8;
  return make_desc(tile + (col / CB) * ROWS * CB * 4 + (col % CB) * 4, 16, 8 * CB * 4,
                   CB == 32 ? 1 : 2);
}

__device__ __forceinline__ int tf32_key_order(int pos) {   // V^T position -> key, per 8
  return pos < 4 ? 2 * pos : 2 * (pos - 4) + 1;
}

__device__ __forceinline__ void tf32_split(float x, float& hi, float& lo) {
  const float h = tf32_rna(x);
  hi = h;
  lo = tf32_rna(x - h);
}

// the A fragments (hi, lo) of a k8 slice from accumulator elements x[4j ..
// 4j + 3]: a[0..3] = x[4j], x[4j + 2], x[4j + 1], x[4j + 3]
__device__ __forceinline__ int frag_elem(int j, int a) { return 4 * j + (a >> 1) + 2 * (a & 1); }

// The forward's pre-pass: one block of 256 threads per (head, 32 keys), D <=
// DMAX. kh, kl like k; vth, vtl (BH, D, Nkp) with each group of 8 keys in
// tf32_key_order.
template <int DMAX = 128>
__device__ __forceinline__ void tf32_split_kv(const float* __restrict__ k,
                                              const float* __restrict__ v, float* __restrict__ kh,
                                              float* __restrict__ kl, float* __restrict__ vth,
                                              float* __restrict__ vtl, int Nk, int Nkp, int D) {
  __shared__ float vs[32][DMAX + 1];
  const int bh = blockIdx.x, k0 = blockIdx.y * 32;
  const size_t in = (size_t)bh * Nk * D;
  for (int e = threadIdx.x; e < 32 * D; e += blockDim.x) {
    const int r = e / D, c = e - r * D, key = k0 + r;
    float y = 0.f;
    if (key < Nk) {
      const size_t at = in + (size_t)key * D + c;
      const float x = k[at], h = tf32_rna(x);
      kh[at] = h;
      kl[at] = tf32_rna(x - h);
      y = v[at];
    }
    vs[r][c] = y;
  }
  __syncthreads();
  const size_t out = (size_t)bh * D * Nkp;
  for (int e = threadIdx.x; e < 32 * D; e += blockDim.x) {
    const int d = e >> 5, pos = e & 31;
    if (k0 + pos >= Nkp) continue;
    const float y = vs[(pos & ~7) + tf32_key_order(pos & 7)][d], h = tf32_rna(y);
    const size_t at = out + (size_t)d * Nkp + k0 + pos;
    vth[at] = h;
    vtl[at] = tf32_rna(y - h);
  }
}

// The forward's body, for a kernel of THREADS threads launched by
// launch_f32() below: o = softmax(q k^T * scale) v in fp32, per head, and
// where lse is not null its log-sum-exp (BH, Nq).
template <int DP, int BK, int NS>
__device__ __forceinline__ void attention_fwd_tf32(const CUtensorMap& tq, const CUtensorMap& tkh,
                                                   const CUtensorMap& tkl, const CUtensorMap& tvh,
                                                   const CUtensorMap& tvl, float* __restrict__ o,
                                                   float* __restrict__ lse, int Nq, int Nk, int D,
                                                   float scale_log2) {
  constexpr int NCB = DP / F32_CB;
  using L = F32Smem<DP, BK, NS>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), base = (raw + 1023u) & ~1023u;
  const uint32_t sqh = base, sql = base + L::QB, kbars = base + L::BAR;
  const uint32_t vbars = kbars + 8 * NS, qbar = vbars + 8 * NS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int bh, qt;
  head_tile(bh, qt);
  const int q0 = qt * BQ, n_tiles = (Nk + BK - 1) / BK;

  auto fill_k = [&](int i) {
    const int s = i % NS, k0 = i * BK;
    const uint32_t st = base + L::K0 + s * 2 * L::KB, full = kbars + 8 * s;
    mbar_expect_tx(full, 2 * L::KB);
#pragma unroll
    for (int b = 0; b < NCB; ++b) {
      tma_load(st + b * BK * 128, &tkh, full, b * F32_CB, k0, bh);
      tma_load(st + L::KB + b * BK * 128, &tkl, full, b * F32_CB, k0, bh);
    }
  };
  auto fill_v = [&](int i) {
    const int s = i % NS, k0 = i * BK;
    const uint32_t st = base + L::V0 + s * 2 * L::KB, full = vbars + 8 * s;
    mbar_expect_tx(full, 2 * L::KB);
    tma_load(st, &tvh, full, k0, 0, bh);
    tma_load(st + L::KB, &tvl, full, k0, 0, bh);
  };
  if (tid == 0) {
    for (int s = 0; s <= 2 * NS; ++s) mbar_init(kbars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, L::QB);
#pragma unroll
    for (int b = 0; b < NCB; ++b) tma_load(sqh + b * BQ * 128, &tq, qbar, b * F32_CB, q0, bh);
    for (int i = 0; i < NS && i < n_tiles; ++i) {
      fill_k(i);
      fill_v(i);
    }
  }
  // after every warp's products have read the K (or V^T) stage of tile i
  auto release_k = [&](int i) {
    __syncthreads();
    if (tid == 0 && i + NS < n_tiles) {
      fence_proxy_async();
      fill_k(i + NS);
    }
  };
  auto release_v = [&](int i) {
    __syncthreads();
    if (tid == 0 && i + NS < n_tiles) {
      fence_proxy_async();
      fill_v(i + NS);
    }
  };

  // Q split in place: hi stays in its tile, lo goes to the same offset of
  // the next; fenced so that the tensor cores read the new values
  mbar_wait(qbar, 0);
  {
    float4* qh = reinterpret_cast<float4*>(smem_raw + (base - raw));
    float4* ql = qh + L::QB / 16;
    for (int i = tid; i < L::QB / 16; i += THREADS) {
      const float4 x = qh[i];
      const float4 h = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
      qh[i] = h;
      ql[i] = make_float4(tf32_rna(x.x - h.x), tf32_rna(x.y - h.y), tf32_rna(x.z - h.z),
                          tf32_rna(x.w - h.w));
    }
    fence_proxy_async();
    __syncthreads();
  }

  float acc[DP / 2];
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) acc[e] = 0.f;
  // rows r and r + 8 of the thread: running max (log2 units, scaled) and sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int c = 2 * (lane & 3);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % NS, k0 = i * BK;
    const uint32_t skh = base + L::K0 + s * 2 * L::KB, skl = skh + L::KB;
    const uint32_t svh = base + L::V0 + s * 2 * L::KB, svl = svh + L::KB;
    mbar_wait(kbars + 8 * s, (i / NS) & 1);

    float sc[BK / 2];   // S = Q K^T (unscaled), the small terms first
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk)
      WgmmaTf32<BK>::ss(sc, desc_k_f32<BQ>(sql, kk), desc_k_f32<BK>(skh, kk), kk);
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk)
      WgmmaTf32<BK>::ss(sc, desc_k_f32<BQ>(sqh, kk), desc_k_f32<BK>(skl, kk), 1);
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk)
      WgmmaTf32<BK>::ss(sc, desc_k_f32<BQ>(sqh, kk), desc_k_f32<BK>(skh, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);
    release_k(i);
    if (k0 + BK > Nk) {   // the ragged last tile: keys >= Nk take no weight
#pragma unroll
      for (int e = 0; e < BK / 2; ++e)
        if (k0 + 8 * (e / 4) + c + (e & 1) >= Nk) sc[e] = -INFINITY;
    }
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

    // p in fp32, summed unsplit; its hi and lo as the A fragments of P V's
    // k8 slices (keys 2t and 2t + 1 as k = t and t + 4)
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int e = frag_elem(j, a), h = a & 1;
        const float p = exp2f(fmaf(sc[e], scale_log2, -m[h]));
        l[h] += p;
        const float hi = tf32_rna(p);
        ph[j][a] = __float_as_uint(hi);
        pl[j][a] = __float_as_uint(tf32_rna(p - hi));
      }
    }
    mbar_wait(vbars + 8 * s, (i / NS) & 1);
    wgmma_fence();   // acc, ph and pl were written by ordinary instructions
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks)
      WgmmaTf32<DP>::rs(acc, pl[ks], desc_k_f32<DP, BK>(svh, ks));
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks)
      WgmmaTf32<DP>::rs(acc, ph[ks], desc_k_f32<DP, BK>(svl, ks));
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks)
      WgmmaTf32<DP>::rs(acc, ph[ks], desc_k_f32<DP, BK>(svh, ks));
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    release_v(i);
  }

  const int r0 = q0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lh = quad_sum(l[h]);
    const int row = r0 + 8 * h;
    if (row >= Nq) continue;
    float* orow = o + ((size_t)bh * Nq + row) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < D)
        *reinterpret_cast<float2*>(orow + 8 * j + c) =
            make_float2(acc[4 * j + 2 * h] / lh, acc[4 * j + 2 * h + 1] / lh);
    if (lse != nullptr && (lane & 3) == 0) lse[(size_t)bh * Nq + row] = (m[h] + log2f(lh)) * LN2;
  }
}

// ------------------------------------------------------------ backward

// The fp32 backward's scratch, carved by bwd_scratch() below: Di and lse2
// (BH Np each, the rows of BwdRows), the hi and lo of q, k, v, dO (BH, N, D)
// and of q^T, dO^T, k^T (BH, D, Nt), each group of 8 rows in tf32_key_order.
struct F32Bwd {
  float *di, *lse2;
  float *qh, *ql, *kh, *kl, *vh, *vl, *doh, *dol;
  float *qth, *qtl, *doth, *dotl, *kth, *ktl;
};

// floats of F32Bwd for (BH, N, D); Np = 64 ceil(N / 64), Nt = 8 ceil(N / 8)
inline size_t bwd_scratch_floats(int BH, int N, int D) {
  const size_t Np = (N + 63) / 64 * 64, Nt = (N + 7) / 8 * 8;
  return (size_t)BH * (2 * Np + 8 * (size_t)N * D + 6 * (size_t)D * Nt);
}

inline F32Bwd bwd_scratch(float* p, int BH, int N, int D) {
  const size_t Np = (N + 63) / 64 * 64, Nt = (N + 7) / 8 * 8;
  const size_t rows = (size_t)BH * Np, nd = (size_t)BH * N * D, dt = (size_t)BH * D * Nt;
  F32Bwd s;
  s.di = p;
  s.lse2 = p + rows;
  float* r = p + 2 * rows;
  float** row_major[8] = {&s.qh, &s.ql, &s.kh, &s.kl, &s.vh, &s.vl, &s.doh, &s.dol};
  for (int i = 0; i < 8; ++i) *row_major[i] = r + i * nd;
  float* t = r + 8 * nd;
  float** trans[6] = {&s.qth, &s.qtl, &s.doth, &s.dotl, &s.kth, &s.ktl};
  for (int i = 0; i < 6; ++i) *trans[i] = t + i * dt;
  return s;
}

// The backward's pre-pass: one block of 256 threads per (head, 32 rows),
// D <= DMAX. Rows < Np get Di = sum(o dO) and lse2 = lse log2(e) (+inf and 0
// past N); rows < N their q, k, v, dO split; positions < Nt of q^T, dO^T, k^T
// their split, in tf32_key_order, zero past N.
template <int DMAX>
__device__ __forceinline__ void tf32_bwd_prep(const float* __restrict__ q,
                                              const float* __restrict__ k,
                                              const float* __restrict__ v,
                                              const float* __restrict__ o,
                                              const float* __restrict__ dout,
                                              const float* __restrict__ lse, const F32Bwd s,
                                              int N, int Np, int Nt, int D) {
  __shared__ float ts[32][DMAX + 1];
  const int bh = blockIdx.x, r0 = blockIdx.y * 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t in = (size_t)bh * N * D;
  for (int rr = warp; rr < 32; rr += blockDim.x >> 5) {
    const int row = r0 + rr;
    if (row >= Np) continue;
    float acc = 0.f;
    if (row < N)
      for (int c = lane; c < D; c += 32) acc += o[in + (size_t)row * D + c] * dout[in + (size_t)row * D + c];
    acc = warp_sum(acc);
    if (lane == 0) {
      s.di[(size_t)bh * Np + row] = acc;
      s.lse2[(size_t)bh * Np + row] = row < N ? lse[(size_t)bh * N + row] * LOG2E : INFINITY;
    }
  }
  for (int e = tid; e < 32 * D; e += blockDim.x) {
    const int r = e / D, c = e - r * D, row = r0 + r;
    if (row >= N) continue;
    const size_t at = in + (size_t)row * D + c;
    tf32_split(q[at], s.qh[at], s.ql[at]);
    tf32_split(k[at], s.kh[at], s.kl[at]);
    tf32_split(v[at], s.vh[at], s.vl[at]);
    tf32_split(dout[at], s.doh[at], s.dol[at]);
  }
  const float* src[3] = {q, dout, k};
  float* hi[3] = {s.qth, s.doth, s.kth};
  float* lo[3] = {s.qtl, s.dotl, s.ktl};
  const size_t out = (size_t)bh * D * Nt;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    __syncthreads();   // the previous tensor's reads of ts are done
    for (int e = tid; e < 32 * D; e += blockDim.x) {
      const int r = e / D, c = e - r * D, row = r0 + r;
      ts[r][c] = row < N ? src[t][in + (size_t)row * D + c] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < 32 * D; e += blockDim.x) {
      const int d = e >> 5, pos = e & 31;
      if (r0 + pos >= Nt) continue;
      const size_t at = out + (size_t)d * Nt + r0 + pos;
      tf32_split(ts[(pos & ~7) + tf32_key_order(pos & 7)][d], hi[t][at], lo[t][at]);
    }
  }
}

// dK/dV's shared memory for DL of D's columns: K hi, K lo, V hi, V lo
// resident (64 x DL); NA stages of the A ring (Q hi, Q lo, dO hi, dO lo:
// BQK x DL), NB of the B ring (Q^T hi, Q^T lo, dO^T hi, dO^T lo: DL x BQK);
// XB bytes of exchange memory (two buffers of S^T's and dP^T's partials,
// CS = 2); the A stages' lse2 and Di (BQK fp32 each); then the NA + NB full
// barriers and the resident tiles'.
template <int DL, int BQK, int NA, int NB, int XB>
struct F32DkvSmem {
  static constexpr int RB = BQ * DL * 4;         // one resident tile
  static constexpr int TB = BQK * DL * 4;        // one streamed tile, either orientation
  static constexpr int A0 = 4 * RB;              // A stage s: A0 + 4 s TB
  static constexpr int B0 = A0 + NA * 4 * TB;    // B stage s: B0 + 4 s TB
  static constexpr int X0 = B0 + NB * 4 * TB;
  static constexpr int V0 = X0 + XB;             // A stage s's lse2: V0 + 2 s BQK 4, Di after
  static constexpr int BAR = V0 + NA * 2 * BQK * 4;
  static constexpr int BYTES = BAR + (NA + NB + 1) * 8 + 1024;   // + the base's alignment
  static_assert(TB % 1024 == 0, "tiles must keep 1024-byte alignment");
  static_assert(BYTES <= 232448, "dK/dV's tiles exceed shared memory");
};

// dQ's shared memory for DL of D's columns: Q hi, Q lo, dO hi, dO lo
// resident (64 x DL); NA stages of the A ring (K hi, K lo, V hi, V lo:
// BK x DL), NB of the B ring (K^T hi, K^T lo: DL x BK); XB bytes of exchange
// memory (CS = 2); then the NA + NB full barriers and the resident tiles'.
template <int DL, int BK, int NA, int NB, int XB>
struct F32DqSmem {
  static constexpr int RB = BQ * DL * 4;
  static constexpr int TB = BK * DL * 4;
  static constexpr int A0 = 4 * RB;              // A stage s: A0 + 4 s TB
  static constexpr int B0 = A0 + NA * 4 * TB;    // B stage s: B0 + 2 s TB
  static constexpr int X0 = B0 + NB * 2 * TB;
  static constexpr int BAR = X0 + XB;
  static constexpr int BYTES = BAR + (NA + NB + 1) * 8 + 1024;
  static_assert(TB % 1024 == 0, "tiles must keep 1024-byte alignment");
  static_assert(BYTES <= 232448, "dQ's tiles exceed shared memory");
};

// exchange memory of the two CTAs of a cluster (CS = 2) for two partial
// products of N fp32 a thread: two buffers, so that a CTA writes tile i + 2's
// partials only after the peer has passed tile i + 1's barrier
template <int CS, int N>
__host__ __device__ constexpr int xchg_bytes() {
  return CS == 1 ? 0 : 2 * 2 * N * 4 * THREADS;
}

// With CS = 2 each CTA of a cluster reduces over its half of D: x and y (N
// fp32 a thread) become the sums of both CTAs' partials, the same bits in
// both (own + peer in each, and a + b == b + a). This CTA's partials go to
// the peer's buffer `buf` (16-byte stores to its shared memory), a cluster
// barrier, then the peer's are read from this CTA's own buffer.
template <int N>
__device__ __forceinline__ void cluster_sum(float (&x)[N], float (&y)[N], float4* xch, int buf) {
  constexpr int F4 = N / 4;
  const int t = threadIdx.x;
  float4* mine = xch + buf * 2 * F4 * THREADS;
  const uint32_t peer = mapa_shared(smem_addr(mine), cluster_rank() ^ 1);
#pragma unroll
  for (int j = 0; j < F4; ++j) {
    st_cluster_v4(peer + (j * THREADS + t) * 16, x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
    st_cluster_v4(peer + ((F4 + j) * THREADS + t) * 16, y[4 * j], y[4 * j + 1], y[4 * j + 2],
                  y[4 * j + 3]);
  }
  cluster_sync();
#pragma unroll
  for (int j = 0; j < F4; ++j) {
    const float4 a = mine[j * THREADS + t], b = mine[(F4 + j) * THREADS + t];
    x[4 * j] += a.x, x[4 * j + 1] += a.y, x[4 * j + 2] += a.z, x[4 * j + 3] += a.w;
    y[4 * j] += b.x, y[4 * j + 1] += b.y, y[4 * j + 2] += b.z, y[4 * j + 3] += b.w;
  }
}

// The maps of dK/dV: K, V (hi, lo) with 64-row boxes (resident), Q, dO
// (hi, lo) with BQK-row boxes; the transposed Q^T, dO^T (hi, lo) with
// (BQK x D / CS) boxes.
struct F32DkvMaps {
  CUtensorMap kh, kl, vh, vl, qh, ql, doh, dol, qth, qtl, doth, dotl;
};

// The maps of dQ: Q, dO (hi, lo) with 64-row boxes, K, V (hi, lo) with
// BK-row boxes, K^T (hi, lo) with (BK x D / CS) boxes.
struct F32DqMaps {
  CUtensorMap qh, ql, doh, dol, kh, kl, vh, vl, kth, ktl;
};

// dK and dV of one (head, 64-key tile), the key tile the wgmma M, on one
// warpgroup: K and V resident, the query tiles through the A and B rings.
// With CS = 2 a cluster of two CTAs shares the tile, CTA h holding columns
// h D / 2 .. of every operand and producing those of dK and dV; S^T and dP^T
// are summed over the two halves through cluster_sum.
template <int D, int BQK, int NA, int NB, int CS>
__device__ __forceinline__ void attention_bwd_dkv_tf32(const F32DkvMaps& m, const BwdRows& a,
                                                       float* __restrict__ dk,
                                                       float* __restrict__ dv) {
  constexpr int DL = D / CS, NCB = DL / F32_CB;
  using L = F32DkvSmem<DL, BQK, NA, NB, xchg_bytes<CS, BQK / 2>()>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), base = (raw + 1023u) & ~1023u;
  const float* vecs = reinterpret_cast<const float*>(smem_raw + (base - raw) + L::V0);
  float4* xch = reinterpret_cast<float4*>(smem_raw + (base - raw) + L::X0);
  const uint32_t skh = base, skl = base + L::RB, svh = base + 2 * L::RB, svl = base + 3 * L::RB;
  const uint32_t abars = base + L::BAR, bbars = abars + 8 * NA, rbar = bbars + 8 * NB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col0 = CS == 1 ? 0 : (int)cluster_rank() * DL;   // this CTA's columns of D
  int bh, kt;
  head_tile(bh, kt);
  const int k0 = kt * BQ, n_tiles = (a.N + BQK - 1) / BQK;

  auto fill_a = [&](int i) {
    const int s = i % NA, q0 = i * BQK;
    const uint32_t st = base + L::A0 + s * 4 * L::TB, full = abars + 8 * s;
    const uint32_t sl = base + L::V0 + s * 2 * BQK * 4;
    mbar_expect_tx(full, 4 * L::TB + 2 * BQK * 4);
#pragma unroll
    for (int b = 0; b < NCB; ++b) {
      const int col = col0 + b * F32_CB;
      tma_load(st + b * BQK * 128, &m.qh, full, col, q0, bh);
      tma_load(st + L::TB + b * BQK * 128, &m.ql, full, col, q0, bh);
      tma_load(st + 2 * L::TB + b * BQK * 128, &m.doh, full, col, q0, bh);
      tma_load(st + 3 * L::TB + b * BQK * 128, &m.dol, full, col, q0, bh);
    }
    bulk_load(sl, a.lse2 + (size_t)bh * a.Np + q0, BQK * 4, full);
    bulk_load(sl + BQK * 4, a.di + (size_t)bh * a.Np + q0, BQK * 4, full);
  };
  auto fill_b = [&](int i) {
    const int s = i % NB, q0 = i * BQK;
    const uint32_t st = base + L::B0 + s * 4 * L::TB, full = bbars + 8 * s;
    mbar_expect_tx(full, 4 * L::TB);
    tma_load(st, &m.qth, full, q0, col0, bh);
    tma_load(st + L::TB, &m.qtl, full, q0, col0, bh);
    tma_load(st + 2 * L::TB, &m.doth, full, q0, col0, bh);
    tma_load(st + 3 * L::TB, &m.dotl, full, q0, col0, bh);
  };
  if (tid == 0) {
    for (int s = 0; s <= NA + NB; ++s) mbar_init(abars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (CS == 2) cluster_sync();   // the peer has started before its memory is written
  if (tid == 0) {
    mbar_expect_tx(rbar, 4 * L::RB);
#pragma unroll
    for (int b = 0; b < NCB; ++b) {
      const int col = col0 + b * F32_CB;
      tma_load(skh + b * BQ * 128, &m.kh, rbar, col, k0, bh);
      tma_load(skl + b * BQ * 128, &m.kl, rbar, col, k0, bh);
      tma_load(svh + b * BQ * 128, &m.vh, rbar, col, k0, bh);
      tma_load(svl + b * BQ * 128, &m.vl, rbar, col, k0, bh);
    }
    for (int i = 0; i < NA && i < n_tiles; ++i) fill_a(i);
    for (int i = 0; i < NB && i < n_tiles; ++i) fill_b(i);
  }

  float dka[DL / 2], dva[DL / 2];
#pragma unroll
  for (int e = 0; e < DL / 2; ++e) dka[e] = dva[e] = 0.f;
  const int c = 2 * (lane & 3);   // the thread's first column in each 8-column group
  mbar_wait(rbar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int sa = i % NA, sb = i % NB;
    const uint32_t sqh = base + L::A0 + sa * 4 * L::TB, sql = sqh + L::TB;
    const uint32_t sdoh = sqh + 2 * L::TB, sdol = sqh + 3 * L::TB;
    const uint32_t sqth = base + L::B0 + sb * 4 * L::TB, sqtl = sqth + L::TB;
    const uint32_t sdoth = sqth + 2 * L::TB, sdotl = sqth + 3 * L::TB;
    const float* vl = vecs + sa * 2 * BQK;   // lse2, then Di
    mbar_wait(abars + 8 * sa, (i / NA) & 1);

    float st[BQK / 2], dpt[BQK / 2];   // S^T, dP^T (unscaled): keys x queries
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DL / 8; ++kk)
      WgmmaTf32<BQK>::ss(st, desc_k_f32<BQ>(skl, kk), desc_k_f32<BQK>(sqh, kk), kk);
#pragma unroll
    for (int kk = 0; kk < DL / 8; ++kk)
      WgmmaTf32<BQK>::ss(st, desc_k_f32<BQ>(skh, kk), desc_k_f32<BQK>(sql, kk), 1);
#pragma unroll
    for (int kk = 0; kk < DL / 8; ++kk)
      WgmmaTf32<BQK>::ss(st, desc_k_f32<BQ>(skh, kk), desc_k_f32<BQK>(sqh, kk), 1);
#pragma unroll
    for (int kk = 0; kk < DL / 8; ++kk)
      WgmmaTf32<BQK>::ss(dpt, desc_k_f32<BQ>(svl, kk), desc_k_f32<BQK>(sdoh, kk), kk);
#pragma unroll
    for (int kk = 0; kk < DL / 8; ++kk)
      WgmmaTf32<BQK>::ss(dpt, desc_k_f32<BQ>(svh, kk), desc_k_f32<BQK>(sdol, kk), 1);
#pragma unroll
    for (int kk = 0; kk < DL / 8; ++kk)
      WgmmaTf32<BQK>::ss(dpt, desc_k_f32<BQ>(svh, kk), desc_k_f32<BQK>(sdoh, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    pin(st);
    pin(dpt);
    if constexpr (CS == 2) cluster_sum(st, dpt, xch, i & 1);
    // the thread's queries' lse2 and Di, read before the stage is refilled
    float2 l2[BQK / 8], d2[BQK / 8];
#pragma unroll
    for (int j = 0; j < BQK / 8; ++j) {
      l2[j] = *reinterpret_cast<const float2*>(vl + 8 * j + c);
      d2[j] = *reinterpret_cast<const float2*>(vl + BQK + 8 * j + c);
    }
    __syncthreads();   // every warp is past the A stage
    if (tid == 0 && i + NA < n_tiles) {
      fence_proxy_async();
      fill_a(i + NA);
    }

    // P^T and dS^T (keys x queries) split as the A fragments of the next
    // products' k8 slices; element frag_elem(j, q) is at query
    // 8j + c + (q >> 1)
    uint32_t ph[BQK / 8][4], pl[BQK / 8][4], dh[BQK / 8][4], dl[BQK / 8][4];
#pragma unroll
    for (int j = 0; j < BQK / 8; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = frag_elem(j, q), odd = q >> 1;
        const float p = exp2f(fmaf(st[e], a.scale_log2, -(odd ? l2[j].y : l2[j].x)));
        const float ds = (dpt[e] - (odd ? d2[j].y : d2[j].x)) * p * a.scale;
        float hi, lo;
        tf32_split(p, hi, lo);
        ph[j][q] = __float_as_uint(hi);
        pl[j][q] = __float_as_uint(lo);
        tf32_split(ds, hi, lo);
        dh[j][q] = __float_as_uint(hi);
        dl[j][q] = __float_as_uint(lo);
      }
    }
    mbar_wait(bbars + 8 * sb, (i / NB) & 1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BQK / 8; ++ks)
      WgmmaTf32<DL>::rs(dva, pl[ks], desc_k_f32<DL, BQK>(sdoth, ks));
#pragma unroll
    for (int ks = 0; ks < BQK / 8; ++ks)
      WgmmaTf32<DL>::rs(dva, ph[ks], desc_k_f32<DL, BQK>(sdotl, ks));
#pragma unroll
    for (int ks = 0; ks < BQK / 8; ++ks)
      WgmmaTf32<DL>::rs(dva, ph[ks], desc_k_f32<DL, BQK>(sdoth, ks));
#pragma unroll
    for (int ks = 0; ks < BQK / 8; ++ks)
      WgmmaTf32<DL>::rs(dka, dl[ks], desc_k_f32<DL, BQK>(sqth, ks));
#pragma unroll
    for (int ks = 0; ks < BQK / 8; ++ks)
      WgmmaTf32<DL>::rs(dka, dh[ks], desc_k_f32<DL, BQK>(sqtl, ks));
#pragma unroll
    for (int ks = 0; ks < BQK / 8; ++ks)
      WgmmaTf32<DL>::rs(dka, dh[ks], desc_k_f32<DL, BQK>(sqth, ks));
    wgmma_commit();
    wgmma_wait_all();
    pin(dva);
    pin(dka);
    __syncthreads();   // every warp is past the B stage
    if (tid == 0 && i + NB < n_tiles) {
      fence_proxy_async();
      fill_b(i + NB);
    }
  }

  const int r0 = k0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= a.N) continue;
    const size_t off = ((size_t)bh * a.N + row) * D + col0 + c;
#pragma unroll
    for (int j = 0; j < DL / 8; ++j) {
      *reinterpret_cast<float2*>(dk + off + 8 * j) = make_float2(dka[4 * j + 2 * h], dka[4 * j + 2 * h + 1]);
      *reinterpret_cast<float2*>(dv + off + 8 * j) = make_float2(dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
    }
  }
}

// dQ of one (head, 64-query tile) on one warpgroup: Q and dO resident, the
// key tiles through the A and B rings. With CS = 2 a cluster of two CTAs
// shares the tile as in attention_bwd_dkv_tf32, S and dP summed over the two
// halves of D.
template <int D, int BK, int NA, int NB, int CS>
__device__ __forceinline__ void attention_bwd_dq_tf32(const F32DqMaps& m, const BwdRows& a,
                                                      float* __restrict__ dq) {
  constexpr int DL = D / CS, NCB = DL / F32_CB;
  using L = F32DqSmem<DL, BK, NA, NB, xchg_bytes<CS, BK / 2>()>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), base = (raw + 1023u) & ~1023u;
  float4* xch = reinterpret_cast<float4*>(smem_raw + (base - raw) + L::X0);
  const uint32_t sqh = base, sql = base + L::RB, sdoh = base + 2 * L::RB, sdol = base + 3 * L::RB;
  const uint32_t abars = base + L::BAR, bbars = abars + 8 * NA, rbar = bbars + 8 * NB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col0 = CS == 1 ? 0 : (int)cluster_rank() * DL;
  int bh, qt;
  head_tile(bh, qt);
  const int q0 = qt * BQ, n_tiles = (a.N + BK - 1) / BK;

  auto fill_a = [&](int i) {
    const int s = i % NA, k0 = i * BK;
    const uint32_t st = base + L::A0 + s * 4 * L::TB, full = abars + 8 * s;
    mbar_expect_tx(full, 4 * L::TB);
#pragma unroll
    for (int b = 0; b < NCB; ++b) {
      const int col = col0 + b * F32_CB;
      tma_load(st + b * BK * 128, &m.kh, full, col, k0, bh);
      tma_load(st + L::TB + b * BK * 128, &m.kl, full, col, k0, bh);
      tma_load(st + 2 * L::TB + b * BK * 128, &m.vh, full, col, k0, bh);
      tma_load(st + 3 * L::TB + b * BK * 128, &m.vl, full, col, k0, bh);
    }
  };
  auto fill_b = [&](int i) {
    const int s = i % NB, k0 = i * BK;
    const uint32_t st = base + L::B0 + s * 2 * L::TB, full = bbars + 8 * s;
    mbar_expect_tx(full, 2 * L::TB);
    tma_load(st, &m.kth, full, k0, col0, bh);
    tma_load(st + L::TB, &m.ktl, full, k0, col0, bh);
  };
  if (tid == 0) {
    for (int s = 0; s <= NA + NB; ++s) mbar_init(abars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (CS == 2) cluster_sync();   // the peer has started before its memory is written
  if (tid == 0) {
    mbar_expect_tx(rbar, 4 * L::RB);
#pragma unroll
    for (int b = 0; b < NCB; ++b) {
      const int col = col0 + b * F32_CB;
      tma_load(sqh + b * BQ * 128, &m.qh, rbar, col, q0, bh);
      tma_load(sql + b * BQ * 128, &m.ql, rbar, col, q0, bh);
      tma_load(sdoh + b * BQ * 128, &m.doh, rbar, col, q0, bh);
      tma_load(sdol + b * BQ * 128, &m.dol, rbar, col, q0, bh);
    }
    for (int i = 0; i < NA && i < n_tiles; ++i) fill_a(i);
    for (int i = 0; i < NB && i < n_tiles; ++i) fill_b(i);
  }

  float acc[DL / 2];
#pragma unroll
  for (int e = 0; e < DL / 2; ++e) acc[e] = 0.f;
  const int r0 = q0 + warp * 16 + (lane >> 2), c = 2 * (lane & 3);
  // rows r0 and r0 + 8 (< Np: the padded rows have P = 0)
  float lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lr[h] = a.lse2[(size_t)bh * a.Np + r0 + 8 * h];
    dr[h] = a.di[(size_t)bh * a.Np + r0 + 8 * h];
  }
  mbar_wait(rbar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int sa = i % NA, sb = i % NB, k0 = i * BK;
    const uint32_t skh = base + L::A0 + sa * 4 * L::TB, skl = skh + L::TB;
    const uint32_t svh = skh + 2 * L::TB, svl = skh + 3 * L::TB;
    const uint32_t skth = base + L::B0 + sb * 2 * L::TB, sktl = skth + L::TB;
    mbar_wait(abars + 8 * sa, (i / NA) & 1);

    float sc[BK / 2], dp[BK / 2];   // S, dP (unscaled): queries x keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DL / 8; ++kk)
      WgmmaTf32<BK>::ss(sc, desc_k_f32<BQ>(sql, kk), desc_k_f32<BK>(skh, kk), kk);
#pragma unroll
    for (int kk = 0; kk < DL / 8; ++kk)
      WgmmaTf32<BK>::ss(sc, desc_k_f32<BQ>(sqh, kk), desc_k_f32<BK>(skl, kk), 1);
#pragma unroll
    for (int kk = 0; kk < DL / 8; ++kk)
      WgmmaTf32<BK>::ss(sc, desc_k_f32<BQ>(sqh, kk), desc_k_f32<BK>(skh, kk), 1);
#pragma unroll
    for (int kk = 0; kk < DL / 8; ++kk)
      WgmmaTf32<BK>::ss(dp, desc_k_f32<BQ>(sdol, kk), desc_k_f32<BK>(svh, kk), kk);
#pragma unroll
    for (int kk = 0; kk < DL / 8; ++kk)
      WgmmaTf32<BK>::ss(dp, desc_k_f32<BQ>(sdoh, kk), desc_k_f32<BK>(svl, kk), 1);
#pragma unroll
    for (int kk = 0; kk < DL / 8; ++kk)
      WgmmaTf32<BK>::ss(dp, desc_k_f32<BQ>(sdoh, kk), desc_k_f32<BK>(svh, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);
    pin(dp);
    __syncthreads();   // every warp is past the A stage
    if (tid == 0 && i + NA < n_tiles) {
      fence_proxy_async();
      fill_a(i + NA);
    }
    if constexpr (CS == 2) cluster_sum(sc, dp, xch, i & 1);
    if (k0 + BK > a.N) {   // the ragged last tile: keys >= N take no weight
#pragma unroll
      for (int e = 0; e < BK / 2; ++e)
        if (k0 + 8 * (e / 4) + c + (e & 1) >= a.N) sc[e] = -INFINITY;
    }
    uint32_t dh[BK / 8][4], dl[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = frag_elem(j, q), h = q & 1;
        const float p = exp2f(fmaf(sc[e], a.scale_log2, -lr[h]));
        float hi, lo;
        tf32_split((dp[e] - dr[h]) * p * a.scale, hi, lo);
        dh[j][q] = __float_as_uint(hi);
        dl[j][q] = __float_as_uint(lo);
      }
    }
    mbar_wait(bbars + 8 * sb, (i / NB) & 1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) WgmmaTf32<DL>::rs(acc, dl[ks], desc_k_f32<DL, BK>(skth, ks));
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) WgmmaTf32<DL>::rs(acc, dh[ks], desc_k_f32<DL, BK>(sktl, ks));
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) WgmmaTf32<DL>::rs(acc, dh[ks], desc_k_f32<DL, BK>(skth, ks));
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    __syncthreads();   // every warp is past the B stage
    if (tid == 0 && i + NB < n_tiles) {
      fence_proxy_async();
      fill_b(i + NB);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= a.N) continue;
    float* out = dq + ((size_t)bh * a.N + row) * D + col0 + c;
#pragma unroll
    for (int j = 0; j < DL / 8; ++j)
      *reinterpret_cast<float2*>(out + 8 * j) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// ------------------------------------------------------------ host side

// The map of a contiguous (planes, rows, cols) fp32 tensor as (cols, rows,
// planes), with boxes of box_cols (32 or 16: a 128- or 64-byte swizzle) x
// box_rows of one plane; a box past a plane's last row or past cols is
// zero-filled.
inline bool make_map_f32(CUtensorMap* map, const void* ptr, int planes, int rows, int cols,
                         int box_cols, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 4, (cuuint64_t)rows * cols * 4};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw =
      box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches SPLIT (a __global__ wrapping tf32_split_kv) and then KERN (one
// wrapping attention_fwd_tf32<DP, BK, NS>, with the signature (tq, tkh, tkl,
// tvh, tvl, o, lse, Nq, Nk, D, scale_log2)) on q (BH, Nq, D), k and v (BH,
// Nk, D), o like q, fp32, contiguous and 16-byte aligned, D % 8 == 0; lse
// (BH, Nq) fp32 or null. scratch holds 2 BH D (Nk + Nkp) floats, Nkp =
// 8 ceil(Nk / 8): K hi, K lo, V^T hi, V^T lo.
template <int DP, int BK, int NS, auto SPLIT, auto KERN>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                       void* scratch, int BH, int Nq, int Nk, int D, float scale,
                       cudaStream_t stream) {
  using L = F32Smem<DP, BK, NS>;
  cudaError_t e = configure<KERN>(L::BYTES);
  if (e != cudaSuccess) return e;
  const int Nkp = (Nk + 7) / 8 * 8;
  float* kh = (float*)scratch;
  float* kl = kh + (size_t)BH * Nk * D;
  float* vth = kl + (size_t)BH * Nk * D;
  float* vtl = vth + (size_t)BH * D * Nkp;
  const auto split = SPLIT;
  split<<<dim3(BH, (Nkp + 31) / 32), 256, 0, stream>>>((const float*)k, (const float*)v, kh, kl,
                                                       vth, vtl, Nk, Nkp, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  CUtensorMap tq, tkh, tkl, tvh, tvl;
  if (!make_map_f32(&tq, q, BH, Nq, D, F32_CB, BQ) ||
      !make_map_f32(&tkh, kh, BH, Nk, D, F32_CB, BK) ||
      !make_map_f32(&tkl, kl, BH, Nk, D, F32_CB, BK) ||
      !make_map_f32(&tvh, vth, BH, D, Nkp, BK, DP) ||
      !make_map_f32(&tvl, vtl, BH, D, Nkp, BK, DP))
    return cudaErrorInvalidValue;
  const dim3 grid(BH, (Nq + BQ - 1) / BQ);
  const auto kern = KERN;
  kern<<<grid, THREADS, L::BYTES, stream>>>(tq, tkh, tkl, tvh, tvl, (float*)o, (float*)lse, Nq,
                                            Nk, D, scale * LOG2E);
  return cudaGetLastError();
}

// KERN on a grid (x, y, cs) of THREADS-thread blocks in clusters of (1, 1,
// cs) (cs = 1: no cluster)
template <auto KERN, typename... Args>
cudaError_t launch_clustered(dim3 grid, int cs, int smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid.x, grid.y, cs);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cs;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, KERN, args...);
}

// Launches PREP (a __global__ wrapping tf32_bwd_prep, 256 threads), then
// DKV (wrapping attention_bwd_dkv_tf32<D, BQK, NA, NB, CS>, (F32DkvMaps,
// BwdRows, dk, dv)) and DQ (wrapping attention_bwd_dq_tf32<D, BK, QNA, QNB,
// CS>, (F32DqMaps, BwdRows, dq)), in clusters of CS CTAs, on q, k, v, o,
// dout, dq, dk, dv (BH, N, D) fp32, lse (BH, N) fp32; scratch holds
// bwd_scratch_floats(BH, N, D).
template <int D, int BQK, int NA, int NB, int BK, int QNA, int QNB, int CS, auto PREP, auto DKV,
          auto DQ>
cudaError_t launch_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                           const void* lse, const void* dout, void* dq, void* dk, void* dv,
                           void* scratch, int BH, int N, float scale, cudaStream_t stream) {
  constexpr int DL = D / CS;
  using LKV = F32DkvSmem<DL, BQK, NA, NB, xchg_bytes<CS, BQK / 2>()>;
  using LQ = F32DqSmem<DL, BK, QNA, QNB, xchg_bytes<CS, BK / 2>()>;
  cudaError_t e = configure<DKV>(LKV::BYTES);
  if (e == cudaSuccess) e = configure<DQ>(LQ::BYTES);
  if (e != cudaSuccess) return e;
  const int Np = (N + 63) / 64 * 64, Nt = (N + 7) / 8 * 8;
  const F32Bwd s = bwd_scratch((float*)scratch, BH, N, D);
  const auto prep = PREP;
  prep<<<dim3(BH, Np / 32), 256, 0, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                               (const float*)o, (const float*)dout,
                                               (const float*)lse, s, N, Np, Nt, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  F32DkvMaps mk;
  F32DqMaps mq;
  auto rows = [&](CUtensorMap* m, const float* p, int box_rows) {
    return make_map_f32(m, p, BH, N, D, F32_CB, box_rows);
  };
  // a CTA's DL rows of the transposed tiles
  auto trans = [&](CUtensorMap* m, const float* p, int box_cols) {
    return make_map_f32(m, p, BH, D, Nt, box_cols, DL);
  };
  if (!rows(&mk.kh, s.kh, BQ) || !rows(&mk.kl, s.kl, BQ) || !rows(&mk.vh, s.vh, BQ) ||
      !rows(&mk.vl, s.vl, BQ) || !rows(&mk.qh, s.qh, BQK) || !rows(&mk.ql, s.ql, BQK) ||
      !rows(&mk.doh, s.doh, BQK) || !rows(&mk.dol, s.dol, BQK) || !trans(&mk.qth, s.qth, BQK) ||
      !trans(&mk.qtl, s.qtl, BQK) || !trans(&mk.doth, s.doth, BQK) ||
      !trans(&mk.dotl, s.dotl, BQK) || !rows(&mq.qh, s.qh, BQ) || !rows(&mq.ql, s.ql, BQ) ||
      !rows(&mq.doh, s.doh, BQ) || !rows(&mq.dol, s.dol, BQ) || !rows(&mq.kh, s.kh, BK) ||
      !rows(&mq.kl, s.kl, BK) || !rows(&mq.vh, s.vh, BK) || !rows(&mq.vl, s.vl, BK) ||
      !trans(&mq.kth, s.kth, BK) || !trans(&mq.ktl, s.ktl, BK))
    return cudaErrorInvalidValue;
  const BwdRows a{s.lse2, s.di, N, Np, D, scale, scale * LOG2E};
  const dim3 grid(BH, (N + BQ - 1) / BQ);
  e = launch_clustered<DKV>(grid, CS, LKV::BYTES, stream, mk, a, (float*)dk, (float*)dv);
  if (e != cudaSuccess) return e;
  return launch_clustered<DQ>(grid, CS, LQ::BYTES, stream, mq, a, (float*)dq);
}

}  // namespace sm90
}  // namespace a3r
