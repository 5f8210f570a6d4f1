// The fp32 operand policy of the attention core (sm90_attention.cuh): fp32
// attention on the tensor cores at fp32 accuracy, by 3xTF32 split products.
// K6's fp32 forward (small_attention.cu) runs it; K9's fp32 forward and
// backward are to take it next.
//
// 3xTF32. A TF32 product keeps 10 mantissa bits of each operand (unit
// roundoff 2^-11), which is not the fp32 function of the JAX package. Each
// fp32 operand x is split as hi = tf32(x) (cvt.rna: to nearest, ties away)
// and lo = tf32(x - hi); a product is lo hi + hi lo + hi hi with fp32
// accumulation (lo lo, below 2^-22 relative, is dropped), about 2^-21 of the
// product's magnitude: three wgmma.m64nNk8 tf32 products for each fp32 one.
//
// Forward. For q (BH, Nq, D) and k, v (BH, Nk, D) fp32, D <= DP (DP = 32, 64
// or 128), one block of one warpgroup per (head, 64-query tile):
//   - tf32_split_kv (a pre-pass) writes K's hi and lo (BH, Nk, D) and V^T's
//     (BH, D, Nkp), Nkp = 8 ceil(Nk / 8): TF32 operands in shared memory must
//     be K-major (wgmma has no transpose for tf32), and P V reduces over the
//     keys, so V is transposed. Within each group of 8 keys V^T holds them in
//     the order 0 2 4 6 1 3 5 7: an accumulator fragment holds keys (2t,
//     2t + 1) of a k8 slice where an A fragment wants (t, t + 4), so P's
//     fragments feed P V from registers with the keys permuted in the same
//     way on both operands. Keys >= Nk are zero.
//   - TMA brings Q once into the hi tile; the block splits it in place (lo
//     into the tile beside it, the same swizzled layout) and fences it for
//     the tensor cores. A ring of STAGES stages of BK = 32 keys (K hi and lo,
//     V^T hi and lo) streams behind full mbarriers; one thread refills a
//     stage after all four warps have passed its products, after a
//     fence.proxy.async.
//   - S = Q K^T as Q_lo K_hi + Q_hi K_lo + Q_hi K_hi (wgmma.m64n32k8, both
//     operands K-major in shared memory, 128-byte swizzle, 32 fp32 columns a
//     swizzle row), S in registers; keys >= Nk masked to -inf.
//   - One online-softmax pass: running row max m and sum l of the unrounded
//     p = exp2(s * D^-1/2 * log2(e) - m); O and l rescaled by
//     exp2(m_old - m_new). In fp32 the EXACT policy's "P rounded to v's
//     dtype" is the identity, so the running max gives the same function up
//     to fp32 rounding, and the exact-max pass (a third product) goes away.
//   - p split to hi and lo in registers: O += P_lo V_hi + P_hi V_lo +
//     P_hi V_hi (wgmma.m64n{DP}k8, A from registers, V^T K-major).
//   - The epilogue divides by l and stores fp32 O for rows < Nq.
//
// What bounds it on the H100: at (4, 16, 576, 64) the two products are
// 5.4 GFLOP, 16.3 GFLOP as 3xTF32 (33 us at 494.7 TFLOP/s dense TF32),
// against 38 MB of q, k, v and o (11 us at 3.35 TB/s); the pre-pass moves
// 57 MB (17 us). One warpgroup runs the products and the softmax in turns;
// at DP = 64 the block takes 97 KB of shared memory, so 2 blocks share an SM
// and one's softmax overlaps the other's products.
#pragma once

#include "sm90_attention.cuh"

namespace a3r {
namespace sm90 {

constexpr int F32_BK = 32;     // keys per stage
constexpr int F32_CB = 32;     // fp32 columns per 128-byte swizzle row

// The fp32 forward's shared memory: Q's hi and lo tiles (BQ x DP), then
// STAGES stages of K hi, K lo (BK x DP), V^T hi, V^T lo (DP x BK), then the
// STAGES full barriers and Q's. Each (rows x DP) tile is DP / 32 column
// blocks of rows x 128 bytes.
template <int DP>
struct F32Smem {
  static constexpr int QB = BQ * DP * 4;
  static constexpr int KB = F32_BK * DP * 4;
  static constexpr int K0 = 2 * QB;   // stage s: K0 + 4 s KB: K hi, K lo, V^T hi, V^T lo
  static constexpr int BAR = K0 + STAGES * 4 * KB;
  static constexpr int BYTES = BAR + (STAGES + 1) * 8 + 1024;   // + the base's alignment
  static_assert(QB % 1024 == 0 && KB % 1024 == 0, "tiles must keep 1024-byte alignment");
};

// K-major fp32 operand: a (ROWS x DP) tile reduced along DP, k8 slice kk (32
// bytes); 8-row groups 1024 bytes apart (128-byte swizzle)
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k_f32(uint32_t tile, int kk) {
  const int col = kk * 8;
  return make_desc(tile + (col / F32_CB) * ROWS * 128 + (col % F32_CB) * 4, 16, 1024, 1);
}

__device__ __forceinline__ int tf32_key_order(int pos) {   // V^T position -> key, per 8
  return pos < 4 ? 2 * pos : 2 * (pos - 4) + 1;
}

// The pre-pass: one block of 256 threads per (head, 32 keys). kh, kl like k;
// vth, vtl (BH, D, Nkp) with each group of 8 keys in tf32_key_order.
__device__ __forceinline__ void tf32_split_kv(const float* __restrict__ k,
                                              const float* __restrict__ v, float* __restrict__ kh,
                                              float* __restrict__ kl, float* __restrict__ vth,
                                              float* __restrict__ vtl, int Nk, int Nkp, int D) {
  __shared__ float vs[32][129];
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
// launch_f32() below: o = softmax(q k^T * scale) v in fp32, per head.
template <int DP>
__device__ __forceinline__ void attention_fwd_tf32(const CUtensorMap& tq, const CUtensorMap& tkh,
                                                   const CUtensorMap& tkl, const CUtensorMap& tvh,
                                                   const CUtensorMap& tvl, float* __restrict__ o,
                                                   int Nq, int Nk, int D, float scale_log2) {
  constexpr int BK = F32_BK, NCB = DP / F32_CB;
  using L = F32Smem<DP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), base = (raw + 1023u) & ~1023u;
  const uint32_t sqh = base, sql = base + L::QB, bars = base + L::BAR, qbar = bars + 8 * STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int bh, qt;
  head_tile(bh, qt);
  const int q0 = qt * BQ, n_tiles = (Nk + BK - 1) / BK;

  auto fill = [&](int i) {
    const int s = i % STAGES, k0 = i * BK;
    const uint32_t st = base + L::K0 + s * 4 * L::KB, full = bars + 8 * s;
    mbar_expect_tx(full, 4 * L::KB);
#pragma unroll
    for (int b = 0; b < NCB; ++b) {
      tma_load(st + b * BK * 128, &tkh, full, b * F32_CB, k0, bh);
      tma_load(st + L::KB + b * BK * 128, &tkl, full, b * F32_CB, k0, bh);
    }
    tma_load(st + 2 * L::KB, &tvh, full, k0, 0, bh);
    tma_load(st + 3 * L::KB, &tvl, full, k0, 0, bh);
  };
  if (tid == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, L::QB);
#pragma unroll
    for (int b = 0; b < NCB; ++b) tma_load(sqh + b * BQ * 128, &tq, qbar, b * F32_CB, q0, bh);
    for (int i = 0; i < STAGES && i < n_tiles; ++i) fill(i);
  }
  auto release = [&](int i) {
    __syncthreads();
    if (tid == 0 && i + STAGES < n_tiles) {
      fence_proxy_async();
      fill(i + STAGES);
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
    const int s = i % STAGES, k0 = i * BK;
    const uint32_t skh = base + L::K0 + s * 4 * L::KB, skl = skh + L::KB;
    const uint32_t svh = skh + 2 * L::KB, svl = skh + 3 * L::KB;
    mbar_wait(bars + 8 * s, (i / STAGES) & 1);

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
    // k8 slices: slice j's a[0..3] are sc[4j], sc[4j + 2], sc[4j + 1],
    // sc[4j + 3] (keys 2t and 2t + 1 as k = t and t + 4)
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int e = 4 * j + (a >> 1) + 2 * (a & 1), h = a & 1;
        const float p = exp2f(fmaf(sc[e], scale_log2, -m[h]));
        l[h] += p;
        const float hi = tf32_rna(p);
        ph[j][a] = __float_as_uint(hi);
        pl[j][a] = __float_as_uint(tf32_rna(p - hi));
      }
    }
    wgmma_fence();   // acc, ph and pl were written by ordinary instructions
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) WgmmaTf32<DP>::rs(acc, pl[ks], desc_k_f32<DP>(svh, ks));
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) WgmmaTf32<DP>::rs(acc, ph[ks], desc_k_f32<DP>(svl, ks));
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) WgmmaTf32<DP>::rs(acc, ph[ks], desc_k_f32<DP>(svh, ks));
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    release(i);
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
  }
}

// ------------------------------------------------------------ host side

// The map of a contiguous (planes, rows, cols) fp32 tensor as (cols, rows,
// planes), with boxes of box_cols (<= 32) x box_rows of one plane and a
// 128-byte swizzle; a box past a plane's last row or past cols is
// zero-filled.
inline bool make_map_f32(CUtensorMap* map, const void* ptr, int planes, int rows, int cols,
                         int box_cols, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 4, (cuuint64_t)rows * cols * 4};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches SPLIT (a __global__ wrapping tf32_split_kv) and then KERN (one
// wrapping attention_fwd_tf32<DP>, with the signature (tq, tkh, tkl, tvh,
// tvl, o, Nq, Nk, D, scale_log2)) on q (BH, Nq, D), k and v (BH, Nk, D), o
// like q, fp32, contiguous and 16-byte aligned, D % 8 == 0. scratch holds
// 2 BH D (Nk + Nkp) floats, Nkp = 8 ceil(Nk / 8): K hi, K lo, V^T hi, V^T lo.

template <int DP, auto SPLIT, auto KERN>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, void* scratch,
                       int BH, int Nq, int Nk, int D, float scale, cudaStream_t stream) {
  using L = F32Smem<DP>;
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
      !make_map_f32(&tkh, kh, BH, Nk, D, F32_CB, F32_BK) ||
      !make_map_f32(&tkl, kl, BH, Nk, D, F32_CB, F32_BK) ||
      !make_map_f32(&tvh, vth, BH, D, Nkp, F32_BK, DP) ||
      !make_map_f32(&tvl, vtl, BH, D, Nkp, F32_BK, DP))
    return cudaErrorInvalidValue;
  const dim3 grid(BH, (Nq + BQ - 1) / BQ);
  const auto kern = KERN;
  kern<<<grid, THREADS, L::BYTES, stream>>>(tq, tkh, tkl, tvh, tvl, (float*)o, Nq, Nk, D,
                                            scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace a3r
