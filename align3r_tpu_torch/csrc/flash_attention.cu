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
//   fp32 forward and backward: the fp32 operand policy of the same core
//     (sm90_attention_tf32.cuh), every product as three TF32 wgmma products of
//     split operands (3xTF32, about 2^-21 relative). The forward is K6's fp32
//     body with the log-sum-exp stored: one online pass (in fp32 the rounding
//     of P is the identity), a pre-pass that splits K and writes V^T split,
//     32-key stages at D = 64 and 128; at D = 256, where Q's hi and lo alone
//     take 128 KB, 16-key stages, one each of K and V^T. The backward keeps
//     the bf16 roles (dK/dV per 64-key tile, dQ per 64-query tile), each with
//     two rings: the tiles reduced over D (Q and dO, or K and V) and the
//     transposed tiles reduced over queries or keys (Q^T and dO^T, or K^T),
//     which a pre-pass writes split with Di and lse2, since TF32 wgmma has no
//     transpose. At D = 256 the resident tiles in hi and lo would take
//     256 KB, so each block is a cluster of two CTAs, each holding half of
//     D's columns (the D = 128 kernels' tiles) and summing S and dP's
//     partials with its peer through distributed shared memory.
#include "common.cuh"
#include "sm90_attention.cuh"
#include "sm90_attention_tf32.cuh"

#include <type_traits>

namespace a3r {
namespace fa {

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

// the split pre-pass of K and V^T (sm90::tf32_split_kv), D <= DMAX
template <int DMAX>
__global__ void __launch_bounds__(256)
flash_fwd_tf32_split(const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ kh, float* __restrict__ kl, float* __restrict__ vth,
                     float* __restrict__ vtl, int Nk, int Nkp, int D) {
  sm90::tf32_split_kv<DMAX>(k, v, kh, kl, vth, vtl, Nk, Nkp, D);
}

// the fp32 operand policy (3xTF32) with the log-sum-exp; MINB blocks per SM
template <int DP, int BK, int NS, int MINB>
__global__ void __launch_bounds__(sm90::THREADS, MINB)
flash_fwd_tf32(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tkh,
               const __grid_constant__ CUtensorMap tkl, const __grid_constant__ CUtensorMap tvh,
               const __grid_constant__ CUtensorMap tvl, float* __restrict__ o,
               float* __restrict__ lse, int Nq, int Nk, int D, float scale_log2) {
  sm90::attention_fwd_tf32<DP, BK, NS>(tq, tkh, tkl, tvh, tvl, o, lse, Nq, Nk, D, scale_log2);
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

// the pre-pass (sm90::tf32_bwd_prep): Di, lse2, the split rows and transposes
template <int DMAX>
__global__ void __launch_bounds__(256)
flash_bwd_prep_tf32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const sm90::F32Bwd s, int N, int Np, int Nt, int D) {
  sm90::tf32_bwd_prep<DMAX>(q, k, v, o, dout, lse, s, N, Np, Nt, D);
}

// dK/dV per (head, 64-key tile) and dQ per (head, 64-query tile) on the fp32
// operand policy, on clusters of CS CTAs each holding D / CS columns
template <int D, int BQK, int NA, int NB, int CS>
__global__ void __launch_bounds__(sm90::THREADS, 1)
flash_bwd_dkv_tf32(const __grid_constant__ sm90::F32DkvMaps maps, const sm90::BwdRows rows,
                   float* __restrict__ dk, float* __restrict__ dv) {
  sm90::attention_bwd_dkv_tf32<D, BQK, NA, NB, CS>(maps, rows, dk, dv);
}

template <int D, int BK, int NA, int NB, int CS>
__global__ void __launch_bounds__(sm90::THREADS, 1)
flash_bwd_dq_tf32(const __grid_constant__ sm90::F32DqMaps maps, const sm90::BwdRows rows,
                  float* __restrict__ dq) {
  sm90::attention_bwd_dq_tf32<D, BK, NA, NB, CS>(maps, rows, dq);
}

// ------------------------------------------------------------------ launch

// Tile sizes. The forward's BK (keys a stage) is the key-block width of the
// plain version in ops/flash_attention.py (block_k(); the CPU tests read it
// from this text). bf16: 128 keys at D = 64; at D = 128 and 256, 64, where a
// 128-key ring leaves one block per SM (D = 128) or O takes 128 registers a
// thread (D = 256). FWD_BLOCKS is the forward's blocks per SM. The sm90
// backward takes 64 keys by SM90_Q queries in dK/dV (32 at D = 128 and 256,
// where a 64-query S^T and dP^T beside dK and dV would spill) on SM90_WG
// warpgroups (2 at D = 256: 128 of dK's and dV's columns each), and SM90_QT
// tiles of 64 queries by SM90_K keys in dQ (at D = 256 two query tiles, a
// warpgroup each, and 32 keys, beside dQ's 128 accumulator registers);
// DKV_BLOCKS and DQ_BLOCKS are their blocks per SM.
// fp32 (3xTF32): 32 keys a stage and FWD_NS stages each of K and V^T (16 and
// one at D = 256, where Q's hi and lo take 128 KB). The backward runs on
// clusters of CS CTAs, each holding D / CS columns (2 at D = 256, whose
// resident K and V, or Q and dO, would take 256 KB): dK/dV 64 keys by KV_Q
// queries (16 where a CTA holds 128 columns), KV_NA stages of Q and dO, KV_NB
// of Q^T and dO^T; dQ 64 queries by DQ_K keys, DQ_NA stages of K and V, DQ_NB
// of K^T; one block an SM (160-226 KB).
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
  static constexpr int BK = D == 256 ? 16 : 32;
  static constexpr int FWD_NS = D == 256 ? 1 : 2;
  static constexpr int FWD_BLOCKS = D == 64 ? 2 : 1;
  static constexpr int CS = D == 256 ? 2 : 1;
  static constexpr int KV_Q = D == 64 ? 32 : 16;
  static constexpr int KV_NA = D == 256 ? 1 : 2, KV_NB = D == 64 ? 2 : 1;
  static constexpr int DQ_K = D == 64 ? 32 : 16;
  static constexpr int DQ_NA = 2, DQ_NB = D == 256 ? 1 : 2;
};

// fp32 forward: scratch of 2 BH D (N + Nkp) floats (K and V^T split)
template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                       void* scratch, int BH, int N, float scale, cudaStream_t s) {
  using Tl = Tiles<T, D>;
  if constexpr (std::is_same<T, bf16>::value) {
    return sm90::launch<D, Tl::BK, flash_fwd_sm90<D, Tl::BK, Tl::FWD_BLOCKS>>(
        q, k, v, o, lse, BH, N, N, D, scale, s);
  } else {
    return sm90::launch_f32<D, Tl::BK, Tl::FWD_NS, flash_fwd_tf32_split<D == 256 ? 256 : 128>,
                            flash_fwd_tf32<D, Tl::BK, Tl::FWD_NS, Tl::FWD_BLOCKS>>(
        q, k, v, o, lse, scratch, BH, N, N, D, scale, s);
  }
}

template <typename T>
cudaError_t fwd_by_d(int D, const void* q, const void* k, const void* v, void* o,
                     void* lse, void* scratch, int BH, int N, float scale, cudaStream_t s) {
  if (D == 64) return launch_fwd<T, 64>(q, k, v, o, lse, scratch, BH, N, scale, s);
  if (D == 128) return launch_fwd<T, 128>(q, k, v, o, lse, scratch, BH, N, scale, s);
  return launch_fwd<T, 256>(q, k, v, o, lse, scratch, BH, N, scale, s);
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

// The fp32 backward on the TF32 policy: the pre-pass, then dK/dV and dQ;
// scratch holds sm90::bwd_scratch_floats(BH, N, D).
template <int D>
cudaError_t launch_bwd_tf32(const void* q, const void* k, const void* v, const void* o,
                            const void* lse, const void* dout, void* dq, void* dk, void* dv,
                            void* scratch, int BH, int N, float scale, cudaStream_t s) {
  using Tl = Tiles<float, D>;
  return sm90::launch_bwd_f32<D, Tl::KV_Q, Tl::KV_NA, Tl::KV_NB, Tl::DQ_K, Tl::DQ_NA, Tl::DQ_NB,
                              Tl::CS, flash_bwd_prep_tf32<D>,
                              flash_bwd_dkv_tf32<D, Tl::KV_Q, Tl::KV_NA, Tl::KV_NB, Tl::CS>,
                              flash_bwd_dq_tf32<D, Tl::DQ_K, Tl::DQ_NA, Tl::DQ_NB, Tl::CS>>(
      q, k, v, o, lse, dout, dq, dk, dv, scratch, BH, N, scale, s);
}

cudaError_t bwd_f32(int D, const void* q, const void* k, const void* v, const void* o,
                    const void* lse, const void* dout, void* dq, void* dk, void* dv,
                    void* scratch, int BH, int N, float scale, cudaStream_t s) {
  if (D == 64)
    return launch_bwd_tf32<64>(q, k, v, o, lse, dout, dq, dk, dv, scratch, BH, N, scale, s);
  if (D == 128)
    return launch_bwd_tf32<128>(q, k, v, o, lse, dout, dq, dk, dv, scratch, BH, N, scale, s);
  return launch_bwd_tf32<256>(q, k, v, o, lse, dout, dq, dk, dv, scratch, BH, N, scale, s);
}

bool bad_args(int BH, int N, int D) {
  return BH <= 0 || N <= 0 || !(D == 64 || D == 128 || D == 256) || (N + 31) / 32 > 65535;
}

}  // namespace fa
}  // namespace a3r

using namespace a3r::fa;

// q, k, v, o (BH, N, D) in one dtype (bf16 or fp32), contiguous and 16-byte
// aligned; lse (BH, N) fp32; scratch: fp32 2 BH D (N + Nkp) floats, Nkp =
// 8 ceil(N / 8) (K and V^T split to TF32 hi and lo); bf16 none.
A3R_EXPORT int a3r_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, void* scratch, int BH, int N, int D, int is_bf16,
                             float scale, void* stream) {
  if (bad_args(BH, N, D) || (!is_bf16 && scratch == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_bf16 ? fwd_by_d<bf16>(D, q, k, v, o, lse, nullptr, BH, N, scale, s)
                       : fwd_by_d<float>(D, q, k, v, o, lse, scratch, BH, N, scale, s));
}

// dq, dk, dv (BH, N, D) in the inputs' dtype; scratch: bf16 2 BH Np fp32,
// Np = 64 * ceil(N / 64) (Di and lse2); fp32 sm90::bwd_scratch_floats(BH, N,
// D): BH (2 Np + 8 N D + 6 D Nt), Nt = 8 ceil(N / 8).
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
