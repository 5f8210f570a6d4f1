// K3 / K4: the fused edge-residual loss of the global-alignment solve.
//
// Replaces align3r_tpu/ops/edge_loss.py:
//   K3  _fwd_call (:303-324) -> _fwd_kernel (:172) / _fwd_kernel_chunked (:197)
//       loss = sum_e sum_a w[e,a] * safe_norm(proj[idx[e],:,a] - M[e] [pred[e,:,a]; 1])
//   K4  _bwd_call (:327-357) -> _bwd_kernel (:207) / _bwd_kernel_chunked
//       (:214) / _bwd_body (:227)
//       dproj[n,:,a] = sum_{e: idx[e]=n} g w r/||r||   (0 where ||r||^2 <= 1e-12)
//       dM[e]        = -sum_a u[e,:,a] [pred[e,:,a]; 1]^T
//   M is the folded Sim(3) + xyz adaptor matrix, one (3, 4) per edge term.
//   safe_norm: a distance of 0 where ||r||^2 = 0 (forward), a zero gradient
//   where ||r||^2 <= EDGE_EPS (backward). All arithmetic is fp32.
//
// A scene axis (the batched multi-scene solve, alignment/batched.py): S
// scenes of n images each are laid end to end, n S images, with each scene's
// terms, CSR entries and offsets after the previous scene's. The walk is the
// same; K3's second pass writes one loss per scene, the sum of its scene's
// contiguous (tile, image) partials, and K4 reads the upstream gradient
// g[image / n]. S = 1 is the single-scene kernel, bit for bit.
//
// Layout: observations packed once per solve, channel-major (e2, 3, A) in
// bf16 or fp32 with A contiguous, weights (e2, A); proj (n, 3, A) fp32; a
// CSR of each image's terms (order (e2,), offsets (n + 1,), term_csr).
//
// What bounds it on the H100: bytes. At 24 frames (n = 24, e2 = 380 terms,
// A = 147,456) a call must read proj once (42 MB), pred and w (448 MB in
// bf16, 896 MB in fp32) and the 3x4 matrices; K4 also writes dproj (42 MB):
// 0.146 / 0.280 ms for K3 and 0.159 / 0.293 ms for K4 at 3.35 TB/s. The
// arithmetic (about 30 fp32 operations a term-pixel forward, 60 backward)
// is a fifth of that time at the fp32 peak.
//
// The design (one walk for both kernels):
//   - a block owns a (1,024-pixel tile, image) pair, one block per pair
//     (144 x 24 = 3,456 at the main path). Its 256 threads own 4 pixels
//     each and load the image's proj tile once into registers with 16-byte
//     loads; then they walk the image's terms through the CSR. proj is read
//     from device memory once a call, not once a term;
//   - each term's pred tile (3 channels), w tile and 3x4 matrix come through
//     a ring of STAGES shared-memory stages filled by 1-D bulk copies on
//     mbarriers. Thread 0 keeps the ring STAGES terms ahead: once the block
//     has read term i out of its stage it issues term i + STAGES there. A
//     warp reads its vectors of a stage into registers (8 bytes a channel in
//     bf16, 16 in fp32) and frees the stage before its arithmetic. A bf16
//     stage is 8 KB (fp32 16 KB): 4 bf16 stages (3 fp32) and 3 blocks an SM
//     keep 96-144 KB in flight an SM;
//   - K3 sums w d in registers over the walk and writes one partial per
//     block. K4 sums dproj in registers over the walk and stores it once with
//     16-byte stores (zeros for an image with no terms); each warp
//     reduce-scatters its 12 dM products across lanes (16 shuffles, not 12
//     full warp sums) into a shared-memory slot per (term, warp), and the
//     block meets once at the end of the walk (every EMAXT terms on a longer
//     walk) to write one 12-value partial per (term, tile);
//   - second passes in a fixed order, deterministic without atomics on the
//     values: K3's partials by EBLOCK_SUM-value blocks (14 at the main
//     path), the last block to finish (a ticket the main kernel zeroes)
//     summing the blocks' sums in block order; K4's dM by one warp per
//     (term, value) over its tiles (4,560 warps on 570 blocks);
//   - a tile past the end of A, or any tile when rows are not 16-byte
//     aligned (odd A; the wrapper checks), takes an element-load path inside
//     the same kernel: direct loads from device memory, masked, no ring.
// Tuning (H100 80GB HBM3, 700 W; PERF.md, Findings): K4 in bf16 is bound by its
// arithmetic, not its bytes. 4 pixels a thread (80 registers, 3 blocks an
// SM) ran it 10% faster than 8 (128 registers, 2 blocks an SM) and K3 4%;
// 4 blocks an SM spilled; 6 bf16 stages gained nothing over 4. One block
// per pair, not a persistent grid: the hardware hands the next pair to the
// first free slot, which balances images of 10 to 20 terms.
#include "sm90_ptx.cuh"

namespace a3r {

constexpr float EDGE_EPS = 1e-12f;    // must match geometry.core.safe_norm
constexpr int ETHREADS = 256;         // threads a block (8 warps)
constexpr int EWARPS = ETHREADS / 32;
constexpr int EPT = 4;                // pixels a thread
constexpr int ETILE = ETHREADS * EPT; // pixels a block
constexpr int ESTAGES_BF16 = 4;       // ring stages, bf16 observations
constexpr int ESTAGES_F32 = 3;        // ring stages, fp32 observations
constexpr int EMAXT = 32;             // K4: terms between meetings of the block
constexpr int EMIN_BLOCKS = 3;        // blocks an SM the registers must allow
constexpr int EBLOCK_SUM = 256;       // K3's second pass: partials a block

template <typename T>
struct EdgeCfg {
  static constexpr int VB = EPT * sizeof(T);      // bytes of a thread's pixels in a row
  static constexpr int STAGES = sizeof(T) == 2 ? ESTAGES_BF16 : ESTAGES_F32;
  static constexpr int ROW = ETILE * sizeof(T);   // bytes of one row's tile
  static constexpr int MAT = 4 * ROW;             // the 3x4 matrix after pred[3], w
  static constexpr int STAGE = 4 * ROW + 64;
  static constexpr int TX = 4 * ROW + 48;         // bytes the copies bring a stage
  static constexpr int BAR = STAGES * STAGE;      // full[S], empty[S]
  static constexpr int RED = BAR + 16 * STAGES;   // K3: the block's warp sums
  static constexpr int SLOTS = RED;               // K4: dM slots
  static constexpr int FWD_SMEM = RED + EWARPS * 4;
  static constexpr int BWD_SMEM = SLOTS + EMAXT * EWARPS * 12 * 4;
};
// thread t owns pixels 4 t .. 4 t + 3 of the tile: one 8-byte (bf16) or
// 16-byte (fp32) vector of a stage's row, one float4 of proj and dproj
static_assert(EPT == 4, "a thread's pixels are one float4 of proj and dproj a row");

// a vector of VB bytes from shared memory as 32-bit words
template <int VB>
__device__ __forceinline__ void load_words(const unsigned char* p, uint32_t (&v)[VB / 4]) {
  if constexpr (VB == 16) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
}

template <int W>
__device__ __forceinline__ void unpack(const uint32_t (&v)[W], float* out, bf16) {
#pragma unroll
  for (int q = 0; q < W; ++q) {
    out[2 * q] = __uint_as_float(v[q] << 16);
    out[2 * q + 1] = __uint_as_float(v[q] & 0xffff0000u);
  }
}
template <int W>
__device__ __forceinline__ void unpack(const uint32_t (&v)[W], float* out, float) {
#pragma unroll
  for (int q = 0; q < W; ++q) out[q] = __uint_as_float(v[q]);
}

template <typename T>
struct EdgeArgs {
  const float* proj;     // (n, 3, A)
  const float* pw34;     // (e2, 12)
  const T* pred;         // (e2, 3, A)
  const T* w;            // (e2, A)
  const int* order;      // (e2,) terms by image
  const int* offsets;    // (n + 1,)
  const float* g;        // K4: upstream gradient, one a scene (S,)
  float* partials;       // K3: (n, tiles); K4: dM partials (e2, 12, tiles)
  float* dproj;          // K4: (n, 3, A)
  unsigned* ticket;      // K3: zeroed here for the second pass
  int A, tiles, vec;
  int n_scene;           // images a scene (K4: scene of an image = image / n_scene)
};

// a tile goes through the ring when it is whole and every row is 16-byte aligned
__device__ __forceinline__ bool ring_tile(int tile, int A, int vec) {
  return vec && (long long)(tile + 1) * ETILE <= A;
}

// Term i of the walk (CSR entry t) into ring stage i % STAGES, once the
// block has read term i - STAGES out of it: five bulk copies, one thread.
template <typename T>
__device__ __forceinline__ void issue(const EdgeArgs<T>& a, uint32_t base, int t, int i,
                                      long long a0) {
  using C = EdgeCfg<T>;
  const int s = i % C::STAGES, e = a.order[t];
  const uint32_t full = base + C::BAR + 8 * s;
  if (i >= C::STAGES) {
    sm90::mbar_wait(base + C::BAR + 8 * (C::STAGES + s), (i / C::STAGES - 1) & 1);
    // the block's reads of the stage (generic proxy) before the copy
    // engine's writes (async proxy): without this fence a few warps a call
    // read values of the term STAGES ahead (measured; PERF.md, Findings)
    sm90::fence_proxy_async();
  }
  const uint32_t st = base + s * C::STAGE;
  sm90::mbar_expect_tx(full, C::TX);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    sm90::bulk_load(st + c * C::ROW, a.pred + ((long long)e * 3 + c) * a.A + a0, C::ROW, full);
  sm90::bulk_load(st + 3 * C::ROW, a.w + (long long)e * a.A + a0, C::ROW, full);
  sm90::bulk_load(st + C::MAT, a.pw34 + (long long)e * 12, 48, full);
}

// The ring's set-up: thread 0 inits the barriers and issues the walk's first
// STAGES terms.
template <typename T>
__device__ __forceinline__ void ring_start(const EdgeArgs<T>& a, uint32_t base, bool ring,
                                           int t0, int t1, long long a0) {
  using C = EdgeCfg<T>;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      sm90::mbar_init(base + C::BAR + 8 * s, 1);
      sm90::mbar_init(base + C::BAR + 8 * (C::STAGES + s), EWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (ring)
      for (int i = 0; i < C::STAGES && t0 + i < t1; ++i) issue(a, base, t0 + i, i, a0);
  }
  __syncthreads();
}

// One term's pred (3 x EPT), w (EPT) and matrix for thread `tid`: from ring
// stage i of the walk (freed once read), or, on the element path, straight
// from device memory (0 past A).
template <typename T>
__device__ __forceinline__ void term_values(const EdgeArgs<T>& a, const unsigned char* smem,
                                            uint32_t base, bool ring, int i, int e,
                                            long long a0, int tid, float (&p)[3][EPT],
                                            float (&w)[EPT], float (&m)[12]) {
  using C = EdgeCfg<T>;
  if (ring) {
    const int s = i % C::STAGES;
    sm90::mbar_wait(base + C::BAR + 8 * s, (i / C::STAGES) & 1);
    const unsigned char* st = smem + s * C::STAGE;
    uint32_t raw[4][C::VB / 4];
#pragma unroll
    for (int r = 0; r < 4; ++r) load_words<C::VB>(st + r * C::ROW + tid * C::VB, raw[r]);
    const float4* mm = reinterpret_cast<const float4*>(st + C::MAT);
    const float4 m0 = mm[0], m1 = mm[1], m2 = mm[2];
    __syncwarp();
    if ((tid & 31) == 0) sm90::mbar_arrive(base + C::BAR + 8 * (C::STAGES + s));
    m[0] = m0.x; m[1] = m0.y; m[2] = m0.z; m[3] = m0.w;
    m[4] = m1.x; m[5] = m1.y; m[6] = m1.z; m[7] = m1.w;
    m[8] = m2.x; m[9] = m2.y; m[10] = m2.z; m[11] = m2.w;
#pragma unroll
    for (int c = 0; c < 3; ++c) unpack(raw[c], p[c], T());
    unpack(raw[3], w, T());
  } else {
#pragma unroll
    for (int k = 0; k < 12; ++k) m[k] = __ldg(a.pw34 + (long long)e * 12 + k);
    const T* pd = a.pred + (long long)e * 3 * a.A;
    const T* ww = a.w + (long long)e * a.A;
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      const long long px = a0 + tid * EPT + k;
      const bool in = px < a.A;
#pragma unroll
      for (int c = 0; c < 3; ++c) p[c][k] = in ? to_f32(pd[c * (long long)a.A + px]) : 0.f;
      w[k] = in ? to_f32(ww[px]) : 0.f;
    }
  }
}

// the image's proj tile into registers (0 past A)
template <typename T>
__device__ __forceinline__ void load_proj(const EdgeArgs<T>& a, int img, long long a0, bool ring,
                                          int tid, float (&pv)[3][EPT]) {
  const float* src = a.proj + (long long)img * 3 * a.A + a0 + tid * EPT;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (ring) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src + c * (long long)a.A));
      pv[c][0] = v.x; pv[c][1] = v.y; pv[c][2] = v.z; pv[c][3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < EPT; ++k)
        pv[c][k] = a0 + tid * EPT + k < a.A ? __ldg(src + c * (long long)a.A + k) : 0.f;
    }
  }
}

// the residual r = pv - M [p; 1] of pixel k and its squared norm
__device__ __forceinline__ float residual(const float (&pv)[3][EPT], const float (&p)[3][EPT],
                                          const float (&m)[12], int k, float (&r)[3]) {
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r[c] = pv[c][k] - (m[4 * c] * p[0][k] + m[4 * c + 1] * p[1][k] + m[4 * c + 2] * p[2][k] +
                       m[4 * c + 3]);
    sq += r[c] * r[c];
  }
  return sq;
}

template <typename T>
__global__ void __launch_bounds__(ETHREADS, EMIN_BLOCKS)
edge_fwd_kernel(const EdgeArgs<T> a) {
  using C = EdgeCfg<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = sm90::smem_addr(smem);
  const int tid = threadIdx.x;
  const int img = blockIdx.x / a.tiles, tile = blockIdx.x % a.tiles;
  const bool ring = ring_tile(tile, a.A, a.vec);
  const long long a0 = (long long)tile * ETILE;
  const int t0 = a.offsets[img], t1 = a.offsets[img + 1];
  if (tid == 0 && blockIdx.x == 0) *a.ticket = 0u;
  ring_start(a, base, ring, t0, t1, a0);
  float pv[3][EPT];
  load_proj(a, img, a0, ring, tid, pv);
  float acc = 0.f;
  for (int t = t0; t < t1; ++t) {
    float p[3][EPT], w[EPT], m[12];
    term_values(a, smem, base, ring, t - t0, ring ? 0 : a.order[t], a0, tid, p, w, m);
    if (ring && tid == 0 && t + C::STAGES < t1) issue(a, base, t + C::STAGES, t - t0 + C::STAGES, a0);
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      float r[3];
      const float sq = residual(pv, p, m, k, r);
      const float d = sq > 0.f ? sqrtf(fmaxf(sq, EDGE_EPS)) : 0.f;
      acc += w[k] * d;
    }
  }
  float* red = reinterpret_cast<float*>(smem + C::RED);
  acc = warp_sum(acc);
  if ((tid & 31) == 0) red[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < EWARPS; ++k) s += red[k];
    a.partials[blockIdx.x] = s;
  }
}

// K3's second pass, one grid row a scene (blockIdx.y): block b of scene z
// sums the scene's partials [b EBLOCK_SUM, (b + 1) EBLOCK_SUM) of its P in a
// fixed order; the last block to finish sums each scene's block sums in block
// order into out[z], one warp a scene. The ticket was zeroed by the main
// kernel.
__global__ void __launch_bounds__(EBLOCK_SUM)
edge_loss_sum(const float* __restrict__ partials, int P, float* __restrict__ level,
              unsigned* __restrict__ ticket, float* __restrict__ out) {
  __shared__ float red[EBLOCK_SUM / 32];
  __shared__ bool last;
  const int tid = threadIdx.x, z = blockIdx.y, nb = gridDim.x;
  const int i = blockIdx.x * EBLOCK_SUM + tid;
  float v = warp_sum(i < P ? partials[(long long)z * P + i] : 0.f);
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < EBLOCK_SUM / 32; ++k) s += red[k];
    level[z * nb + blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(ticket, 1u) == nb * gridDim.y - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int lane = tid & 31;
  for (int sc = tid >> 5; sc < (int)gridDim.y; sc += EBLOCK_SUM / 32) {
    float s = 0.f;
    for (int b = lane; b < nb; b += 32) s += __ldcg(level + sc * nb + b);
    s = warp_sum(s);
    if (lane == 0) out[sc] = s;
  }
}

// One step of the reduce-scatter below: a lane keeps H of its 2 H values
// (the upper half where lane bit O is set), sends its partner (lane ^ O) the
// half the partner keeps, and adds the half it receives.
template <int O, int H>
__device__ __forceinline__ void scatter_step(float (&v)[16], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = up ? v[k] : v[k + H];
    v[k] = (up ? v[k + H] : v[k]) + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// K4's dM products of one warp: 12 values a lane in; lanes 2 k and 2 k + 1
// hold the warp's sum of value k out (16 shuffles; 12 warp sums take 60)
__device__ __forceinline__ float reduce_scatter12(const float (&dm)[12], int lane) {
  float v[16];
#pragma unroll
  for (int k = 0; k < 12; ++k) v[k] = dm[k];
#pragma unroll
  for (int k = 12; k < 16; ++k) v[k] = 0.f;
  scatter_step<16, 8>(v, lane);
  scatter_step<8, 4>(v, lane);
  scatter_step<4, 2>(v, lane);
  scatter_step<2, 1>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

template <typename T>
__global__ void __launch_bounds__(ETHREADS, EMIN_BLOCKS)
edge_bwd_kernel(const EdgeArgs<T> a) {
  using C = EdgeCfg<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = sm90::smem_addr(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int img = blockIdx.x / a.tiles, tile = blockIdx.x % a.tiles;
  const bool ring = ring_tile(tile, a.A, a.vec);
  const long long a0 = (long long)tile * ETILE;
  const int t0 = a.offsets[img], t1 = a.offsets[img + 1];
  ring_start(a, base, ring, t0, t1, a0);
  const float gg = a.g[img / a.n_scene];
  float pv[3][EPT], acc[3][EPT];
  load_proj(a, img, a0, ring, tid, pv);
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int k = 0; k < EPT; ++k) acc[c][k] = 0.f;
  float* slots = reinterpret_cast<float*>(smem + C::SLOTS);   // [EMAXT][EWARPS][12]
  for (int t = t0; t < t1; ++t) {
    float p[3][EPT], w[EPT], m[12], dm[12];
    term_values(a, smem, base, ring, t - t0, ring ? 0 : a.order[t], a0, tid, p, w, m);
    if (ring && tid == 0 && t + C::STAGES < t1) issue(a, base, t + C::STAGES, t - t0 + C::STAGES, a0);
#pragma unroll
    for (int k = 0; k < 12; ++k) dm[k] = 0.f;
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      float r[3];
      const float sq = residual(pv, p, m, k, r);
      const float scale = sq > EDGE_EPS ? gg * w[k] * rsqrtf(sq) : 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float u = scale * r[c];
        acc[c][k] += u;
        dm[4 * c] -= u * p[0][k];
        dm[4 * c + 1] -= u * p[1][k];
        dm[4 * c + 2] -= u * p[2][k];
        dm[4 * c + 3] -= u;
      }
    }
    const int j = (t - t0) % EMAXT;
    const float v = reduce_scatter12(dm, lane);
    if (!(lane & 1) && lane < 24) slots[(j * EWARPS + warp) * 12 + (lane >> 1)] = v;
    if (j == EMAXT - 1 || t == t1 - 1) {
      // the block meets: one 12-value partial per (term, tile), warps in order
      __syncthreads();
      const int tb = t - j;
      for (int q = tid; q < (j + 1) * 12; q += ETHREADS) {
        const int jj = q / 12, k = q % 12;
        float s = 0.f;
#pragma unroll
        for (int wp = 0; wp < EWARPS; ++wp) s += slots[(jj * EWARPS + wp) * 12 + k];
        const int e = a.order[tb + jj];
        a.partials[((long long)e * 12 + k) * a.tiles + tile] = s;
      }
      __syncthreads();
    }
  }
  float* dp = a.dproj + (long long)img * 3 * a.A + a0 + tid * EPT;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (ring) {
      *reinterpret_cast<float4*>(dp + c * (long long)a.A) =
          make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
    } else {
#pragma unroll
      for (int k = 0; k < EPT; ++k)
        if (a0 + tid * EPT + k < a.A) dp[c * (long long)a.A + k] = acc[c][k];
    }
  }
}

// K4's second pass: dM[e, k] = the (term, value)'s partials summed over its
// tiles, one warp each, lane-strided then a fixed shuffle tree
__global__ void __launch_bounds__(256)
edge_dm_sum(const float* __restrict__ partials, int tiles, int nseg, float* __restrict__ dm) {
  const int seg = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (seg >= nseg) return;
  const float* x = partials + (long long)seg * tiles;
  float s = 0.f;
  for (int i = lane; i < tiles; i += 32) s += x[i];
  s = warp_sum(s);
  if (lane == 0) dm[seg] = s;
}

template <typename T>
int launch_fwd(const EdgeArgs<T>& a, int n, int scenes, float* level, float* out,
               cudaStream_t s) {
  using C = EdgeCfg<T>;
  cudaError_t e = sm90::configure<edge_fwd_kernel<T>>(C::FWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  edge_fwd_kernel<T><<<a.tiles * n, ETHREADS, C::FWD_SMEM, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int P = a.tiles * a.n_scene;   // a scene's partials
  edge_loss_sum<<<dim3((P + EBLOCK_SUM - 1) / EBLOCK_SUM, scenes), EBLOCK_SUM, 0, s>>>(
      a.partials, P, level, a.ticket, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const EdgeArgs<T>& a, int n, int e2, float* dm, cudaStream_t s) {
  using C = EdgeCfg<T>;
  cudaError_t e = sm90::configure<edge_bwd_kernel<T>>(C::BWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  edge_bwd_kernel<T><<<a.tiles * n, ETHREADS, C::BWD_SMEM, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  edge_dm_sum<<<(e2 * 12 + 7) / 8, 256, 0, s>>>(a.partials, a.tiles, e2 * 12, dm);
  return (int)cudaGetLastError();
}

template <typename T>
EdgeArgs<T> edge_args(const void* proj, const void* pw34, const void* pred, const void* w,
                      const void* order, const void* offsets, const void* g, void* partials,
                      void* dproj, void* ticket, int A, int vec, int n_scene) {
  return EdgeArgs<T>{(const float*)proj, (const float*)pw34, (const T*)pred, (const T*)w,
                     (const int*)order, (const int*)offsets, (const float*)g,
                     (float*)partials, (float*)dproj, (unsigned*)ticket, A,
                     (A + ETILE - 1) / ETILE, vec, n_scene};
}

}  // namespace a3r

using namespace a3r;

// K3 over `scenes` scenes of n / scenes images each (n images in all).
// partials: n * tiles floats; level: scenes * ceil(n tiles / scenes /
// EBLOCK_SUM) floats; ticket: one 32-bit word; out: scenes floats. vec: every
// row starts on a 16-byte boundary.
A3R_EXPORT int a3r_edge_fwd(const void* proj, const void* pw34, const void* pred,
                            const void* w, const void* order, const void* offsets,
                            void* partials, void* level, void* ticket, void* out, int n,
                            int A, int vec, int bf16_obs, int scenes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (scenes < 1 || n % scenes) return (int)cudaErrorInvalidValue;
  if (bf16_obs)
    return launch_fwd(edge_args<bf16>(proj, pw34, pred, w, order, offsets, nullptr, partials,
                                      nullptr, ticket, A, vec, n / scenes),
                      n, scenes, (float*)level, (float*)out, s);
  return launch_fwd(edge_args<float>(proj, pw34, pred, w, order, offsets, nullptr, partials,
                                     nullptr, ticket, A, vec, n / scenes),
                    n, scenes, (float*)level, (float*)out, s);
}

// K4 over `scenes` scenes (g: one value a scene). dm_partials: e2 * 12 *
// tiles floats.
A3R_EXPORT int a3r_edge_bwd(const void* proj, const void* pw34, const void* pred,
                            const void* w, const void* order, const void* offsets,
                            const void* g, void* dproj, void* dm_partials, void* dm, int n,
                            int e2, int A, int vec, int bf16_obs, int scenes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (scenes < 1 || n % scenes) return (int)cudaErrorInvalidValue;
  if (bf16_obs)
    return launch_bwd(edge_args<bf16>(proj, pw34, pred, w, order, offsets, g, dm_partials,
                                      dproj, nullptr, A, vec, n / scenes),
                      n, e2, (float*)dm, s);
  return launch_bwd(edge_args<float>(proj, pw34, pred, w, order, offsets, g, dm_partials, dproj,
                                     nullptr, A, vec, n / scenes),
                    n, e2, (float*)dm, s);
}
