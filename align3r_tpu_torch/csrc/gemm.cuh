// The Hopper GEMM core of K1's projections and K2 (fused_site.cu) and of
// K7/K8's bf16 3x3 convolutions (dpt_pipeline.cu), with its epilogues fused:
//
//   C[g] = epilogue(A[g] @ W[g])     A (G, M, K) bf16 row-major,
//                                    W (G, K, N) bf16 row-major ((in, out)
//                                    as the JAX package stores kernels),
//                                    C (G, M, N) bf16, fp32 accumulation.
//
// The core (gemm_core) is one kernel body for a policy that says where a
// tile's A k-tiles come from, in which order the tiles are walked and what
// the epilogue does; the ring, the products and the hand-offs are the core's.
// The GEMM's policy (GemmPolicy, below) reads A through a 3-D map; the conv's
// (ConvPolicy, dpt_pipeline.cu) reads each k-tile as a tap-shifted box of an
// NHWC image, an implicit GEMM.
//
// Persistent, ping-pong: one block per SM walks over the 128 x 128 tiles of
// C in order, N fastest. A block is one producer warpgroup and two consumer
// warpgroups; consumer w takes the block's tiles w, w + 2, ... whole.
//   - The producer's first thread keeps a ring of GSTAGES (A, W) k-tiles in
//     flight by TMA, behind full and empty mbarriers, in the block's tile
//     order, and brings each tile's bias slice by a bulk copy. The two
//     consumers' products alternate: a consumer starts tile i once the other
//     has finished the products of tile i - 1 (an order mbarrier each), so
//     while one runs its products the other runs its last tile's epilogue,
//     and a consumer never waits on a stage more than one fill ahead of the
//     producer (a parity wait could not tell the two apart). GBK = 64 bf16 is one
//     128-byte swizzle row. The maps are 3-D, (K, M, G) for A and (N, K, G)
//     for W, so rows past M are zero-filled per stream and a tile never reads
//     the next stream's rows.
//   - A consumer runs wgmma.m64n128k16 on both 64-row halves of its tile,
//     A K-major and W an N-major B operand (the transpose bit, as V in P V),
//     128 fp32 accumulators a thread. One k-tile's products stay in flight
//     while the stage of the one before is handed back to the producer. The
//     producer gives its registers to the consumers (setmaxnreg: 40 a thread
//     against 232).
//   - The epilogue runs on the accumulator fragment in registers. A thread
//     holds columns 8 j + 2 (lane % 4) + {0, 1} of rows r and r + 8 of each
//     half, so the RoPE partner D/4 = 16 columns away is its own register
//     j +- 2 (a tile covers two whole 64-column heads). Bias (from the slice
//     in shared memory), GELU, the residual and RoPE's cos / sin are per
//     element. There is no fp32 tile in shared memory: the bf16 tile goes by
//     stmatrix into the consumer's C buffer, as 64 x 64 boxes with the
//     128-byte swizzle, and from there by TMA stores, which clip the rows
//     past M and are waited for only before the buffer is written again.
//   - A policy may ask for the ReLU of A (RELU_A): then the producer
//     warpgroup's other three warps rewrite each landed A stage in shared
//     memory and hand it to the consumers on a third barrier (ready), ahead
//     of the products, so the consumers' loop stays as it is.
//   - A map that fails to encode or a refused launch is an error code; a copy
//     that never lands traps after 4 s (mbar_wait).
//
// What bounds it: at the main path's shapes (M = 9216 / 18432 rows; K, N
// of 768 to 4096) every product is operations-bound, at 200 to 600 FLOP per
// byte of A, W and C. Against that peak an SM loses the ring's fill at its
// first tile and the last epilogue, the idle SMs of the last round where the
// tiles are not a whole number of rounds of the 132 SMs, and what a 128 x 128
// tile costs in L2-to-shared-memory traffic: 32 KB a k-tile for 2.1 MFLOP
// (a 128 x 256 tile reads 48 KB for twice the work, but its 128 accumulators
// a thread and the epilogue's operands exceed the registers once the two
// warpgroups share a tile, and then no epilogue overlaps a product).
//
// Rounding order of the epilogues (bit for bit gemm_plain's,
// ops/fused_site.py):
//   EPI_BIAS        bf16(acc + bias)
//   EPI_BIAS_ROPE   t = bf16(acc + bias), tp the partner's the same way;
//                   bf16(bf16(t cos) + bf16(+-tp sin)), token = row % rope_n
//   EPI_BIAS_GELU   bf16(gelu_erf(acc + bias))
//   EPI_BIAS_RESID  bf16(resid + bf16(acc + bias))
//   EPI_PARTIAL     acc in fp32, no bias: a rank's share of a product split
//                   over K (the tensor-parallel sites' out-projection and fc2);
//                   the sum over the ranks is finished by finish_kernel
//                   (fused_site.cu) as EPI_BIAS / EPI_BIAS_RESID would
//
// N is a multiple of 128, or of 64 for EPI_BIAS, EPI_BIAS_ROPE and
// EPI_PARTIAL (a rank's q/k/v of a split site are C / m wide, 192 at C = 768,
// m = 4): their TAIL instances take a last tile 64 wide. Its second W box
// repeats the first (those columns are computed and never stored), its bias
// slice is 64 floats and C is stored for its first 64 columns only. The
// instances without TAIL are the code they were before the tail existed: at
// 168 registers the core has no room to spare, and the residual's and GELU's
// epilogues spilled with the tail's predicates in them.
#pragma once

#include "sm90_ptx.cuh"

namespace a3r {

enum Epilogue : int {
  EPI_BIAS = 0,        // bf16(acc + bias)
  EPI_BIAS_ROPE = 1,   // RoPE2D(bf16(acc + bias)) with bf16 cos/sin tables
  EPI_BIAS_GELU = 2,   // bf16(gelu_erf(acc + bias))
  EPI_BIAS_RESID = 3,  // bf16(resid + bf16(acc + bias))
  EPI_PARTIAL = 5,     // acc in fp32, no bias
};

constexpr int GBM = 128;                   // rows of a tile: two wgmma halves of 64
constexpr int GBN = 128;                   // columns of a tile
constexpr int GBN_TAIL = 64;               // N % GBN_TAIL == 0: a last tile may be 64 wide
constexpr int GBK = 64;                    // k of a stage: one 128-byte swizzle row
constexpr int GSTAGES = 4;                 // depth of the (A, W) ring
constexpr int GEMM_THREADS = 384;          // the producer and two consumer warpgroups
constexpr int GEMM_PRODUCER_REGS = 40, GEMM_CONSUMER_REGS = 232;   // 64,512 of 65,536
constexpr int GEMM_ROPE_D = 64;            // the RoPE epilogue's head dim

struct GemmSmem {
  static constexpr int AB = GBM * GBK * 2;     // the A tile of a stage
  static constexpr int WB = GBK * GBN * 2;     // the W tile: two boxes of 64 x 64
  static constexpr int STAGE = AB + WB;
  static constexpr int CB = GBM * GBN * 2;     // a consumer's C tile: four boxes of 64 x 64
  static constexpr int C0 = GSTAGES * STAGE;   // consumer w's at C0 + w CB
  static constexpr int BIAS = C0 + 2 * CB;     // consumer w's fp32 bias slice at BIAS + w 512
  // full, empty, ready [GSTAGES]; bias full, empty [2]; products done [2]
  static constexpr int BAR = BIAS + 2 * GBN * 4;
  static constexpr int BYTES = BAR + (3 * GSTAGES + 6) * 8 + 1024;   // + the base's alignment
  static_assert(STAGE % 1024 == 0 && CB % 1024 == 0, "tiles must keep 1024-byte alignment");
};

// The producer warpgroup's warps 1..3, which apply an operand ReLU to each
// landed A stage where a policy asks for one (RELU_A).
constexpr int GEMM_RELU_WARPS = 3;

struct GemmArgs {
  const float* bias;   // (G, N) fp32
  const bf16* resid;   // (G, M, N), EPI_BIAS_RESID
  const bf16* cos;     // (rope_n, 64) token-major, EPI_BIAS_ROPE
  const bf16* sin;
  float* part;         // (G, M, N) fp32, EPI_PARTIAL's output
  int G, M, N, K;
  int rope_n;          // tokens per sequence: row m is token m % rope_n
};

// The 1024-byte aligned base of the dynamic shared memory.
__device__ __forceinline__ uint32_t gemm_smem_base(const void* smem_raw) {
  return (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
}

// The core, for a policy P that says where a tile's A and W k-tiles come
// from and what its epilogue does:
//   P::RELU_A, P::TMA_STORE, P::C_PASS operand ReLU of A; C by TMA stores;
//                                      p.pass(cbuf, tile, thread) on the bf16
//                                      tile in the C buffer before its stores
//   p.walk()                           .tiles, .nk, .at(t) -> P::Tile
//   p.prologue(smem)                   by every thread, before the roles split
//   p.load(sa, ta, tw, bar, tile, kt)  the producer's TMA loads of one stage
//   p.bias(tile), p.bias_bytes(tile)   the tile's fp32 bias slice (up to 128 floats;
//                                      0 bytes: none, and no copy is issued)
//   p.rows(tile, wl, lane)             the epilogue's per-tile state
//   p.chunk(a, hm, h, st, bias, smem, wl, lane)   one (half, row half) chunk
//   p.store(tc, cbase, tile)           the issuer's TMA stores of the C tile
template <class P>
__device__ __forceinline__ void gemm_core(const CUtensorMap* ta, const CUtensorMap* tw,
                                          const CUtensorMap* tc, const P& p) {
  using namespace sm90;
  using L = GemmSmem;
  constexpr int S = GSTAGES;
  // barriers: full, empty, ready [S]; bias full, empty [2]; products done [2]
  constexpr int EMPTY = L::BAR + 8 * S, READY = EMPTY + 8 * S, BFULL = READY + 8 * S,
                BEMPTY = BFULL + 16, DONE = BEMPTY + 16;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = gemm_smem_base(smem_raw);
  unsigned char* smem = smem_raw + (base - smem_addr(smem_raw));
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(base + L::BAR + 8 * s, 1);
      mbar_init(base + EMPTY + 8 * s, 4);   // the consuming warpgroup's four warps
      mbar_init(base + READY + 8 * s, GEMM_RELU_WARPS);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(base + BFULL + 8 * b, 1);
      mbar_init(base + BEMPTY + 8 * b, 4);
      mbar_init(base + DONE + 8 * b, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  p.prologue(smem);
  __syncthreads();

  if (threadIdx.x >= 256) {   // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<GEMM_PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      const uint32_t full = base + L::BAR;
      const uint32_t empty = base + EMPTY, bfull = base + BFULL, bempty = base + BEMPTY;
      const auto tl = p.walk();
      int it = 0;   // k-tiles issued, over all of this block's tiles
      for (int t = blockIdx.x, i = 0; t < tl.tiles; t += gridDim.x, ++i) {
        const auto tile = tl.at(t);
        const int b = i & 1;   // tile i's consumer
        if (i >= 2) mbar_wait(bempty + 8 * b, ((i >> 1) - 1) & 1);
        const uint32_t bb = p.bias_bytes(tile);
        mbar_expect_tx(bfull + 8 * b, bb);
        if (bb) bulk_load(base + L::BIAS + b * GBN * 4, p.bias(tile), bb, bfull + 8 * b);
        for (int kt = 0; kt < tl.nk; ++kt, ++it) {
          const int s = it % S;
          if (it >= S) mbar_wait(empty + 8 * s, (it / S - 1) & 1);
          const uint32_t bar = full + 8 * s;
          mbar_expect_tx(bar, L::STAGE);
          p.load(base + s * L::STAGE, ta, tw, bar, tile, kt);
        }
      }
    } else if constexpr (P::RELU_A) {
      if (threadIdx.x >= 256 + 32) {   // warps 1..3: relu each landed A stage in place
        // (the swizzle moves 16-byte chunks only), then hand it to the consumers
        const uint32_t full = base + L::BAR, ready = base + READY;
        const auto tl = p.walk();
        const int mine = (tl.tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
        const int rt = threadIdx.x - 256 - 32;
        for (int it = 0; it < mine * tl.nk; ++it) {
          const int s = it % S;
          mbar_wait(full + 8 * s, (it / S) & 1);
          uint4* a = reinterpret_cast<uint4*>(smem + s * L::STAGE);
#pragma unroll 4
          for (int e = rt; e < L::AB / 16; e += 32 * GEMM_RELU_WARPS) {
            uint4 v = a[e];   // bf16 pairs: a negative bf16 is a negative int16
            v.x = __vmaxs2(v.x, 0u);
            v.y = __vmaxs2(v.y, 0u);
            v.z = __vmaxs2(v.z, 0u);
            v.w = __vmaxs2(v.w, 0u);
            a[e] = v;
          }
          fence_proxy_async();   // visible to the consumers' wgmma (the async proxy)
          __syncwarp();
          if ((threadIdx.x & 31) == 0) mbar_arrive(ready + 8 * s);
        }
      }
    }
  } else {   // consumer wg: the block's tiles wg, wg + 2, ...
    setmaxnreg_inc<GEMM_CONSUMER_REGS>();
    const uint32_t tid = threadIdx.x;
    // a stage is the consumers' once it landed, or once the ReLU warps are done with it
    const uint32_t full = base + (P::RELU_A ? READY : L::BAR);
    const uint32_t empty = base + EMPTY, bfull = base + BFULL, bempty = base + BEMPTY;
    const uint32_t done = base + DONE;
    const auto tl = p.walk();
    const int nk = tl.nk, warp = tid >> 5, lane = tid & 31;
    const int wg = warp >> 2, wl = warp & 3, c = 2 * (lane & 3);
    const uint32_t cbase = base + L::C0 + wg * L::CB;
    const float* bias = reinterpret_cast<const float*>(smem + L::BIAS) + wg * GBN + c;
    const bool issuer = wl == 0 && lane == 0;   // this consumer's TMA stores
    for (int t = blockIdx.x + wg * gridDim.x, i = wg; t < tl.tiles; t += 2 * gridDim.x, i += 2) {
      float acc[2][GBN / 2];   // the two 64-row halves
#pragma unroll
      for (int e = 0; e < GBN / 2; ++e) acc[0][e] = acc[1][e] = 0.f;
      // the other consumer's products of tile i - 1 (its ((i - 1) >> 1)-th tile) are done
      if (i > 0) mbar_wait(done + 8 * (1 - wg), ((i - 1) >> 1) & 1);
      for (int kt = 0, it = i * nk; kt < nk; ++kt, ++it) {
        const int s = it % S;
        const uint32_t sa = base + s * L::STAGE, sw = sa + L::AB;
        mbar_wait(full + 8 * s, (it / S) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < GBK / 16; ++kk) {   // A: k16 slice 32 bytes along a swizzle row;
          const uint64_t bd = make_desc(sw + kk * 16 * 128, GBK * 128, 1024, 1);   // W: 16 rows down
          Wgmma<GBN>::ss_t(acc[0], make_desc(sa + 32 * kk, 16, 1024, 1), bd);
          Wgmma<GBN>::ss_t(acc[1], make_desc(sa + 64 * 128 + 32 * kk, 16, 1024, 1), bd);
        }
        wgmma_commit();
        wgmma_wait<1>();   // the previous k-tile's products are done: hand its stage back
        if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % S));
      }
      wgmma_wait<0>();
      pin(acc[0]);
      pin(acc[1]);
      if (lane == 0) {
        mbar_arrive(empty + 8 * ((i * nk + nk - 1) % S));   // the last stage
        mbar_arrive(done + 8 * wg);
      }

      // ---- epilogue, in four chunks (64-row half hm, row half h), each its
      // loads, bias and math after a pin of the half's accumulators (whose
      // memory clobber keeps the next chunk's loads behind it): the registers
      // beside the 128 accumulators stay few. acc[hm][4 j + 2 h + e] is row
      // 64 hm + 16 wl + lane / 4 + 8 h of the tile, column n0 + 8 j + c + e.
      // With TMA stores the bf16 tile goes into this consumer's C buffer once
      // the stores of its last tile have read it: box (hm, w) (rows 64 hm..,
      // columns 64 w..) at cbase + (2 hm + w) 8 KB, row-major with the
      // 128-byte swizzle. One stmatrix.x4 takes column groups j, j + 1 of
      // both row halves h; lane l addresses row l % 8 of matrix l / 8 =
      // (h, j + jj).
      const auto tile = tl.at(t);   // decoded here: only t is live over the products
      const auto st = p.rows(tile, wl, lane);
      mbar_wait(bfull + 8 * wg, (i >> 1) & 1);
      if constexpr (P::TMA_STORE) {
        if (issuer) tma_store_wait_read();
        named_sync(1 + wg, 128);
      }
      const int mi = lane >> 3, ri = lane & 7;
      const uint32_t row_off = (wl * 16 + (mi & 1) * 8 + ri) * 128;
#pragma unroll
      for (int hm = 0; hm < 2; ++hm) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          pin(acc[hm]);
          p.chunk(acc[hm], hm, h, st, bias, smem, wl, lane);
        }
        if constexpr (P::TMA_STORE) {
          const float* a = acc[hm];
#pragma unroll
          for (int j = 0; j < GBN / 8; j += 2) {
            const int jj = j + (mi >> 1);
            stmatrix_x4(cbase + (2 * hm + (jj >> 3)) * (64 * 128) + row_off + (((jj & 7) ^ ri) << 4),
                        pack_bf16(a[4 * j], a[4 * j + 1]), pack_bf16(a[4 * j + 2], a[4 * j + 3]),
                        pack_bf16(a[4 * j + 4], a[4 * j + 5]), pack_bf16(a[4 * j + 6], a[4 * j + 7]));
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bempty + 8 * wg);   // the bias slice is read
      if constexpr (P::TMA_STORE) {
        if constexpr (P::C_PASS) {   // a pass over the whole bf16 tile in the C buffer
          named_sync(1 + wg, 128);
          p.pass(smem + L::C0 + wg * L::CB, tile, tid & 127);
        }
        fence_proxy_async();
        named_sync(1 + wg, 128);
        if (issuer) {
          p.store(tc, cbase, tile);
          tma_store_commit();
        }
      }
    }
    if (P::TMA_STORE && issuer) tma_store_wait_all();
  }
}

// ------------------------------------------------------------ the GEMM

// The GEMM's policy: A (G, M, K) and W (G, K, N) by 3-D maps, tiles
// (G, M / GBM, N / GBN) with N fastest (both rounded up), C (G, M, N) bf16 by
// TMA stores; EPI_PARTIAL's fp32 C from registers. TAIL: N % 128 may be 64.
template <int EPI, bool TAIL>
struct GemmPolicy {
  static_assert(!TAIL || EPI == EPI_BIAS || EPI == EPI_BIAS_ROPE || EPI == EPI_PARTIAL,
                "a 64-wide last tile is taken by the bias, RoPE and partial epilogues");
  static constexpr bool RELU_A = false, TMA_STORE = EPI != EPI_PARTIAL, C_PASS = false;
  struct Tile { int g, m0, n0; };
  struct Walk {
    int nn, nm, tiles, nk;
    __device__ __forceinline__ Tile at(int t) const {
      Tile r;
      r.n0 = (t % nn) * GBN;
      t /= nn;
      r.m0 = (t % nm) * GBM;
      r.g = t / nm;
      return r;
    }
  };
  struct Rows { int g, m0, n0, tok0; };
  GemmArgs p;

  __device__ __forceinline__ Walk walk() const {
    const int nn = TAIL ? (p.N + GBN - 1) / GBN : p.N / GBN, nm = (p.M + GBM - 1) / GBM;
    return Walk{nn, nm, p.G * nm * nn, p.K / GBK};
  }
  __device__ __forceinline__ void prologue(unsigned char*) const {}
  __device__ __forceinline__ void load(uint32_t sa, const CUtensorMap* ta, const CUtensorMap* tw,
                                       uint32_t bar, const Tile& t, int kt) const {
    // a 64-wide last tile reads its one W box twice (the stage's bytes stay whole)
    const int n1 = TAIL && t.n0 + 64 >= p.N ? t.n0 : t.n0 + 64;
    sm90::tma_load(sa, ta, bar, kt * GBK, t.m0, t.g);
    sm90::tma_load(sa + GemmSmem::AB, tw, bar, t.n0, kt * GBK, t.g);
    sm90::tma_load(sa + GemmSmem::AB + GBK * 128, tw, bar, n1, kt * GBK, t.g);
  }
  __device__ __forceinline__ const float* bias(const Tile& t) const {
    return p.bias + (size_t)t.g * p.N + t.n0;
  }
  __device__ __forceinline__ uint32_t bias_bytes(const Tile& t) const {
    return EPI == EPI_PARTIAL ? 0u : TAIL ? 4u * (uint32_t)min(GBN, p.N - t.n0) : 4u * GBN;
  }
  __device__ __forceinline__ Rows rows(const Tile& t, int wl, int lane) const {
    return Rows{t.g, t.m0, t.n0,
                EPI == EPI_BIAS_ROPE ? (t.m0 + 16 * wl + (lane >> 2)) % p.rope_n : 0};
  }
  // the epilogue math of chunk (hm, h) on a = acc[hm]; the bf16 rounding of
  // the result is the stmatrix pack
  __device__ __forceinline__ void chunk(float (&a)[GBN / 2], int hm, int h, const Rows& st,
                                        const float* bias, const unsigned char*, int wl,
                                        int lane) const {
    const int M = p.M, N = p.N, c = 2 * (lane & 3);
    const int row = st.m0 + 64 * hm + 16 * wl + (lane >> 2) + 8 * h;
    if constexpr (EPI == EPI_PARTIAL) {
      const bool wide = !TAIL || st.n0 + 64 < N;   // the tile's columns 64..127 lie inside C
      if (row < M) {
        float* out = p.part + ((size_t)st.g * M + row) * N + st.n0 + c;
#pragma unroll
        for (int j = 0; j < GBN / 8; ++j)
          if (j < 8 || wide)
            *reinterpret_cast<float2*>(out + 8 * j) = make_float2(a[4 * j + 2 * h], a[4 * j + 2 * h + 1]);
      }
      return;
    }
    // side[j]: the bf16 pair of the row at columns n0 + 8 j + c (resid),
    // or of its token at head columns 8 j + c of cos (j < 8), sin (j >= 8)
    uint32_t side[16];
    if constexpr (EPI == EPI_BIAS_RESID) {
      const bf16* R = p.resid + ((size_t)st.g * M + min(row, M - 1)) * N + st.n0 + c;
#pragma unroll
      for (int j = 0; j < 16; ++j) side[j] = *reinterpret_cast<const uint32_t*>(R + 8 * j);
    } else if constexpr (EPI == EPI_BIAS_ROPE) {
      int tk = st.tok0 + 64 * hm + 8 * h;   // (row % rope_n), without a division per chunk
      while (tk >= p.rope_n) tk -= p.rope_n;
      const size_t tok = (size_t)tk * GEMM_ROPE_D + c;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        side[j] = *reinterpret_cast<const uint32_t*>(p.cos + tok + 8 * j);
        side[8 + j] = *reinterpret_cast<const uint32_t*>(p.sin + tok + 8 * j);
      }
    }
    const auto pair = [&](int j) {
      return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&side[j]));
    };
#pragma unroll
    for (int j = 0; j < GBN / 8; ++j) {
      const float2 bj = *reinterpret_cast<const float2*>(bias + 8 * j);
      a[4 * j + 2 * h] += bj.x;
      a[4 * j + 2 * h + 1] += bj.y;
    }
    if constexpr (EPI == EPI_BIAS_GELU) {
#pragma unroll
      for (int j = 0; j < GBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = a[4 * j + 2 * h + e];
          a[4 * j + 2 * h + e] = 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
        }
    } else if constexpr (EPI == EPI_BIAS_RESID) {
#pragma unroll
      for (int j = 0; j < GBN / 8; ++j) {
        const float2 r = pair(j);
        a[4 * j + 2 * h] = r.x + bf16r(a[4 * j + 2 * h]);
        a[4 * j + 2 * h + 1] = r.y + bf16r(a[4 * j + 2 * h + 1]);
      }
    } else if constexpr (EPI == EPI_BIAS_ROPE) {
      // in a 64-column head, column groups j % 8 = 0, 1 and 4, 5 are the
      // first quarters of its halves, rotated against groups j + 2
#pragma unroll
      for (int jb = 0; jb < GBN / 8; jb += 8)
#pragma unroll
        for (int jq = 0; jq < 6; ++jq) {
          if (jq == 2 || jq == 3) continue;
          const int i1 = 4 * (jb + jq) + 2 * h, i2 = i1 + 8;   // i2: the partner, 16 columns on
          const float2 c1 = pair(jq), s1 = pair(8 + jq), c2 = pair(jq + 2), s2 = pair(10 + jq);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float t1 = bf16r(a[i1 + e]), t2 = bf16r(a[i2 + e]);
            a[i1 + e] = bf16r(t1 * (e ? c1.y : c1.x)) + bf16r(-t2 * (e ? s1.y : s1.x));
            a[i2 + e] = bf16r(t2 * (e ? c2.y : c2.x)) + bf16r(t1 * (e ? s2.y : s2.x));
          }
        }
    }
  }
  __device__ __forceinline__ void store(const CUtensorMap* tc, uint32_t cbase,
                                        const Tile& t) const {
#pragma unroll
    for (int hm = 0; hm < 2; ++hm)
      if (t.m0 + 64 * hm < p.M) {
        sm90::tma_store(tc, cbase + 2 * hm * (64 * 128), t.n0, t.m0 + 64 * hm, t.g);
        if (!TAIL || t.n0 + 64 < p.N)
          sm90::tma_store(tc, cbase + (2 * hm + 1) * (64 * 128), t.n0 + 64, t.m0 + 64 * hm, t.g);
      }
  }
};

template <int EPI, bool TAIL>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
gemm_sm90(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
          const __grid_constant__ CUtensorMap tc, const GemmArgs p) {
  gemm_core(&ta, &tw, &tc, GemmPolicy<EPI, TAIL>{p});
}

// ------------------------------------------------------------ host side

// The map of a contiguous (G, rows, cols) bf16 tensor as (cols, rows, G),
// boxes of 64 columns x box_rows rows of one plane, 128-byte swizzle: a box
// past a plane's last row is zero-filled on a load and clipped on a store.
inline bool gemm_map(CUtensorMap* map, const void* ptr, int G, int rows, int cols, int box_rows) {
  const sm90::EncodeTiled fn = sm90::encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)G};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The card's SM count: the persistent grid's size (0 if it cannot be read).
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
  }
  return sms;
}

// Launches gemm_sm90<EPI, TAIL> on A (G, M, K), W (G, K, N) and C (G, M, N)
// (bf16; fp32 for EPI_PARTIAL, whose p.part is C): min(tiles, SMs) blocks.
template <int EPI, bool TAIL>
cudaError_t launch_gemm(const void* A, const void* W, void* C, const GemmArgs& p,
                        cudaStream_t stream) {
  cudaError_t e = sm90::configure<gemm_sm90<EPI, TAIL>>(GemmSmem::BYTES);
  if (e != cudaSuccess) return e;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  CUtensorMap ta, tw, tc{};   // EPI_PARTIAL stores from registers: no C map
  if (!gemm_map(&ta, A, p.G, p.M, p.K, GBM) || !gemm_map(&tw, W, p.G, p.K, p.N, GBK) ||
      (EPI != EPI_PARTIAL && !gemm_map(&tc, C, p.G, p.M, p.N, 64)))
    return cudaErrorInvalidValue;
  const long long tiles = (long long)p.G * ((p.M + GBM - 1) / GBM) * ((p.N + GBN - 1) / GBN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  gemm_sm90<EPI, TAIL><<<grid, GEMM_THREADS, GemmSmem::BYTES, stream>>>(ta, tw, tc, p);
  return cudaGetLastError();
}

}  // namespace a3r
