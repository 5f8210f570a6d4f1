// K7 and K8: the DPT head's residual conv units and final trio, for Hopper.
//
// K7 replaces align3r_tpu/ops/dpt_pipeline.py: _res_unit_call (:176) ->
// _res_unit_kernel (:101), the residual conv unit of each refinenet level:
//   a = bf16(conv3x3(relu(v)) + b1); a = bf16(conv3x3(relu(a)) + b2);
//   y = v + a (+ base)        (NHWC, SAME zero padding, fp32 accumulation,
//                             bias added in fp32, then rounded to storage)
// K8 replaces _head_trio_call (:389) -> _head_trio_kernel (:319), the
// regression head's tail:
//   h1 = round(conv3x3(x) + b1); 2x align_corners bilinear upsample, columns
//   first (round), then rows (round); a2 = relu(conv3x3(h2) + b2) in fp32;
//   out = a2 w3 + b3 in fp32.
//
// Each 3x3 convolution is an implicit GEMM: M = pixels, N = output channels,
// K = 9 taps x input channels, with the (9, Cin, Cout) taps as W (9 Cin,
// Cout), row-major. K7 is two launches (its intermediate in device memory),
// K8 three: conv 1, the upsample, conv 2 + the 1 x 1.
//
// bf16: the GEMM core of gemm.cuh (persistent, ping-pong, a TMA ring, wgmma,
// epilogues in registers) with the conv's policy (ConvPolicy):
//   - A tile is 128 pixels of one image, a box of BW x BH = 128 pixels: BW =
//     64 for W >= 64, else the power of two >= W (W = 11 -> 16). Tiles walk
//     N fastest, then along W, H and B, so that a tile's 3x3 halo was read
//     by its neighbours moments before and is still in L2.
//   - The A k-tile of tap (dh, dw) and channel block c0 is the box at (c0,
//     w0 + dw - 1, h0 + dh - 1, b) of a 4-D map (C, W, H, B) of the input:
//     64 channels (one 128-byte swizzle row) of BW x BH pixels, which lands
//     as the core's 128-row K-major A stage. The TMA zero-fills coordinates
//     that are negative or past the end: that is the SAME padding, with no
//     masks. W's k-tiles are rows 64 kt.. of the taps: tap kt / (Cin / 64),
//     channels 64 (kt % (Cin / 64)).., 36 k-tiles at Cin = 256.
//   - C goes out through a 4-D map too, half a tile (BW x BH / 2 pixels) a
//     store box, and the store clips the pixels past H or W (the ragged
//     9-row level, W = 11).
//   - K7's conv 1 reads relu(v): the core's ReLU warps rewrite each landed A
//     stage in shared memory (RELU_A). Its conv 2's operand ReLU moves into
//     conv 1's epilogue (EPI_RELU stores relu(a)): relu(round(x)) =
//     round(relu(x)), and a has no other reader.
// Epilogues (the rounding order of conv3x3_plain, ops/dpt_pipeline.py):
//   EPI_ROUND  bf16(acc + b)                               (K8 conv 1)
//   EPI_RELU   bf16(relu(acc + b))                         (K7 conv 1)
//   EPI_RESID  bf16(bf16(v + bf16(acc + b)) + base)        (K7 conv 2; base optional)
//              the adds in a pass over the bf16 tile in the C buffer, with
//              16-byte loads of v and base (C_PASS): in the accumulators'
//              registers they spilled
//   EPI_HEAD   relu(acc + b) w3 + b3 in fp32, the 1 x 1 conv over the
//              tile's 128 channels: each thread's 32 columns, then two quad
//              shuffles; w3 and b3 sit in shared memory   (K8 conv 2)
// fp32 (no path runs it): conv3x3_fp32, an FMA kernel without tensor cores, 128 x 128 tiles
// with a K step of 32 channels on a two-stage cp.async ring, 8 x 8 outputs a
// thread, the operand ReLU on each landed chunk, the same epilogues through
// an fp32 tile in shared memory.
// The upsample (upsample2x_kernel) moves 16 bytes of channels a thread:
// each output reads its two row and two column taps directly, with
// _interp_matrix's weights.
//
// What bounds them on the H100: operations. A K7 unit at the 72 x 128 level
// of a 32-pair decode batch is 2 x 2 x 294,912 x 9 x 256 x 256 = 0.70 TFLOP
// against about 60 MB of activations and weights: 0.70 ms of bf16 tensor-core
// time against 0.02 ms of memory. K8 at (32, 144, 256, 256) is 2.1 TFLOP; its
// upsample alone is bytes-bound (0.30 GB read, 1.21 GB written). The TPU
// kernels keep K7's intermediate and K8's h1 / h2 in VMEM; here they go
// through device memory.
#include "common.cuh"
#include "gemm.cuh"

namespace a3r {
namespace dpt {

enum Epi : int { EPI_ROUND = 0, EPI_RESID = 1, EPI_HEAD = 2, EPI_RELU = 3 };

constexpr int MAX_C3 = 16;    // outputs of the 1 x 1 conv (EPI_HEAD)
constexpr int CONV_BW = 64;   // the widest box: 64 pixels of a row (BH = GBM / BW rows)

struct ConvArgs {
  const void* x;       // (B, H, W, Cin); the bf16 kernel reads it through its map
  const void* w;       // (9, Cin, Cout), taps dh * 3 + dw
  const float* bias;   // (Cout,)
  void* out;           // (B, H, W, Cout) storage, or (B, H, W, C3) fp32 for EPI_HEAD
  const void* resid;   // EPI_RESID: v (B, H, W, Cout)
  const void* base;    // EPI_RESID: optional base (B, H, W, Cout)
  const float* w3;     // EPI_HEAD: (Cout, C3)
  const float* b3;     // EPI_HEAD: (C3,)
  int B, H, W, Cin, Cout, C3;
  // the bf16 kernel's walk, computed once on the host: a box of 1 << bwl
  // pixels of a row by bh rows, nn x nw x nh x B tiles, nk k-tiles each
  int bwl, bh, nn, nw, nh, tiles, nk;
};

// the box width: CONV_BW for W >= CONV_BW, else the power of two >= W
inline int conv_box_w(int W) {
  int bw = 1;
  while (bw < W && bw < CONV_BW) bw <<= 1;
  return bw;
}

// ------------------------------------------------- bf16: the GEMM core's policy

template <int EPI>
struct ConvPolicy {
  static constexpr bool RELU_A = EPI == EPI_RELU, TMA_STORE = EPI != EPI_HEAD,
                        C_PASS = EPI == EPI_RESID;
  struct Tile { int b, h0, w0, n0; };
  struct Walk {
    const ConvArgs& p;
    int tiles, nk;
    __device__ __forceinline__ Tile at(int t) const {
      Tile r;
      r.n0 = (t % p.nn) * GBN;
      t /= p.nn;
      r.w0 = (t % p.nw) << p.bwl;
      t /= p.nw;
      r.h0 = (t % p.nh) * p.bh;
      r.b = t / p.nh;
      return r;
    }
  };
  using Rows = Tile;
  ConvArgs p;

  __device__ __forceinline__ Walk walk() const { return Walk{p, p.tiles, p.nk}; }
  // EPI_HEAD: w3 as (GBN, C3P) fp32 at C0 (the unused C buffers), C3P = C3
  // rounded up to 4 with zero columns, then b3 at C0 + GBN MAX_C3 floats
  __device__ __forceinline__ void prologue(unsigned char* smem) const {
    if constexpr (EPI == EPI_HEAD) {
      float* w3s = reinterpret_cast<float*>(smem + GemmSmem::C0);
      const int C3 = p.C3, C3P = (C3 + 3) & ~3;
      for (int e = threadIdx.x; e < GBN * C3P; e += blockDim.x) {
        const int r = e / C3P, o = e - r * C3P;
        w3s[e] = o < C3 ? p.w3[r * C3 + o] : 0.f;
      }
      for (int o = threadIdx.x; o < MAX_C3; o += blockDim.x)
        w3s[GBN * MAX_C3 + o] = o < C3 ? p.b3[o] : 0.f;
    }
  }
  __device__ __forceinline__ void load(uint32_t sa, const CUtensorMap* ta, const CUtensorMap* tw,
                                       uint32_t bar, const Tile& t, int kt) const {
    const int kc = p.Cin / GBK, tap = kt / kc, c0 = (kt - tap * kc) * GBK;
    const int dh = tap / 3, dw = tap - 3 * dh;
    sm90::tma_load_4d(sa, ta, bar, c0, t.w0 + dw - 1, t.h0 + dh - 1, t.b);
    sm90::tma_load(sa + GemmSmem::AB, tw, bar, t.n0, kt * GBK, 0);
    sm90::tma_load(sa + GemmSmem::AB + GBK * 128, tw, bar, t.n0 + 64, kt * GBK, 0);
  }
  __device__ __forceinline__ const float* bias(const Tile& t) const { return p.bias + t.n0; }
  __device__ __forceinline__ Rows rows(const Tile& t, int, int) const { return t; }

  // chunk (hm, h) of the epilogue (EPI_RESID's residual adds come after it,
  // in pass). Tile row r = 64 hm + 16 wl + lane / 4 + 8 h is pixel (h0 + r /
  // BW, w0 + r % BW), which may lie past H or W.
  __device__ __forceinline__ void chunk(float (&a)[GBN / 2], int hm, int h, const Rows& t,
                                        const float* bias, const unsigned char* smem, int wl,
                                        int lane) const {
#pragma unroll
    for (int j = 0; j < GBN / 8; ++j) {
      const float2 bj = *reinterpret_cast<const float2*>(bias + 8 * j);
      a[4 * j + 2 * h] += bj.x;
      a[4 * j + 2 * h + 1] += bj.y;
    }
    if constexpr (EPI == EPI_RELU) {
#pragma unroll
      for (int j = 0; j < GBN / 8; ++j) {
        a[4 * j + 2 * h] = fmaxf(a[4 * j + 2 * h], 0.f);
        a[4 * j + 2 * h + 1] = fmaxf(a[4 * j + 2 * h + 1], 0.f);
      }
    } else if constexpr (EPI == EPI_HEAD) {
      // out[pix, o] = b3[o] + sum_k relu(a[k]) w3[k, o] over the tile's 128
      // channels (Cout == GBN): this thread's 32, then the quad's
      const float* w3s = reinterpret_cast<const float*>(smem + GemmSmem::C0);
      const int C3 = p.C3, C3P = (C3 + 3) & ~3, c = 2 * (lane & 3);
      const int r = 64 * hm + 16 * wl + (lane >> 2) + 8 * h;
      const int hh = t.h0 + (r >> p.bwl), ww = t.w0 + (r & ((1 << p.bwl) - 1));
#pragma unroll
      for (int j = 0; j < GBN / 8; ++j) {
        a[4 * j + 2 * h] = fmaxf(a[4 * j + 2 * h], 0.f);
        a[4 * j + 2 * h + 1] = fmaxf(a[4 * j + 2 * h + 1], 0.f);
      }
      float* out = static_cast<float*>(p.out) + (((size_t)t.b * p.H + hh) * p.W + ww) * C3;
      for (int o0 = 0; o0 < C3; o0 += 4) {
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < GBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = a[4 * j + 2 * h + e];
            const float4 w = *reinterpret_cast<const float4*>(w3s + (8 * j + c + e) * C3P + o0);
            s[0] = fmaf(v, w.x, s[0]);
            s[1] = fmaf(v, w.y, s[1]);
            s[2] = fmaf(v, w.z, s[2]);
            s[3] = fmaf(v, w.w, s[3]);
          }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s[k] += __shfl_xor_sync(0xffffffffu, s[k], 1);
          s[k] += __shfl_xor_sync(0xffffffffu, s[k], 2);
          s[k] += w3s[GBN * MAX_C3 + o0 + k];
        }
        if (hh < p.H && ww < p.W && (lane & 3) == (o0 >> 2)) {   // one lane of the quad per 4 outputs
          if (C3 % 4 == 0) {
            *reinterpret_cast<float4*>(out + o0) = make_float4(s[0], s[1], s[2], s[3]);
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (o0 + k < C3) out[o0 + k] = s[k];
          }
        }
      }
    }
  }
  // EPI_RESID, after the chunks left bf16(acc + b) in the C buffer: y =
  // round(v + y), then (if given) round(y + base), 16 bytes (8 channels) a
  // step. Box (hm, w) row rr of the buffer is tile row 64 hm + rr, channels
  // n0 + 64 w.., its 16-byte chunk k at (k ^ rr % 8) (the 128-byte
  // swizzle); eight threads read a pixel's 128 contiguous bytes of v.
  // Pixels past H or W are left as they are (the store clips them).
  __device__ __forceinline__ void pass(unsigned char* cbuf, const Tile& t, int tid) const {
    const bf16* v = static_cast<const bf16*>(p.resid);
    const bf16* base = static_cast<const bf16*>(p.base);
    const auto add = [](uint32_t y, uint32_t x) {   // round(y + x) on a bf16 pair
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
      return sm90::pack_bf16(a.x + b.x, a.y + b.y);
    };
#pragma unroll 4
    for (int q = tid; q < GBM * GBN / 8; q += 128) {
      const int box = q >> 9, rr = (q >> 3) & 63, k = q & 7;
      const int r = 64 * (box >> 1) + rr;
      const int hh = t.h0 + (r >> p.bwl), ww = t.w0 + (r & ((1 << p.bwl) - 1));
      if (hh >= p.H || ww >= p.W) continue;
      uint4* y = reinterpret_cast<uint4*>(cbuf + box * (64 * 128) + rr * 128 + ((k ^ (rr & 7)) << 4));
      const size_t o =
          (((size_t)t.b * p.H + hh) * p.W + ww) * p.Cout + t.n0 + 64 * (box & 1) + 8 * k;
      uint4 c = *y;
      const uint4 x = *reinterpret_cast<const uint4*>(v + o);
      c = make_uint4(add(c.x, x.x), add(c.y, x.y), add(c.z, x.z), add(c.w, x.w));
      if (base != nullptr) {
        const uint4 b = *reinterpret_cast<const uint4*>(base + o);
        c = make_uint4(add(c.x, b.x), add(c.y, b.y), add(c.z, b.z), add(c.w, b.w));
      }
      *y = c;
    }
  }
  // the two halves (rows 64 hm.., pixel rows h0 + hm BH / 2..) by the C map's
  // boxes of 64 channels x BW x BH / 2 pixels; a half wholly past H is skipped
  __device__ __forceinline__ void store(const CUtensorMap* tc, uint32_t cbase,
                                        const Tile& t) const {
    const int hb = p.bh >> 1;
#pragma unroll
    for (int hm = 0; hm < 2; ++hm)
      if (t.h0 + hm * hb < p.H) {
        sm90::tma_store_4d(tc, cbase + 2 * hm * (64 * 128), t.n0, t.w0, t.h0 + hm * hb, t.b);
        sm90::tma_store_4d(tc, cbase + (2 * hm + 1) * (64 * 128), t.n0 + 64, t.w0,
                           t.h0 + hm * hb, t.b);
      }
  }
};

template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
conv_sm90(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
          const __grid_constant__ CUtensorMap tc, const ConvArgs p) {
  gemm_core(&ta, &tw, &tc, ConvPolicy<EPI>{p});
}

// The map of a contiguous NHWC bf16 tensor (B, H, W, C) as (C, W, H, B):
// boxes of 64 channels x bw x bh pixels of one image, 128-byte swizzle;
// elements outside the image are zero-filled on a load and not written on a
// store.
inline bool nhwc_map(CUtensorMap* map, const void* ptr, int B, int H, int W, int C, int bw,
                     int bh) {
  const sm90::EncodeTiled fn = sm90::encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int EPI>
cudaError_t launch_conv_sm90(const ConvArgs& p, long long tiles, cudaStream_t stream) {
  cudaError_t e = sm90::configure<conv_sm90<EPI>>(GemmSmem::BYTES);
  if (e != cudaSuccess) return e;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int bw = 1 << p.bwl;
  CUtensorMap ta, tw, tc;
  if (!nhwc_map(&ta, p.x, p.B, p.H, p.W, p.Cin, bw, p.bh) ||
      !gemm_map(&tw, p.w, 1, 9 * p.Cin, p.Cout, GBK))
    return cudaErrorInvalidValue;
  if (EPI == EPI_HEAD)
    tc = ta;   // unused: EPI_HEAD writes fp32 from registers
  else if (!nhwc_map(&tc, p.out, p.B, p.H, p.W, p.Cout, bw, p.bh / 2))
    return cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  conv_sm90<EPI><<<grid, GEMM_THREADS, GemmSmem::BYTES, stream>>>(ta, tw, tc, p);
  return cudaGetLastError();
}

// ------------------------------------------------- fp32: FMA

constexpr int BM = 128, BN = 128, BKC = 32;   // pixels, output channels, K step
constexpr int FMA_THREADS = 256;

struct FmaLayout {
  static constexpr int LDA = BKC + 4;   // A tile rows, 2 stages
  static constexpr int LDB = BN + 4;    // B tile rows, 2 stages
  static constexpr int LDC = BN + 4;    // staged accumulator
  static constexpr int A_FLOATS = 2 * BM * LDA;
  static constexpr int AB = (A_FLOATS + 2 * BKC * LDB) * 4;
  static constexpr int C = BM * LDC * 4;
  static constexpr int BYTES = AB > C ? AB : C;
};

// thread (ty, tx) of 16 x 16 owns the outputs of rows ty * 8.., columns tx * 8..
template <int EPI, bool RELU>
__global__ void __launch_bounds__(FMA_THREADS) conv3x3_fp32(ConvArgs p) {
  using Lay = FmaLayout;
  extern __shared__ __align__(128) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + Lay::A_FLOATS;
  float* Cs = reinterpret_cast<float*>(smem);
  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.w);
  const int H = p.H, W = p.W, Cin = p.Cin, Cout = p.Cout;
  const int M = p.B * H * W;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  constexpr int ACPR = BKC / 4;                 // 16-byte A chunks per row
  constexpr int AN = BM * ACPR / FMA_THREADS;   // A chunks per thread
  constexpr int BCPR = BN / 4;                  // B chunks per row
  constexpr int BNC = BKC * BCPR / FMA_THREADS;
  // the pixel of each of this thread's A chunks, fixed over the K loop
  int pb[AN], ph[AN], pw[AN];
  bool pm[AN];
#pragma unroll
  for (int i = 0; i < AN; ++i) {
    const int r = (tid + i * FMA_THREADS) / ACPR, m = m0 + r;
    pm[i] = m < M;
    const int mm = pm[i] ? m : 0;
    pw[i] = mm % W;
    ph[i] = (mm / W) % H;
    pb[i] = mm / (W * H);
  }
  const int kc = Cin / BKC, nk = 9 * kc;

  auto a_chunk = [&](int stage, int i) {
    const int c = tid + i * FMA_THREADS;
    return As + stage * BM * Lay::LDA + (c / ACPR) * Lay::LDA + (c % ACPR) * 4;
  };
  auto load = [&](int stage, int kt) {
    const int tap = kt / kc, ci0 = (kt - tap * kc) * BKC;
    const int dh = tap / 3 - 1, dw = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < AN; ++i) {
      const int hh = ph[i] + dh, ww = pw[i] + dw;
      const bool ok = pm[i] && hh >= 0 && hh < H && ww >= 0 && ww < W;
      const int cc = ((tid + i * FMA_THREADS) % ACPR) * 4;
      const float* src = ok ? x + (((size_t)pb[i] * H + hh) * W + ww) * Cin + ci0 + cc : x;
      cp_async16(a_chunk(stage, i), src, ok ? 16 : 0);
    }
    float* bs = Bs + stage * BKC * Lay::LDB;
#pragma unroll
    for (int i = 0; i < BNC; ++i) {
      const int c = tid + i * FMA_THREADS, r = c / BCPR, nc = (c % BCPR) * 4;
      cp_async16(bs + r * Lay::LDB + nc, w + ((size_t)tap * Cin + ci0 + r) * Cout + n0 + nc, 16);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    if constexpr (RELU) {
      // this thread's own chunks of the stage have landed: relu them in place
#pragma unroll
      for (int i = 0; i < AN; ++i) {
        float* e = a_chunk(kt & 1, i);
#pragma unroll
        for (int j = 0; j < 4; ++j) e[j] = fmaxf(e[j], 0.f);
      }
    }
    __syncthreads();
    const float* as = As + (kt & 1) * BM * Lay::LDA;
    const float* bs = Bs + (kt & 1) * BKC * Lay::LDB;
    for (int kk = 0; kk < BKC; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = as[(ty * 8 + i) * Lay::LDA + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = bs[kk * Lay::LDB + tx * 8 + j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) Cs[(ty * 8 + i) * Lay::LDC + tx * 8 + j] = acc[i][j];
  __syncthreads();

  if constexpr (EPI == EPI_HEAD) {
    // Cout == BN: the whole channel row of each pixel is in this tile
    float* out = static_cast<float*>(p.out);
    const int C3 = p.C3;
    for (int e = tid; e < BM * C3; e += FMA_THREADS) {
      const int r = e / C3, j = e - r * C3, m = m0 + r;
      if (m >= M) continue;
      float s = 0.f;
      for (int c = 0; c < BN; ++c)
        s = fmaf(fmaxf(Cs[r * Lay::LDC + c] + p.bias[c], 0.f), p.w3[c * C3 + j], s);
      out[(size_t)m * C3 + j] = s + p.b3[j];
    }
  } else {
    float* out = static_cast<float*>(p.out);
    const float* resid = static_cast<const float*>(p.resid);
    const float* base = static_cast<const float*>(p.base);
    for (int e = tid; e < BM * BN; e += FMA_THREADS) {
      const int r = e / BN, c = e - r * BN, m = m0 + r, n = n0 + c;
      if (m >= M) continue;
      const size_t o = (size_t)m * Cout + n;
      float a = Cs[r * Lay::LDC + c] + p.bias[n];
      if constexpr (EPI == EPI_RELU) a = fmaxf(a, 0.f);
      if constexpr (EPI == EPI_RESID) {
        a = resid[o] + a;
        if (base != nullptr) a = a + base[o];
      }
      out[o] = a;
    }
  }
}

template <int EPI, bool RELU>
cudaError_t launch_conv_fp32(const ConvArgs& p, cudaStream_t s) {
  cudaError_t e = sm90::configure<conv3x3_fp32<EPI, RELU>>(FmaLayout::BYTES);
  if (e != cudaSuccess) return e;
  const long long M = (long long)p.B * p.H * p.W;
  dim3 grid((unsigned)((M + BM - 1) / BM), p.Cout / BN);
  conv3x3_fp32<EPI, RELU><<<grid, FMA_THREADS, FmaLayout::BYTES, s>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------- the upsample

template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// 16 bytes of T as four 32-bit words: element k as fp32, and V results packed
// back (rounded to T)
template <typename T>
struct Vec16;
template <>
struct Vec16<bf16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ float get(const uint32_t (&w)[4], int k) {
    const uint32_t x = w[k >> 1];
    return __uint_as_float(k & 1 ? x & 0xffff0000u : x << 16);
  }
  static __device__ __forceinline__ void put(uint32_t (&w)[4], const float (&r)[V]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = sm90::pack_bf16(r[2 * i], r[2 * i + 1]);
  }
};
template <>
struct Vec16<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ float get(const uint32_t (&w)[4], int k) {
    return __uint_as_float(w[k]);
  }
  static __device__ __forceinline__ void put(uint32_t (&w)[4], const float (&r)[V]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(r[i]);
  }
};

// 2x align_corners bilinear upsample, columns then rows, each rounded to
// storage: out = round(ah0 * t(r0) + ah1 * t(r1)), t(r) = round(aw0 * x[r, c0]
// + aw1 * x[r, c1]). Products are rounded before the sum (no FMA), as the
// separate products of a matmul. A block walks output rows blockIdx.y,
// blockIdx.y + gridDim.y, ...; a thread takes 16 bytes of channels of one
// output pixel of the row: four 16-byte loads (the two rows' two column
// taps) and one 16-byte store.
template <typename T>
__global__ void __launch_bounds__(256)
upsample2x_kernel(const T* __restrict__ x, T* __restrict__ out, const int* __restrict__ hidx,
                  const float* __restrict__ hwt, const int* __restrict__ widx,
                  const float* __restrict__ wwt, int B, int Hin, int Win, int C) {
  using Vc = Vec16<T>;
  constexpr int V = Vc::V;   // channels a thread
  const int Hout = 2 * Hin, Wout = 2 * Win, cv = C / V, per_row = Wout * cv;
  const auto ld = [](const T* src, uint32_t(&w)[4]) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  };
  for (int row = blockIdx.y; row < B * Hout; row += gridDim.y) {
    const int b = row / Hout, oh = row - b * Hout;
    const float ah0 = hwt[2 * oh], ah1 = hwt[2 * oh + 1];
    const T* x0 = x + ((size_t)b * Hin + hidx[2 * oh]) * Win * C;
    const T* x1 = x + ((size_t)b * Hin + hidx[2 * oh + 1]) * Win * C;
    T* orow = out + (size_t)row * Wout * C;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < per_row; i += gridDim.x * blockDim.x) {
      const int ow = i / cv, cc = (i - ow * cv) * V;
      const size_t s0 = (size_t)widx[2 * ow] * C + cc, s1 = (size_t)widx[2 * ow + 1] * C + cc;
      const float aw0 = wwt[2 * ow], aw1 = wwt[2 * ow + 1];
      uint32_t w00[4], w01[4], w10[4], w11[4];
      ld(x0 + s0, w00);
      ld(x0 + s1, w01);
      ld(x1 + s0, w10);
      ld(x1 + s1, w11);
      float r[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float t0 = round_to<T>(__fadd_rn(__fmul_rn(aw0, Vc::get(w00, k)),
                                               __fmul_rn(aw1, Vc::get(w01, k))));
        const float t1 = round_to<T>(__fadd_rn(__fmul_rn(aw0, Vc::get(w10, k)),
                                               __fmul_rn(aw1, Vc::get(w11, k))));
        r[k] = __fadd_rn(__fmul_rn(ah0, t0), __fmul_rn(ah1, t1));
      }
      uint32_t o[4];
      Vc::put(o, r);
      // streamed past L2 (written once, read by the next launch), so the
      // input rows the neighbouring output rows share stay there
      __stcs(reinterpret_cast<uint4*>(orow + (size_t)ow * C + cc), make_uint4(o[0], o[1], o[2], o[3]));
    }
  }
}

// (epilogue, operand relu) of the heads' four convs
inline bool conv_mode(int epi, int relu) {
  return epi == EPI_RELU ? relu == 1
                         : relu == 0 && (epi == EPI_ROUND || epi == EPI_RESID || epi == EPI_HEAD);
}

}  // namespace dpt
}  // namespace a3r

using namespace a3r;
using namespace a3r::dpt;

// One 3x3 SAME convolution with an epilogue (see the header). Tensors are
// contiguous NHWC in one storage dtype (bf16 or fp32) with 16-byte aligned
// rows; bias (16-byte aligned), w3 and b3 are fp32. bf16: Cin % 64 == 0
// (one 128-byte swizzle row a k-tile); fp32: Cin % 32 == 0. Cout % 128 == 0;
// EPI_HEAD needs Cout == 128 and 1 <= C3 <= 16; EPI_RESID needs resid.
// (epi, relu_in) is one of (EPI_ROUND, 0), (EPI_RELU, 1), (EPI_RESID, 0),
// (EPI_HEAD, 0).
A3R_EXPORT int a3r_conv3x3(const void* x, const void* w, const void* bias, void* out,
                           const void* resid, const void* base, const void* w3,
                           const void* b3, int B, int H, int W, int Cin, int Cout, int C3,
                           int epi, int relu_in, int is_bf16, void* stream) {
  const int bk = is_bf16 ? GBK : BKC;
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cin % bk || Cout <= 0 || Cout % GBN ||
      (long long)B * H * W > 0x7fffffffLL - GBM || Cout / GBN > 65535 ||
      !conv_mode(epi, relu_in) || bias == nullptr || (uintptr_t)bias % 16 ||
      (epi == EPI_HEAD && (Cout != GBN || C3 < 1 || C3 > MAX_C3 || !w3 || !b3)) ||
      (epi == EPI_RESID && !resid))
    return (int)cudaErrorInvalidValue;
  const int bw = conv_box_w(W), bh = GBM / bw;
  int bwl = 0;
  while ((1 << bwl) < bw) ++bwl;
  const int nn = Cout / GBN, nw = (W + bw - 1) / bw, nh = (H + bh - 1) / bh;
  const long long tiles = (long long)B * nh * nw * nn;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const ConvArgs p{x, w, (const float*)bias, out, resid, base, (const float*)w3,
                   (const float*)b3, B, H, W, Cin, Cout, C3, bwl, bh, nn, nw, nh,
                   (int)tiles, 9 * Cin / GBK};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (is_bf16) {
    switch (epi) {
      case EPI_ROUND: e = launch_conv_sm90<EPI_ROUND>(p, tiles, s); break;
      case EPI_RELU: e = launch_conv_sm90<EPI_RELU>(p, tiles, s); break;
      case EPI_RESID: e = launch_conv_sm90<EPI_RESID>(p, tiles, s); break;
      default: e = launch_conv_sm90<EPI_HEAD>(p, tiles, s); break;
    }
  } else {
    switch (epi) {
      case EPI_ROUND: e = launch_conv_fp32<EPI_ROUND, false>(p, s); break;
      case EPI_RELU: e = launch_conv_fp32<EPI_RELU, true>(p, s); break;
      case EPI_RESID: e = launch_conv_fp32<EPI_RESID, false>(p, s); break;
      default: e = launch_conv_fp32<EPI_HEAD, false>(p, s); break;
    }
  }
  return (int)e;
}

// x (B, Hin, Win, C) -> out (B, 2 Hin, 2 Win, C) in x's dtype, both 16-byte
// aligned with C * itemsize % 16 == 0; hidx/hwt (2 Hin, 2) and widx/wwt
// (2 Win, 2) hold each output row's and column's two source indices and
// weights.
A3R_EXPORT int a3r_upsample2x(const void* x, void* out, const void* hidx, const void* hwt,
                              const void* widx, const void* wwt, int B, int Hin, int Win,
                              int C, int is_bf16, void* stream) {
  const int V = is_bf16 ? 8 : 4;
  if (B <= 0 || Hin <= 0 || Win <= 0 || C <= 0 || C % V ||
      (long long)2 * Win * (C / V) > 0x7fffffffLL || (long long)2 * B * Hin > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // about 4096 blocks, each walking output rows gridDim.y apart
  const int per_row = 2 * Win * (C / V), rows = 2 * B * Hin;
  const int gx = (per_row + 255) / 256 < 65535 ? (per_row + 255) / 256 : 65535;
  const int gy = rows < 4096 / gx ? rows : (4096 / gx > 1 ? 4096 / gx : 1);
  const dim3 grid((unsigned)gx, (unsigned)gy);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    upsample2x_kernel<bf16><<<grid, 256, 0, s>>>(
        (const bf16*)x, (bf16*)out, (const int*)hidx, (const float*)hwt, (const int*)widx,
        (const float*)wwt, B, Hin, Win, C);
  else
    upsample2x_kernel<float><<<grid, 256, 0, s>>>(
        (const float*)x, (float*)out, (const int*)hidx, (const float*)hwt, (const int*)widx,
        (const float*)wwt, B, Hin, Win, C);
  return (int)cudaGetLastError();
}
