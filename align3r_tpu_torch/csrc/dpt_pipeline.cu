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
// fp32 (the heads at head_dtype fp32): conv_tf32_sm90<EPI>, the same walk,
// boxes and zero fill with fp32 operands on the tensor cores at fp32
// accuracy by 3xTF32 (x = hi + lo, hi = tf32(x), lo = tf32(x - hi); a
// product is a_lo b_hi + a_hi b_lo + a_hi b_hi in fp32, about 2^-21 of its
// magnitude: the fp32 policy of sm90_attention_tf32.cuh):
//   - A's k-tile is a box of 32 fp32 channels (one 128-byte swizzle row),
//     72 k-tiles at Cin = 256. TF32 wgmma has no transpose bit, so W is K-
//     major: the wrapper splits the taps once a call into hi and lo (2, Cout,
//     9 Cin), each 32-channel block in the order of the A fragments below.
//   - A is read from the landed stage into registers (wgmma's A-from-
//     registers form): the operand ReLU and the split happen there, and the
//     stage is read once, where a split copy in shared memory would be read
//     by three products and written once more (about 160 bytes a clock of
//     the SM's 128 against about 106 this way).
//   - Epilogues in fp32 (the roundings are the identity): acc + b, relu(acc
//     + b), v + (acc + b) [+ base], and EPI_HEAD as in bf16; stored from
//     registers (float2 a thread, whole 32-byte sectors a quad): a staged
//     fp32 tile would take 64 KB of the ring's shared memory.
// The upsample (upsample2x_kernel) moves 16 bytes of channels a thread:
// each output reads its two row and two column taps directly, with
// _interp_matrix's weights.
//
// What bounds them on the H100: operations. A K7 unit at the 72 x 128 level
// of a 32-pair decode batch is 2 x 2 x 294,912 x 9 x 256 x 256 = 0.70 TFLOP
// against about 60 MB of activations and weights: 0.70 ms of bf16 tensor-core
// time against 0.02 ms of memory; in fp32 three TF32 products each, 4.2 ms
// at 494.7 TFLOP/s. K8 at (32, 144, 256, 256) is 2.1 TFLOP; its
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

// Tile t of the walk: N fastest, then along W, H and B, so that a tile's 3x3
// halo was read by its neighbours moments before and is still in L2
struct ConvTile { int b, h0, w0, n0; };
__device__ __forceinline__ ConvTile conv_tile(const ConvArgs& p, int t) {
  ConvTile r;
  r.n0 = (t % p.nn) * GBN;
  t /= p.nn;
  r.w0 = (t % p.nw) << p.bwl;
  t /= p.nw;
  r.h0 = (t % p.nh) * p.bh;
  r.b = t / p.nh;
  return r;
}

template <int EPI>
struct ConvPolicy {
  static constexpr bool RELU_A = EPI == EPI_RELU, TMA_STORE = EPI != EPI_HEAD,
                        C_PASS = EPI == EPI_RESID;
  using Tile = ConvTile;
  struct Walk {
    const ConvArgs& p;
    int tiles, nk;
    __device__ __forceinline__ Tile at(int t) const { return conv_tile(p, t); }
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
  __device__ __forceinline__ uint32_t bias_bytes(const Tile&) const { return GBN * 4; }
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

// The map of a contiguous NHWC tensor (B, H, W, C), bf16 or fp32, as (C, W,
// H, B): boxes of one 128-byte swizzle row of channels (64 bf16, 32 fp32) x
// bw x bh pixels of one image; elements outside the image are zero-filled on
// a load and not written on a store.
inline bool nhwc_map(CUtensorMap* map, const void* ptr, int B, int H, int W, int C, int bw,
                     int bh, bool is_bf16 = true) {
  const sm90::EncodeTiled fn = sm90::encoder();
  if (fn == nullptr) return false;
  const cuuint64_t sz = is_bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {C * sz, W * C * sz, H * W * C * sz};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / sz), (cuuint32_t)bw, (cuuint32_t)bh, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
            const_cast<void*>(ptr), dims, strides, box,
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

// ------------------------------------------------- fp32: 3xTF32 on wgmma

constexpr int TBK = 32;            // fp32 channels of a k-tile: one 128-byte swizzle row
constexpr int TSTAGES = 4;         // depth of the (A, W hi, W lo) ring
constexpr int TF32_THREADS = 384;  // two consumer warpgroups, then the producer's

struct Tf32Smem {
  static constexpr int AB = GBM * TBK * 4;    // A: 128 pixels x 32 channels, 128-byte rows
  static constexpr int WB = GBN * TBK * 4;    // W hi or lo: 128 output channels x 32 k
  static constexpr int STAGE = AB + 2 * WB;
  static constexpr int W3 = TSTAGES * STAGE;  // EPI_HEAD: w3 (GBN, C3P), b3 at GBN MAX_C3
  static constexpr int BAR = W3 + (GBN + 1) * MAX_C3 * 4;   // full, empty [TSTAGES]
  static constexpr int BYTES = BAR + 2 * TSTAGES * 8 + 1024;   // + the base's alignment
  static_assert(AB % 1024 == 0 && WB % 1024 == 0, "tiles must keep 1024-byte alignment");
  static_assert(BYTES <= 232448, "the ring exceeds shared memory");
};

// TF32 A fragments (hi, lo) of the two k8 slices 2 pp, 2 pp + 1 from x0 and
// x1, one 16-byte chunk of this thread's rows r and r + 8: slice kk's k = q
// and q + 4 are channels 8 q + 2 kk and 8 q + 2 kk + 1 (the order the
// wrapper gave W's k rows, tf32_taps in ops/dpt_pipeline.py)
template <bool RELU>
__device__ __forceinline__ void tf32_frags(float4 x0, float4 x1, uint32_t (&hi)[2][4],
                                           uint32_t (&lo)[2][4]) {
  const float v[2][4] = {{x0.x, x1.x, x0.y, x1.y}, {x0.z, x1.z, x0.w, x1.w}};
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float y = RELU ? fmaxf(v[j][a], 0.f) : v[j][a];
      const float h = sm90::tf32_rna(y);
      hi[j][a] = __float_as_uint(h);
      lo[j][a] = __float_as_uint(sm90::tf32_rna(y - h));
    }
}

// K7/K8's fp32 3x3 convs: ConvPolicy's walk, box and zero fill with fp32
// operands, each product 3xTF32 on the tensor cores. Persistent: one block an
// SM walks the tiles in conv_tile order. The producer warpgroup's first
// thread keeps a ring of TSTAGES stages in flight by TMA: A's tap-shifted box
// of 32 channels, and W's hi and lo (Cout, 9 Cin) k-tiles. The two consumer
// warpgroups share each 128 x 128 tile, rows 64 wg.. each (64 fp32
// accumulators a thread). A consumer reads its A fragments from the landed
// stage (two 16-byte loads a k-tile per row; the channel order above makes
// them conflict-free through the swizzle), applies the operand ReLU, splits
// each value in registers and runs a_lo W_hi + a_hi W_lo + a_hi W_hi
// (wgmma.m64n128k8 tf32, A from registers, W K-major); one half k-tile's
// products stay in flight while the next half's fragments are made. The
// epilogue runs on the accumulators and stores fp32 from registers.
template <int EPI>
__global__ void __launch_bounds__(TF32_THREADS, 1)
conv_tf32_sm90(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
               const ConvArgs p) {
  using namespace sm90;
  using L = Tf32Smem;
  constexpr int S = TSTAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = gemm_smem_base(smem_raw);
  unsigned char* smem = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t full = base + L::BAR, empty = full + 8 * S;
  const int tid = threadIdx.x, nk = p.nk;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);   // the two consumers' eight warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float* w3s = reinterpret_cast<float*>(smem + L::W3);
  const int C3 = p.C3, C3P = (C3 + 3) & ~3;
  if constexpr (EPI == EPI_HEAD) {
    for (int e = tid; e < GBN * C3P; e += blockDim.x) {
      const int r = e / C3P, o = e - r * C3P;
      w3s[e] = o < C3 ? p.w3[r * C3 + o] : 0.f;
    }
    for (int o = tid; o < MAX_C3; o += blockDim.x) w3s[GBN * MAX_C3 + o] = o < C3 ? p.b3[o] : 0.f;
  }
  __syncthreads();

  if (tid >= 256) {   // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<GEMM_PRODUCER_REGS>();
    if (tid == 256) {
      const int kc = p.Cin / TBK;
      int it = 0;   // k-tiles issued, over all of this block's tiles
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const ConvTile tile = conv_tile(p, t);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % S, tap = kt / kc, c0 = (kt - tap * kc) * TBK;
          const int dh = tap / 3, dw = tap - 3 * dh;
          if (it >= S) mbar_wait(empty + 8 * s, (it / S - 1) & 1);
          const uint32_t bar = full + 8 * s, sa = base + s * L::STAGE;
          mbar_expect_tx(bar, L::STAGE);
          tma_load_4d(sa, &ta, bar, c0, tile.w0 + dw - 1, tile.h0 + dh - 1, tile.b);
          tma_load(sa + L::AB, &tw, bar, kt * TBK, tile.n0, 0);
          tma_load(sa + L::AB + L::WB, &tw, bar, kt * TBK, tile.n0, 1);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<GEMM_CONSUMER_REGS>();
  const int warp = tid >> 5, lane = tid & 31, q = lane & 3, c = 2 * q;
  const int r0 = 64 * (warp >> 2) + 16 * (warp & 3) + (lane >> 2);   // tile rows r0, r0 + 8
  // chunk 2 q + pp of row r lies at chunk (2 q + pp) ^ (r % 8) (the 128-byte swizzle)
  const int off0 = r0 * 128 + (((2 * q) ^ (r0 & 7)) << 4);
  const int off1 = r0 * 128 + (((2 * q + 1) ^ (r0 & 7)) << 4);
  int it = 0;   // k-tiles consumed, over all of this block's tiles
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    float acc[GBN / 2];
#pragma unroll
    for (int e = 0; e < GBN / 2; ++e) acc[e] = 0.f;
    uint32_t h0[2][4], l0[2][4], h1[2][4], l1[2][4];   // the k-tile's two halves
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % S;
      const uint32_t sw = base + s * L::STAGE + L::AB;   // W hi; W lo WB on
      const unsigned char* sa = smem + s * L::STAGE;
      mbar_wait(full + 8 * s, (it / S) & 1);
      // slices 0 and 1 (channels 8 q + 0..3), then the previous k-tile's
      // products are done: hand its stage back
      tf32_frags<EPI == EPI_RELU>(*reinterpret_cast<const float4*>(sa + off0),
                                  *reinterpret_cast<const float4*>(sa + off0 + 8 * 128), h0, l0);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint64_t bh = make_desc(sw + 32 * j, 16, 1024, 1);
        const uint64_t bl = make_desc(sw + L::WB + 32 * j, 16, 1024, 1);
        WgmmaTf32<GBN>::rs(acc, l0[j], bh);
        WgmmaTf32<GBN>::rs(acc, h0[j], bl);
        WgmmaTf32<GBN>::rs(acc, h0[j], bh);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % S));
      // slices 2 and 3 (channels 8 q + 4..7)
      tf32_frags<EPI == EPI_RELU>(*reinterpret_cast<const float4*>(sa + off1),
                                  *reinterpret_cast<const float4*>(sa + off1 + 8 * 128), h1, l1);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint64_t bh = make_desc(sw + 32 * (2 + j), 16, 1024, 1);
        const uint64_t bl = make_desc(sw + L::WB + 32 * (2 + j), 16, 1024, 1);
        WgmmaTf32<GBN>::rs(acc, l1[j], bh);
        WgmmaTf32<GBN>::rs(acc, h1[j], bl);
        WgmmaTf32<GBN>::rs(acc, h1[j], bh);
      }
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    pin(acc);
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % S));   // the tile's last stage

    // epilogue: acc[4 j + 2 h + e] is tile row r0 + 8 h, column n0 + 8 j + c +
    // e; row r is pixel (h0 + r / BW, w0 + r % BW), stored where it lies in
    // the image. fp32 adds in conv3x3_plain's order.
    const ConvTile tile = conv_tile(p, t);
    const float* bias = p.bias + tile.n0 + c;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const int hh = tile.h0 + (r >> p.bwl), ww = tile.w0 + (r & ((1 << p.bwl) - 1));
      const bool in = hh < p.H && ww < p.W;
      const size_t pix = ((size_t)tile.b * p.H + hh) * p.W + ww;
#pragma unroll
      for (int j = 0; j < GBN / 8; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j);
        acc[4 * j + 2 * h] += b.x;
        acc[4 * j + 2 * h + 1] += b.y;
        if constexpr (EPI == EPI_RELU || EPI == EPI_HEAD) {
          acc[4 * j + 2 * h] = fmaxf(acc[4 * j + 2 * h], 0.f);
          acc[4 * j + 2 * h + 1] = fmaxf(acc[4 * j + 2 * h + 1], 0.f);
        }
      }
      if constexpr (EPI == EPI_HEAD) {
        // out[pix, o] = b3[o] + sum_k relu(a[k]) w3[k, o] over the tile's 128
        // channels (Cout == GBN): this thread's 32, then the quad's
        float* out = static_cast<float*>(p.out) + pix * C3;
        for (int o0 = 0; o0 < C3; o0 += 4) {
          float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int j = 0; j < GBN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = acc[4 * j + 2 * h + e];
              const float4 w = *reinterpret_cast<const float4*>(w3s + (8 * j + c + e) * C3P + o0);
              s4[0] = fmaf(v, w.x, s4[0]);
              s4[1] = fmaf(v, w.y, s4[1]);
              s4[2] = fmaf(v, w.z, s4[2]);
              s4[3] = fmaf(v, w.w, s4[3]);
            }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            s4[k] += __shfl_xor_sync(0xffffffffu, s4[k], 1);
            s4[k] += __shfl_xor_sync(0xffffffffu, s4[k], 2);
            s4[k] += w3s[GBN * MAX_C3 + o0 + k];
          }
          if (in && q == (o0 >> 2)) {   // one lane of the quad per 4 outputs
            if (C3 % 4 == 0) {
              *reinterpret_cast<float4*>(out + o0) = make_float4(s4[0], s4[1], s4[2], s4[3]);
            } else {
#pragma unroll
              for (int k = 0; k < 4; ++k)
                if (o0 + k < C3) out[o0 + k] = s4[k];
            }
          }
        }
      } else if (in) {
        const size_t o = pix * p.Cout + tile.n0 + c;
        float* out = static_cast<float*>(p.out) + o;
        if constexpr (EPI == EPI_RESID) {
          const float* v = static_cast<const float*>(p.resid) + o;
          const float* bs = static_cast<const float*>(p.base);
#pragma unroll
          for (int j = 0; j < GBN / 8; ++j) {
            const float2 x = *reinterpret_cast<const float2*>(v + 8 * j);
            acc[4 * j + 2 * h] = x.x + acc[4 * j + 2 * h];
            acc[4 * j + 2 * h + 1] = x.y + acc[4 * j + 2 * h + 1];
          }
          if (bs != nullptr) {
#pragma unroll
            for (int j = 0; j < GBN / 8; ++j) {
              const float2 x = *reinterpret_cast<const float2*>(bs + o + 8 * j);
              acc[4 * j + 2 * h] += x.x;
              acc[4 * j + 2 * h + 1] += x.y;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < GBN / 8; ++j)
          *reinterpret_cast<float2*>(out + 8 * j) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// The map of the split taps (2, Cout, 9 Cin) fp32 as (9 Cin, Cout, 2): boxes
// of 32 k x 128 output channels, 128-byte swizzle
inline bool tf32_taps_map(CUtensorMap* map, const void* ptr, int Cout, int K) {
  const sm90::EncodeTiled fn = sm90::encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)Cout, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)K * 4, (cuuint64_t)Cout * K * 4};
  const cuuint32_t box[3] = {TBK, GBN, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int EPI>
cudaError_t launch_conv_tf32(const ConvArgs& p, cudaStream_t stream) {
  cudaError_t e = sm90::configure<conv_tf32_sm90<EPI>>(Tf32Smem::BYTES);
  if (e != cudaSuccess) return e;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  CUtensorMap ta, tw;
  if (!nhwc_map(&ta, p.x, p.B, p.H, p.W, p.Cin, 1 << p.bwl, p.bh, false) ||
      !tf32_taps_map(&tw, p.w, p.Cout, 9 * p.Cin))
    return cudaErrorInvalidValue;
  const int grid = p.tiles < sms ? p.tiles : sms;
  conv_tf32_sm90<EPI><<<grid, TF32_THREADS, Tf32Smem::BYTES, stream>>>(ta, tw, p);
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
// rows; bias (16-byte aligned), w3 and b3 are fp32. w: bf16 the taps (9, Cin,
// Cout); fp32 their TF32 split (2, Cout, 9 Cin) in the kernel's k order
// (tf32_taps, ops/dpt_pipeline.py). A k-tile is one 128-byte swizzle row of
// channels: Cin % 64 == 0 in bf16, Cin % 32 == 0 in fp32. Cout % 128 == 0;
// EPI_HEAD needs Cout == 128 and 1 <= C3 <= 16; EPI_RESID needs resid.
// (epi, relu_in) is one of (EPI_ROUND, 0), (EPI_RELU, 1), (EPI_RESID, 0),
// (EPI_HEAD, 0).
A3R_EXPORT int a3r_conv3x3(const void* x, const void* w, const void* bias, void* out,
                           const void* resid, const void* base, const void* w3,
                           const void* b3, int B, int H, int W, int Cin, int Cout, int C3,
                           int epi, int relu_in, int is_bf16, void* stream) {
  const int bk = is_bf16 ? GBK : TBK;
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
                   (int)tiles, 9 * Cin / bk};
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
      case EPI_ROUND: e = launch_conv_tf32<EPI_ROUND>(p, s); break;
      case EPI_RELU: e = launch_conv_tf32<EPI_RELU>(p, s); break;
      case EPI_RESID: e = launch_conv_tf32<EPI_RESID>(p, s); break;
      default: e = launch_conv_tf32<EPI_HEAD>(p, s); break;
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
