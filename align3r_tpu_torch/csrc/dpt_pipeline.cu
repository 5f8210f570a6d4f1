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
// Both are built from one implicit-GEMM 3x3 convolution (conv3x3_kernel):
// M = pixels, N = output channels, K = 9 taps x input channels, a block tile
// of 128 pixels x 128 channels with a K step of 32 channels of one tap, a
// two-stage cp.async ring (zero-filled where the tap falls outside the image:
// the SAME padding), WMMA bf16 -> fp32 for bf16 (8 warps, 64 x 32 each) and
// scalar FMA in fp32 without TF32 for fp32 (8 x 8 outputs a thread). The
// operand ReLU is applied in shared memory by the thread that copied each
// chunk, after its copy landed. The accumulator tile is staged through
// shared memory in fp32 for the epilogues:
//   EPI_ROUND  out = round(acc + bias)                       (K7 conv 1, K8 conv 1)
//   EPI_RESID  out = round(round(v + round(acc + bias)) + base)  (K7 conv 2)
//   EPI_HEAD   out = relu(acc + bias) w3 + b3 in fp32, the 1 x 1 conv over
//              the tile's 128 channels                       (K8 conv 2)
// K7 is two launches with the intermediate in device memory; K8 is conv 1,
// the upsample (upsample2x_kernel: each output reads its two row and two
// column taps directly, with _interp_matrix's weights, not a dense banded
// matmul) and conv 2 + the 1 x 1, with h1 and h2 in device memory. The TPU
// kernels keep those intermediates in VMEM; keeping them on the chip is
// later work.
//
// What bounds them on the H100: operations. A K7 unit at the 72 x 128 level
// of a 32-pair decode batch is 2 x 2 x 294,912 x 9 x 256 x 256 = 0.70 TFLOP
// against about 60 MB of activations and weights: 0.70 ms of bf16 tensor-core
// time against 0.02 ms of memory. K8 at (32, 144, 256, 256) is 2.1 TFLOP.
#include "common.cuh"

#include <mma.h>

#include <type_traits>

namespace a3r {
namespace dpt {

constexpr int BM = 128, BN = 128, BKC = 32;   // pixels, output channels, K step
constexpr int THREADS = 256;
constexpr int MAX_C3 = 16;

enum Epi : int { EPI_ROUND = 0, EPI_RESID = 1, EPI_HEAD = 2 };

template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

template <typename T>
struct ConvLayout {
  static constexpr int PADT = 16 / sizeof(T);
  static constexpr int LDA = BKC + PADT;     // A tile rows (T), 2 stages
  static constexpr int LDB = BN + PADT;      // B tile rows (T), 2 stages
  static constexpr int LDC = BN + 4;         // staged accumulator (fp32)
  static constexpr int A_BYTES = 2 * BM * LDA * (int)sizeof(T);
  static constexpr int AB = A_BYTES + 2 * BKC * LDB * (int)sizeof(T);
  static constexpr int C = BM * LDC * 4;
  static constexpr int BYTES = AB > C ? AB : C;
};

struct ConvArgs {
  const void* x;       // (B, H, W, Cin)
  const void* w;       // (9, Cin, Cout), taps dh * 3 + dw
  const float* bias;   // (Cout,)
  void* out;           // (B, H, W, Cout) storage, or (B, H, W, C3) fp32 for EPI_HEAD
  const void* resid;   // EPI_RESID: v (B, H, W, Cout)
  const void* base;    // EPI_RESID: optional base (B, H, W, Cout)
  const float* w3;     // EPI_HEAD: (Cout, C3)
  const float* b3;     // EPI_HEAD: (C3,)
  int B, H, W, Cin, Cout, C3;
};

// the block's 128 x 128 product, bf16 on WMMA: 8 warps, 2 x 4, 64 x 32 each
template <typename T>
struct TileMma;

template <>
struct TileMma<bf16> {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[4][2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.0f);
  }
  __device__ __forceinline__ void step(const bf16* as, const bf16* bs) {
    using namespace nvcuda;
    using Lay = ConvLayout<bf16>;
    const int warp = threadIdx.x >> 5, wm = warp >> 2, wn = warp & 3;
#pragma unroll
    for (int kk = 0; kk < BKC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], as + (wm * 64 + i * 16) * Lay::LDA + kk, Lay::LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], bs + kk * Lay::LDB + wn * 32 + j * 16, Lay::LDB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  __device__ __forceinline__ void store(float* Cs) {
    using Lay = ConvLayout<bf16>;
    const int warp = threadIdx.x >> 5, wm = warp >> 2, wn = warp & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        nvcuda::wmma::store_matrix_sync(Cs + (wm * 64 + i * 16) * Lay::LDC + wn * 32 + j * 16,
                                        acc[i][j], Lay::LDC, nvcuda::wmma::mem_row_major);
  }
};

// fp32 on FMA: thread (ty, tx) of 16 x 16 owns rows ty * 8.., columns tx * 8..
template <>
struct TileMma<float> {
  float acc[8][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  __device__ __forceinline__ void step(const float* as, const float* bs) {
    using Lay = ConvLayout<float>;
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
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
  }
  __device__ __forceinline__ void store(float* Cs) {
    using Lay = ConvLayout<float>;
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) Cs[(ty * 8 + i) * Lay::LDC + tx * 8 + j] = acc[i][j];
  }
};

template <typename T, int EPI, bool RELU>
__global__ void __launch_bounds__(THREADS) conv3x3_kernel(ConvArgs p) {
  using Lay = ConvLayout<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + Lay::A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);
  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);
  const int H = p.H, W = p.W, Cin = p.Cin, Cout = p.Cout;
  const int M = p.B * H * W;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  constexpr int EPC = 16 / sizeof(T);          // elements per 16-byte chunk
  constexpr int ACPR = BKC / EPC;              // A chunks per row
  constexpr int AN = BM * ACPR / THREADS;      // A chunks per thread
  constexpr int BCPR = BN / EPC;               // B chunks per row
  constexpr int BNC = BKC * BCPR / THREADS;    // B chunks per thread
  // the pixel of each of this thread's A chunks, fixed over the K loop
  int pb[AN], ph[AN], pw[AN];
  bool pm[AN];
#pragma unroll
  for (int i = 0; i < AN; ++i) {
    const int r = (tid + i * THREADS) / ACPR, m = m0 + r;
    pm[i] = m < M;
    const int mm = pm[i] ? m : 0;
    pw[i] = mm % W;
    ph[i] = (mm / W) % H;
    pb[i] = mm / (W * H);
  }
  const int kc = Cin / BKC, nk = 9 * kc;

  auto a_chunk = [&](int stage, int i) {
    const int c = tid + i * THREADS;
    return As + stage * BM * Lay::LDA + (c / ACPR) * Lay::LDA + (c % ACPR) * EPC;
  };
  auto load = [&](int stage, int kt) {
    const int tap = kt / kc, ci0 = (kt - tap * kc) * BKC;
    const int dh = tap / 3 - 1, dw = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < AN; ++i) {
      const int hh = ph[i] + dh, ww = pw[i] + dw;
      const bool ok = pm[i] && hh >= 0 && hh < H && ww >= 0 && ww < W;
      const int cc = ((tid + i * THREADS) % ACPR) * EPC;
      const T* src = ok ? x + (((size_t)pb[i] * H + hh) * W + ww) * Cin + ci0 + cc : x;
      cp_async16(a_chunk(stage, i), src, ok ? 16 : 0);
    }
    T* bs = Bs + stage * BKC * Lay::LDB;
#pragma unroll
    for (int i = 0; i < BNC; ++i) {
      const int c = tid + i * THREADS, r = c / BCPR, nc = (c % BCPR) * EPC;
      cp_async16(bs + r * Lay::LDB + nc, w + ((size_t)tap * Cin + ci0 + r) * Cout + n0 + nc, 16);
    }
  };

  TileMma<T> mma;
  mma.zero();
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
        T* e = a_chunk(kt & 1, i);
#pragma unroll
        for (int j = 0; j < EPC; ++j) e[j] = from_f32<T>(fmaxf(to_f32(e[j]), 0.f));
      }
    }
    __syncthreads();
    mma.step(As + (kt & 1) * BM * Lay::LDA, Bs + (kt & 1) * BKC * Lay::LDB);
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();
  mma.store(Cs);
  __syncthreads();

  if constexpr (EPI == EPI_HEAD) {
    // Cout == BN: the whole channel row of each pixel is in this tile
    float* out = static_cast<float*>(p.out);
    const int C3 = p.C3;
    for (int e = tid; e < BM * C3; e += THREADS) {
      const int r = e / C3, j = e - r * C3, m = m0 + r;
      if (m >= M) continue;
      float s = 0.f;
      for (int c = 0; c < BN; ++c)
        s = fmaf(fmaxf(Cs[r * Lay::LDC + c] + p.bias[c], 0.f), p.w3[c * C3 + j], s);
      out[(size_t)m * C3 + j] = s + p.b3[j];
    }
  } else {
    T* out = static_cast<T*>(p.out);
    const T* resid = static_cast<const T*>(p.resid);
    const T* base = static_cast<const T*>(p.base);
    for (int e = tid; e < BM * BN; e += THREADS) {
      const int r = e / BN, c = e - r * BN, m = m0 + r, n = n0 + c;
      if (m >= M) continue;
      const size_t o = (size_t)m * Cout + n;
      float a = round_to<T>(Cs[r * Lay::LDC + c] + p.bias[n]);
      if constexpr (EPI == EPI_RESID) {
        a = round_to<T>(to_f32(resid[o]) + a);
        if (base != nullptr) a = round_to<T>(a + to_f32(base[o]));
      }
      out[o] = from_f32<T>(a);
    }
  }
}

// 2x align_corners bilinear upsample, columns then rows, each rounded to
// storage: out = round(ah0 * t(r0) + ah1 * t(r1)), t(r) = round(aw0 * x[r, c0]
// + aw1 * x[r, c1]). Products are rounded before the sum (no FMA), as the
// separate products of a matmul.
template <typename T>
__global__ void __launch_bounds__(256)
upsample2x_kernel(const T* __restrict__ x, T* __restrict__ out, const int* __restrict__ hidx,
                  const float* __restrict__ hwt, const int* __restrict__ widx,
                  const float* __restrict__ wwt, int B, int Hin, int Win, int C) {
  const int Hout = 2 * Hin, Wout = 2 * Win;
  const size_t total = (size_t)B * Hout * Wout * C;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(e % C);
    size_t t = e / C;
    const int ow = (int)(t % Wout);
    t /= Wout;
    const int oh = (int)(t % Hout);
    const size_t b = t / Hout;
    const T* xb = x + b * Hin * Win * C + c;
    const int c0 = widx[2 * ow], c1 = widx[2 * ow + 1];
    const float w0 = wwt[2 * ow], w1 = wwt[2 * ow + 1];
    auto cols = [&](int r) {
      const T* row = xb + (size_t)r * Win * C;
      return round_to<T>(__fadd_rn(__fmul_rn(w0, to_f32(row[(size_t)c0 * C])),
                                   __fmul_rn(w1, to_f32(row[(size_t)c1 * C]))));
    };
    const float t0 = cols(hidx[2 * oh]), t1 = cols(hidx[2 * oh + 1]);
    out[e] = from_f32<T>(__fadd_rn(__fmul_rn(hwt[2 * oh], t0), __fmul_rn(hwt[2 * oh + 1], t1)));
  }
}

template <typename T, int EPI, bool RELU>
cudaError_t launch_conv(const ConvArgs& p, cudaStream_t s) {
  using Lay = ConvLayout<T>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(conv3x3_kernel<T, EPI, RELU>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::BYTES);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const long long M = (long long)p.B * p.H * p.W;
  dim3 grid((unsigned)((M + BM - 1) / BM), p.Cout / BN);
  conv3x3_kernel<T, EPI, RELU><<<grid, THREADS, Lay::BYTES, s>>>(p);
  return cudaGetLastError();
}

// the four (epilogue, operand relu) pairs the heads use
template <typename T>
cudaError_t conv_by_mode(const ConvArgs& p, int epi, int relu, cudaStream_t s) {
  if (epi == EPI_ROUND && relu) return launch_conv<T, EPI_ROUND, true>(p, s);
  if (epi == EPI_ROUND) return launch_conv<T, EPI_ROUND, false>(p, s);
  if (epi == EPI_RESID && relu) return launch_conv<T, EPI_RESID, true>(p, s);
  if (epi == EPI_HEAD && !relu) return launch_conv<T, EPI_HEAD, false>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace dpt
}  // namespace a3r

using namespace a3r::dpt;

// One 3x3 SAME convolution with an epilogue (see the header). Tensors are
// contiguous NHWC in one storage dtype (bf16 or fp32) with 16-byte aligned
// rows; bias, w3 and b3 are fp32. Cin % 32 == 0 and Cout % 128 == 0;
// EPI_HEAD needs Cout == 128 and 1 <= C3 <= 16; EPI_RESID needs resid.
A3R_EXPORT int a3r_conv3x3(const void* x, const void* w, const void* bias, void* out,
                           const void* resid, const void* base, const void* w3,
                           const void* b3, int B, int H, int W, int Cin, int Cout, int C3,
                           int epi, int relu_in, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cin % BKC || Cout <= 0 || Cout % BN ||
      (long long)B * H * W > 0x7fffffffLL - BM || Cout / BN > 65535 ||
      (epi == EPI_HEAD && (Cout != BN || C3 < 1 || C3 > MAX_C3 || !w3 || !b3)) ||
      (epi == EPI_RESID && !resid))
    return (int)cudaErrorInvalidValue;
  ConvArgs p{x, w, (const float*)bias, out, resid, base, (const float*)w3, (const float*)b3,
             B, H, W, Cin, Cout, C3};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_bf16 ? conv_by_mode<bf16>(p, epi, relu_in, s)
                       : conv_by_mode<float>(p, epi, relu_in, s));
}

// x (B, Hin, Win, C) -> out (B, 2 Hin, 2 Win, C) in x's dtype; hidx/hwt
// (2 Hin, 2) and widx/wwt (2 Win, 2) hold each output row's and column's
// two source indices and weights.
A3R_EXPORT int a3r_upsample2x(const void* x, void* out, const void* hidx, const void* hwt,
                              const void* widx, const void* wwt, int B, int Hin, int Win,
                              int C, int is_bf16, void* stream) {
  if (B <= 0 || Hin <= 0 || Win <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const long long total = 4LL * B * Hin * Win * C;
  const long long blocks = (total + 255) / 256;
  const unsigned grid = (unsigned)(blocks < 132 * 64 ? blocks : 132 * 64);
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
