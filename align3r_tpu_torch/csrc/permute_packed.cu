// K5: the row permute that assembles the solve's packed observations.
//
// Replaces align3r_tpu/ops/edge_loss.py permute_packed (:360-439; the
// Pallas kernel `kern` :417, pallas_call :425). For each packed slot s:
//   t = perm[s]
//   pred_out[s] = t < E ? pred_i[t] : pred_j[t - E]          (3A values)
//   w_out[s]    = (t < E ? w_i[t] : w_j[t - E]) * valid[s]   (A values)
// in the pack's storage type (bf16 or fp32). Rows are clamped to [0, E)
// as the TPU kernel's block index maps clamp them. A slot with valid 0 keeps
// its points and gets weight w * 0.
//
// What bounds it on the H100: memory bandwidth, and nothing else: it is a
// gather copy with no arithmetic beyond the multiply by valid. At 24 frames
// (e2 = 380 slots, A = 147,456) it reads and writes 4 A values per slot,
// 0.90 GB in bf16 and 1.79 GB in fp32: 0.27 ms and 0.53 ms at 3.35 TB/s.
// The design spends every byte once:
//   - one block per (slot, 16 KB tile of its pred row or its w row); each
//     block reads its own perm[s] and valid[s], so no index pass precedes it;
//   - it reads only the source row it needs. The TPU kernel fetched the i
//     and the j row of every slot and selected in a register, because a
//     data-dependent DMA source costs a branch there; here the branch is
//     uniform over the block and reading one row halves the read traffic;
//   - 16-byte vector loads and stores where every row starts on a 16-byte
//     boundary (the wrapper checks), element copies otherwise; a slot whose
//     valid is not 1 takes the element path and multiplies in fp32, which
//     rounds back exactly for 0 and 1.
#include "common.cuh"

namespace a3r {

constexpr int PTHREADS = 256;
constexpr int PUNROLL = 4;                            // 16-byte vectors per thread
constexpr int PTILE_BYTES = PTHREADS * PUNROLL * 16;  // bytes per block

__device__ __forceinline__ float from_f32(float x, float) { return x; }
__device__ __forceinline__ bf16 from_f32(float x, bf16) { return __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(PTHREADS)
permute_packed_kernel(const T* __restrict__ pred_i, const T* __restrict__ pred_j,
                      const T* __restrict__ w_i, const T* __restrict__ w_j,
                      const int* __restrict__ perm, const int* __restrict__ valid,
                      T* __restrict__ pred_out, T* __restrict__ w_out, int E,
                      long long A, int pred_tiles, int vec) {
  constexpr int EPV = 16 / sizeof(T);                 // elements per vector
  constexpr int TILE = PTHREADS * PUNROLL * EPV;      // elements per block
  const int s = blockIdx.y, tid = threadIdx.x;
  const int t = perm[s];
  const bool from_i = t < E;
  const long long row = min(max(from_i ? t : t - E, 0), E - 1);
  const bool is_pred = (int)blockIdx.x < pred_tiles;
  const long long n = is_pred ? 3 * A : A;            // elements in the row
  const T* src = is_pred ? (from_i ? pred_i : pred_j) + row * 3 * A
                         : (from_i ? w_i : w_j) + row * A;
  T* dst = is_pred ? pred_out + (long long)s * 3 * A : w_out + (long long)s * A;
  const long long base = (long long)(is_pred ? blockIdx.x : blockIdx.x - pred_tiles) * TILE;
  const int v = is_pred ? 1 : valid[s];
  if (v == 1 && vec) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src + base);
    uint4* d4 = reinterpret_cast<uint4*>(dst + base);
    const long long nv = (n - base) / EPV;            // whole vectors left in the row
#pragma unroll
    for (int k = 0; k < PUNROLL; ++k) {
      const long long i = (long long)k * PTHREADS + tid;
      if (i < nv) d4[i] = __ldg(s4 + i);
    }
    return;
  }
  const float vf = to_f32(from_f32((float)v, T()));
  for (int k = 0; k < PUNROLL * EPV; ++k) {
    const long long i = base + (long long)k * PTHREADS + tid;
    if (i < n) dst[i] = v == 1 ? src[i] : from_f32(to_f32(src[i]) * vf, T());
  }
}

}  // namespace a3r

using namespace a3r;

A3R_EXPORT int a3r_permute_tiles(long long n_bytes) {
  return (int)((n_bytes + PTILE_BYTES - 1) / PTILE_BYTES);
}

A3R_EXPORT int a3r_permute_packed(const void* pred_i, const void* pred_j,
                                  const void* w_i, const void* w_j,
                                  const void* perm, const void* valid,
                                  void* pred_out, void* w_out, int E, int e2,
                                  long long A, int bf16_obs, int vec,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long isz = bf16_obs ? 2 : 4;
  const int pred_tiles = a3r_permute_tiles(3 * A * isz);
  dim3 grid(pred_tiles + a3r_permute_tiles(A * isz), e2);
  if (bf16_obs)
    permute_packed_kernel<bf16><<<grid, PTHREADS, 0, st>>>(
        (const bf16*)pred_i, (const bf16*)pred_j, (const bf16*)w_i, (const bf16*)w_j,
        (const int*)perm, (const int*)valid, (bf16*)pred_out, (bf16*)w_out, E, A,
        pred_tiles, vec);
  else
    permute_packed_kernel<float><<<grid, PTHREADS, 0, st>>>(
        (const float*)pred_i, (const float*)pred_j, (const float*)w_i,
        (const float*)w_j, (const int*)perm, (const int*)valid, (float*)pred_out,
        (float*)w_out, E, A, pred_tiles, vec);
  return (int)cudaGetLastError();
}
