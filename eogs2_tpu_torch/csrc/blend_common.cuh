// What the port's blend kernels (K1-K4) share: the tile shape, the skip and
// stop constants of the CUDA reference's renderCUDA (forward.cu), and the
// staging of one fused-route pair into shared memory in either payload
// layout. ops/cuda_build.py hashes this header with every source that
// includes it, so an edit here rebuilds them all.

#pragma once

#include <cuda_runtime.h>

namespace eogs2 {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;  // threads per block, one per pixel
constexpr int NC = 5;             // feature channels
constexpr int NWARP = PIX / 32;
constexpr unsigned FULL = 0xffffffffu;

// fused-route payload: 11 fields per pair (mx, my, conic a, b, c, opacity,
// 5 features); the row layout pads each pair to one 64-byte row
constexpr int NF = 11;
constexpr int NFR = 16;

// Stage pair p of a fused-route payload into column `slot` of batch[NF][PIX].
// Column layout (K1, K2): field f of pair p at pay[f * stride + p].
// Row layout (K3): pair p is the 16 floats at pay[p * 16], fields 0-10 used.
template <bool ROWS>
__device__ __forceinline__ void stage_pair(float (*batch)[PIX], int slot,
                                           const float* __restrict__ pay,
                                           long long stride, long long p) {
  if (ROWS) {
    const float4* src = reinterpret_cast<const float4*>(pay + p * NFR);
    const float4 r0 = src[0], r1 = src[1], r2 = src[2];
    batch[0][slot] = r0.x;
    batch[1][slot] = r0.y;
    batch[2][slot] = r0.z;
    batch[3][slot] = r0.w;
    batch[4][slot] = r1.x;
    batch[5][slot] = r1.y;
    batch[6][slot] = r1.z;
    batch[7][slot] = r1.w;
    batch[8][slot] = r2.x;
    batch[9][slot] = r2.y;
    batch[10][slot] = r2.z;
  } else {
    const float* src = pay + p;
#pragma unroll
    for (int f = 0; f < NF; ++f) batch[f][slot] = src[(long long)f * stride];
  }
}

// The largest v over the block's PIX threads (every thread must call it);
// smem holds NWARP ints and may be reused once it returns.
__device__ __forceinline__ int block_max(int v, int* smem) {
  v = __reduce_max_sync(FULL, v);
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = smem[0];
#pragma unroll
  for (int w = 1; w < NWARP; ++w) m = max(m, smem[w]);
  __syncthreads();
  return m;
}

// K4's packed table [T, 16, K]: the number of slots up to the tile's last
// pair (mask row 11 set), so the kernels skip the trailing empty slots. An
// empty slot changes nothing (alpha 0, log1p(-0) = 0) and stays live.
__device__ __forceinline__ int slots_in_use(const float* __restrict__ mask,
                                            int K, int* smem) {
  int last = 0;
  for (int k = threadIdx.x; k < K; k += PIX)
    if (mask[k] > 0.5f) last = k + 1;
  return block_max(last, smem);
}

}  // namespace eogs2

// the plain versions compare float32 tensors with Python doubles, which
// torch rounds to float32 once: round the same doubles here
#define ALPHA_EPS ((float)(1.0 / 255.0))
#define ALPHA_MAX ((float)0.99)
#define T_EPS ((float)1e-4)
#define POWER_TOL ((float)1e-4)
