// What the port's blend kernels (K1-K4) share: the tile shape, the skip and
// stop constants of the CUDA reference's renderCUDA (forward.cu), and the
// staging of fused-route pairs into shared memory in either payload layout.
// ops/cuda_build.py hashes this header with every source that includes it,
// so an edit here rebuilds them all.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

// the plain versions compare float32 tensors with Python doubles, which
// torch rounds to float32 once: round the same doubles here
#define ALPHA_EPS ((float)(1.0 / 255.0))
#define ALPHA_MAX ((float)0.99)
#define T_EPS ((float)1e-4)
#define POWER_TOL ((float)1e-4)

namespace eogs2 {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;  // pixels per tile (K4: threads per block)
constexpr int NC = 5;             // feature channels
constexpr int NWARP = PIX / 32;
constexpr unsigned FULL = 0xffffffffu;

// fused-route payload: 11 fields per pair (mx, my, conic a, b, c, opacity,
// 5 features); the row layout pads each pair to one 64-byte row
constexpr int NF = 11;
constexpr int NFR = 16;

// A fused-route pair as K1 and K2 stage it in shared memory: three 16-byte
// rows, each read by all threads at once (a broadcast LDS.128). r0 and r1
// feed the keep test, r1.w and r2 the composite.
//   r0 = (mx, my, conic a, conic b)
//   r1 = (conic c, alpha cut, opacity, f0)
//   r2 = (f1, f2, f3, f4)
struct __align__(16) Pair {
  float4 r0, r1, r2;
};

constexpr int BATCH = 256;  // pairs per staged batch

// K1 and K2: two horizontally adjacent pixels per thread, so 128 threads
// per tile
constexpr int PPT = 2;
constexpr int NT = PIX / PPT;

// The power below which op * exp(power) < ALPHA_EPS for certain, so the keep
// test fails: log(ALPHA_EPS / op) less a margin of 1e-3 in log space, a
// thousand times the few-ulp error of logf, expf and the product. Skipping
// such a pixel (no exp) is therefore exact: the same pixels are kept, with
// the same bits. Opacity 0 gives +inf (alpha is 0: every pixel skips); a
// negative or NaN opacity gives NaN, which skips none.
__device__ __forceinline__ float alpha_cut(float op) {
  return logf(ALPHA_EPS / op) - 1e-3f;
}

// Start the asynchronous copy (cp.async) of pair p into s, in the payload's
// field order: r0 = fields 0-3, r1 = fields 4-7, r2 = fields 8-11.
// Column layout (K1, K2): field f of pair p at pay[f * stride + p], eleven
// 4-byte copies. Row layout (K3): the 16 floats at pay[p * 16], three
// 16-byte copies (field 11 is zero).
template <bool ROWS>
__device__ __forceinline__ void copy_pair_async(Pair* s,
                                                const float* __restrict__ pay,
                                                long long stride, long long p) {
  if (ROWS) {
    const float* src = pay + p * NFR;
    __pipeline_memcpy_async(&s->r0, src, 16);
    __pipeline_memcpy_async(&s->r1, src + 4, 16);
    __pipeline_memcpy_async(&s->r2, src + 8, 16);
  } else {
    float* dst = &s->r0.x;
#pragma unroll
    for (int f = 0; f < NF; ++f)
      __pipeline_memcpy_async(dst + f, pay + (long long)f * stride + p, 4);
  }
}

// Copy pairs [base, min(base + BATCH, n)) of a tile whose range starts at
// `start` into buf: thread t copies slots t, t + NT, ... and commits one
// cp.async group.
template <bool ROWS>
__device__ __forceinline__ void stage_batch(Pair* buf,
                                            const float* __restrict__ pay,
                                            long long stride, long long start,
                                            int base, int n) {
#pragma unroll
  for (int i = 0; i < BATCH / NT; ++i) {
    const int k = threadIdx.x + i * NT;
    if (base + k < n)
      copy_pair_async<ROWS>(buf + k, pay, stride, start + base + k);
  }
  __pipeline_commit();
}

// Wait for this thread's copies of the batch and rearrange its slots from
// the payload's field order into Pair's (adding the alpha cut). A barrier
// must follow before other threads read the batch.
__device__ __forceinline__ void finish_batch(Pair* buf, int base, int n) {
  __pipeline_wait_prior(0);
#pragma unroll
  for (int i = 0; i < BATCH / NT; ++i) {
    const int k = threadIdx.x + i * NT;
    if (base + k < n) {
      const float4 r1 = buf[k].r1, r2 = buf[k].r2;  // (c, op, f0, f1), (f2..f4, -)
      buf[k].r1 = make_float4(r1.x, alpha_cut(r1.y), r1.y, r1.z);
      buf[k].r2 = make_float4(r1.w, r2.x, r2.y, r2.z);
    }
  }
}

// The tile-local (x, y) of thread t's first pixel; its PPT pixels are (x + i,
// y). Each warp covers an 8 x 8 block of the tile, four lanes to a row, so
// that fewer warps meet a small Gaussian than with whole rows.
__device__ __forceinline__ int2 thread_pixel(int t) {
  constexpr int WB = 8;              // block width in pixels
  constexpr int PER_ROW = WB / PPT;  // lanes per block row
  const int lane = t & 31, warp = t >> 5;
  return make_int2((warp % (TILE / WB)) * WB + (lane % PER_ROW) * PPT,
                   (warp / (TILE / WB)) * (32 / PER_ROW) + lane / PER_ROW);
}

// The power of a pair at a pixel, rounded as the plain versions round it:
// -0.5 (a dx^2 + c dy^2) - b dx dy, with c dy^2 passed in (a pixel row
// shares it).
__device__ __forceinline__ float pair_power(float4 r0, float cdy2, float dx,
                                            float dy) {
  return -0.5f * (r0.z * dx * dx + cdy2) - r0.w * dx * dy;
}

// The largest v over the block's THREADS threads (every thread must call
// it); smem holds THREADS / 32 ints and may be reused once it returns.
template <int THREADS = PIX>
__device__ __forceinline__ int block_max(int v, int* smem) {
  v = __reduce_max_sync(FULL, v);
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = smem[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) m = max(m, smem[w]);
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
