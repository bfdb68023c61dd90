// K1 and K3: forward blend of the fused route, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel eogs2_tpu/ops/fused_raster.py:_fwd_kernel_col
// (launched by _fused_fwd_call). For every 16x16 tile it walks the tile's
// depth-sorted pair range [tstart[t], tstart[t] + cnt[t]) front to back and
// composites the five feature channels per pixel, exactly as the CUDA
// reference's renderCUDA (forward.cu:288-411):
//
//   pixel  (ox + lx, oy + ly), integer coordinates, no +0.5
//   power  = -0.5 (a dx^2 + c dy^2) - b dx dy,  dx = mx - px, dy = my - py
//   alpha  = min(0.99, op * exp(min(power, 0)))
//   a pair is kept when power <= 1e-4 and alpha >= 1/255;
//   test_T = T (1 - alpha); the pixel stops at the first kept pair with
//   test_T < 1e-4, else C += f alpha T and T = test_T.
//
// The 1e-4 power tolerance exists because the TPU kernel evaluates power by
// a basis expansion whose cancellation leaves ~1e-5 of noise at splat
// centres. This direct dx/dy evaluation has no such cancellation, but the
// same rule holds here, in the plain PyTorch version and in the JAX kernel,
// so one rule holds everywhere.
//
// Output out8 [T, 256, 8] float32 per pixel:
//   0-4  the pre-background channel sums,
//   5    final_T, the transmittance after the last live pair,
//   6    n_contrib: 1-based position, within the tile's range, of the last
//        pair that composited into the pixel (forward.cu's last_contributor;
//        0 if none). The backward kernel walks back from it. The TPU kernel
//        stores a chunk-granular tile bound here instead; channel 6 is never
//        compared with JAX,
//   7    zero.
//
// Payload, in one of two layouts (the same 11 fields per pair: mx, my,
// conic a, b, c, opacity, 5 features):
//   column (K1): structure of arrays [11, stride] float32, each row holding
//                the sorted pairs; 44 B per pair;
//   row    (K3): one 64-byte row per pair, [P, 16] float32, fields 11-15
//                zero; read as three float4 loads.
// K3 replaces eogs2_tpu/ops/fused_raster.py:_fwd_kernel (the wide layout,
// payload_col=False). Only the load differs: every product and sum is K1's,
// in K1's order, so K3's out8 equals K1's bit for bit.
//
// Design: one CTA of 256 threads per tile, one thread per pixel. Batches of
// 256 pairs are staged cooperatively in shared memory (11 x 256 floats,
// 11 KB, from either layout), read by all threads as broadcasts. Each pixel
// keeps T and its sums in registers; the block stops as soon as
// __syncthreads_count shows all 256 pixels done. No atomics: the output is
// deterministic.
//
// Bound on this card: the payload is read once per tile (44 B/pair; K3
// reads 48 of its 64 B) and the
// output written once (8 KB/tile), a few hundred MB at 1M Gaussians, well
// under a millisecond at 3.35 TB/s. The work is ~30 FP32 operations and one
// SFU exp per pair-pixel evaluation, so FP32/SFU issue rate bounds it; the
// early exit and the emission's tile cull cut the evaluations.
//
// Built with -fmad=false (ops/cuda_build.py) so every product and sum rounds
// as in the plain version, and with expf (not __expf), the same function
// torch.exp calls on the card: kernel and plain version agree bit for bit
// on every keep and stop decision.

#include "blend_common.cuh"

namespace {

using namespace eogs2;

template <bool ROWS>
__global__ void __launch_bounds__(PIX)
fused_blend_fwd_kernel(const float* __restrict__ pay, long long stride,
                       const int* __restrict__ tstart,
                       const int* __restrict__ cnt, int grid_x,
                       float* __restrict__ out8) {
  __shared__ float batch[NF][PIX];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const float px = (float)((tile % grid_x) * TILE + tid % TILE);
  const float py = (float)((tile / grid_x) * TILE + tid / TILE);
  const long long start = tstart[tile];
  const int n = cnt[tile];

  float T = 1.0f;
  float acc[NC] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int last = 0;
  bool done = false;
  for (int base = 0; base < n; base += PIX) {
    // also the barrier that keeps the previous batch until all have read it
    if (__syncthreads_count(done) == PIX) break;
    const int k = base + tid;
    if (k < n) stage_pair<ROWS>(batch, tid, pay, stride, start + k);
    __syncthreads();
    const int m = min(PIX, n - base);
    for (int j = 0; !done && j < m; ++j) {
      const float dx = batch[0][j] - px;
      const float dy = batch[1][j] - py;
      const float power = -0.5f * (batch[2][j] * dx * dx + batch[4][j] * dy * dy)
                          - batch[3][j] * dx * dy;
      if (power > POWER_TOL) continue;
      const float alpha = fminf(ALPHA_MAX, batch[5][j] * expf(fminf(power, 0.0f)));
      if (alpha < ALPHA_EPS) continue;
      const float test_T = T * (1.0f - alpha);
      if (test_T < T_EPS) {
        done = true;
        continue;
      }
      const float w = alpha * T;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] += w * batch[6 + c][j];
      T = test_T;
      last = base + j + 1;
    }
  }
  float4* o = reinterpret_cast<float4*>(out8 + ((long long)tile * PIX + tid) * 8);
  o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  o[1] = make_float4(acc[4], T, (float)last, 0.0f);
}

template <bool ROWS>
int launch(const float* pay, long long stride, const int* tstart,
           const int* cnt, int n_tiles, int grid_x, float* out8,
           void* stream) {
  if (n_tiles > 0) {
    fused_blend_fwd_kernel<ROWS><<<n_tiles, PIX, 0, (cudaStream_t)stream>>>(
        pay, stride, tstart, cnt, grid_x, out8);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K1. pay [11, stride] f32; tstart, cnt [n_tiles] i32; out8 [n_tiles, 256, 8]
// f32. Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int eogs2_fused_blend_fwd(const float* pay, long long stride,
                                     const int* tstart, const int* cnt,
                                     int n_tiles, int grid_x, float* out8,
                                     void* stream) {
  return launch<false>(pay, stride, tstart, cnt, n_tiles, grid_x, out8, stream);
}

// K3. pay [P, 16] f32 (one row per sorted pair); otherwise as K1.
extern "C" int eogs2_fused_blend_fwd_rows(const float* pay, const int* tstart,
                                          const int* cnt, int n_tiles,
                                          int grid_x, float* out8,
                                          void* stream) {
  return launch<true>(pay, 0, tstart, cnt, n_tiles, grid_x, out8, stream);
}
