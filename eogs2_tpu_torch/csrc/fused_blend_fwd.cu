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
// so one rule holds everywhere. A NaN power is not kept, as in the plain
// version.
//
// Output out8 [T, 256, 8] float32 per pixel:
//   0-4  the pre-background channel sums,
//   5    final_T, the transmittance after the last live pair,
//   6    n_contrib: 1-based position, within the tile's range, of the last
//        pair that composited into the pixel (forward.cu's last_contributor;
//        0 if none). The backward kernel walks up to it. The TPU kernel
//        stores a chunk-granular tile bound here instead; channel 6 is never
//        compared with JAX,
//   7    zero.
//
// Payload, in one of two layouts (the same 11 fields per pair: mx, my,
// conic a, b, c, opacity, 5 features):
//   column (K1): structure of arrays [11, stride] float32, each row holding
//                the sorted pairs; 44 B per pair;
//   row    (K3): one 64-byte row per pair, [P, 16] float32, fields 11-15
//                zero.
// K3 replaces eogs2_tpu/ops/fused_raster.py:_fwd_kernel (the wide layout,
// payload_col=False). Only the copy into shared memory differs: every
// product and sum is K1's, in K1's order, so K3's out8 equals K1's bit for
// bit.
//
// Bound on this card: the payload is read once per tile up to its pixels'
// deepest stop (44 B/pair; K3 reads 48 of its 64 B) and out8 written once
// (8 KB/tile): a few hundred MB at 1M Gaussians, well under a millisecond at
// 3.35 TB/s. The work is 17 FP32 operations per pair-pixel evaluation and 14
// per composite (chip_smoke.py:k1_bound), so instruction issue bounds it,
// and the design cuts the instructions per evaluation and the time a warp
// waits on them:
//
//   * One CTA of 128 threads per tile, PPT = 2 horizontally adjacent pixels
//     per thread; each warp covers an 8 x 8 block of the tile, so that
//     fewer warps meet a small Gaussian than with whole rows. A thread reads
//     each staged pair once for its two pixels, which share dy and c dy^2.
//   * Pairs are staged as 16-byte rows (blend_common.cuh: Pair), so two
//     broadcast LDS.128 feed the keep test and a third the composite, where
//     one thread per pixel read 6 + 5 scalars from a structure of arrays.
//   * Each staged pair carries its alpha cut, log(ALPHA_EPS / op) less a
//     margin: a pixel whose power lies below it cannot be kept. The walk
//     takes U = 4 pairs at a time: first the cheap half of the keep test
//     (power against the tolerance and the cut) for all of them, U x PPT
//     independent chains; then, in pair order per pixel, the exp, the
//     alpha test, the stop test and the composite for the pixels that
//     passed. Most evaluations lie in the tail of their Gaussian and never
//     reach the exp; every keep and stop decision is the full test's, bit
//     for bit.
//   * The channel sums, which decide nothing, use fused multiply-adds.
//   * Batches of 256 pairs are double-buffered: the cp.async copy of the next
//     batch runs while the pixels walk this one.
// Each pixel keeps T and its sums in registers; the block stops as soon as
// __syncthreads_count shows every thread's pixels done. No atomics: the
// output is deterministic. scripts/fused_blend_ab.py times this kernel
// against an older checkout's; PERF.md section 6 has the numbers, with
// those of the alternatives tried (1 or 4 pixels per thread, whole-row
// warps, no alpha cut, U = 1 or 8, unfused channel sums), all slower.
//
// Built with -fmad=false (ops/cuda_build.py) so every product and sum of the
// keep and stop decisions rounds as in the plain version, and with expf (not
// __expf), the same function torch.exp calls on the card: kernel and plain
// version agree bit for bit on every keep and stop decision, so on final_T
// and n_contrib.

#include "blend_common.cuh"

namespace {

using namespace eogs2;

constexpr int U = 4;  // pairs whose cheap test runs at once

template <bool ROWS>
__global__ void __launch_bounds__(NT)
fused_blend_fwd_kernel(const float* __restrict__ pay, long long stride,
                       const int* __restrict__ tstart,
                       const int* __restrict__ cnt, int grid_x,
                       float* __restrict__ out8) {
  __shared__ Pair batch[2][BATCH];
  const int tile = blockIdx.x;
  const int2 lp = thread_pixel(threadIdx.x);
  const int pix0 = lp.y * TILE + lp.x;  // this thread's first pixel in the tile
  const float px0 = (float)((tile % grid_x) * TILE + lp.x);
  const float py = (float)((tile / grid_x) * TILE + lp.y);
  const long long start = tstart[tile];
  const int n = cnt[tile];

  float T[PPT], acc[PPT][NC];
  int last[PPT];
  bool done[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    T[i] = 1.0f;
    last[i] = 0;
    done[i] = false;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }
  bool all_done = false;

  if (n > 0) stage_batch<ROWS>(batch[0], pay, stride, start, 0, n);
  for (int base = 0, buf = 0; base < n; base += BATCH, buf ^= 1) {
    finish_batch(batch[buf], base, n);
    // also the barrier that keeps the other buffer until all have read it
    if (__syncthreads_count(all_done) == NT) break;
    if (base + BATCH < n)
      stage_batch<ROWS>(batch[buf ^ 1], pay, stride, start, base + BATCH, n);
    const int m = min(BATCH, n - base);
    for (int j = 0; !all_done && j < m; j += U) {
      // the cheap half of the keep test (power against the tolerance and
      // the cut) for U pairs at once: U x PPT independent chains; slots past
      // m hold stale pairs and are masked
      float pw[U][PPT];
      unsigned pass = 0;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float4 r0 = batch[buf][j + u].r0;
        const float4 r1 = batch[buf][j + u].r1;
        const float dy = r0.y - py;
        const float cdy2 = r1.x * dy * dy;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          pw[u][i] = pair_power(r0, cdy2, r0.x - (px0 + (float)i), dy);
          if (pw[u][i] <= POWER_TOL && !(pw[u][i] < r1.y) && j + u < m)
            pass |= 1u << (u * PPT + i);
        }
      }
      if (!pass) continue;
      // the rest, in pair order per pixel
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          if (!(pass >> (u * PPT + i) & 1u) || done[i]) continue;
          const Pair* q = &batch[buf][j + u];
          const float alpha =
              clamp_alpha(q->r1.z * expf(fminf(pw[u][i], 0.0f)));
          if (!(alpha >= ALPHA_EPS)) continue;  // a NaN is not kept
          const float test_T = T[i] * (1.0f - alpha);
          if (test_T < T_EPS) {
            done[i] = true;
            continue;
          }
          const float w = alpha * T[i];
          // the channel sums decide nothing, and the plain version adds
          // them in another order (an einsum): they may fuse
          const float4 r1 = q->r1, r2 = q->r2;
          acc[i][0] = __fmaf_rn(w, r1.w, acc[i][0]);
          acc[i][1] = __fmaf_rn(w, r2.x, acc[i][1]);
          acc[i][2] = __fmaf_rn(w, r2.y, acc[i][2]);
          acc[i][3] = __fmaf_rn(w, r2.z, acc[i][3]);
          acc[i][4] = __fmaf_rn(w, r2.w, acc[i][4]);
          T[i] = test_T;
          last[i] = base + j + u + 1;
        }
      }
      all_done = true;
#pragma unroll
      for (int i = 0; i < PPT; ++i) all_done = all_done && done[i];
    }
  }
  float4* o = reinterpret_cast<float4*>(out8 + ((long long)tile * PIX + pix0) * 8);
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    o[2 * i] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    o[2 * i + 1] = make_float4(acc[i][4], T[i], (float)last[i], 0.0f);
  }
}

template <bool ROWS>
int launch(const float* pay, long long stride, const int* tstart,
           const int* cnt, int n_tiles, int grid_x, float* out8,
           void* stream) {
  if (n_tiles > 0) {
    fused_blend_fwd_kernel<ROWS><<<n_tiles, NT, 0, (cudaStream_t)stream>>>(
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
