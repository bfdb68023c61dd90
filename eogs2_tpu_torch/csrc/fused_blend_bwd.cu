// K2 and K3: backward blend of the fused route, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel eogs2_tpu/ops/fused_raster.py:_bwd_kernel_col
// (launched by _fused_bwd_call). For every 16x16 tile it walks the tile's
// depth-sorted pair range [tstart[t], tstart[t] + cnt[t]) FRONT TO BACK,
// recomputing what K1 (fused_blend_fwd.cu) computed, and writes per sorted
// pair row the gradient of the loss with respect to the payload:
// (mx, my, conic a, b, c, opacity, f0..f4).
//
// Per pixel (JAX's conventions, _bwd_kernel_col with _chunk_fields_col):
//   total   = sum_c acc_c g_pix_c                    (acc: out8 channels 0-4)
//   for each kept, live pair, in order:
//     w       = alpha T_before,  fdot = sum_c g_pix_c f_c
//     prefix += w fdot,          suffix = total - prefix
//     g_alpha = fdot T_before - (suffix + final_T g_ft) / (1 - alpha)
//     gG      = g_alpha op G,    G = exp(min(power, 0))
//   and per pair, summed over the tile's 256 pixels:
//     g_mx = -(a S_x + b S_y)    g_my = -(c S_y + b S_x)
//     g_a  = -S_xx / 2           g_b  = -S_xy           g_c = -S_yy / 2
//     g_op = sum g_alpha G       g_f_c = sum w g_pix_c
//   with S_x = sum gG dx, S_y = sum gG dy, S_xx = sum gG dx^2, S_xy =
//   sum gG dx dy, S_yy = sum gG dy^2 (the conic enters after the sum, once
//   per pair). There is no derivative through the 0.99 alpha clamp, and the
//   gradient flows through min(power, 0) as if it were power (also for
//   power in (0, 1e-4]), as JAX's basis expansion does.
//
// Front to back with suffix = total - prefix, not the CUDA reference's
// back-to-front division by (1 - alpha): the walk repeats K1's products
// exactly (T *= 1 - alpha over the same kept pairs in the same order, the
// same alpha cut), so every keep, live and stop decision is K1's.
//
// Walk length: each pixel walks up to its own n_contrib (out8 channel 6, the
// 1-based position of its last composited pair); pairs past it carry no
// gradient for that pixel, and the pair at which it stopped (test_T < 1e-4)
// gets none, as in JAX (live is false there). A warp walks up to its deepest
// pixel's bound, the block up to its deepest warp's, and the block writes
// zeros to the rows past it.
//
// Inputs: pay (the sorted payload K1 or K3 read), tstart, cnt [T] i32,
// out8 [T, 256, 8] (the forward's output), gout8 [T, 256, 8] (the
// cotangent: channels 0-4 g_pix, 5 g_ft; 6-7 ignored).
// Output: gpay in the payload's layout, every pair of every tile's range
// written: K2 takes and writes the column layout [11, stride] f32; K3
// (replacing eogs2_tpu/ops/fused_raster.py:_bwd_kernel, the wide layout)
// the row layout [P, 16] f32, one 64-byte row per pair with fields 11-15
// zero. Only the copies in and the stores out differ, so K3's gpay is K2's
// transposed, bit for bit.
//
// Bound on this card: the payload is read once (44 B/pair) up to each
// tile's walk, g_pay written once (44 B/pair), out8 and gout8 read once
// (8 KB/tile each): a few hundred MB at 1M Gaussians, well under a
// millisecond at 3.35 TB/s. The work (chip_smoke.py:k2_bound) is the
// forward's 17 FP32 operations per pair-pixel evaluation and 58 per
// contribution, so instruction issue bounds it. Summing 11 values over 256
// pixels for every pair is what set the pace of a thread-per-pixel design
// (five shuffles and five adds per value per warp), and the design cuts it:
//
//   * One CTA of 128 threads per tile, PPT = 2 horizontally adjacent pixels
//     per thread, each warp an 8 x 8 block of the tile: a thread adds its
//     pixels' contributions in registers first, so a tile's shuffles per
//     pair fall with its warps, and fewer warps meet a small Gaussian.
//   * A reduce-scatter butterfly: at the shuffle of offset o a lane keeps
//     half of its values (chosen by lane bit o) and sends the other half,
//     so the 11 values (padded to 16) take 8 + 4 + 2 + 1 + 1 = 16 shuffles
//     instead of 55, and each field's warp sum lands on its own pair of
//     lanes, which store it at once. A warp in which no pixel contributes
//     to a pair skips the exchange and leaves the pair unmarked in a bit
//     mask; the block then adds the marked warps' partials in a fixed
//     order, after every 32 pairs, and writes the 32 rows coalesced.
//   * Explicit fused multiply-adds (__fmaf_rn) and __fdividef in the
//     gradient arithmetic only (fdot, prefix, g_alpha, the sums); the
//     recomputation that decides keep and stop is K1's, unfused.
//   * Pairs are staged as K1 stages them (16-byte rows with their alpha
//     cut, batches of 256 double-buffered by cp.async), and the walk takes
//     U = 4 pairs at a time as K1's does: the cheap half of the keep test
//     for all of them, then the contributions of the pixels that passed, in
//     pair order, and a warp none of whose pixels passed skips the four.
// No atomics: every pair row belongs to exactly one tile and every sum runs
// in a fixed order, so the output is bitwise identical launch to launch.
// scripts/fused_blend_ab.py times this kernel against an older checkout's;
// PERF.md section 6 has the numbers, with those of the alternatives tried
// (1 or 4 pixels per thread, eleven full butterflies with lane 0 storing,
// whole-row warps, no alpha cut, U = 1 or 8, no explicit fused
// multiply-adds), all slower.
//
// Built with -fmad=false (ops/cuda_build.py) and the accurate expf, like
// K1: the recomputed alpha, T and keep/stop decisions match K1 bit for bit.

#include "blend_common.cuh"

namespace {

using namespace eogs2;

constexpr int SUB = 32;  // pairs per block-level reduction round (a mask)
constexpr int U = 4;     // pairs whose cheap test runs at once (divides SUB)

template <bool ROWS>
__global__ void __launch_bounds__(NT)
fused_blend_bwd_kernel(const float* __restrict__ pay, long long stride,
                       const int* __restrict__ tstart,
                       const int* __restrict__ cnt, int grid_x,
                       int tile0,
                       const float* __restrict__ out8,
                       const float* __restrict__ gout8,
                       float* __restrict__ gpay) {
  constexpr int NW = NT / 32;
  __shared__ Pair batch[2][BATCH];
  // per warp and pair of a round, the warp's 11 sums; +1 against bank
  // conflicts (the scatter stores 11 fields of one pair at once)
  __shared__ float part[NW][NF][SUB + 1];
  __shared__ unsigned wmask[NW];  // pairs of the round the warp summed
  __shared__ int red[NW];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int2 lp = thread_pixel(threadIdx.x);
  const int pix0 = lp.y * TILE + lp.x;  // this thread's first pixel in the tile
  // the pixel origin is that of global tile tile0 + tile (tile0 = 0 on the
  // whole frame; a row band's first tile on the multi-device path)
  const int gtile = tile0 + tile;
  const float px0 = (float)((gtile % grid_x) * TILE + lp.x);
  const float py = (float)((gtile / grid_x) * TILE + lp.y);
  const long long start = tstart[tile];
  const int n = cnt[tile];

  float gpix[PPT][NC], total[PPT], tail[PPT], T[PPT], prefix[PPT];
  int last[PPT];
  int walk = 0;  // this thread's walk bound
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const long long px = ((long long)tile * PIX + pix0 + i) * 8;
    const float4 o0 = *reinterpret_cast<const float4*>(out8 + px);
    const float4 o1 = *reinterpret_cast<const float4*>(out8 + px + 4);
    const float4 q0 = *reinterpret_cast<const float4*>(gout8 + px);
    const float4 q1 = *reinterpret_cast<const float4*>(gout8 + px + 4);
    gpix[i][0] = q0.x;
    gpix[i][1] = q0.y;
    gpix[i][2] = q0.z;
    gpix[i][3] = q0.w;
    gpix[i][4] = q1.x;
    total[i] = o0.x * q0.x + o0.y * q0.y + o0.z * q0.z + o0.w * q0.w +
               o1.x * q1.x;
    tail[i] = o1.y * q1.y;  // final_T * g_ft
    last[i] = (int)o1.z;    // this pixel's walk bound (n_contrib)
    T[i] = 1.0f;
    prefix[i] = 0.0f;
    walk = max(walk, last[i]);
  }
  const int n_walk = min(block_max<NT>(walk, red), n);
  const int warp_walk = __reduce_max_sync(FULL, walk);

  if (n_walk > 0) stage_batch<ROWS>(batch[0], pay, stride, start, 0, n_walk);
  for (int base = 0, buf = 0; base < n_walk; base += BATCH, buf ^= 1) {
    finish_batch(batch[buf], base, n_walk);
    __syncthreads();  // the batch has landed; the other buffer is free
    if (base + BATCH < n_walk)
      stage_batch<ROWS>(batch[buf ^ 1], pay, stride, start, base + BATCH,
                        n_walk);
    const int m = min(BATCH, n_walk - base);
    for (int s0 = 0; s0 < m; s0 += SUB) {
      const int ms = min(SUB, m - s0);
      const int mw = min(ms, warp_walk - base - s0);  // warp-uniform
      unsigned mask = 0;
      for (int j0 = 0; j0 < mw; j0 += U) {
        // the cheap half of the keep test for U pairs at once (the walk
        // bound, power against the tolerance and the cut): U x PPT
        // independent chains; pairs past mw are masked
        unsigned pass = 0;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = s0 + j0 + u;
          const float4 r0 = batch[buf][j].r0;
          const float4 r1 = batch[buf][j].r1;
          const float dy = r0.y - py;
          const float cdy2 = r1.x * dy * dy;
#pragma unroll
          for (int i = 0; i < PPT; ++i) {
            const float power =
                pair_power(r0, cdy2, r0.x - (px0 + (float)i), dy);
            if (power <= POWER_TOL && !(power < r1.y) && j0 + u < mw &&
                base + j < last[i])
              pass |= 1u << (u * PPT + i);
          }
        }
        if (!__any_sync(FULL, pass)) continue;  // the warp's sums are 0
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const unsigned mine = pass >> (u * PPT) & ((1u << PPT) - 1u);
          if (!__any_sync(FULL, mine)) continue;
          const int jj = j0 + u;
          const Pair* q = &batch[buf][s0 + jj];
          const float4 r0 = q->r0, r1 = q->r1, r2 = q->r2;
          const float dy = r0.y - py;
          const float cdy2 = r1.x * dy * dy;
          float v[NV];
#pragma unroll
          for (int f = 0; f < NV; ++f) v[f] = 0.0f;
          bool contrib = false;
#pragma unroll
          for (int i = 0; i < PPT; ++i) {
            if (!(mine >> i & 1u)) continue;
            const float dx = r0.x - (px0 + (float)i);
            const float power = pair_power(r0, cdy2, dx, dy);
            const float G = expf(fminf(power, 0.0f));
            const float opG = r1.z * G;
            const float alpha = clamp_alpha(opG);
            if (!(alpha >= ALPHA_EPS)) continue;  // a NaN is not kept
            const float one_minus = 1.0f - alpha;
            const float test_T = T[i] * one_minus;
            if (test_T < T_EPS) continue;
            const float w = alpha * T[i];
            float fdot = gpix[i][0] * r1.w;
            fdot = __fmaf_rn(gpix[i][1], r2.x, fdot);
            fdot = __fmaf_rn(gpix[i][2], r2.y, fdot);
            fdot = __fmaf_rn(gpix[i][3], r2.z, fdot);
            fdot = __fmaf_rn(gpix[i][4], r2.w, fdot);
            prefix[i] = __fmaf_rn(w, fdot, prefix[i]);
            const float suffix = total[i] - prefix[i];
            const float g_alpha = __fmaf_rn(
                fdot, T[i], -__fdividef(suffix + tail[i], one_minus));
            const float gG = g_alpha * opG;
            const float gdx = gG * dx, gdy = gG * dy;
            v[0] += gdx;
            v[1] += gdy;
            v[2] = __fmaf_rn(gdx, dx, v[2]);
            v[3] = __fmaf_rn(gdx, dy, v[3]);
            v[4] = __fmaf_rn(gdy, dy, v[4]);
            v[5] = __fmaf_rn(g_alpha, G, v[5]);
#pragma unroll
            for (int c = 0; c < NC; ++c)
              v[6 + c] = __fmaf_rn(w, gpix[i][c], v[6 + c]);
            T[i] = test_T;
            contrib = true;
          }
          if (!__any_sync(FULL, contrib)) continue;
          mask |= 1u << jj;
          const float s = warp_reduce_scatter(v, lane);
          const int f = lane >> 1;
          if (!(lane & 1) && f < NF) part[warp][f][jj] = s;
        }
      }
      if (lane == 0) wmask[warp] = mask;
      __syncthreads();
      // the marked warps' partials, added in a fixed order; the conic
      // enters the mean's gradient here, once per pair
      auto sum = [&](int f, int jj) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < NW; ++w)
          if (wmask[w] >> jj & 1u) s += part[w][f][jj];
        return s;
      };
      auto field = [&](int f, int jj) {
        const float4 r0 = batch[buf][s0 + jj].r0;
        switch (f) {
          case 0: return -(r0.z * sum(0, jj) + r0.w * sum(1, jj));
          case 1: return -(batch[buf][s0 + jj].r1.x * sum(1, jj) +
                           r0.w * sum(0, jj));
          case 2: return -0.5f * sum(2, jj);
          case 3: return -sum(3, jj);
          case 4: return -0.5f * sum(4, jj);
          default: return sum(f, jj);
        }
      };
      const long long p0 = start + base + s0;
      if (ROWS) {
        for (int idx = threadIdx.x; idx < NFR * SUB; idx += NT) {
          const int jj = idx / NFR;
          const int f = idx % NFR;
          if (jj < ms) gpay[(p0 + jj) * NFR + f] = f < NF ? field(f, jj) : 0.0f;
        }
      } else {
        for (int idx = threadIdx.x; idx < NF * SUB; idx += NT) {
          const int f = idx / SUB;
          const int jj = idx % SUB;
          if (jj < ms) gpay[(long long)f * stride + p0 + jj] = field(f, jj);
        }
      }
      __syncthreads();  // part and wmask are reused by the next round
    }
  }
  // pairs past the walk: no pixel composited them
  if (ROWS) {
    for (long long i = (long long)n_walk * NFR + threadIdx.x;
         i < (long long)n * NFR; i += NT)
      gpay[start * NFR + i] = 0.0f;
  } else {
    for (int k = n_walk + threadIdx.x; k < n; k += NT) {
#pragma unroll
      for (int f = 0; f < NF; ++f) gpay[(long long)f * stride + start + k] = 0.0f;
    }
  }
}

template <bool ROWS>
int launch(const float* pay, long long stride, const int* tstart,
           const int* cnt, int n_tiles, int grid_x, int tile0,
           const float* out8, const float* gout8, float* gpay, void* stream) {
  if (n_tiles > 0) {
    fused_blend_bwd_kernel<ROWS><<<n_tiles, NT, 0, (cudaStream_t)stream>>>(
            pay, stride, tstart, cnt, grid_x, tile0, out8, gout8, gpay);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K2. pay, gpay [11, stride] f32; tstart, cnt [n_tiles] i32; out8, gout8
// [n_tiles, 256, 8] f32. Local tile t is global tile tile0 + t of a frame
// grid_x tiles wide. Launches on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int eogs2_fused_blend_bwd(const float* pay, long long stride,
                                     const int* tstart, const int* cnt,
                                     int n_tiles, int grid_x, int tile0,
                                     const float* out8, const float* gout8,
                                     float* gpay, void* stream) {
  return launch<false>(pay, stride, tstart, cnt, n_tiles, grid_x, tile0, out8,
                       gout8, gpay, stream);
}

// K3. pay, gpay [P, 16] f32 (one row per sorted pair); otherwise as K2.
extern "C" int eogs2_fused_blend_bwd_rows(const float* pay, const int* tstart,
                                          const int* cnt, int n_tiles,
                                          int grid_x, int tile0,
                                          const float* out8,
                                          const float* gout8, float* gpay,
                                          void* stream) {
  return launch<true>(pay, 0, tstart, cnt, n_tiles, grid_x, tile0, out8,
                      gout8, gpay, stream);
}
