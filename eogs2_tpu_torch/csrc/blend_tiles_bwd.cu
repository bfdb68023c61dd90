// K4 backward: the tile-slot blend of the dense raster modes, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel eogs2_tpu/ops/blend_pallas.py:_bwd_kernel
// (launched by blend_backward_pallas). One pass per tile, BACK TO FRONT,
// the CUDA reference's strategy (backward.cu:457-643): the forward saved
// each pixel's final_t and n_contrib, the live slots are exactly the slots
// below n_contrib, and each slot's transmittance is rebuilt from final_t by
// the log sum of the live slots after it.
//
// Inputs: data [T, 16, K] (the packed table K4 forward read) and gout
// [T, 256, 8] per pixel: 0-4 dL/d(channel), 5 dL/dfinal_t (the background
// term folded in), 6 final_t, 7 n_contrib (K4 forward's channels 5 and 6).
// Per pixel, for each kept slot j < n_contrib, walking j downwards
// (blend_pallas.py's formulas):
//   s_after = sum of log1p(-alpha) over the live slots after j
//   cp      = exp(log(final_t) - s_after)     (transmittance after j)
//   T_j     = cp / (1 - alpha),  w = alpha T_j,  fdot = sum_c g_c f_c
//   suffix  = sum of w fdot over the slots after j
//   g_alpha = fdot T_j - (suffix + final_t g_ft) / (1 - alpha)
//   gG      = g_alpha op G,  G = exp(power)
// and per slot, summed over the tile's 256 pixels:
//   g_mx = -(a S_x + b S_y)    g_my = -(c S_y + b S_x)
//   g_a  = -S_xx / 2           g_b  = -S_xy           g_c = -S_yy / 2
//   g_op = sum g_alpha G       g_f_c = sum w g_c
// with S_x = sum gG dx, S_y = sum gG dy, S_xx = sum gG dx^2, S_xy = sum gG
// dx dy, S_yy = sum gG dy^2 (the conic enters after the sum, once per
// slot). No derivative through the 0.99 alpha clamp (the reference's
// quirk). A slot that is masked or not kept has alpha 0: it adds nothing
// and gets no gradient.
// Output gdata [T, 16, K] f32 in data's layout: rows 0-10 the gradients,
// rows 11-15 zero, zero for every slot no pixel reached.
//
// Bound on this card: data and gout read once, gdata's gradient rows
// written once up to each tile's walk; the work is the forward's cull per
// slot and recomputation per slot-pixel evaluation below the walk and ~69
// FP32 operations per contribution (chip_smoke.py:k4_bounds), so at a
// render's tables the bytes bound it. The contract's zeros (rows 11-15 of
// every slot, rows 0-10 past the walk) are most of the bytes written at K
// = 8192. K2's design (fused_blend_bwd.cu) carried to this back-to-front
// walk:
//
//   * One CTA of 128 threads per tile, PPT = 2 horizontally adjacent pixels
//     per thread, each warp an 8 x 8 block of the tile. Each thread carries
//     s_after, suffix, log(final_t), final_t g_ft and n_contrib for both.
//   * The block walks from min(its deepest n_contrib, the tile's last pair)
//     down to slot 0 in batches of 256 slots, double-buffered by cp.async:
//     [hi - 256, hi) lands while [hi - 512, hi - 256) is requested; the
//     lowest batch is the partial one. Slots are staged as 16-byte rows
//     (blend_common.cuh: Pair) with the mask folded into the alpha cut, so
//     an empty slot fails the cheap test whatever it holds.
//   * Each batch runs in rounds of 32 slots from its back. Staging marks,
//     per slot, the warps whose 8 x 8 block the slot's alpha-cut ellipse
//     may reach (slot_blocks); a warp's ballot over the round's 32 slots,
//     one per lane, names the ones it visits (below its deepest pixel's
//     n_contrib), about a third of them at a render's tables. It takes
//     them one at a time, back to front: the cheap half of the keep test
//     (power <= 0, power against the cut, the slot below the pixel's
//     n_contrib) for both pixels, then their contributions, which a warp
//     none of whose pixels passed skips. (Two or four slots' cheap tests
//     at once, as in K2 and K4 forward, were slower here.)
//   * Each contributing slot's 11 sums go through the reduce-scatter
//     butterfly (16 shuffles); a per-round warp bit mask marks the slots a
//     warp summed, and the block adds the marked partials in warp order and
//     writes the round's 32 slots coalesced. A slot no warp marked is
//     written as 0 (its conic may be NaN in an empty slot).
//   * Explicit fused multiply-adds and __fdividef in the gradient arithmetic
//     only; what decides keep and live (power, G, alpha) and the
//     transmittance (expf, log1pf, logf) stay unfused and accurate.
//   * The zeros go out as streaming 16-byte stores while the first batch
//     loads.
// No atomics: each tile writes only its own slots and every sum runs in a
// fixed order, so the output is bitwise identical launch to launch.
// scripts/fused_blend_ab.py times this kernel against an older checkout's;
// PERF.md section 6 has the numbers.
//
// Built with -fmad=false (ops/cuda_build.py) and the accurate expf, log1pf
// and logf, like K4 forward: the recomputed alpha and keep decisions are
// the forward's.

#include "blend_common.cuh"

namespace {

using namespace eogs2;

constexpr int NR = 16;      // packed rows
constexpr int SUB = 32;     // slots per block-level reduction round (a mask)
constexpr int NW = NT / 32;

// Zero p[0, n) with the block's threads: scalar stores up to the first
// 16-byte boundary and after the last, streaming 16-byte stores between.
__device__ __forceinline__ void zero_fill(float* p, long long n) {
  const long long head = min(
      n, (long long)((16 - (reinterpret_cast<unsigned long long>(p) & 15)) &
                     15) / 4);
  if (threadIdx.x < head) p[threadIdx.x] = 0.0f;
  float4* q = reinterpret_cast<float4*>(p + head);
  const long long n4 = (n - head) / 4;
  for (long long i = threadIdx.x; i < n4; i += NT)
    __stcs(q + i, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
  const long long rest = head + 4 * n4;
  if (threadIdx.x < n - rest) p[rest + threadIdx.x] = 0.0f;
}

__global__ void __launch_bounds__(NT)
blend_tiles_bwd_kernel(const float* __restrict__ data,
                       const float* __restrict__ gout, int K, int grid_x,
                       float* __restrict__ gdata) {
  __shared__ Pair batch[2][BATCH];
  __shared__ unsigned char blocks[2][BATCH];  // slot_blocks of each slot
  // per warp and slot of a round, the warp's 11 sums; +1 against bank
  // conflicts (the scatter stores 11 fields of one slot at once)
  __shared__ float part[NW][NF][SUB + 1];
  __shared__ unsigned wmask[NW];  // slots of the round the warp summed
  __shared__ int red[NW];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int2 lp = thread_pixel(threadIdx.x);
  const int pix0 = lp.y * TILE + lp.x;  // this thread's first pixel in the tile
  const float ox = (float)((tile % grid_x) * TILE);
  const float oy = (float)((tile / grid_x) * TILE);
  const float px0 = ox + (float)lp.x;
  const float py = oy + (float)lp.y;
  const float* src = data + (long long)tile * NR * K;
  float* dst = gdata + (long long)tile * NR * K;

  float gpix[PPT][NC], tail[PPT], log_ft[PPT], s_after[PPT], suffix[PPT];
  int last[PPT];
  int walk = 0;  // this thread's deepest n_contrib
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const long long px = ((long long)tile * PIX + pix0 + i) * 8;
    const float4 q0 = *reinterpret_cast<const float4*>(gout + px);
    const float4 q1 = *reinterpret_cast<const float4*>(gout + px + 4);
    gpix[i][0] = q0.x;
    gpix[i][1] = q0.y;
    gpix[i][2] = q0.z;
    gpix[i][3] = q0.w;
    gpix[i][4] = q1.x;
    tail[i] = q1.z * q1.y;  // final_t * g_ft
    log_ft[i] = logf(q1.z);
    last[i] = (int)q1.w;  // n_contrib: slots below it are live
    s_after[i] = 0.0f;    // live log1p(-alpha) after the current slot
    suffix[i] = 0.0f;     // w fdot after the current slot
    walk = max(walk, last[i]);
  }
  const int n_walk = min(block_max<NT>(walk, red),
                         slots_in_use(src + (long long)NF * K, K, red));
  const int warp_walk = __reduce_max_sync(FULL, walk);

  if (n_walk > 0)
    stage_slots(batch[0], src, K, max(0, n_walk - BATCH), min(n_walk, BATCH));
  // rows 11-15 of every slot, and rows 0-10 of every slot past the walk
  zero_fill(dst + (long long)NF * K, (long long)(NR - NF) * K);
  if (n_walk < K) {
    for (int f = 0; f < NF; ++f)
      zero_fill(dst + (long long)f * K + n_walk, K - n_walk);
  }

  for (int hi = n_walk, buf = 0; hi > 0; hi -= BATCH, buf ^= 1) {
    const int lo = max(0, hi - BATCH);
    finish_slots(batch[buf], blocks[buf], hi - lo, ox, oy);
    __syncthreads();  // the batch has landed; the other buffer is free
    if (lo > 0)
      stage_slots(batch[buf ^ 1], src, K, max(0, lo - BATCH), min(lo, BATCH));
    for (int r_hi = hi - lo; r_hi > 0; r_hi -= SUB) {
      const int r_lo = max(0, r_hi - SUB);
      // the round's slots below the warp's walk that may pass somewhere in
      // its block, one lane each (bit jj: slot r_lo + jj)
      const int jl = r_lo + lane;
      unsigned todo = __ballot_sync(
          FULL, jl < r_hi && lo + jl < warp_walk &&
                    (blocks[buf][jl] >> warp & 1u));
      unsigned mask = 0;
      while (todo) {  // back to front
        const int jj = 31 - __clz(todo);
        todo &= ~(1u << jj);
        const Pair* q = &batch[buf][r_lo + jj];
        const float4 r0 = q->r0, r1 = q->r1, r2 = q->r2;
        const float dy = r0.y - py;
        const float cdy2 = r1.x * dy * dy;
        // the cheap half of the keep test (power <= 0, the cut, the pixel's
        // n_contrib) for both pixels
        float power[PPT];
        unsigned pass = 0;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          power[i] = pair_power(r0, cdy2, r0.x - (px0 + (float)i), dy);
          if (power[i] <= 0.0f && !(power[i] < r1.y) &&
              lo + r_lo + jj < last[i])
            pass |= 1u << i;
        }
        if (!__any_sync(FULL, pass)) continue;  // the warp's sums are 0
        float v[NV];
#pragma unroll
        for (int f = 0; f < NV; ++f) v[f] = 0.0f;
        bool contrib = false;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          if (!(pass >> i & 1u)) continue;
          const float dx = r0.x - (px0 + (float)i);
          const float G = expf(fminf(power[i], 0.0f));
          const float opG = r1.z * G;
          const float alpha = clamp_alpha(opG);
          if (!(alpha >= ALPHA_EPS)) continue;
          const float one_minus = 1.0f - alpha;
          const float inv = __fdividef(1.0f, one_minus);
          const float t_before = expf(log_ft[i] - s_after[i]) * inv;
          const float w = alpha * t_before;
          float fdot = gpix[i][0] * r1.w;
          fdot = __fmaf_rn(gpix[i][1], r2.x, fdot);
          fdot = __fmaf_rn(gpix[i][2], r2.y, fdot);
          fdot = __fmaf_rn(gpix[i][3], r2.z, fdot);
          fdot = __fmaf_rn(gpix[i][4], r2.w, fdot);
          const float g_alpha =
              __fmaf_rn(fdot, t_before, -(suffix[i] + tail[i]) * inv);
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
          suffix[i] = __fmaf_rn(w, fdot, suffix[i]);
          s_after[i] += log1pf(-alpha);
          contrib = true;
        }
        if (!__any_sync(FULL, contrib)) continue;
        mask |= 1u << jj;
        const float sum = warp_reduce_scatter(v, lane);
        const int f = lane >> 1;
        if (!(lane & 1) && f < NF) part[warp][f][jj] = sum;
      }
      if (lane == 0) wmask[warp] = mask;
      __syncthreads();
      // the marked warps' partials, added in warp order; the conic enters
      // the mean's gradient here, once per slot
      const int ms = r_hi - r_lo;
      for (int idx = threadIdx.x; idx < NF * SUB; idx += NT) {
        const int f = idx / SUB;
        const int jj = idx % SUB;
        if (jj >= ms) continue;
        float S[2] = {0.0f, 0.0f};
        bool any = false;
        const int f0 = f < 2 ? 0 : f;  // g_mx and g_my need S_x and S_y
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          if (!(wmask[w] >> jj & 1u)) continue;
          any = true;
          S[0] += part[w][f0][jj];
          if (f < 2) S[1] += part[w][1][jj];
        }
        float g = 0.0f;  // a slot no pixel reached
        if (any) {
          const Pair& q = batch[buf][r_lo + jj];
          switch (f) {
            case 0: g = -(q.r0.z * S[0] + q.r0.w * S[1]); break;
            case 1: g = -(q.r1.x * S[1] + q.r0.w * S[0]); break;
            case 2: g = -0.5f * S[0]; break;
            case 3: g = -S[0]; break;
            case 4: g = -0.5f * S[0]; break;
            default: g = S[0];
          }
        }
        dst[(long long)f * K + lo + r_lo + jj] = g;
      }
      __syncthreads();  // part and wmask are reused by the next round
    }
  }
}

}  // namespace

// data, gdata [n_tiles, 16, K] f32; gout [n_tiles, 256, 8] f32. Launches on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int eogs2_blend_tiles_bwd(const float* data, const float* gout,
                                     int n_tiles, int K, int grid_x,
                                     float* gdata, void* stream) {
  if (n_tiles > 0 && K > 0) {
    blend_tiles_bwd_kernel<<<n_tiles, NT, 0, (cudaStream_t)stream>>>(
        data, gout, K, grid_x, gdata);
  }
  return (int)cudaGetLastError();
}
