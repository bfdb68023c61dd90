// K4 forward: the tile-slot blend of the dense raster modes, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel eogs2_tpu/ops/blend_pallas.py:_fwd_kernel
// (launched by blend_forward_pallas), which the `gather` and `sorted` modes
// run with use_pallas. Input: the packed dense view of each tile's pairs,
// data [T, 16, K] float32, rows 0 mx, 1 my, 2-4 conic a, b, c, 5 opacity,
// 6-10 features, 11 mask (1 = a pair, 0 = an empty slot), 12-15 unused.
// Slot k of tile t is its k-th pair front to back.
//
// Per pixel, over the K slots in order (blend_pallas.py's formulas):
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  dx = mx - px, dy = my - py
//   alpha = min(0.99, op exp(min(power, 0))), kept when mask & power <= 0 &
//           alpha >= 1/255, else 0;
//   s     = running sum of log1p(-alpha)   (log-space transmittance)
//   cp    = exp(s); the slot is live while cp >= 1e-4. The live slots are a
//           prefix (s never rises), so the pixel stops at the first dead one;
//   w     = alpha cp / (1 - alpha)   (alpha T_before), C += w f.
// A slot that is masked or not kept leaves s as it is and still counts as
// live: the mask row need not be a prefix, and an empty slot may hold any
// values.
//
// Output out [T, 256, 8] float32 per pixel: 0-4 the channel sums (before the
// background), 5 final_t = exp(s) at the last live slot, 6 n_contrib = the
// number of live slots (K for a pixel still live after slot K), 7 zero.
// The keep rule is power <= 0, not the fused route's 1e-4, and the
// transmittance is exp of a log sum, not K1's running product: this is
// what the JAX kernel computes, and the plain version follows it, so every
// live decision at 1e-4 is the same.
//
// Bound on this card: the packed table is read once (48 of a slot's 64 B,
// and the mask row in full) up to each tile's stop, the output written once
// (8 KB per tile). The work is ~30 FP32 operations per slot for the cull
// below, ~17 per slot-pixel evaluation inside the slot's alpha-cut ellipse
// and, per composite, log1p, exp, a division and the channel sums
// (chip_smoke.py:k4_bounds); at a render's tables the bytes bound it. K1's
// design (fused_blend_fwd.cu) with K4's rules:
//
//   * One CTA of 128 threads per tile, PPT = 2 horizontally adjacent pixels
//     per thread, each warp an 8 x 8 block of the tile; the tile's origin
//     comes from blockIdx and grid_x.
//   * The block first finds the tile's last pair (the mask row's last set
//     slot) and walks no further: the empty slots after it change nothing,
//     and a pixel still live there is live at slot K.
//   * Slots are staged as 16-byte rows (blend_common.cuh: Pair) in batches
//     of 256 double-buffered by cp.async, with the mask folded into the
//     alpha cut (+inf for an empty slot), so one test skips an empty slot
//     and a slot in a Gaussian's tail alike.
//   * Staging also marks, per slot, the warps whose 8 x 8 block the slot's
//     alpha-cut ellipse may reach (slot_blocks). At a render's tables about
//     3% of slot-pixel evaluations pass the cheap test, so a warp takes 32
//     slots at a time, one per lane, and its ballot of their marks names
//     the few it visits: a slot outside the block costs 1/32 of a test.
//   * The warp takes the marked slots U = 2 at a time: the cheap half of
//     the keep test for all of them (U x PPT independent chains), then, in
//     slot order per pixel, the exp, the alpha test, the log sum, the stop
//     test and the composite for the pixels that passed.
//   * The block stops once __syncthreads_count shows every pixel dead, at
//     the next batch.
// No atomics: the output is deterministic.
//
// Built with -fmad=false (ops/cuda_build.py) and the accurate expf and
// log1pf, the functions torch.exp and torch.log1p call on the card: the
// per-pixel log sum keeps its order and its unfused arithmetic, and the
// plain version's cumsum over the slot axis (not the innermost one) runs
// sequentially per pixel, so kernel and plain version agree bit for bit on
// s and on every live decision (final_t and n_contrib). Only the channel
// sums, which decide nothing, use fused multiply-adds and __fdividef.

#include "blend_common.cuh"

namespace {

using namespace eogs2;

constexpr int NR = 16;  // packed rows
constexpr int U = 2;    // marked slots whose cheap test runs at once
constexpr int NW = NT / 32;

__global__ void __launch_bounds__(NT)
blend_tiles_fwd_kernel(const float* __restrict__ data, int K, int grid_x,
                       float* __restrict__ out) {
  __shared__ Pair batch[2][BATCH];
  __shared__ unsigned char blocks[2][BATCH];  // slot_blocks of each slot
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
  const int n_slots = slots_in_use(src + (long long)NF * K, K, red);

  float s[PPT], acc[PPT][NC];  // s: log1p(-alpha) over the live slots so far
  int dead[PPT];               // the first dead slot: n_contrib
  bool done[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    s[i] = 0.0f;
    dead[i] = K;  // live through the empty slots to slot K
    done[i] = false;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }
  bool all_done = false;

  if (n_slots > 0) stage_slots(batch[0], src, K, 0, min(n_slots, BATCH));
  for (int base = 0, buf = 0; base < n_slots; base += BATCH, buf ^= 1) {
    const int m = min(BATCH, n_slots - base);
    finish_slots(batch[buf], blocks[buf], m, ox, oy);
    // also the barrier that keeps the other buffer until all have read it
    if (__syncthreads_count(all_done) == NT) break;
    if (base + BATCH < n_slots)
      stage_slots(batch[buf ^ 1], src, K, base + BATCH,
                  min(BATCH, n_slots - base - BATCH));
    for (int j0 = 0; j0 < m; j0 += 32) {
      if (__all_sync(FULL, all_done)) break;  // the warp's pixels are dead
      // the slots of these 32 that may pass somewhere in the warp's block,
      // one lane each
      const int jl = j0 + lane;
      unsigned todo = __ballot_sync(
          FULL, jl < m && (blocks[buf][jl] >> warp & 1u));
      while (todo && !all_done) {
        // the next U of them in slot order (j[u] < 0: none left); then the
        // cheap half of the keep test (power <= 0, power against the cut)
        // for all U: U x PPT independent chains
        int j[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          j[u] = todo ? j0 + __ffs(todo) - 1 : -1;
          todo &= todo - 1;
        }
        float pw[U][PPT];
        unsigned pass = 0;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const Pair* q = &batch[buf][max(j[u], 0)];
          const float4 r0 = q->r0;
          const float4 r1 = q->r1;
          const float dy = r0.y - py;
          const float cdy2 = r1.x * dy * dy;
#pragma unroll
          for (int i = 0; i < PPT; ++i) {
            pw[u][i] = pair_power(r0, cdy2, r0.x - (px0 + (float)i), dy);
            if (pw[u][i] <= 0.0f && !(pw[u][i] < r1.y) && j[u] >= 0)
              pass |= 1u << (u * PPT + i);
          }
        }
        if (!pass) continue;
        // the rest, in slot order per pixel
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int i = 0; i < PPT; ++i) {
            if (!(pass >> (u * PPT + i) & 1u) || done[i]) continue;
            const Pair* q = &batch[buf][j[u]];
            const float alpha =
                clamp_alpha(q->r1.z * expf(fminf(pw[u][i], 0.0f)));
            if (!(alpha >= ALPHA_EPS)) continue;
            const float s_new = s[i] + log1pf(-alpha);
            const float cp = expf(s_new);
            if (cp < T_EPS) {  // the first dead slot: the pixel stops
              done[i] = true;
              dead[i] = base + j[u];
              continue;
            }
            // the channel sums decide nothing, and the plain version adds
            // them in another order (an einsum): they may fuse
            const float w = alpha * __fdividef(cp, 1.0f - alpha);
            const float4 r1 = q->r1, r2 = q->r2;
            acc[i][0] = __fmaf_rn(w, r1.w, acc[i][0]);
            acc[i][1] = __fmaf_rn(w, r2.x, acc[i][1]);
            acc[i][2] = __fmaf_rn(w, r2.y, acc[i][2]);
            acc[i][3] = __fmaf_rn(w, r2.z, acc[i][3]);
            acc[i][4] = __fmaf_rn(w, r2.w, acc[i][4]);
            s[i] = s_new;
          }
        }
        all_done = true;
#pragma unroll
        for (int i = 0; i < PPT; ++i) all_done = all_done && done[i];
      }
    }
  }
  float4* o = reinterpret_cast<float4*>(out + ((long long)tile * PIX + pix0) * 8);
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    o[2 * i] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    o[2 * i + 1] = make_float4(acc[i][4], expf(s[i]), (float)dead[i], 0.0f);
  }
}

}  // namespace

// data [n_tiles, 16, K] f32; out [n_tiles, 256, 8] f32. Launches on `stream`;
// returns cudaGetLastError() (0 on success).
extern "C" int eogs2_blend_tiles_fwd(const float* data, int n_tiles, int K,
                                     int grid_x, float* out, void* stream) {
  if (n_tiles > 0) {
    blend_tiles_fwd_kernel<<<n_tiles, NT, 0, (cudaStream_t)stream>>>(
        data, K, grid_x, out);
  }
  return (int)cudaGetLastError();
}
