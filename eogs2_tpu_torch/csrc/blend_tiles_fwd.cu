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
// live: the mask row need not be a prefix.
//
// Output out [T, 256, 8] float32 per pixel: 0-4 the channel sums (before the
// background), 5 final_t = exp(s) at the last live slot, 6 n_contrib = the
// number of live slots (K for a pixel still live after slot K), 7 zero.
// The keep rule is power <= 0, not the fused route's 1e-4, and the
// transmittance is exp of a log sum, not K1's running product: this is
// what the JAX kernel computes, and the plain version follows it, so every
// live decision at 1e-4 is the same.
//
// Design: one CTA of 256 threads per tile, one thread per pixel; the tile's
// origin comes from blockIdx and grid_x. The block first finds the tile's
// last pair (the mask row's last set slot) and walks no further: the empty
// slots after it change nothing, and a pixel still live there is live at
// slot K. Batches of 256 slots (rows 0-11) are staged cooperatively in
// shared memory (12 KB) and read by all threads as broadcasts. The block
// stops once __syncthreads_count shows all 256 pixels dead. No atomics: the
// output is deterministic.
//
// Bound on this card: the packed table is read once (64 B per slot; 48 of
// them used, and the mask row in full) up to each tile's stop, the output
// written once (8 KB per tile). The work is ~20 FP32 operations per
// slot-pixel evaluation and, per kept slot, exp, log1p, exp and a division
// besides, so the FP32 and SFU issue rates bound it.
//
// Built with -fmad=false (ops/cuda_build.py) and the accurate expf and
// log1pf, the functions torch.exp and torch.log1p call on the card: the
// plain version's cumsum over the slot axis (not the innermost one) runs
// sequentially per pixel, so kernel and plain version agree bit for bit on
// s and on every live decision.

#include "blend_common.cuh"

namespace {

using namespace eogs2;

constexpr int NR = 16;  // packed rows
constexpr int NU = 12;  // rows read: 0-10 and the mask

__global__ void __launch_bounds__(PIX)
blend_tiles_fwd_kernel(const float* __restrict__ data, int K, int grid_x,
                       float* __restrict__ out) {
  __shared__ float batch[NU][PIX];
  __shared__ int red[NWARP];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const float px = (float)((tile % grid_x) * TILE + tid % TILE);
  const float py = (float)((tile / grid_x) * TILE + tid / TILE);
  const float* src = data + (long long)tile * NR * K;
  const int n_slots = slots_in_use(src + 11LL * K, K, red);

  float s = 0.0f;  // sum of log1p(-alpha) over the live slots so far
  float acc[NC] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int n_live = 0;
  bool done = false;
  for (int base = 0; base < n_slots; base += PIX) {
    // also the barrier that keeps the previous batch until all have read it
    if (__syncthreads_count(done) == PIX) break;
    const int k = base + tid;
    if (k < n_slots) {
#pragma unroll
      for (int f = 0; f < NU; ++f) batch[f][tid] = src[(long long)f * K + k];
    }
    __syncthreads();
    const int m = min(PIX, n_slots - base);
    for (int j = 0; !done && j < m; ++j) {
      if (batch[11][j] > 0.5f) {
        const float dx = batch[0][j] - px;
        const float dy = batch[1][j] - py;
        const float power =
            -0.5f * (batch[2][j] * dx * dx + batch[4][j] * dy * dy) -
            batch[3][j] * dx * dy;
        if (power <= 0.0f) {
          const float alpha =
              fminf(ALPHA_MAX, batch[5][j] * expf(fminf(power, 0.0f)));
          if (alpha >= ALPHA_EPS) {
            const float s_new = s + log1pf(-alpha);
            const float cp = expf(s_new);
            if (cp < T_EPS) {  // the first dead slot: the pixel stops
              done = true;
              continue;
            }
            const float w = alpha * (cp / (1.0f - alpha));
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[c] += w * batch[6 + c][j];
            s = s_new;
          }
        }
      }
      n_live = base + j + 1;
    }
  }
  if (!done) n_live = K;  // live through the empty slots to slot K
  float4* o = reinterpret_cast<float4*>(out + ((long long)tile * PIX + tid) * 8);
  o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  o[1] = make_float4(acc[4], expf(s), (float)n_live, 0.0f);
}

}  // namespace

// data [n_tiles, 16, K] f32; out [n_tiles, 256, 8] f32. Launches on `stream`;
// returns cudaGetLastError() (0 on success).
extern "C" int eogs2_blend_tiles_fwd(const float* data, int n_tiles, int K,
                                     int grid_x, float* out, void* stream) {
  if (n_tiles > 0) {
    blend_tiles_fwd_kernel<<<n_tiles, PIX, 0, (cudaStream_t)stream>>>(
        data, K, grid_x, out);
  }
  return (int)cudaGetLastError();
}
