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
//   g_mx = gG (-(a dx) - b dy)   g_my = gG (-(c dy) - b dx)
//   g_a  = gG (-dx^2 / 2)        g_b  = gG (-dx dy)      g_c = gG (-dy^2 / 2)
//   g_op = g_alpha G             g_f_c = w g_c
// and each is summed over the tile's 256 pixels. No derivative through the
// 0.99 alpha clamp (the reference's quirk). A slot that is masked or not
// kept has alpha 0: it adds nothing and gets no gradient.
// Output gdata [T, 16, K] f32 in data's layout: rows 0-10 the gradients,
// rows 11-15 zero, zero for every slot no pixel reached.
//
// Design: one CTA of 256 threads per tile, one thread per pixel. The block
// walks from its deepest pixel's n_contrib, or from the tile's last pair if
// that comes first (the empty slots after it get no gradient), down to slot
// 0 in batches of 256 slots staged in shared memory (rows 0-11, 12 KB), each
// batch in rounds of 32 slots from its back. Each thread carries its s_after and suffix. Per
// slot, a warp-shuffle butterfly sums the 11 values over the warp's 32
// pixels (skipped when no lane contributes), lane 0 stores the warp's
// partials, and after each round the block adds the 8 warps' partials in a
// fixed order and writes the 32 slots, coalesced. No atomics: each tile
// writes only its own slots, so the output is bitwise deterministic.
//
// Bound on this card: data and gout read once, gdata written once (64 B per
// slot and 8 KB per tile each way); the work is the forward's recomputation
// per slot-pixel evaluation below the walk, ~55 FP32 operations per
// contributing slot-pixel and the 11 sums per slot over the pixels, so the
// FP32 (and SFU) issue rate bounds it.
//
// Built with -fmad=false and the accurate expf, log1pf and logf, like K4
// forward: the recomputed alpha and keep decisions are the forward's.

#include "blend_common.cuh"

namespace {

using namespace eogs2;

constexpr int NR = 16;  // packed rows
constexpr int NU = 12;  // rows read: 0-10 and the mask
constexpr int NG = 11;  // gradient rows written
constexpr int SUB = 32;  // slots per block-level reduction round

__global__ void __launch_bounds__(PIX)
blend_tiles_bwd_kernel(const float* __restrict__ data,
                       const float* __restrict__ gout, int K, int grid_x,
                       float* __restrict__ gdata) {
  __shared__ float batch[NU][PIX];
  __shared__ float part[NWARP][NG][SUB + 1];  // +1: no bank conflicts
  __shared__ int red[NWARP];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float px = (float)((tile % grid_x) * TILE + tid % TILE);
  const float py = (float)((tile / grid_x) * TILE + tid / TILE);
  const float* src = data + (long long)tile * NR * K;
  float* dst = gdata + (long long)tile * NR * K;

  const long long pix = ((long long)tile * PIX + tid) * 8;
  const float4 q0 = *reinterpret_cast<const float4*>(gout + pix);
  const float4 q1 = *reinterpret_cast<const float4*>(gout + pix + 4);
  const float gpix[NC] = {q0.x, q0.y, q0.z, q0.w, q1.x};
  const float final_t = q1.z;
  const float tail = final_t * q1.y;  // final_t * g_ft
  const float log_ft = logf(final_t);
  const int last = (int)q1.w;  // n_contrib: slots below it are live

  const int n_walk = min(block_max(last, red),
                         slots_in_use(src + 11LL * K, K, red));

  // rows 11-15 of every slot, and every slot past the walk, are zero
  for (long long i = tid; i < (long long)(NR - NG) * K; i += PIX)
    dst[(long long)NG * K + i] = 0.0f;
  for (int f = 0; f < NG; ++f)
    for (int k = n_walk + tid; k < K; k += PIX) dst[(long long)f * K + k] = 0.0f;

  float s_after = 0.0f;  // live log1p(-alpha) after the current slot
  float suffix = 0.0f;   // w fdot after the current slot
  for (int hi = n_walk; hi > 0; hi -= PIX) {
    const int lo = max(0, hi - PIX);
    __syncthreads();  // every thread is done with the previous batch
    const int k = lo + tid;
    if (k < hi) {
#pragma unroll
      for (int f = 0; f < NU; ++f) batch[f][tid] = src[(long long)f * K + k];
    }
    __syncthreads();
    for (int r_hi = hi - lo; r_hi > 0; r_hi -= SUB) {
      const int r_lo = max(0, r_hi - SUB);
      for (int j = r_hi - 1; j >= r_lo; --j) {
        float v[NG];
#pragma unroll
        for (int f = 0; f < NG; ++f) v[f] = 0.0f;
        bool contrib = false;
        if (lo + j < last && batch[11][j] > 0.5f) {
          const float a = batch[2][j], b = batch[3][j], c = batch[4][j];
          const float op = batch[5][j];
          const float dx = batch[0][j] - px;
          const float dy = batch[1][j] - py;
          const float power = -0.5f * (a * dx * dx + c * dy * dy) - b * dx * dy;
          if (power <= 0.0f) {
            const float G = expf(fminf(power, 0.0f));
            const float alpha = fminf(ALPHA_MAX, op * G);
            if (alpha >= ALPHA_EPS) {
              const float one_minus = 1.0f - alpha;
              const float cp = expf(log_ft - s_after);
              const float t_before = cp / one_minus;
              const float w = alpha * t_before;
              float fdot = gpix[0] * batch[6][j];
#pragma unroll
              for (int cc = 1; cc < NC; ++cc) fdot += gpix[cc] * batch[6 + cc][j];
              const float g_alpha =
                  fdot * t_before - (suffix + tail) / one_minus;
              const float gG = g_alpha * op * G;
              v[0] = gG * (-(a * dx) - b * dy);
              v[1] = gG * (-(c * dy) - b * dx);
              v[2] = gG * (-0.5f * dx * dx);
              v[3] = gG * (-dx * dy);
              v[4] = gG * (-0.5f * dy * dy);
              v[5] = g_alpha * G;
#pragma unroll
              for (int cc = 0; cc < NC; ++cc) v[6 + cc] = w * gpix[cc];
              suffix += w * fdot;
              s_after += log1pf(-alpha);
              contrib = true;
            }
          }
        }
        if (__any_sync(FULL, contrib)) {
#pragma unroll
          for (int f = 0; f < NG; ++f) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              v[f] += __shfl_xor_sync(FULL, v[f], off);
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int f = 0; f < NG; ++f) part[warp][f][j - r_lo] = v[f];
        }
      }
      __syncthreads();
      const int ms = r_hi - r_lo;
      for (int idx = tid; idx < NG * SUB; idx += PIX) {
        const int f = idx / SUB;
        const int jj = idx % SUB;
        if (jj < ms) {
          float s = part[0][f][jj];
#pragma unroll
          for (int w = 1; w < NWARP; ++w) s += part[w][f][jj];
          dst[(long long)f * K + lo + r_lo + jj] = s;
        }
      }
      __syncthreads();  // part is reused by the next round
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
    blend_tiles_bwd_kernel<<<n_tiles, PIX, 0, (cudaStream_t)stream>>>(
        data, gout, K, grid_x, gdata);
  }
  return (int)cudaGetLastError();
}
