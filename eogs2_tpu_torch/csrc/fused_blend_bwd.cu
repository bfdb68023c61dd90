// K2: backward blend of the fused route, for NVIDIA Hopper (sm_90a).
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
//     g_mx = -gG (a dx + b dy)   g_my = -gG (c dy + b dx)
//     g_a  = -gG dx^2 / 2        g_b  = -gG dx dy       g_c = -gG dy^2 / 2
//     g_op = g_alpha G           g_f_c = w g_pix_c
// and each is summed over the tile's 256 pixels. There is no derivative
// through the 0.99 alpha clamp, and the gradient flows through min(power, 0)
// as if it were power (also for power in (0, 1e-4]), as JAX's basis
// expansion does.
//
// Front to back with suffix = total - prefix, not the CUDA reference's
// back-to-front division by (1 - alpha): the walk repeats K1's products
// exactly (T *= 1 - alpha over the same kept pairs in the same order), so
// every keep, live and stop decision is K1's.
//
// Walk length: each pixel walks up to its own n_contrib (out8 channel 6, the
// 1-based position of its last composited pair); pairs past it carry no
// gradient for that pixel, and the pair at which it stopped (test_T < 1e-4)
// gets none, as in JAX (live is false there). The block walks up to its
// deepest pixel's bound and writes zeros to the rows past it.
//
// Inputs: pay [11, stride] f32 (the sorted SoA payload K1 read), tstart,
// cnt [T] i32, out8 [T, 256, 8] (K1's output), gout8 [T, 256, 8] (the
// cotangent: channels 0-4 g_pix, 5 g_ft; 6-7 ignored).
// Output: gpay [11, stride] f32, every row of every tile's range written.
//
// Design: one CTA of 256 threads per tile, one thread per pixel, batches of
// 256 pairs staged in shared memory as in K1. Each thread computes its 11
// contributions to a pair; a warp-shuffle butterfly sums them over the
// warp's 32 pixels, lane 0 stores the warp's partials in shared memory, and
// after every 32 pairs the block adds the 8 warp partials in a fixed order
// and writes the 32 rows, coalesced. A warp whose pixels all contribute
// nothing to a pair skips its shuffles (its partial is 0). No atomics: every
// pair row belongs to exactly one tile, so the output is deterministic.
//
// Bound on this card: the payload is read once (44 B/pair) up to each
// tile's walk, g_pay written once (44 B/pair), out8 and gout8 read once
// (8 KB/tile each): a few hundred MB at 1M Gaussians, well under a
// millisecond at 3.35 TB/s. The work is the forward's recomputation per
// pair-pixel evaluation plus ~60 FP32 operations per contributing
// pair-pixel, and the 11 per-pair sums over 256 pixels, so FP32 issue rate
// bounds it.
//
// Built with -fmad=false (ops/cuda_build.py) and the accurate expf, like
// K1: the recomputed alpha, T and keep/stop decisions match K1 bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;  // threads per block, one per pixel
constexpr int NF = 11;            // payload rows
constexpr int NC = 5;             // feature channels
constexpr int NWARP = PIX / 32;
constexpr int SUB = 32;           // pairs per block-level reduction round
constexpr unsigned FULL = 0xffffffffu;

// the plain version compares float32 tensors with Python doubles, which
// torch rounds to float32 once: round the same doubles here
#define ALPHA_EPS ((float)(1.0 / 255.0))
#define ALPHA_MAX ((float)0.99)
#define T_EPS ((float)1e-4)
#define POWER_TOL ((float)1e-4)

__global__ void __launch_bounds__(PIX)
fused_blend_bwd_kernel(const float* __restrict__ pay, long long stride,
                       const int* __restrict__ tstart,
                       const int* __restrict__ cnt, int grid_x,
                       const float* __restrict__ out8,
                       const float* __restrict__ gout8,
                       float* __restrict__ gpay) {
  __shared__ float batch[NF][PIX];
  __shared__ float part[NWARP][NF][SUB];
  __shared__ int warp_walk[NWARP];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float px = (float)((tile % grid_x) * TILE + tid % TILE);
  const float py = (float)((tile / grid_x) * TILE + tid / TILE);
  const long long start = tstart[tile];
  const int n = cnt[tile];

  const long long pix = ((long long)tile * PIX + tid) * 8;
  const float4 o0 = *reinterpret_cast<const float4*>(out8 + pix);
  const float4 o1 = *reinterpret_cast<const float4*>(out8 + pix + 4);
  const float4 q0 = *reinterpret_cast<const float4*>(gout8 + pix);
  const float4 q1 = *reinterpret_cast<const float4*>(gout8 + pix + 4);
  const float gpix[NC] = {q0.x, q0.y, q0.z, q0.w, q1.x};
  const float total = o0.x * gpix[0] + o0.y * gpix[1] + o0.z * gpix[2] +
                      o0.w * gpix[3] + o1.x * gpix[4];
  const float tail = o1.y * q1.y;  // final_T * g_ft
  const int last = (int)o1.z;      // this pixel's walk bound (n_contrib)

  // the block walks up to its deepest pixel's bound
  const int wmax = __reduce_max_sync(FULL, last);
  if (lane == 0) warp_walk[warp] = wmax;
  __syncthreads();
  int n_walk = 0;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) n_walk = max(n_walk, warp_walk[w]);
  n_walk = min(n_walk, n);

  float T = 1.0f;
  float prefix = 0.0f;
  for (int base = 0; base < n_walk; base += PIX) {
    __syncthreads();  // every thread is done with the previous batch
    const int k = base + tid;
    if (k < n_walk) {
      const float* src = pay + start + k;
#pragma unroll
      for (int f = 0; f < NF; ++f) batch[f][tid] = src[(long long)f * stride];
    }
    __syncthreads();
    const int m = min(PIX, n_walk - base);
    for (int s0 = 0; s0 < m; s0 += SUB) {
      const int ms = min(SUB, m - s0);
      for (int jj = 0; jj < ms; ++jj) {
        const int j = s0 + jj;
        float v[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f) v[f] = 0.0f;
        bool contrib = false;
        if (base + j < last) {
          const float a = batch[2][j], b = batch[3][j], c = batch[4][j];
          const float op = batch[5][j];
          const float dx = batch[0][j] - px;
          const float dy = batch[1][j] - py;
          const float power = -0.5f * (a * dx * dx + c * dy * dy) - b * dx * dy;
          if (power <= POWER_TOL) {
            const float G = expf(fminf(power, 0.0f));
            const float alpha = fminf(ALPHA_MAX, op * G);
            if (alpha >= ALPHA_EPS) {
              const float one_minus = 1.0f - alpha;
              const float test_T = T * one_minus;
              if (test_T >= T_EPS) {
                const float w = alpha * T;
                float fdot = gpix[0] * batch[6][j];
#pragma unroll
                for (int cc = 1; cc < NC; ++cc) fdot += gpix[cc] * batch[6 + cc][j];
                prefix += w * fdot;
                const float suffix = total - prefix;
                const float g_alpha = fdot * T - (suffix + tail) / one_minus;
                const float gG = g_alpha * (op * G);
                v[0] = -(gG * (a * dx + b * dy));
                v[1] = -(gG * (c * dy + b * dx));
                v[2] = -0.5f * gG * dx * dx;
                v[3] = -gG * dx * dy;
                v[4] = -0.5f * gG * dy * dy;
                v[5] = g_alpha * G;
#pragma unroll
                for (int cc = 0; cc < NC; ++cc) v[6 + cc] = w * gpix[cc];
                T = test_T;
                contrib = true;
              }
            }
          }
        }
        if (__any_sync(FULL, contrib)) {
#pragma unroll
          for (int f = 0; f < NF; ++f) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              v[f] += __shfl_xor_sync(FULL, v[f], off);
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int f = 0; f < NF; ++f) part[warp][f][jj] = v[f];
        }
      }
      __syncthreads();
      for (int idx = tid; idx < NF * SUB; idx += PIX) {
        const int f = idx / SUB;
        const int jj = idx % SUB;
        if (jj < ms) {
          float s = part[0][f][jj];
#pragma unroll
          for (int w = 1; w < NWARP; ++w) s += part[w][f][jj];
          gpay[(long long)f * stride + start + base + s0 + jj] = s;
        }
      }
      __syncthreads();  // part is reused by the next round
    }
  }
  // rows past the walk: no pixel composited them
  for (int k = n_walk + tid; k < n; k += PIX) {
#pragma unroll
    for (int f = 0; f < NF; ++f) gpay[(long long)f * stride + start + k] = 0.0f;
  }
}

}  // namespace

// pay, gpay [11, stride] f32; tstart, cnt [n_tiles] i32; out8, gout8
// [n_tiles, 256, 8] f32. Launches on `stream`; returns cudaGetLastError()
// (0 on success).
extern "C" int eogs2_fused_blend_bwd(const float* pay, long long stride,
                                     const int* tstart, const int* cnt,
                                     int n_tiles, int grid_x,
                                     const float* out8, const float* gout8,
                                     float* gpay, void* stream) {
  if (n_tiles > 0) {
    fused_blend_bwd_kernel<<<n_tiles, PIX, 0, (cudaStream_t)stream>>>(
        pay, stride, tstart, cnt, grid_x, out8, gout8, gpay);
  }
  return (int)cudaGetLastError();
}
