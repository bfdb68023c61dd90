// The per-Gaussian preprocess of every render, forward and backward, for
// NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package writes the preprocess as XLA ops
// (eogs2_tpu/ops/projection.py: compute_cov2d_direct, preprocess_gaussians)
// that XLA fuses, and autodiff derives their backward. The port's plain
// version (ops/projection.py, the CPU's path) is the same tensor code run
// eagerly: ~220 elementwise launches in the forward and ~400 in autograd's
// backward a render, each a full pass over [N] or [N, k] tensors, for a
// function whose per-Gaussian inputs and outputs are ~100 bytes.
//
//   forward   one thread a Gaussian: project (uva = A [xyz, 1]), the screen
//             covariance (J R) diag(s^2) (J R)^T with J = diag(W/2, H/2)
//             A[:2, :3] and the unnormalised quaternion's R, the +0.3
//             dilation, the conic, the antialias rescale, the 3-sigma
//             radius, getRect's truncate-then-clamp and the cull
//             (det > 0, a non-empty rect, alive); every Preprocessed field
//             written, and mean2d moved by the optional NDC offset times
//             (W/2, H/2);
//   backward  one thread a Gaussian: the forward's intermediates recomputed,
//             the closed-form gradients of xyz, scales, quats, opacities
//             and the NDC offset from those of mean2d, depth, conic and
//             opacity (ops/projection.preprocess_backward_plain is its plain
//             twin); the affine's, when asked, summed without atomics: each
//             block's 12 sums in a fixed order (shuffles, then its warps in
//             order), then one block adds the blocks' sums in a fixed order.
//             Two calls on the same inputs give the same bits.
//
// The forward follows the plain version operation by operation, in its
// order, compiled with -fmad=false and IEEE division and square root: every
// constant is the float32 that PyTorch casts its Python scalar to, the
// reciprocal of det is one IEEE division (the plain 1.0 / t is
// reciprocal(t) * 1.0), clamp_min keeps a NaN as torch.clamp_min does, and
// the float-to-int conversions saturate as the card's .to(torch.int32) does
// (cvt.rzi). So conic, opacity and radius equal the plain version's on the
// card bit for bit. The projection's three products run as the one fused
// multiply-add chain of a K = 3 matrix product (the plain version's
// means3d @ A^T goes through cuBLAS): mean2d and depth agree to an ulp or
// two, and a rect can differ only where that ulp crosses a tile boundary.
// The affine is read from the card (12 floats) and W, H are arguments: no
// constant goes to the card as a tensor, so nothing waits for it.
//
// Bound on this card: each per-Gaussian input read once and each output
// written once, 105 B a Gaussian forward (53 in: xyz, scale, quat,
// opacity, alive, offset; 52 out) and 124 B backward (44 B of xyz, scale,
// quat and opacity, 28 B of incoming gradients, 52 B of gradients out): at
// 1M Gaussians 31 and 37 us at 3.35 TB/s. The arithmetic, ~200 FP32 operations a Gaussian
// forward and ~400 backward, is 3-6 us at 67 TFLOP/s: the bytes bound it.
// One launch each replaces the plain version's passes over intermediates.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int NT = 256;  // threads per block
constexpr int NA = 12;   // entries of the [3, 4] affine
constexpr unsigned FULL = 0xffffffffu;

// the plain version's Python scalars, as PyTorch casts them to float32
#define F32(x) ((float)(x))

struct Inputs {
  const float* means;      // [N, 3]
  const float* scales;     // [N, 3] activated
  const float* quats;      // [N, 4] raw (w, x, y, z)
  const float* opacities;  // [N] activated
  const float* affine;     // [3, 4] row-major, on the card
  long long n;
  int width, height;
  int antialiasing;
};

// torch.clamp_min(t, lo) with a scalar bound: a NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ void load_affine(const float* affine, float* A) {
#pragma unroll
  for (int i = 0; i < NA; ++i) A[i] = __ldg(affine + i);
}

// uva = means3d @ A[:, :3]^T + A[:, 3]: a K = 3 product's multiply-add
// chain, then the bias
__device__ __forceinline__ float project_row(const float* Ar, float x, float y,
                                             float z) {
  return fmaf(z, Ar[2], fmaf(y, Ar[1], x * Ar[0])) + Ar[3];
}

// compute_cov2d_direct's intermediates, in its order
struct Screen {
  float R[3][3];  // rotation of the unnormalised quaternion
  float J[2][3];  // diag(W/2, H/2) A[:2, :3]
  float a[3], b[3];  // rows of J R
  float s[3];     // squared scales
  float c0, c1, c2;  // cxx, cxy, cyy before the dilation
};

__device__ __forceinline__ void screen(const float* A, float hw, float hh,
                                       const float* q, const float* sc,
                                       Screen& S) {
  const float r = q[0], x = q[1], y = q[2], z = q[3];
  S.R[0][0] = 1.0f - 2.0f * (y * y + z * z);
  S.R[0][1] = 2.0f * (x * y - r * z);
  S.R[0][2] = 2.0f * (x * z + r * y);
  S.R[1][0] = 2.0f * (x * y + r * z);
  S.R[1][1] = 1.0f - 2.0f * (x * x + z * z);
  S.R[1][2] = 2.0f * (y * z - r * x);
  S.R[2][0] = 2.0f * (x * z - r * y);
  S.R[2][1] = 2.0f * (y * z + r * x);
  S.R[2][2] = 1.0f - 2.0f * (x * x + y * y);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    S.J[0][j] = hw * A[j];
    S.J[1][j] = hh * A[4 + j];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    S.a[k] = S.J[0][0] * S.R[0][k] + S.J[0][1] * S.R[1][k] +
             S.J[0][2] * S.R[2][k];
    S.b[k] = S.J[1][0] * S.R[0][k] + S.J[1][1] * S.R[1][k] +
             S.J[1][2] * S.R[2][k];
    S.s[k] = sc[k] * sc[k];
  }
  S.c0 = S.a[0] * S.a[0] * S.s[0] + S.a[1] * S.a[1] * S.s[1] +
         S.a[2] * S.a[2] * S.s[2];
  S.c1 = S.a[0] * S.b[0] * S.s[0] + S.a[1] * S.b[1] * S.s[1] +
         S.a[2] * S.b[2] * S.s[2];
  S.c2 = S.b[0] * S.b[0] * S.s[0] + S.b[1] * S.b[1] * S.s[1] +
         S.b[2] * S.b[2] * S.s[2];
}

// preprocess_gaussians' dilated covariance and its determinants
struct Dilated {
  float det_cov;  // det before the dilation
  float xx, xy, yy;  // after it
  float det;
  bool valid;  // det > 0
  float det_safe, det_inv;
};

__device__ __forceinline__ void dilate(const Screen& S, Dilated& D) {
  D.det_cov = S.c0 * S.c2 - S.c1 * S.c1;
  D.xx = S.c0 + F32(0.3);
  D.xy = S.c1;
  D.yy = S.c2 + F32(0.3);
  D.det = D.xx * D.yy - D.xy * D.xy;
  D.valid = D.det > 0.0f;
  D.det_safe = D.valid ? D.det : 1.0f;
  D.det_inv = 1.0f / D.det_safe;
}

__device__ __forceinline__ void load_gaussian(const Inputs& in, long long g,
                                              float* m, float* sc, float* q) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    m[j] = in.means[3 * g + j];
    sc[j] = in.scales[3 * g + j];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) q[j] = in.quats[4 * g + j];
}

struct Outputs {
  float* mean2d;    // [N, 2]
  float* depth;     // [N]
  float* conic;     // [N, 3]
  float* opacity;   // [N]
  int* radius;      // [N]
  int* rect_min;    // [N, 2]
  int* rect_size;   // [N, 2]
  int* tiles;       // [N]
};

__global__ void __launch_bounds__(NT)
forward_kernel(Inputs in, const unsigned char* alive, const float* offset,
               Outputs out) {
  const long long g = (long long)blockIdx.x * NT + threadIdx.x;
  if (g >= in.n) return;
  float A[NA], m[3], sc[3], q[4];
  load_affine(in.affine, A);
  load_gaussian(in, g, m, sc, q);
  const float Wf = (float)in.width, Hf = (float)in.height;
  const float hw = F32(0.5 * in.width), hh = F32(0.5 * in.height);

  // ndc_to_pixel; depth = -altitude
  const float u = project_row(A, m[0], m[1], m[2]);
  const float v = project_row(A + 4, m[0], m[1], m[2]);
  const float w = project_row(A + 8, m[0], m[1], m[2]);
  const float px = ((u + 1.0f) * Wf - 1.0f) * 0.5f;
  const float py = ((v + 1.0f) * Hf - 1.0f) * 0.5f;

  Screen S;
  screen(A, hw, hh, q, sc, S);
  Dilated D;
  dilate(S, D);
  float h = 1.0f;
  if (in.antialiasing) h = sqrtf(clamp_min(D.det_cov / D.det, F32(0.000025)));

  const float mid = 0.5f * (D.xx + D.yy);
  const float disc = sqrtf(clamp_min(mid * mid - D.det_safe, F32(0.1)));
  const float lambda_max = mid + disc;
  const float radius_f = ceilf(3.0f * sqrtf(clamp_min(lambda_max, 0.0f)));

  // getRect: truncate toward zero, then clamp to the grid
  const int grid_x = (in.width + TILE - 1) / TILE;
  const int grid_y = (in.height + TILE - 1) / TILE;
  const float T = (float)TILE;
  const int rmin_x = clampi(__float2int_rz((px - radius_f) / T), 0, grid_x);
  const int rmin_y = clampi(__float2int_rz((py - radius_f) / T), 0, grid_y);
  const int rmax_x =
      clampi(__float2int_rz(((px + radius_f) + T - 1.0f) / T), 0, grid_x);
  const int rmax_y =
      clampi(__float2int_rz(((py + radius_f) + T - 1.0f) / T), 0, grid_y);
  int rect_w = rmax_x - rmin_x, rect_h = rmax_y - rmin_y;
  const bool visible = D.valid && rect_w > 0 && rect_h > 0 &&
                       (alive == nullptr || alive[g] != 0);
  if (!visible) rect_w = rect_h = 0;

  float mx = px, my = py;
  if (offset != nullptr) {
    mx = px + offset[2 * g] * hw;
    my = py + offset[2 * g + 1] * hh;
  }
  out.mean2d[2 * g] = mx;
  out.mean2d[2 * g + 1] = my;
  out.depth[g] = -w;
  out.conic[3 * g] = D.yy * D.det_inv;
  out.conic[3 * g + 1] = -D.xy * D.det_inv;
  out.conic[3 * g + 2] = D.xx * D.det_inv;
  out.opacity[g] = in.opacities[g] * h;
  out.radius[g] = visible ? __float2int_rz(radius_f) : 0;
  out.rect_min[2 * g] = rmin_x;
  out.rect_min[2 * g + 1] = rmin_y;
  out.rect_size[2 * g] = rect_w;
  out.rect_size[2 * g + 1] = rect_h;
  out.tiles[g] = rect_w * rect_h;
}

struct Cotangents {  // each nullptr when no gradient reached that output
  const float* mean2d;   // [N, 2]
  const float* depth;    // [N]
  const float* conic;    // [N, 3]
  const float* opacity;  // [N]
};

struct Gradients {
  float* means;      // [N, 3]
  float* scales;     // [N, 3]
  float* quats;      // [N, 4]
  float* opacities;  // [N]
  float* offset;     // [N, 2], or nullptr: not asked
  float* partial;    // [blocks, 12] the blocks' affine sums, or nullptr
};

__device__ __forceinline__ float cot(const float* p, long long i) {
  return p != nullptr ? p[i] : 0.0f;
}

__global__ void __launch_bounds__(NT)
backward_kernel(Inputs in, Cotangents gin, Gradients gout) {
  const long long g = (long long)blockIdx.x * NT + threadIdx.x;
  float part[NA];  // this Gaussian's share of the affine's gradient
#pragma unroll
  for (int i = 0; i < NA; ++i) part[i] = 0.0f;
  if (g < in.n) {
    float A[NA], m[3], sc[3], q[4];
    load_affine(in.affine, A);
    load_gaussian(in, g, m, sc, q);
    const float Wf = (float)in.width, Hf = (float)in.height;
    const float hw = F32(0.5 * in.width), hh = F32(0.5 * in.height);
    const float gmx = cot(gin.mean2d, 2 * g), gmy = cot(gin.mean2d, 2 * g + 1);
    const float gca = cot(gin.conic, 3 * g), gcb = cot(gin.conic, 3 * g + 1);
    const float gcc = cot(gin.conic, 3 * g + 2);
    const float gop = cot(gin.opacity, g);

    // the projection: mean2d = ((uva + 1) S - 1) / 2 (+ offset S / 2),
    // depth = -uva[2]
    const float gu = (gmx * 0.5f) * Wf, gv = (gmy * 0.5f) * Hf;
    const float gw = -cot(gin.depth, g);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      gout.means[3 * g + j] = gu * A[j] + gv * A[4 + j] + gw * A[8 + j];
    if (gout.offset != nullptr) {
      gout.offset[2 * g] = gmx * hw;
      gout.offset[2 * g + 1] = gmy * hh;
    }

    Screen S;
    screen(A, hw, hh, q, sc, S);
    Dilated D;
    dilate(S, D);

    // conic = (yy, -xy, xx) / det_safe; det_safe = det where det > 0, else 1
    float gxx = gcc * D.det_inv, gyy = gca * D.det_inv;
    float gxy = -(gcb * D.det_inv);
    const float ginv = gca * D.yy + gcb * -D.xy + gcc * D.xx;
    float gdet = D.valid ? -ginv * (D.det_inv * D.det_inv) : 0.0f;
    float gdc = 0.0f;  // of det_cov
    const float opac = in.opacities[g];
    if (in.antialiasing) {
      // opacity * sqrt(clamp_min(det_cov / det, 0.000025))
      const float ratio = D.det_cov / D.det;
      const float h = sqrtf(clamp_min(ratio, F32(0.000025)));
      gout.opacities[g] = gop * h;
      const float gh = gop * opac;
      const float gr = ratio >= F32(0.000025) ? gh / (2.0f * h) : 0.0f;
      gdc = gr / D.det;
      gdet += -gr * ((D.det_cov / D.det) / D.det);
    } else {
      gout.opacities[g] = gop;
    }
    // det = xx yy - xy^2 and det_cov = c0 c2 - c1^2
    gxx += gdet * D.yy;
    gyy += gdet * D.xx;
    gxy -= 2.0f * (gdet * D.xy);
    const float g0 = gxx + gdc * S.c2, g2 = gyy + gdc * S.c0;
    const float g1 = gxy - 2.0f * (gdc * S.c1);

    // c0 = sum a_k^2 s_k, c1 = sum a_k b_k s_k, c2 = sum b_k^2 s_k
    float ga[3], gb[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float as = S.a[k] * S.s[k], bs = S.b[k] * S.s[k];
      ga[k] = 2.0f * g0 * as + g1 * bs;
      gb[k] = g1 * as + 2.0f * g2 * bs;
      const float gs = g0 * S.a[k] * S.a[k] + g1 * S.a[k] * S.b[k] +
                       g2 * S.b[k] * S.b[k];
      gout.scales[3 * g + k] = 2.0f * gs * sc[k];
    }
    // a_k = sum_m J[0][m] R[m][k], b_k = sum_m J[1][m] R[m][k]
    float gR[3][3], gJ0[3], gJ1[3];
#pragma unroll
    for (int mm = 0; mm < 3; ++mm) {
      gJ0[mm] = ga[0] * S.R[mm][0] + ga[1] * S.R[mm][1] + ga[2] * S.R[mm][2];
      gJ1[mm] = gb[0] * S.R[mm][0] + gb[1] * S.R[mm][1] + gb[2] * S.R[mm][2];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        gR[mm][k] = S.J[0][mm] * ga[k] + S.J[1][mm] * gb[k];
    }
    // R of the unnormalised quaternion (r, x, y, z)
    const float r = q[0], x = q[1], y = q[2], z = q[3];
    gout.quats[4 * g] =
        2.0f * (-z * gR[0][1] + y * gR[0][2] + z * gR[1][0] - x * gR[1][2] -
                y * gR[2][0] + x * gR[2][1]);
    gout.quats[4 * g + 1] =
        2.0f * (y * gR[0][1] + z * gR[0][2] + y * gR[1][0] -
                2.0f * x * gR[1][1] - r * gR[1][2] + z * gR[2][0] +
                r * gR[2][1] - 2.0f * x * gR[2][2]);
    gout.quats[4 * g + 2] =
        2.0f * (-2.0f * y * gR[0][0] + x * gR[0][1] + r * gR[0][2] +
                x * gR[1][0] + z * gR[1][2] - r * gR[2][0] + z * gR[2][1] -
                2.0f * y * gR[2][2]);
    gout.quats[4 * g + 3] =
        2.0f * (-2.0f * z * gR[0][0] - r * gR[0][1] + x * gR[0][2] +
                r * gR[1][0] - 2.0f * z * gR[1][1] + y * gR[1][2] +
                x * gR[2][0] + y * gR[2][1]);

    if (gout.partial != nullptr) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        part[j] = gu * m[j] + hw * gJ0[j];
        part[4 + j] = gv * m[j] + hh * gJ1[j];
        part[8 + j] = gw * m[j];
      }
      part[3] = gu;
      part[7] = gv;
      part[11] = gw;
    }
  }
  if (gout.partial == nullptr) return;
  // the block's sums, in a fixed order: each warp's by shuffles, then the
  // warps' in order
  __shared__ float warp_sum[NT / 32][NA];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    float s = part[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(FULL, s, o);
    if (lane == 0) warp_sum[warp][i] = s;
  }
  __syncthreads();
  if (threadIdx.x < NA) {
    float s = 0.0f;
    for (int k = 0; k < NT / 32; ++k) s += warp_sum[k][threadIdx.x];
    gout.partial[(long long)blockIdx.x * NA + threadIdx.x] = s;
  }
}

// One block of NA warps: warp i adds entry i of the blocks' sums, each lane
// a fixed stride of blocks in order, then the lanes by shuffles.
__global__ void __launch_bounds__(NA * 32)
affine_sum_kernel(const float* partial, int blocks, float* g_affine) {
  const int i = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s = 0.0f;
  for (int b = lane; b < blocks; b += 32) s += partial[(long long)b * NA + i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(FULL, s, o);
  if (lane == 0) g_affine[i] = s;
}

int blocks(long long n) { return (int)((n + NT - 1) / NT); }

Inputs inputs(const float* means, const float* scales, const float* quats,
              const float* opacities, const float* affine, long long n,
              int width, int height, int antialiasing) {
  return Inputs{means, scales, quats, opacities, affine, n, width, height,
                antialiasing};
}

}  // namespace

// Forward. means, scales [n, 3], quats [n, 4], opacities [n], affine [3, 4]
// float32 on the card; alive [n] bool (one byte each) or nullptr; offset
// [n, 2] float32 (the NDC offset of mean2d) or nullptr. Writes mean2d
// [n, 2], depth [n], conic [n, 3], opacity [n] float32 and radius [n],
// rect_min, rect_size [n, 2], tiles [n] int32. Launches on `stream`;
// returns cudaGetLastError() (0 on success).
extern "C" int eogs2_preprocess_fwd(
    const float* means, const float* scales, const float* quats,
    const float* opacities, const float* affine, const unsigned char* alive,
    const float* offset, long long n, int width, int height, int antialiasing,
    float* mean2d, float* depth, float* conic, float* opacity, int* radius,
    int* rect_min, int* rect_size, int* tiles, void* stream) {
  if (n > 0) {
    forward_kernel<<<blocks(n), NT, 0, (cudaStream_t)stream>>>(
        inputs(means, scales, quats, opacities, affine, n, width, height,
               antialiasing),
        alive, offset,
        Outputs{mean2d, depth, conic, opacity, radius, rect_min, rect_size,
                tiles});
  }
  return (int)cudaGetLastError();
}

// Backward. Inputs as the forward's; g_mean2d [n, 2], g_depth [n], g_conic
// [n, 3], g_opacity [n] float32, each nullptr for a zero gradient. Writes
// d_means, d_scales [n, 3], d_quats [n, 4], d_opacities [n]; d_offset
// [n, 2] unless nullptr; unless g_affine is nullptr, partial [blocks, 12]
// (blocks = ceil(n / 256), scratch) and g_affine [3, 4]. Launches on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int eogs2_preprocess_bwd(
    const float* means, const float* scales, const float* quats,
    const float* opacities, const float* affine, long long n, int width,
    int height, int antialiasing, const float* g_mean2d, const float* g_depth,
    const float* g_conic, const float* g_opacity, float* d_means,
    float* d_scales, float* d_quats, float* d_opacities, float* d_offset,
    float* partial, float* g_affine, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    backward_kernel<<<blocks(n), NT, 0, s>>>(
        inputs(means, scales, quats, opacities, affine, n, width, height,
               antialiasing),
        Cotangents{g_mean2d, g_depth, g_conic, g_opacity},
        Gradients{d_means, d_scales, d_quats, d_opacities, d_offset,
                  g_affine != nullptr ? partial : nullptr});
  }
  if (g_affine != nullptr) {
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    affine_sum_kernel<<<1, NA * 32, 0, s>>>(partial, n > 0 ? blocks(n) : 0,
                                            g_affine);
  }
  return (int)cudaGetLastError();
}
